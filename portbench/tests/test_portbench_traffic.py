"""The file pools: the same seed gives the same files, another seed other
audio over the same lengths and speaker counts."""

import numpy as np
import pytest

from portbench.traffic.files import make_pool, pool_sizes

TRAFFIC = {"files": 3, "lengths": "loguniform", "min_s": 2.0, "max_s": 4.0, "speakers": [1, 3],
           "turn_s": [0.5, 1.5], "advance": [0.7, 1.0], "sample_rate": 16000}


def test_same_seed_same_files():
    a, b = make_pool(TRAFFIC, 2**31 + 11, "cpu"), make_pool(TRAFFIC, 2**31 + 11, "cpu")
    assert [x["seconds"] for x in a] == [x["seconds"] for x in b]
    assert all(np.array_equal(x["wave"], y["wave"]) for x, y in zip(a, b))


def test_other_seed_other_audio_same_lengths():
    a, b = make_pool(TRAFFIC, 1, "cpu"), make_pool(TRAFFIC, 2, "cpu")
    assert sorted(x["seconds"] for x in a) == sorted(x["seconds"] for x in b)
    # the same work for every seed: each length keeps its speaker count
    assert (sorted((x["seconds"], x["speakers"]) for x in a)
            == sorted((x["seconds"], x["speakers"]) for x in b))
    by_len = {x["seconds"]: x["wave"] for x in b}
    assert not all(np.array_equal(x["wave"], by_len[x["seconds"]]) for x in a)


@pytest.mark.parametrize("lengths", ["uniform", "loguniform"])
def test_sizes_are_quantiles(lengths):
    seconds, speakers = pool_sizes({**TRAFFIC, "files": 4, "lengths": lengths})
    assert len(seconds) == 4 and seconds.min() > 2.0 and seconds.max() < 4.0
    assert list(speakers) == [1, 2, 3, 1]


def test_audio_is_pcm16():
    wave = make_pool(TRAFFIC, 3, "cpu")[0]["wave"]
    assert wave.dtype == np.float32 and np.abs(wave).max() <= 1.0
    assert np.allclose(wave * 32768.0, np.round(wave * 32768.0))
