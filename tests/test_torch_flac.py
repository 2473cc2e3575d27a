"""The port's FLAC decoder and FLAC audio io against the JAX package.

`tests/flac_ref_encoder.py` (numpy only) encodes seeded integer samples per
the public FLAC spec; the port's decoder and the JAX package's decode every
stream, and both must return the source samples bit for bit. Then the audio
helpers: FLAC reads, headers and crops equal the WAV copy's, and a Kaldi
training directory of FLAC files gives the batches of its WAV twin.
"""

import io
import wave

import numpy as np
import pytest

from diarizen_tpu.core.flac import decode_flac_bytes as jax_decode_flac_bytes
from diarizen_tpu_torch.core import flac
from diarizen_tpu_torch.core.audio import Audio, get_audio_info, read_audio
from diarizen_tpu_torch.core.segments import Segment
from diarizen_tpu_torch.train.dataset import DataLoader, DiarizationDataset

from flac_ref_encoder import encode_flac


def _rand(rng, shape, bps, scale=1.0):
    lim = int((1 << (bps - 1)) * scale) - 1
    return rng.integers(-lim, lim + 1, size=shape, dtype=np.int64)


def _write_pcm16(path, x, sample_rate):
    """The WAV twin of a FLAC file: the same int16 samples."""
    with wave.open(str(path), "wb") as w:
        w.setnchannels(x.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(x.T.astype("<i2").tobytes())


def _smooth(rng, n):
    return np.cumsum(_rand(rng, n, 8), dtype=np.int64)[None]


# (samples from a seeded generator, encoder arguments): every path of the
# decoder the encoder can reach
CASES = {
    "verbatim": (lambda r: _rand(r, 1000, 16), dict(blocksize=256)),
    "constant": (lambda r: np.full((1, 777), -12345, np.int64),
                 dict(blocksize=777, specs=[{"kind": "constant"}])),
    **{f"fixed{o}": (lambda r: _smooth(r, 512),
                     dict(blocksize=512, specs=[{"kind": "fixed", "order": o, "porder": 2}]))
       for o in range(5)},
    **{f"lpc{o}": (lambda r: _rand(r, 400, 12)[None],
                   dict(blocksize=400, specs=[{"kind": "lpc", "order": o, "shift": sh,
                                               "method": m, "porder": 1 if o <= 8 else 0}]))
       for o, sh, m in ((1, 3, 0), (8, 5, 0), (32, 9, 1))},
    "rice2": (lambda r: _rand(r, 1024, 16)[None],
              dict(blocksize=1024, specs=[{"kind": "fixed", "order": 1, "method": 1,
                                           "porder": 3}])),
    "escape": (lambda r: _rand(r, 1024, 16)[None],
               dict(blocksize=1024, specs=[{"kind": "fixed", "order": 2, "porder": 2,
                                            "escape": True}])),
    "escape-zero": (lambda r: np.zeros((1, 256), np.int64),
                    dict(blocksize=256, specs=[{"kind": "fixed", "order": 0, "escape": True}])),
    "wasted-verbatim": (lambda r: (_rand(r, 300, 12) << 3)[None],
                        dict(blocksize=300, specs=[{"kind": "verbatim", "wasted": 3}])),
    "wasted-lpc": (lambda r: (_rand(r, 300, 12) << 3)[None],
                   dict(blocksize=300, specs=[{"kind": "lpc", "order": 2, "wasted": 3,
                                               "method": 1}])),
    **{f"stereo-{mode}": (lambda r: _rand(r, (2, 600), 16),
                          dict(blocksize=200, stereo=mode,
                               specs=[{"kind": "fixed", "order": 2, "porder": 1},
                                      {"kind": "verbatim"}]))
       for mode in ("independent", "left_side", "right_side", "mid_side")},
    **{f"bits{b}": (lambda r, b=b: _rand(r, (2, 333), b),
                    dict(bps=b, blocksize=128, stereo="mid_side")) for b in (8, 16, 24)},
    "multi-frame": (lambda r: _rand(r, 192 * 200 + 57, 16), dict(blocksize=192)),
    "explicit-8bit-size": (lambda r: _rand(r, 500, 16), dict(blocksize=250, bs_mode="explicit")),
    "explicit-16bit-size": (lambda r: _rand(r, 700, 16),
                            dict(blocksize=300, bs_mode="explicit")),
    "extra-metadata": (lambda r: _rand(r, 256, 16), dict(blocksize=256, extra_metadata=True)),
    "trailing-garbage": (lambda r: _rand(r, 1024, 16), dict(trailing=b"TAG" + bytes(125))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decoder_bit_exact_against_jax(case):
    make, kwargs = CASES[case]
    x = np.atleast_2d(make(np.random.default_rng(sorted(CASES).index(case))))
    kwargs = dict(kwargs)
    bps = kwargs.pop("bps", 16)
    data = encode_flac(x, 16000, bps=bps, **kwargs)
    got, rate, bits = flac.decode_flac_bytes(data)
    want, want_rate, want_bits = jax_decode_flac_bytes(data)
    assert (rate, bits) == (want_rate, want_bits) == (16000, bps)
    assert got.dtype == want.dtype and got.shape == x.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("fault", ["crc", "no-frames"])
def test_corrupt_streams_raise_the_jax_error(fault):
    rng = np.random.default_rng(13)
    data = encode_flac(_rand(rng, 256, 16), 16000, blocksize=256)
    if fault == "crc":
        broken = bytearray(data)
        broken[-40] ^= 0x40  # a payload bit inside the only frame
        data = bytes(broken)
    else:  # metadata, then garbage where the frames should be
        data = data[: data.index(b"\xff\xf8")] + bytes(64)
    with pytest.raises(ValueError) as want:
        jax_decode_flac_bytes(data)
    with pytest.raises(ValueError, match="FLAC decode failed") as got:
        flac.decode_flac_bytes(data)
    assert str(got.value) == str(want.value)


def test_library_is_built_once_under_build(monkeypatch):
    path = flac.library_path()
    flac._lib()
    assert path.exists() and path.parent.name == "diarizen_tpu_torch"
    assert path.parent.parent.name == "build"
    monkeypatch.setattr(flac, "_LIB", None)
    mtime = path.stat().st_mtime_ns
    flac._lib()  # loads the existing library, builds nothing
    assert path.stat().st_mtime_ns == mtime


def test_flac_reads_equal_wav(tmp_path, monkeypatch):
    rng = np.random.default_rng(51)
    x = _rand(rng, (2, 32000), 16)
    fpath, wpath = tmp_path / "e.flac", tmp_path / "e.wav"
    fpath.write_bytes(encode_flac(x, 16000, blocksize=1000))
    _write_pcm16(wpath, x, 16000)
    assert get_audio_info(fpath) == get_audio_info(wpath) == (32000, 16000, 2)
    assert get_audio_info(io.BytesIO(fpath.read_bytes())) == (32000, 16000, 2)
    for start, num in ((0, None), (1234, 100), (31990, 100)):
        got, rate = read_audio(fpath, start, num)
        want, _ = read_audio(wpath, start, num)
        assert rate == 16000
        np.testing.assert_array_equal(got, want)
    got, _ = read_audio(io.BytesIO(fpath.read_bytes()))  # sniffed by its magic
    np.testing.assert_array_equal(got, read_audio(wpath)[0])
    got[:] = 0.0  # a caller's copy: the cache stays as decoded
    np.testing.assert_array_equal(read_audio(fpath)[0], read_audio(wpath)[0])

    for mono in ("downmix", None):
        audio = Audio(sample_rate=16000, mono=mono)
        assert audio.get_duration(fpath) == audio.get_duration(wpath) == 2.0
        for seg in (Segment(0.25, 1.75), Segment(1.5, 2.5), Segment(-0.5, 0.5)):
            np.testing.assert_array_equal(audio.crop(fpath, seg)[0], audio.crop(wpath, seg)[0])
        np.testing.assert_array_equal(Audio(8000, mono)(fpath)[0], Audio(8000, mono)(wpath)[0])

    monkeypatch.setattr(flac, "_CACHE_MAX_BYTES", 0)  # no cache: decodes all the same
    monkeypatch.setattr(flac, "_CACHE_BYTES", 0)
    monkeypatch.setattr(flac, "_CACHE", type(flac._CACHE)())
    np.testing.assert_array_equal(read_audio(fpath)[0], read_audio(wpath)[0])
    assert len(flac._CACHE) == 0


def test_flac_training_directory_gives_the_wav_batches(tmp_path):
    sr, rttm, uem = 16000, [], []
    scps = {"wav": [], "flac": []}
    rng = np.random.default_rng(7)
    for rec in ("rec1", "rec2"):
        x = _rand(rng, (1, 6 * sr), 16, scale=0.1)
        _write_pcm16(tmp_path / f"{rec}.wav", x, sr)
        (tmp_path / f"{rec}.flac").write_bytes(encode_flac(x, sr))
        for kind in scps:
            scps[kind].append(f"{rec} {tmp_path / f'{rec}.{kind}'}")
        rttm += [f"SPEAKER {rec} 1 0.50 2.00 <NA> <NA> A <NA> <NA>",
                 f"SPEAKER {rec} 1 2.00 3.50 <NA> <NA> B <NA> <NA>"]
        uem.append(f"{rec} 1 0.0 6.0")
    (tmp_path / "rttm").write_text("\n".join(rttm) + "\n")
    (tmp_path / "all.uem").write_text("\n".join(uem) + "\n")
    batches = {}
    for kind, lines in scps.items():
        (tmp_path / f"{kind}.scp").write_text("\n".join(lines) + "\n")
        ds = DiarizationDataset(str(tmp_path / f"{kind}.scp"), str(tmp_path / "rttm"),
                                str(tmp_path / "all.uem"), model_num_frames=99,
                                model_rf_duration=0.025, model_rf_step=0.02,
                                chunk_size=1.0, chunk_shift=0.5)
        batches[kind] = list(DataLoader(ds, batch_size=2, shuffle=True, seed=3,
                                        max_speakers_per_chunk=2))
    assert len(batches["flac"]) == len(batches["wav"]) > 2
    for f, w in zip(batches["flac"], batches["wav"]):
        assert f["names"] == w["names"]
        np.testing.assert_array_equal(f["xs"], w["xs"])
        np.testing.assert_array_equal(f["target"], w["target"])
        assert np.abs(f["xs"]).max() > 0
