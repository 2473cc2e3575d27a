"""Port DER, RTTM writing and oracle clustering against the JAX package.

The same seeded numpy inputs go through `diarizen_tpu.ops.der`,
`core.io_rttm` and `cluster.oracle` and their counterparts in the port.
Frame-level components agree within 1e-6 (float32 sums of 0/1 values);
the segment-level scorer runs the same float64 sweep on both sides, so its
counts agree within 1e-9; oracle assignments are equal and centroids
within 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diarizen_tpu.cluster.oracle import OracleClustering as JaxOracleClustering
from diarizen_tpu.core import io_rttm as jax_io_rttm
from diarizen_tpu.core import segments as jax_segments
from diarizen_tpu.ops import der as jax_der
from diarizen_tpu_torch.cluster import OracleClustering
from diarizen_tpu_torch.core import io_rttm, segments
from diarizen_tpu_torch.ops import der


def _turns(rng, num_speakers, duration, num_turns, jitter=0.0):
    """Random speaker turns (with overlaps): [(start, end, label)]."""
    out = []
    for _ in range(num_turns):
        start = float(rng.uniform(0.0, duration - 0.5))
        length = float(rng.uniform(0.2, 4.0))
        out.append((round(start + jitter, 3), round(min(duration, start + length), 3),
                    f"spk{int(rng.integers(num_speakers))}"))
    return out


def _annotation(module, turns, uri="rec"):
    ann = module.Annotation(uri=uri)
    for i, (start, end, label) in enumerate(turns):
        ann[module.Segment(start, end), i] = label
    return ann


@pytest.fixture(scope="module")
def pairs():
    """(reference turns, hypothesis turns) for a few seeded recordings; the
    hypothesis is a noisy relabelled copy with extra and missing turns."""
    out = []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        ref = _turns(rng, 3, 60.0, 25)
        rename = {f"spk{i}": f"h{(i + seed) % 4}" for i in range(3)}
        hyp = [(max(0.0, s + float(rng.normal(0, 0.3))), e + float(rng.normal(0, 0.3)),
                rename[label]) for s, e, label in ref if rng.uniform() > 0.15]
        hyp = [(round(s, 3), round(max(e, s + 0.05), 3), label) for s, e, label in hyp]
        hyp += _turns(rng, 4, 60.0, 4)
        out.append((ref, hyp))
    return out


def test_der_components_match_jax():
    rng = np.random.default_rng(0)
    target = (rng.uniform(size=(3, 4, 200)) > 0.6).astype(np.float32)
    # predictions: the targets with noise, speakers permuted per chunk
    preds = np.clip(target + 0.4 * rng.standard_normal(target.shape), 0, 1).astype(np.float32)
    for b in range(3):
        preds[b] = preds[b, rng.permutation(4)]
    got = der.der_components(torch.from_numpy(preds), torch.from_numpy(target))
    want = jax_der.der_components(jnp.asarray(preds), jnp.asarray(target))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=0, atol=1e-6)
    assert float(got[3]) == float(target.sum()) and float(got[2]) >= 0

    metric, jax_metric = der.DiarizationErrorRate(), jax_der.DiarizationErrorRate()
    for b in range(3):
        metric.update(torch.from_numpy(preds[b: b + 1]), torch.from_numpy(target[b: b + 1]))
        jax_metric.update(jnp.asarray(preds[b: b + 1]), jnp.asarray(target[b: b + 1]))
    for key, value in jax_metric.compute().items():
        np.testing.assert_allclose(metric.compute()[key], value, rtol=0, atol=1e-6)


@pytest.mark.parametrize("collar", [0.0, 0.25])
@pytest.mark.parametrize("with_uem", [False, True], ids=["no-uem", "uem"])
def test_der_report_matches_jax(pairs, collar, with_uem):
    for ref_turns, hyp_turns in pairs:
        ref, hyp = _annotation(segments, ref_turns), _annotation(segments, hyp_turns)
        jref, jhyp = _annotation(jax_segments, ref_turns), _annotation(jax_segments, hyp_turns)
        uem = juem = None
        if with_uem:
            uem = segments.Timeline([segments.Segment(5.0, 30.0), segments.Segment(35.0, 55.5)])
            juem = jax_segments.Timeline([jax_segments.Segment(5.0, 30.0),
                                          jax_segments.Segment(35.0, 55.5)])
        got = der.der_report(ref, hyp, uem=uem, collar=collar)
        want = jax_der.der_report(jref, jhyp, uem=juem, collar=collar)
        for field in ("false_alarm", "missed_detection", "confusion", "total"):
            np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                       rtol=0, atol=1e-9, err_msg=field)
        assert got.total > 0 and 0 < got.der < 2
        assert abs(got.der - want.der) <= 1e-9
        assert der.optimal_mapping(ref, hyp) == jax_der.optimal_mapping(jref, jhyp)
    # a perfect hypothesis scores 0, sums add
    ref = _annotation(segments, pairs[0][0])
    assert der.der_report(ref, ref, collar=collar).der == 0.0
    total = der.DERReport(1.0, 2.0, 3.0, 10.0) + der.DERReport(1.0, 0.0, 0.0, 10.0)
    assert total.der == pytest.approx(0.35) and der.DERReport(0, 0, 0, 0).der == 0.0


def test_rttm_write_load_and_arrays_match_jax(pairs, tmp_path):
    anns = [_annotation(segments, turns, uri=f"rec{i}") for i, (turns, _) in enumerate(pairs)]
    io_rttm.write_rttm(tmp_path / "a.rttm", anns)
    jax_io_rttm.write_rttm(tmp_path / "b.rttm", [
        _annotation(jax_segments, turns, uri=f"rec{i}") for i, (turns, _) in enumerate(pairs)])
    assert (tmp_path / "a.rttm").read_text() == (tmp_path / "b.rttm").read_text()
    loaded = io_rttm.load_rttm(tmp_path / "a.rttm")
    assert [loaded[a.uri].to_rttm() for a in anns] == [a.to_rttm() for a in anns]

    data, sessions, speakers = io_rttm.rttm_to_arrays(loaded)
    want = jax_io_rttm.rttm_to_arrays(jax_io_rttm.load_rttm(tmp_path / "a.rttm"))
    assert data.dtype == want[0].dtype and len(data) == sum(len(a) for a in anns)
    np.testing.assert_array_equal(data, want[0])
    assert sessions == want[1] and speakers == want[2]


def test_oracle_clustering_matches_jax(pairs):
    ref_turns = pairs[1][0]
    window = segments.SlidingWindow(start=0.0, duration=8.0, step=0.8)
    frames = segments.SlidingWindow(start=-0.0125, duration=0.025, step=0.02)
    jwindow = jax_segments.SlidingWindow(start=0.0, duration=8.0, step=0.8)
    jframes = jax_segments.SlidingWindow(start=-0.0125, duration=0.025, step=0.02)
    rng = np.random.default_rng(5)
    num_chunks, num_frames, local = 60, 399, 4
    binary = (rng.uniform(size=(num_chunks, num_frames, local)) > 0.7).astype(np.float32)
    binary[:, :, 3] = 0.0  # an inactive local speaker
    embeddings = rng.standard_normal((num_chunks, local, 16))
    embeddings[2, 1] = np.nan  # a chunk without an embedding

    ours = OracleClustering(_annotation(segments, ref_turns), frames)
    theirs = JaxOracleClustering(_annotation(jax_segments, ref_turns), jframes)
    for emb in (None, embeddings):
        hard, soft, centroids = ours(emb, binary, window=window)
        want_hard, want_soft, want_centroids = theirs(emb, binary, window=jwindow)
        np.testing.assert_array_equal(hard, want_hard)
        np.testing.assert_array_equal(soft, want_soft)
        assert hard.dtype == want_hard.dtype and (hard >= 0).any()
        if emb is None:
            assert centroids is None and want_centroids is None
        else:
            np.testing.assert_allclose(centroids, want_centroids, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="chunk window"):
        ours(None, binary)
