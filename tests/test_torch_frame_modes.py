"""The port's frame-level modes against the JAX package, in float32 on the
CPU: soft sliding scores, `whole` and `aggregated`; voice-activity and
overlapped-speech detection, multi-label segmentation and resegmentation
(identical RTTM text); the per-window fbank route of the embedding stage
(window starts off the 10 ms hop included, within 1e-4); and a file -> RTTM
run whose window step is off the 10 ms grid (identical text).

The tiny EEND and ResNet of tests/test_torch_pipeline.py (real conv
geometry, 8 s windows, weights initialised in JAX and carried into the
port) are used; scores agree within that module's float32 tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diarizen_tpu.cluster import AgglomerativeClustering as JaxAHC
from diarizen_tpu.core import segments as jax_segments
from diarizen_tpu.infer import DiarizationPipeline as JaxPipeline
from diarizen_tpu.infer import EmbeddingInference as JaxEmbeddingInference
from diarizen_tpu.infer import MultiLabelSegmentation as JaxMultiLabelSegmentation
from diarizen_tpu.infer import OverlappedSpeechDetection as JaxOverlappedSpeechDetection
from diarizen_tpu.infer import Resegmentation as JaxResegmentation
from diarizen_tpu.infer import SlidingInference as JaxSlidingInference
from diarizen_tpu.infer import VoiceActivityDetection as JaxVoiceActivityDetection
from diarizen_tpu_torch.cluster import AgglomerativeClustering
from diarizen_tpu_torch.core import segments
from diarizen_tpu_torch.infer import (
    DiarizationPipeline,
    EmbeddingInference,
    MultiLabelSegmentation,
    OverlappedSpeechDetection,
    Resegmentation,
    SlidingInference,
    VoiceActivityDetection,
)

from diarizen_tpu_torch.infer.sliding import gather_rows

from test_torch_pipeline import make_wave, tiny  # noqa: F401 (fixture)
from test_torch_wavlm_eend import TOL

# 15.3 s: 10 full 8 s windows at 0.8 s and an orphan last one
NUM_SAMPLES = 15 * 16000 + 5000


def _min_top2_margin(seg, wave):
    """Smallest top-2 powerset score margin over the file's windows: an
    argmax flip between the packages must not hide in a tie (the packages'
    scores agree within TOL)."""
    wave_dev, starts = seg.prepare_wave(wave)
    chunks = gather_rows(wave_dev, torch.as_tensor(starts), seg.window_size, 0)
    with torch.no_grad():
        top2 = seg.model(chunks, compute_dtype=torch.float32).topk(2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


@pytest.fixture(scope="module")
def sliding(tiny):
    """(port SlidingInference, JAX SlidingInference, wave), float32."""
    cfg, params, state, _, _, model, _ = tiny
    seg_jax = JaxSlidingInference(params, state, cfg, batch_size=32, compute_dtype=jnp.float32)
    seg = SlidingInference(model, compute_dtype=torch.float32, device="cpu")
    wave = make_wave(20)[:, :NUM_SAMPLES]
    assert _min_top2_margin(seg, wave) > 1e-3
    return seg, seg_jax, wave


def test_soft_whole_and_aggregated_scores_match_jax(sliding):
    seg, seg_jax, wave = sliding
    got, want = seg(wave, 16000, soft=True), seg_jax(wave, 16000, soft=True)
    assert got.data.dtype == np.float32 and got.data.shape == want.data.shape == (11, 399, 4)
    np.testing.assert_allclose(got.data, want.data, **TOL)
    assert 0.0 <= got.data.min() and got.data.max() <= 1.0 + 1e-6
    # hard mode is unchanged: the argmax of the same scores, uint8 on the device
    np.testing.assert_array_equal(seg(wave, 16000).data, seg_jax(wave, 16000).data)

    agg, want_agg = seg.aggregated(wave, 16000), seg_jax.aggregated(wave, 16000)
    assert agg.data.shape == want_agg.data.shape and agg.data.shape[0] == 765
    np.testing.assert_allclose(agg.data, want_agg.data, **TOL)
    window = lambda w: (w.start, w.duration, w.step)  # noqa: E731
    assert window(agg.sliding_window) == window(want_agg.sliding_window)

    short = wave[:, : 3 * 16000]  # one forward over the whole file
    for soft in (True, False):
        got_whole = seg.whole(short, 16000, soft=soft)
        want_whole = seg_jax.whole(short, 16000, soft=soft)
        assert got_whole.shape == want_whole.shape == (149, 4)
        assert got_whole.dtype == (np.float32 if soft else np.uint8) == want_whole.dtype
        np.testing.assert_allclose(got_whole, want_whole, **TOL)


def _turns_annotation(module, turns, uri):
    ann = module.Annotation(uri=uri)
    for i, (start, end, label) in enumerate(turns):
        ann[module.Segment(start, end), i] = label
    return ann


def test_frame_pipelines_give_jax_annotations(sliding):
    seg, seg_jax, wave = sliding
    for port_cls, jax_cls, kwargs in (
            (VoiceActivityDetection, JaxVoiceActivityDetection, {}),
            (VoiceActivityDetection, JaxVoiceActivityDetection,
             dict(onset=0.6, offset=0.4, min_duration_on=0.1, min_duration_off=0.2)),
            (OverlappedSpeechDetection, JaxOverlappedSpeechDetection, dict(onset=0.3)),
    ):
        got = port_cls(seg, **kwargs)(wave, 16000, uri="f").to_rttm()
        assert got == jax_cls(seg_jax, **kwargs)(wave, 16000, uri="f").to_rttm()
        assert got.count("SPEAKER") > 0

    classes = ["a", "b", "c", "d"]
    thresholds = {"a": {"onset": 0.6, "offset": 0.3, "min_duration_on": 0.1}, "c": {"onset": 0.2}}
    for shared in (False, True):
        kw = dict(thresholds=thresholds, share_min_duration=shared, min_duration_off=0.05)
        got = MultiLabelSegmentation(seg, classes, **kw)(wave, 16000, uri="m").to_rttm()
        assert got == JaxMultiLabelSegmentation(seg_jax, classes, **kw)(
            wave, 16000, uri="m").to_rttm()
        assert len({line.split()[7] for line in got.splitlines()}) > 1

    # an input diarization with three speakers (one more than the model
    # finds on some windows) and an overlap
    turns = [(0.5, 4.2, "A"), (3.9, 8.8, "B"), (8.0, 12.5, "A"), (12.0, 15.1, "C")]
    got = Resegmentation(seg)(wave, 16000, _turns_annotation(segments, turns, "r"), uri="r")
    want = JaxResegmentation(seg_jax)(wave, 16000, _turns_annotation(jax_segments, turns, "r"),
                                      uri="r")
    assert got.to_rttm() == want.to_rttm() and len(got) > 0


def test_per_window_embeddings_match_jax(tiny):
    """`shared_fbank=False` gathers waveform windows and computes an fbank
    per window; window starts off the 160-sample hop take that route even
    when the shared one is asked for."""
    _, _, _, rcfg, rparams, _, resnet = tiny
    window = 128000
    padded = make_wave(20)[0]  # every window lies inside
    starts = np.array([0, 12800, 12803, 25611, 38400, 64000])  # two off the hop
    rng = np.random.default_rng(2)
    weights = (rng.uniform(size=(len(starts), 4, 99)) > 0.4).astype(np.float32)
    want = JaxEmbeddingInference(rparams, rcfg, window_size=window, num_speakers=4,
                                 batch_size=4, shared_fbank=False)(
        jnp.asarray(padded), starts, weights)
    routes = {}
    for shared in (False, True):
        emb = EmbeddingInference(resnet, window, num_speakers=4, batch_size=4,
                                 device="cpu", shared_fbank=shared)
        routes[shared] = emb(torch.from_numpy(padded), starts, weights)
        assert routes[shared].shape == want.shape == (6, 4, 32)
        np.testing.assert_allclose(routes[shared], want, rtol=1e-4, atol=1e-4)
    # on the hop, the shared whole-file fbank equals the per-window one
    on_hop = starts[[0, 1, 4, 5]]
    emb = EmbeddingInference(resnet, window, num_speakers=4, device="cpu")
    np.testing.assert_allclose(emb(torch.from_numpy(padded), on_hop, weights[[0, 1, 4, 5]]),
                               routes[False][[0, 1, 4, 5]], rtol=1e-4, atol=1e-4)


def test_window_step_off_the_10ms_grid_rttm_equals_jax(tiny):
    """seg_duration 7.77 s: windows every 0.777 s (12432 samples, off the
    160-sample fbank hop), so the embedding stage takes the per-window
    route in both packages."""
    cfg, params, state, rcfg, rparams, model, resnet = tiny
    wave = make_wave(20)[:, : 12 * 16000]
    seg_jax = JaxSlidingInference(params, state, cfg, duration=7.77, step=0.777,
                                  batch_size=8, compute_dtype=jnp.float32)
    assert seg_jax.step_size % 160 != 0
    pipe_jax = JaxPipeline(
        seg_jax, JaxEmbeddingInference(rparams, rcfg, window_size=seg_jax.window_size,
                                       num_speakers=4, batch_size=8),
        JaxAHC(), cfg, max_speakers=4, fused_stitch=False)
    expected = pipe_jax(wave, 16000, uri="grid").to_rttm()

    seg = SlidingInference(model, duration=7.77, step=0.777, batch_size=8,
                           compute_dtype=torch.float32, device="cpu")
    assert seg.step_size == seg_jax.step_size and _min_top2_margin(seg, wave) > 1e-3
    pipe = DiarizationPipeline(
        seg, EmbeddingInference(resnet, seg.window_size, num_speakers=4, batch_size=8,
                                device="cpu"),
        AgglomerativeClustering(), model.cfg, max_speakers=4)
    assert len(expected.splitlines()) > 1
    assert pipe(wave, 16000, uri="grid").to_rttm() == expected
