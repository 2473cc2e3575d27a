"""The port's device-side stitch, streamed pipeline and hooks against the JAX
package and against the port's own host stages, on the CPU: the stitch and the
float32 RTTMs must be equal exactly."""

import io

import numpy as np
import pytest
import torch
from scipy.ndimage import median_filter

import jax.numpy as jnp

from diarizen_tpu import hooks as jax_hooks
from diarizen_tpu.cluster import AgglomerativeClustering as JaxAHC
from diarizen_tpu.core.segments import SlidingWindow as JaxSlidingWindow
from diarizen_tpu.infer import DiarizationPipeline as JaxPipeline
from diarizen_tpu.infer import EmbeddingInference as JaxEmbeddingInference
from diarizen_tpu.infer import SlidingInference as JaxSlidingInference
from diarizen_tpu.infer.fused import FusedStitch as JaxFusedStitch
from diarizen_tpu_torch import hooks
from diarizen_tpu_torch.cluster import AgglomerativeClustering
from diarizen_tpu_torch.core.segments import SlidingWindow, SlidingWindowFeature
from diarizen_tpu_torch.infer import (
    DiarizationPipeline,
    EmbeddingInference,
    FusedStitch,
    SlidingInference,
    speaker_count,
)
from tests.test_torch_pipeline import _min_top2_margin, make_wave, tiny  # noqa: F401

F, S = 39, 4  # frames per chunk, speakers
LAYOUT = dict(chunk_dur=2.0, chunk_step=0.2, frame_dur=0.025, frame_step=0.05)


def make_stitch(cls, window, f, s, chunk_dur, chunk_step, frame_dur, frame_step, **kw):
    frames = window(start=-0.002, duration=frame_dur, step=frame_step)
    chunks = window(start=0.0, duration=chunk_dur, step=chunk_step)
    return cls(frames, chunks, f, s, **kw), chunks, frames


def host_weights(filtered, min_num_frames):
    masks = filtered.astype(np.float32)
    clean = masks * (np.sum(masks, axis=2, keepdims=True) < 2)
    use_clean = np.sum(clean, axis=1) > min_num_frames
    return np.transpose(np.where(use_clean[:, None, :], clean, masks), (0, 2, 1))


@pytest.mark.parametrize("n_chunks", [1, 7, 32, 65])
@pytest.mark.parametrize("median", [True, False])
def test_fused_stitch_equals_jax_and_host(n_chunks, median):
    kw = dict(apply_median_filtering=median, exclude_overlap=True, min_num_frames=2)
    fs, chunks, frames = make_stitch(FusedStitch, SlidingWindow, F, S, **LAYOUT, **kw)
    jfs, _, _ = make_stitch(JaxFusedStitch, JaxSlidingWindow, F, S, **LAYOUT, chunk_bucket=16,
                            **kw)
    seg = (np.random.default_rng(n_chunks).random((n_chunks, F, S)) < 0.35).astype(np.uint8)

    plan = fs.plan(n_chunks)
    assert plan is not None and plan["n"] == n_chunks
    binarized, counts, weights = (t.numpy() for t in fs.stitch(torch.from_numpy(seg), plan))
    assert binarized.shape == (n_chunks, F, S) and weights.shape == (n_chunks, S, F)
    assert binarized.dtype == counts.dtype == weights.dtype == np.uint8

    # the JAX stitch (bit-packed, padded to its compile bucket)
    jplan = jfs.plan(n_chunks)
    packed, jcounts, jweights = jfs.stitch(jnp.asarray(seg), jplan)
    bits = np.unpackbits(np.asarray(packed))[: jplan["n_pad"] * F * S]
    np.testing.assert_array_equal(binarized, bits.reshape(jplan["n_pad"], F, S)[:n_chunks])
    assert plan["num_frames"] == jplan["num_frames_true"] == fs.num_frames(n_chunks)
    np.testing.assert_array_equal(counts, np.asarray(jcounts)[: plan["num_frames"]])
    np.testing.assert_array_equal(weights, np.asarray(jweights)[:n_chunks])

    # the port's host stages
    filtered = seg.astype(np.float32)
    if median:
        filtered = median_filter(filtered, size=(1, 11, 1), mode="reflect")
    count_ref = speaker_count(SlidingWindowFeature(filtered, chunks), frames, warm_up=(0.0, 0.0))
    np.testing.assert_array_equal(binarized, filtered)
    np.testing.assert_array_equal(counts, count_ref.data[:, 0])
    np.testing.assert_array_equal(weights, host_weights(filtered, 2))


def test_stitch_options_and_layouts():
    # a chunk step below the frame step gives hop 0: no plan, as in JAX
    layout = dict(chunk_dur=2.0, chunk_step=0.01, frame_dur=0.025, frame_step=0.05)
    fs, _, _ = make_stitch(FusedStitch, SlidingWindow, F, S, **layout)
    jfs, _, _ = make_stitch(JaxFusedStitch, JaxSlidingWindow, F, S, **layout)
    assert fs.plan(8) is None and jfs.plan(8) is None
    assert fs.plan(0) is None and jfs.plan(0) is None  # the empty file
    # without the exclude-overlap rule the weights are the transposed masks
    fs, _, _ = make_stitch(FusedStitch, SlidingWindow, F, S, **LAYOUT, exclude_overlap=False,
                           apply_median_filtering=False)
    seg = (np.random.default_rng(0).random((5, F, S)) < 0.5).astype(np.uint8)
    binarized, _, weights = fs.stitch(torch.from_numpy(seg), fs.plan(5))
    np.testing.assert_array_equal(binarized.numpy(), seg)
    np.testing.assert_array_equal(weights.numpy(), seg.transpose(0, 2, 1))
    with pytest.raises(ValueError, match="expected uint8"):
        fs.stitch(torch.from_numpy(seg).float(), fs.plan(5))


@pytest.fixture(scope="module")
def pipelines(tiny):  # noqa: F811
    cfg, params, state, rcfg, rparams, model, resnet = tiny
    seg_jax = JaxSlidingInference(params, state, cfg, batch_size=6, compute_dtype=jnp.float32)
    pipe_jax = JaxPipeline(
        seg_jax,
        JaxEmbeddingInference(rparams, rcfg, window_size=seg_jax.window_size, num_speakers=4,
                              batch_size=6),
        JaxAHC(), cfg, max_speakers=4)
    seg = SlidingInference(model, batch_size=6, compute_dtype=torch.float32, device="cpu")
    emb = EmbeddingInference(resnet, seg.window_size, num_speakers=4, batch_size=6, device="cpu")

    def build(fused=True):
        return DiarizationPipeline(seg, emb, AgglomerativeClustering(), model.cfg,
                                   max_speakers=4, fused_stitch=fused)

    wave = make_wave(20)
    waves = [wave, np.ascontiguousarray(wave[:, ::-1]), wave[:, : 9 * 16000 + 3000]]
    for w in waves:  # no argmax decision of these files hides in a tie
        assert _min_top2_margin(params, state, cfg, w, seg_jax) > 1e-3
    return pipe_jax, build, waves


def test_dispatch_stays_on_the_device_and_collect_fetches(pipelines):
    _, build, waves = pipelines
    seg = build().seg_inference
    wave, starts = seg.prepare_wave(waves[2])
    calls = []
    out = seg.dispatch(wave, starts, hook=lambda *a, **kw: calls.append((a, kw)))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    assert out.shape == (3, 399, 4)  # exactly the file's chunks: no bucket rows
    assert calls == [(("segmentation", None), {"total": 3, "completed": 3})]
    np.testing.assert_array_equal(seg.collect(out), seg(waves[2], 16000).data)
    assert seg.dispatch(wave, starts[:0]) is None and seg.collect(None) is None


def test_stream_equals_per_file_calls_and_jax(pipelines):
    pipe_jax, build, waves = pipelines
    uris = ["a", "b", "c"]
    expected = [pipe_jax(w, 16000, uri=u).to_rttm() for w, u in zip(waves, uris)]
    assert all(len(e.splitlines()) > 1 for e in expected)
    for fused in (True, False):
        pipe = build(fused)
        streamed = [ann.to_rttm() for ann in pipe.stream(iter(waves), 16000, uris=uris,
                                                         trim_every=2)]
        single = [pipe(w, 16000, uri=u).to_rttm() for w, u in zip(waves, uris)]
        assert streamed == single == expected, f"fused_stitch={fused}"
    # without uris, and an empty stream
    assert [a.uri for a in build().stream(waves[:2])] == [None, None]
    assert list(build().stream([])) == []


def test_a_file_without_a_plan_takes_the_host_path(pipelines, monkeypatch):
    _, build, waves = pipelines
    expected = build()(waves[0], 16000, uri="x").to_rttm()
    pipe = build()
    monkeypatch.setattr(pipe._get_fused(), "plan", lambda n: None)
    state = pipe._dispatch_file(waves[0], 16000, "x", None)
    assert "fetch" not in state and state["seg_dev"].dtype == torch.uint8
    assert pipe._finish_file(state, None, None).to_rttm() == expected
    assert list(a.to_rttm() for a in pipe.stream(waves[:2], uris=["x", "y"]))[0] == expected
    # a duck-typed embedder without `dispatch` turns the fused route off
    assert build()._use_fused() and not build(False)._use_fused()
    assert not DiarizationPipeline(pipe.seg_inference, lambda *a, **kw: None, None,
                                   pipe.eend_cfg)._use_fused()
    with pytest.raises(ValueError, match="resample"):
        pipe(waves[0], 8000)


@pytest.mark.parametrize("fused", [True, False])
def test_return_embeddings_and_no_speech_reset(pipelines, fused, monkeypatch):
    pipe_jax, build, waves = pipelines
    pipe = build(fused)
    ann, centroids = pipe(waves[0], 16000, uri="x", return_embeddings=True)
    ann_jax, centroids_jax = pipe_jax(waves[0], 16000, uri="x", return_embeddings=True)
    assert ann.to_rttm() == ann_jax.to_rttm()
    assert centroids.shape == centroids_jax.shape == (len(ann.labels()), 32)
    np.testing.assert_allclose(centroids, centroids_jax, rtol=1e-4, atol=1e-4)

    # a silent file must not hand back the previous file's centroids
    seg = pipe.seg_inference
    monkeypatch.setattr(seg, "dispatch",
                        lambda wave, starts, hook=None, events=None: torch.zeros(
                            (len(starts), 399, 4), dtype=torch.uint8))
    ann, centroids = pipe(waves[0], 16000, uri="silent", return_embeddings=True)
    assert ann.uri == "silent" and ann.to_rttm() == ""
    assert centroids.shape == (0, 32)


@pytest.mark.parametrize("fused", [True, False])
def test_hooks_follow_the_protocol(pipelines, fused):
    _, build, waves = pipelines
    pipe = build(fused)
    calls = []
    keep = hooks.ArtifactHook("segmentation", "clustering")
    timing = hooks.TimingHook()
    text = io.StringIO()
    both = hooks.Hooks(keep, timing, None, hooks.ProgressHook(text),
                       lambda step, artifact=None, **kw: calls.append((step, artifact is None, kw)))
    ann = pipe(waves[0], 16000, uri="x", hook=both)
    timing.finish()

    stages = ["segmentation", "speaker_counting", "embeddings", "clustering",
              "discrete_diarization"]
    assert [c[0] for c in calls if not c[1]] == stages  # one artifact per stage, in order
    batches = [c for c in calls if c[1]]
    assert {c[0] for c in batches} == {"segmentation", "embeddings"}
    for step in ("segmentation", "embeddings"):  # 16 chunks in batches of 6: 6, 12, 16
        assert [c[2] for c in batches if c[0] == step] == [
            {"total": 16, "completed": n} for n in (6, 12, 16)]
    assert set(keep.artifacts) == {"segmentation", "clustering"}
    assert keep.artifacts["segmentation"].data.shape == (16, 399, 4)
    assert set(timing.timings) == set(stages) and all(t >= 0 for t in timing.timings.values())
    timing.audio_duration = 20.0
    assert timing.throughput() > 0
    assert "segmentation: 16/16" in text.getvalue() and "clustering: done" in text.getvalue()
    assert ann.to_rttm() == build(fused)(waves[0], 16000, uri="x").to_rttm()


def test_hook_classes_equal_jax():
    """The same call sequence through both packages' hooks."""
    sequence = [("segmentation", None, dict(total=5, completed=2)),
                ("segmentation", None, dict(total=5, completed=5)),
                ("segmentation", "seg", {}), ("embeddings", "emb", {}),
                ("clustering", None, {})]
    outputs = []
    for mod in (hooks, jax_hooks):
        text = io.StringIO()
        keep, kept_all = mod.ArtifactHook("embeddings"), mod.ArtifactHook()
        timing = mod.TimingHook()
        both = mod.Hooks(mod.ProgressHook(text), keep, kept_all, timing)
        for step, artifact, kw in sequence:
            both(step, artifact, **kw)
        timing.finish()
        assert timing.throughput() is None  # no audio duration set
        outputs.append((text.getvalue(), keep.artifacts, kept_all.artifacts,
                        sorted(timing.timings)))
    assert outputs[0] == outputs[1]
    assert outputs[0][1] == {"embeddings": "emb"}
