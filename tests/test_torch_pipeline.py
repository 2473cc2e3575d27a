"""Port pipeline against the JAX package: the host stages on identical
inputs (exact equality), and file -> RTTM end to end on a synthetic
two-speaker wave with the same tiny weights in float32 (identical text)."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diarizen_tpu.cluster import AgglomerativeClustering as JaxAHC
from diarizen_tpu.core.segments import SlidingWindow as JaxSlidingWindow
from diarizen_tpu.core.segments import SlidingWindowFeature as JaxSWF
from diarizen_tpu.infer import DiarizationPipeline as JaxPipeline
from diarizen_tpu.infer import EmbeddingInference as JaxEmbeddingInference
from diarizen_tpu.infer import SlidingInference as JaxSlidingInference
from diarizen_tpu.infer import reconstruct as jax_reconstruct
from diarizen_tpu.infer import speaker_count as jax_speaker_count
from diarizen_tpu.models.conformer import ConformerConfig as JaxConformerConfig
from diarizen_tpu.models.eend import EendConfig as JaxEendConfig
from diarizen_tpu.models.eend import eend_forward, init_eend_params
from diarizen_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from diarizen_tpu.models.resnet import init_resnet_params
from diarizen_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from diarizen_tpu.ops.aggregate import aggregate as jax_aggregate
from diarizen_tpu.ops.binarize import Binarize as JaxBinarize
from diarizen_tpu_torch.cluster import AgglomerativeClustering
from diarizen_tpu_torch.core.segments import SlidingWindow, SlidingWindowFeature
from diarizen_tpu_torch.infer import (
    DiarizationPipeline,
    EmbeddingInference,
    SlidingInference,
    reconstruct,
    speaker_count,
)
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.convert import (
    eend_state_dict_from_jax,
    resnet_state_dict_from_jax,
)
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig
from diarizen_tpu_torch.models.wavlm import WavLMConfig
from diarizen_tpu_torch.ops.aggregate import aggregate
from diarizen_tpu_torch.ops.binarize import Binarize


@pytest.fixture(scope="module")
def stage_inputs():
    rng = np.random.default_rng(0)
    seg = (rng.uniform(size=(20, 50, 3)) > 0.6).astype(np.float32)
    chunks = dict(start=0.0, duration=2.0, step=0.2)
    frames = dict(start=-0.01, duration=0.04, step=0.04)
    clusters = rng.integers(-2, 3, size=(20, 3))
    # two speaker blobs with noise, a NaN row for an inactive local speaker
    centers = np.stack([np.eye(16)[0], -np.eye(16)[0], np.eye(16)[1]]) * 3.0
    emb = centers[rng.integers(0, 3, size=(20, 3))] + rng.standard_normal((20, 3, 16))
    emb[4, 1] = np.nan
    seg[4, :, 1] = 0.0
    return seg, chunks, frames, clusters, emb


def _both(seg, chunks):
    return (SlidingWindowFeature(seg.copy(), SlidingWindow(**chunks)),
            JaxSWF(seg.copy(), JaxSlidingWindow(**chunks)))


def test_host_stages_equal_jax(stage_inputs):
    seg, chunks, frames, clusters, emb = stage_inputs
    port, ref = _both(seg, chunks)

    for kw in (dict(hamming=True, warm_up=(0.1, 0.1)), dict(skip_average=True, missing=0.0)):
        np.testing.assert_array_equal(
            aggregate(port, SlidingWindow(**frames), **kw).data,
            jax_aggregate(ref, JaxSlidingWindow(**frames), **kw).data)

    count = speaker_count(port, SlidingWindow(**frames), warm_up=(0.0, 0.0))
    ref_count = jax_speaker_count(ref, JaxSlidingWindow(**frames), warm_up=(0.0, 0.0))
    np.testing.assert_array_equal(count.data, ref_count.data)

    discrete = reconstruct(port, clusters.copy(), count)
    ref_discrete = jax_reconstruct(ref, clusters.copy(), ref_count)
    np.testing.assert_array_equal(discrete.data, ref_discrete.data)

    for kw in (dict(onset=0.5), dict(onset=0.6, offset=0.4, min_duration_on=0.1,
                                     min_duration_off=0.1, pad_onset=0.05)):
        scores = SlidingWindowFeature(discrete.data * 0.9, discrete.sliding_window)
        ref_scores = JaxSWF(ref_discrete.data * 0.9, ref_discrete.sliding_window)
        assert Binarize(**kw)(scores).to_rttm() == JaxBinarize(**kw)(ref_scores).to_rttm()

    for kw in (dict(min_clusters=1, max_clusters=4), dict(min_clusters=3, max_clusters=3)):
        got = AgglomerativeClustering(min_cluster_size=5)(emb, seg, **kw)
        expected = JaxAHC(min_cluster_size=5)(emb, seg, **kw)
        for a, b in zip(got, expected):
            np.testing.assert_array_equal(a, b)


class _CaptureWeights:
    """Embedding stand-in that records the weights it is handed."""

    min_num_samples = 400

    def __call__(self, wave, starts, weights, hook=None):
        self.weights = np.asarray(weights, np.float32)
        return np.zeros((len(starts), weights.shape[1], 8))


def test_embedding_weights_equal_jax():
    """Exclude-overlap weights, including speakers whose clean-frame count
    sits exactly on the min_num_frames boundary (2 frames at 399 frames per
    8 s window)."""
    rng = np.random.default_rng(5)
    seg = (rng.uniform(size=(3, 399, 4)) > 0.7).astype(np.float32)
    seg[0, :, 0] = 0.0
    seg[0, :2, 0] = 1.0  # exactly 2 clean frames...
    seg[0, :2, 1:] = 0.0
    seg[0, 10:20, :2] = 1.0  # ...and overlapped ones
    seg[1, :, 1] = 0.0
    seg[1, 5:8, 1] = 1.0  # 3 clean frames
    seg[1, 5:8, [0, 2, 3]] = 0.0
    chunks = dict(start=0.0, duration=8.0, step=0.8)
    prepared = (None, np.arange(3) * 12800)
    windows = types.SimpleNamespace(window_size=128000, step_size=12800)

    jax_emb, port_emb = _CaptureWeights(), _CaptureWeights()
    JaxPipeline(windows, jax_emb, None, None).get_embeddings(
        None, JaxSWF(seg.copy(), JaxSlidingWindow(**chunks)), prepared=prepared)
    DiarizationPipeline(windows, port_emb, None, None).get_embeddings(
        SlidingWindowFeature(seg.copy(), SlidingWindow(**chunks)), prepared)
    np.testing.assert_array_equal(port_emb.weights, jax_emb.weights)


def make_wave(dur_s, sr=16000):
    """Synthetic two-speaker PCM16 meeting (bench.py's generator)."""
    t = np.arange(dur_s * sr) / sr
    wave = np.zeros_like(t, dtype=np.float32)
    rng = np.random.default_rng(0)
    pos, spk = 0.0, 0
    while pos < dur_s - 2:
        seg = rng.uniform(2.0, 6.0)
        m = (t >= pos) & (t < pos + seg)
        f = 180 + 90 * spk
        wave[m] += 0.2 * np.sin(2 * np.pi * f * t[m]).astype(np.float32)
        wave[m] += 0.01 * rng.standard_normal(int(m.sum())).astype(np.float32)
        pos += seg * rng.uniform(0.6, 1.0)
        spk = 1 - spk
    wave = np.clip(np.rint(wave * 32767.0), -32768, 32767) / 32768.0
    return wave[None].astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    """A tiny EEND (real 7-layer conv geometry, 8 s windows) and ResNet,
    initialised in JAX and carried into the port."""
    n = 2
    wavlm = JaxWavLMConfig(
        conv_layers=((16, 10, 5), (16, 3, 2), (16, 3, 2), (16, 3, 2), (16, 3, 2),
                     (16, 2, 2), (16, 2, 2)),
        embed_dim=64, num_layers=n, use_attention=(True,) * n,
        use_feed_forward=(True,) * n, total_num_heads=(4,) * n,
        remaining_heads=((0, 2), (1, 2, 3)), ff_interm_features=(48, 32),
        layer_drop=0.0,
    )
    cfg = JaxEendConfig(
        wavlm=wavlm,
        conformer=JaxConformerConfig(dim=32, ffn_hidden=64, num_heads=4, num_layers=1),
        wavlm_layer_num=n + 1, wavlm_feat_dim=64, attention_in=32,
    )
    params, state = init_eend_params(jax.random.PRNGKey(0), cfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    # widen the powerset scores so argmax decisions sit far from ties
    params["classifier"]["w"] = params["classifier"]["w"] * 100.0
    rcfg = JaxResNetConfig(m_channels=8, num_blocks=(1, 1, 1, 1), embed_dim=32)
    rparams = jax.tree_util.tree_map(np.asarray, init_resnet_params(jax.random.PRNGKey(1), rcfg))

    model = EendModel(EendConfig(**{
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
        "wavlm": WavLMConfig(**dataclasses.asdict(cfg.wavlm)),
        "conformer": ConformerConfig(**dataclasses.asdict(cfg.conformer)),
    }))
    model.load_state_dict(eend_state_dict_from_jax(params, state, cfg))
    resnet = ResNet(ResNetConfig(m_channels=8, num_blocks=(1, 1, 1, 1), embed_dim=32))
    resnet.load_state_dict(resnet_state_dict_from_jax(rparams, rcfg))
    return cfg, params, state, rcfg, rparams, model, resnet


def _min_top2_margin(params, state, cfg, wave, seg_jax):
    """Smallest top-2 powerset score margin of the JAX model over the file's
    windows: an argmax flip between the packages must not hide in a tie."""
    total = sum(seg_jax.num_chunks(wave.shape[1]))
    padded = np.zeros((total - 1) * seg_jax.step_size + seg_jax.window_size, np.float32)
    padded[: wave.shape[1]] = wave[0]
    chunks = np.stack([padded[i * seg_jax.step_size:][: seg_jax.window_size]
                       for i in range(total)])
    scores, _ = eend_forward(params, state, cfg, jnp.asarray(chunks))
    top2 = np.sort(np.asarray(scores), axis=-1)[..., -2:]
    return float(np.min(top2[..., 1] - top2[..., 0]))


def test_end_to_end_rttm_equals_jax(tiny):
    cfg, params, state, rcfg, rparams, model, resnet = tiny
    wave = make_wave(20)
    seg_jax = JaxSlidingInference(params, state, cfg, batch_size=6, compute_dtype=jnp.float32)
    pipe_jax = JaxPipeline(
        seg_jax,
        JaxEmbeddingInference(rparams, rcfg, window_size=seg_jax.window_size,
                              num_speakers=4, batch_size=6),
        JaxAHC(), cfg, max_speakers=4, fused_stitch=False)
    expected = pipe_jax(wave, 16000, uri="synth").to_rttm()
    assert _min_top2_margin(params, state, cfg, wave, seg_jax) > 1e-3

    seg = SlidingInference(model, batch_size=6, compute_dtype=torch.float32, device="cpu")
    pipe = DiarizationPipeline(
        seg, EmbeddingInference(resnet, seg.window_size, num_speakers=4, batch_size=6,
                                device="cpu"),
        AgglomerativeClustering(), model.cfg, max_speakers=4)
    got = pipe(wave, 16000, uri="synth").to_rttm()

    assert len(expected.splitlines()) > 1
    assert got == expected


def test_short_file_equals_jax(tiny):
    """3 windows (the last an orphan) against batches of 32 and 16: both
    packages take their zero-padded tail-batch paths in both stages."""
    cfg, params, state, rcfg, rparams, model, resnet = tiny
    wave = make_wave(20)[:, : 9 * 16000 + 3000]
    seg_jax = JaxSlidingInference(params, state, cfg, batch_size=32, compute_dtype=jnp.float32)
    assert _min_top2_margin(params, state, cfg, wave, seg_jax) > 1e-3
    expected = seg_jax(wave, 16000)
    seg = SlidingInference(model, compute_dtype=torch.float32, device="cpu")
    got = seg(wave, 16000)
    assert got.data.shape == expected.data.shape == (3, 399, 4)
    np.testing.assert_array_equal(got.data, expected.data)
    window = lambda w: (w.start, w.duration, w.step)  # noqa: E731
    assert window(got.sliding_window) == window(expected.sliding_window)

    pipe_jax = JaxPipeline(
        seg_jax, JaxEmbeddingInference(rparams, rcfg, window_size=seg_jax.window_size,
                                       num_speakers=4),
        JaxAHC(), cfg, max_speakers=4, fused_stitch=False)
    pipe = DiarizationPipeline(
        seg, EmbeddingInference(resnet, seg.window_size, num_speakers=4, device="cpu"),
        AgglomerativeClustering(), model.cfg, max_speakers=4)
    expected_rttm = pipe_jax(wave, 16000, uri="short").to_rttm()
    assert expected_rttm
    assert pipe(wave, 16000, uri="short").to_rttm() == expected_rttm
