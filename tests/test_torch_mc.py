"""The port's multi-channel family against the JAX package on the CPU, in
float32: both channel fusions, the multi-channel WavLM hidden states, the
multi-channel EEND scores and spatial attention (all channels and the
training-time truncation to 2), the state-dict round trip, the
attention-weighted embeddings, and 3-channel audio through the serving
path (`DiarizationPipeline` on a multi-channel `SlidingInference`) to an
RTTM equal to the JAX pipeline's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diarizen_tpu.cluster import AgglomerativeClustering as JaxAHC
from diarizen_tpu.infer.mc_pipeline import McDiarizationPipeline as JaxMcPipeline
from diarizen_tpu.infer.mc_pipeline import McSlidingInference as JaxMcSlidingInference
from diarizen_tpu.infer.pipeline import EmbeddingInference as JaxEmbeddingInference
from diarizen_tpu.models.conformer import ConformerConfig as JaxConformerConfig
from diarizen_tpu.models.convert import eend_mc_params_from_torch, fusion_params_from_torch
from diarizen_tpu.models.mc import FusionConfig as JaxFusionConfig
from diarizen_tpu.models.mc import McEendConfig as JaxMcEendConfig
from diarizen_tpu.models.mc import (
    apply_fusion,
    eend_mc_forward,
    init_eend_mc_params,
    init_fusions,
    wavlm_extract_features_mc,
)
from diarizen_tpu.models.mc import attention_weighted_embeddings as jax_weighted_embeddings
from diarizen_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from diarizen_tpu.models.resnet import init_resnet_params
from diarizen_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from diarizen_tpu_torch.cluster import AgglomerativeClustering
from diarizen_tpu_torch.infer import DiarizationPipeline, EmbeddingInference, SlidingInference
from diarizen_tpu_torch.models.build import wavlm_conformer, wavlm_conformer_mc
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.convert import (
    eend_mc_state_dict_from_jax,
    fusion_state_dict_from_jax,
    resnet_state_dict_from_jax,
    wavlm_state_dict_from_jax,
)
from diarizen_tpu_torch.models.forward import segmentation_forward
from diarizen_tpu_torch.models.mc import (
    FusionConfig,
    McEendConfig,
    McEendModel,
    attention_weighted_embeddings,
    make_fusions,
    wavlm_hidden_states_mc,
)
from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig
from diarizen_tpu_torch.models.wavlm import WavLM, WavLMConfig


def tiny_wavlm(n=4):
    """tests/test_mc.py's tiny WavLM."""
    return JaxWavLMConfig(
        conv_layers=((16, 10, 5), (16, 3, 2), (16, 2, 2)), embed_dim=32, num_layers=n,
        use_attention=(True,) * n, use_feed_forward=(True,) * n, total_num_heads=(4,) * n,
        remaining_heads=(tuple(range(4)),) * n, ff_interm_features=(64,) * n, num_buckets=16,
        max_distance=20, layer_drop=0.0, dropout=0.0, attention_dropout=0.0,
        projection_dropout=0.0)


def tiny_mc_cfg(chunk_size=0.125):
    return JaxMcEendConfig(
        wavlm=tiny_wavlm(), conformer=JaxConformerConfig(dim=32, ffn_hidden=64, num_heads=4,
                                                         num_layers=1),
        wavlm_layer_num=5, wavlm_feat_dim=32, attention_in=32, chunk_size=chunk_size,
        fusion=JaxFusionConfig(hidden=16, num_heads=4, num_fusion_layers=2), num_channels=3)


def port_cfg(cfg) -> McEendConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["wavlm"] = WavLMConfig(**dataclasses.asdict(cfg.wavlm))
    fields["conformer"] = ConformerConfig(**dataclasses.asdict(cfg.conformer))
    fields["fusion"] = FusionConfig(**dataclasses.asdict(cfg.fusion))
    return McEendConfig(**fields)


def perturbed(tree, seed):
    """numpy copy of a pytree with every vector moved by N(0, 0.3^2): the
    fusion norms leave their near-zero start, so the fusions' own path
    shows in the output."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (0.3 * rng.standard_normal(np.shape(x)).astype(np.float32)
                                   if np.ndim(x) == 1 else 0.0), tree)


@pytest.fixture(scope="module")
def mc_model():
    cfg = tiny_mc_cfg()
    params, state = init_eend_mc_params(jax.random.PRNGKey(0), cfg, cfg.fusion)
    params = perturbed(params, 1)
    state = jax.tree_util.tree_map(np.asarray, state)
    model = McEendModel(port_cfg(cfg))
    model.load_state_dict(eend_mc_state_dict_from_jax(params, state, cfg), strict=True)
    wave = (0.1 * np.random.default_rng(2).standard_normal((2, 3, 2000))).astype(np.float32)
    return cfg, params, state, model.eval(), wave


@pytest.mark.parametrize("kind, hidden", [("cross_attention", 16), ("tac", 48)])
def test_fusion_matches_jax(kind, hidden):
    jfcfg = JaxFusionConfig(kind=kind, hidden=hidden, num_heads=4, num_fusion_layers=1)
    params = perturbed(init_fusions(jax.random.PRNGKey(3), 32, jfcfg)[0], 4)
    x = np.random.default_rng(5).standard_normal((2, 3, 10, 32)).astype(np.float32)
    want, want_att = apply_fusion(params, jfcfg, jnp.asarray(x))

    fusion = make_fusions(32, FusionConfig(**dataclasses.asdict(jfcfg)))[0]
    fusion.load_state_dict(fusion_state_dict_from_jax(params, kind), strict=True)
    with torch.no_grad():
        got, att = fusion(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(att.numpy(), np.asarray(want_att), rtol=1e-5, atol=1e-5)
    assert att.shape == ((2, 10, 4, 3, 3) if kind == "cross_attention" else (2, 10, 1, 3, 3))
    # the state dict carries back through the JAX converter exactly
    back = fusion_params_from_torch(fusion.state_dict(), kind)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    # a fresh fusion starts near the identity, as the JAX init does
    fresh = make_fusions(32, FusionConfig(kind=kind))[0]
    norm = fresh.ln_norm if kind == "cross_attention" else fresh.norm
    assert torch.all(norm.weight == 1e-2)


def test_mc_hidden_states_match_jax(mc_model):
    cfg, params, _, model, wave = mc_model
    want_hidden, want_att = wavlm_extract_features_mc(
        params["wavlm"], cfg.wavlm, params["channel_fusions"], cfg.fusion, jnp.asarray(wave))
    wavlm = WavLM(port_cfg(cfg).wavlm)
    wavlm.load_state_dict(wavlm_state_dict_from_jax(params["wavlm"], cfg.wavlm), strict=True)
    with torch.no_grad():
        hidden, att = wavlm_hidden_states_mc(wavlm, model.channel_fusions,
                                             torch.from_numpy(wave))
    f = cfg.num_frames(2000)
    assert len(hidden) == len(want_hidden) == cfg.wavlm.num_layers + 1
    assert [tuple(a.shape) for a in att] == [(2, f, 4, 3, 3)] * 2
    for g, w in zip(hidden + att, list(want_hidden) + list(want_att)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("channels", [None, 2], ids=["all", "truncated"])
def test_mc_eend_matches_jax(mc_model, channels):
    cfg, params, state, model, wave = mc_model
    want, want_att, _ = eend_mc_forward(params, state, cfg, cfg.fusion, jnp.asarray(wave),
                                        num_train_channels=channels)
    with torch.no_grad():
        got, att = model(torch.from_numpy(wave), num_train_channels=channels)
        forward = segmentation_forward(model)(torch.from_numpy(wave))
    c = channels or 3
    assert got.shape == (2, cfg.num_frames(2000), 11) and att.shape == (2, 2, got.shape[1], c, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(att.numpy(), np.asarray(want_att), rtol=1e-4, atol=1e-4)
    if channels is None:
        torch.testing.assert_close(forward, got, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="ResNet"):
        segmentation_forward(ResNet(ResNetConfig(m_channels=4, num_blocks=(1, 1, 1, 1))))


def test_mc_state_dict_round_trip(mc_model):
    cfg, params, state, model, _ = mc_model
    back, back_state = eend_mc_params_from_torch(model.state_dict(), cfg, num_fusions=2)
    for want, got in ((params, back), (state, back_state)):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the builder: wavlm_conformer's weights for the same seed, fusions from
    # seed + 1 starting at the identity's neighbourhood
    kwargs = dict(wavlm_src="wavlm_base_s80_md", num_fusion_layers=2, fusion_hidden=64,
                  fusion_heads=4, num_channels=4, num_layer=1, seed=7)
    mc_cfg, mc = wavlm_conformer_mc(**kwargs)
    _, single = wavlm_conformer(wavlm_src="wavlm_base_s80_md", num_layer=1, seed=7)
    assert mc_cfg.num_channels == 4 and mc_cfg.fusion.hidden == 64
    sd, base = mc.state_dict(), single.state_dict()
    assert set(sd) - set(base) == {k for k in sd if k.startswith("channel_fusions.")}
    assert all(torch.equal(sd[k], v) for k, v in base.items())
    assert torch.all(sd["channel_fusions.1.ln_norm.weight"] == 1e-2)


def test_attention_weighted_embeddings_equal_jax():
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((5, 3, 4, 16))
    att = rng.random((5, 4, 10, 3, 3)).astype(np.float32)
    for layer in (1, 3):
        np.testing.assert_array_equal(attention_weighted_embeddings(emb, att, layer),
                                      jax_weighted_embeddings(emb, att, layer))


def test_mc_pipeline_rttm_equals_jax():
    """3-channel 4 s audio with AHC, 1 s windows (one batch of 4 and a
    shifted tail in the port, a zero-padded one in JAX): the RTTM, two
    speakers in four turns, equals the JAX pipeline's."""
    cfg = tiny_mc_cfg(chunk_size=1.0)
    params, state = init_eend_mc_params(jax.random.PRNGKey(0), cfg, cfg.fusion)
    params = perturbed(params, 11)
    # widen the powerset scores so argmax decisions sit far from ties
    params["classifier"]["w"] = params["classifier"]["w"] * 100.0
    state = jax.tree_util.tree_map(np.asarray, state)
    rcfg = JaxResNetConfig(m_channels=8, num_blocks=(1, 1, 1, 1), embed_dim=32)
    rparams = jax.tree_util.tree_map(np.asarray, init_resnet_params(jax.random.PRNGKey(1), rcfg))
    t = np.arange(4 * 16000) / 16000
    rng = np.random.default_rng(0)
    tone = np.where(t < 2.0, np.sin(2 * np.pi * 220 * t), np.sin(2 * np.pi * 430 * t))
    wave = np.stack([g * tone for g in (0.2, 0.14, 0.1)])
    wave = (wave + 0.05 * rng.standard_normal(wave.shape)).astype(np.float32)

    seg_jax = JaxMcSlidingInference(params, state, cfg, cfg.fusion, num_channels=3,
                                    batch_size=4, compute_dtype=jnp.float32)
    emb_jax = JaxEmbeddingInference(rparams, rcfg, window_size=seg_jax.window_size,
                                    num_speakers=4, batch_size=4)
    expected = JaxMcPipeline(seg_jax, emb_jax, JaxAHC(threshold=0.7, min_cluster_size=2), cfg,
                             max_speakers=4, fusion_layer=1)(wave, 16000, uri="mc").to_rttm()

    model = McEendModel(port_cfg(cfg))
    model.load_state_dict(eend_mc_state_dict_from_jax(params, state, cfg), strict=True)
    resnet = ResNet(ResNetConfig(m_channels=8, num_blocks=(1, 1, 1, 1), embed_dim=32))
    resnet.load_state_dict(resnet_state_dict_from_jax(rparams, rcfg))
    seg = SlidingInference(model, batch_size=4, compute_dtype=torch.float32, device="cpu")
    assert seg.num_channels == 3
    emb = EmbeddingInference(resnet, seg.window_size, num_speakers=4, batch_size=4, device="cpu")
    # the multi-channel recipe's plain masks; fusion 1, the last of two, weighs the channels
    pipe = DiarizationPipeline(seg, emb, AgglomerativeClustering(threshold=0.7,
                                                                 min_cluster_size=2),
                               model.cfg, max_speakers=4, embedding_exclude_overlap=False)
    got = pipe(wave, 16000, uri="mc").to_rttm()
    assert len({line.split()[7] for line in expected.splitlines()}) == 2  # two speakers found
    assert got == expected
