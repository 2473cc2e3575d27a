"""Port WavLM + Conformer + powerset head against the JAX package.

Tiny heterogeneous pruned configurations (a layer without attention, one
without a feed-forward, uneven head subsets), in the Base and the Large
layout, are initialised in JAX; their weights go through
`eend_state_dict_from_jax` into the port, and both packages run the same
numpy waveforms in float32. The JAX side runs its Pallas attention kernel
in interpret mode.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from diarizen_tpu.models.conformer import ConformerConfig as JaxConformerConfig
from diarizen_tpu.models.convert import eend_params_from_torch
from diarizen_tpu.models.eend import EendConfig as JaxEendConfig
from diarizen_tpu.models.eend import eend_forward, init_eend_params
from diarizen_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from diarizen_tpu.models.wavlm import set_flash_attention, wavlm_extract_features
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.convert import eend_state_dict_from_jax
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models import wavlm as port_wavlm
from diarizen_tpu_torch.models.wavlm import WavLMConfig
from diarizen_tpu_torch.ops.flash_attention import bias_row_stride, padded_bias

# float32 on both sides: reassociation differences only
TOL = dict(rtol=5e-4, atol=5e-4)


def port_config(cfg: JaxEendConfig) -> EendConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["wavlm"] = WavLMConfig(**dataclasses.asdict(cfg.wavlm))
    fields["conformer"] = ConformerConfig(**dataclasses.asdict(cfg.conformer))
    return EendConfig(**fields)


def _perturbed(params, rng):
    """Move every vector leaf (norms, biases, gates, weight-norm g) off its
    init so a swapped or dropped one shows up."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (0.1 * rng.standard_normal(x.shape).astype(np.float32)
                                   if np.ndim(x) == 1 else 0.0), params)


# Base-style: GroupNorm extractor, post-LN. Large-style: LayerNorm
# extractor with conv bias, pre-LN, waveform normalisation.
STYLES = {
    "base-style": dict(),
    "large-style": dict(extractor_mode="layer_norm", conv_bias=True,
                        layer_norm_first=True, normalize_waveform=True),
}


@pytest.fixture(scope="module", params=sorted(STYLES))
def models(request):
    n = 3
    wavlm = JaxWavLMConfig(
        conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)),
        embed_dim=64, num_layers=n,
        use_attention=(True, False, True), use_feed_forward=(True, True, False),
        total_num_heads=(4,) * n, remaining_heads=((0, 2), (), (1, 2, 3)),
        ff_interm_features=(48, 32, 40), num_buckets=40, max_distance=100,
        layer_drop=0.0, **STYLES[request.param],
    )
    cfg = JaxEendConfig(
        wavlm=wavlm,
        conformer=JaxConformerConfig(dim=32, ffn_hidden=64, num_heads=4, num_layers=2),
        wavlm_layer_num=n + 1, wavlm_feat_dim=64, attention_in=32,
    )
    rng = np.random.default_rng(0)
    params, state = init_eend_params(jax.random.PRNGKey(0), cfg)
    params = _perturbed(params, rng)
    params["wavlm"]["feature_extractor"]["output_scale"] = rng.uniform(
        0.5, 1.5, 32).astype(np.float32)
    state = jax.tree_util.tree_map(np.asarray, state)
    for s in state["conformer"]["blocks"]:
        s["bn"]["mean"] = (0.1 * rng.standard_normal(32)).astype(np.float32)
        s["bn"]["var"] = rng.uniform(0.5, 1.5, 32).astype(np.float32)
        s["bn"]["var"][:4] = 1e-5  # where BatchNorm's eps matters

    model = EendModel(port_config(cfg))
    model.load_state_dict(eend_state_dict_from_jax(params, state, cfg))
    wave = (0.1 * rng.standard_normal((2, 2000))).astype(np.float32)
    return cfg, params, state, model.eval(), wave


def test_wavlm_hidden_states_match_jax(models):
    cfg, params, _, model, wave = models
    set_flash_attention(True)
    try:
        expected = wavlm_extract_features(params["wavlm"], cfg.wavlm, jax.numpy.asarray(wave))
    finally:
        set_flash_attention(None)
    num_states = cfg.wavlm.num_layers + 1
    with torch.no_grad():
        for i in range(num_states):
            # a one-hot layer weighting returns hidden state i exactly
            got = model.wavlm_model(torch.from_numpy(wave), torch.eye(num_states)[i])
            np.testing.assert_allclose(got.numpy(), np.asarray(expected[i]), **TOL,
                                       err_msg=f"hidden state {i}")


def test_eend_scores_match_jax(models):
    cfg, params, state, model, wave = models
    set_flash_attention(True)
    try:
        expected, _ = eend_forward(params, state, cfg, jax.numpy.asarray(wave))
    finally:
        set_flash_attention(None)
    with torch.no_grad():
        got = model(torch.from_numpy(wave))
    assert got.shape == expected.shape == (2, cfg.num_frames(2000), cfg.num_powerset_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


def test_state_dict_round_trips_through_jax_converter(models):
    cfg, params, state, model, _ = models
    back_params, back_state = eend_params_from_torch(model.state_dict(), cfg)
    for original, back in ((params, back_params), ({"conformer": state["conformer"]}, back_state)):
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(original)
        for a, b in zip(jax.tree_util.tree_leaves(original), jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_layers_hand_the_kernel_its_padded_bias_rows(models, monkeypatch):
    """Inference makes the position bias once per forward as a padded
    (H, T, ldbias) buffer; every attention layer, with contiguous or
    scattered remaining heads, hands the kernel a `[..., :T]` view of it in
    the kernels' layout, holding the training route's values."""
    cfg, _, _, model, wave = models
    seen = []
    original = port_wavlm.flash_attention_gated_bias

    def spy(q, k, v, pos_bias, gate, *args, **kwargs):
        seen.append(pos_bias)
        return original(q, k, v, pos_bias, gate, *args, **kwargs)

    monkeypatch.setattr(port_wavlm, "flash_attention_gated_bias", spy)
    with torch.no_grad():
        model.wavlm_model(torch.from_numpy(wave), torch.ones(cfg.wavlm.num_layers + 1))
    t = cfg.num_frames(2000)
    heads = [h for h, a in zip(cfg.wavlm.remaining_heads, cfg.wavlm.use_attention) if a]
    assert [tuple(p.shape) for p in seen] == [(len(h), t, t) for h in heads]
    with torch.no_grad():
        exact = model.wavlm_model._position_bias(t, torch.float32, torch.device("cpu"), train=True)
    for pos, h in zip(seen, heads):
        assert pos.stride() == (t * bias_row_stride(t), bias_row_stride(t), 1)
        assert padded_bias(pos, torch.float32) is pos  # no copy before the kernel
        torch.testing.assert_close(pos, exact[list(h)], rtol=0, atol=0)


@pytest.mark.parametrize("t", [37, 1100], ids=["T37", "T1100-clipped"])
def test_conformer_relative_positions_match_jax(t):
    """`use_posi`: relative-position key scores from one shared table, the
    offsets clipped to the table beyond posi_maxlen (a short table makes the
    clipping show at T 1100); outputs against JAX and the converter round
    trip exact."""
    from diarizen_tpu.models.conformer import conformer_forward, init_conformer_params
    from diarizen_tpu.models.convert import conformer_params_from_torch
    from diarizen_tpu_torch.models.conformer import Conformer
    from diarizen_tpu_torch.models.convert import conformer_state_dict_from_jax

    jcfg = JaxConformerConfig(dim=32, ffn_hidden=48, num_heads=4, num_layers=2, use_posi=True,
                              posi_maxlen=500)
    rng = np.random.default_rng(4)
    params, state = init_conformer_params(jax.random.PRNGKey(2), jcfg)
    params = _perturbed(params, rng)
    params["pos_emb"] = rng.standard_normal(params["pos_emb"].shape).astype(np.float32)
    state = jax.tree_util.tree_map(np.asarray, state)
    x = rng.standard_normal((2, t, 32)).astype(np.float32)
    expected, _ = conformer_forward(params, state, jcfg, jax.numpy.asarray(x))

    model = Conformer(ConformerConfig(**dataclasses.asdict(jcfg))).eval()
    model.load_state_dict(conformer_state_dict_from_jax(params, state))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)

    back_params, back_state = conformer_params_from_torch(model.state_dict(), jcfg)
    for original, back in ((params, back_params), (state, back_state)):
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(original)
        for a, b in zip(jax.tree_util.tree_leaves(original), jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
