"""The port's WavLM presets and configuration constructors against the JAX
package's, field for field; and a pre-LN model with a LayerNorm in every
extractor block, a normalised waveform and 16 heads with pruned subsets (the
Large-s80 layout at small width) against the JAX forward in float32."""

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
from diarizen_tpu.models.wavlm import set_flash_attention
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.convert import eend_state_dict_from_jax
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.wavlm import WavLM, WavLMConfig

PRESETS = ["wavlm_base", "wavlm_base_plus", "wavlm_large", "wavlm_base_s80_md",
           "wavlm_large_s80_md"]


@pytest.mark.parametrize("name", PRESETS)
def test_from_preset_equals_jax(name):
    got, want = WavLMConfig.from_preset(name), JaxWavLMConfig.from_preset(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.head_dim == want.head_dim == 64
    assert got.frame_stride == want.frame_stride == 320
    assert got.conv_out_channels == want.conv_out_channels
    assert got.num_frames(128000) == want.num_frames(128000) == 399
    assert WavLMConfig.from_preset(name.upper()) == got  # names are case-insensitive


@pytest.mark.parametrize("method", ["base", "large", "base_s80_md", "large_s80_md"])
def test_preset_methods_equal_jax(method):
    got, want = getattr(WavLMConfig, method)(), getattr(JaxWavLMConfig, method)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]


def test_unknown_preset_raises_like_jax():
    for cls in (WavLMConfig, JaxWavLMConfig):
        with pytest.raises(ValueError, match="unknown preset wavlm_huge"):
            cls.from_preset("wavlm_huge")


@pytest.mark.parametrize("name", ["wavlm_base", "wavlm_large_s80_md"])
def test_from_dict_round_trip(name):
    import json

    cfg = WavLMConfig.from_preset(name)
    payload = json.loads(json.dumps(dataclasses.asdict(cfg)))  # tuples become lists
    assert WavLMConfig.from_dict(payload) == cfg
    assert dataclasses.asdict(JaxWavLMConfig.from_dict(payload)) == dataclasses.asdict(cfg)


REFERENCE_DICT = dict(
    extractor_mode="layer_norm",
    extractor_conv_layer_config=[[16, 10, 5], [24, 3, 2], [32, 2, 2]],
    extractor_conv_bias=False,
    encoder_embed_dim=128,
    encoder_projection_dropout=0.05,
    encoder_pos_conv_kernel=16,
    encoder_pos_conv_groups=4,
    encoder_num_layers=3,
    encoder_use_attention=[True, False, True],
    encoder_use_feed_forward=[True, True, False],
    encoder_total_num_heads=[8, 8, 8],
    encoder_remaining_heads=[[0, 3, 5], [], [1, 2, 6, 7]],
    encoder_num_buckets=40,
    encoder_max_distance=100,
    encoder_attention_dropout=0.2,
    encoder_ff_interm_features=[40, 24, 0],
    encoder_ff_interm_dropout=0.1,
    encoder_dropout=0.15,
    encoder_layer_norm_first=True,
    encoder_layer_drop=0.0,
    normalize_waveform=True,
)


def test_from_reference_dict_equals_jax():
    got = WavLMConfig.from_reference_dict(REFERENCE_DICT)
    want = JaxWavLMConfig.from_reference_dict(REFERENCE_DICT)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.layer_norm_first and got.normalize_waveform and got.embed_dim == 128
    # the optional keys fall back to the same defaults
    minimal = {k: v for k, v in REFERENCE_DICT.items()
               if k not in ("encoder_projection_dropout", "encoder_use_attention",
                            "encoder_use_feed_forward", "encoder_attention_dropout",
                            "encoder_ff_interm_dropout", "encoder_dropout", "encoder_layer_drop")}
    assert dataclasses.asdict(WavLMConfig.from_reference_dict(minimal)) == dataclasses.asdict(
        JaxWavLMConfig.from_reference_dict(minimal))


def test_large_extractor_has_a_layer_norm_in_every_block():
    """Why kernel K5 does not fit WavLM-Large: "layer_norm" mode puts a norm
    between every convolution and its GELU."""
    cfg = dataclasses.replace(
        WavLMConfig.large(), embed_dim=64, num_layers=1, use_attention=(True,),
        use_feed_forward=(True,), total_num_heads=(1,), remaining_heads=((0,),),
        ff_interm_features=(8,), conv_layers=tuple((8, k, s) for _, k, s in
                                                   WavLMConfig.large().conv_layers))
    blocks = WavLM(cfg).feature_extractor.conv_layers
    assert all(isinstance(b.layer_norm, torch.nn.LayerNorm) for b in blocks)
    base = WavLM(dataclasses.replace(cfg, extractor_mode="group_norm")).feature_extractor
    assert [b.layer_norm is not None for b in base.conv_layers] == [True] + [False] * 6


@pytest.fixture(scope="module")
def large_style():
    """Pre-LN, LayerNorm extractor, normalised waveform, 16 total heads of
    which each layer keeps a subset, one layer without attention."""
    n = 4
    fields = dict(
        extractor_mode="layer_norm", conv_layers=((32, 10, 5), (24, 3, 2), (40, 2, 2)),
        embed_dim=128, num_layers=n, use_attention=(True, True, False, True),
        use_feed_forward=(True,) * n, total_num_heads=(16,) * n,
        remaining_heads=((1, 2, 4, 5, 6), (9, 10, 14), (), (0, 15)),
        ff_interm_features=(48, 32, 40, 24), pos_conv_kernel=16, pos_conv_groups=4,
        num_buckets=40, max_distance=100, layer_norm_first=True, layer_drop=0.0,
        normalize_waveform=True)
    jcfg = JaxEendConfig(
        wavlm=JaxWavLMConfig(**fields),
        conformer=JaxConformerConfig(dim=32, ffn_hidden=64, num_heads=4, num_layers=1),
        wavlm_layer_num=n + 1, wavlm_feat_dim=128, attention_in=32)
    cfg = EendConfig(
        wavlm=WavLMConfig(**fields),
        conformer=ConformerConfig(dim=32, ffn_hidden=64, num_heads=4, num_layers=1),
        wavlm_layer_num=n + 1, wavlm_feat_dim=128, attention_in=32)
    rng = np.random.default_rng(7)
    params, state = init_eend_params(jax.random.PRNGKey(1), jcfg)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (0.1 * rng.standard_normal(x.shape).astype(np.float32)
                                   if np.ndim(x) == 1 else 0.0), params)
    state = jax.tree_util.tree_map(np.asarray, state)
    model = EendModel(cfg)
    model.load_state_dict(eend_state_dict_from_jax(params, state, jcfg), strict=True)
    wave = (0.05 * rng.standard_normal((2, 2400)) + 0.3).astype(np.float32)  # an offset to remove
    return jcfg, params, state, model.eval(), wave


def test_pre_ln_model_matches_jax(large_style):
    jcfg, params, state, model, wave = large_style
    assert jcfg.wavlm.head_dim == 8 and model.cfg.wavlm.head_dim == 8
    set_flash_attention(True)
    try:
        expected, _ = eend_forward(params, state, jcfg, jax.numpy.asarray(wave))
    finally:
        set_flash_attention(None)
    with torch.no_grad():
        got = model(torch.from_numpy(wave))
    assert got.shape == expected.shape == (2, jcfg.num_frames(2400), 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-4, atol=1e-4)
    # waveform normalisation: a scaled and shifted input gives the same scores
    with torch.no_grad():
        again = model(torch.from_numpy(3.0 * wave - 1.0))
    np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=1e-3, atol=1e-3)


def test_pre_ln_state_dict_round_trips_through_jax_converter(large_style):
    jcfg, params, state, model, _ = large_style
    keys = model.state_dict().keys()
    assert all(f"wavlm_model.feature_extractor.conv_layers.{i}.layer_norm.weight" in keys
               for i in range(3))
    back_params, back_state = eend_params_from_torch(model.state_dict(), jcfg)
    for original, back in ((params, back_params), ({"conformer": state["conformer"]}, back_state)):
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(original)
        for a, b in zip(jax.tree_util.tree_leaves(original), jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
