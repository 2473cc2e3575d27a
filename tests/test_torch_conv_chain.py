"""Kernel K5's plain version and wrapper (diarizen_tpu_torch/ops/conv_chain.py)
against the JAX package's `xla_conv_chain` and its Pallas kernel in interpret
mode, on the same numpy-seeded inputs in float32; and the conv-chain route of
the port's WavLM against the ordinary route and the JAX WavLM."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diarizen_tpu.models.convert import wavlm_params_from_torch
from diarizen_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from diarizen_tpu.models.wavlm import set_flash_attention, wavlm_extract_features
from diarizen_tpu.ops.conv_chain import fused_conv_chain as jax_fused_conv_chain
from diarizen_tpu.ops.conv_chain import xla_conv_chain
from diarizen_tpu_torch.models.convert import random_state_dict
from diarizen_tpu_torch.models.wavlm import (
    WavLM,
    WavLMConfig,
    set_conv_chain,
    use_conv_chain,
)
from diarizen_tpu_torch.ops import conv_chain as k5
from diarizen_tpu_torch.ops import cuda_build

# float32 on both sides, sums in another order: the JAX kernel's own test limits
TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(b, t_out, extra=0, seed=0):
    rng = np.random.default_rng(seed)
    t1 = k5.min_input_frames(t_out) + extra
    x1 = (0.5 * rng.standard_normal((b, t1, k5.C))).astype(np.float32)
    weights = [(rng.standard_normal((k, k5.C, k5.C)) / np.sqrt(k5.C * k)).astype(np.float32)
               for k in k5.KERNELS]
    return x1, weights


@pytest.mark.parametrize("b,t_out,extra", [(1, 1, 0), (2, 32, 0), (1, 65, 0), (2, 1, 40)],
                         ids=["one-frame", "one-tile", "ragged", "longer-input"])
def test_plain_matches_xla_conv_chain(b, t_out, extra):
    x1, weights = _inputs(b, t_out, extra)
    expected = np.asarray(xla_conv_chain(jnp.asarray(x1), [jnp.asarray(w) for w in weights], t_out))
    got = k5.conv_chain_plain(torch.from_numpy(x1), [torch.from_numpy(w) for w in weights], t_out)
    assert got.shape == expected.shape == (b, t_out, k5.C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expected, **TOL)


@pytest.mark.parametrize("b,t_out", [(1, 1), (1, 32), (2, 65)],
                         ids=["one-frame", "one-tile", "ragged"])
def test_wrapper_matches_interpreted_pallas_kernel(b, t_out):
    x1, weights = _inputs(b, t_out, seed=1)
    expected = np.asarray(jax_fused_conv_chain(
        jnp.asarray(x1), [jnp.asarray(w) for w in weights], t_out, interpret=True))
    before = dict(cuda_build.launches)
    got = k5.fused_conv_chain(torch.from_numpy(x1), [torch.from_numpy(w) for w in weights], t_out)
    assert cuda_build.launches == before  # a CPU tensor takes the plain version: no launch
    np.testing.assert_allclose(got.numpy(), expected, **TOL)


def test_packed_weights_and_bfloat16():
    x1, weights = _inputs(1, 2)
    tw = [torch.from_numpy(w) for w in weights]
    packed = k5.pack_weights(tw, torch.float32, "cpu")
    assert packed.flat is None and packed.dtype == torch.float32
    a = k5.fused_conv_chain(torch.from_numpy(x1), packed, 2)
    b = k5.fused_conv_chain(torch.from_numpy(x1), tw, 2)
    assert torch.equal(a, b)
    # bfloat16: the type of the output, and close to float32 at bf16 resolution
    packed16 = k5.pack_weights(tw, torch.bfloat16, "cpu")
    c = k5.fused_conv_chain(torch.from_numpy(x1).bfloat16(), packed16, 2)
    assert c.dtype == torch.bfloat16
    assert float((c.float() - a).abs().max()) <= 2e-2 * max(1.0, float(a.abs().max()))


def test_bfloat16_gemm_packing():
    """The (512 out, k 512) K-major matrix a bfloat16 stage's GEMM reads:
    element [out, tap * 512 + in] is w[tap, in, out]; the packed buffer holds
    the six stages back to back."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((3, k5.C, k5.C)).astype(np.float32))
    packed = k5.gemm_weight(w)
    assert packed.shape == (k5.C, 3 * k5.C)
    for _ in range(64):
        tap, i, o = (int(rng.integers(n)) for n in (3, k5.C, k5.C))
        assert packed[o, tap * k5.C + i] == w[tap, i, o]
    assert k5.num_output_frames(k5.min_input_frames(7)) == 7
    assert k5.num_output_frames(k5.min_input_frames(7) - 1) == 6
    assert sum(k5.KERNELS) * k5.C * k5.C == 16 * k5.C * k5.C  # the flat buffer's length
    assert k5.CUDA_LAUNCHES == {torch.bfloat16: 6, torch.float32: 1}


@pytest.mark.parametrize("t_out", [1, 7, 65])
def test_stage_frames_are_what_the_next_stage_reads(t_out):
    frames = k5.stage_frames(t_out)
    assert len(frames) == 6 and frames[-1] == t_out
    for s in range(5):  # stage s + 1 reads frames 0 .. 2 (T - 1) + k - 1 of stage s's output
        assert 2 * (frames[s + 1] - 1) + k5.KERNELS[s + 1] == frames[s]
    assert 2 * (frames[0] - 1) + k5.KERNELS[0] == k5.min_input_frames(t_out)


def _implicit_gemm_chain(x1, weights, t_out):
    """The bfloat16 kernel's formulation in torch: per stage, row t of the A
    operand is the strided view of input frames 2 t .. 2 t + k - 1 (no
    copy), times the stage's packed matrix, GELU in float32, rounded."""
    x = x1
    for k, w, t_s in zip(k5.KERNELS, weights, k5.stage_frames(t_out)):
        b, t_in, c = x.shape
        rows = x.contiguous().as_strided((b, t_s, k * c), (t_in * c, 2 * c, 1))
        y = torch.matmul(rows.float(), k5.gemm_weight(w).float().t())
        x = torch.nn.functional.gelu(y).to(x1.dtype)
    return x


@pytest.mark.parametrize("b,t_out,extra", [(1, 1, 0), (2, 5, 1), (1, 9, 37), (3, 3, 64)],
                         ids=["one-frame", "odd-extra", "ragged", "longer-input"])
def test_implicit_gemm_matches_plain_and_xla_conv_chain(b, t_out, extra):
    x1, weights = _inputs(b, t_out, extra, seed=6)
    tw = [torch.from_numpy(w) for w in weights]
    got = _implicit_gemm_chain(torch.from_numpy(x1), tw, t_out)
    plain = k5.conv_chain_plain(torch.from_numpy(x1), tw, t_out)
    expected = np.asarray(xla_conv_chain(jnp.asarray(x1), [jnp.asarray(w) for w in weights], t_out))
    assert got.shape == plain.shape == (b, t_out, k5.C)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), expected, **TOL)
    # bfloat16: each stage rounded, as the plain version rounds it
    x16 = torch.from_numpy(x1).bfloat16()
    w16 = [w.bfloat16() for w in tw]
    got16 = _implicit_gemm_chain(x16, w16, t_out).float()
    plain16 = k5.conv_chain_plain(x16, w16, t_out).float()
    assert float((got16 - plain16).abs().max()) <= 2e-2 * float(plain16.abs().max())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x1, weights = _inputs(1, 1)
    x, tw = torch.from_numpy(x1), [torch.from_numpy(w) for w in weights]
    with pytest.raises(ValueError, match=r"\(B, T1, 512\)"):
        k5.fused_conv_chain(x[..., :256], tw, 1)
    with pytest.raises(ValueError, match="input frames"):
        k5.fused_conv_chain(x, tw, 2)  # 79 frames hold one output frame
    with pytest.raises(ValueError, match="t_out >= 1"):
        k5.fused_conv_chain(x, tw, 0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k5.fused_conv_chain(x.double(), tw, 1)
    with pytest.raises(ValueError, match="expected 6 weights"):
        k5.fused_conv_chain(x, tw[:5], 1)
    with pytest.raises(ValueError, match=r"\(tap, in, out\)"):
        k5.fused_conv_chain(x, tw[:4] + [tw[0], tw[5]], 1)
    with pytest.raises(ValueError, match="weights are torch.float32"):
        k5.fused_conv_chain(x.bfloat16(), k5.pack_weights(tw, torch.float32, "cpu"), 1)
    with pytest.raises(ValueError, match="no gradient"):
        k5.fused_conv_chain(x.clone().requires_grad_(), tw, 1)
    with pytest.raises(ValueError, match="no gradient"):
        k5.fused_conv_chain(x, [w.clone().requires_grad_() for w in tw], 1)


@pytest.fixture(scope="module")
def base_type_wavlm():
    """WavLM-Base's extractor (512 channels, GroupNorm on layer 0 only) over
    a two-layer narrow encoder, seeded random weights, and the same weights
    as the JAX package's pytree."""
    fields = dict(embed_dim=64, num_layers=2, use_attention=(True, True),
                  use_feed_forward=(True, True), total_num_heads=(4, 4),
                  remaining_heads=((0, 1, 2, 3), (1, 3)), ff_interm_features=(48, 32),
                  pos_conv_kernel=16, pos_conv_groups=4, num_buckets=40, max_distance=100)
    cfg = dataclasses.replace(WavLMConfig.base(), **fields)
    jcfg = dataclasses.replace(JaxWavLMConfig.base(), **fields)
    model = WavLM(cfg)
    sd = random_state_dict(model, seed=3)
    rng = np.random.default_rng(4)
    sd["feature_extractor.dummy_weight"] = torch.from_numpy(
        rng.uniform(0.5, 1.5, 512).astype(np.float32))
    model.load_state_dict(sd)
    wave = (0.1 * rng.standard_normal((2, 4000))).astype(np.float32)
    return cfg, jcfg, model.eval(), wave


def test_wavlm_conv_chain_route_matches_ordinary_route(base_type_wavlm):
    cfg, _, model, wave = base_type_wavlm
    assert not use_conv_chain()  # off by default
    weights = torch.ones(cfg.num_layers + 1)
    x = torch.from_numpy(wave)
    try:
        with torch.inference_mode():
            off = model(x, weights)
            set_conv_chain(True)
            assert use_conv_chain() and model._conv_chain_applies(train=False)
            assert not model._conv_chain_applies(train=True)
            on = model(x, weights)
            packed = model._conv_chain_weights(torch.float32, x.device)
            assert model._conv_chain_weights(torch.float32, x.device) is packed  # cached
        # a training forward keeps the ordinary route, and stays differentiable
        out = model(x, weights, train=True)
        out.sum().backward()
        assert model.feature_extractor.conv_layers[3].conv.weight.grad is not None
    finally:
        set_conv_chain(None)
    assert on.shape == off.shape == (2, cfg.num_frames(4000), 64)
    assert float((on - off).abs().max()) <= 1e-5
    # a parameter update invalidates the packed weights
    with torch.no_grad():
        model.feature_extractor.conv_layers[2].conv.weight.mul_(1.0)
    assert model._conv_chain_weights(torch.float32, x.device) is not packed


def test_conv_chain_route_applies_only_to_the_extractor_it_fits():
    set_conv_chain(True)
    try:
        for cfg in (WavLMConfig.base_s80_md(), WavLMConfig.large_s80_md(), WavLMConfig.large(),
                    dataclasses.replace(WavLMConfig.base(), conv_bias=True)):
            probe = WavLM.__new__(WavLM)  # the rule reads the configuration only
            probe.cfg = cfg
            assert not WavLM._conv_chain_applies(probe, train=False)
        probe.cfg = WavLMConfig.base()
        assert WavLM._conv_chain_applies(probe, train=False)
    finally:
        set_conv_chain(None)
    assert not WavLM._conv_chain_applies(probe, train=False)


def test_wavlm_conv_chain_route_matches_jax(base_type_wavlm):
    cfg, jcfg, model, wave = base_type_wavlm
    params = wavlm_params_from_torch(model.state_dict(), jcfg)
    set_flash_attention(True)
    try:
        expected = wavlm_extract_features(params, jcfg, jnp.asarray(wave))
    finally:
        set_flash_attention(None)
    num_states = cfg.num_layers + 1
    set_conv_chain(True)
    try:
        with torch.inference_mode():
            for i in (0, num_states - 1):
                got = model(torch.from_numpy(wave), torch.eye(num_states)[i])
                np.testing.assert_allclose(got.numpy(), np.asarray(expected[i]), rtol=5e-4,
                                           atol=5e-4, err_msg=f"hidden state {i}")
    finally:
        set_conv_chain(None)
