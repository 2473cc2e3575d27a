"""The port's fused residual + LayerNorm (K3, K4) against the JAX package.

On the CPU the port's wrappers take the plain PyTorch versions and the JAX
functions run their Pallas kernels in interpret mode; the same numpy inputs go
through both. Tolerances: float32 1e-5 (reassociated sums), bfloat16 2e-2 on y
(one output ulp at |y| < 8) and 1e-3 on the float32 accumulator.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diarizen_tpu.models import wavlm as jax_wavlm
from diarizen_tpu.ops import fused_ln as jax_fused_ln
from diarizen_tpu_torch.models import wavlm as port_wavlm
from diarizen_tpu_torch.models.convert import wavlm_state_dict_from_jax
from diarizen_tpu_torch.ops import fused_ln

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
Y_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ACC_TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.standard_normal(shape).astype(np.float32),
        "b": rng.standard_normal(shape).astype(np.float32),
        "gamma": rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32),
        "beta": rng.standard_normal(shape[-1]).astype(np.float32),
        "acc": rng.standard_normal(shape).astype(np.float32),
    }


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 39, 96), (2, 7, 128), (12768 // 16, 768)])
def test_residual_ln_matches_jax(dtype, shape):
    jd, td = DTYPES[dtype]
    x = _inputs(shape, 0)
    expected = jax_fused_ln.residual_ln(
        jnp.asarray(x["a"], jd), jnp.asarray(x["b"], jd), jnp.asarray(x["gamma"]),
        jnp.asarray(x["beta"]))
    a, b = torch.tensor(x["a"]).to(td), torch.tensor(x["b"]).to(td)
    gamma, beta = torch.tensor(x["gamma"]), torch.tensor(x["beta"])
    got = fused_ln.residual_ln(a, b, gamma, beta)
    assert got.dtype == td and got.shape == a.shape
    np.testing.assert_allclose(_f32(got), _f32(expected), rtol=Y_TOL[dtype], atol=Y_TOL[dtype])
    np.testing.assert_array_equal(_f32(got), _f32(fused_ln.residual_ln_plain(a, b, gamma, beta)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 41, 256), (2, 7, 64)])
def test_residual_ln_acc_matches_jax(dtype, shape):
    jd, td = DTYPES[dtype]
    x = _inputs(shape, 1)
    y_ref, acc_ref = jax_fused_ln.residual_ln_acc(
        jnp.asarray(x["a"], jd), jnp.asarray(x["b"], jd), jnp.asarray(x["gamma"]),
        jnp.asarray(x["beta"]), jnp.asarray(0.37, jnp.float32), jnp.asarray(x["acc"]))
    a, b = torch.tensor(x["a"]).to(td), torch.tensor(x["b"]).to(td)
    gamma, beta = torch.tensor(x["gamma"]), torch.tensor(x["beta"])
    acc = torch.tensor(x["acc"])
    y, acc_out = fused_ln.residual_ln_acc(a, b, gamma, beta, torch.tensor(0.37), acc)
    assert acc_out.data_ptr() == acc.data_ptr() and acc_out.dtype == torch.float32  # in place
    np.testing.assert_allclose(_f32(y), _f32(y_ref), rtol=Y_TOL[dtype], atol=Y_TOL[dtype])
    # the accumulator takes the ROUNDED y
    np.testing.assert_allclose(acc.numpy(), x["acc"] + np.float32(0.37) * _f32(y),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_ref), rtol=ACC_TOL[dtype],
                               atol=ACC_TOL[dtype] if dtype == "float32" else 2e-2 * 0.37)
    # a number for w is taken as the JAX function takes it
    y2, _ = fused_ln.residual_ln_acc(a, b, gamma, beta, 0.37, torch.tensor(x["acc"]))
    np.testing.assert_array_equal(_f32(y2), _f32(y))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = {k: torch.tensor(v) for k, v in _inputs((2, 5, 16), 2).items()}
    with pytest.raises(ValueError, match="share one"):
        fused_ln.residual_ln(x["a"], x["b"][:, :4], x["gamma"], x["beta"])
    with pytest.raises(ValueError, match="gamma and beta"):
        fused_ln.residual_ln(x["a"], x["b"], x["gamma"][:8], x["beta"])
    with pytest.raises(ValueError, match="acc must be float32"):
        fused_ln.residual_ln_acc(x["a"], x["b"], x["gamma"], x["beta"], 0.5, x["acc"].double())
    with pytest.raises(ValueError, match="one value"):
        fused_ln.residual_ln_acc(x["a"], x["b"], x["gamma"], x["beta"], torch.ones(2), x["acc"])


@pytest.fixture(scope="module")
def tiny_wavlm():
    """Three layers: full attention, pruned heads without a feed-forward, and
    a layer without attention (the plain norm and K4 alone)."""
    n = 3
    cfg = jax_wavlm.WavLMConfig(
        conv_layers=((16, 10, 5), (16, 4, 4), (16, 4, 4)),
        embed_dim=64, num_layers=n,
        use_attention=(True, True, False),
        use_feed_forward=(True, False, True),
        total_num_heads=(4,) * n,
        remaining_heads=(tuple(range(4)), (1, 3), ()),
        ff_interm_features=(96,) * n,
        num_buckets=40, max_distance=100, layer_drop=0.0,
    )
    params = jax.tree_util.tree_map(np.asarray, jax_wavlm.init_wavlm_params(
        jax.random.PRNGKey(0), cfg))
    model = port_wavlm.WavLM(port_wavlm.WavLMConfig(**dataclasses.asdict(cfg)))
    model.load_state_dict(wavlm_state_dict_from_jax(params, cfg))
    rng = np.random.default_rng(3)
    wave = (0.1 * rng.standard_normal((2, 8000))).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, n + 1).astype(np.float32)
    return cfg, params, model.eval(), wave, weights


@pytest.mark.parametrize("fused", [True, False])
def test_weighted_sum_matches_jax(tiny_wavlm, fused):
    cfg, params, model, wave, weights = tiny_wavlm
    try:
        jax_wavlm.set_fused_ln(fused)
        port_wavlm.set_fused_ln(fused)
        assert port_wavlm.use_fused_ln() is fused
        expected = jax_wavlm.wavlm_extract_features(
            params, cfg, jnp.asarray(wave), train=False, layer_weights=jnp.asarray(weights))
        with torch.inference_mode():
            got = model(torch.tensor(wave), torch.tensor(weights))
    finally:
        jax_wavlm.set_fused_ln(None)
        port_wavlm.set_fused_ln(None)
    assert not port_wavlm.use_fused_ln()  # off by default, as in the JAX package
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-5)


def test_fused_route_runs_the_fused_functions(tiny_wavlm, monkeypatch):
    """With the toggle on: K3 once per layer with attention (and once more
    for a final norm without an accumulator to fold: none here), K4 once per
    layer with a feed-forward; none of either in train mode or when off."""
    cfg, params, model, wave, weights = tiny_wavlm
    calls = {"ln": 0, "acc": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(port_wavlm, "residual_ln", counted("ln", fused_ln.residual_ln))
    monkeypatch.setattr(port_wavlm, "residual_ln_acc", counted("acc", fused_ln.residual_ln_acc))
    x, w = torch.tensor(wave), torch.tensor(weights)
    try:
        port_wavlm.set_fused_ln(True)
        with torch.inference_mode():
            fused_out = model(x, w)
        assert calls == {"ln": 2, "acc": 2}
        model(x, w, train=True)
        assert calls == {"ln": 2, "acc": 2}
        port_wavlm.set_fused_ln(False)
        with torch.inference_mode():
            plain_out = model(x, w)
        assert calls == {"ln": 2, "acc": 2}
    finally:
        port_wavlm.set_fused_ln(None)
    np.testing.assert_allclose(fused_out.numpy(), plain_out.numpy(), rtol=1e-5, atol=1e-5)


def test_backward_matches_jax_vjp():
    """Eval-mode gradients through the port's autograd Functions against the
    JAX custom VJP, for every input, within 2e-5."""
    x = _inputs((2, 9, 64), 4)
    names = ("a", "b", "gamma", "beta", "w", "acc")

    def jax_loss(args):
        y, acc2 = jax_fused_ln.residual_ln_acc(*args)
        return jnp.sum(y * 1.3) + jnp.sum(acc2 * 0.7)

    jargs = tuple(jnp.asarray(x[k]) for k in names[:4]) + (jnp.asarray(0.61, jnp.float32),
                                                          jnp.asarray(x["acc"]))
    expected = jax.grad(jax_loss)(jargs)

    leaves = [torch.tensor(x[k], requires_grad=True) for k in names[:4]]
    leaves += [torch.tensor(0.61, requires_grad=True), torch.tensor(x["acc"], requires_grad=True)]
    a, b, gamma, beta, w, acc = leaves
    y, acc2 = fused_ln.residual_ln_acc(a, b, gamma, beta, w, acc * 1.0)  # acc: not a leaf, in place
    (torch.sum(y * 1.3) + torch.sum(acc2 * 0.7)).backward()
    for name, leaf, want in zip(names, leaves, expected):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5,
                                   err_msg=name)

    def jax_plain(args):
        return jnp.sum(jax_fused_ln.residual_ln(*args) * 0.9)

    expected = jax.grad(jax_plain)(jargs[:4])
    leaves = [torch.tensor(x[k], requires_grad=True) for k in names[:4]]
    torch.sum(fused_ln.residual_ln(*leaves) * 0.9).backward()
    for name, leaf, want in zip(names, leaves, expected):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5,
                                   err_msg=name)
