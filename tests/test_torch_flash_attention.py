"""Port kernel K1 (gated-bias attention): the plain PyTorch version the
wrapper takes on CPU tensors, held against the JAX package's Pallas kernel
(interpret mode) and its XLA reference on the same numpy inputs. The CUDA
kernel itself is compared with this plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diarizen_tpu.ops.flash_attention import (
    flash_attention_gated_bias as jax_flash,
    xla_attention_gated_bias,
)
from diarizen_tpu_torch.ops.flash_attention import (
    bias_row_stride,
    check_kernel_inputs,
    flash_attention_gated_bias,
    flash_attention_gated_bias_reference,
    flash_attention_gated_bias_trainable,
    padded_bias,
    softmax_mode,
)


def _inputs(b, h, t, d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    pos = rng.standard_normal((h, t, t)).astype(np.float32)
    gate = rng.uniform(1.0, 2.0, (b, h, t)).astype(np.float32)
    return q, k, v, pos, gate


@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("t", [64, 37], ids=["aligned", "ragged"])
def test_port_attention_matches_jax(t, h):
    arrays = _inputs(2, h, t, 64)
    got = flash_attention_gated_bias(*(torch.from_numpy(a) for a in arrays)).numpy()
    pallas = np.asarray(jax_flash(*(jnp.asarray(a) for a in arrays), interpret=True))
    xla = np.asarray(xla_attention_gated_bias(*(jnp.asarray(a) for a in arrays)))
    # f32 reassociation only (same bound as tests/test_flash_attention.py)
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, xla, rtol=2e-4, atol=2e-4)


def test_cpu_wrapper_is_the_plain_version_and_checks_inputs():
    q, k, v, pos, gate = (torch.from_numpy(a) for a in _inputs(1, 2, 16, 8, seed=1))
    # the plain version in the schedule the inference wrapper runs ("deferred")
    torch.testing.assert_close(
        flash_attention_gated_bias(q, k, v, pos, gate),
        flash_attention_gated_bias_reference(q, k, v, pos, gate, softmax_mode=softmax_mode()),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="seed"):
        flash_attention_gated_bias(q, k, v, pos, gate, dropout_rate=0.1)
    with pytest.raises(ValueError, match="pos_bias"):
        flash_attention_gated_bias(q, k, v, pos[:1], gate)
    with pytest.raises(ValueError, match="gate"):
        flash_attention_gated_bias(q, k, v, pos, gate[..., :-1])
    with pytest.raises(ValueError, match="shape"):
        flash_attention_gated_bias(q, k[..., :4], v, pos, gate)


@pytest.mark.parametrize("t", [37, 399])
def test_padded_bias_view_equals_the_contiguous_call(t):
    """The wrappers on a `[..., :T]` view of a padded (H, T, ldbias) buffer,
    as WavLM hands them its position bias, equal the contiguous call: the
    output, and through the trainable function the five gradients."""
    q, k, v, pos, gate = (torch.from_numpy(a) for a in _inputs(1, 2, t, 16, seed=2))
    view = padded_bias(pos, torch.float32)
    assert view.shape == pos.shape and view.stride() == (t * bias_row_stride(t),
                                                         bias_row_stride(t), 1)
    assert bias_row_stride(t) % 8 == 0 and bias_row_stride(t) - t < 8
    assert padded_bias(view, torch.float32) is view  # already in the kernels' layout
    torch.testing.assert_close(flash_attention_gated_bias(q, k, v, view, gate),
                               flash_attention_gated_bias(q, k, v, pos, gate), rtol=0, atol=0)
    do = torch.from_numpy(np.random.default_rng(3).standard_normal(q.shape).astype(np.float32))
    results = []
    for bias in (view, pos):
        leaves = [x.clone().requires_grad_() for x in (q, k, v, bias, gate)]
        out = flash_attention_gated_bias_trainable(*leaves, dropout_rate=0.1, seed=7)
        out.backward(do)
        results.append([out.detach()] + [x.grad for x in leaves])
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernel_input_check_takes_only_padded_bias_rows():
    """What a CUDA tensor must satisfy, checked without a card: the bias
    rows lie a multiple of 8 elements apart (16-byte aligned for TMA)."""
    t = 399
    q, k, v, pos, gate = (torch.from_numpy(a) for a in _inputs(1, 2, t, 64, seed=4))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    check_kernel_inputs(q, k, v, padded_bias(pos, torch.bfloat16), gate)
    for ld in (t, 401, 404):  # contiguous rows, then two strides that are not a multiple of 8
        bad = torch.zeros((2, t, ld), dtype=torch.bfloat16)[..., :t]
        with pytest.raises(ValueError, match="multiple of 8"):
            check_kernel_inputs(q, k, v, bad, gate)
    with pytest.raises(TypeError, match="q's type"):
        check_kernel_inputs(q, k, v, padded_bias(pos, torch.float32), gate)
