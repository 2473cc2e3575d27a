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
    flash_attention_gated_bias,
    flash_attention_gated_bias_reference,
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
    torch.testing.assert_close(
        flash_attention_gated_bias(q, k, v, pos, gate),
        flash_attention_gated_bias_reference(q, k, v, pos, gate), rtol=0, atol=0)
    with pytest.raises(ValueError, match="seed"):
        flash_attention_gated_bias(q, k, v, pos, gate, dropout_rate=0.1)
    with pytest.raises(ValueError, match="pos_bias"):
        flash_attention_gated_bias(q, k, v, pos[:1], gate)
    with pytest.raises(ValueError, match="gate"):
        flash_attention_gated_bias(q, k, v, pos, gate[..., :-1])
    with pytest.raises(ValueError, match="shape"):
        flash_attention_gated_bias(q, k[..., :4], v, pos, gate)
