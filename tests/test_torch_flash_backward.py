"""The trainable gated-bias attention of the port (K1 with dropout, K2)
against the JAX package on the CPU.

The attention-dropout mask is a hash that both packages compute in uint32
arithmetic, so it must agree bit for bit; the port's plain trainable
version (what the wrapper takes for CPU tensors) must agree with the JAX
package's `flash_attention_gated_bias_trainable` (its Pallas forward and
backward kernels in interpret mode) in the output and all five gradients.
The CUDA kernels themselves are held against this plain version on the card
by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diarizen_tpu.ops.flash_attention import _dropout_mask
from diarizen_tpu.ops.flash_attention import (
    flash_attention_gated_bias_trainable as jax_trainable,
)
from diarizen_tpu_torch.ops.flash_attention import (
    SCRATCH_SHARE,
    chunk_bounds,
    dropout_constants,
    dropout_mask,
    flash_attention_gated_bias,
    flash_attention_gated_bias_reference,
    flash_attention_gated_bias_trainable,
    pack_keep_bits,
    pass_a_chunks,
    softmax_mode_scope,
    unpack_keep_bits,
)


@pytest.mark.parametrize("rate", [0.1, 0.25])
@pytest.mark.parametrize("seed", [0, 7, 123456789, 2**31 - 2])
def test_dropout_mask_matches_jax_bit_for_bit(seed, rate):
    rows, cols = 37, 131  # odd shapes
    full = dropout_mask(seed, 14, 12, rows, cols, rate)
    for b, h in [(0, 0), (1, 0), (0, 5), (13, 11)]:
        want = np.asarray(_dropout_mask(jnp.int32(seed), b, h, (rows, cols), rate))
        np.testing.assert_array_equal(full[b, h].numpy(), want, err_msg=f"b={b} h={h}")
    kept = float((full > 0).float().mean())
    assert abs(kept - (1 - rate)) < 0.02
    assert dropout_constants(rate)[0] == int(rate * (2**32 - 1))


@pytest.mark.parametrize("t", [37, 70])
def test_packed_keep_mask_matches_jax_bit_for_bit(t):
    """The packed keep mask K2's pass A writes and pass B reads instead of
    hashing: `pack_keep_bits` of the port's mask holds the JAX package's
    `_dropout_mask` bit for bit in (B, H, KB, TP, 2) words (bit k of word w
    of row r in key block j: key 64 j + 32 w + k), zero past T in both
    directions (T 70: a ragged last word and key block); `unpack_keep_bits`
    gives the mask back."""
    b, h, rate, seed = 2, 3, 0.1, 20240917
    packed = pack_keep_bits(dropout_mask(seed, b, h, t, t, rate))
    kb = -(-t // 64)
    assert tuple(packed.shape) == (b, h, kb, 64 * kb, 2) and packed.dtype == torch.int32
    words = packed.numpy().view(np.uint32)
    want = np.stack([np.stack([np.asarray(_dropout_mask(jnp.int32(seed), bi, hi, (t, t), rate)) > 0
                               for hi in range(h)]) for bi in range(b)])
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1  # (B, H, KB, TP, 2, 32)
    full = bits.transpose(0, 1, 3, 2, 4, 5).reshape(b, h, 64 * kb, 64 * kb).astype(bool)
    np.testing.assert_array_equal(full[:, :, :t, :t], want)
    assert not full[:, :, t:].any() and not full[:, :, :, t:].any()
    np.testing.assert_array_equal(unpack_keep_bits(packed, t).numpy(), want)


def _arrays(b, h, t, d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(4))
    pos = rng.standard_normal((h, t, t)).astype(np.float32)
    gate = rng.uniform(1.0, 2.0, (b, h, t)).astype(np.float32)
    return (q, k, v, pos, gate), do


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("t", [64, 130])
def test_trainable_attention_matches_jax(t, rate):
    seed = 20240917
    inputs, do = _arrays(2, 3, t, 64, seed=t)
    out, vjp = jax.vjp(
        lambda *a: jax_trainable(*a, dropout_rate=rate, seed=jnp.int32(seed)),
        *(jnp.asarray(a) for a in inputs))
    want_grads = vjp(jnp.asarray(do))

    tensors = [torch.from_numpy(a).requires_grad_() for a in inputs]
    got = flash_attention_gated_bias_trainable(*tensors, dropout_rate=rate, seed=seed)
    got.backward(torch.from_numpy(do))
    # f32 on both sides: reassociation only (the mask is exact)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=2e-4, atol=2e-4)
    for name, x, want in zip(("q", "k", "v", "pos_bias", "gate"), tensors, want_grads):
        want = np.asarray(want)
        np.testing.assert_allclose(x.grad.numpy(), want, rtol=2e-3,
                                   atol=2e-3 * max(1.0, float(np.abs(want).max())),
                                   err_msg=f"d{name}")


def test_cpu_wrappers_take_the_plain_version():
    inputs, _ = _arrays(1, 2, 16, 8, seed=1)
    q, k, v, pos, gate = (torch.from_numpy(a) for a in inputs)
    # training in "f32"; inference with dropout only under the "f32"
    # schedule (K1 has no dropout instance of the others)
    plain = flash_attention_gated_bias_reference(q, k, v, pos, gate, 0.25, seed=3)
    with softmax_mode_scope("f32"):
        torch.testing.assert_close(flash_attention_gated_bias(q, k, v, pos, gate, 0.25, seed=3),
                                   plain, rtol=0, atol=0)
    for mode in ("deferred", "bf16"):
        with softmax_mode_scope(mode), pytest.raises(ValueError, match="f32"):
            flash_attention_gated_bias(q, k, v, pos, gate, 0.25, seed=3)
    torch.testing.assert_close(
        flash_attention_gated_bias_trainable(q, k, v, pos, gate, 0.25, seed=3),
        plain, rtol=0, atol=0)
    # rate 0 ignores the seed
    torch.testing.assert_close(
        flash_attention_gated_bias_trainable(q, k, v, pos, gate),
        flash_attention_gated_bias_reference(q, k, v, pos, gate), rtol=0, atol=0)
    with pytest.raises(ValueError, match="seed"):
        flash_attention_gated_bias_trainable(q, k, v, pos, gate, 0.1)
    with pytest.raises(ValueError, match="rate"):
        dropout_constants(1.0)


H100_MEMORY = 80 * 10**9  # bytes, the card the plan's cases are computed for


@pytest.mark.parametrize("b,h,t,sms,per_sm", [(16, 12, 399, 132, 2), (1, 12, 399, 132, 2),
                                              (5, 12, 399, 132, 2), (13, 12, 399, 132, 2),
                                              (2, 3, 37, 132, 2), (64, 12, 799, 132, 2),
                                              (16, 12, 399, 132, 1), (7, 1, 64, 8, 3),
                                              (16, 12, 399, 132, 3), (64, 2, 399, 132, 3),
                                              (64, 5, 399, 132, 3), (64, 12, 1499, 132, 3)])
def test_pass_a_plan_puts_each_batch_element_in_one_chunk(b, h, t, sms, per_sm):
    """K2's pass A splits the batch into S chunks of consecutive elements: each
    element in exactly one chunk, no chunk empty, S <= B; the chunks'
    float32 slices fit 1 / SCRATCH_SHARE of the card's memory, and no S the
    plan may take walks fewer batch elements per block slot."""
    s = pass_a_chunks(b, h, t, sms, per_sm, H100_MEMORY)
    bounds = chunk_bounds(b, s)
    assert 1 <= s <= b and len(bounds) == s
    assert bounds[0][0] == 0 and bounds[-1][1] == b
    assert all(b0 < b1 for b0, b1 in bounds)
    assert all(bounds[z][1] == bounds[z + 1][0] for z in range(s - 1))
    slice_bytes = 4 * h * t * t
    most = min(b, max(1, H100_MEMORY // SCRATCH_SHARE // slice_bytes))
    assert s <= most
    blocks = h * -(-t // 64)

    def walk(n):  # rounds of resident blocks x batch elements of the largest chunk
        return -(-blocks * n // (sms * per_sm)) * max(b1 - b0 for b0, b1 in chunk_bounds(b, n))

    assert all(walk(s) < walk(n) or (walk(s) == walk(n) and s >= n) for n in range(1, most + 1))
    # B chunks of one element each walk least, so S = B wherever the slices
    # fit: WavLM-Base training and the MC batch (B 64 = 8 utterances x 8
    # channels) at H 2 and H 5; at T 1499 the cap (23 slices) bites and the
    # walk picks 22 of them
    assert walk(b) == min(walk(n) for n in range(1, b + 1))
    if sms == 132 and per_sm == 3:
        assert s == {399: b, 1499: 22}[t]
    assert (s == b) == (b * slice_bytes <= H100_MEMORY // SCRATCH_SHARE)


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_chunked_dbias_partials_sum_to_the_autograd_dbias(rate):
    """d pos_bias summed per chunk (each chunk's batch elements alone: the
    cotangent zeroed elsewhere) and then over the chunks in chunk order
    equals the plain version's autograd d pos_bias over the batch, for the
    plan's chunks (one element each where the scratch holds every slice)
    and for chunks of unequal sizes (what the plan takes under the scratch
    cap)."""
    b, h, t = 5, 2, 21
    inputs, do = _arrays(b, h, t, 8, seed=5)
    plan = chunk_bounds(b, pass_a_chunks(b, h, t, sms=2, per_sm=2, memory=H100_MEMORY))
    assert plan == [(z, z + 1) for z in range(b)]
    unequal = chunk_bounds(b, 2)
    assert unequal == [(0, 2), (2, 5)]

    def dbias(cotangent):
        leaves = [torch.from_numpy(a).double().requires_grad_() for a in inputs]
        out = flash_attention_gated_bias_reference(*leaves, dropout_rate=rate, seed=11)
        out.backward(torch.from_numpy(cotangent))
        return leaves[3].grad

    total = dbias(do)
    for chunks in (plan, unequal):
        summed = torch.zeros_like(total)
        for b0, b1 in chunks:
            part = np.zeros_like(do)
            part[b0:b1] = do[b0:b1]
            summed = summed + dbias(part)
        torch.testing.assert_close(summed, total, rtol=1e-5, atol=1e-6)
