"""Attention with fused gated relative-position bias: kernels K1 (forward)
and K2 (backward), their plain versions, and the trainable function.

For q, k, v (B, H, T, D), pos_bias (H, T, T) and gate (B, H, T),

    w = softmax(q k^T / sqrt(D) + gate[..., None] * pos_bias)
    o = (w * m) v

with m the attention-dropout keep mask in {0, 1 / (1 - rate)}: a pure hash
of (seed, batch index, head index, row, column), the JAX package's
`_dropout_mask` (`diarizen_tpu/ops/flash_attention.py:165-198`) bit for bit,
so the backward replays the forward's mask and both packages drop the same
weights. The softmax normaliser is summed before the mask is applied.
`head_offset` numbers the heads from an offset: a model rank that holds
heads o .. o + H - 1 of a layer (`parallel/mesh.py`) draws the slice of the
whole layer's mask. The hash is linear in (seed, b, h) before its first
scramble, s0 = seed + b * 0x9E3779B1 + h * 0x85EBCA77 (mod 2^32), so the
kernels take the offset as the seed shifted by o * 0x85EBCA77 (`head_seed`)
and their source knows nothing of it.

K1 replaces the Pallas TPU kernel `diarizen_tpu/ops/flash_attention.py:_kernel`
and K2 its backward `_bwd_kernel`, with the hand-written CUDA kernels of
`csrc/gated_bias_attention.cu` for CUDA tensors; CPU tensors take the plain
PyTorch versions below. On an H100 both kernels are bound by memory traffic
at WavLM's shapes (the source note has the numbers); their design keeps the
(T, T) scores, weights and gated bias out of device memory.

K1 has the TPU kernel's three softmax schedules (`SOFTMAX_MODES`):
"f32" normalises the weights exactly before they are rounded to v's type
for w @ v; "deferred" multiplies the unnormalised exp by v and divides once
at the end; "bf16" is deferred with the exp taken of the shifted scores
rounded to bfloat16. Inference (`flash_attention_gated_bias`) runs the
process-wide schedule, "deferred" unless `set_softmax_mode` or
`softmax_mode_scope` says otherwise; the differentiable function always runs
"f32", as the JAX package pins it for a forward that has a backward. The
TPU kernel compiles the schedule in at trace time; here the wrapper reads
it at each call. At dropout rate 0 the training instance and K2 run
instances without the dropout hash, as the TPU kernels compile no mask
when their static rate is 0. Inference with dropout runs only in "f32"
(the training instance's kernel without lse): no caller of either package
runs it in another schedule, so K1 compiles no such instance.

The kernels read pos_bias as rows of `ldbias` elements, a multiple of 8, so
that every row starts on a 16-byte boundary and its tiles load by TMA and
16-byte copies: `padded_bias` gives that layout, a (H, T, ldbias) buffer's
`[..., :T]` view (WavLM makes one per forward), and the wrappers copy into
one only when handed anything else.

The kernels are compiled with nvcc into `build/diarizen_tpu_torch/` at first
use and bound through ctypes (a plain C interface; the 32 instances take
under a minute). Each launch is counted by instance in `cuda_build`'s
registry (`KERNEL_INSTANCES` "k1", "k1_train" and "k2").
`pass_a_chunks` is the plan that splits K2's pass A across the batch.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from diarizen_tpu_torch.ops.cuda_build import CSRC_DIR, build_library, count, library_path

SOURCE = CSRC_DIR / "gated_bias_attention.cu"
LIBRARY = library_path(SOURCE)


# ---------------------------------------------------------------------------
# the softmax schedule

SOFTMAX_MODES = ("f32", "deferred", "bf16")  # the kernels' schedule numbers, in order
_SOFTMAX_MODE = "deferred"


def _mode_number(mode: str) -> int:
    if mode not in SOFTMAX_MODES:
        raise ValueError(f"softmax mode must be one of {SOFTMAX_MODES}, got {mode!r}")
    return SOFTMAX_MODES.index(mode)


def set_softmax_mode(mode: str) -> None:
    """Select K1's inference softmax schedule ("f32" | "deferred" | "bf16")
    for this process, as the JAX package's `set_softmax_mode` does. The
    differentiable function runs "f32" whatever is set. Read when the
    attention is called (the JAX package reads it when a kernel is traced,
    and a compiled executable keeps its schedule; there is no trace here)."""
    global _SOFTMAX_MODE
    _mode_number(mode)
    _SOFTMAX_MODE = mode


@contextlib.contextmanager
def softmax_mode_scope(mode: str):
    """`set_softmax_mode(mode)` for the calls inside the `with` block; the
    previous schedule comes back on exit, an exception's included. The
    Trainer's steps and validation and the distill-prune step run under
    softmax_mode_scope("f32"), as the JAX package's do."""
    global _SOFTMAX_MODE
    _mode_number(mode)
    previous, _SOFTMAX_MODE = _SOFTMAX_MODE, mode
    try:
        yield
    finally:
        _SOFTMAX_MODE = previous


def softmax_mode() -> str:
    """The schedule an inference call made now would run."""
    return _SOFTMAX_MODE


_lib: Optional[ctypes.CDLL] = None
_U32 = 0xFFFFFFFF


def build() -> str:
    """Compile the kernels for sm_90a unless the library is newer than its
    source; returns the compiler's output (register and shared-memory
    report from ptxas), empty when nothing was built."""
    return build_library(SOURCE)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIBRARY))
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        dropout = [i32, u32, u32, ctypes.c_float]  # on, seed, threshold, keep scale
        lib.gated_bias_attention_fwd.argtypes = ([ptr] * 4 + [i32] + [ptr] * 3 + [i32] * 6
                                                 + dropout + [ptr])
        lib.gated_bias_attention_bwd_a_bf16.argtypes = ([ptr] * 5 + [i32] + [ptr] * 7 + [i32] * 6
                                                        + dropout + [ptr])
        lib.gated_bias_attention_bwd_a_f32.argtypes = ([ptr] * 4 + [i32] + [ptr] * 8 + [i32] * 6
                                                       + dropout + [ptr])
        lib.gated_bias_attention_dbias_sum.argtypes = [ptr] * 2 + [i32] * 4 + [ptr]
        lib.gated_bias_attention_bwd_b_bf16.argtypes = ([ptr] * 5 + [i32] + [ptr] * 4 + [i32] * 5
                                                        + [ctypes.c_float, ptr])
        lib.gated_bias_attention_bwd_b_f32.argtypes = ([ptr] * 4 + [i32] + [ptr] * 6 + [i32] * 4
                                                       + dropout + [ptr])
        lib.gated_bias_attention_bwd_a_blocks_per_sm.argtypes = [i32] * 4
        lib.gated_bias_attention_fwd_bf16_occupancy.argtypes = [i32, ctypes.POINTER(i32)]
        for fn in (lib.gated_bias_attention_fwd, lib.gated_bias_attention_bwd_a_bf16,
                   lib.gated_bias_attention_bwd_a_f32, lib.gated_bias_attention_dbias_sum,
                   lib.gated_bias_attention_bwd_b_bf16, lib.gated_bias_attention_bwd_b_f32,
                   lib.gated_bias_attention_bwd_a_blocks_per_sm,
                   lib.gated_bias_attention_fwd_bf16_occupancy):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def forward_occupancy(head_dim: int) -> Tuple[int, int]:
    """(blocks one SM of the current card holds at once, dynamic shared
    memory of a block in bytes) of K1's bfloat16 kernel."""
    smem = ctypes.c_int(0)
    blocks = _library().gated_bias_attention_fwd_bf16_occupancy(head_dim, ctypes.byref(smem))
    if blocks <= 0:
        raise RuntimeError(f"K1 occupancy query failed: CUDA error {-blocks}")
    return blocks, smem.value


# ---------------------------------------------------------------------------
# the dropout hash


def dropout_constants(rate: float) -> Tuple[int, float]:
    """(threshold, keep value) of the JAX package's mask: keep where the hash
    is >= int(rate * (2^32 - 1)); kept weights scale by float32(1) /
    float32(1 - rate)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return int(rate * (2**32 - 1)), float(np.float32(1.0) / np.float32(1.0 - rate))


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) held in int64, without overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def head_seed(seed: int, head_offset: int) -> int:
    """The seed whose hash at head h is the hash of `seed` at head
    h + head_offset."""
    return (int(seed) + int(head_offset) * 0x85EBCA77) & _U32


def dropout_mask(seed: int, batch: int, heads: int, rows: int, cols: int, rate: float,
                 device=None, head_offset: int = 0) -> torch.Tensor:
    """Float32 (batch, heads, rows, cols) keep mask in {0, 1 / (1 - rate)} of
    the attention-dropout hash at heads head_offset .. head_offset + heads -
    1; uint32 arithmetic held in int64 and masked after every add, multiply
    and left shift."""
    threshold, keep = dropout_constants(rate)
    dev = torch.device("cpu") if device is None else torch.device(device)
    b = torch.arange(batch, device=dev).view(-1, 1, 1, 1)
    h = torch.arange(head_offset, head_offset + heads, device=dev).view(1, -1, 1, 1)
    s0 = (int(seed) & _U32) + _mul32(b, 0x9E3779B1) + _mul32(h, 0x85EBCA77)
    s0 = s0 & _U32
    s0 = s0 ^ (s0 >> 16)
    s0 = _mul32(s0, 0x85EBCA6B)
    s0 = s0 ^ (s0 >> 13)
    s0 = _mul32(s0, 0xC2B2AE35)
    s1 = s0 ^ (s0 >> 16)
    s2 = _mul32(s1, 0x9E3779B1)
    r = torch.arange(rows, device=dev).view(1, 1, -1, 1)
    c = torch.arange(cols, device=dev).view(1, 1, 1, -1)

    def xorshift(x):
        x = x ^ ((x << 13) & _U32)
        x = x ^ (x >> 17)
        return x ^ ((x << 5) & _U32)

    x = ((((r + s1) & _U32) << 16) & _U32) ^ ((c + s2) & _U32)
    x = xorshift(x)
    x = (x + (r ^ ((c << 11) & _U32)) + s1) & _U32
    x = xorshift(x)
    return torch.where(x >= threshold, torch.tensor(keep, dtype=torch.float32, device=dev),
                       torch.tensor(0.0, dtype=torch.float32, device=dev))


# ---------------------------------------------------------------------------
# plain versions


def flash_attention_gated_bias_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos_bias: torch.Tensor,
    gate: torch.Tensor,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    head_offset: int = 0,
    softmax_mode: str = "f32",
) -> torch.Tensor:
    """Plain PyTorch version, differentiable, of the TPU kernel's schedule
    `softmax_mode`: f32 logits (the bias rounded to q's type as the kernels
    read it) less their row max, p = exp of that, the row sum l of p in f32
    before the hashed dropout mask m of heads from `head_offset`, then
      "f32": w = p / l (the math of `xla_attention_gated_bias`), (w m)
              rounded to v's type, times v;
      "deferred": (p m) rounded to v's type, times v in f32, divided by l;
      "bf16": as "deferred" with p = exp of the shifted logits rounded to
              bfloat16, a bfloat16 value, and m in bfloat16.
    The output is in q's type."""
    mode = _mode_number(softmax_mode)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    logits = logits + gate.float()[..., None] * pos_bias.to(q.dtype).float()[None]
    logits = logits - logits.amax(dim=-1, keepdim=True).detach()
    mask = None
    if dropout_rate > 0.0:
        b, h, t, _ = q.shape
        mask = dropout_mask(_need_seed(seed), b, h, t, t, dropout_rate, q.device, head_offset)
    if mode == 0:
        w = torch.softmax(logits, dim=-1)
        if mask is not None:
            w = w * mask
        return torch.matmul(w.to(q.dtype), v).to(q.dtype)
    p = torch.exp(logits.to(torch.bfloat16) if mode == 2 else logits)
    total = p.float().sum(dim=-1, keepdim=True)
    if mask is not None:
        p = p * mask.to(p.dtype)
    return (torch.matmul(p.to(v.dtype).float(), v.float()) / total).to(q.dtype)


KEY_BLOCK = 64  # keys per block of K2's pass B, and per packed keep-mask block


def pack_keep_bits(keep: torch.Tensor) -> torch.Tensor:
    """The keep mask (B, H, T, T) (nonzero: kept) in the packed layout K2's
    pass A writes for pass B, as int32 (B, H, KB, TP, 2) with KB =
    ceil(T / 64) key blocks and TP = 64 KB rows: bit k of word w of row r in
    key block kb is keep[..., r, 64 kb + 32 w + k]; bits past T, in either
    direction, are 0."""
    b, h, t, _ = keep.shape
    kb = -(-t // KEY_BLOCK)
    tp = kb * KEY_BLOCK
    bits = torch.zeros((b, h, tp, tp), dtype=torch.int64, device=keep.device)
    bits[:, :, :t, :t] = (keep != 0).long()
    bits = bits.view(b, h, tp, kb, 2, 32).permute(0, 1, 3, 2, 4, 5)
    weights = torch.tensor([1 << k for k in range(32)], dtype=torch.int64, device=keep.device)
    words = (bits * weights).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_keep_bits(packed: torch.Tensor, t: int) -> torch.Tensor:
    """`pack_keep_bits`' inverse: the bool keep mask (B, H, T, T)."""
    b, h, kb, tp, _ = packed.shape
    words = packed.long() & _U32
    shifts = torch.arange(32, device=packed.device)
    bits = (words[..., None] >> shifts) & 1  # (B, H, KB, TP, 2, 32)
    return bits.permute(0, 1, 3, 2, 4, 5).reshape(b, h, tp, tp)[:, :, :t, :t].bool()


def _need_seed(seed: Optional[int]) -> int:
    if seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    return int(seed)


def _check(q, k, v, pos_bias, gate) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, T, D) shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, t, _ = q.shape
    if tuple(pos_bias.shape) != (h, t, t):
        raise ValueError(f"pos_bias must be {(h, t, t)}, got {tuple(pos_bias.shape)}")
    if tuple(gate.shape) != (b, h, t):
        raise ValueError(f"gate must be {(b, h, t)}, got {tuple(gate.shape)}")
    if len({x.device for x in (q, k, v, pos_bias, gate)}) != 1:
        raise ValueError("q, k, v, pos_bias and gate must be on one device")


BIAS_ALIGN = 8  # elements: a bias row stride that keeps bf16 and f32 rows 16-byte aligned


def bias_row_stride(t: int) -> int:
    """ldbias of a padded (H, T, ldbias) bias: T rounded up to a multiple of 8."""
    return -(-t // BIAS_ALIGN) * BIAS_ALIGN


def _bias_layout_ok(pos_bias: torch.Tensor) -> bool:
    """pos_bias (H, T, T) is rows of ldbias elements, ldbias >= T a multiple
    of 8, heads T * ldbias apart, the first row 16-byte aligned."""
    _, t, _ = pos_bias.shape
    sh, ld, sc = pos_bias.stride()
    return (sc == 1 and ld >= t and ld % BIAS_ALIGN == 0 and sh == t * ld
            and pos_bias.data_ptr() % 16 == 0)


def padded_bias(pos_bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """pos_bias (H, T, T) in `dtype`, laid out as the kernels read it: the
    tensor itself where it already is, else a copy into a zero-padded
    (H, T, bias_row_stride(T)) buffer, of which the `[..., :T]` view is
    returned."""
    if pos_bias.dtype == dtype and _bias_layout_ok(pos_bias):
        return pos_bias
    h, t, _ = pos_bias.shape
    buf = torch.zeros((h, t, bias_row_stride(t)), dtype=dtype, device=pos_bias.device)
    buf[..., :t] = pos_bias
    return buf[..., :t]


def check_kernel_inputs(*tensors) -> None:
    """What the kernels take, whatever the device: q, k, v, pos_bias (and o,
    dO) in one type (float32 or bfloat16), gate in float32, all contiguous
    but pos_bias, which is rows of ldbias elements (`_bias_layout_ok`), q, k,
    v 16-byte aligned, and D <= 128 a multiple of 8."""
    q, k, v, pos_bias, gate = tensors[:5]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if any(x.dtype != q.dtype for x in (k, v, pos_bias, *tensors[5:])):
        raise TypeError("k, v and pos_bias must have q's type")
    if gate.dtype != torch.float32:
        raise TypeError(f"gate must be float32, got {gate.dtype}")
    if not all(x.is_contiguous() for x in tensors if x is not pos_bias):
        raise ValueError("q, k, v, gate (and o, dO) must be contiguous")
    if not _bias_layout_ok(pos_bias):
        raise ValueError(
            f"pos_bias must be rows of a contiguous last dimension with a row stride that is "
            f"a multiple of {BIAS_ALIGN} and >= T, heads T row strides apart, 16-byte "
            f"aligned (padded_bias makes one); got strides {tuple(pos_bias.stride())}")
    d = q.shape[-1]
    if d % 8 or d > 128:
        raise ValueError(f"head dim must be a multiple of 8 and <= 128, got {d}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries")


def _check_cuda(*tensors) -> None:
    if tensors[0].device.type != "cuda":
        raise ValueError(f"unsupported device {tensors[0].device}")
    check_kernel_inputs(*tensors)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------------------------
# kernel wrappers


def _forward(q, k, v, pos_bias, gate, mode: str, rate: float, seed: int, lse: bool):
    """One launch of K1: (o, f32 row log-sum-exp (B, H, T) or None). `lse`:
    the training instance, which writes it; rate 0 takes the instance
    without the dropout hash."""
    pos_bias = padded_bias(pos_bias, q.dtype)
    _check_cuda(q, k, v, pos_bias, gate)
    threshold, keep = dropout_constants(rate)
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    row_lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if lse else None
    if out.numel() == 0:
        return out, row_lse
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.gated_bias_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_bias.data_ptr(), pos_bias.stride(1),
            gate.data_ptr(), out.data_ptr(), None if row_lse is None else row_lse.data_ptr(),
            b, h, t, d, int(q.dtype == torch.bfloat16), _mode_number(mode),
            int(rate > 0.0), int(seed) & _U32, threshold, keep, _stream(q))
    if rc != 0:
        raise RuntimeError(f"gated_bias_attention_fwd launch failed: CUDA error {rc}")
    count(("train" if rate > 0.0 else "train_rate0") if lse else f"fwd_{mode}")
    return out, row_lse


def _forward_train(q, k, v, pos_bias, gate, rate: float, seed: int):
    """K1's training instance, the f32 schedule: (o, f32 row log-sum-exp
    (B, H, T))."""
    return _forward(q, k, v, pos_bias, gate, "f32", rate, seed, lse=True)


BLOCK_Q = 64  # query rows per block of K2's pass A
# pass A's partial d pos_bias slices, (S, H, T, T) float32, take at most
# this share of the card's memory (2.5 GB on an 80 GB card: every path's
# shapes take S = B under it; WavLM-Base at T 1499, B 64 would need 6.9 GB)
SCRATCH_SHARE = 32


def pass_a_chunks(batch: int, heads: int, t: int, sms: int, per_sm: int, memory: int) -> int:
    """S, the number of batch chunks of K2's pass A, whose grid is (heads,
    ceil(t / 64), S) blocks on `sms` multiprocessors that hold `per_sm`
    blocks each at once, on a card of `memory` bytes. At most as many
    chunks as batch elements, and as many as the chunks' (heads, t, t)
    float32 slices fit in 1 / SCRATCH_SHARE of the memory; among those, the
    S whose rounds of resident blocks times the batch elements of its
    largest chunk (the blocks' walk, in batch elements) is least, and the
    most chunks among equals. One element a chunk always walks least, so S
    = B wherever the slices fit, and the walk decides below that cap."""
    blocks = heads * -(-t // BLOCK_Q)
    slots = sms * per_sm
    most = max(1, min(batch, memory // SCRATCH_SHARE // (4 * heads * t * t)))

    def walk(s: int) -> int:
        return -(-blocks * s // slots) * -(-batch // s)

    return min(range(1, most + 1), key=lambda s: (walk(s), -s))


def chunk_bounds(batch: int, chunks: int) -> List[Tuple[int, int]]:
    """[(b0, b1)] of each chunk, in the order the sum adds them: chunk z holds
    batch elements z batch // chunks .. (z + 1) batch // chunks - 1, as the
    kernel computes them."""
    return [(z * batch // chunks, (z + 1) * batch // chunks) for z in range(chunks)]


# (device, type, head dim, dropout, T) -> pass A blocks one multiprocessor holds
_blocks_per_sm = {}


def _pass_a_plan(q: torch.Tensor, rate: float) -> int:
    """`pass_a_chunks` for q (B, H, T, D) on its card, for pass A's instance
    at dropout rate `rate` (with the mask or without)."""
    b, h, t, d = q.shape
    key = (q.device, q.dtype, d, rate > 0.0, t)
    if key not in _blocks_per_sm:
        with torch.cuda.device(q.device):
            per_sm = _library().gated_bias_attention_bwd_a_blocks_per_sm(
                d, int(q.dtype == torch.bfloat16), int(rate > 0.0), t)
        if per_sm <= 0:
            raise RuntimeError(f"K2 pass A occupancy query failed: CUDA error {-per_sm}")
        _blocks_per_sm[key] = per_sm
    card = torch.cuda.get_device_properties(q.device)
    return pass_a_chunks(b, h, t, card.multi_processor_count, _blocks_per_sm[key],
                         card.total_memory)


def _raise_on(rc: int, entry: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: error {rc}")


def _bwd_pass_a(q, k, v, pos_bias, gate, out, lse, dout, rate: float, seed: int):
    """K2's pass A, one launch: (dq, the chunks' partial d pos_bias slices
    (S, H, T, ldb) float32, f32 dgate, what pass B reads of the rows, the
    packed keep mask or None). The rows: in bfloat16 (B H, TP, 4) float32
    (gate log2 e, lse log2 e, D, 0), TP = T rounded up to 64; in float32 D
    (B, H, T), from `out`, which only that instance reads. The packed mask
    (`pack_keep_bits`' layout) only in bfloat16 at a rate above 0: pass B
    reads it and hashes nothing."""
    threshold, keep = dropout_constants(rate)
    dropout = [int(rate > 0.0), int(seed) & _U32, threshold, keep, _stream(q)]
    b, h, t, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dgate = torch.empty((b, h, t), **f32)
    chunks = _pass_a_plan(q, rate)
    ldb = -(-t // 4) * 4  # rows of the partial slices start on 16-byte boundaries
    part = torch.empty((chunks, h, t, ldb), **f32)
    common = [dq.data_ptr(), dgate.data_ptr(), part.data_ptr(), b, h, t, d, chunks, ldb]
    if q.dtype == torch.bfloat16:
        tp = -(-t // KEY_BLOCK) * KEY_BLOCK
        rows = torch.empty((b * h, tp, 4), **f32)
        bits = (torch.empty((b, h, tp // KEY_BLOCK, tp, 2), dtype=torch.int32, device=q.device)
                if rate > 0.0 else None)
        _raise_on(_library().gated_bias_attention_bwd_a_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), pos_bias.data_ptr(),
            pos_bias.stride(1), gate.data_ptr(), lse.data_ptr(), rows.data_ptr(),
            None if bits is None else bits.data_ptr(), *common, *dropout),
            "gated_bias_attention_bwd_a_bf16")
        return dq, part, dgate, rows, bits
    delta = torch.empty((b, h, t), **f32)
    _raise_on(_library().gated_bias_attention_bwd_a_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_bias.data_ptr(), pos_bias.stride(1),
        gate.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *common, *dropout), "gated_bias_attention_bwd_a_f32")
    return dq, part, dgate, delta, None


def _dbias_sum(part: torch.Tensor, t: int) -> torch.Tensor:
    """d pos_bias (H, T, T) float32: pass A's partial slices (S, H, T, ldb)
    added in chunk order, one launch."""
    chunks, h, _, ldb = part.shape
    dbias = torch.empty((h, t, t), dtype=torch.float32, device=part.device)
    _raise_on(_library().gated_bias_attention_dbias_sum(
        part.data_ptr(), dbias.data_ptr(), h, t, chunks, ldb, _stream(part)),
        "gated_bias_attention_dbias_sum")
    return dbias


def _bwd_pass_b(q, k, v, pos_bias, gate, lse, rows, bits, dout, rate: float, seed: int):
    """K2's pass B from what pass A returned (`rows`, `bits`), one launch:
    (dk, dv) in q's type. The bfloat16 instance reads the mask from `bits`;
    the float32 one replays it from the seed with gate and lse."""
    threshold, keep = dropout_constants(rate)
    b, h, t, d = q.shape
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        _raise_on(_library().gated_bias_attention_bwd_b_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), pos_bias.data_ptr(),
            pos_bias.stride(1), rows.data_ptr(), None if bits is None else bits.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, t, d, int(rate > 0.0), keep, _stream(q)),
            "gated_bias_attention_bwd_b_bf16")
    else:
        _raise_on(_library().gated_bias_attention_bwd_b_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_bias.data_ptr(), pos_bias.stride(1),
            gate.data_ptr(), dout.data_ptr(), lse.data_ptr(), rows.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, t, d, int(rate > 0.0), int(seed) & _U32, threshold, keep,
            _stream(q)), "gated_bias_attention_bwd_b_f32")
    return dk, dv


def _backward(q, k, v, pos_bias, gate, out, lse, dout, rate: float, seed: int):
    """K2: (dq, dk, dv in q's type, f32 dpos_bias (H, T, T), f32 dgate);
    three launches (pass A, the sum of its slices, pass B); rate 0 takes the
    instances without the mask."""
    pos_bias = padded_bias(pos_bias, q.dtype)
    _check_cuda(q, k, v, pos_bias, gate, out, dout)
    b, h, t, d = q.shape
    if q.numel() == 0:
        f32 = dict(dtype=torch.float32, device=q.device)
        return (torch.empty_like(q), torch.empty_like(q), torch.empty_like(q),
                torch.zeros((h, t, t), **f32), torch.empty((b, h, t), **f32))
    with torch.cuda.device(q.device):
        dq, part, dgate, rows, bits = _bwd_pass_a(q, k, v, pos_bias, gate, out, lse, dout,
                                                  rate, seed)
        dbias = _dbias_sum(part, t)
        dk, dv = _bwd_pass_b(q, k, v, pos_bias, gate, lse, rows, bits, dout, rate, seed)
    count("bwd" if rate > 0.0 else "bwd_rate0")
    return dq, dk, dv, dbias, dgate


def flash_attention_gated_bias(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos_bias: torch.Tensor,
    gate: torch.Tensor,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    head_offset: int = 0,
) -> torch.Tensor:
    """(B, H, T, D) attention output in q's type, not differentiable, in the
    softmax schedule `softmax_mode()` gives at the call (`head_offset` as in
    the plain version).

    A rate above 0 needs the "f32" schedule and raises in the others: K1
    has no such instance, and no path of the port or of the JAX package runs
    inference with dropout.

    CUDA tensors go to K1's inference instance of that schedule (with the
    dropout mask at a rate above 0), which takes q, k, v and pos_bias in one
    type (float32 or bfloat16; bfloat16 runs on the tensor cores), gate in
    float32, q, k, v and gate contiguous, q, k, v 16-byte aligned, and
    D <= 128 a multiple of 8; anything else raises. pos_bias not in
    `padded_bias`'s layout is copied into it first. CPU tensors go to the
    plain version."""
    _check(q, k, v, pos_bias, gate)
    seed = _need_seed(seed) if dropout_rate > 0.0 else 0
    mode = _SOFTMAX_MODE
    if dropout_rate > 0.0 and mode != "f32":
        raise ValueError(f"inference with dropout runs only the 'f32' softmax schedule, not "
                         f"{mode!r}: call it under softmax_mode_scope('f32')")
    if q.device.type == "cpu":
        return flash_attention_gated_bias_reference(q, k, v, pos_bias, gate, dropout_rate, seed,
                                                    head_offset, softmax_mode=mode)
    return _forward(q, k, v, pos_bias, gate, mode, dropout_rate, head_seed(seed, head_offset),
                    lse=False)[0]


class _TrainableAttention(torch.autograd.Function):
    """K1 (training instance, the f32 schedule) forward, K2 backward; rate 0
    takes both kernels' instances without the dropout hash. pos_bias is
    rounded to q's type into the padded layout once; K1 and both passes of K2
    read that copy. Its gradient comes back in pos_bias's own type."""

    @staticmethod
    def forward(ctx, q, k, v, pos_bias, gate, rate, seed):
        bias = padded_bias(pos_bias, q.dtype)
        out, lse = _forward_train(q, k, v, bias, gate, rate, seed)
        ctx.save_for_backward(q, k, v, bias, gate, out, lse)
        ctx.rate, ctx.seed, ctx.bias_dtype = rate, seed, pos_bias.dtype
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, gate, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias, dgate = _backward(
            q, k, v, bias, gate, out, lse, dout.contiguous(), ctx.rate, ctx.seed)
        return dq, dk, dv, dbias.to(ctx.bias_dtype), dgate, None, None


def flash_attention_gated_bias_trainable(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos_bias: torch.Tensor,
    gate: torch.Tensor,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    head_offset: int = 0,
) -> torch.Tensor:
    """Differentiable gated-bias attention with in-kernel attention dropout
    (deterministic from the int `seed`, the mask of heads from
    `head_offset`), always in the "f32" softmax schedule, as the JAX
    package runs every forward that has a backward; gradients flow to q, k,
    v, pos_bias and gate. CUDA tensors go to K1 and K2 (as
    `flash_attention_gated_bias` takes them, except that pos_bias may have
    any floating type); CPU tensors to autograd through the plain version."""
    _check(q, k, v, pos_bias, gate)
    seed = _need_seed(seed) if dropout_rate > 0.0 else 0
    if q.device.type == "cpu":
        return flash_attention_gated_bias_reference(q, k, v, pos_bias, gate, dropout_rate, seed,
                                                    head_offset, softmax_mode="f32")
    return _TrainableAttention.apply(q, k, v, pos_bias, gate, float(dropout_rate),
                                     head_seed(seed, head_offset))
