"""The WavLM extractor's conv layers 1-6: kernel K5 (port of
diarizen_tpu/ops/conv_chain.py).

For x1 (B, T1, 512), channels last, in float32 or bfloat16, and six weights
(k, 512, 512) in (tap, in, out) order with k = 3, 3, 3, 3, 2, 2:

    y_s[t] = gelu(sum_j y_{s-1}[2 t + j] @ w_s[j]),  y_0 = x1,  out = y_6[:t_out]

with float32 accumulation, the exact (erf) GELU in float32, and each stage's
output rounded to the input type. It fits the unpruned 512-channel extractor
whose layers 1-6 have no norm (`extractor_mode="group_norm"`: WavLM-Base);
layer 0 (k = 10, stride 5, GroupNorm, GELU) stays outside.

K5 replaces the Pallas TPU kernel `diarizen_tpu/ops/conv_chain.py:_kernel`
with the hand-written CUDA kernels of `csrc/conv_chain.cu` for CUDA tensors
(the source note has the design and the bound); CPU tensors take the plain
PyTorch version below. In bfloat16 each stage is one implicit GEMM on the
tensor cores (six CUDA launches a call, the intermediates in scratch that
the wrapper allocates); in float32 the six stages run in one launch on the
CUDA cores. There is no gradient, as the TPU kernel has none.

`set_conv_chain` is the process-wide switch that WavLM's inference forward
reads (`models/wavlm.py`). A call that runs K5 counts one launch in
`cuda_build`'s registry ("k5"), whatever `CUDA_LAUNCHES` says it launched
on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from diarizen_tpu_torch.ops.cuda_build import CSRC_DIR, build_library, count, library_path

SOURCE = CSRC_DIR / "conv_chain.cu"
LIBRARY = library_path(SOURCE)
C = 512  # channels of every layer
KERNELS = (3, 3, 3, 3, 2, 2)
STRIDE_TOTAL = 64  # product of the six strides
RECEPTIVE_FIELD = 79  # input frames under one output frame

CUDA_LAUNCHES = {torch.bfloat16: 6, torch.float32: 1}  # CUDA launches of one call

_lib: Optional[ctypes.CDLL] = None
_CONV_CHAIN_OVERRIDE: Optional[bool] = None


def set_conv_chain(enabled: Optional[bool]) -> None:
    """Override the fused conv-chain toggle; None restores the default, which
    is off (the JAX package wires its kernel into no path). When on, the
    inference forward runs the extractor's layers 1-6 through K5 where the
    extractor is the one it fits (`models/wavlm.py`): the default 512-channel
    stack, "group_norm" mode (no norm after layer 0), no conv bias. Any other
    extractor keeps the ordinary route."""
    global _CONV_CHAIN_OVERRIDE
    _CONV_CHAIN_OVERRIDE = enabled


def use_conv_chain() -> bool:
    return _CONV_CHAIN_OVERRIDE if _CONV_CHAIN_OVERRIDE is not None else False


def build() -> str:
    """Compile the kernel for sm_90a unless the library is newer than its
    source; returns the compiler's output, empty when nothing was built."""
    return build_library(SOURCE)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIBRARY))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.conv_chain_stage_bf16.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.conv_chain_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        for fn in (lib.conv_chain_stage_bf16, lib.conv_chain_f32):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def min_input_frames(t_out: int) -> int:
    """Input frames that `t_out` output frames read."""
    return STRIDE_TOTAL * (t_out - 1) + RECEPTIVE_FIELD


def num_output_frames(t1: int) -> int:
    """Output frames of the six stages on `t1` input frames."""
    n = t1
    for k in KERNELS:
        n = max(0, (n - k) // 2 + 1)
    return n


def stage_frames(t_out: int) -> Tuple[int, ...]:
    """Frames of each stage's output that `t_out` output frames need: stage
    s computes frames 0 .. T_s - 1 and reads frames 0 .. 2 (T_s - 1) + k - 1
    of its input."""
    frames = [t_out]
    for k in reversed(KERNELS[1:]):
        frames.append(2 * (frames[-1] - 1) + k)
    return tuple(reversed(frames))


def gemm_weight(w: torch.Tensor) -> torch.Tensor:
    """(k, 512 in, 512 out) -> the (512 out, k 512) K-major matrix of one
    bfloat16 stage: column tap * 512 + in, the order of the taps' frames in
    a row of the stage's A operand."""
    k = w.shape[0]
    return w.permute(2, 0, 1).reshape(C, k * C)


def conv_chain_plain(x1: torch.Tensor, weights: Sequence[torch.Tensor],
                     t_out: int) -> torch.Tensor:
    """Plain PyTorch version of K5: six `conv1d` + GELU (float32 math, each
    stage rounded to x1's type) on the frames that `t_out` outputs read."""
    x = x1[:, :min_input_frames(t_out)].transpose(1, 2)
    for w in weights:
        y = F.conv1d(x, w.to(x.dtype).permute(2, 1, 0), stride=2)
        x = F.gelu(y.float()).to(x1.dtype)
    return x.transpose(1, 2)[:, :t_out].contiguous()


@dataclasses.dataclass(frozen=True)
class ConvChainWeights:
    """The six weights in one type on one device, ready for `fused_conv_chain`:
    `taps` are the (k, in, out) tensors, `flat` the kernels' buffer (CUDA
    only): the stages back to back, bfloat16 as `gemm_weight` matrices,
    float32 as (k, in, out)."""

    taps: List[torch.Tensor]
    flat: Optional[torch.Tensor]

    @property
    def dtype(self) -> torch.dtype:
        return self.taps[0].dtype

    @property
    def device(self) -> torch.device:
        return self.taps[0].device


def _check_weights(weights: Sequence[torch.Tensor]) -> None:
    if len(weights) != len(KERNELS):
        raise ValueError(f"expected {len(KERNELS)} weights, got {len(weights)}")
    for i, (w, k) in enumerate(zip(weights, KERNELS)):
        if tuple(w.shape) != (k, C, C):
            raise ValueError(f"weight {i} must be ({k}, {C}, {C}) in (tap, in, out) order, "
                             f"got {tuple(w.shape)}")
        if w.requires_grad and torch.is_grad_enabled():
            raise ValueError("fused_conv_chain has no gradient: detach the weights")


def pack_weights(weights: Sequence[torch.Tensor], dtype: torch.dtype,
                 device: Union[str, torch.device]) -> ConvChainWeights:
    """Cast the six (k, 512, 512) (tap, in, out) weights to `dtype` on
    `device` and, on a CUDA device, lay them out for the kernel. Do this once
    per model, type and device, not per call."""
    _check_weights(weights)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weights are packed as float32 or bfloat16, not {dtype}")
    device = torch.device(device)
    taps = [w.detach().to(device=device, dtype=dtype).contiguous() for w in weights]
    flat = None
    if device.type == "cuda":
        parts = [(gemm_weight(w) if dtype == torch.bfloat16 else w).reshape(-1) for w in taps]
        flat = torch.cat(parts)
    return ConvChainWeights(taps, flat)


def fused_conv_chain(x1: torch.Tensor,
                     weights: Union[ConvChainWeights, Sequence[torch.Tensor]],
                     t_out: int) -> torch.Tensor:
    """x1: (B, T1, 512) layer-1 input (after conv 0, GroupNorm and GELU),
    float32 or bfloat16; `weights`: the six (k, 512, 512) kernels in
    (tap, in, out) order, or their `pack_weights` (a plain list is packed on
    every call); returns (B, t_out, 512) in x1's type.

    A CUDA tensor goes to K5, which takes it contiguous and 16-byte aligned
    with T1 >= 64 (t_out - 1) + 79 (nothing is padded or copied); anything
    else raises, as does a failed build or launch. A CPU tensor goes to the
    plain version. No gradient: a tensor that requires grad raises."""
    if x1.dim() != 3 or x1.shape[-1] != C:
        raise ValueError(f"x1 must be (B, T1, {C}), got {tuple(x1.shape)}")
    if x1.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x1 must be float32 or bfloat16, got {x1.dtype}")
    if x1.requires_grad and torch.is_grad_enabled():
        raise ValueError("fused_conv_chain has no gradient: x1 requires grad")
    b, t1, _ = x1.shape
    if t_out < 1 or t1 < min_input_frames(t_out):
        raise ValueError(f"t_out={t_out} needs at least {min_input_frames(max(t_out, 1))} "
                         f"input frames and t_out >= 1, got T1={t1}")
    if not isinstance(weights, ConvChainWeights):
        weights = pack_weights(weights, x1.dtype, x1.device)
    if weights.dtype != x1.dtype or weights.device != x1.device:
        raise ValueError(f"weights are {weights.dtype} on {weights.device}, x1 is "
                         f"{x1.dtype} on {x1.device}")
    if x1.device.type == "cpu":
        return conv_chain_plain(x1, weights.taps, t_out)
    if x1.device.type != "cuda":
        raise ValueError(f"unsupported device {x1.device}")
    if not x1.is_contiguous() or x1.data_ptr() % 16:
        raise ValueError("x1 must be contiguous and start on a 16-byte boundary")
    if b > 65535:
        raise ValueError(f"at most 65535 batch elements per call, got {b}")
    out = torch.empty((b, t_out, C), dtype=x1.dtype, device=x1.device)
    if b == 0:
        return out
    lib = _library()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        if x1.dtype == torch.bfloat16:
            _chain_bf16(lib, x1, weights.flat, out, stream)
        else:
            # one block per (batch element, span of output frames): about one
            # block per multiprocessor, each walking along time
            sms = torch.cuda.get_device_properties(x1.device).multi_processor_count
            span = -(-t_out // max(1, sms // b))
            rc = lib.conv_chain_f32(x1.data_ptr(), weights.flat.data_ptr(), out.data_ptr(), b,
                                    t1, t_out, span, stream)
            if rc != 0:
                raise RuntimeError(f"conv_chain_f32 launch failed: CUDA error {rc}")
    count("k5")
    return out


def _chain_bf16(lib, x1: torch.Tensor, flat: torch.Tensor, out: torch.Tensor,
                stream: int) -> None:
    """The six stage GEMMs, levels 1-5 in two scratch buffers used in turn."""
    b, t1, _ = x1.shape
    frames = stage_frames(out.shape[1])
    scratch = [torch.empty(b * frames[i] * C, dtype=x1.dtype, device=x1.device) for i in (0, 1)]
    src, t_in, w_ptr = x1, t1, flat.data_ptr()
    for s, (k, t_s) in enumerate(zip(KERNELS, frames)):
        dst = out if s == len(KERNELS) - 1 else scratch[s % 2][: b * t_s * C].view(b, t_s, C)
        rc = lib.conv_chain_stage_bf16(src.data_ptr(), w_ptr, dst.data_ptr(), b, t_in, t_s, k,
                                       stream)
        if rc != 0:
            raise RuntimeError(f"conv_chain_stage_bf16 launch failed at stage {s + 1}: {rc} "
                               "(a CUDA error; -1: no cuTensorMapEncodeTiled in the driver; "
                               "-1000 - r: the driver refused a tensor map with error r)")
        src, t_in, w_ptr = dst, t_s, w_ptr + 2 * k * C * C
