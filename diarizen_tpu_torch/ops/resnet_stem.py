"""The ResNet34's stem (`models/resnet.py`): its one-channel 3x3 convolution
with the folded BatchNorm's bias and the ReLU, from the fbank straight to
channels-last activations, as one CUDA kernel (`csrc/resnet_stem.cu`).

For an fbank (B, T, F) in float32 or bfloat16, a weight (C, 1, 3, 3) and a
bias (C,) in the same type, with the fbank read as the one-channel image
x[b, 0, f, t]:

    y[b, c, f, t] = relu(bias[c] + sum_{i, j} w[c, 0, i, j] x[b, 0, f + i - 1, t + j - 1])

(zero padding of 1, stride 1), summed in float32 and rounded to the fbank's
type, out as a (B, C, F, T) tensor in `torch.channels_last`.

The kernel replaces no TPU kernel; the source note says why it was added,
what bounds it and its design. CUDA tensors go to the kernel, which counts
one launch in `cuda_build`'s registry ("resnet_stem") a call; CPU tensors
take the plain version below.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from diarizen_tpu_torch.ops.cuda_build import CSRC_DIR, build_library, count, library_path

SOURCE = CSRC_DIR / "resnet_stem.cu"
LIBRARY = library_path(SOURCE)

_lib: Optional[ctypes.CDLL] = None


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
        for fn in (lib.resnet_stem_f32, lib.resnet_stem_bf16):
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def stem_conv(fbank: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(B, T, F) fbank, (C, 1, 3, 3) weight, (C,) bias -> relu(conv(x) +
    bias) as (B, C, F, T) channels-last, in the fbank's type: the kernel for
    CUDA tensors (contiguous, all three of one type; anything else raises),
    the plain version for CPU tensors."""
    if not fbank.is_cuda:
        return stem_conv_reference(fbank, weight, bias)
    b, t, f = fbank.shape
    c = weight.shape[0]
    if weight.shape != (c, 1, 3, 3) or bias.shape != (c,):
        raise ValueError(f"stem weight {tuple(weight.shape)}, bias {tuple(bias.shape)}")
    if fbank.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the stem takes float32 or bfloat16, not {fbank.dtype}")
    if weight.dtype != fbank.dtype or bias.dtype != fbank.dtype:
        raise TypeError(f"fbank {fbank.dtype}, weight {weight.dtype}, bias {bias.dtype}")
    if weight.device != fbank.device or bias.device != fbank.device:
        raise ValueError("the stem's fbank, weight and bias lie on different devices")
    if not (fbank.is_contiguous() and weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("the stem takes contiguous fbank, weight and bias")
    if b > 65535:
        raise ValueError(f"at most 65535 rows a call, got {b}")
    out = torch.empty((b, c, f, t), dtype=fbank.dtype, device=fbank.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    lib = _library()
    launch = lib.resnet_stem_f32 if fbank.dtype == torch.float32 else lib.resnet_stem_bf16
    with torch.cuda.device(fbank.device):
        stream = torch.cuda.current_stream(fbank.device).cuda_stream
        rc = launch(fbank.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                    b, t, f, c, stream)
    if rc != 0:
        raise RuntimeError(f"resnet_stem launch failed: CUDA error {rc}")
    count("resnet_stem")
    return out


def stem_conv_reference(fbank: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """The plain version of `stem_conv`: the transposed fbank as a
    channels-last one-channel image through `F.conv2d` with the bias, then
    the ReLU."""
    x = fbank.transpose(1, 2)[:, None].contiguous(memory_format=torch.channels_last)
    return torch.relu(F.conv2d(x, weight, bias, padding=1))
