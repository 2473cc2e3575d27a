"""Fused residual add + LayerNorm, with and without the weighted-sum update:
kernels K3 and K4 (port of diarizen_tpu/ops/fused_ln.py).

For a, b (..., D) in float32 or bfloat16 and gamma, beta (D,) in float32,

    residual_ln:      y = LayerNorm(a + b)
    residual_ln_acc:  the same y, and acc += w * float32(y), acc updated IN PLACE

The sum a + b is formed in float32 and is not rounded to the input type
before the norm; the statistics are the mean, then the mean of squared
deviations; y is rounded to the input type, and K4 accumulates that rounded
y: exactly what the unfused `acc + w * x.float()` adds from the layer output.

K3 replaces the Pallas TPU kernel `diarizen_tpu/ops/fused_ln.py:
_residual_ln_kernel` and K4 `_residual_ln_acc_kernel`, with the hand-written
CUDA kernels of `csrc/residual_layer_norm.cu` for CUDA tensors; CPU tensors
take the plain PyTorch versions below. On an H100 both are bound by memory
traffic (the source note has the numbers): one pass reads a, b (and acc) once
and writes y (and acc) once, where the unfused route makes several passes.

The backward is plain PyTorch math (`_ln_bwd_math`), as the JAX package's
custom VJP is plain XLA math: it backs eval-mode gradients only.

`set_fused_ln` is the process-wide switch that WavLM's post-norm inference
forward reads (`models/wavlm.py`). Each launch is counted in `cuda_build`'s
registry ("k3", "k4").
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from diarizen_tpu_torch.ops.cuda_build import CSRC_DIR, build_library, count, library_path

SOURCE = CSRC_DIR / "residual_layer_norm.cu"
LIBRARY = library_path(SOURCE)
MAX_DIM = 1024  # the kernels keep a row in registers: 4 chunks of 8 per lane

_lib: Optional[ctypes.CDLL] = None
_FUSED_LN_OVERRIDE: Optional[bool] = None


def set_fused_ln(enabled: Optional[bool]) -> None:
    """Override the fused residual + LayerNorm (+ weighted-sum) toggle; None
    restores the default, which is off as in the JAX package. When on, the
    post-norm inference forward runs K3 and K4 in place of the residual add,
    the two LayerNorms and the per-layer `acc + w * x` update."""
    global _FUSED_LN_OVERRIDE
    _FUSED_LN_OVERRIDE = enabled


def use_fused_ln() -> bool:
    return _FUSED_LN_OVERRIDE if _FUSED_LN_OVERRIDE is not None else False


def build() -> str:
    """Compile the kernels for sm_90a unless the library is newer than its
    source; returns the compiler's output, empty when nothing was built."""
    return build_library(SOURCE)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIBRARY))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.residual_layer_norm.argtypes = [ptr] * 5 + [i32, i32, f32, i32, ptr]
        lib.residual_layer_norm_acc.argtypes = [ptr] * 7 + [i32, i32, f32, i32, ptr]
        lib.residual_layer_norm.restype = ctypes.c_int
        lib.residual_layer_norm_acc.restype = ctypes.c_int
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain versions


def residual_ln_plain(a: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K3."""
    x = a.float() + b.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(a.dtype)


def residual_ln_acc_plain(a: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, w: torch.Tensor, acc: torch.Tensor,
                          eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4; `acc` is updated in place."""
    y = residual_ln_plain(a, b, gamma, beta, eps)
    acc.add_(w.float().reshape(()) * y.float())
    return y, acc


def _ln_bwd_math(x32, gamma, dy32, eps):
    """LayerNorm backward in float32: (dx, dgamma, dbeta)."""
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * rstd
    dyg = dy32 * gamma
    dx = rstd * (dyg - dyg.mean(dim=-1, keepdim=True)
                 - xhat * (dyg * xhat).mean(dim=-1, keepdim=True))
    axes = tuple(range(x32.dim() - 1))
    return dx, (dy32 * xhat).sum(dim=axes), dy32.sum(dim=axes)


# ---------------------------------------------------------------------------
# kernel wrappers


def _check(a, b, gamma, beta, acc=None, w=None) -> None:
    d = a.shape[-1] if a.dim() else 0
    if a.dim() < 1 or b.shape != a.shape or b.dtype != a.dtype:
        raise ValueError(f"a and b must share one (..., D) shape and type: {tuple(a.shape)} "
                         f"{a.dtype}, {tuple(b.shape)} {b.dtype}")
    if tuple(gamma.shape) != (d,) or tuple(beta.shape) != (d,):
        raise ValueError(f"gamma and beta must be ({d},), got {tuple(gamma.shape)}, "
                         f"{tuple(beta.shape)}")
    tensors = [a, b, gamma, beta]
    if acc is not None:
        if acc.shape != a.shape or acc.dtype != torch.float32:
            raise ValueError(f"acc must be float32 {tuple(a.shape)}, got {acc.dtype} "
                             f"{tuple(acc.shape)}")
        if w.numel() != 1:
            raise ValueError(f"w must hold one value, got shape {tuple(w.shape)}")
        tensors += [acc, w]
    if len({x.device for x in tensors}) != 1:
        raise ValueError("all tensors must be on one device")


def _check_cuda(a, b, gamma, beta, acc=None, w=None) -> None:
    """What the kernels take: a and b float32 or bfloat16, contiguous; gamma,
    beta, w and acc float32, contiguous; D a multiple of 8 up to MAX_DIM;
    a, b and acc 16-byte aligned. Nothing is copied to make it so."""
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a and b must be float32 or bfloat16, got {a.dtype}")
    small = [gamma, beta] + ([w] if w is not None else [])
    if any(x.dtype != torch.float32 for x in small):
        raise TypeError("gamma, beta and w must be float32")
    rows = [a, b] + ([acc] if acc is not None else [])
    if not all(x.is_contiguous() for x in rows + small):
        raise ValueError("a, b, gamma, beta and acc must be contiguous")
    d = a.shape[-1]
    if d % 8 or not 0 < d <= MAX_DIM:
        raise ValueError(f"D must be a multiple of 8 in [8, {MAX_DIM}], got {d}")
    if any(x.data_ptr() % 16 for x in rows + [gamma, beta]):
        raise ValueError("a, b, gamma, beta and acc must start on 16-byte boundaries")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _forward(a, b, gamma, beta, eps: float) -> torch.Tensor:
    """K3 for CUDA tensors (launches or raises), the plain version on the CPU."""
    _check(a, b, gamma, beta)
    if a.device.type == "cpu":
        return residual_ln_plain(a, b, gamma, beta, eps)
    _check_cuda(a, b, gamma, beta)
    y = torch.empty_like(a)
    if y.numel() == 0:
        return y
    d = a.shape[-1]
    lib = _library()
    with torch.cuda.device(a.device):
        rc = lib.residual_layer_norm(
            a.data_ptr(), b.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            a.numel() // d, d, float(eps), int(a.dtype == torch.bfloat16), _stream(a))
    if rc != 0:
        raise RuntimeError(f"residual_layer_norm launch failed: CUDA error {rc}")
    count("k3")
    return y


def _forward_acc(a, b, gamma, beta, w, acc, eps: float) -> torch.Tensor:
    """K4 for CUDA tensors (launches or raises), the plain version on the
    CPU; returns y, `acc` is updated in place."""
    _check(a, b, gamma, beta, acc, w)
    if a.device.type == "cpu":
        return residual_ln_acc_plain(a, b, gamma, beta, w, acc, eps)[0]
    _check_cuda(a, b, gamma, beta, acc, w)
    y = torch.empty_like(a)
    if y.numel() == 0:
        return y
    d = a.shape[-1]
    lib = _library()
    with torch.cuda.device(a.device):
        rc = lib.residual_layer_norm_acc(
            a.data_ptr(), b.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
            acc.data_ptr(), y.data_ptr(), a.numel() // d, d, float(eps),
            int(a.dtype == torch.bfloat16), _stream(a))
    if rc != 0:
        raise RuntimeError(f"residual_layer_norm_acc launch failed: CUDA error {rc}")
    count("k4")
    return y


class _ResidualLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, gamma, beta, eps):
        y = _forward(a, b, gamma, beta, eps)
        ctx.save_for_backward(a, b, gamma)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        a, b, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = _ln_bwd_math(a.float() + b.float(), gamma.float(), dy.float(),
                                         ctx.eps)
        return dx.to(a.dtype), dx.to(b.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None


class _ResidualLNAcc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, gamma, beta, w, acc, eps):
        y = _forward_acc(a, b, gamma, beta, w, acc, eps)
        ctx.mark_dirty(acc)
        ctx.save_for_backward(a, b, gamma, w, y)
        ctx.eps = eps
        return y, acc

    @staticmethod
    def backward(ctx, dy, dacc):
        a, b, gamma, w, y = ctx.saved_tensors
        dy_full = dy.float() + w.float().reshape(()) * dacc
        dx, dgamma, dbeta = _ln_bwd_math(a.float() + b.float(), gamma.float(), dy_full, ctx.eps)
        dw = (dacc * y.float()).sum().reshape(w.shape)
        return (dx.to(a.dtype), dx.to(b.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype),
                dw.to(w.dtype), dacc, None)


def residual_ln(a: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm(a + b) over the last axis in one pass, in a's type.

    CUDA tensors go to K3, which takes a and b in one type (float32 or
    bfloat16), gamma and beta in float32, all contiguous (the caller makes
    them so: nothing is copied here), D a multiple of 8 up to 1024; anything
    else raises. CPU tensors go to the plain version."""
    return _ResidualLN.apply(a, b, gamma, beta, float(eps))


def residual_ln_acc(a: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    w: Union[torch.Tensor, float], acc: torch.Tensor,
                    eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """y = LayerNorm(a + b); acc += w * float32(y). Returns (y, acc), `acc`
    the float32 tensor that was passed, updated in place.

    `w` is a float32 tensor of one element on a's device (a number is made
    one, which costs a host-to-device copy). CUDA tensors go to K4, under
    K3's conditions with acc contiguous float32 of a's shape."""
    if not isinstance(w, torch.Tensor):
        w = torch.tensor(float(w), dtype=torch.float32, device=a.device)
    return _ResidualLNAcc.apply(a, b, gamma, beta, w, acc, float(eps))
