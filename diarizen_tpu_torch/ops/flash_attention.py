"""Attention with fused gated relative-position bias: kernel K1 and its plain
version.

`flash_attention_gated_bias` computes, for q, k, v (B, H, T, D), pos_bias
(H, T, T) and gate (B, H, T),

    o = softmax(q k^T / sqrt(D) + gate[..., None] * pos_bias) v

It replaces the Pallas TPU kernel `diarizen_tpu/ops/flash_attention.py:_kernel`
(launched from `flash_attention_gated_bias` there) with the hand-written CUDA
kernel `csrc/gated_bias_attention.cu` for CUDA tensors, and with the plain
PyTorch version below for CPU tensors. On an H100 the kernel is bound by
memory traffic at WavLM's shapes (the source note has the numbers); its
design keeps the (T, T) scores and gated bias out of device memory.

The kernel is compiled with nvcc into `build/diarizen_tpu_torch/` at first
use and bound through ctypes (a plain C interface, so the build takes
seconds). `launches` counts kernel launches, so a run can show that a path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
from pathlib import Path
from typing import Optional

import torch

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "gated_bias_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "diarizen_tpu_torch"
LIBRARY = BUILD_DIR / "libgated_bias_attention.so"

launches = 0  # kernel launches since the caller last set it to 0

_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the kernel for sm_90a unless the library is newer than its
    source; returns the compiler's output (register and shared-memory
    report from ptxas), empty when nothing was built."""
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return ""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) was not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        os.path.join(CUDA_HOME, "bin", "nvcc"),
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(tmp), str(SOURCE),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return proc.stdout + proc.stderr


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIBRARY))
        fn = lib.gated_bias_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def flash_attention_gated_bias_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos_bias: torch.Tensor,
    gate: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version: the math of the JAX package's
    `xla_attention_gated_bias` (f32 logits and softmax, weights cast to q's
    type for the product with v)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    logits = logits + gate.float()[..., None] * pos_bias.float()[None]
    logits = logits - logits.amax(dim=-1, keepdim=True)
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w.to(q.dtype), v).to(q.dtype)


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


def flash_attention_gated_bias(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos_bias: torch.Tensor,
    gate: torch.Tensor,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """(B, H, T, D) attention output, in q's type.

    CUDA tensors go to kernel K1, which takes q, k, v and pos_bias in one
    type (float32 or bfloat16; bfloat16 runs on the tensor cores), gate in
    float32, all contiguous, q, k, v 16-byte aligned, and D <= 128 a
    multiple of 8; anything else raises. CPU tensors go to the plain
    version."""
    global launches
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout belongs to the training path, not yet ported"
        )
    _check(q, k, v, pos_bias, gate)
    if q.device.type == "cpu":
        return flash_attention_gated_bias_reference(q, k, v, pos_bias, gate)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype or pos_bias.dtype != q.dtype:
        raise TypeError("k, v and pos_bias must have q's type")
    if gate.dtype != torch.float32:
        raise TypeError(f"gate must be float32, got {gate.dtype}")
    if not all(x.is_contiguous() for x in (q, k, v, pos_bias, gate)):
        raise ValueError("q, k, v, pos_bias and gate must be contiguous")
    b, h, t, d = q.shape
    if d % 8 or d > 128:
        raise ValueError(f"head dim must be a multiple of 8 and <= 128, got {d}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.gated_bias_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_bias.data_ptr(),
            gate.data_ptr(), out.data_ptr(), b, h, t, d,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gated_bias_attention_fwd launch failed: CUDA error {rc}")
    launches += 1
    return out
