"""Builds one CUDA source of `csrc/` into a shared library with a plain C
interface: nvcc for sm_90a into `build/diarizen_tpu_torch/` at first use,
loaded through ctypes by the module that owns the kernels."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "diarizen_tpu_torch"


def library_path(source: Path) -> Path:
    return BUILD_DIR / f"lib{source.stem}.so"


def build_library(source: Path) -> str:
    """Compile `source` unless its library is newer; returns the compiler's
    output (the register and shared-memory report of ptxas), empty when
    nothing was built. Raises when nvcc is missing or fails."""
    library = library_path(source)
    if library.exists() and library.stat().st_mtime >= source.stat().st_mtime:
        return ""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) was not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = library.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        os.path.join(CUDA_HOME, "bin", "nvcc"),
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(tmp), str(source),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, library)
    return proc.stdout + proc.stderr
