"""Builds one CUDA source of `csrc/` into a shared library with a plain C
interface: nvcc for sm_90a into `build/diarizen_tpu_torch/` at first use,
loaded through ctypes by the module that owns the kernels. Holds the one
registry of the kernels' launch counts (`launches`, `count`)."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Dict

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


# ---------------------------------------------------------------------------
# launch counts: one counter by kernel instance, so that a run can show which
# kernels a path went through. K1's inference instances by softmax schedule
# (at a dropout rate above 0 only "fwd_f32"), its training instance
# (log-sum-exp output) at a rate above 0 and at 0, K2 (one count a backward:
# pass A, the sum of its d pos_bias slices and pass B) at a rate above 0 and
# at 0; K3, K4 and K5 one count a call, whatever CUDA launches the call makes
# on the card. The ResNet34's convolutions (`models/resnet.py`), each with
# its BatchNorm folded in and its epilogue fused: the stem's kernel
# ("resnet_stem", `ops/resnet_stem.py`) and the trunk's cuDNN calls
# ("resnet_conv", not the port's kernels but counted all the same), one
# count a convolution; beside them one count a fold of the BatchNorms into
# the convolutions ("resnet_fold").

KERNEL_INSTANCES = {
    "k1": ("fwd_f32", "fwd_deferred", "fwd_bf16"),
    "k1_train": ("train", "train_rate0"),
    "k2": ("bwd", "bwd_rate0"),
    "k3": ("k3",),
    "k4": ("k4",),
    "k5": ("k5",),
    "resnet_conv": ("resnet_stem", "resnet_conv"),
    "resnet_fold": ("resnet_fold",),
}
launches: Dict[str, int] = {n: 0 for names in KERNEL_INSTANCES.values() for n in names}


def count(instance: str) -> None:
    """One launch of `instance` (a name of `KERNEL_INSTANCES`)."""
    launches[instance] += 1


def reset_launches() -> None:
    """Every launch counter to 0."""
    launches.update(dict.fromkeys(launches, 0))


def launch_totals() -> Dict[str, int]:
    """The launches by kernel (the keys of `KERNEL_INSTANCES`), summed over
    its instances."""
    return {kernel: sum(launches[n] for n in names) for kernel, names in KERNEL_INSTANCES.items()}
