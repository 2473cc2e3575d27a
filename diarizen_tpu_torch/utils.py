"""Device selection, host-device transfers and the out-of-memory batch
backoff shared by the port's entry points, and the small utilities of the
JAX package's `utils.py` (seeding, directories, clamping, a timer, the
environment report)."""

from __future__ import annotations

import itertools
import logging
import os
import random
import shutil
import time
from pathlib import Path
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the CUDA device: `cuda:{LOCAL_RANK}` when a launcher such
    as torchrun set LOCAL_RANK, else the current one. Raises when CUDA is
    asked for and absent: the port never falls back to the CPU on its own."""
    if device is None:
        local_rank = os.environ.get("LOCAL_RANK")
        device = "cuda" if local_rank is None else f"cuda:{int(local_rank)}"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


_constants: Dict[Tuple[Hashable, torch.device], torch.Tensor] = {}


def device_constant(key: Hashable, make: Callable[[], np.ndarray],
                    device: Union[str, torch.device]) -> torch.Tensor:
    """`make()` as a tensor on `device`, uploaded once per (key, device) and
    kept. A copy from pageable host memory waits for everything queued on the
    device before it, so a constant that a forward needs must not be uploaded
    on every call."""
    slot = (key, torch.device(device))
    if slot not in _constants:
        with torch.inference_mode(False):  # usable inside autograd graphs too
            _constants[slot] = torch.as_tensor(make(), device=device)
    return _constants[slot]


def to_device_async(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device` without a host-side wait: staged through
    pinned memory and copied with `non_blocking=True` (the caching host
    allocator keeps the staging block until the copy has run). On the CPU
    the tensor shares the array's memory."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return tensor
    staged = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    staged.copy_(tensor)
    return staged.to(device, non_blocking=True)


class HostFetch:
    """Device tensors on their way to the host: copies into pinned buffers
    queued behind the work that produces them, and one recorded event.
    `wait()` is the single host wait; it returns the numpy arrays. On the
    CPU there is nothing to copy or to wait for. `stream`: the tensors'
    device's current stream where the caller has it already."""

    def __init__(self, tensors: Sequence[torch.Tensor], stream=None):
        self.event: Optional[torch.cuda.Event] = None
        if tensors and tensors[0].device.type == "cuda":
            self.host = []
            for t in tensors:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self.host.append(buf.copy_(t, non_blocking=True))
            self.event = torch.cuda.Event()
            self.event.record(stream or torch.cuda.current_stream(tensors[0].device))
        else:
            self.host = list(tensors)

    def wait(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [t.numpy() for t in self.host]


def state_stamp(model: torch.nn.Module) -> list:
    """(address, version) of every parameter and buffer of `model`: it
    changes when one is replaced, moved or changed in place. A tensor made
    inside `torch.inference_mode` (a model moved or converted there) has no
    version counter: its address alone counts, so its changes in place go
    unseen. A walk of the modules' own dicts: `parameters()` and `buffers()`
    build every name and cost twice as much, on every file."""
    stamp, stack = [], [model]
    while stack:
        module = stack.pop()
        for t in itertools.chain(module._parameters.values(), module._buffers.values()):
            if t is not None:
                stamp.append((t.data_ptr(), None if t.is_inference() else t._version))
        stack.extend(module._modules.values())
    return stamp


def is_oom_error(exc: BaseException) -> bool:
    """True when an exception is the device running out of memory."""
    return isinstance(exc, torch.cuda.OutOfMemoryError)


def halve_batch_or_raise(exc: BaseException, batch_size: int, stage: str) -> int:
    """Batch backoff for a device out-of-memory error during inference:
    returns half the batch size for a retry (after freeing the caching
    allocator's blocks), or raises the actionable message when already at 1.
    Any other exception is re-raised unchanged."""
    if not is_oom_error(exc):
        raise exc
    if batch_size <= 1:
        raise RuntimeError(
            f"{stage} ran out of device memory even at batch_size=1 — "
            "use shorter chunks (smaller `duration`), a smaller model, or "
            "a device with more memory"
        ) from exc
    new = batch_size // 2
    logging.getLogger("diarizen_tpu_torch.infer").warning(
        "%s hit device OOM at batch_size=%d; retrying at %d", stage, batch_size, new)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return new


def set_random_seed(seed: int = 3407) -> None:
    """Seed python's, numpy's and torch's generators (every card's too)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if torch.cuda.is_available():
        torch.cuda.manual_seed_all(seed)


def prepare_empty_dir(path: Union[str, Path], resume: bool = False) -> Path:
    """`path` as an empty directory (its old contents removed), or as it is
    when resuming."""
    path = Path(path)
    if path.exists() and not resume:
        shutil.rmtree(path)
    path.mkdir(parents=True, exist_ok=True)
    return path


def clamp_inf_value(x, limit: float = 1e10):
    """+-inf to +-limit and NaN to 0, for numpy arrays and tensors alike."""
    if isinstance(x, torch.Tensor):
        return torch.nan_to_num(x, nan=0.0, posinf=limit, neginf=-limit)
    return np.nan_to_num(x, nan=0.0, posinf=limit, neginf=-limit)


class Timer:
    """A wall-clock timer: a context manager, or `start()` / `stop()`
    pairs whose spans add up in `elapsed` (seconds)."""

    def __init__(self):
        self.start_time: Optional[float] = None
        self.elapsed = 0.0

    def start(self) -> "Timer":
        self.start_time = time.perf_counter()
        return self

    def stop(self) -> float:
        if self.start_time is not None:
            self.elapsed += time.perf_counter() - self.start_time
            self.start_time = None
        return self.elapsed

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def print_env() -> dict:
    """Print and return the runtime: torch's and CUDA's versions, each
    card's name and compute capability, and this process's rank and the
    world size of the process group (0 and 1 without one)."""
    from diarizen_tpu_torch.parallel.distributed import process_count, process_index

    info = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": [f"{torch.cuda.get_device_name(i)} (sm_{''.join(map(str, cap))})"
                    for i in range(torch.cuda.device_count())
                    for cap in [torch.cuda.get_device_capability(i)]],
        "process_index": process_index(),
        "process_count": process_count(),
    }
    for k, v in info.items():
        print(f"{k}: {v}")
    return info
