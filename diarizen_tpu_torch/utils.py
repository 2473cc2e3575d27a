"""Device selection, host-device transfers and the out-of-memory batch
backoff shared by the port's entry points."""

from __future__ import annotations

import logging
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the CUDA device. Raises when CUDA is asked for and absent:
    the port never falls back to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
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
    CPU there is nothing to copy or to wait for."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self.event: Optional[torch.cuda.Event] = None
        if tensors and tensors[0].device.type == "cuda":
            self.host = []
            for t in tensors:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self.host.append(buf.copy_(t, non_blocking=True))
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(tensors[0].device))
        else:
            self.host = list(tensors)

    def wait(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [t.numpy() for t in self.host]


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
