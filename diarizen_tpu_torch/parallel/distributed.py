"""Process groups and the collectives of data-parallel serving and training
(port of diarizen_tpu/parallel/distributed.py on torch.distributed).

`initialize_distributed` joins the group a launcher describes (torchrun's
`env://` variables) or one given explicitly: NCCL when CUDA is available,
gloo otherwise, with the reference's 3600 s timeout. Without a group every
collective here is a copy and every caller's touch point a no-op; in a group,
of one process too, the collectives run. A collective runs where the group's
backend needs its tensors: on this rank's card for NCCL, on the host for
gloo, and its result goes back to the caller's device. Results for the host
come back as numpy copies, since callers mutate them. Every collective takes
an optional `group` (a sub-group of a `parallel/mesh.py` mesh: its data or
its model axis), the world by default.

The two operators of Megatron's tensor parallelism run over the model group:
`copy_to_group` (identity forward, the gradient summed in backward) where a
replicated activation enters a region that each rank computes on its own
slice of the weights, and `reduce_from_group` (the partial results summed
forward, identity backward) where it leaves it.

The window-shard functions are pure numpy: process p of P handles windows
p, p + P, ... of a file, and the shards are gathered back into window order
(padded to ceil(n / P), since a collective needs equal shapes).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = timedelta(seconds=3600)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join the process group. With no arguments it reads torchrun's
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK, and does nothing when
    WORLD_SIZE is unset or 1; `coordinator_address` ("host:port") with
    `num_processes` and `process_id` starts a group of any size, one
    included. A second call is a no-op. The backend is NCCL where CUDA is
    available and gloo otherwise, unless `backend` names one (gloo lets
    ranks share a card, which NCCL refuses). Under NCCL each rank uses the
    card LOCAL_RANK names (0 without it)."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return
        init_method, world, rank = "env://", None, None
    else:
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    kwargs = {} if world is None else {"world_size": world, "rank": rank}
    dist.init_process_group(backend, init_method=init_method, timeout=TIMEOUT, **kwargs)


def process_index(group=None) -> int:
    """This process's rank in `group` (the world by default); 0 without a
    group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def process_count(group=None) -> int:
    """The processes of `group` (the world by default); 1 without a group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


_rank, _world = process_index, process_count  # names that process_window_shard's arguments shadow


def is_main_process() -> bool:
    return process_index() == 0


def in_group() -> bool:
    """Whether a process group is live (of any size): the collectives here
    run then, and are copies otherwise."""
    return dist.is_initialized()


def _collective_device(group=None) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _to_tensor(x: np.ndarray, group=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(_collective_device(group))


def gather_to_host(x: np.ndarray, group=None) -> np.ndarray:
    """Every process's `x` (equal shapes), stacked as (P, ...) on every
    process; `x` itself, copied, without a group."""
    if not in_group():
        return np.array(x)
    t = _to_tensor(x, group)
    parts = [torch.empty_like(t) for _ in range(process_count(group))]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts).cpu().numpy()


def broadcast_from_host(x: np.ndarray, group=None) -> np.ndarray:
    """The `x` of the group's first process (process 0 for the world) on
    every process of the group (each passes an array of the same shape and
    type), as a numpy copy."""
    if not in_group():
        return np.array(x)
    t = _to_tensor(x, group)
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast(t, src=src, group=group)
    return t.cpu().numpy()


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the processes of `group` (the
    world by default), in place, through one flat float32 all-reduce on the
    collective's device. A no-op without a group."""
    tensors = list(tensors)
    if not in_group() or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors]).to(_collective_device(group))
    dist.all_reduce(flat, group=group)
    flat /= process_count(group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset: offset + t.numel()].view_as(t))
        offset += t.numel()


def _summed(t: torch.Tensor, group=None) -> torch.Tensor:
    out = t.to(_collective_device(group), copy=True)
    dist.all_reduce(out, group=group)
    return out.to(t.device)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return _summed(t, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _summed(grad, ctx.group), None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `t` over the processes of `group` (the world by default),
    differentiable: every process's loss depends on the sum, so the gradient
    of `t` is the sum of the processes' gradients of it. `t` itself without
    a group."""
    if not in_group():
        return t
    return _AllReduceSum.apply(t, group)


model_reduces = 0  # all-reduces of `copy_to_group` and `reduce_from_group`, both directions


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        global model_reduces
        model_reduces += 1
        return _summed(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        global model_reduces
        model_reduces += 1
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: `x` unchanged, its gradient summed over `group` in
    backward (each rank's slice of the weights gives only its part of it).
    `x` itself without a group."""
    if not in_group():
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum of the ranks' partial `x` over `group`, its
    gradient passed through unchanged. `x` itself without a group."""
    if not in_group():
        return x
    return _ReduceFromGroup.apply(x, group)


def process_window_shard(num_windows: int, process_index: Optional[int] = None,
                         process_count: Optional[int] = None, group=None) -> np.ndarray:
    """This process's strided shard of window indices: windows p, p + P, ...
    (p and P default to this process's rank in `group` and its size, the
    live world's without one)."""
    p = _rank(group) if process_index is None else process_index
    P = _world(group) if process_count is None else process_count
    return np.arange(num_windows)[p::P]


def reassemble_window_shards(shards: List[np.ndarray], num_windows: int) -> np.ndarray:
    """Re-interleave strided shards (shards[p] holds windows p, p + P, ...,
    possibly padded past its true length) into window order."""
    P = len(shards)
    out = np.zeros((num_windows,) + tuple(shards[0].shape[1:]), shards[0].dtype)
    for p in range(P):
        idx = np.arange(num_windows)[p::P]
        out[idx] = shards[p][: len(idx)]
    return out


def gather_window_shards(local: np.ndarray, num_windows: int, group=None) -> np.ndarray:
    """The inverse of `process_window_shard` across the processes of `group`
    (the world by default; shard p is that of the group's rank p): pad the
    local shard to ceil(n / P) rows, all-gather, re-interleave. A copy
    without a group."""
    if not in_group():
        return np.array(local)
    P = process_count(group)
    per = -(-num_windows // P)
    padded = np.zeros((per,) + local.shape[1:], dtype=local.dtype)
    padded[: len(local)] = local
    return reassemble_window_shards(list(gather_to_host(padded, group)), num_windows)

