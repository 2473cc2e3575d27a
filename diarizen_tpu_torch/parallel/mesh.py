"""The (data, model) process mesh and the tensor-parallel `model` axis (port
of diarizen_tpu/parallel/mesh.py).

The JAX package places arrays on a `jax.sharding.Mesh` and lets XLA insert
the collectives. Here a mesh is a grid over the processes of the live
torch.distributed group, one card each, rank d * n_model + m at (d, m) as
the JAX package's `np.array(devices).reshape(n_data, n_model)` orders its
devices, with a process group for each axis (`init_device_mesh`):

* `data`: each process trains on, or serves, its own rows of the batch.
  The train step averages gradients over this axis, BatchNorm sums its batch
  statistics over it and the dropout seeds are offset by the data index, so
  the model ranks of one data index draw alike.
* `model`: WavLM's transformer layers are split Megatron-style over it
  (`shard_model_`). q/k/v and the FF-in projection keep the rank's output
  rows: whole heads of the layer's remaining heads and a contiguous block of
  the FF width, both split by `np.array_split`, so uneven splits and a rank
  holding none of a layer's heads are allowed. out-proj and FF-out keep the
  matching input columns; their biases are replicated and added once after
  the all-reduce. Every other parameter is replicated. The GRU gate's
  projection stays whole: it reads all `total_num_heads` heads of the full
  input, and every rank computes it and keeps its heads' gates.

Without a process group the mesh is (1, 1) and every collective a no-op.
A sharded model keeps its mesh: `shard_model_` gives it to each WavLM (the
model axis of its layers and the data index of its dropout seeds), to the
Conformer's convolution modules (the data axis of their BatchNorm
statistics) and to each split parameter (`model_group`, which the gradient
norm reads), and the train step reads it from the model. A model that is
not split has no mesh, and its data axis is the whole world. Checkpoints
keep the full reference layout: `gather_state` rebuilds it from the ranks'
slices and `local_state` cuts the rank's slices out of it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from diarizen_tpu_torch.parallel.distributed import (
    _collective_device,
    all_reduce_mean_,
    in_group,
    process_count,
    process_index,
)


def split_range(n: int, parts: int, index: int) -> Tuple[int, int]:
    """(start, length) of part `index` of `np.array_split(range(n), parts)`:
    the first n % parts parts hold one more."""
    base, extra = divmod(n, parts)
    return index * base + min(index, extra), base + (index < extra)


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of processes; `device_mesh` holds the axes'
    process groups (None without a process group)."""

    n_data: int
    n_model: int
    rank: int = 0
    device_mesh: Any = field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def data_group(self):
        return None if self.device_mesh is None else self.device_mesh.get_group("data")

    @property
    def model_group(self):
        return None if self.device_mesh is None else self.device_mesh.get_group("model")

    def split(self, n: int) -> Tuple[int, int]:
        """(start, length) of this rank's share of n heads or columns on
        the model axis."""
        return split_range(n, self.n_model, self.model_index)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The ('data', 'model') mesh over every process of the live group
    (n_data defaults to the processes over n_model); the (1, 1) mesh
    without a group. The collectives of a
    mesh run where its backend needs them: on the cards under NCCL, on the
    host under gloo (two ranks on one card, for one)."""
    world = process_count()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} processes; "
                         f"the group has {world}")
    if not in_group():
        return Mesh(1, 1)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device_mesh = init_device_mesh(device_type, (n_data, n_model),
                                   mesh_dim_names=("data", "model"))
    return Mesh(n_data, n_model, process_index(), device_mesh)


# ---------------------------------------------------------------------------
# shardings of arrays (the JAX package's NamedSharding helpers)


@dataclass(frozen=True)
class Sharding:
    """Which mesh axis splits each leading axis of an array (None: whole),
    as a JAX PartitionSpec names them; () is replicated."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    def local(self, x):
        """This process's block of `x` (a numpy array or a tensor): equal
        contiguous blocks, as JAX splits an axis over a mesh axis."""
        for axis, name in enumerate(self.spec):
            if name is None:
                continue
            parts = self.mesh.shape[name]
            index = self.mesh.data_index if name == "data" else self.mesh.model_index
            if x.shape[axis] % parts:
                raise ValueError(f"axis {axis} of {x.shape[axis]} does not split over "
                                 f"{parts} {name!r} ranks")
            n = x.shape[axis] // parts
            x = x[(slice(None),) * axis + (slice(index * n, (index + 1) * n),)]
        return x


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh)


def data_sharding(mesh: Mesh, ndim: int = 1) -> Sharding:
    """Shard the leading (batch) axis over 'data'."""
    return Sharding(mesh, ("data",) + (None,) * (ndim - 1))


def shard_batch(batch, mesh: Mesh):
    """This process's data-axis rows of every array of a batch (a dict, list
    or tuple of them, nested): the model ranks of one data index get the
    same rows."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return data_sharding(mesh, np.ndim(batch)).local(batch)


# ---------------------------------------------------------------------------
# the model axis of WavLM


_PARTIAL = ("rel_attn_embed.weight", "gru_rel_pos_linear.weight", "gru_rel_pos_linear.bias",
            "gru_rel_pos_const")


def _wavlms(model: torch.nn.Module) -> List[Tuple[str, Any]]:
    from diarizen_tpu_torch.models.wavlm import WavLM

    return [(name + "." if name else "", m) for name, m in model.named_modules()
            if isinstance(m, WavLM)]


def _slices(model: torch.nn.Module, n_model: int,
            index: int) -> Dict[str, Tuple[int, int, int]]:
    """{state_dict key: (dim, start, length)} of model rank `index`'s slice
    of every sharded parameter, from the full configuration."""
    out: Dict[str, Tuple[int, int, int]] = {}
    for prefix, wavlm in _wavlms(model):
        cfg = wavlm.cfg
        hd = cfg.head_dim
        for i in range(cfg.num_layers):
            key = f"{prefix}encoder.transformer.layers.{i}"
            if cfg.use_attention[i]:
                h0, nh = split_range(len(cfg.remaining_heads[i]), n_model, index)
                for proj in ("q_proj", "k_proj", "v_proj"):
                    for leaf in ("weight", "bias"):
                        out[f"{key}.attention.{proj}.{leaf}"] = (0, h0 * hd, nh * hd)
                out[f"{key}.attention.out_proj.weight"] = (1, h0 * hd, nh * hd)
            if cfg.use_feed_forward[i]:
                f0, nf = split_range(cfg.ff_interm_features[i], n_model, index)
                ff = f"{key}.feed_forward"
                out[f"{ff}.intermediate_dense.weight"] = (0, f0, nf)
                out[f"{ff}.intermediate_dense.bias"] = (0, f0, nf)
                out[f"{ff}.output_dense.weight"] = (1, f0, nf)
    return out


def eend_param_shardings(model: torch.nn.Module, mesh: Mesh) -> Dict[str, Optional[int]]:
    """{state_dict key: the dim split over 'model', or None (replicated)},
    in the reference key layout. With n_model == 1 everything is replicated
    (pure data parallelism, the reference's strategy); otherwise the WavLM
    layers' q/k/v weights and biases and FF-in weight and bias split dim 0
    (their output rows), out-proj and FF-out weights dim 1."""
    dims = {key: None for key in model.state_dict()}
    if mesh.n_model > 1:
        dims.update({key: dim for key, (dim, _, _) in _slices(model, mesh.n_model, 0).items()})
    return dims


def model_mesh(model: torch.nn.Module) -> Optional[Mesh]:
    """The mesh `shard_model_` split `model` over; None for a model that
    is not split (its data axis is then the whole world)."""
    return next((wavlm.mesh for _, wavlm in _wavlms(model) if wavlm.mesh is not None), None)


def shard_model_(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Keep this rank's slice of every sharded parameter, in place (each
    Parameter object stays, so an optimizer built on them carries over
    before its first step), tag it with `model_group`, and give the mesh to
    the modules that read it: the WavLM forward switches to the model axis,
    and the dropout seeds and the Conformer's BatchNorm follow the data
    axis. Nothing changes with n_model == 1."""
    if mesh.n_model == 1:
        return model
    from diarizen_tpu_torch.models.conformer import _ConvModule
    from diarizen_tpu_torch.models.mc import McEendModel

    if isinstance(model, McEendModel):
        raise NotImplementedError(
            "McEendModel on a model axis: the multi-channel family runs data parallel only")
    wavlms = _wavlms(model)
    if not wavlms:
        raise ValueError(f"{type(model).__name__} holds no WavLM to split over 'model'")
    if model_mesh(model) is not None:
        raise ValueError("the model is already sharded over 'model'")
    params = dict(model.named_parameters())
    with torch.no_grad():
        for key, (dim, start, length) in _slices(model, mesh.n_model, mesh.model_index).items():
            p = params[key]
            p.data = p.data.narrow(dim, start, length).clone()
            p.model_group = mesh.model_group
    for module in model.modules():
        if isinstance(module, _ConvModule):
            module.mesh = mesh
    for _, wavlm in wavlms:
        wavlm.mesh = mesh
    return model


def _map_sharded(tree, keys, fn):
    """`tree` (nested dicts) with fn(key, tensor) applied to every tensor
    keyed by a name in `keys`: a state dict, or an optimizer's state whose
    per-parameter dicts are keyed by parameter name."""
    if not isinstance(tree, dict):
        return tree
    return {k: fn(k, v) if (k in keys and isinstance(v, torch.Tensor)) else
            _map_sharded(v, keys, fn) for k, v in tree.items()}


def _gather_along(t: torch.Tensor, dim: int, lengths: Sequence[int], group) -> torch.Tensor:
    """The ranks' slices of `t` (lengths[m] along `dim` at model rank m)
    concatenated along `dim`, on every rank: padded to the longest for one
    all-gather."""
    device = _collective_device(group)
    longest = max(lengths)
    padded = torch.zeros(t.shape[:dim] + (longest,) + t.shape[dim + 1:], dtype=t.dtype,
                         device=device)
    padded.narrow(dim, 0, t.shape[dim]).copy_(t)
    parts = [torch.empty_like(padded) for _ in lengths]
    dist.all_gather(parts, padded, group=group)
    return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, lengths)], dim).to(t.device)


def gather_state(tree, model: torch.nn.Module, mesh: Mesh):
    """The full reference layout of `tree` (a sharded model's state dict,
    or its optimizer's state), on every rank of the model axis; a
    collective, so every rank calls it. `tree` itself with n_model == 1."""
    if mesh.n_model == 1 or model_mesh(model) is None:
        return tree
    per_rank = [_slices(model, mesh.n_model, m) for m in range(mesh.n_model)]

    def gather(key, t):
        dim = per_rank[0][key][0]
        return _gather_along(t.detach(), dim, [s[key][2] for s in per_rank], mesh.model_group)

    return _map_sharded(tree, per_rank[0], gather)


def local_state(tree, model: torch.nn.Module, mesh: Mesh):
    """The inverse of `gather_state`: this rank's slices cut from a tree in
    the full layout (a checkpoint read back under a mesh)."""
    if mesh.n_model == 1 or model_mesh(model) is None:
        return tree
    mine = _slices(model, mesh.n_model, mesh.model_index)

    def cut(key, t):
        dim, start, length = mine[key]
        return t.narrow(dim, start, length).clone()

    return _map_sharded(tree, mine, cut)


def gather_state_dict(model: torch.nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The model's full state dict in the reference layout, on every rank."""
    return gather_state(model.state_dict(), model, mesh)


# ---------------------------------------------------------------------------
# gradients on the mesh


def _roles(model: torch.nn.Module, names: Sequence[str]) -> Tuple[List[bool], List[bool]]:
    """Per name: (split over 'model', replicated but used only in part by
    each rank's share of the layers: the position-bias table and the GRU
    gate's projection and constant, whose gradients the ranks sum)."""
    mesh = model_mesh(model)
    if mesh is None:
        return [False] * len(names), [False] * len(names)
    sharded = _slices(model, mesh.n_model, 0)
    prefixes = [prefix for prefix, _ in _wavlms(model)]
    return ([n in sharded for n in names],
            [n.endswith(_PARTIAL) and any(n.startswith(p) for p in prefixes) for n in names])


def mean_gradients_(model: torch.nn.Module, names: Sequence[str],
                    grads: Sequence[torch.Tensor], extra: Sequence[torch.Tensor] = ()) -> None:
    """Turn each process's gradients of its local loss into those of the
    global batch's mean loss, in place, and average `extra` (the loss) the
    same way. On the mesh the model is split over, sharded gradients
    average over the data group. Replicated ones average over the whole
    world, those used in part by each model rank scaled by n_model first:
    the mean over the data axis of their sum over the model axis. Averaging
    the replicated gradients over the model axis too keeps the replicas of
    every model rank bit-identical where the card's backward is not bitwise
    repeatable. For a model that is not split, one world average: the
    data-parallel step."""
    sharded, partial = _roles(model, names)
    grads = list(grads)
    if any(sharded):
        mesh = model_mesh(model)
        with torch.no_grad():
            for g, part in zip(grads, partial):
                if part:
                    g.mul_(mesh.n_model)
        all_reduce_mean_([g for g, s in zip(grads, sharded) if s], group=mesh.data_group)
    all_reduce_mean_([g for g, s in zip(grads, sharded) if not s] + list(extra))
