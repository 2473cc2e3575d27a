"""Train and eval steps for EEND segmentation training (port of
diarizen_tpu/train/step.py).

One train step: the training forward (dropout, layer drop and the
attention-dropout seeds drawn from a host generator seeded by (seed, step)),
PIT powerset NLL, backward, the global gradient norm (before clipping),
AutoClip and the dual-LR update. A batch whose loss is not finite is
skipped as in the JAX package: parameters, optimizer state (the schedules'
counts and the AutoClip history included) and the BatchNorm running
statistics, which the forward has already moved, keep their old values;
the step counter still advances. Reading the loss is the step's one host
sync. In a process group each process's batch is its shard of the global
batch (of the same size on every process): the gradients and the loss are
averaged over the processes before the update (`parallel/distributed.py`),
so every process takes the same step.

Both steps run the model through `segmentation_forward`, so `eval_step`
evaluates a multi-channel model on all its channels (the JAX package's
`make_mc_eval_step`); `mc_train_step` is its `make_mc_train_step`: it keeps
the first `num_channels` channels of the batch, k drawn by the caller each
step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from diarizen_tpu_torch.models.forward import segmentation_forward
from diarizen_tpu_torch.models.mc import McEendModel
from diarizen_tpu_torch.models.wavlm import WavLM
from diarizen_tpu_torch.parallel.distributed import all_reduce_mean_
from diarizen_tpu_torch.train.loss import der_metrics, segmentation_loss
from diarizen_tpu_torch.train.optim import GradientAccumulation, Optimizer, global_norm
from diarizen_tpu_torch.utils import resolve_device

Batch = Dict[str, Union[np.ndarray, torch.Tensor, list]]


@dataclass
class TrainState:
    model: nn.Module  # a segmentation model of any family
    optimizer: Union[Optimizer, GradientAccumulation]
    step: int = 0


def create_train_state(model: nn.Module, optimizer, device=None) -> TrainState:
    """Moves the model (and so the optimizer's parameters) to `device`:
    the CUDA device by default, which raises where there is none."""
    model.to(resolve_device(device))
    return TrainState(model=model, optimizer=optimizer)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def to_device(batch: Batch, device: torch.device):
    """(waveforms float32 (B, C, N), targets float32 (B, F, K)) on `device`."""
    xs = torch.as_tensor(batch["xs"]).to(device, torch.float32, non_blocking=True)
    target = torch.as_tensor(batch["target"]).to(device, non_blocking=True).float()
    return xs, target


def step_generator(seed: int, step: int, device="cpu") -> torch.Generator:
    """The generator of one train step, on the host unless `device` says
    otherwise (the JAX package folds the step into its key)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def _batch_norm_buffers(model: torch.nn.Module) -> List[torch.Tensor]:
    return [buf for name, buf in model.named_buffers()
            if name.endswith("running_mean") or name.endswith("running_var")]


def train_step(state: TrainState, batch: Batch, seed: int = 0,
               compute_dtype: torch.dtype = torch.bfloat16) -> Dict[str, float]:
    """One optimizer step on `batch`. Returns loss, grad_norm (before
    clipping, 0 on a skipped batch), skipped, and attention_layers (the
    WavLM attention layers the forward computed: fewer than the model has
    where layer drop skipped some; 0 for a model with no WavLM)."""
    xs, target = to_device(batch, _device(state.model))
    return _step(state, xs, target, seed, compute_dtype)


def mc_train_step(state: TrainState, batch: Batch, seed: int = 0,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  num_channels: Optional[int] = None) -> Dict[str, float]:
    """`train_step` of a multi-channel model on the first `num_channels`
    channels of the batch's (B, C, N) waveforms (all with None); the metrics
    also give num_channels, the channels the step ran on."""
    if not isinstance(state.model, McEendModel):
        raise TypeError(f"mc_train_step takes an McEendModel, got {type(state.model).__name__}")
    xs, target = to_device(batch, _device(state.model))
    xs = xs[:, :num_channels]
    return {**_step(state, xs, target, seed, compute_dtype), "num_channels": xs.shape[1]}


def _step(state: TrainState, xs: torch.Tensor, target: torch.Tensor, seed: int,
          compute_dtype: torch.dtype) -> Dict[str, float]:
    model = state.model
    bn_before = [buf.clone() for buf in _batch_norm_buffers(model)]
    for p in model.parameters():
        p.grad = None
    scores = segmentation_forward(model)(xs, compute_dtype, train=True,
                                         generator=step_generator(seed, state.step))
    loss = segmentation_loss(model.cfg.powerset, scores, target)
    loss.backward()
    grads = state.optimizer.grads()  # zeros where a parameter got no gradient
    shared_loss = loss.detach().float().reshape(1)
    # data parallel: the global batch's mean gradient and mean loss on every
    # process (a no-op without a group); a non-finite loss anywhere makes
    # the mean non-finite everywhere, so every process skips the batch together
    all_reduce_mean_(grads + [shared_loss])
    loss_value = float(shared_loss)
    good = math.isfinite(loss_value)
    grad_norm = 0.0
    if good:
        norm = global_norm(grads)
        state.optimizer.step(grads)
        grad_norm = float(norm)
    else:
        with torch.no_grad():
            for buf, old in zip(_batch_norm_buffers(model), bn_before):
                buf.copy_(old)
    for p in model.parameters():
        p.grad = None
    state.step += 1
    wavlm = next((m for m in model.modules() if isinstance(m, WavLM)), None)
    attention_layers = 0 if wavlm is None else sum(
        1 for i in wavlm.layers_run if wavlm.cfg.use_attention[i])
    return {"loss": loss_value, "grad_norm": grad_norm, "skipped": not good,
            "attention_layers": attention_layers}


@torch.no_grad()
def eval_step(model: nn.Module, batch: Batch,
              compute_dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Loss and DER components summed over the batch, as device tensors
    (accumulate across batches, then divide). The forward is the inference
    forward: no dropout, BatchNorm running statistics, K1's rate-0 instance."""
    xs, target = to_device(batch, _device(model))
    scores = segmentation_forward(model)(xs, compute_dtype)
    powerset = model.cfg.powerset
    m = der_metrics(powerset, scores, target)
    m["loss_sum"] = segmentation_loss(powerset, scores, target) * xs.shape[0]
    m["num_chunks"] = torch.tensor(float(xs.shape[0]), device=xs.device)
    return m
