"""Joint distillation and structured pruning of a WavLM (port of
diarizen_tpu/prune/distill.py).

  * a frozen teacher and a gated student share the WavLM init; the student
    samples HardConcrete masks every step, from a generator seeded by
    (seed, step) on the device;
  * distill loss: weighted L2 / L1 / cosine over the hidden states at
    `distill_layers` (default 0, 4, 8, 12), stacked (B, layer, T, D);
  * Lagrangian sparsity objective lambda1 (s - t) + lambda2 (s - t)^2, the
    target sparsity t warmed linearly over `sparsity_warmup_updates` after
    `pre_train_updates`; the lambdas follow a NEGATIVE learning rate
    (gradient ascent to the saddle point);
  * three AdamW groups without weight decay: main at `distill_lr`,
    log-alphas at `reg_lr`, lambdas at -`reg_lr`.

On the card in bfloat16 the teacher's forward runs kernel K1's inference
instance, the student's K1's training instance at dropout rate 0 and K2 in
the backward. A step whose loss is not finite updates none of the three
groups (the step counter still advances). Reading the step's metrics is its
one host sync.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from diarizen_tpu_torch.models.wavlm import WavLM, WavLMConfig, count_params
from diarizen_tpu_torch.prune.gates import (
    GateTree,
    PruneConfig,
    expected_num_params,
    gate_leaves,
    gates_from_flat,
    map_gates,
    sample_gates,
)
from diarizen_tpu_torch.train.optim import Optimizer
from diarizen_tpu_torch.train.step import step_generator
from diarizen_tpu_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    l2_weight: float = 0.0
    l1_weight: float = 1.0
    cos_weight: float = 1.0
    cos_type: str = "raw"  # "raw" | "log_sig"
    distill_layers: Tuple[int, ...] = (0, 4, 8, 12)
    target_sparsity: float = 0.8
    pre_train_updates: int = 0
    sparsity_warmup_updates: int = 1
    distill_lr: float = 2e-4
    reg_lr: float = 2e-2
    use_reg: bool = True


def distill_loss(cfg: DistillConfig, student: torch.Tensor,
                 teacher: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Stacked (B, L, T, D) hidden states -> (loss, its parts), float32."""
    student, teacher = student.float(), teacher.float()
    zero = student.new_zeros(())
    loss_mse = torch.mean((student - teacher) ** 2) if cfg.l2_weight else zero
    loss_l1 = torch.mean(torch.abs(student - teacher)) if cfg.l1_weight else zero
    loss_cos = zero
    if cfg.cos_weight:
        sim = torch.sum(student * teacher, -1) / (
            torch.linalg.vector_norm(student, dim=-1) * torch.linalg.vector_norm(teacher, dim=-1)
            + 1e-8)
        if cfg.cos_type == "raw":
            loss_cos = -torch.mean(sim)
        else:
            loss_cos = -torch.mean(torch.log(torch.sigmoid(sim)))
    loss = cfg.l2_weight * loss_mse + cfg.l1_weight * loss_l1 + cfg.cos_weight * loss_cos
    return loss, {"loss_mse": loss_mse, "loss_l1": loss_l1, "loss_cos": loss_cos}


def distill_loss_fn(l2_weight, l1_weight, cos_weight, cos_type):
    """The config system's entry for the reference's DistillLoss constructor:
    `loss(student, teacher) -> (loss, parts)` closing over the weights."""
    if cos_type not in ("raw", "log_sig"):
        raise ValueError(f"cos_type must be 'raw' or 'log_sig', not {cos_type!r}")
    cfg = DistillConfig(l2_weight=l2_weight, l1_weight=l1_weight, cos_weight=cos_weight,
                        cos_type=cos_type)
    return lambda student, teacher: distill_loss(cfg, student, teacher)


def target_sparsity(dcfg: DistillConfig, step: int) -> float:
    real = max(step - dcfg.pre_train_updates, 0)
    return dcfg.target_sparsity * min(1.0, real / max(dcfg.sparsity_warmup_updates, 1))


@dataclasses.dataclass
class DistillPruneState:
    student: WavLM  # trainable
    log_alphas: GateTree  # trainable gate parameters
    lambdas: torch.Tensor  # (2,) Lagrangian multipliers (gradient ascent)
    optimizer: Optimizer
    step: int = 0


@dataclasses.dataclass
class DistillPruneModel:
    """What the `distill_prune` builder makes: the frozen teacher, the
    student, the student's log-alphas and what the pruning run reads."""
    teacher: WavLM
    student: WavLM
    log_alphas: GateTree
    prune_config: PruneConfig
    distill_layers: Tuple[int, ...]


def make_distill_prune_optimizer(dcfg: DistillConfig, student: WavLM, log_alphas: GateTree,
                                 lambdas: torch.Tensor) -> Optimizer:
    """AdamW over the groups {"main": the student, "log_alpha": the
    log-alphas, "lambda": the lambdas}, without weight decay, at constant
    learning rates distill_lr, reg_lr and -reg_lr."""
    groups = {
        "main": {f"student.{n}": p for n, p in student.named_parameters() if p.requires_grad},
        "log_alpha": {f"log_alphas.{n}": p for n, p in gate_leaves(log_alphas)},
        "lambda": {"lambdas": lambdas},
    }
    rates = {"main": dcfg.distill_lr, "log_alpha": dcfg.reg_lr, "lambda": -dcfg.reg_lr}
    return Optimizer(groups, {g: (lambda step, lr=lr: lr) for g, lr in rates.items()},
                     weight_decay=0.0)


def create_distill_prune_state(student: WavLM, log_alphas: GateTree, dcfg: DistillConfig,
                               device=None) -> DistillPruneState:
    """The student, its log-alphas (as parameters) and zero lambdas on
    `device` (the CUDA device by default, which raises where there is
    none), with their optimizer."""
    device = resolve_device(device)
    student.to(device).requires_grad_(True)
    # an identity dummy_weight is no parameter of the JAX package's pytree,
    # so nothing trains it there
    scale = student.feature_extractor.dummy_weight
    scale.requires_grad_(not torch.allclose(scale.detach(), torch.ones_like(scale)))
    log_alphas = map_gates(
        lambda la: torch.nn.Parameter(torch.as_tensor(la, dtype=torch.float32).to(device)),
        log_alphas)
    lambdas = torch.nn.Parameter(torch.zeros(2, device=device))
    optimizer = make_distill_prune_optimizer(dcfg, student, log_alphas, lambdas)
    return DistillPruneState(student, log_alphas, lambdas, optimizer)


def teacher_targets(teacher: WavLM, waveforms: torch.Tensor, dcfg: DistillConfig,
                    compute_dtype: torch.dtype) -> torch.Tensor:
    """The frozen teacher's (B, L, T, D) hidden states at distill_layers."""
    with torch.no_grad():
        hidden = teacher.hidden_states(waveforms, compute_dtype)
        return torch.stack([hidden[i] for i in dcfg.distill_layers], dim=1)


def distill_prune_loss(student: WavLM, log_alphas: GateTree, lambdas: torch.Tensor,
                       masks: GateTree, waveforms: torch.Tensor, targets: torch.Tensor,
                       wavlm_cfg: WavLMConfig, dcfg: DistillConfig, teacher_total: float,
                       step: int, compute_dtype: torch.dtype = torch.bfloat16,
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The step's objective: the distill loss of the student's training
    forward under `masks` (sampled from `log_alphas`) against `targets`,
    plus the Lagrangian term; (loss, parts)."""
    hidden = student.hidden_states(waveforms, compute_dtype, train=True, gates=masks)
    stack = torch.stack([hidden[i] for i in dcfg.distill_layers], dim=1)
    l_distill, parts = distill_loss(dcfg, stack, targets)
    zero = l_distill.new_zeros(())
    cur = tgt = l_reg = zero
    if dcfg.use_reg:
        cur = 1.0 - expected_num_params(wavlm_cfg, log_alphas) / teacher_total
        tgt = zero + target_sparsity(dcfg, step)
        gap = cur - tgt
        l_reg = lambdas[0] * gap + lambdas[1] * gap ** 2
    aux = {**parts, "loss_distill": l_distill, "loss_reg": l_reg,
           "sparsity_expected": cur, "sparsity_target": tgt}
    return l_distill + l_reg, aux


def make_distill_prune_step(wavlm_cfg: WavLMConfig, dcfg: DistillConfig, teacher: WavLM,
                            compute_dtype: torch.dtype = torch.bfloat16):
    """Returns step(state, waveforms (B, num_samples) array or tensor, seed)
    -> metrics."""
    teacher_total = float(count_params(teacher.state_dict()))
    teacher.requires_grad_(False)

    def step(state: DistillPruneState, waveforms, seed: int = 0) -> Dict[str, float]:
        if state.student.mesh is not None:
            raise NotImplementedError(
                "the distill-prune step on a model axis: it runs on one process")
        device = state.lambdas.device
        waves = torch.as_tensor(waveforms).to(device, torch.float32)
        targets = teacher_targets(teacher, waves, dcfg, compute_dtype)
        params = list(state.optimizer.params.values())
        for p in params:
            p.grad = None
        masks = sample_gates(state.log_alphas, step_generator(seed, state.step, device))
        loss, aux = distill_prune_loss(state.student, state.log_alphas, state.lambdas, masks,
                                       waves, targets, wavlm_cfg, dcfg, teacher_total,
                                       state.step, compute_dtype)
        loss.backward()
        names = ["loss", *aux]
        values = torch.stack([loss.detach(), *(v.detach() for v in aux.values()),
                              *state.lambdas.detach()]).tolist()  # the one host sync
        good = math.isfinite(values[0])
        if good:
            state.optimizer.step()
        for p in params:
            p.grad = None
        state.step += 1
        metrics = dict(zip(names, values))
        metrics.update(lambda1=values[-2], lambda2=values[-1], skipped=not good)
        return metrics

    return step


def distill_state_dict(state: DistillPruneState) -> Dict[str, torch.Tensor]:
    """A distill-prune run's checkpoint (student, log-alphas, lambdas) as one
    flat state dict, which `train.checkpoint.save_checkpoint` writes and
    `average_checkpoints` averages: "student.<key>", "log_alphas.<leaf>",
    "lambdas"."""
    sd = {f"student.{k}": v for k, v in state.student.state_dict().items()}
    sd.update({f"log_alphas.{n}": la.detach() for n, la in gate_leaves(state.log_alphas)})
    sd["lambdas"] = state.lambdas.detach()
    return sd


def split_distill_state_dict(sd: Dict[str, torch.Tensor], num_layers: int):
    """Inverse of `distill_state_dict`: (student state dict, log-alpha tree,
    lambdas)."""
    student = {k[len("student."):]: v for k, v in sd.items() if k.startswith("student.")}
    flat = {k[len("log_alphas."):]: v for k, v in sd.items() if k.startswith("log_alphas.")}
    return student, gates_from_flat(flat, num_layers), sd["lambdas"]
