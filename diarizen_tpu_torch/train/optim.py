"""Optimizers, schedules and gradient clipping (port of
diarizen_tpu/train/optim.py).

The JAX package builds these from optax; here they are one small class with
optax's semantics, so that a run behaves as the JAX one does:
  * AdamW as `optax.adamw`: bias-corrected moments, decoupled weight decay
    added to the update, the learning rate evaluated at the group's update
    count before it advances; every parameter is updated at every step, a
    parameter without a gradient with a zero one (its moments decay and
    weight decay applies), unlike `torch.optim.AdamW`, which skips it;
  * groups with their own schedules (the dual-LR split: 2e-5 on WavLM, 1e-3
    on the rest), and `freeze_wavlm` (optax.set_to_zero: no update, no
    state);
  * percentile AutoClip in front: the global gradient norm goes into a
    1000-entry history and the update is clipped to the given percentile of
    the valid entries (linear interpolation, numpy's default). History and
    count are tensors of the optimizer state, computed on the device
    without a host sync, and saved in checkpoints;
  * gradient accumulation as `optax.MultiSteps`: a running mean over k
    micro-batches, one update every k-th call;
  * the schedules: linear warmup, Noam (in float32, as the JAX package
    computes it) and optax's cosine one-cycle;
  * reduce-on-plateau as `optax.contrib.reduce_on_plateau` chained after
    AdamW: the monitored value goes in through `step(value=...)`, and the
    scale it keeps multiplies the whole update, weight decay included.
    Inside gradient accumulation it sees the value of each k-th call only,
    one per real update, as under `optax.MultiSteps`.
A skipped (non-finite) batch must not call `step`: its state, the schedules'
counts and the plateau's included, stays as it was.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from diarizen_tpu_torch.parallel.distributed import all_reduce_sum

Schedule = Callable[[int], float]
BETAS = (0.9, 0.999)  # optax.adamw's defaults, as the recipes use them
EPS = 1e-8


def warmup_schedule(base_lr: float, warmup_steps: int) -> Schedule:
    """base_lr * min(1, (step + 1) / warmup_steps); constant without warmup."""
    if warmup_steps <= 0:
        return lambda step: base_lr
    return lambda step: base_lr * min(1.0, (step + 1) / warmup_steps)


def noam_schedule(model_size: int, warmup: int, factor: float = 1.0) -> Schedule:
    """factor * model_size^-0.5 * min(s^-0.5, s * warmup^-1.5) at the
    1-based s = max(step + 1, 1), in float32 as the JAX package computes it."""

    def schedule(step: int) -> float:
        s = np.float32(max(step + 1, 1))
        return float(factor * model_size ** -0.5 * np.minimum(s ** -0.5, s * warmup ** -1.5))

    return schedule


def one_cycle_schedule(max_lr: float, total_steps: int, pct_start: float = 0.3) -> Schedule:
    """optax.cosine_onecycle_schedule (not torch's OneCycleLR) with its
    div_factor 25 and final_div_factor 1e4: from max_lr / 25 up to max_lr at
    step int(pct_start * total_steps), then down to max_lr / 25 / 1e4 at
    total_steps, each phase a half cosine; the last value is held after the
    end."""
    if total_steps <= 0:
        raise ValueError("one_cycle_schedule needs a positive total_steps")
    div_factor, final_div_factor = 25.0, 1e4
    bounds = (0, int(pct_start * total_steps), int(total_steps))
    values = [max_lr / div_factor]  # optax multiplies the scales up in turn
    for scale in (div_factor, 1.0 / (div_factor * final_div_factor)):
        values.append(values[-1] * scale)

    def schedule(step: int) -> float:
        for lo, hi, start, end in zip(bounds, bounds[1:], values, values[1:]):
            if lo <= step < hi:
                pct = (step - lo) / (hi - lo)
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return values[-1] if step >= bounds[-1] else 0.0

    return schedule


class ReduceOnPlateau:
    """optax.contrib.reduce_on_plateau: the mean of every
    `accumulation_size` monitored values improves when it is below
    (1 - rtol) * best - atol; after `patience` values without improvement
    the scale is multiplied by `factor` (not below `min_scale`) and
    `cooldown` values are ignored. The state is a dict of numbers."""

    def __init__(self, factor: float = 0.5, patience: int = 3, min_scale: float = 1e-3,
                 rtol: float = 1e-4, atol: float = 0.0, cooldown: int = 0,
                 accumulation_size: int = 1):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"factor must be in (0, 1), got {factor}")
        if rtol < 0.0 or atol < 0.0 or (rtol == 0.0 and atol == 0.0) or rtol > 1.0:
            raise ValueError(f"need 0 <= rtol <= 1, atol >= 0, one positive; got {rtol}, {atol}")
        self.factor, self.patience, self.min_scale = factor, patience, min_scale
        self.rtol, self.atol, self.cooldown = rtol, atol, cooldown
        self.accumulation_size = accumulation_size

    @staticmethod
    def init() -> Dict[str, float]:
        return {"best_value": math.inf, "plateau_count": 0, "scale": 1.0,
                "cooldown_count": 0, "count": 0, "avg_value": 0.0}

    def update(self, state: Dict[str, float], value: float) -> Dict[str, float]:
        """The state after one monitored value."""
        count = state["count"] + 1
        state = {**state, "count": count,
                 "avg_value": (state["count"] * state["avg_value"] + value) / count}
        if count != self.accumulation_size:
            return state
        avg = state["avg_value"]
        improved = avg < (1 - self.rtol) * state["best_value"] - self.atol
        plateau = 0 if improved else state["plateau_count"] + 1
        scale, cooldown = state["scale"], 0
        if state["cooldown_count"] > 0:
            plateau, cooldown = 0, state["cooldown_count"] - 1
        elif plateau == self.patience:
            plateau, scale, cooldown = 0, scale * self.factor, self.cooldown
        return {"best_value": avg if improved else state["best_value"],
                "plateau_count": plateau, "scale": max(scale, self.min_scale),
                "cooldown_count": cooldown, "count": 0, "avg_value": 0.0}


def global_norm(tensors: Iterable[torch.Tensor],
                params: Optional[Iterable[torch.Tensor]] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as optax.global_norm.
    With `params` (the tensors' parameters, in order), a tensor whose
    parameter is split over a model axis (it carries the `model_group` that
    `parallel.mesh.shard_model_` gives it) is this rank's slice: its squares
    are summed over that group and the others counted once, the norm of the
    whole."""
    norms = torch.stack(torch._foreach_norm(list(tensors)))
    params = list(params or ())
    split = [p for p in params if hasattr(p, "model_group")]
    if not split:
        return torch.linalg.vector_norm(norms)
    flags = torch.tensor([hasattr(p, "model_group") for p in params], device=norms.device)
    squares = norms.float() ** 2
    return torch.sqrt(squares[~flags].sum()
                      + all_reduce_sum(squares[flags].sum(), split[0].model_group))


class AutoClip:
    """Clip to the `percentile`-th percentile of the last `history_len`
    global gradient norms, the current one included."""

    def __init__(self, percentile: float = 90.0, history_len: int = 1000):
        self.percentile = percentile
        self.history_len = history_len

    def init(self, device) -> Dict[str, torch.Tensor]:
        return {"history": torch.zeros(self.history_len, device=device),
                "count": torch.zeros((), dtype=torch.int64, device=device)}

    def scale(self, g_norm: torch.Tensor, state: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Records g_norm in `state` (in place) and returns the factor that
        clips the update, min(1, percentile / g_norm)."""
        n = self.history_len
        history, count = state["history"], state["count"]
        history.scatter_(0, (count % n).view(1), g_norm.view(1).float())
        count.add_(1)
        n_valid = torch.clamp(count, max=n)
        slots = torch.arange(n, device=history.device)
        vals = torch.sort(torch.where(slots < n_valid, history, torch.inf)).values
        pos = (self.percentile / 100.0) * (n_valid.float() - 1.0)
        lo = torch.clamp(torch.floor(pos).long(), 0, n - 1)
        hi = torch.clamp(lo + 1, 0, n - 1)
        frac = pos - lo.float()
        lo_v = vals[lo]
        hi_v = torch.where(hi < n_valid, vals[hi], lo_v)
        clip_value = lo_v + frac * (hi_v - lo_v)
        return torch.clamp(clip_value / torch.clamp(g_norm, min=1e-12), max=1.0)


class Optimizer:
    """AdamW over named parameter groups, behind an optional AutoClip.

    groups: {group: {name: parameter}}; schedules: {group: lr schedule};
    frozen: groups that never move; plateau: a ReduceOnPlateau after AdamW.
    `step()` reads each parameter's `.grad` (a missing one counts as
    zeros)."""

    def __init__(self, groups: Dict[str, Dict[str, nn.Parameter]],
                 schedules: Dict[str, Schedule], weight_decay: float = 0.01,
                 clip: Optional[AutoClip] = None, frozen: Iterable[str] = (),
                 betas: Tuple[float, float] = BETAS, eps: float = EPS,
                 plateau: Optional[ReduceOnPlateau] = None):
        self.groups = groups
        self.schedules = schedules
        self.weight_decay = weight_decay
        self.betas = tuple(betas)
        self.eps = eps
        self.clip = clip
        self.frozen = set(frozen)
        self.plateau = plateau
        self.params: Dict[str, nn.Parameter] = {
            name: p for group in groups.values() for name, p in group.items()}
        self.state: Dict = {"count": {g: 0 for g in groups}, "mu": {}, "nu": {}, "clip": None,
                            "plateau": None if plateau is None else plateau.init()}

    def grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params.values()]

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None,
             value: Optional[float] = None, norm: Optional[torch.Tensor] = None) -> None:
        """One update from `grads` (in the order of `self.params`; by
        default the parameters' .grad). `value` is the monitored value that
        an optimizer with a plateau needs at every step; `norm` is the
        global norm of `grads` where the caller has it (AutoClip's input),
        computed here otherwise."""
        grads = self.grads() if grads is None else list(grads)
        plateau_scale = 1.0
        if self.plateau is not None:
            if value is None:
                raise ValueError("an optimizer with reduce-on-plateau needs step(value=...)")
            self.state["plateau"] = self.plateau.update(self.state["plateau"], float(value))
            plateau_scale = self.state["plateau"]["scale"]
        by_name = dict(zip(self.params, grads))
        if self.clip is not None:
            if self.state["clip"] is None:
                self.state["clip"] = self.clip.init(grads[0].device)
            if norm is None:
                norm = global_norm(grads, self.params.values())
            scale = self.clip.scale(norm, self.state["clip"])
            by_name = dict(zip(by_name, torch._foreach_mul(grads, scale)))
        b1, b2 = self.betas
        for group, named in self.groups.items():
            if group in self.frozen or not named:
                continue
            names = list(named)
            params = [named[n].data for n in names]
            g = [by_name[n] for n in names]
            for n, p in zip(names, params):
                if n not in self.state["mu"]:
                    self.state["mu"][n] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    self.state["nu"][n] = torch.zeros_like(p, memory_format=torch.preserve_format)
            mu = [self.state["mu"][n] for n in names]
            nu = [self.state["nu"][n] for n in names]
            lr = self.schedules[group](self.state["count"][group])
            count = self.state["count"][group] + 1
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - b2)
            denom = torch._foreach_div(nu, 1 - b2**count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            update = torch._foreach_div(mu, 1 - b1**count)
            torch._foreach_div_(update, denom)
            if self.weight_decay:
                torch._foreach_add_(update, params, alpha=self.weight_decay)
            torch._foreach_add_(params, update, alpha=-lr * plateau_scale)
            self.state["count"][group] = count

    def state_dict(self) -> Dict:
        return {"count": dict(self.state["count"]), "mu": dict(self.state["mu"]),
                "nu": dict(self.state["nu"]), "clip": self.state["clip"],
                "plateau": None if self.state["plateau"] is None else dict(self.state["plateau"])}

    def load_state_dict(self, state: Dict) -> None:
        def to_param(name, t):
            return t.to(self.params[name].device)

        self.state = {
            "count": {g: int(c) for g, c in state["count"].items()},
            "mu": {n: to_param(n, t) for n, t in state["mu"].items()},
            "nu": {n: to_param(n, t) for n, t in state["nu"].items()},
            "clip": None,
            "plateau": (None if self.plateau is None
                        else dict(state.get("plateau") or self.plateau.init())),
        }
        if state.get("clip") is not None:
            device = next(iter(self.params.values())).device
            self.state["clip"] = {k: v.to(device) for k, v in state["clip"].items()}


class GradientAccumulation:
    """optax.MultiSteps around an Optimizer: `step()` folds the gradients
    into a running mean and updates the parameters on every k-th call."""

    def __init__(self, optimizer: Optimizer, every_k: int):
        self.optimizer = optimizer
        self.every_k = every_k
        self.params = optimizer.params
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None

    def grads(self) -> List[torch.Tensor]:
        return self.optimizer.grads()

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None,
             value: Optional[float] = None, norm: Optional[torch.Tensor] = None) -> None:
        """Fold `grads` into the mean; on the k-th call update with it, and
        with that call's `value` (the plateau sees one value an update).
        `norm`, that of this call's `grads`, is not the mean's: the update
        clips by the mean's own norm."""
        grads = self.grads() if grads is None else list(grads)
        if self.acc is None:
            self.acc = [torch.zeros_like(g) for g in grads]
        diff = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(diff, self.mini_step + 1)
        torch._foreach_add_(self.acc, diff)
        if self.mini_step == self.every_k - 1:
            self.optimizer.step(self.acc, value=value)
            self.acc = None
            self.mini_step = 0
        else:
            self.mini_step += 1

    def state_dict(self) -> Dict:
        names = list(self.params)
        acc = None if self.acc is None else dict(zip(names, self.acc))
        return {"inner": self.optimizer.state_dict(), "mini_step": self.mini_step, "acc": acc}

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        self.acc = None if state["acc"] is None else [
            state["acc"][n].to(p.device) for n, p in self.params.items()]


def adamw_with_warmup(params: Dict[str, nn.Parameter], lr: float, warmup_steps: int = 0,
                      weight_decay: float = 0.01, clip_percentile: Optional[float] = 90.0,
                      clip_history: int = 1000) -> Optimizer:
    clip = None if clip_percentile is None else AutoClip(clip_percentile, clip_history)
    return Optimizer({"all": dict(params)}, {"all": warmup_schedule(lr, warmup_steps)},
                     weight_decay=weight_decay, clip=clip)


def adamw_torch_args(params: Dict[str, nn.Parameter], lr: float = 1e-3,
                     betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                     weight_decay: float = 1e-2, **_ignored) -> Optimizer:
    """AdamW with `torch.optim.AdamW`'s constructor surface and defaults
    (eps 1e-8, weight decay 1e-2), which a reference `[optimizer]` section
    names; arguments that torch takes and optax does not (amsgrad, ...) are
    ignored, as in the JAX package. The update is the Optimizer's (optax's
    AdamW), with no clipping."""
    return Optimizer({"all": dict(params)}, {"all": warmup_schedule(lr, 0)},
                     weight_decay=weight_decay, betas=betas, eps=eps)


def noam_adamw(params: Dict[str, nn.Parameter], model_size: int, warmup: int,
               factor: float = 1.0, weight_decay: float = 0.0) -> Optimizer:
    """AdamW (optax's defaults, no weight decay unless asked) on the Noam
    schedule."""
    return Optimizer({"all": dict(params)}, {"all": noam_schedule(model_size, warmup, factor)},
                     weight_decay=weight_decay)


def reduce_on_plateau(factor: float = 0.5, patience: int = 3,
                      min_scale: float = 1e-3) -> ReduceOnPlateau:
    """The JAX package's defaults for the plateau (optax's for the rest);
    pass it to an Optimizer as `plateau=`."""
    return ReduceOnPlateau(factor=factor, patience=patience, min_scale=min_scale)


def dual_lr_optimizer(groups: Dict[str, Dict[str, nn.Parameter]], lr_small: float = 2e-5,
                      lr_big: float = 1e-3, warmup_steps: int = 0, weight_decay: float = 0.01,
                      clip_percentile: Optional[float] = 90.0,
                      freeze_wavlm: bool = False) -> Optimizer:
    """The recipe's optimizer over `EendModel.param_groups()`: AdamW at
    lr_small on "wavlm" and lr_big on "other", behind percentile AutoClip;
    `freeze_wavlm` leaves the trunk where it is."""
    clip = None if clip_percentile is None else AutoClip(clip_percentile)
    return Optimizer(groups, {"wavlm": warmup_schedule(lr_small, warmup_steps),
                              "other": warmup_schedule(lr_big, warmup_steps)},
                     weight_decay=weight_decay, clip=clip,
                     frozen=("wavlm",) if freeze_wavlm else ())


def with_gradient_accumulation(optimizer: Optimizer, every_k: int):
    return optimizer if every_k <= 1 else GradientAccumulation(optimizer, every_k)
