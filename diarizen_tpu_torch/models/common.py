"""Shared functional primitives (port of diarizen_tpu/models/common.py).

Parameters live in float32 modules; a forward runs in the type of its input
activation (float32 or bfloat16), casting each weight at its use. Norm
statistics and softmax are float32, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def layer_norm(norm: nn.Module, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics; output in x's type."""
    y = F.layer_norm(x.float(), x.shape[-1:], norm.weight.float(), norm.bias.float(), eps)
    return y.to(x.dtype)


def group_norm(norm: nn.Module, x: torch.Tensor, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over channel-first (B, C, T): float32 statistics per
    (batch, group) over (C // G, T), variance as E[x^2] - E[x]^2 as in the
    JAX package."""
    b, c, t = x.shape
    xg = x.float().reshape(b, num_groups, -1)
    mean = xg.mean(dim=-1, keepdim=True)
    var = (xg * xg).mean(dim=-1, keepdim=True) - mean * mean
    y = ((xg - mean) * torch.rsqrt(var.clamp_min(0.0) + eps)).reshape(b, c, t)
    y = y * norm.weight.float()[:, None] + norm.bias.float()[:, None]
    return y.to(x.dtype)


def channel_norm_last(norm: nn.Module, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """`group_norm` with one group per channel on channels-last (B, T, C):
    float32 statistics per (batch, channel) over time, variance as
    E[x^2] - E[x]^2, the same arithmetic in another layout."""
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    var = (xf * xf).mean(dim=1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var.clamp_min(0.0) + eps)
    return (y * norm.weight.float() + norm.bias.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class TrainRandom:
    """The randomness of one training forward. `host` draws what the host
    decides (attention-dropout seeds, layer drop) without a device sync;
    `device` draws the dropout masks on the activations' device. Both come
    from one host generator, so a seeded run repeats."""

    def __init__(self, generator: torch.Generator, device: torch.device):
        self.host = generator
        self.device = torch.Generator(device=device)
        self.device.manual_seed(self.seed())

    def seed(self) -> int:
        """A uniform int32 seed in [0, 2^31 - 1)."""
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.host))

    def uniform(self) -> float:
        return float(torch.rand((1,), generator=self.host))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout, as the JAX package's: kept values divided by
    1 - rate in x's type. No-op without a generator or at rate 0; the mask
    comes from `generator`, which must live on x's device."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty(x.shape, device=x.device).bernoulli_(keep, generator=generator)
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


class _GradMultiply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def grad_multiply(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity forward, gradient scaled by `scale` (the reference's
    GradMultiply 0.1 on the WavLM conv output)."""
    return _GradMultiply.apply(x, scale)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dropout_rate: float = 0.0,
              generator: Optional[torch.Generator] = None,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain scaled dot-product attention on (B, H, T, D): float32 logits
    (plus `bias`, broadcastable to (B, H, T, T)) and softmax, dropout on the
    weights (with a generator), weights cast to q's type for the product
    with v."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if bias is not None:
        logits = logits + bias.float()
    w = torch.softmax(logits - logits.amax(dim=-1, keepdim=True).detach(), dim=-1)
    w = dropout(w, dropout_rate, generator)
    return torch.matmul(w.to(q.dtype), v).to(q.dtype)
