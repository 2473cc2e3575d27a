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

from diarizen_tpu_torch.parallel.distributed import process_index


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


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """Leaky ReLU at slope 0.01 (jax.nn.leaky_relu's and torch's default)."""
    return F.leaky_relu(x, 0.01)


def instance_norm(norm: nn.Module, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm1d over time on channel-first (B, C, T): float32
    statistics per (batch, channel), biased variance, then `norm`'s affine
    weight and bias; output in x's type."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * norm.weight.float()[:, None] + norm.bias.float()[:, None]).to(x.dtype)


def lstm_layer(in_dim: int, hidden: int, bidirectional: bool = True) -> nn.LSTM:
    """One (bi)directional LSTM layer in torch's layout (gates i, f, g, o),
    with the JAX package's single bias per direction: `bias_ih` carries it,
    `bias_hh` stays zero and takes no gradient. A stack of these with dropout
    between the layers draws that dropout from the step's generator, where a
    multi-layer nn.LSTM would draw it from the global one."""
    layer = nn.LSTM(in_dim, hidden, batch_first=True, bidirectional=bidirectional)
    for name, p in layer.named_parameters():
        if name.startswith("bias_hh"):
            p.requires_grad_(False)
            with torch.no_grad():
                p.zero_()
    return layer


def run_lstm(layers: nn.ModuleList, x: torch.Tensor, rate: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, T, D) through the stacked LSTM layers in float32, dropout (with a
    generator) after every layer but the last."""
    x = x.float()
    for i, layer in enumerate(layers):
        x = layer(x)[0]
        if i < len(layers) - 1:
            x = dropout(x, rate, generator)
    return x


class TrainRandom:
    """The randomness of one training forward. `host` draws what the host
    decides (attention-dropout seeds, layer drop) without a device sync;
    `device` draws the dropout masks on the activations' device. Both come
    from one host generator, so a seeded run repeats. In a process group
    every process draws the same from `host`, so layer drop skips the same
    layers everywhere, but the seeds are offset by the process index: each
    process draws its own dropout masks for its own rows of the batch."""

    def __init__(self, generator: torch.Generator, device: torch.device):
        self.host = generator
        self.offset = process_index() * 0x9E3779B1
        self.device = torch.Generator(device=device)
        self.device.manual_seed(self.seed())

    def seed(self) -> int:
        """A uniform int32 seed in [0, 2^31 - 1)."""
        drawn = int(torch.randint(0, 2**31 - 1, (1,), generator=self.host))
        return (drawn + self.offset) % (2**31 - 1)

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
