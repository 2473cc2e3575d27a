"""Shared functional primitives (port of diarizen_tpu/models/common.py).

Parameters live in float32 modules; a forward runs in the type of its input
activation (float32 or bfloat16), casting each weight at its use. Norm
statistics and softmax are float32, as in the JAX package.
"""

from __future__ import annotations

import math

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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain scaled dot-product attention on (B, H, T, D): float32 logits and
    softmax, weights cast to q's type for the product with v."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    w = torch.softmax(logits - logits.amax(dim=-1, keepdim=True), dim=-1)
    return torch.matmul(w.to(q.dtype), v).to(q.dtype)
