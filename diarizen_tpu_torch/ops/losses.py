"""Training losses (port of diarizen_tpu/ops/losses.py).

Reference: pyannote-audio's utils/loss.py (nll_loss, binary_cross_entropy,
mse_loss), with optional frame weights.
"""

from __future__ import annotations

from typing import Optional

import torch


def nll_loss(log_probs: torch.Tensor, target: torch.Tensor,
             weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Frame-weighted negative log-likelihood.

    log_probs : (B, F, C) log-probabilities
    target : (B, F) integer class indices
    weight : optional (B, F) frame weights
    """
    loss = -torch.gather(log_probs, -1, target[..., None].long())[..., 0]
    if weight is not None:
        return (loss * weight).sum() / weight.sum().clamp_min(1e-12)
    return loss.mean()


def _weighted_mean(loss: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    if weight is None:
        return loss.mean()
    while weight.dim() < loss.dim():
        weight = weight[..., None]
    return (loss * weight).sum() / (weight.sum() * (loss.numel() / weight.numel())).clamp_min(1e-12)


def binary_cross_entropy(probs: torch.Tensor, target: torch.Tensor,
                         weight: Optional[torch.Tensor] = None,
                         eps: float = 1e-6) -> torch.Tensor:
    probs = probs.clamp(eps, 1.0 - eps)
    loss = -(target * torch.log(probs) + (1.0 - target) * torch.log(1.0 - probs))
    return _weighted_mean(loss, weight)


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _weighted_mean((pred - target) ** 2, weight)
