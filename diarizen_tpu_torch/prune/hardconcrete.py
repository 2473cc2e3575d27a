"""Hard-Concrete L0 gates (port of diarizen_tpu/prune/hardconcrete.py).

The stretched hard-concrete distribution of FLOP / DPHuBERT / CoFi. Train-time
masks are sampled with the logistic reparameterisation, differentiable
through log_alpha; the uniform noise comes from an explicit
`torch.Generator`, or is given (`u`), so that a caller can feed the JAX
package and the port the same draws. Eval-time "compiled" masks zero the
value-dependent number of smallest entries and are computed on the host
(numpy), as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

BETA = 2.0 / 3.0
LIMIT_L = -0.1
LIMIT_R = 1.1
EPS = 1e-6


def hc_bias(beta: float = BETA, limit_l: float = LIMIT_L, limit_r: float = LIMIT_R) -> float:
    return -beta * math.log(-limit_l / limit_r)


def init_log_alpha(n: int, init_mean: float = 0.5, init_std: float = 0.01,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """log_alpha ~ N(log(1 - m) - log(m), std), float32 on the CPU."""
    mean = math.log(1 - init_mean) - math.log(init_mean)
    return mean + init_std * torch.randn(n, generator=generator)


def l0_norm(log_alpha: torch.Tensor, beta: float = BETA) -> torch.Tensor:
    """Expected number of alive units; differentiable."""
    return torch.sigmoid(log_alpha + hc_bias(beta)).sum()


def sample_mask(log_alpha: torch.Tensor, generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None, beta: float = BETA,
                limit_l: float = LIMIT_L, limit_r: float = LIMIT_R,
                eps: float = EPS) -> torch.Tensor:
    """Train-time stochastic mask in [0, 1], from the uniform draw `u` in
    [eps, 1 - eps) or, without one, from `generator` (on log_alpha's
    device)."""
    if u is None:
        u = torch.rand(log_alpha.shape, generator=generator, device=log_alpha.device)
        u = eps + (1 - 2 * eps) * u
    s = torch.sigmoid((torch.log(u / (1 - u)) + log_alpha) / beta)
    s = s * (limit_r - limit_l) + limit_l
    return torch.clamp(s, 0.0, 1.0)


def compiled_mask(log_alpha: np.ndarray, beta: float = BETA) -> np.ndarray:
    """Deterministic eval mask: zero the `round(n - l0)` smallest soft-mask
    entries of sigmoid(log_alpha / beta * 0.8). Host numpy (value-dependent
    k), the JAX package's arithmetic in float64."""
    log_alpha = np.asarray(log_alpha, dtype=np.float64)
    n = log_alpha.shape[0]
    expected_zeros = n - float((1 / (1 + np.exp(-(log_alpha + hc_bias(beta))))).sum())
    num_zeros = round(expected_zeros)
    soft = 1 / (1 + np.exp(-log_alpha / beta * 0.8))
    if num_zeros > 0:
        idx = np.argsort(soft)[:num_zeros]
        soft = soft.copy()
        soft[idx] = 0.0
    return soft.astype(np.float32)
