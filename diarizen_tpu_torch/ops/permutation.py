"""Permutation-invariant (PIT) target alignment (port of
diarizen_tpu/ops/permutation.py).

`permutate_enumerate` tries all K! speaker permutations at once on the
tensors' device (K <= 4 in every recipe: 24 candidates), exact and without a
host round trip; `permutate_hungarian` is the host numpy/scipy path for any
K, with the MSE or MAE cost.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import permutations
from typing import Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


@lru_cache(maxsize=None)
def _all_permutations(k: int) -> np.ndarray:
    """(k!, k) int64 array of all permutations of range(k), itertools order."""
    return np.array(list(permutations(range(k))), dtype=np.int64)


def permutate_enumerate(y1: torch.Tensor, y2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Align the speaker axis of `y2` to best match `y1` under MSE cost.

    y1, y2 : (B, F, K). Returns (permutated_y2, perm) with
    permutated_y2[b, :, k] = y2[b, :, perm[b, k]]; ties go to the first
    permutation in itertools order, as jnp.argmin.
    """
    _, _, k = y1.shape
    perms = torch.as_tensor(_all_permutations(k), device=y2.device)  # (P, K)
    candidates = y2[:, :, perms].movedim(2, 1)  # (B, P, F, K)
    cost = ((candidates - y1[:, None]) ** 2).mean(dim=(2, 3))  # (B, P)
    perm = perms[torch.argmin(cost, dim=1)]  # (B, K)
    return torch.gather(y2, 2, perm[:, None, :].expand(-1, y2.shape[1], -1)), perm


def permutate_hungarian(y1: np.ndarray, y2: np.ndarray,
                        cost: str = "mse") -> Tuple[np.ndarray, np.ndarray]:
    """Host Hungarian PIT: the contract of `permutate_enumerate` on numpy
    arrays, for any K; y2 may have another number of speakers than y1
    (missing columns come out as zeros). cost: "mse" or "mae"."""
    b_size, _, k1 = y1.shape
    permutated = np.zeros_like(y1)
    perm_list = np.full((b_size, k1), -1, dtype=np.int64)
    for b in range(b_size):
        diff = y1[b][:, :, None] - y2[b][:, None, :]  # (F, K1, K2)
        if cost == "mse":
            cost_mat = np.mean(diff**2, axis=0)
        elif cost == "mae":
            cost_mat = np.mean(np.abs(diff), axis=0)
        else:
            raise ValueError(f"unknown cost {cost!r}")
        for i, j in zip(*linear_sum_assignment(cost_mat)):
            permutated[b, :, i] = y2[b, :, j]
            perm_list[b, i] = j
    return permutated, perm_list
