"""Powerset <-> multilabel conversion (port of diarizen_tpu/ops/powerset.py).

Classes are ordered by set size, then lexicographically, e.g. for
(num_classes=3, max_set_size=2): {}, {0}, {1}, {2}, {0,1}, {0,2}, {1,2}.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import combinations
from math import comb

import numpy as np
import torch

from diarizen_tpu_torch.utils import device_constant


def num_powerset_classes(num_classes: int, max_set_size: int) -> int:
    return sum(comb(num_classes, k) for k in range(max_set_size + 1))


@lru_cache(maxsize=None)
def _mapping_np(num_classes: int, max_set_size: int) -> np.ndarray:
    n_ps = num_powerset_classes(num_classes, max_set_size)
    mapping = np.zeros((n_ps, num_classes), dtype=np.float32)
    k = 0
    for set_size in range(max_set_size + 1):
        for subset in combinations(range(num_classes), set_size):
            mapping[k, list(subset)] = 1.0
            k += 1
    return mapping


class Powerset:
    def __init__(self, num_classes: int, max_set_size: int):
        self.num_classes = num_classes
        self.max_set_size = max_set_size
        self.num_powerset_classes = num_powerset_classes(num_classes, max_set_size)
        self.mapping = _mapping_np(num_classes, max_set_size)  # (P, K) numpy

    def to_multilabel(self, scores: torch.Tensor, soft: bool = False) -> torch.Tensor:
        """(..., P) log-probabilities -> (..., K) multilabel.

        hard: argmax one-hot @ mapping as uint8 (ties go to the lowest class,
        as in jnp.argmax); soft: exp(scores) @ mapping in float32."""
        mapping = self._mapping_on(scores.device)
        if soft:
            return torch.exp(scores.float()) @ mapping
        one_hot = torch.nn.functional.one_hot(
            torch.argmax(scores, dim=-1), self.num_powerset_classes
        ).to(mapping.dtype)
        return (one_hot @ mapping).to(torch.uint8)

    def _mapping_on(self, device: torch.device) -> torch.Tensor:
        return device_constant(("powerset.mapping", self.num_classes, self.max_set_size),
                               lambda: self.mapping, device)

    def _scores(self, multilabel: torch.Tensor) -> torch.Tensor:
        mapping = self._mapping_on(multilabel.device)
        return multilabel.float() @ mapping.T

    def to_powerset_index(self, multilabel: torch.Tensor) -> torch.Tensor:
        """(..., K) hard multilabel -> (...,) int64 powerset class index: the
        class with the largest overlap, lowest index first (as jnp.argmax)."""
        return torch.argmax(self._scores(multilabel), dim=-1)

    def to_powerset(self, multilabel: torch.Tensor) -> torch.Tensor:
        """(..., K) hard multilabel -> (..., P) one-hot powerset, in
        multilabel's type."""
        return torch.nn.functional.one_hot(
            self.to_powerset_index(multilabel), self.num_powerset_classes
        ).to(multilabel.dtype)
