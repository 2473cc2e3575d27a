"""Training and validation objectives for EEND powerset segmentation (port
of diarizen_tpu/train/loss.py).

Training: powerset scores -> hard multilabel -> PIT-align the target to the
prediction (MSE cost, all K! permutations on the device) -> powerset index
-> frame NLL. Validation: hard multilabel aligned to the target, thresholded
at 0.5 -> false-alarm, missed, confusion and speech frame counts.
"""

from __future__ import annotations

from typing import Dict

import torch

from diarizen_tpu_torch.ops.der import der_components
from diarizen_tpu_torch.ops.losses import nll_loss
from diarizen_tpu_torch.ops.permutation import permutate_enumerate
from diarizen_tpu_torch.ops.powerset import Powerset


def segmentation_loss(powerset: Powerset, scores: torch.Tensor,
                      target: torch.Tensor) -> torch.Tensor:
    """PIT powerset NLL. scores: (B, F, P) log-probabilities; target:
    (B, F, K) binary speaker activity."""
    multilabel = powerset.to_multilabel(scores, soft=False).to(scores.dtype)
    permutated, _ = permutate_enumerate(multilabel, target.to(scores.dtype))
    return nll_loss(scores, powerset.to_powerset_index(permutated))


def der_metrics(powerset: Powerset, scores: torch.Tensor, target: torch.Tensor,
                threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    """Scalar sums over a batch of chunks: false_alarm, missed_detection,
    confusion, speech_total; DER = (fa + miss + conf) / total, accumulated
    over batches."""
    pred = powerset.to_multilabel(scores, soft=False)
    fa, miss, conf, total = der_components(pred.transpose(1, 2), target.transpose(1, 2),
                                           threshold)
    return {"false_alarm": fa, "missed_detection": miss, "confusion": conf,
            "speech_total": total}
