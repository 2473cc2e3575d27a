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
    pred = powerset.to_multilabel(scores, soft=False).float()
    target = target.float()
    aligned, _ = permutate_enumerate(target, pred)
    hyp = (aligned > threshold).float()  # (B, F, K)
    detection_error = hyp.sum(-1) - target.sum(-1)  # (B, F)
    false_alarm_f = detection_error.clamp_min(0.0)
    return {
        "false_alarm": false_alarm_f.sum(),
        "missed_detection": (-detection_error).clamp_min(0.0).sum(),
        "confusion": (((hyp != target).float() * hyp).sum(-1) - false_alarm_f).sum(),
        "speech_total": target.sum(),
    }
