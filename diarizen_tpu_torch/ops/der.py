"""Diarization error rate (port of diarizen_tpu/ops/der.py).

1. `der_components` / `DiarizationErrorRate`: frame level, on torch tensors
   of any device, for validation. The soft predictions take the speaker
   permutation that best matches the targets (MSE, every permutation), are
   thresholded, and give false-alarm, missed, confusion and speech counts.
2. `der_report`: segment level, for a pipeline's output against a reference
   RTTM, in numpy and scipy. Exact interval sweep, optional collar and UEM,
   overlapped speech scored, hypothesis speakers mapped to reference ones
   by Hungarian assignment on total overlap (md-eval / dscore semantics).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from diarizen_tpu_torch.core.segments import Annotation, Segment, Timeline
from diarizen_tpu_torch.ops.permutation import permutate_enumerate


def der_components(
    preds: torch.Tensor, target: torch.Tensor, threshold: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frame-level DER components with the optimal speaker permutation.

    preds: (B, K, F) predictions in [0, 1]; target: (B, K, F) binary.
    Returns scalar tensors (false_alarm, missed_detection, confusion,
    speech_total); DER = (fa + miss + conf) / total."""
    permutated, _ = permutate_enumerate(target.transpose(1, 2).float(),
                                        preds.transpose(1, 2).float())
    hyp = (permutated.transpose(1, 2) > threshold).float()  # (B, K, F)
    tgt = target.float()
    detection_error = hyp.sum(dim=1) - tgt.sum(dim=1)  # (B, F)
    false_alarm = detection_error.clamp_min(0.0).sum()
    missed = (-detection_error).clamp_min(0.0).sum()
    confusion = ((hyp != tgt).float() * hyp).sum() - false_alarm
    return false_alarm, missed, confusion, tgt.sum()


@dataclass
class DERReport:
    false_alarm: float
    missed_detection: float
    confusion: float
    total: float

    @property
    def der(self) -> float:
        if self.total <= 0:
            return 0.0
        return (self.false_alarm + self.missed_detection + self.confusion) / self.total

    def __add__(self, other: "DERReport") -> "DERReport":
        return DERReport(self.false_alarm + other.false_alarm,
                         self.missed_detection + other.missed_detection,
                         self.confusion + other.confusion, self.total + other.total)


def _boundaries(anns: List[Annotation]) -> np.ndarray:
    times = set()
    for ann in anns:
        for seg, _, _ in ann.itertracks():
            times.update((seg.start, seg.end))
    return np.array(sorted(times), dtype=np.float64)


def _interval_speaker_matrix(ann: Annotation, bounds: np.ndarray,
                             labels: List[str]) -> np.ndarray:
    """(num_intervals, num_labels) activity over the boundary intervals."""
    mat = np.zeros((len(bounds) - 1, len(labels)), dtype=bool)
    label_idx = {label: i for i, label in enumerate(labels)}
    starts, ends = bounds[:-1], bounds[1:]
    for seg, _, label in ann.itertracks():
        mat[(starts >= seg.start - 1e-9) & (ends <= seg.end + 1e-9), label_idx[label]] = True
    return mat


def optimal_mapping(reference: Annotation, hypothesis: Annotation) -> Dict[str, str]:
    """Hypothesis -> reference label mapping that maximises the total
    overlap (Hungarian); pairs without overlap stay unmapped."""
    ref_labels, hyp_labels = reference.labels(), hypothesis.labels()
    if not ref_labels or not hyp_labels:
        return {}
    ref_tls = [reference.label_timeline(r).support() for r in ref_labels]
    overlap = np.zeros((len(hyp_labels), len(ref_labels)))
    for i, h in enumerate(hyp_labels):
        h_tl = hypothesis.label_timeline(h).support()
        for j, r_tl in enumerate(ref_tls):
            overlap[i, j] = sum(hs.overlap_duration(rs) for hs in h_tl for rs in r_tl)
    rows, cols = linear_sum_assignment(-overlap)
    return {hyp_labels[i]: ref_labels[j] for i, j in zip(rows, cols) if overlap[i, j] > 0}


def der_report(reference: Annotation, hypothesis: Annotation,
               uem: Optional[Timeline] = None, collar: float = 0.0) -> DERReport:
    """Exact interval-sweep DER with the optimal speaker mapping.

    collar: no-score zone of +-collar/2 around every reference boundary
    (md-eval convention: `dscore --collar 0` is collar=0.0 here).
    Overlapped speech is scored."""
    if uem is not None:
        reference, hypothesis = reference.crop(uem), hypothesis.crop(uem)
    if collar > 0:
        half = collar / 2
        noscore = Timeline()
        for seg, _, _ in reference.itertracks():
            noscore.add(Segment(seg.start - half, seg.start + half))
            noscore.add(Segment(seg.end - half, seg.end + half))
        extent = Timeline([reference.get_timeline().extent(),
                           hypothesis.get_timeline().extent()]).extent()
        score_zone = noscore.support().gaps(Segment(extent.start - half, extent.end + half))
        reference, hypothesis = reference.crop(score_zone), hypothesis.crop(score_zone)

    mapping = optimal_mapping(reference, hypothesis)
    hypothesis = hypothesis.rename_labels(
        {h: mapping.get(h, f"!unmapped_{h}") for h in hypothesis.labels()})

    bounds = _boundaries([reference, hypothesis])
    if len(bounds) < 2:
        return DERReport(0.0, 0.0, 0.0, 0.0)
    durations = np.diff(bounds)
    labels = sorted(set(reference.labels()) | set(hypothesis.labels()))
    ref_mat = _interval_speaker_matrix(reference, bounds, labels)
    hyp_mat = _interval_speaker_matrix(hypothesis, bounds, labels)
    n_ref = ref_mat.sum(axis=1).astype(np.float64)
    n_hyp = hyp_mat.sum(axis=1).astype(np.float64)
    n_correct = (ref_mat & hyp_mat).sum(axis=1).astype(np.float64)
    return DERReport(
        false_alarm=float(np.sum(np.maximum(n_hyp - n_ref, 0.0) * durations)),
        missed_detection=float(np.sum(np.maximum(n_ref - n_hyp, 0.0) * durations)),
        confusion=float(np.sum((np.minimum(n_ref, n_hyp) - n_correct) * durations)),
        total=float(np.sum(n_ref * durations)),
    )


class DiarizationErrorRate:
    """Accumulates `der_components` over batches of frame-level predictions
    (a validation loop's metric)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.reset()

    def reset(self) -> None:
        self.false_alarm = self.missed = self.confusion = self.total = 0.0

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        fa, miss, conf, total = der_components(preds, target, self.threshold)
        self.false_alarm += float(fa)
        self.missed += float(miss)
        self.confusion += float(conf)
        self.total += float(total)

    def compute(self) -> Dict[str, float]:
        denom = max(self.total, 1e-12)
        return {
            "der": (self.false_alarm + self.missed + self.confusion) / denom,
            "false_alarm": self.false_alarm / denom,
            "missed_detection": self.missed / denom,
            "confusion": self.confusion / denom,
        }
