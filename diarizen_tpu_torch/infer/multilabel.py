"""Multi-label segmentation, e.g. speech / music / noise detection (port of
diarizen_tpu/infer/multilabel.py): the aggregated per-class frame scores are
binarized one class at a time, each with its own hysteresis thresholds, into
one Annotation labelled with the class names."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from diarizen_tpu_torch.core.segments import Annotation, SlidingWindowFeature
from diarizen_tpu_torch.infer.sliding import SlidingInference
from diarizen_tpu_torch.ops.binarize import Binarize


@dataclass
class MultiLabelSegmentation:
    """`classes[k]` names the segmentation model's k-th output.

    thresholds: per class {"onset", "offset" and, when share_min_duration is
    False, "min_duration_on", "min_duration_off"} (0.5, 0.5, 0, 0 when
    absent)."""

    seg_inference: SlidingInference
    classes: List[str]
    thresholds: Dict[str, Dict[str, float]] = field(default_factory=dict)
    share_min_duration: bool = False
    min_duration_on: float = 0.0
    min_duration_off: float = 0.0

    def _binarizer(self, label: str) -> Binarize:
        t = self.thresholds.get(label, {})
        shared = self.share_min_duration
        return Binarize(
            onset=t.get("onset", 0.5), offset=t.get("offset", 0.5),
            min_duration_on=self.min_duration_on if shared else t.get("min_duration_on", 0.0),
            min_duration_off=self.min_duration_off if shared else t.get("min_duration_off", 0.0),
        )

    def __call__(self, waveform: np.ndarray, sample_rate: int = 16000,
                 uri: Optional[str] = None, hook: Optional[Callable] = None) -> Annotation:
        agg = self.seg_inference.aggregated(waveform, sample_rate, soft=True)
        if hook is not None:
            hook("segmentation", agg)
        detection = Annotation(uri=uri)
        for i, label in enumerate(self.classes):
            ann = self._binarizer(label)(
                SlidingWindowFeature(agg.data[:, i: i + 1], agg.sliding_window))
            for seg, track, _ in ann.itertracks():
                detection[seg, (label, track)] = label
        return detection
