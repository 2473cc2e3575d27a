"""Voice-activity and overlapped-speech detection (port of
diarizen_tpu/infer/vad.py).

Both reduce the segmentation model's aggregated soft frame scores to one
activation and binarize it with hysteresis:
  * VAD: P(speech) = the largest speaker score of a frame;
  * OSD: P(overlap) = the second-largest speaker score of a frame, the
    probability that at least two speakers are active.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from diarizen_tpu_torch.core.segments import Annotation, SlidingWindowFeature
from diarizen_tpu_torch.infer.sliding import SlidingInference
from diarizen_tpu_torch.ops.binarize import Binarize


@dataclass
class _FrameDetection:
    seg_inference: SlidingInference
    onset: float = 0.5
    offset: float = 0.5
    min_duration_on: float = 0.0
    min_duration_off: float = 0.0

    def _detect(self, activation: np.ndarray, agg: SlidingWindowFeature, label: str,
                uri: Optional[str]) -> Annotation:
        """(frames, 1) activation -> Annotation of `label` turns."""
        ann = Binarize(onset=self.onset, offset=self.offset,
                       min_duration_on=self.min_duration_on,
                       min_duration_off=self.min_duration_off)(
            SlidingWindowFeature(activation, agg.sliding_window))
        ann.uri = uri
        return ann.rename_labels({old: label for old in ann.labels()})


@dataclass
class VoiceActivityDetection(_FrameDetection):
    def __call__(self, waveform: np.ndarray, sample_rate: int = 16000,
                 uri: Optional[str] = None) -> Annotation:
        agg = self.seg_inference.aggregated(waveform, sample_rate, soft=True)
        return self._detect(np.max(agg.data, axis=-1, keepdims=True), agg, "SPEECH", uri)


@dataclass
class OverlappedSpeechDetection(_FrameDetection):
    def __call__(self, waveform: np.ndarray, sample_rate: int = 16000,
                 uri: Optional[str] = None) -> Annotation:
        agg = self.seg_inference.aggregated(waveform, sample_rate, soft=True)
        if agg.data.shape[-1] < 2:
            return Annotation(uri=uri)
        second = np.sort(agg.data, axis=-1)[:, -2:-1]  # the 2nd-largest speaker score
        return self._detect(second, agg, "OVERLAP", uri)
