"""Resegmentation: refine an existing diarization with the segmentation model
(port of diarizen_tpu/infer/resegmentation.py).

  1. sliding-window soft segmentation, one output per window;
  2. hysteresis-binarize the windows -> frame-level speaker count;
  3. discretize the input diarization on the model's frame grid;
  4. trim the warm-up regions of the windows;
  5. per window, permute the local speakers to best match the input
     diarization (Hungarian, MAE cost);
  6. overlap-add the permuted windows, keep the top-count speakers per frame
     and binarize into an Annotation.

The defaults are the reference's DIHARD3-tuned values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from diarizen_tpu_torch.core.segments import Annotation, Segment, SlidingWindowFeature
from diarizen_tpu_torch.infer.pipeline import speaker_count, to_diarization
from diarizen_tpu_torch.infer.sliding import SlidingInference, receptive_field_window
from diarizen_tpu_torch.ops.aggregate import trim
from diarizen_tpu_torch.ops.binarize import Binarize, binarize_hysteresis
from diarizen_tpu_torch.ops.permutation import permutate_hungarian


def binarize_chunked(scores: SlidingWindowFeature, onset: float, offset: float,
                     initial_state: bool = False) -> SlidingWindowFeature:
    """Hysteresis-binarize a (chunks, frames, classes) feature along frames."""
    data = np.asarray(scores.data, dtype=np.float32)
    chunks, frames, classes = data.shape
    flat = np.transpose(data, (0, 2, 1)).reshape(chunks * classes, frames)
    binary = binarize_hysteresis(flat, onset=onset, offset=offset, initial_state=initial_state)
    binary = binary.reshape(chunks, classes, frames).transpose(0, 2, 1)
    return SlidingWindowFeature(binary.astype(np.float32), scores.sliding_window)


def _pad_speakers(data: np.ndarray, num_speakers: int) -> np.ndarray:
    """Zero columns up to `num_speakers` on the last axis."""
    missing = num_speakers - data.shape[-1]
    if missing <= 0:
        return data
    return np.pad(data, [(0, 0)] * (data.ndim - 1) + [(0, missing)])


@dataclass
class Resegmentation:
    """Refine `diarization` with `seg_inference`'s local segmentations."""

    seg_inference: SlidingInference
    warm_up: float = 0.05
    onset: float = 0.810
    offset: float = 0.481
    min_duration_on: float = 0.055
    min_duration_off: float = 0.098

    def __call__(self, waveform: np.ndarray, sample_rate: int, diarization: Annotation,
                 uri: Optional[str] = None, hook: Optional[Callable] = None) -> Annotation:
        if waveform.ndim == 1:
            waveform = waveform[None]
        duration = waveform.shape[-1] / sample_rate
        frames = receptive_field_window(self.seg_inference.cfg)
        warm_up = (self.warm_up, self.warm_up)

        segmentations = self.seg_inference(waveform, sample_rate, soft=True)
        if hook is not None:
            hook("segmentation", segmentations)
        binarized = binarize_chunked(segmentations, onset=self.onset, offset=self.offset)
        count = speaker_count(binarized, frames, warm_up=warm_up)
        if hook is not None:
            hook("speaker_counting", count)

        # the support reaches one window step past the end of the file, as
        # the reference's does
        labels = diarization.labels()
        discretized = diarization.discretize(
            Segment(0.0, duration + self.seg_inference.step), frames, labels=labels)
        if hook is not None:
            hook("@resegmentation/original", discretized)
        segmentations = trim(segmentations, warm_up=warm_up)
        if hook is not None:
            hook("@resegmentation/trim", segmentations)

        num_speakers = max(len(labels), segmentations.data.shape[-1])
        seg_data = _pad_speakers(segmentations.data, num_speakers)
        discretized = SlidingWindowFeature(_pad_speakers(discretized.data, num_speakers),
                                           discretized.sliding_window)
        num_chunks, num_frames, _ = seg_data.shape
        permutated = np.zeros_like(seg_data)
        for c in range(num_chunks):
            chunk = segmentations.sliding_window[c]
            local = discretized.crop(chunk, mode="loose").data[:num_frames]
            if local.shape[0] < num_frames:
                local = np.pad(local, ((0, num_frames - local.shape[0]), (0, 0)))
            out, _ = permutate_hungarian(local[None].astype(np.float32),
                                         seg_data[c][None].astype(np.float32), cost="mae")
            permutated[c] = out[0]
        permutated_swf = SlidingWindowFeature(permutated, segmentations.sliding_window)
        if hook is not None:
            hook("@resegmentation/permutated", permutated_swf)

        discrete = to_diarization(permutated_swf, count)
        result = Binarize(onset=0.5, offset=0.5, min_duration_on=self.min_duration_on,
                          min_duration_off=self.min_duration_off)(discrete)
        result.uri = uri
        # columns back to the input's speakers; the ones beyond them keep
        # SPEAKER_%02d names
        return result.rename_labels({
            str(i): labels[i] if i < len(labels) else f"SPEAKER_{i:02d}"
            for i in range(discrete.data.shape[-1])})
