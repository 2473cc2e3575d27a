"""Hysteresis thresholding and segment extraction (host-side numpy).

Reference semantics: pyannote-audio/pyannote/audio/utils/signal.py:44-374
(`binarize`, `Binarize`). These run on the host over final aggregated scores
(tiny arrays); exact reference behavior matters for the DER parity gate.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from diarizen_tpu_torch.core.segments import Annotation, Segment, SlidingWindowFeature


def binarize_hysteresis(
    scores: np.ndarray,
    onset: float = 0.5,
    offset: Optional[float] = None,
    initial_state: Optional[Union[bool, np.ndarray]] = None,
) -> np.ndarray:
    """Batched hysteresis thresholding.

    scores : (batch, num_frames)
    Each row switches ON when score > onset, OFF when score < offset, and
    holds its previous state in between. NaNs are treated as 0.

    Implemented by forward-filling the last well-defined state.
    """
    offset = onset if offset is None else offset
    scores = np.nan_to_num(scores)
    batch, num_frames = scores.shape

    if initial_state is None:
        init = scores[:, 0] >= 0.5 * (onset + offset)
    elif isinstance(initial_state, bool):
        init = np.full((batch,), initial_state, dtype=bool)
    else:
        init = np.asarray(initial_state, dtype=bool)

    on = scores > onset
    off = scores < offset
    defined = on | off

    # index of the latest defined frame at or before each position (-1 if none)
    idx = np.where(defined, np.arange(num_frames)[None, :], -1)
    idx = np.maximum.accumulate(idx, axis=1)

    rows = np.arange(batch)[:, None]
    state_at = on[rows, np.maximum(idx, 0)]
    return np.where(idx >= 0, state_at, init[:, None])


class Binarize:
    """Scores -> Annotation with hysteresis + min-duration + padding rules.

    Reference: utils/signal.py Binarize (Gelly & Gauvain 2015 heuristics):
    onset/offset hysteresis, pad_onset/pad_offset segment extension,
    min_duration_off gap filling, min_duration_on removal.
    """

    def __init__(
        self,
        onset: float = 0.5,
        offset: Optional[float] = None,
        min_duration_on: float = 0.0,
        min_duration_off: float = 0.0,
        pad_onset: float = 0.0,
        pad_offset: float = 0.0,
    ):
        self.onset = onset
        self.offset = onset if offset is None else offset
        self.min_duration_on = min_duration_on
        self.min_duration_off = min_duration_off
        self.pad_onset = pad_onset
        self.pad_offset = pad_offset

    def _active_segments(
        self, row: np.ndarray, frame_times: np.ndarray
    ) -> List[Segment]:
        """Segment boundaries from one score row.

        Matches the reference's stateful sweep: a segment starts at the frame
        crossing onset and ends at the frame dropping below offset; timestamps
        are frame middles, and a still-active run ends at the last frame's
        middle (signal.py:301-303).
        """
        segments: List[Segment] = []
        is_active = row[0] > self.onset
        start = frame_times[0]
        t = frame_times[0]
        for t, y in zip(frame_times[1:], row[1:]):
            if is_active:
                if y < self.offset:
                    segments.append(
                        Segment(start - self.pad_onset, t + self.pad_offset)
                    )
                    is_active = False
            else:
                if y > self.onset:
                    start = t
                    is_active = True
        if is_active:
            segments.append(Segment(start - self.pad_onset, t + self.pad_offset))
        return segments

    def _active_segments_vec(
        self, rows: np.ndarray, frame_times: np.ndarray
    ) -> List[List[Segment]]:
        """Vectorized equivalent of `_active_segments` over all classes.

        The stateful sweep is a hysteresis: state flips ON at frames with
        score > onset, OFF at frames with score < offset, and holds otherwise
        — which is forward-filling the last *defined* frame's on/off value.
        Only valid when onset >= offset (a frame can't be both); the caller
        falls back to the python sweep otherwise.
        """
        num_classes, num_frames = rows.shape
        on = rows > self.onset
        off = rows < self.offset
        defined = on | off
        idx = np.where(defined, np.arange(num_frames)[None, :], -1)
        idx = np.maximum.accumulate(idx, axis=1)
        cls = np.arange(num_classes)[:, None]
        state = np.where(idx >= 0, on[cls, np.maximum(idx, 0)], on[:, :1])

        out: List[List[Segment]] = []
        for k in range(num_classes):
            s = state[k]
            starts_idx = np.flatnonzero(s[1:] & ~s[:-1]) + 1
            ends_idx = np.flatnonzero(~s[1:] & s[:-1]) + 1
            starts = frame_times[starts_idx]
            ends = frame_times[ends_idx]
            if s[0]:
                starts = np.concatenate([[frame_times[0]], starts])
            if s[-1]:
                ends = np.concatenate([ends, [frame_times[-1]]])
            out.append(
                [
                    Segment(a - self.pad_onset, b + self.pad_offset)
                    for a, b in zip(starts, ends)
                ]
            )
        return out

    def __call__(self, scores: SlidingWindowFeature) -> Annotation:
        """scores: (num_frames, num_classes) SlidingWindowFeature."""
        data = np.asarray(scores.data)
        window = scores.sliding_window
        num_frames, num_classes = data.shape
        frame_times = (
            window.start
            + window.step * np.arange(num_frames, dtype=np.float64)
            + 0.5 * window.duration
        )

        annotation = Annotation()
        if self.onset >= self.offset:
            per_class = self._active_segments_vec(data.T, frame_times)
        else:
            per_class = [
                self._active_segments(data[:, k], frame_times)
                for k in range(num_classes)
            ]
        for k in range(num_classes):
            for i, seg in enumerate(per_class[k]):
                annotation[seg, i] = str(k)

        # padding may create overlaps; merge them + fill short same-label gaps
        if self.pad_onset > 0 or self.pad_offset > 0 or self.min_duration_off > 0:
            annotation = annotation.support(collar=self.min_duration_off)

        if self.min_duration_on > 0:
            kept = Annotation(uri=annotation.uri)
            for seg, track, label in annotation.itertracks():
                if seg.duration >= self.min_duration_on:
                    kept[seg, track] = label
            annotation = kept
        return annotation
