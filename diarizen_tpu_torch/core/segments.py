"""Temporal structures for diarization: segments, timelines, annotations,
sliding windows.

These replace the pyannote.core data structures the reference depends on
(reference: pyannote-audio/pyannote/audio/core/{inference,io}.py usage of
pyannote.core.{Segment, SlidingWindow, SlidingWindowFeature, Annotation}).
Only the behavior the diarization pipeline needs is implemented; semantics
(e.g. ``SlidingWindow.closest_frame`` rounding) match pyannote.core exactly
because downstream stitching math depends on them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True, order=True)
class Segment:
    """A time interval [start, end) in seconds."""

    start: float
    end: float

    @property
    def duration(self) -> float:
        return max(0.0, self.end - self.start)

    @property
    def middle(self) -> float:
        return 0.5 * (self.start + self.end)

    def __bool__(self) -> bool:
        return self.end - self.start > 0

    def __and__(self, other: "Segment") -> "Segment":
        """Intersection (may be empty: start >= end)."""
        return Segment(max(self.start, other.start), min(self.end, other.end))

    def intersects(self, other: "Segment") -> bool:
        return max(self.start, other.start) < min(self.end, other.end)

    def overlap_duration(self, other: "Segment") -> float:
        return max(0.0, min(self.end, other.end) - max(self.start, other.start))

    def __str__(self) -> str:
        return f"[{self.start:.3f} --> {self.end:.3f}]"


class Timeline:
    """An ordered collection of segments (possibly overlapping)."""

    def __init__(self, segments: Optional[List[Segment]] = None):
        self._segments: List[Segment] = list(segments or [])
        self._dirty = True

    @property
    def segments(self) -> List[Segment]:
        # sorted lazily: per-insert sorting is O(n^2 log n) over a multi-hour
        # file's segment count (found by the 2 h host-stitching budget test)
        if self._dirty:
            self._segments.sort()
            self._dirty = False
        return self._segments

    def add(self, segment: Segment) -> None:
        self._segments.append(segment)
        self._dirty = True

    def __iter__(self) -> Iterator[Segment]:
        return iter(self.segments)

    def __len__(self) -> int:
        return len(self._segments)

    def __bool__(self) -> bool:
        return len(self._segments) > 0

    def duration(self) -> float:
        """Total duration of the support (merged overlaps counted once)."""
        return sum(s.duration for s in self.support())

    def extent(self) -> Segment:
        if not self._segments:
            return Segment(0.0, 0.0)
        return Segment(
            min(s.start for s in self._segments),
            max(s.end for s in self._segments),
        )

    def support(self, collar: float = 0.0) -> "Timeline":
        """Merge segments separated by a gap strictly shorter than `collar`
        (pyannote.core semantics: overlapping segments always merge; touching
        segments merge only when collar > 0)."""
        merged: List[Segment] = []
        for seg in self.segments:
            if merged and seg.start - merged[-1].end < collar:
                if seg.end > merged[-1].end:
                    merged[-1] = Segment(merged[-1].start, seg.end)
            else:
                merged.append(seg)
        return Timeline(merged)

    def crop(self, other: "Timeline") -> "Timeline":
        """Intersect this timeline with the support of `other`."""
        out: List[Segment] = []
        supports = other.support().segments
        for seg in self.segments:
            for sup in supports:
                inter = seg & sup
                if inter:
                    out.append(inter)
        return Timeline(out)

    def gaps(self, support: Optional[Segment] = None) -> "Timeline":
        support = support or self.extent()
        out: List[Segment] = []
        cursor = support.start
        for seg in self.support():
            if seg.start > cursor:
                out.append(Segment(cursor, min(seg.start, support.end)))
            cursor = max(cursor, seg.end)
        if cursor < support.end:
            out.append(Segment(cursor, support.end))
        return Timeline([s for s in out if s])


class Annotation:
    """Speaker-labelled segments: a list of (segment, track, label) rows.

    Minimal equivalent of pyannote.core.Annotation for pipeline output,
    RTTM serialization and DER scoring.
    """

    def __init__(self, uri: Optional[str] = None):
        self.uri = uri
        self._unsorted: List[Tuple[Segment, object, str]] = []
        self._sorted = True

    @property
    def _rows(self) -> List[Tuple[Segment, object, str]]:
        # lazily sorted: per-insert sorting made pipeline output assembly
        # O(n^2 log n) over a multi-hour file's segment count
        if not self._sorted:
            self._unsorted.sort(key=lambda r: (r[0].start, r[0].end, str(r[2])))
            self._sorted = True
        return self._unsorted

    def __setitem__(self, key: Tuple[Segment, object], label: str) -> None:
        segment, track = key
        self._unsorted.append((segment, track, label))
        self._sorted = False

    def itertracks(
        self, yield_label: bool = True
    ) -> Iterator[Tuple[Segment, object, str]]:
        for row in self._rows:
            yield row if yield_label else row[:2]

    def labels(self) -> List[str]:
        return sorted({label for _, _, label in self._unsorted})

    def label_timeline(self, label: str) -> Timeline:
        return Timeline([seg for seg, _, lab in self._unsorted if lab == label])

    def get_timeline(self) -> Timeline:
        return Timeline([seg for seg, _, _ in self._unsorted])

    def __len__(self) -> int:
        return len(self._unsorted)

    def __bool__(self) -> bool:
        return len(self._unsorted) > 0

    def crop(self, support: Timeline) -> "Annotation":
        out = Annotation(uri=self.uri)
        supports = support.support().segments
        for seg, track, label in self._unsorted:
            for sup in supports:
                inter = seg & sup
                if inter:
                    out._unsorted.append((inter, track, label))
        out._sorted = False
        return out

    def rename_labels(self, mapping: Dict[str, str]) -> "Annotation":
        out = Annotation(uri=self.uri)
        for seg, track, label in self._rows:
            out._unsorted.append((seg, track, mapping.get(label, label)))
        return out

    def support(self, collar: float = 0.0) -> "Annotation":
        """Per-label merge of overlapping segments."""
        out = Annotation(uri=self.uri)
        for label in self.labels():
            for i, seg in enumerate(self.label_timeline(label).support(collar)):
                out._unsorted.append((seg, i, label))
        out._sorted = False
        return out

    def chart(self) -> List[Tuple[str, float]]:
        """Labels sorted by decreasing total speech duration."""
        totals: Dict[str, float] = {}
        for seg, _, label in self._rows:
            totals[label] = totals.get(label, 0.0) + seg.duration
        return sorted(totals.items(), key=lambda kv: (-kv[1], kv[0]))

    def to_rttm(self) -> str:
        lines = []
        uri = self.uri or "<NA>"
        for seg, _, label in self._rows:
            lines.append(
                f"SPEAKER {uri} 1 {seg.start:.3f} {seg.duration:.3f} "
                f"<NA> <NA> {label} <NA> <NA>"
            )
        return "\n".join(lines) + ("\n" if lines else "")

    def discretize(
        self,
        support: Segment,
        resolution: "SlidingWindow",
        labels: Optional[List[str]] = None,
    ) -> "SlidingWindowFeature":
        """Rasterize to a binary (num_frames, num_labels) SlidingWindowFeature.

        pyannote.core Annotation.discretize equivalent, used by the
        resegmentation pipeline (reference pipelines/resegmentation.py:233-239)
        to align an input diarization with the segmentation model's frame
        grid. Frame i (window [support.start + i*step, +duration)) is active
        for a label iff a segment of that label contains the frame's center —
        the same frame-center rasterization the training dataset uses.
        """
        labels = self.labels() if labels is None else labels
        window = SlidingWindow(
            duration=resolution.duration, step=resolution.step, start=support.start
        )
        num_frames = max(0, int(round(support.duration / resolution.step)))
        data = np.zeros((num_frames, len(labels)), dtype=np.float32)
        centers = (
            support.start
            + np.arange(num_frames) * resolution.step
            + 0.5 * resolution.duration
        )
        for k, label in enumerate(labels):
            for seg in self.label_timeline(label):
                data[:, k] = np.maximum(
                    data[:, k],
                    ((centers >= seg.start) & (centers < seg.end)).astype(np.float32),
                )
        return SlidingWindowFeature(data, window)


@dataclass(frozen=True)
class SlidingWindow:
    """Regular sliding window: i-th window is [start + i*step, +duration).

    Rounding semantics of `closest_frame` follow pyannote.core: the frame
    whose *center* is closest to time t.
    """

    duration: float
    step: float
    start: float = 0.0

    def __getitem__(self, i: int) -> Segment:
        s = self.start + i * self.step
        return Segment(s, s + self.duration)

    def closest_frame(self, t: float) -> int:
        return int(np.rint((t - self.start - 0.5 * self.duration) / self.step))

    def samples(self, duration: float, mode: str = "strict") -> int:
        """Number of windows fitting in `duration`."""
        if mode == "strict":
            return int(math.floor((duration - self.duration) / self.step)) + 1
        if mode == "loose":
            return int(math.floor((duration + self.duration) / self.step))
        # center
        return int(math.ceil((duration - self.duration / 2) / self.step))

    def crop_range(
        self, focus: Segment, mode: str = "loose", duration: Optional[float] = None
    ) -> Tuple[int, int]:
        """Range [i0, i1) of window indices intersecting `focus` (loose mode)."""
        i0 = int(np.ceil((focus.start - self.duration - self.start) / self.step))
        i1 = int(np.floor((focus.end - self.start) / self.step)) + 1
        return max(0, i0), max(0, i1)


class SlidingWindowFeature:
    """(num_frames, ...) data attached to a SlidingWindow.

    If data has ndim >= 3, the leading axis indexes chunks of the sliding
    window (matches pyannote's use for per-chunk segmentation scores).
    """

    def __init__(self, data: np.ndarray, sliding_window: SlidingWindow):
        self.data = data
        self.sliding_window = sliding_window

    def __len__(self) -> int:
        return self.data.shape[0]

    def __iter__(self) -> Iterator[Tuple[Segment, np.ndarray]]:
        for i in range(len(self)):
            yield self.sliding_window[i], self.data[i]

    def __getitem__(self, i: int) -> np.ndarray:
        return self.data[i]

    @property
    def extent(self) -> Segment:
        """Time span covered by the windows of the leading axis."""
        sw = self.sliding_window
        n = self.data.shape[0]
        return Segment(sw.start, sw.start + (n - 1) * sw.step + sw.duration)

    def crop(self, focus: Segment, mode: str = "loose") -> "SlidingWindowFeature":
        """Leading-axis crop to the windows intersecting `focus`.

        Loose-mode index math matches pyannote.core (windows *overlapping*
        the focus are kept, so the result can extend past `focus`); the
        stitching parity gate depends on this exact rounding
        (pyannote SlidingWindow.crop / SlidingWindowFeature.crop).
        """
        assert mode == "loose"
        sw = self.sliding_window
        i = int(np.ceil((focus.start - sw.duration - sw.start) / sw.step))
        j = int(np.floor((focus.end - sw.start) / sw.step))
        n = self.data.shape[0]
        data = self.data[max(i, 0) : min(j + 1, n)]
        new_sw = SlidingWindow(
            start=sw.start + max(i, 0) * sw.step,
            duration=sw.duration,
            step=sw.step,
        )
        return SlidingWindowFeature(data, new_sw)
