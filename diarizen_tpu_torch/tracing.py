"""Host spans and per-file records of the serving pipeline.

`DiarizationPipeline` opens a span at each of its layer boundaries, at the
file and stage level (never per batch or per launch):

    diarize.dispatch    `_dispatch_file`: the file's device work enqueued
      diarize.segment     the segmentation enqueue
      diarize.stitch      the device-side stitch (`FusedStitch.stitch`)
      diarize.embed       the embedding enqueue (`EmbeddingInference.dispatch`)
    diarize.finish      `_finish_file`: the file's host stages
      diarize.wait        every blocking device-to-host fetch
      diarize.cluster     the clustering call
      diarize.reconstruct reconstruction, binarization, relabelling, centroids
    diarize.trim        `stream`'s heap trim, on the file whose finish set it off

On the host route (`fused_stitch=False`, a file without a plan, a process
group) the segmentation is fetched by a `diarize.wait` (in `stream` before
the next file is enqueued, so outside `diarize.finish`), and the stitch and
the embeddings run inside `diarize.finish`, the embeddings' fetch a
`diarize.wait` inside `diarize.embed`.

While a `torch.profiler` is recording, a span is also a `record_function`
range, so it lands in the profiler's Chrome trace beside the kernels, on
the same clock, as a `user_annotation` event. Otherwise a span costs one
check of the profiler's state and two reads of the host clock; it never
enters `record_function`, which costs microseconds even with no profiler.

Every file the pipeline finishes leaves a `FileRecord`: the pipeline
instance and the file's sequence number in it, its spans on the host clock
(`time.perf_counter_ns`), its audio seconds, how many of its segmentation
batches and of its embedding batches replayed a captured CUDA graph and how
many ran eagerly (`infer/sliding.py`, `EmbeddingInference` in
`infer/pipeline.py`, counted on the thread's current file) and, on the fused
route on a CUDA device, the stream milliseconds of its segmentation (with
the device stitch) and of its embeddings: `StageEvents` between the stages'
enqueues; and, for a segmentation model that runs in stages (WavLM +
Conformer), those of the extractor and of the encoder, from timing events at
the stage boundaries of every batch, summed over the file's batches, and for
a multi-channel model also those of the encoder's stretch on every
channel's stream, from the event before the encoder to the one after the
channel mean. A multi-channel model's file also records the microphones it
was served on and the (window, microphone) rows its embeddings ran.
`records()` returns the most recent `KEEP`; nothing is written anywhere.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

KEEP = 4096  # records kept, newest last

_records: deque = deque(maxlen=KEEP)
_pipeline_ids = itertools.count()
_current = threading.local()  # the file whose spans this thread is opening


def records() -> List["FileRecord"]:
    """The most recent `KEEP` files finished, in the order they finished."""
    return list(_records)


def current() -> Optional["FileRecord"]:
    """The record of the file whose span this thread is inside, or None."""
    return getattr(_current, "record", None)


def new_pipeline_id() -> int:
    """A process-unique identity for a pipeline instance."""
    return next(_pipeline_ids)


@dataclass
class FileRecord:
    """One file served: `spans` holds (name, start ns, end ns) in the order
    they closed; `seg_graph_batches` and `seg_eager_batches` the
    segmentation batches that replayed a CUDA graph and those that ran the
    forward eagerly, `emb_graph_batches` and `emb_eager_batches` the same
    of the embedding batches; the stream milliseconds (`StageEvents`) are
    None off the fused route or off CUDA, and `seg_extract_ms` and
    `seg_encode_ms` also for a segmentation model without stages.
    A multi-channel model's file: `channels` the microphones served,
    `emb_rows` the (window, microphone) rows through the embedding model,
    and on the fused route on CUDA `seg_fuse_ms`, the part of
    `seg_encode_ms` on every channel's stream, through the channel mean;
    None, 0 and None for a single-channel model."""

    pipeline: int
    file: int
    audio_s: float
    spans: List[Tuple[str, int, int]] = field(default_factory=list)
    seg_graph_batches: int = 0
    seg_eager_batches: int = 0
    emb_graph_batches: int = 0
    emb_eager_batches: int = 0
    seg_stream_ms: Optional[float] = None
    embed_stream_ms: Optional[float] = None
    seg_extract_ms: Optional[float] = None
    seg_encode_ms: Optional[float] = None
    channels: Optional[int] = None
    emb_rows: int = 0
    seg_fuse_ms: Optional[float] = None

    def ms(self, name: str) -> float:
        """Host milliseconds inside the spans called `name`, summed."""
        return sum(end - start for n, start, end in self.spans if n == name) / 1e6


def finished(record: FileRecord) -> None:
    """Keeps a finished file's record for `records()`."""
    _records.append(record)


class span:
    """`with span(name, record):` times the block on the host clock into
    `record.spans`, and makes `record` this thread's current file while the
    block runs; `span(name)` records on the current file, or nowhere when
    there is none. Inside a recording profiler the block is also a
    `record_function(name)` range."""

    __slots__ = ("name", "record", "outer", "range", "start")

    def __init__(self, name: str, record: Optional[FileRecord] = None):
        self.name = name
        self.record = record

    def __enter__(self) -> "span":
        self.outer = current()
        if self.record is None:
            self.record = self.outer
        _current.record = self.record
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.record is not None:
            self.record.spans.append((self.name, self.start, end))
        _current.record = self.outer


class StageEvents:
    """Three CUDA timing events on a file's stream: `mark(0)` before the
    segmentation's enqueue, `mark(1)` after the device stitch's, `mark(2)`
    after the embeddings'; and for every segmentation batch that runs in
    stages one more a stage, `batch()` then `mark_batch(0)` before its
    extractor, `mark_batch(1)` before its encoder and `mark_batch(s)` before
    each later stage, the last its back end (a multi-channel model's
    `mark_batch(2)` after the channel mean: four stages, four events). Once
    the host has waited for work queued behind the last mark (the
    file's `HostFetch`), `read(record, free)` stores the stages'
    milliseconds without another wait and hands the events back to `free`,
    the pipeline's list that `take` draws from; a batch's events go back to
    this object's own spares. So at most the files in flight hold events,
    and once the longest file has run, none is made or destroyed per file.

    An event's time is when the stream reaches it, so a stage's milliseconds
    span the card's work and any stretch in which the card waited for the
    host to enqueue more of the stage: while the host's launches set the
    pace they read the host's pace, not the card's busy time."""

    __slots__ = ("events", "stream", "batches", "spare", "stages")

    def __init__(self):
        self.events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        self.stream = None
        self.batches: list = []  # the file's batches' events, in order
        self.spare: list = []
        self.stages = 0  # the events a batch marks

    @staticmethod
    def take(free: list, stream) -> "StageEvents":
        """Events from `free` (or new ones) to record on `stream`; ones that
        record nothing where `stream` is None (off CUDA)."""
        if stream is None:
            return NO_EVENTS
        events = free.pop() if free else StageEvents()
        events.stream = stream
        return events

    def mark(self, stage: int) -> None:
        self.events[stage].record(self.stream)

    def batch(self) -> None:
        """Starts the events of the next segmentation batch."""
        self.batches.append(self.spare.pop() if self.spare else [])

    def mark_batch(self, boundary: int) -> None:
        events = self.batches[-1]
        while len(events) <= boundary:
            events.append(torch.cuda.Event(enable_timing=True))
        events[boundary].record(self.stream)
        self.stages = max(self.stages, boundary + 1)

    def read(self, record: FileRecord, free: list) -> None:
        first, between, last = self.events
        record.seg_stream_ms = first.elapsed_time(between)
        record.embed_stream_ms = between.elapsed_time(last)
        if self.batches:
            n = self.stages
            record.seg_extract_ms = sum(b[0].elapsed_time(b[1]) for b in self.batches)
            record.seg_encode_ms = sum(b[1].elapsed_time(b[n - 1]) for b in self.batches)
            if n > 3:  # the encoder's stretch on every channel's stream
                record.seg_fuse_ms = sum(b[1].elapsed_time(b[2]) for b in self.batches)
            self.spare.extend(self.batches)
            self.batches.clear()
            self.stages = 0
        free.append(self)


class _NoEvents:
    """`StageEvents` off CUDA: nothing recorded, nothing read."""

    def mark(self, stage: int) -> None:
        pass

    def batch(self) -> None:
        pass

    def mark_batch(self, boundary: int) -> None:
        pass

    def read(self, record: FileRecord, free: list) -> None:
        pass


NO_EVENTS = _NoEvents()
