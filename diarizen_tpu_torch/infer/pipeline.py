"""Speaker diarization pipeline (port of diarizen_tpu/infer/pipeline.py):
segment -> count -> embed -> cluster -> reconstruct -> Annotation.

1. sliding-window segmentation on channel 0 (hard powerset multilabel); a
   multi-channel model reads its C channels and also gives one weight a
   channel for every window;
2. median filter (size (1, 11, 1), reflect);
3. frame-level speaker count (overlap-add, rint);
4. per-(chunk, speaker) masked embeddings, excluding overlapped frames where
   enough clean frames remain; the embedding model runs once per chunk with
   an (S, frames) weight matrix (a multi-channel model's: once per (chunk,
   channel) with the chunk's plain masks, the channels' embeddings then
   summed under the chunk's channel weights on the device);
5. global clustering (AHC);
6. cap the count, mark inactive speakers, reconstruct, keep the top-count
   speakers per frame and binarize into an Annotation.

Stages 5 and 6 run on the host in numpy. Stages 2 and 3 and the weights of
stage 4 run on the device between the two models (`infer/fused.py`, the
default), so that a file's device work is enqueued without a host wait, or on
the host in numpy (`fused_stitch=False`, and any file the fused route cannot
plan); the two routes give identical results. `stream` pipelines files: the
next file's device work is enqueued before this file's host stages run.
Every file leaves host spans at the stage boundaries and a record of them
(`tracing.py`).

Single- and multi-channel models share every line of this path: the
dispatch, the device stitch, the one host wait, the finish, `stream`, the
spans and records. What differs lies below it: `SlidingInference` keeps a
multi-channel model's channels and returns its channel weights beside the
segmentation, and `EmbeddingInference.dispatch` takes (C, N) waves with
those weights. The multi-channel recipe's stitch gives its embeddings the
plain masks (`embedding_exclude_overlap=False`, as `from_pretrained` sets
for such a model).

In a process group (`parallel/distributed.py`; of one process too) every
process segments the whole file, embeds a strided shard of its windows,
gathers the embeddings, and keeps process 0's clusters; the host route is
taken. With a mesh (`DiarizationPipeline(mesh=)`, `SlidingInference(mesh=)`,
`parallel/mesh.py`) both stages shard their windows over the mesh's data
axis, parameters replicated: the model ranks of one data index compute the
same shard.
"""

from __future__ import annotations

import ctypes
import functools
import gc
import math
from dataclasses import dataclass, field
from itertools import repeat
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch
from scipy.ndimage import median_filter

from diarizen_tpu_torch import tracing
from diarizen_tpu_torch.core.segments import Annotation, SlidingWindow, SlidingWindowFeature
from diarizen_tpu_torch.infer.fused import FusedStitch, make_fused_stitch
from diarizen_tpu_torch.infer.sliding import (
    GraphedBatches,
    SlidingInference,
    batch_row_spans,
    gather_rows,
    receptive_field_window,
    tail_size,
)
from diarizen_tpu_torch.models.eend import EendConfig
from diarizen_tpu_torch.models.fbank import FRAME_LENGTH, FRAME_SHIFT, kaldi_fbank, num_fbank_frames
from diarizen_tpu_torch.models.resnet import ResNet
from diarizen_tpu_torch.ops.aggregate import aggregate, trim
from diarizen_tpu_torch.ops.binarize import Binarize
from diarizen_tpu_torch.parallel.distributed import (
    broadcast_from_host,
    gather_window_shards,
    in_group,
    process_window_shard,
)
from diarizen_tpu_torch.utils import (
    HostFetch,
    is_oom_error,
    resolve_device,
    to_device_async,
)


def speaker_count(
    binarized: SlidingWindowFeature,
    frames: SlidingWindow,
    warm_up: Tuple[float, float] = (0.1, 0.1),
) -> SlidingWindowFeature:
    """Frame-level instantaneous speaker count."""
    trimmed = trim(binarized, warm_up=warm_up)
    count = aggregate(
        SlidingWindowFeature(
            np.sum(trimmed.data, axis=-1, keepdims=True), trimmed.sliding_window
        ),
        frames,
        hamming=False,
        missing=0.0,
        skip_average=False,
    )
    count.data = np.rint(count.data).astype(np.uint8)
    return count


def to_diarization(
    segmentations: SlidingWindowFeature,
    count: SlidingWindowFeature,
) -> SlidingWindowFeature:
    """Aggregate clustered segmentations and keep the top-count[t] speakers
    per frame."""
    activations = aggregate(
        segmentations,
        count.sliding_window,
        hamming=False,
        missing=0.0,
        skip_average=True,
    )
    _, num_speakers = activations.data.shape
    max_speakers_per_frame = int(np.max(count.data)) if count.data.size else 0
    if num_speakers < max_speakers_per_frame:
        activations.data = np.pad(
            activations.data, ((0, 0), (0, max_speakers_per_frame - num_speakers))
        )

    # align on the common extent with loose-mode crops (the activation side
    # can carry a couple of trailing frames past the count; they stay 0)
    extent = activations.extent & count.extent
    activations = activations.crop(extent)
    count = count.crop(extent)

    act = activations.data
    n = min(len(count.data), len(act))
    cnt = count.data[:n, 0]

    # speaker ranked i at frame t is active iff i < count[t]
    order = np.argsort(-act, axis=-1)
    binary = np.zeros_like(act)
    keep = (np.arange(act.shape[1])[None, :] < cnt[:, None]).astype(act.dtype)
    np.put_along_axis(binary[:n], order[:n], keep, axis=1)
    return SlidingWindowFeature(binary, activations.sliding_window)


def reconstruct(
    segmentations: SlidingWindowFeature,
    hard_clusters: np.ndarray,
    count: SlidingWindowFeature,
) -> SlidingWindowFeature:
    """Map local speakers to clusters: NaN-initialised (chunks, frames,
    clusters), max over the local speakers of one cluster."""
    num_chunks, num_frames, _ = segmentations.data.shape
    num_clusters = int(np.max(hard_clusters)) + 1
    clustered = np.full(
        (num_chunks, num_frames, num_clusters), np.nan, dtype=np.float32
    )
    data = segmentations.data
    for k in range(num_clusters):
        member = hard_clusters == k  # (chunks, S)
        has = member.any(axis=1)
        if not has.any():
            continue
        vals = np.max(np.where(member[:, None, :], data, -np.inf), axis=2)
        clustered[has, :, k] = vals[has]
    return to_diarization(
        SlidingWindowFeature(clustered, segmentations.sliding_window), count
    )


class EmbeddingInference(GraphedBatches):
    """Batched per-chunk masked speaker embeddings.

    With `shared_fbank` (the default) the log-mel filterbank is computed ONCE
    over the whole file and each window gathers its frames from it (windows
    overlap 90%); this is exact because every fbank frame depends only on its
    own 400 samples, and it applies when the window starts land on the
    160-sample frame hop. Otherwise (`shared_fbank=False`, or a window step
    off the 10 ms grid) each window's waveform is gathered and its fbank
    computed on its own. Per-window mean normalisation follows either.

    On a CUDA device outside a process group each batch replays a CUDA
    graph captured at its row count (8, 16, 24 or 32 at batch 32), fbank
    route, compute type and the process state the forward reads
    (`ops.forward_switches`, the TF32 switches among it), as the
    segmentation's batches do (`infer/sliding.py`, `GraphedBatches`):
    the per-window fbank, the mean normalisation and the ResNet with its
    pooling and head run inside the graph, reading two static inputs (the
    gathered windows and the batch's weights); the whole-file fbank, the
    gathers, the weights' slice and zero pad and the copy of the output
    stay outside it. So a batch is enqueued in a handful of launches and
    `dispatch` returns while the card still has the file's embeddings
    queued. The graphs have their own memory pool, dropped with them when
    the ResNet's parameters or buffers change and when `halve_batch` runs.

    A (C, padded) multi-channel wave runs one row a (window, channel),
    window by window, in the same batches of `batch_size` rows, each
    channel's windows read from its own whole-file fbank, with the window's
    weights for every channel; the channels' embeddings of a window are then
    summed under its channel weights on the device, one (S, D) a window."""

    _what = "embedding inference"

    def __init__(
        self,
        model: ResNet,
        window_size: int,
        num_speakers: int,
        batch_size: int = 16,
        compute_dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        shared_fbank: bool = True,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.window_size = window_size
        self.num_speakers = num_speakers
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.shared_fbank = shared_fbank
        self.embed_dim = model.cfg.embed_dim
        self._frames_per_window = num_fbank_frames(window_size)
        self._init_graphs()  # keyed by `_graph_key` and the row count

    @property
    def min_num_samples(self) -> int:
        """Smallest crop giving at least one embedding frame."""
        return FRAME_LENGTH

    @torch.inference_mode()
    def dispatch(self, wave: torch.Tensor, starts: np.ndarray,
                 weights: Union[torch.Tensor, np.ndarray],
                 hook: Optional[Callable] = None,
                 channel_weights: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        """Enqueue every batch: device waveform + (N,) window starts on the
        host + (N, S, F) weights (a device tensor, or a host array that is
        uploaded once) -> (N, S, D) float32 embeddings ON THE DEVICE, without
        waiting for them (None for no windows). Fetch with `collect`. Each
        batch replays its graph where one applies (class docstring); the
        file's record, where this runs inside one of its spans, counts the
        batches that replayed a graph and those that ran eagerly. A (C,
        padded) wave takes the (N, C) `channel_weights` of its windows
        (device or host) and counts its rows on the record."""
        n = len(starts)
        if n == 0:
            return None
        starts = np.asarray(starts, np.int64)
        channels = wave.shape[0] if wave.dim() == 2 else None
        shared = self.shared_fbank and not (starts % FRAME_SHIFT).any()
        if shared:  # windows of frames of one whole-file fbank (a channel)
            source, length = kaldi_fbank(wave.reshape(-1, wave.shape[-1]) * 32768.0), \
                self._frames_per_window
            starts = starts // FRAME_SHIFT
        else:  # windows of samples, an fbank each
            source, length = wave.reshape(-1, wave.shape[-1]), self.window_size
        if not isinstance(weights, torch.Tensor):
            weights = to_device_async(np.asarray(weights), self.device)
        if channels is not None:  # a row a (window, channel), window by window
            starts = (starts[:, None] + source.shape[1] * np.arange(channels)).reshape(-1)
            weights = weights.repeat_interleave(channels, dim=0)
        source = source.reshape((-1,) + tuple(source.shape[2:]))
        starts_dev = to_device_async(starts, self.device)
        rows = len(starts)
        out = torch.zeros((rows, self.num_speakers, self.embed_dim), device=self.device)
        key = self._graph_key(wave, shared, self.compute_dtype)
        stages = [functools.partial(self._forward, shared)]
        replayed = eager = 0
        for off, blen, pad in batch_row_spans(
                rows, self.batch_size, lambda m: tail_size(m, self.batch_size)):
            windows = gather_rows(source, starts_dev[off: off + blen], length, pad)
            wb = weights[off: off + blen].float()
            if pad:
                wb = torch.cat([wb, wb.new_zeros((pad,) + tuple(wb.shape[1:]))])
            emb, from_graph = self._run_batch(
                None if key is None else key + (len(windows),), stages, (windows, wb))
            replayed += from_graph
            eager += not from_graph
            out[off: off + blen] = emb[:blen]
            if hook is not None:
                hook("embeddings", None, total=rows, completed=min(off + blen + pad, rows))
        record = tracing.current()
        if record is not None:
            record.emb_graph_batches += replayed
            record.emb_eager_batches += eager
        if channels is None:
            return out
        if record is not None:
            record.emb_rows += rows
        if not isinstance(channel_weights, torch.Tensor):
            channel_weights = to_device_async(np.asarray(channel_weights, np.float32),
                                              self.device)
        return torch.einsum("ncsd,nc->nsd", out.view(n, channels, *out.shape[1:]),
                            channel_weights)

    def _forward(self, shared: bool, windows: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """A batch's (rows, S, D) embeddings from its gathered windows
        (fbank frames, or samples without `shared`) and (rows, S, F)
        weights."""
        if not shared:
            windows = kaldi_fbank(windows * 32768.0)
        windows = windows - windows.mean(dim=1, keepdim=True)
        return self.model(windows.to(self.compute_dtype), weights)

    def collect(self, dispatched: Optional[torch.Tensor]) -> np.ndarray:
        """The one device-to-host copy of a dispatched result; clustering
        reads float64 on the host."""
        if dispatched is None:
            return np.zeros((0, self.num_speakers, self.embed_dim))
        return dispatched.cpu().numpy().astype(np.float64)

    def __call__(self, wave: torch.Tensor, starts: np.ndarray,
                 weights: Union[torch.Tensor, np.ndarray],
                 hook: Optional[Callable] = None,
                 channel_weights: Optional[np.ndarray] = None) -> np.ndarray:
        """Device waveform + (N,) window starts + (N, S, F) weights [+ (N, C)
        channel weights of a (C, padded) wave] -> (N, S, D) float64
        embeddings. A device out-of-memory error halves `batch_size`, drops
        the graphs and runs the file again."""
        while True:
            try:
                dispatched = self.dispatch(wave, starts, weights, hook, channel_weights)
                with tracing.span("diarize.wait"):
                    return self.collect(dispatched)
            except Exception as e:  # noqa: BLE001 - the helper re-raises all but OOM
                self.halve_batch(e)


def _trim_host_memory() -> None:
    """Garbage-collect and hand freed heap pages back to the system (glibc's
    malloc_trim; elsewhere the collection alone)."""
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # another libc
        pass


@dataclass
class DiarizationPipeline:
    """End-to-end diarization: __call__(waveform, sample_rate, uri) -> Annotation."""

    seg_inference: SlidingInference
    emb_inference: EmbeddingInference
    clustering: Callable  # AgglomerativeClustering
    eend_cfg: EendConfig
    min_speakers: int = 1
    max_speakers: int = 8
    apply_median_filtering: bool = True
    embedding_exclude_overlap: bool = True
    # The device-side stitch (infer/fused.py): median filter, speaker count
    # and embedding weights run ON THE DEVICE between the two models, so a
    # file's whole device chain is enqueued with no host wait and fetched
    # once. Bit-identical to the host stages (tests/test_torch_stream.py).
    fused_stitch: bool = True
    # a `parallel/mesh.py` mesh: the embedding windows shard over its data
    # axis (over the whole process group without one)
    mesh: Optional[Any] = None
    _fused: Optional[FusedStitch] = field(default=None, init=False, repr=False)
    # centroids of the most recent file finished, aligned to its labels()
    # order (read by return_embeddings; per file in stream mode it is racy:
    # use __call__ when centroids are needed)
    _last_centroids: Optional[np.ndarray] = field(default=None, init=False, repr=False)
    # this instance's identity in `tracing.records()` and the files it has
    # taken; `dataclasses.replace` gives the copy an identity of its own
    _trace_id: int = field(default_factory=tracing.new_pipeline_id, init=False, repr=False,
                           compare=False)
    _files_taken: int = field(default=0, init=False, repr=False, compare=False)
    # `tracing.StageEvents` no file in flight holds, reused file after file
    _free_events: list = field(default_factory=list, init=False, repr=False, compare=False)

    def __call__(
        self,
        waveform: np.ndarray,
        sample_rate: int = 16000,
        uri: Optional[str] = None,
        num_speakers: Optional[int] = None,
        hook: Optional[Callable] = None,
        return_embeddings: bool = False,
    ) -> Union[Annotation, Tuple[Annotation, np.ndarray]]:
        """`hook(step_name, artifact, total=, completed=)` is called after
        each stage ("segmentation", "speaker_counting", "embeddings",
        "clustering", "discrete_diarization") and, with `artifact=None`,
        after each batch inside segmentation and embedding; see
        `hooks.ProgressHook`, `TimingHook`, `ArtifactHook`. On the fused
        route (the default) a file's device work is only enqueued before
        its one host wait, so `TimingHook`'s segmentation and embedding
        seconds are enqueue time; the host time of each stage and the
        stream time of segmentation and embeddings are in the file's
        `tracing.records()` entry.

        `return_embeddings=True` also returns the speaker centroids, row i
        for `annotation.labels()[i]`, zero rows for speakers without one."""
        state = self._dispatch_file(waveform, sample_rate, uri, hook)
        ann = self._finish_file(state, num_speakers, hook)
        if return_embeddings:
            return ann, self._last_centroids
        return ann

    def stream(
        self,
        waveforms: Iterable[np.ndarray],
        sample_rate: int = 16000,
        uris: Optional[Iterable[Optional[str]]] = None,
        num_speakers: Optional[int] = None,
        hook: Optional[Callable] = None,
        trim_every: int = 10,
    ) -> Iterator[Annotation]:
        """Pipelined multi-file diarization: yields one Annotation per input
        waveform, in order, identical to per-file `__call__`.

        File i+1's device work is enqueued BEFORE file i's host stages run,
        so the device's in-order queue always holds work and the host's
        stitching and clustering hide behind it: the throughput mode for
        scoring a whole test set. On a CUDA device both models replay CUDA
        graphs a batch (`SlidingInference`, `EmbeddingInference`), so the
        enqueue takes far less host time than the card takes to run it and
        returns with file i+1's work still queued; file i's finish then runs
        while the card works through file i+1, whose one wait, in its own
        finish, takes what is left.

        `hook` is shared by the files in flight, so per-batch progress calls
        interleave; the per-stage artifacts still arrive in file order.

        `trim_every`: every N files, collect garbage and return freed heap
        pages to the system (glibc; 0 disables), which bounds the host
        memory of a long run."""
        uri_iter = iter(uris) if uris is not None else repeat(None)
        prev = None
        done = 0
        for waveform in waveforms:
            if prev is not None and "fetch" not in prev and "segmentations" not in prev:
                # collect file i's segmentation FIRST (its copy is queued
                # right behind its own kernels, not behind file i+1's), THEN
                # enqueue file i+1 so the device stays busy while the host
                # runs file i's stitching, embedding and clustering
                prev["segmentations"] = self._collect_segmentations(prev)
            cur = self._dispatch_file(waveform, sample_rate, next(uri_iter), hook)
            if prev is not None:
                yield self._finish_file(prev, num_speakers, hook)
                done += 1
                if trim_every and done % trim_every == 0:
                    with tracing.span("diarize.trim", prev["record"]):
                        _trim_host_memory()
            prev = cur
        if prev is not None:
            yield self._finish_file(prev, num_speakers, hook)

    def _dispatch_file(self, waveform, sample_rate, uri, hook) -> dict:
        """Enqueue a file's device work; returns its state for `_finish_file`."""
        if (sample_rate or self.seg_inference.sample_rate) != self.seg_inference.sample_rate:
            raise ValueError(f"resample to {self.seg_inference.sample_rate} Hz before inference")
        if waveform.ndim == 1:
            waveform = waveform[None]
        channels = getattr(self.seg_inference, "num_channels", None)
        if channels is None:
            waveform = waveform[0:1]  # channel 0
        record = tracing.FileRecord(self._trace_id, self._files_taken,
                                    waveform.shape[-1] / self.seg_inference.sample_rate)
        record.channels = channels
        self._files_taken += 1
        with tracing.span("diarize.dispatch", record):
            state = self._enqueue_file(waveform, uri, hook)
        state["record"] = record
        return state

    def _enqueue_file(self, waveform, uri, hook) -> dict:
        # one copy of the waveform to the device for both models
        prepared = self.seg_inference.prepare_wave(waveform)
        try:
            state = self._try_dispatch_fused(prepared, uri, hook)
            if state is not None:
                return state
            with tracing.span("diarize.segment"):
                seg_dev = self.seg_inference.dispatch(prepared[0], prepared[1], hook=hook)
            return {"uri": uri, "prepared": prepared, "seg_dev": seg_dev}
        except Exception as e:  # noqa: BLE001 - only a device OOM is retried
            if not is_oom_error(e):
                raise
            # out of device memory while enqueueing: this file takes the host
            # route, whose two stages halve their own batches until they fit
            self.seg_inference.halve_batch(e)
            with tracing.span("diarize.segment"):
                segmentations, channel_weights = _with_channel_weights(
                    self.seg_inference(waveform, hook=hook, prepared=prepared))
            return {"uri": uri, "prepared": prepared, "segmentations": segmentations,
                    "channel_weights": channel_weights}

    # ---- the device-side stitch route (infer/fused.py) ----------------

    def _use_fused(self) -> bool:
        # duck-typed stand-ins (tests, other backends) may lack the
        # dispatch interface the fused chain needs; in a process group the
        # host route shards the embeddings
        return self.fused_stitch and not in_group() and all(
            hasattr(inf, "dispatch") for inf in (self.seg_inference, self.emb_inference))

    def _get_fused(self) -> FusedStitch:
        if self._fused is None:
            self._fused = make_fused_stitch(
                self.eend_cfg,
                self.seg_inference.window_size,
                self.seg_inference.duration,
                self.seg_inference.step,
                self.emb_inference.num_speakers,
                self.emb_inference.min_num_samples,
                apply_median_filtering=self.apply_median_filtering,
                exclude_overlap=self.embedding_exclude_overlap,
            )
        return self._fused

    def _try_dispatch_fused(self, prepared, uri, hook) -> Optional[dict]:
        """Enqueue the file's WHOLE device chain (segmentation -> stitch ->
        embeddings -> copies to pinned host memory behind one event) with no
        host wait; returns the file's state, or None where the fused route
        does not apply (a layout that is not affine, an empty file). Timing
        events between the stages time them on the stream (`tracing`)."""
        if not self._use_fused():
            return None
        wave, starts = prepared
        fused = self._get_fused()
        plan = fused.plan(len(starts))
        if plan is None:
            return None
        stream = torch.cuda.current_stream(wave.device) if wave.is_cuda else None
        events = tracing.StageEvents.take(self._free_events, stream)
        events.mark(0)
        with tracing.span("diarize.segment"):
            seg_dev = self.seg_inference.dispatch(wave, starts, hook=hook, events=events)
        if seg_dev is None:
            return None
        seg_dev, channel_weights = _with_channel_weights(seg_dev)
        with tracing.span("diarize.stitch"):
            binarized, counts, weights = fused.stitch(seg_dev, plan)
        events.mark(1)
        with tracing.span("diarize.embed"):
            emb_dev = self.emb_inference.dispatch(wave, starts, weights, hook=hook,
                                                  channel_weights=channel_weights)
        events.mark(2)
        # the copies are queued right behind this file's own kernels: in
        # stream mode the next file's work is enqueued after them
        fetched = [binarized, counts, emb_dev]
        if channel_weights is not None:
            fetched.append(channel_weights)
        return {"uri": uri, "prepared": prepared, "events": events,
                "fetch": HostFetch(fetched, stream)}

    def _finish_fused(self, state, num_speakers, hook) -> Annotation:
        with tracing.span("diarize.wait"):
            fetched = state["fetch"].wait()  # THE one host wait per file
        binary, count_data, embeddings = fetched[:3]
        # already reached: no second wait
        state["events"].read(state["record"], self._free_events)
        segmentations = self.seg_inference.to_feature(binary.astype(np.float32))
        if hook is not None:
            hook("segmentation", segmentations)
            if len(fetched) > 3:
                hook("channel_weights", fetched[3])
        count = SlidingWindowFeature(count_data.reshape(-1, 1).copy(),
                                     self._get_fused().out_frames)
        if hook is not None:
            hook("speaker_counting", count)

        if count.data.size == 0 or np.nanmax(count.data) == 0:
            return self._no_speech(state["uri"])
        return self._cluster_and_reconstruct(
            segmentations, count, embeddings.astype(np.float64), state["uri"],
            num_speakers, hook)

    def _no_speech(self, uri) -> Annotation:
        # reset, else return_embeddings would hand back the PREVIOUS file's
        # centroids; (0, dim) is the reference's np.zeros((0, dimension))
        self._last_centroids = np.zeros((0, self._embedding_dim()))
        return Annotation(uri=uri)

    def _embedding_dim(self) -> int:
        """The embedder's dimensionality, for the no-speech centroid shape;
        duck-typed embedders without one give 0 columns."""
        dim = getattr(self.emb_inference, "embed_dim", None)
        return int(dim) if dim is not None else 0

    # ---- the host route -----------------------------------------------

    def _collect_segmentations(self, state) -> SlidingWindowFeature:
        """The host route's fetch of the segmentation (and of a
        multi-channel model's channel weights, kept in `state`)."""
        with tracing.span("diarize.wait", state["record"]):
            data, state["channel_weights"] = _with_channel_weights(
                self.seg_inference.collect(state["seg_dev"]))
        return self.seg_inference.to_feature(data)

    def _finish_file(self, state, num_speakers, hook) -> Annotation:
        """A file's host stages; keeps its record for `tracing.records()`."""
        record = state["record"]
        with tracing.span("diarize.finish", record):
            if "fetch" in state:
                annotation = self._finish_fused(state, num_speakers, hook)
            else:
                segmentations = state.get("segmentations")
                if segmentations is None:
                    segmentations = self._collect_segmentations(state)
                annotation = self._finish_from_segmentations(
                    state["prepared"], segmentations, state["uri"], num_speakers, hook,
                    state.get("channel_weights"))
        tracing.finished(record)
        return annotation

    def _finish_from_segmentations(self, prepared, segmentations, uri, num_speakers,
                                   hook, channel_weights=None) -> Annotation:
        with tracing.span("diarize.stitch"):
            if self.apply_median_filtering:
                segmentations.data = median_filter(
                    segmentations.data, size=(1, 11, 1), mode="reflect"
                )
            binarized = segmentations  # powerset output is already binary
            if hook is not None:
                hook("segmentation", binarized)
                if channel_weights is not None:
                    hook("channel_weights", channel_weights)

            count = speaker_count(binarized, receptive_field_window(self.eend_cfg),
                                  warm_up=(0.0, 0.0))
        if hook is not None:
            hook("speaker_counting", count)

        if count.data.size == 0 or np.nanmax(count.data) == 0:
            return self._no_speech(uri)  # no speech at all
        with tracing.span("diarize.embed"):
            embeddings = self.get_embeddings(binarized, prepared, hook=hook,
                                             channel_weights=channel_weights)
        return self._cluster_and_reconstruct(
            segmentations, count, embeddings, uri, num_speakers, hook)

    def _cluster_and_reconstruct(self, segmentations, count, embeddings, uri, num_speakers,
                                 hook) -> Annotation:
        """Clustering -> reconstruction -> binarization -> Annotation, shared
        by both routes. `segmentations` is the median-filtered binarized
        (chunks, frames, S) feature."""
        binarized = segmentations
        if hook is not None:
            hook("embeddings", embeddings)

        max_clusters = num_speakers or self.max_speakers
        with tracing.span("diarize.cluster"):
            hard_clusters, _, centroids = self.clustering(
                embeddings, binarized.data,
                min_clusters=num_speakers or self.min_speakers, max_clusters=max_clusters,
            )
        # every process clustered the same gathered embeddings; process 0's
        # assignment is kept so that ties cannot diverge (a copy without a group)
        hard_clusters = broadcast_from_host(hard_clusters)
        if hook is not None:
            hook("clustering", hard_clusters)
        with tracing.span("diarize.reconstruct"):
            count.data = np.minimum(count.data, max_clusters).astype(np.int8)
            inactive = np.sum(binarized.data, axis=1) == 0
            hard_clusters[inactive] = -2
            discrete = reconstruct(segmentations, hard_clusters, count)
            if hook is not None:
                hook("discrete_diarization", discrete)

            result = Binarize(onset=0.5, offset=0.5, min_duration_on=0.0,
                              min_duration_off=0.0)(discrete)
            result.uri = uri
            labels = result.labels()  # sorted cluster ids
            result = result.rename_labels(
                {label: f"SPEAKER_{i:02d}" for i, label in enumerate(labels)}
            )
            # centroids aligned to the renamed labels() order, zero rows for
            # speakers beyond the centroid count
            dim = centroids.shape[1] if centroids is not None and centroids.ndim == 2 else 0
            aligned = np.zeros((len(labels), dim))
            for i, label in enumerate(labels):
                if centroids is not None and 0 <= int(label) < centroids.shape[0]:
                    aligned[i] = centroids[int(label)]
            self._last_centroids = aligned
            return result

    def get_embeddings(self, binarized: SlidingWindowFeature,
                       prepared: Tuple[torch.Tensor, np.ndarray],
                       hook: Optional[Callable] = None,
                       channel_weights: Optional[np.ndarray] = None) -> np.ndarray:
        """(num_chunks, S, D) embeddings, each speaker's frames weighted by
        its activity with overlapped frames left out where enough clean
        frames remain; a multi-channel model's channels fused under its
        (num_chunks, C) `channel_weights`."""
        num_chunks, num_frames, _ = binarized.data.shape
        masks = np.nan_to_num(binarized.data, nan=0.0).astype(np.float32)
        if self.embedding_exclude_overlap:
            min_num_frames = math.ceil(
                num_frames * self.emb_inference.min_num_samples
                / self.seg_inference.window_size)
            clean = masks * (np.sum(masks, axis=2, keepdims=True) < 2)
            use_clean = np.sum(clean, axis=1) > min_num_frames  # (chunks, spks)
            weights = np.where(use_clean[:, None, :], clean, masks)
        else:
            weights = masks
        wave, starts = prepared
        weights = np.transpose(weights, (0, 2, 1))
        # each process embeds a strided shard of the windows and the shards
        # are gathered back on every process (the whole file without a
        # group): over the data axis of a mesh, over the world without one
        group = None if self.mesh is None else self.mesh.data_group
        shard = process_window_shard(num_chunks, group=group)
        if channel_weights is None:
            local = self.emb_inference(wave, starts[:num_chunks][shard], weights[shard],
                                       hook=hook)
        else:
            local = self.emb_inference(wave, starts[:num_chunks][shard], weights[shard],
                                       hook=hook, channel_weights=channel_weights[shard])
        return gather_window_shards(local, num_chunks, group)


def _with_channel_weights(segmentation) -> tuple:
    """(segmentation, a multi-channel model's channel weights or None) of
    what a `SlidingInference` gave."""
    return segmentation if isinstance(segmentation, tuple) else (segmentation, None)
