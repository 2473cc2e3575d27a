"""Sliding-window segmentation inference (port of diarizen_tpu/infer/sliding.py).

The waveform is cut into windows of `duration` seconds every `step` seconds
(an orphan last window when the remainder is non-zero), the windows run
through the EEND model in batches, and the powerset scores become multilabel
activity: a (num_chunks, num_frames, K) SlidingWindowFeature on the chunk
window, hard (uint8 on the device, the diarization path, stitched later by
`ops/aggregate.py` on the host or by `infer/fused.py` on the device) or soft
(float32 probabilities, `soft=True`). `whole` runs one forward over a whole
file; `aggregated` overlap-adds the soft windows into one frame sequence for
the frame-level pipelines (VAD, OSD, multi-label).

With `mesh=` (`parallel/mesh.py`) the windows of a file are sharded over the
mesh's data axis, parameters replicated, as the JAX package's
`SlidingInference(mesh=)` shards each window batch: data rank p runs windows
p, p + n_data, ..., the model ranks of one data index the same ones, and
the shards are gathered back in window order on every rank.

On a CUDA device, outside a mesh and a process group, a batch's forward and
its multilabel mapping replay captured CUDA graphs (`BatchGraph`), so that
the host enqueues a batch in a handful of launches instead of the forward's
hundreds: one graph for a model's whole forward, or one a stage for a model
that runs in stages (WavLM + Conformer's `inference_stages`: extractor,
encoder, back end, each a call of the model's forward), with the file's
timing events recorded between them, outside the graphs. A batch has 8, 16,
24 or 32 rows at the default `batch_size` (`batch_row_spans`, `tail_size`),
so an instance holds a few `BatchGraph`s, one per row count, `soft`,
compute type and the process state the forward reads
(`ops.forward_switches`), sharing one memory pool. A
key's first batch runs eagerly and is then captured; the graphs are
dropped when the model's parameters or buffers move or change in place,
and when an out-of-memory error halves `batch_size` (`halve_batch`). The
gather of a batch's windows into the graph's input and the copy of its
output stay outside the graph: the waveform is another tensor for every
file. A file's record (`tracing.py`) counts its batches of each kind.
`GraphedBatches` holds that discipline for this class and for the
speaker embeddings' `EmbeddingInference` (`infer/pipeline.py`), whose graph
takes two static inputs, the windows and their weights.

A multi-channel model (`models/mc.py`: `num_channels`) takes the same path
on (C, num_samples) recordings: a recording's channels are wrapped around
or cut to the model's (`fit_channels`), every window is gathered for all of
them on the device, its four stages replay a graph each (extractor on B·C
streams, the fused encoder through the channel mean, the single-stream
rest, back end), and each window also gives one float32 weight a channel,
reduced on the device inside the last graph, which `dispatch` returns beside
the multilabel activity.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from diarizen_tpu_torch import tracing
from diarizen_tpu_torch.core.segments import SlidingWindow, SlidingWindowFeature
from diarizen_tpu_torch.models.sincnet_eend import (
    SINCNET_KERNELS,
    SINCNET_STRIDES,
    SincNetEendConfig,
)
from diarizen_tpu_torch.ops import cuda_build, forward_switches
from diarizen_tpu_torch.ops.aggregate import aggregate
from diarizen_tpu_torch.ops.receptive_field import multi_conv_receptive_field_center
from diarizen_tpu_torch.parallel.distributed import (
    gather_window_shards,
    in_group,
    process_window_shard,
)
from diarizen_tpu_torch.utils import (
    halve_batch_or_raise,
    resolve_device,
    state_stamp,
    to_device_async,
)


def batch_row_spans(total: int, batch_size: int,
                    tail_size: Callable[[int], int]) -> Iterator[Tuple[int, int, int]]:
    """(offset, length, pad) spans covering [0, total) in `batch_size` rows:
    full batches, then a tail of `tail_size(n_real)` rows drawn from the LAST
    real rows (offset shifted back; the rows run twice give identical
    values). A file smaller than one tail zero-pads instead (pad > 0)."""
    for b0 in range(0, total, batch_size):
        n_real = min(batch_size, total - b0)
        if n_real == batch_size:
            yield b0, batch_size, 0
        else:
            padded = tail_size(n_real)
            if padded <= total:
                yield total - padded, padded, 0
            else:
                yield 0, n_real, padded - n_real


def tail_size(n_real: int, batch_size: int) -> int:
    """Rows of a partial last batch: n_real rounded up to a multiple of 8,
    capped at batch_size."""
    return min(batch_size, ((n_real + 7) // 8) * 8)


def fit_channels(waveform: np.ndarray, channels: int) -> np.ndarray:
    """(C', num_samples) -> (channels, num_samples): channels wrapped around
    where the recording has fewer, the first `channels` where it has more
    (the multi-channel dataset's rule)."""
    waveform = np.atleast_2d(waveform)
    if waveform.shape[0] < channels:
        waveform = np.pad(waveform, ((0, channels - waveform.shape[0]), (0, 0)), mode="wrap")
    return waveform[:channels]


def gather_rows(source: torch.Tensor, starts: torch.Tensor, length: int, pad: int) -> torch.Tensor:
    """(len(starts) + pad, length, ...) windows source[s : s + length] of the
    leading axis, pad rows of zeros at the end. `starts` lies on source's
    device, so nothing here waits for the device."""
    idx = starts[:, None] + torch.arange(length, device=source.device)
    rows = source[idx]
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad,) + tuple(rows.shape[1:]))])
    return rows


class BatchGraph:
    """The forward at one batch shape captured as CUDA graphs, one a stage
    of the forward, each reading the last one's static output: `inputs` are
    the first stage's static inputs (its arguments, in order), `outs` the
    stages' static outputs. A capture runs nothing, so the kernel launches
    it counts (`cuda_build.launches`) are taken back out of the registry
    and added on every replay instead. Capture a shape only after the
    forward has run eagerly at it: that run builds the kernels, uploads the
    constants and sets up the libraries' handles."""

    __slots__ = ("graphs", "inputs", "outs", "launches")

    def __init__(self, stages: list, inputs: tuple, pool: tuple):
        self.inputs = tuple(t.clone() for t in inputs)
        self.graphs, self.outs = [], []
        before = dict(cuda_build.launches)
        try:
            for s, stage in enumerate(stages):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool):
                    x = stage(*self.inputs) if s == 0 else stage(self.outs[-1])
                self.graphs.append(graph)
                self.outs.append(x)  # the next stage's static input
        finally:
            self.launches = {name: n - before[name] for name, n in cuda_build.launches.items()
                             if n != before[name]}
            cuda_build.launches.update(before)

    def __call__(self, inputs: tuple, events=tracing.NO_EVENTS) -> torch.Tensor:
        """The forward of `inputs` (this graph's shapes): the last stage's
        static output, valid until the next replay. `events.mark_batch(s)`
        before stage s."""
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        for s, graph in enumerate(self.graphs):
            events.mark_batch(s)
            graph.replay()
        for name, n in self.launches.items():
            cuda_build.launches[name] += n
        return self.outs[-1]


class GraphedBatches:
    """The CUDA graphs of an inference object's batches (`BatchGraph`), by
    key, for `SlidingInference` and `EmbeddingInference`: a batch replays
    the graph of its key where there is one; else it runs eagerly and is
    then captured. The object's graphs share one memory pool of their own
    and are dropped when a parameter or buffer of its `model` moves or
    changes in place, and when an out-of-memory error halves its
    `batch_size` (`halve_batch`). A key holds the call's own parts, the
    process state the forward reads (`ops.forward_switches`) and the row
    count."""

    _what = "inference"  # the stage named in `halve_batch`'s error
    mesh = None  # a mesh's model axis puts collectives inside the forward

    def _init_graphs(self) -> None:
        # the captured graphs by key, their memory pool, and the parameters'
        # and buffers' addresses and versions they read
        self._graphs: Dict[tuple, BatchGraph] = {}
        self._graph_pool = None
        self._graph_stamp: Optional[list] = None

    def _graphs_apply(self, x: torch.Tensor) -> bool:
        """Whether this call's batches (on `x`'s device) may replay graphs:
        on a CUDA device outside a process group. Drops the graphs when the
        model's parameters or buffers have changed since their capture."""
        if not x.is_cuda or in_group():
            return False
        stamp = state_stamp(self.model)
        if stamp != self._graph_stamp:
            self.drop_graphs()
            self._graph_stamp = stamp
        return True

    def _graph_key(self, x: torch.Tensor, *call_parts) -> Optional[tuple]:
        """The key of this call's batch graphs, less the row count: the
        caller's `call_parts` and `ops.forward_switches()`. None where the
        batches run eagerly: off CUDA, in a process group
        (`_graphs_apply`) and on a mesh."""
        if self.mesh is not None or not self._graphs_apply(x):
            return None
        return call_parts + forward_switches()

    def _run_batch(self, key: Optional[tuple], stages: list, inputs: tuple,
                   events=tracing.NO_EVENTS) -> Tuple[torch.Tensor, bool]:
        """(the batch's output, whether a graph gave it): the stages applied
        in turn to `inputs`, the first taking them as its arguments, by the
        graph of `key`, or eagerly and then captured under `key` (None: no
        graph). `events.mark_batch(s)` before stage s."""
        graph = None if key is None else self._graphs.get(key)
        if graph is not None:
            return graph(inputs, events), True
        x = inputs
        for s, stage in enumerate(stages):
            events.mark_batch(s)
            x = stage(*x) if s == 0 else stage(x)
        if key is not None:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            self._graphs[key] = BatchGraph(stages, inputs, self._graph_pool)
        return x, False

    def drop_graphs(self) -> None:
        """Forget the captured batch graphs; their memory pool goes with
        the last of them."""
        self._graphs.clear()
        self._graph_pool = None

    def halve_batch(self, exc: BaseException) -> None:
        """After a device out-of-memory error: halve `batch_size` and drop
        the graphs, whose shapes it changes (anything else is re-raised,
        `utils.halve_batch_or_raise`)."""
        self.batch_size = halve_batch_or_raise(exc, self.batch_size, self._what)
        self.drop_graphs()


class SlidingInference(GraphedBatches):
    """Callable: (waveform (C, num_samples), sample_rate) ->
    SlidingWindowFeature (num_chunks, num_frames, K), for a segmentation
    model of any family (its forward takes `compute_dtype=`; the model
    carries its config as `cfg`). A single-channel model reads channel 0.
    A multi-channel model (one with `num_channels`, or `num_channels=`
    given) reads that many channels (`fit_channels`), and every result
    comes with its windows' channel weights: (feature, (num_chunks, C)
    float32)."""

    _what = "segmentation inference"

    def __init__(
        self,
        model: nn.Module,
        duration: Optional[float] = None,
        step: Optional[float] = None,
        batch_size: int = 32,
        compute_dtype: torch.dtype = torch.bfloat16,
        device: Optional[Union[str, torch.device]] = None,
        mesh=None,
        num_channels: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.mesh = mesh
        # the channels a recording is served on; None: channel 0 alone
        self.num_channels = num_channels or getattr(model, "num_channels", None)
        if self.num_channels is not None and mesh is not None:
            raise NotImplementedError("a multi-channel model is served without a mesh")
        self.cfg = cfg = model.cfg
        self.duration = duration if duration is not None else cfg.chunk_size
        self.step = step if step is not None else 0.1 * self.duration
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.powerset = cfg.powerset
        self.sample_rate = cfg.sample_rate
        self.window_size = round(self.duration * self.sample_rate)
        self.step_size = round(self.step * self.sample_rate)
        self._frames_per_chunk = cfg.num_frames(self.window_size)
        self._init_graphs()  # keyed by `_graph_key` and the row count

    def num_chunks(self, num_samples: int) -> Tuple[int, bool]:
        if num_samples >= self.window_size:
            n_complete = 1 + (num_samples - self.window_size) // self.step_size
        else:
            n_complete = 0
        has_last = (num_samples < self.window_size) or (
            (num_samples - self.window_size) % self.step_size > 0
        )
        return n_complete, has_last

    def prepare_wave(self, waveform: np.ndarray) -> Tuple[torch.Tensor, np.ndarray]:
        """Zero-pad channel 0 (a multi-channel model: its `num_channels`
        channels, `fit_channels`) so every window is in bounds and copy it
        to the device once, through pinned memory, without waiting for the
        device; returns (wave on device, (padded,) or (C, padded), window
        start samples on the host). The device copy is shared with the
        embedding stage."""
        if self.num_channels is not None:
            waveform = fit_channels(waveform, self.num_channels)
        elif waveform.ndim == 2:
            waveform = waveform[0]
        n_complete, has_last = self.num_chunks(waveform.shape[-1])
        starts = np.arange(n_complete + has_last, dtype=np.int64) * self.step_size
        wave = np.zeros(waveform.shape[:-1] + (max(starts[-1] + self.window_size,
                                                   waveform.shape[-1]),), np.float32)
        wave[..., : waveform.shape[-1]] = waveform
        return to_device_async(wave, self.device), starts

    @torch.inference_mode()
    def dispatch(self, wave: torch.Tensor, starts: np.ndarray,
                 hook: Optional[Callable] = None, soft: bool = False,
                 events=tracing.NO_EVENTS):
        """Enqueue every batch; returns the multilabel activity
        (num_chunks, num_frames, K) ON THE DEVICE, without waiting for it
        (None for no chunks): hard as uint8, or with `soft` the float32
        probabilities exp(scores) @ mapping; a multi-channel model's with
        its (num_chunks, C) float32 channel weights, as a pair. Fetch it
        with `collect`;
        splitting the two lets a caller overlap this file's device work with
        another file's host stages (`DiarizationPipeline.stream`). On a
        mesh this rank's data-axis shard of the windows runs, and the
        gather waits for the device.

        On a CUDA device outside a mesh and a process group each batch
        replays the CUDA graph of its row count (module docstring): the
        first batch of a shape runs eagerly and is then captured, and the
        graphs are captured again after the parameters move or change and
        after `halve_batch`. The file's record, where this runs inside one
        of its spans, counts the batches that replayed a graph and those
        that ran eagerly. A model that runs in stages (`inference_stages`)
        marks each batch's stage boundaries on `events`
        (`tracing.StageEvents`, the pipeline's for this file)."""
        if self.mesh is None or self.mesh.device_mesh is None or len(starts) == 0:
            return self._dispatch(wave, starts, hook, soft, events)
        group = self.mesh.data_group
        shard = process_window_shard(len(starts), group=group)
        local = self._dispatch(wave, np.asarray(starts)[shard], hook, soft)
        local = (np.zeros((0, self._frames_per_chunk, self.powerset.num_classes),
                          np.float32 if soft else np.uint8)
                 if local is None else local.cpu().numpy())
        return torch.from_numpy(gather_window_shards(local, len(starts), group)).to(self.device)

    def _dispatch(self, wave: torch.Tensor, starts: np.ndarray, hook: Optional[Callable],
                  soft: bool, events=tracing.NO_EVENTS):
        total = len(starts)
        if total == 0:
            return None
        starts_dev = to_device_async(np.asarray(starts, np.int64), self.device)
        out = torch.zeros((total, self._frames_per_chunk, self.powerset.num_classes),
                          dtype=torch.float32 if soft else torch.uint8, device=self.device)
        channel_weights = None
        source = wave
        if self.num_channels is not None:  # windows are rows of the time axis, every channel
            channel_weights = torch.zeros((total, wave.shape[0]), device=self.device)
            source = wave.t()
        key = self._graph_key(wave, soft, self.compute_dtype)
        stages = self._stages(soft)
        if len(stages) == 1:  # no boundary inside the forward to time
            events = tracing.NO_EVENTS
        replayed = eager = 0
        for off, blen, pad in batch_row_spans(
                total, self.batch_size, lambda n: tail_size(n, self.batch_size)):
            chunks = gather_rows(source, starts_dev[off: off + blen], self.window_size, pad)
            if channel_weights is not None:
                chunks = chunks.transpose(1, 2)  # (rows, C, window)
            events.batch()
            multilabel, from_graph = self._run_batch(
                None if key is None else key + (len(chunks),), stages, (chunks,), events)
            replayed += from_graph
            eager += not from_graph
            if channel_weights is not None:
                multilabel, weights = multilabel
                channel_weights[off: off + blen] = weights[:blen]
            out[off: off + blen] = multilabel[:blen]
            if hook is not None:
                hook("segmentation", None, total=total, completed=min(off + blen + pad, total))
        record = tracing.current()
        if record is not None:
            record.seg_graph_batches += replayed
            record.seg_eager_batches += eager
        return out if channel_weights is None else (out, channel_weights)

    def _forward(self, chunks: torch.Tensor, soft: bool):
        """The batch forward in one piece, what its stages give in turn; a
        multi-channel model's stages in turn, eagerly (its one-piece forward
        gives every fusion's attention, not the channel weights)."""
        if self.num_channels is not None:
            x = (chunks,)
            for s, stage in enumerate(self._stages(soft)):
                x = stage(*x) if s == 0 else stage(x)
            return x
        scores = self.model(chunks, compute_dtype=self.compute_dtype)
        return self.powerset.to_multilabel(scores, soft=soft)

    def _stages(self, soft: bool) -> list:
        """The batch forward, scores to multilabel, as functions applied in
        turn: the model's `inference_stages` where it has them (WavLM +
        Conformer: extractor, encoder, back end), else its whole forward."""
        def stage(name):
            kwargs = {"compute_dtype": self.compute_dtype}
            if name is not None:
                kwargs["stage"] = name
            return functools.partial(self.model, **kwargs)

        stages = [stage(n) for n in getattr(self.model, "inference_stages", None) or (None,)]
        back_end = stages[-1]

        def to_multilabel(x):
            scores = back_end(x)
            if self.num_channels is not None:  # (scores, channel weights)
                return self.powerset.to_multilabel(scores[0], soft=soft), scores[1]
            return self.powerset.to_multilabel(scores, soft=soft)
        return stages[:-1] + [to_multilabel]

    @staticmethod
    def collect(dispatched):
        """The one device-to-host copy of a dispatched result, as float32
        (a multi-channel model's pair: both)."""
        if dispatched is None:
            return None
        if isinstance(dispatched, tuple):
            return tuple(t.cpu().numpy().astype(np.float32) for t in dispatched)
        return dispatched.cpu().numpy().astype(np.float32)

    def infer(self, wave: torch.Tensor, starts: np.ndarray,
              hook: Optional[Callable] = None, soft: bool = False):
        """Multilabel activity (num_chunks, num_frames, K) as float32, hard
        or soft (a multi-channel model's with its channel weights, a pair).
        A device out-of-memory error halves `batch_size` and runs the file
        again; anything else is raised unchanged."""
        while True:
            try:
                data = self.collect(self.dispatch(wave, starts, hook, soft))
                break
            except Exception as e:  # noqa: BLE001 - the helper re-raises all but OOM
                self.halve_batch(e)
        if data is None:
            data = np.zeros((0, self._frames_per_chunk, self.powerset.num_classes), np.float32)
            if self.num_channels is not None:
                data = data, np.zeros((0, self.num_channels), np.float32)
        return data

    def to_feature(self, data: np.ndarray) -> SlidingWindowFeature:
        return SlidingWindowFeature(
            data, SlidingWindow(start=0.0, duration=self.duration, step=self.step))

    def _check_rate(self, sample_rate: Optional[int]) -> None:
        if (sample_rate or self.sample_rate) != self.sample_rate:
            raise ValueError(f"resample to {self.sample_rate} Hz before inference")

    def __call__(
        self,
        waveform: np.ndarray,
        sample_rate: Optional[int] = None,
        soft: bool = False,
        hook: Optional[Callable] = None,
        prepared: Optional[Tuple[torch.Tensor, np.ndarray]] = None,
    ):
        """`hook(step_name, artifact, total=, completed=)` is called after
        each batch. `prepared` is an optional `prepare_wave(waveform)`
        result, so a caller can share one device copy of the waveform across
        stages. A multi-channel model gives (feature, channel weights)."""
        self._check_rate(sample_rate)
        wave, starts = prepared if prepared is not None else self.prepare_wave(waveform)
        data = self.infer(wave, starts, hook, soft)
        if self.num_channels is not None:
            return self.to_feature(data[0]), data[1]
        return self.to_feature(data)

    @torch.inference_mode()
    def whole(self, waveform: np.ndarray, sample_rate: Optional[int] = None,
              soft: bool = False) -> np.ndarray:
        """One forward over the whole file, no windows: (num_frames, K)
        multilabel, uint8 or (soft) float32. Memory grows with the file's
        length, and WavLM's relative-position buckets saturate at 800
        frames, so it is meant for short files. Single-channel models only."""
        self._check_rate(sample_rate)
        if self.num_channels is not None:
            raise NotImplementedError("whole-file inference of a multi-channel model")
        if waveform.ndim == 2:
            waveform = waveform[self.cfg.selected_channel]
        wave = to_device_async(np.asarray(waveform, np.float32)[None], self.device)
        scores = self.model(wave, compute_dtype=self.compute_dtype)
        return self.powerset.to_multilabel(scores, soft=soft)[0].cpu().numpy()

    def aggregated(self, waveform: np.ndarray, sample_rate: Optional[int] = None,
                   soft: bool = True,
                   warm_up: Tuple[float, float] = (0.0, 0.0)) -> SlidingWindowFeature:
        """Hamming-weighted overlap-add of the windows' scores into one
        (num_frames, K) sequence on the model's frame grid, trimmed to the
        file's frames: what the frame-level pipelines read."""
        scores = self(waveform, sample_rate, soft=soft)
        if waveform.ndim == 2:
            waveform = waveform[0]
        frames = receptive_field_window(self.cfg)
        agg = aggregate(scores, frames, warm_up=warm_up, hamming=True, missing=0.0)
        # drop the frames of the zero padding behind the orphan last window
        agg.data = agg.data[: frames.closest_frame(waveform.shape[0] / self.sample_rate)]
        return agg


def receptive_field_window(cfg) -> SlidingWindow:
    """Output frame resolution of a segmentation model as a SlidingWindow
    (start at the receptive field of frame 0), for every family: the centre
    of WavLM's or SincNet's conv stack, or 0 for the centred fbank frames."""
    step, duration = cfg.rf_info()
    if hasattr(cfg, "wavlm"):
        kernels = [k for _, k, _ in cfg.wavlm.conv_layers]
        strides = [s for _, _, s in cfg.wavlm.conv_layers]
        center0 = multi_conv_receptive_field_center(0, kernels, strides)
    elif isinstance(cfg, SincNetEendConfig):
        center0 = multi_conv_receptive_field_center(0, SINCNET_KERNELS, SINCNET_STRIDES)
    else:  # fbank: frame 0 is centred at t = 0
        center0 = 0
    # the reference offsets by half of (size - 1) samples, not size / 2
    size = duration * cfg.sample_rate
    start = (center0 - (size - 1) / 2) / cfg.sample_rate
    return SlidingWindow(start=start, duration=duration, step=step)
