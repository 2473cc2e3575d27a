"""Multi-channel diarization (port of diarizen_tpu/infer/mc_pipeline.py).

The multi-channel segmentation model reads all channels of each window and
returns the powerset scores and its spatial attention; the speaker
embeddings are computed per channel with the same windows and fused with
channel weights from one fusion's attention (`attention_weighted_embeddings`);
counting, clustering and reconstruction are the single-channel pipeline's.

The (C, N) waveform goes to the device once, through pinned memory; each
batch's windows are gathered there, and each channel's embeddings read their
row of the same device copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
from scipy.ndimage import median_filter

from diarizen_tpu_torch.core.segments import Annotation, SlidingWindow, SlidingWindowFeature
from diarizen_tpu_torch.infer.pipeline import EmbeddingInference, reconstruct, speaker_count
from diarizen_tpu_torch.infer.sliding import (
    batch_row_spans,
    gather_rows,
    receptive_field_window,
    tail_size,
)
from diarizen_tpu_torch.models.eend import EendConfig
from diarizen_tpu_torch.models.mc import McEendModel, attention_weighted_embeddings
from diarizen_tpu_torch.ops.binarize import Binarize
from diarizen_tpu_torch.utils import resolve_device, to_device_async


class McSlidingInference:
    """Callable: ((C, num_samples) waveform, sample_rate) -> (hard multilabel
    SlidingWindowFeature (chunks, frames, K), float32 spatial attention
    (chunks, L, frames, C, C))."""

    def __init__(
        self,
        model: McEendModel,
        num_channels: int,
        duration: Optional[float] = None,
        step: Optional[float] = None,
        batch_size: int = 8,
        compute_dtype: torch.dtype = torch.bfloat16,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg = model.cfg
        self.num_channels = num_channels
        self.duration = duration if duration is not None else cfg.chunk_size
        self.step = step if step is not None else 0.1 * self.duration
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.powerset = cfg.powerset
        self.sample_rate = cfg.sample_rate
        self.window_size = round(self.duration * self.sample_rate)
        self.step_size = round(self.step * self.sample_rate)

    def prepare_wave(self, waveform: np.ndarray) -> Tuple[torch.Tensor, np.ndarray]:
        """Zero-pad (C, N) so every window is in bounds and copy it to the
        device once without waiting; returns (device wave (C, padded), window
        start samples on the host), the orphan last window included."""
        c, num_samples = waveform.shape
        if c != self.num_channels:
            raise ValueError(f"expected {self.num_channels} channels, got {c}")
        n_complete = (1 + (num_samples - self.window_size) // self.step_size
                      if num_samples >= self.window_size else 0)
        has_last = (num_samples < self.window_size
                    or (num_samples - self.window_size) % self.step_size > 0)
        starts = np.arange(n_complete + has_last, dtype=np.int64) * self.step_size
        wave = np.zeros((c, max(starts[-1] + self.window_size, num_samples)), np.float32)
        wave[:, :num_samples] = waveform
        return to_device_async(wave, self.device), starts

    @torch.inference_mode()
    def infer(self, wave: torch.Tensor, starts: np.ndarray,
              hook: Optional[Callable] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Every batch of windows through the model on the device, then one
        copy to the host: (float32 hard multilabel, float32 attention)."""
        total = len(starts)
        starts_dev = to_device_async(np.asarray(starts, np.int64), self.device)
        by_sample = wave.t()  # (padded, C): windows are rows of the leading axis
        frames, c = self.cfg.num_frames(self.window_size), wave.shape[0]
        seg = torch.zeros((total, frames, self.powerset.num_classes), dtype=torch.uint8,
                          device=self.device)
        att = torch.zeros((total, len(self.model.channel_fusions), frames, c, c),
                          device=self.device)
        for off, blen, pad in batch_row_spans(
                total, self.batch_size, lambda n: tail_size(n, self.batch_size)):
            chunks = gather_rows(by_sample, starts_dev[off: off + blen], self.window_size, pad)
            scores, spatial = self.model(chunks.transpose(1, 2), compute_dtype=self.compute_dtype)
            seg[off: off + blen] = self.powerset.to_multilabel(scores)[:blen]
            att[off: off + blen] = spatial[:blen]
            if hook is not None:
                hook("segmentation", None, total=total, completed=min(off + blen + pad, total))
        return seg.cpu().numpy().astype(np.float32), att.cpu().numpy()

    def __call__(self, waveform: np.ndarray, sample_rate: Optional[int] = None,
                 hook: Optional[Callable] = None,
                 prepared: Optional[Tuple[torch.Tensor, np.ndarray]] = None,
                 ) -> Tuple[SlidingWindowFeature, np.ndarray]:
        """`prepared`: a `prepare_wave(waveform)` result to share."""
        if (sample_rate or self.sample_rate) != self.sample_rate:
            raise ValueError(f"resample to {self.sample_rate} Hz before inference")
        wave, starts = prepared if prepared is not None else self.prepare_wave(waveform)
        seg, att = self.infer(wave, starts, hook)
        chunks = SlidingWindow(start=0.0, duration=self.duration, step=self.step)
        return SlidingWindowFeature(seg, chunks), att


@dataclass
class McDiarizationPipeline:
    """Multi-channel end to end: __call__((C, N) waveform, sample_rate, uri)
    -> Annotation."""

    seg_inference: McSlidingInference
    emb_inference: EmbeddingInference
    clustering: Callable
    eend_cfg: EendConfig
    min_speakers: int = 1
    max_speakers: int = 8
    apply_median_filtering: bool = True
    fusion_layer: int = 3  # the reference reads fusion 3 of 4; clamped to the model's

    def __call__(self, waveform: np.ndarray, sample_rate: int = 16000,
                 uri: Optional[str] = None, num_speakers: Optional[int] = None,
                 hook: Optional[Callable] = None) -> Annotation:
        """`hook(step_name, artifact, total=, completed=)` as in
        `DiarizationPipeline`."""
        prepared = self.seg_inference.prepare_wave(waveform)
        segmentations, att = self.seg_inference(waveform, sample_rate, hook, prepared)
        if self.apply_median_filtering:
            segmentations.data = median_filter(segmentations.data, size=(1, 11, 1),
                                               mode="reflect")
        binarized = segmentations  # powerset output is already binary
        if hook is not None:
            hook("segmentation", binarized)

        count = speaker_count(binarized, receptive_field_window(self.eend_cfg),
                              warm_up=(0.0, 0.0))
        if hook is not None:
            hook("speaker_counting", count)
        ann = Annotation(uri=uri)
        if count.data.size == 0 or np.nanmax(count.data) == 0:
            return ann

        embeddings = self.get_embeddings(prepared, binarized, att)
        if hook is not None:
            hook("embeddings", embeddings)

        max_clusters = num_speakers or self.max_speakers
        hard_clusters, _, _ = self.clustering(
            embeddings, binarized.data,
            min_clusters=num_speakers or self.min_speakers, max_clusters=max_clusters)
        if hook is not None:
            hook("clustering", hard_clusters)
        count.data = np.minimum(count.data, max_clusters).astype(np.int8)
        inactive = np.sum(binarized.data, axis=1) == 0
        hard_clusters[inactive] = -2
        discrete = reconstruct(segmentations, hard_clusters, count)
        if hook is not None:
            hook("discrete_diarization", discrete)
        result = Binarize(onset=0.5, offset=0.5)(discrete)
        result.uri = uri
        return result.rename_labels(
            {label: f"SPEAKER_{i:02d}" for i, label in enumerate(result.labels())})

    def get_embeddings(self, prepared: Tuple[torch.Tensor, np.ndarray],
                       binarized: SlidingWindowFeature, att: np.ndarray) -> np.ndarray:
        """(chunks, S, D) embeddings: each channel's row of the device wave
        through the embedding model at the segmentation's window starts,
        every speaker's frames weighted by its activity, then the channels
        fused by the spatial attention of fusion min(fusion_layer, L - 1)."""
        wave, starts = prepared
        num_chunks = binarized.data.shape[0]
        masks = np.nan_to_num(binarized.data, nan=0.0).astype(np.float32)
        weights = np.transpose(masks, (0, 2, 1))  # (chunks, S, frames)
        per_channel = np.stack([self.emb_inference(wave[c], starts[:num_chunks], weights)
                                for c in range(wave.shape[0])], axis=1)  # (chunks, C, S, D)
        fusion_layer = min(self.fusion_layer, att.shape[1] - 1)
        return attention_weighted_embeddings(per_channel, att, fusion_layer)
