"""Speaker diarization pipeline (port of diarizen_tpu/infer/pipeline.py):
segment -> count -> embed -> cluster -> reconstruct -> Annotation.

1. sliding-window segmentation on channel 0 (hard powerset multilabel);
2. median filter (size (1, 11, 1), reflect);
3. frame-level speaker count (overlap-add, rint);
4. per-(chunk, speaker) masked embeddings, excluding overlapped frames where
   enough clean frames remain; the embedding model runs once per chunk with
   an (S, frames) weight matrix;
5. global clustering (AHC);
6. cap the count, mark inactive speakers, reconstruct, keep the top-count
   speakers per frame and binarize into an Annotation.

Stages 2, 3, 5 and 6 run on the host in numpy, as in the JAX package's host
stitch path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
from scipy.ndimage import median_filter

from diarizen_tpu_torch.core.segments import Annotation, SlidingWindow, SlidingWindowFeature
from diarizen_tpu_torch.infer.sliding import (
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
from diarizen_tpu_torch.utils import resolve_device


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


class EmbeddingInference:
    """Batched per-chunk masked speaker embeddings.

    The log-mel filterbank is computed ONCE over the whole file and each
    window gathers its frames from it (windows overlap 90%); this is exact
    because every fbank frame depends only on its own 400 samples and the
    window starts land on the 160-sample frame hop. Per-window mean
    normalisation follows the gather."""

    def __init__(
        self,
        model: ResNet,
        window_size: int,
        num_speakers: int,
        batch_size: int = 16,
        compute_dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.window_size = window_size
        self.num_speakers = num_speakers
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.embed_dim = model.cfg.embed_dim
        self._frames_per_window = num_fbank_frames(window_size)

    @property
    def min_num_samples(self) -> int:
        """Smallest crop giving at least one embedding frame."""
        return FRAME_LENGTH

    @torch.inference_mode()
    def __call__(self, wave: torch.Tensor, starts: np.ndarray, weights: np.ndarray) -> np.ndarray:
        """Device waveform + (N,) window starts + (N, S, F) weights ->
        (N, S, D) float64 embeddings."""
        n = len(starts)
        starts = np.asarray(starts)
        if (starts % FRAME_SHIFT).any():
            raise ValueError(f"window starts must be multiples of {FRAME_SHIFT} samples")
        feats = kaldi_fbank(wave[None] * 32768.0)[0]  # (frames, 80), before CMN
        frame_starts = starts // FRAME_SHIFT
        weights_dev = torch.as_tensor(weights, dtype=torch.float32, device=self.device)
        out = torch.zeros((n, self.num_speakers, self.embed_dim), device=self.device)
        for off, blen, pad in batch_row_spans(
                n, self.batch_size, lambda m: tail_size(m, self.batch_size)):
            windows = gather_rows(feats, frame_starts[off: off + blen],
                                  self._frames_per_window, pad)
            windows = windows - windows.mean(dim=1, keepdim=True)
            wb = weights_dev[off: off + blen]
            if pad:
                wb = torch.cat([wb, wb.new_zeros((pad,) + tuple(wb.shape[1:]))])
            emb = self.model(windows.to(self.compute_dtype), wb)
            out[off: off + blen] = emb[:blen]
        return out.cpu().numpy().astype(np.float64)


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

    def __call__(
        self,
        waveform: np.ndarray,
        sample_rate: int = 16000,
        uri: Optional[str] = None,
        num_speakers: Optional[int] = None,
        hook: Optional[Callable] = None,
    ) -> Annotation:
        """`hook(step_name, artifact)` is called after each stage:
        "segmentation", "speaker_counting", "embeddings", "clustering",
        "discrete_diarization"."""
        if waveform.ndim == 1:
            waveform = waveform[None]
        waveform = waveform[0:1]  # channel 0
        prepared = self.seg_inference.prepare_wave(waveform)
        segmentations = self.seg_inference(waveform, sample_rate, prepared=prepared)

        if self.apply_median_filtering:
            segmentations.data = median_filter(
                segmentations.data, size=(1, 11, 1), mode="reflect"
            )
        binarized = segmentations  # powerset output is already binary
        if hook is not None:
            hook("segmentation", binarized)

        count = speaker_count(binarized, receptive_field_window(self.eend_cfg),
                              warm_up=(0.0, 0.0))
        if hook is not None:
            hook("speaker_counting", count)

        ann = Annotation(uri=uri)
        if count.data.size == 0 or np.nanmax(count.data) == 0:
            return ann  # no speech at all

        embeddings = self.get_embeddings(binarized, prepared)
        if hook is not None:
            hook("embeddings", embeddings)

        max_clusters = num_speakers or self.max_speakers
        hard_clusters, _, _ = self.clustering(
            embeddings, binarized.data,
            min_clusters=num_speakers or self.min_speakers, max_clusters=max_clusters,
        )
        if hook is not None:
            hook("clustering", hard_clusters)

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
        return result.rename_labels(
            {label: f"SPEAKER_{i:02d}" for i, label in enumerate(labels)}
        )

    def get_embeddings(self, binarized: SlidingWindowFeature,
                       prepared: Tuple[torch.Tensor, np.ndarray]) -> np.ndarray:
        """(num_chunks, S, D) embeddings, each speaker's frames weighted by
        its activity with overlapped frames left out where enough clean
        frames remain."""
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
        return self.emb_inference(
            wave, starts[:num_chunks], np.transpose(weights, (0, 2, 1)))
