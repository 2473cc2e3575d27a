"""Device-side stitch for the diarization pipeline (port of
diarizen_tpu/infer/fused.py).

With hard segmentation (the pipeline's mode), every host stage between the
segmentation model and the embedding model is exact integer or binary math,
so it can run on the device and a file's whole chain

    segmentation -> median filter -> speaker count -> embedding weights ->
    embeddings

is enqueued without one host wait; the host fetches the filtered
segmentation, the frame counts and the embeddings once per file.

Each stage equals the host implementation bit for bit
(tests/test_torch_stream.py):

  * `median_filter(size=(1, 11, 1), mode="reflect")` on binary data is "at
    least 6 ones among 11" with half-sample symmetric padding;
  * `speaker_count` with `warm_up=(0, 0)` and no hamming window on binary
    input is an unweighted overlap-add of integer speaker sums divided by the
    integer coverage, then rounded half to even: float32 holds the sums
    exactly, and the one float32 division and rounding are IEEE on both sides;
  * the overlap-add runs as ceil(F / hop) shifted block adds, since a chunk's
    first frame is affine in the chunk index. That is checked on the host per
    file; a layout that is not affine gets no plan and takes the host path;
  * the embedding weights are `DiarizationPipeline.get_embeddings`'
    exclude-overlap rule on binary masks.

The JAX package pads the chunk count to compile buckets and ships one
bit-packed byte buffer; both serve XLA's compile-per-shape and the TPU's
transport and are not carried over: every tensor here holds exactly the
file's chunks.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from diarizen_tpu_torch.core.segments import SlidingWindow
from diarizen_tpu_torch.infer.sliding import receptive_field_window
from diarizen_tpu_torch.utils import device_constant

MEDIAN_SIZE = 11


def _median11_binary(x: torch.Tensor) -> torch.Tensor:
    """scipy.ndimage.median_filter(x, size=(1, 11, 1), mode="reflect") for
    binary uint8 x (N, F, S): the median of 11 zeros and ones is
    [sum >= 6]. torch's `pad` has no symmetric mode, so the padded frame
    axis is gathered through numpy's own symmetric index."""
    f, half = x.shape[1], MEDIAN_SIZE // 2
    index = device_constant(("fused.symmetric", f),
                            lambda: np.pad(np.arange(f), half, mode="symmetric"), x.device)
    xp = x[:, index]
    total = xp[:, 0:f].clone()  # sums reach 11 at most: uint8 holds them
    for k in range(1, MEDIAN_SIZE):
        total += xp[:, k: k + f]
    return (total > half).to(torch.uint8)


class FusedStitch:
    """The stitch of one pipeline configuration: `plan` on the host, `stitch`
    on the device."""

    def __init__(
        self,
        frames: SlidingWindow,
        chunk_window: SlidingWindow,
        frames_per_chunk: int,
        num_speakers: int,
        *,
        apply_median_filtering: bool = True,
        exclude_overlap: bool = True,
        min_num_frames: int = 0,
    ):
        self.frames = frames
        self.chunks = chunk_window
        self.f = frames_per_chunk
        self.s = num_speakers
        self.median = apply_median_filtering
        self.exclude_overlap = exclude_overlap
        self.min_num_frames = min_num_frames
        # aggregate()'s output frame grid starts at the chunk grid's origin
        self.out_frames = SlidingWindow(
            start=chunk_window.start, duration=frames.duration, step=frames.step
        )

    # ---- host-side planning -------------------------------------------

    def _frame_starts(self, n: int) -> np.ndarray:
        """Each chunk's first destination frame, as `ops/aggregate.py` places
        it: float64 arithmetic on the host."""
        c = np.arange(n, dtype=np.float64)
        t = self.chunks.start + c * self.chunks.step + 0.5 * self.frames.duration
        return np.rint(
            (t - self.out_frames.start - 0.5 * self.out_frames.duration)
            / self.out_frames.step
        ).astype(np.int64)

    def num_frames(self, n: int) -> int:
        """aggregate()'s output length for n chunks."""
        return (
            self.out_frames.closest_frame(
                self.chunks.start
                + self.chunks.duration
                + (n - 1) * self.chunks.step
                + 0.5 * self.frames.duration
            )
            + 1
        )

    def plan(self, num_chunks: int) -> Optional[dict]:
        """The layout of a file with `num_chunks` chunks, or None where the
        chunk -> frame mapping is not affine with a positive hop (the host
        path handles that file)."""
        if num_chunks < 1:
            return None
        starts = self._frame_starts(max(num_chunks, 2))
        base, hop = int(starts[0]), int(starts[1] - starts[0])
        if hop <= 0 or not np.array_equal(starts, base + hop * np.arange(len(starts))):
            return None
        return {"n": num_chunks, "base": base, "hop": hop,
                "num_frames": self.num_frames(num_chunks)}

    # ---- device program ------------------------------------------------

    @torch.inference_mode()
    def stitch(self, seg: torch.Tensor, plan: dict
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(n, F, S) uint8 hard segmentation on the device -> (filtered
        segmentation (n, F, S) uint8, frame-level speaker count
        (num_frames,) uint8, embedding weights (n, S, F) uint8), all on the
        device; nothing here waits for it."""
        n, f, hop, base = plan["n"], self.f, plan["hop"], plan["base"]
        if tuple(seg.shape) != (n, f, self.s) or seg.dtype != torch.uint8:
            raise ValueError(f"expected uint8 {(n, f, self.s)}, got {seg.dtype} {tuple(seg.shape)}")
        x = _median11_binary(seg) if self.median else seg

        # speaker count: unweighted overlap-add, then round half to even.
        # frame = base + (c + k) * hop + r for chunk c, block k, offset r
        k_blocks = (f + hop - 1) // hop
        spk = x.sum(dim=-1, dtype=torch.float32)  # (n, f)
        cov = torch.ones_like(spk)
        fpad = k_blocks * hop - f
        spk = torch.nn.functional.pad(spk, (0, fpad)).reshape(n, k_blocks, hop)
        cov = torch.nn.functional.pad(cov, (0, fpad)).reshape(n, k_blocks, hop)
        total = spk.new_zeros((n + k_blocks, hop))
        count = spk.new_zeros((n + k_blocks, hop))
        for k in range(k_blocks):
            total[k: k + n] += spk[:, k]
            count[k: k + n] += cov[:, k]
        avg = torch.round(total.reshape(-1) / count.reshape(-1).clamp_min(1e-12))  # aggregate()'s epsilon
        counts = torch.zeros(plan["num_frames"], dtype=torch.uint8, device=seg.device)
        take = min(avg.numel(), plan["num_frames"] - base)
        counts[base: base + take] = avg[:take].to(torch.uint8)

        # embedding weights: a speaker's clean (non-overlapped) frames where
        # enough of them remain, else all its frames
        if self.exclude_overlap:
            clean = x * (x.sum(dim=2, keepdim=True) < 2)
            use_clean = clean.sum(dim=1) > self.min_num_frames  # (n, S)
            weights = torch.where(use_clean[:, None, :], clean, x)
        else:
            weights = x
        return x, counts, weights.transpose(1, 2).contiguous()


def make_fused_stitch(
    eend_cfg,
    window_size: int,
    duration: float,
    step: float,
    num_speakers: int,
    min_num_samples: int,
    *,
    apply_median_filtering: bool = True,
    exclude_overlap: bool = True,
) -> FusedStitch:
    """A FusedStitch wired from pipeline-level objects, with the host-side
    constants of `DiarizationPipeline.get_embeddings` and `speaker_count`."""
    frames = receptive_field_window(eend_cfg)
    f = eend_cfg.num_frames(window_size)
    min_num_frames = math.ceil(f * min_num_samples / window_size)
    return FusedStitch(
        frames,
        SlidingWindow(start=0.0, duration=duration, step=step),
        f,
        num_speakers,
        apply_median_filtering=apply_median_filtering,
        exclude_overlap=exclude_overlap,
        min_num_frames=min_num_frames,
    )
