"""Sliding-window overlap-add aggregation and warm-up trimming.

Host-side numpy (tiny arrays, executed once per file). Semantics match the
reference engine exactly — hamming weighting, warm-up masking, NaN masking,
per-frame normalization, frame-count formula — because the DER parity gate
depends on them (pyannote-audio/pyannote/audio/core/inference.py:543-713).

Vectorized with np.add.at instead of the reference's per-chunk python loop.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from diarizen_tpu_torch.core.segments import SlidingWindow, SlidingWindowFeature


def aggregate(
    scores: SlidingWindowFeature,
    frames: SlidingWindow,
    warm_up: Tuple[float, float] = (0.0, 0.0),
    epsilon: float = 1e-12,
    hamming: bool = False,
    missing: float = np.nan,
    skip_average: bool = False,
) -> SlidingWindowFeature:
    """Overlap-add aggregation of per-chunk scores to a global frame sequence.

    scores.data : (num_chunks, num_frames_per_chunk, num_classes); NaN entries
    are masked out of the aggregation.
    """
    num_chunks, chunk_frames, num_classes = scores.data.shape
    chunks = scores.sliding_window
    out_frames = SlidingWindow(
        start=chunks.start, duration=frames.duration, step=frames.step
    )

    mask = (~np.isnan(scores.data)).astype(np.float32)
    data = np.nan_to_num(scores.data, nan=0.0).astype(np.float32)

    hamming_win = (
        np.hamming(chunk_frames).reshape(-1, 1).astype(np.float32)
        if hamming
        else np.ones((chunk_frames, 1), dtype=np.float32)
    )

    warm_up_win = np.ones((chunk_frames, 1), dtype=np.float32)
    left = round(warm_up[0] / chunks.duration * chunk_frames)
    right = round(warm_up[1] / chunks.duration * chunk_frames)
    warm_up_win[:left] = epsilon
    warm_up_win[chunk_frames - right :] = epsilon

    num_frames = (
        out_frames.closest_frame(
            chunks.start
            + chunks.duration
            + (num_chunks - 1) * chunks.step
            + 0.5 * frames.duration
        )
        + 1
    )

    total = np.zeros((num_frames, num_classes), dtype=np.float32)
    count = np.zeros((num_frames, num_classes), dtype=np.float32)
    any_valid = np.zeros((num_frames, num_classes), dtype=np.float32)

    # start frame per chunk (reference: closest_frame(chunk.start + 0.5*frame_dur))
    starts = np.array(
        [
            out_frames.closest_frame(chunks[c].start + 0.5 * frames.duration)
            for c in range(num_chunks)
        ],
        dtype=np.int64,
    )
    # per-chunk destination frame indices: (num_chunks, chunk_frames)
    idx = starts[:, None] + np.arange(chunk_frames)[None, :]
    w = hamming_win * warm_up_win  # (chunk_frames, 1)

    flat_idx = idx.reshape(-1)
    np.add.at(total, flat_idx, (data * mask * w).reshape(-1, num_classes))
    np.add.at(count, flat_idx, (mask * w).reshape(-1, num_classes))
    np.maximum.at(any_valid, flat_idx, mask.reshape(-1, num_classes))

    if skip_average:
        average = total
    else:
        average = total / np.maximum(count, epsilon)
    average[any_valid == 0.0] = missing
    return SlidingWindowFeature(average, out_frames)


def trim(
    scores: SlidingWindowFeature,
    warm_up: Tuple[float, float] = (0.1, 0.1),
) -> SlidingWindowFeature:
    """Trim left/right warm-up regions (ratios of chunk duration) from
    per-chunk scores (reference inference.py:668-713)."""
    assert scores.data.ndim == 3
    _, num_frames, _ = scores.data.shape
    chunks = scores.sliding_window

    n_left = round(num_frames * warm_up[0])
    n_right = round(num_frames * warm_up[1])
    new_data = scores.data[:, n_left : num_frames - n_right]
    new_chunks = SlidingWindow(
        start=chunks.start + warm_up[0] * chunks.duration,
        step=chunks.step,
        duration=(1 - warm_up[0] - warm_up[1]) * chunks.duration,
    )
    return SlidingWindowFeature(new_data, new_chunks)
