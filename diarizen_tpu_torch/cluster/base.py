"""Shared clustering machinery: embedding filtering, centroid assignment,
constrained per-chunk assignment.

Host-side numpy (runs once per file on ~1e3 embeddings); the only O(N^2 D)
piece — the embedding/centroid cosine affinity — is a single matmul that can
be fed from device-resident embeddings. Reference semantics:
pyannote-audio/pyannote/audio/pipelines/clustering.py:47-245.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def filter_embeddings_by_frames(
    binary_segmentations: np.ndarray, min_frames: int = 0
) -> np.ndarray:
    """(chunks, frames, spks) binary activity -> (chunks, spks) bool: speaker
    has >= min_frames frames where it is the only active speaker
    (clustering.py:47-73, fork-added clean-frames filter)."""
    single_active = np.sum(binary_segmentations, axis=2, keepdims=True) == 1
    clean_counts = np.sum(binary_segmentations * single_active, axis=1)
    return clean_counts >= min_frames


def filter_embeddings(
    embeddings: np.ndarray,
    binary_segmentations: np.ndarray,
    min_frames_ratio: float = 0.1,
    max_num_embeddings: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Select embeddings usable for clustering: active, non-NaN, and with
    enough clean (single-speaker) frames — with fallback to min_frames=0 when
    fewer than 2 survive (clustering.py:111-157).

    Returns (filtered (N, D), chunk_idx (N,), speaker_idx (N,)).
    """
    active = np.sum(binary_segmentations, axis=1) > 0  # (chunks, spks)
    valid = ~np.any(np.isnan(embeddings), axis=2)
    min_frames = round(min_frames_ratio * binary_segmentations.shape[1])
    frame_mask = filter_embeddings_by_frames(binary_segmentations, min_frames)
    chunk_idx, speaker_idx = np.where(active & valid & frame_mask)

    if len(chunk_idx) < 2:
        frame_mask = filter_embeddings_by_frames(binary_segmentations, 0)
        chunk_idx, speaker_idx = np.where(active & valid & frame_mask)

    if max_num_embeddings is not None and len(chunk_idx) > max_num_embeddings:
        rng = rng or np.random.default_rng()
        keep = np.sort(
            rng.choice(len(chunk_idx), size=max_num_embeddings, replace=False)
        )
        chunk_idx, speaker_idx = chunk_idx[keep], speaker_idx[keep]

    return embeddings[chunk_idx, speaker_idx], chunk_idx, speaker_idx


def set_num_clusters(
    num_embeddings: int,
    num_clusters: Optional[int] = None,
    min_clusters: Optional[int] = None,
    max_clusters: Optional[int] = None,
) -> Tuple[Optional[int], int, int]:
    min_clusters = num_clusters or min_clusters or 1
    min_clusters = max(1, min(num_embeddings, min_clusters))
    max_clusters = num_clusters or max_clusters or num_embeddings
    max_clusters = max(1, min(num_embeddings, max_clusters))
    if min_clusters > max_clusters:
        raise ValueError(f"min_clusters {min_clusters} > max_clusters {max_clusters}")
    if min_clusters == max_clusters:
        num_clusters = min_clusters
    return num_clusters, min_clusters, max_clusters


def cosine_cdist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Cosine distance matrix — the affinity hot spot, one (N, D) x (D, K)
    matmul (scipy.cdist parity incl. zero-vector -> distance handling)."""
    an = np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    bn = np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    with np.errstate(divide="ignore", invalid="ignore"):
        sim = (a @ b.T) / (an * bn.T)
    return 1.0 - sim


def constrained_argmax(
    soft_clusters: np.ndarray, const_location: Optional[np.ndarray] = None
) -> np.ndarray:
    """Per-chunk Hungarian: at most one local speaker per cluster
    (clustering.py:159-177). soft_clusters: (chunks, spks, clusters)."""
    soft = np.nan_to_num(soft_clusters, nan=np.nanmin(soft_clusters))
    if const_location is not None:
        soft[const_location] = -10000
    num_chunks, num_speakers, _ = soft.shape
    hard = -2 * np.ones((num_chunks, num_speakers), dtype=np.int8)
    for c, cost in enumerate(soft):
        speakers, clusters = linear_sum_assignment(cost, maximize=True)
        hard[c, speakers] = clusters
    return hard


def assign_embeddings(
    embeddings: np.ndarray,
    train_chunk_idx: np.ndarray,
    train_speaker_idx: np.ndarray,
    train_clusters: np.ndarray,
    constrained: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Centroids = mean of train members; soft = 2 - cosine distance; hard =
    (constrained) argmax (clustering.py:179-245). Every embedding — including
    train ones — is (re)assigned to its closest centroid."""
    num_clusters = int(np.max(train_clusters)) + 1
    num_chunks, num_speakers, dim = embeddings.shape
    train_embeddings = embeddings[train_chunk_idx, train_speaker_idx]
    centroids = np.vstack(
        [np.mean(train_embeddings[train_clusters == k], axis=0) for k in range(num_clusters)]
    )
    dist = cosine_cdist(embeddings.reshape(-1, dim), centroids).reshape(
        num_chunks, num_speakers, num_clusters
    )
    soft_clusters = 2 - dist
    if constrained:
        hard_clusters = constrained_argmax(soft_clusters)
    else:
        hard_clusters = np.argmax(soft_clusters, axis=2)
    return hard_clusters, soft_clusters, centroids
