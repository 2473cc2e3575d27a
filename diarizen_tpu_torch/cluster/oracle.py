"""Oracle clustering: map local speakers to reference speakers (port of
diarizen_tpu/cluster/oracle.py).

For each chunk the binarized local segmentation is aligned (Hungarian PIT)
with the reference annotation rasterised on the same chunk grid; the
permutation is the cluster assignment. It bounds what the clustering stage
could reach.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from diarizen_tpu_torch.cluster.base import filter_embeddings
from diarizen_tpu_torch.core.segments import Annotation, SlidingWindow
from diarizen_tpu_torch.ops.permutation import permutate_hungarian


def oracle_segmentation(reference: Annotation, window: SlidingWindow, num_chunks: int,
                        frames: SlidingWindow, num_frames: int) -> np.ndarray:
    """The reference rasterised per chunk: (chunks, frames, speakers) float32."""
    labels = reference.labels()
    out = np.zeros((num_chunks, num_frames, max(len(labels), 1)), dtype=np.float32)
    tracks = [(seg, labels.index(label)) for seg, _, label in reference.itertracks()]
    for c in range(num_chunks):
        chunk = window[c]
        for seg, k in tracks:
            if seg.end <= chunk.start or seg.start >= chunk.start + window.duration:
                continue
            f0 = max(0, round((seg.start - chunk.start - 0.5 * frames.duration) / frames.step))
            f1 = round((seg.end - chunk.start - 0.5 * frames.duration) / frames.step)
            out[c, f0: min(f1 + 1, num_frames), k] = 1.0
    return out


class OracleClustering:
    """A clustering stage that reads the answer from a reference annotation:
    same call contract as AgglomerativeClustering, plus the chunk window."""

    def __init__(self, reference: Annotation, frames: SlidingWindow):
        self.reference = reference
        self.frames = frames

    def __call__(
        self,
        embeddings: Optional[np.ndarray],
        binary_segmentations: np.ndarray,
        window: Optional[SlidingWindow] = None,
        min_clusters=None,
        max_clusters=None,
    ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Returns (hard (chunks, S) int8 with -2 for unassigned, soft
        (chunks, S, clusters) one-hot, centroids (clusters, D) or None)."""
        if window is None:
            raise ValueError("OracleClustering needs the chunk window")
        num_chunks, num_frames, num_speakers = binary_segmentations.shape
        oracle = oracle_segmentation(self.reference, window, num_chunks, self.frames,
                                     num_frames)
        num_clusters = oracle.shape[2]
        hard = np.full((num_chunks, num_speakers), -2, dtype=np.int8)
        soft = np.zeros((num_chunks, num_speakers, num_clusters))
        for c in range(num_chunks):
            # the oracle's columns aligned onto the local segmentation
            _, perm = permutate_hungarian(
                oracle[c][None], binary_segmentations[c][None].astype(np.float64))
            for j, i in enumerate(perm[0]):
                if 0 <= i < num_speakers:
                    hard[c, i] = j
                    soft[c, i, j] = 1.0
        if embeddings is None:
            return hard, soft, None
        train_embeddings, chunk_idx, speaker_idx = filter_embeddings(
            embeddings, binary_segmentations)
        train_clusters = hard[chunk_idx, speaker_idx]
        centroids = np.vstack([
            np.mean(train_embeddings[train_clusters == k], axis=0)
            if np.any(train_clusters == k) else np.zeros(embeddings.shape[-1])
            for k in range(num_clusters)
        ])
        return hard, soft, centroids
