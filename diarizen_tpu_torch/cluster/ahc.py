"""Agglomerative hierarchical clustering with min-cluster-size repair.

Reference semantics: pyannote AgglomerativeClustering
(pyannote-audio/pyannote/audio/pipelines/clustering.py:325-513): scipy
linkage + fcluster at a distance threshold, large/small cluster split at
min_cluster_size, dendrogram re-traversal (iteration-index criterion,
closest-to-threshold-first) to hit a target cluster count, and small->large
centroid reassignment. scipy's C linkage is kept (the reference delegates to
the same library; the O(N^2) affinity is not the bottleneck at N<=1000).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage

from diarizen_tpu_torch.cluster.base import (
    assign_embeddings,
    cosine_cdist,
    filter_embeddings,
    set_num_clusters,
)


def ahc_cluster(
    embeddings: np.ndarray,
    min_clusters: int,
    max_clusters: int,
    num_clusters: Optional[int] = None,
    threshold: float = 0.7,
    method: str = "centroid",
    min_cluster_size: int = 30,
    metric: str = "cosine",
) -> np.ndarray:
    """(N, D) embeddings -> (N,) cluster labels."""
    num_embeddings = embeddings.shape[0]
    min_cluster_size = min(min_cluster_size, max(1, round(0.1 * num_embeddings)))
    if num_embeddings == 1:
        return np.zeros((1,), dtype=np.uint8)

    if metric == "cosine" and method in ("centroid", "median", "ward"):
        # these linkages need euclidean — unit-normalize first
        with np.errstate(divide="ignore", invalid="ignore"):
            embeddings = embeddings / np.maximum(
                np.linalg.norm(embeddings, axis=-1, keepdims=True), 1e-12
            )
        dendrogram = linkage(embeddings, method=method, metric="euclidean")
    else:
        dendrogram = linkage(embeddings, method=method, metric=metric)

    clusters = fcluster(dendrogram, threshold, criterion="distance") - 1

    cluster_unique, cluster_counts = np.unique(clusters, return_counts=True)
    large_clusters = cluster_unique[cluster_counts >= min_cluster_size]
    num_large_clusters = len(large_clusters)

    if num_large_clusters < min_clusters:
        num_clusters = min_clusters
    elif num_large_clusters > max_clusters:
        num_clusters = max_clusters

    if num_clusters is not None and num_large_clusters != num_clusters:
        # re-traverse the dendrogram by iteration index, nearest the threshold
        # first, to land on the target number of large clusters
        _dendrogram = np.copy(dendrogram)
        _dendrogram[:, 2] = np.arange(num_embeddings - 1)

        best_iteration = num_embeddings - 1
        best_num_large_clusters = 1

        for iteration in np.argsort(np.abs(dendrogram[:, 2] - threshold)):
            if _dendrogram[iteration, 3] < min_cluster_size:
                continue
            clusters = fcluster(_dendrogram, iteration, criterion="distance") - 1
            cluster_unique, cluster_counts = np.unique(clusters, return_counts=True)
            large_clusters = cluster_unique[cluster_counts >= min_cluster_size]
            num_large_clusters = len(large_clusters)
            if abs(num_large_clusters - num_clusters) < abs(
                best_num_large_clusters - num_clusters
            ):
                best_iteration = iteration
                best_num_large_clusters = num_large_clusters
            if num_large_clusters == num_clusters:
                break

        if best_num_large_clusters != num_clusters:
            clusters = fcluster(_dendrogram, best_iteration, criterion="distance") - 1
            cluster_unique, cluster_counts = np.unique(clusters, return_counts=True)
            large_clusters = cluster_unique[cluster_counts >= min_cluster_size]
            num_large_clusters = len(large_clusters)

    if num_large_clusters == 0:
        clusters[:] = 0
        return clusters

    small_clusters = cluster_unique[cluster_counts < min_cluster_size]
    if len(small_clusters) == 0:
        return clusters

    large_centroids = np.vstack(
        [np.mean(embeddings[clusters == k], axis=0) for k in large_clusters]
    )
    small_centroids = np.vstack(
        [np.mean(embeddings[clusters == k], axis=0) for k in small_clusters]
    )
    centroids_cdist = cosine_cdist(large_centroids, small_centroids)
    for small_k, large_k in enumerate(np.argmin(centroids_cdist, axis=0)):
        clusters[clusters == small_clusters[small_k]] = large_clusters[large_k]

    _, clusters = np.unique(clusters, return_inverse=True)
    return clusters


class AgglomerativeClustering:
    """Callable matching the reference pipeline contract
    ((embeddings, binary_segmentations, num/min/max) ->
     (hard_clusters, soft_clusters, centroids))."""

    def __init__(
        self,
        threshold: float = 0.7,
        method: str = "centroid",
        min_cluster_size: int = 30,
        metric: str = "cosine",
        constrained_assignment: bool = True,
        max_num_embeddings: Optional[int] = None,
    ):
        self.threshold = threshold
        self.method = method
        self.min_cluster_size = min_cluster_size
        self.metric = metric
        self.constrained_assignment = constrained_assignment
        self.max_num_embeddings = max_num_embeddings

    def __call__(
        self,
        embeddings: np.ndarray,
        binary_segmentations: np.ndarray,
        num_clusters: Optional[int] = None,
        min_clusters: Optional[int] = None,
        max_clusters: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        train_embeddings, chunk_idx, speaker_idx = filter_embeddings(
            embeddings, binary_segmentations,
            max_num_embeddings=self.max_num_embeddings,
        )
        num_embeddings = train_embeddings.shape[0]
        num_clusters, min_clusters, max_clusters = set_num_clusters(
            num_embeddings, num_clusters, min_clusters, max_clusters
        )
        if max_clusters < 2:
            num_chunks, num_speakers, _ = embeddings.shape
            return (
                np.zeros((num_chunks, num_speakers), dtype=np.int8),
                np.ones((num_chunks, num_speakers, 1)),
                np.mean(train_embeddings, axis=0, keepdims=True),
            )
        train_clusters = ahc_cluster(
            train_embeddings, min_clusters, max_clusters, num_clusters,
            threshold=self.threshold, method=self.method,
            min_cluster_size=self.min_cluster_size, metric=self.metric,
        )
        return assign_embeddings(
            embeddings, chunk_idx, speaker_idx, train_clusters,
            constrained=self.constrained_assignment,
        )
