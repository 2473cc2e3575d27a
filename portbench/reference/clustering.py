"""Plain reference of VBx clustering as DiariZen runs it
(`diarizen/clustering/VBx.py` and pyannote's clustering helpers, themselves
from BUTSpeechFIT/VBx): embeddings with enough clean frames, centroid AHC on
unit vectors as the initial assignment, x-vector and PLDA transforms, VB
GMM updates (loop probability 0) with speaker priors, gamma-weighted
centroids, and a constrained per-chunk assignment (Hungarian). Host numpy in
`dtype` (float64 as the recipe computes; float32 for the control). Imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage
from scipy.linalg import eigh
from scipy.optimize import linear_sum_assignment
from scipy.special import logsumexp, softmax


def usable(embeddings: np.ndarray, binary: np.ndarray, min_frames_ratio: float = 0.1):
    """(chunk, speaker) indices of the embeddings clustering trains on: active,
    finite, and with at least a tenth of the chunk's frames clean (the speaker
    alone); without two such, any clean frame will do."""
    active = binary.sum(axis=1) > 0
    finite = ~np.any(np.isnan(embeddings), axis=2)
    alone = binary.sum(axis=2, keepdims=True) == 1
    clean = (binary * alone).sum(axis=1)
    chunks, speakers = np.where(active & finite
                                & (clean >= round(min_frames_ratio * binary.shape[1])))
    if len(chunks) < 2:
        chunks, speakers = np.where(active & finite & (clean >= 0))
    return chunks, speakers


def plda_transforms(plda_dir: str, dtype):
    x = np.load(f"{plda_dir}/xvec_transform.npz")
    mean1, mean2, lda = (x[k].astype(dtype) for k in ("mean1", "mean2", "lda"))
    p = np.load(f"{plda_dir}/plda.npz")
    mu, tr, psi = (p[k].astype(dtype) for k in ("mu", "tr", "psi"))
    within = np.linalg.inv(tr.T.dot(tr))
    between = np.linalg.inv((tr.T / psi).dot(tr))
    acvar, wccn = eigh(between, within)
    psi, tr = acvar[::-1], wccn.T[::-1]

    def unit(v):
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    def xvec(v):
        h = np.sqrt(lda.shape[0]) * unit(v - mean1)
        return np.sqrt(lda.shape[1]) * unit(lda.T.dot(h.T).T - mean2)

    def plda(v, lda_dim):
        return (v - mu).dot(tr.T)[:, :lda_dim]

    return xvec, plda, psi


def vb_gmm(x, phi, gamma, fa, fb, max_iters, epsilon=1e-4):
    """VB updates of the responsibilities `gamma` and priors `pi`."""
    d = x.shape[1]
    pi = np.ones(gamma.shape[1], x.dtype) / gamma.shape[1]
    g_const = -0.5 * (np.sum(x ** 2, axis=1, keepdims=True) + d * np.log(2 * np.pi))
    rho = x * np.sqrt(phi)
    elbos = []
    for it in range(max_iters):
        inv_l = 1.0 / (1 + fa / fb * gamma.sum(axis=0, keepdims=True).T * phi)
        alpha = fa / fb * inv_l * gamma.T.dot(rho)
        log_p = fa * (rho.dot(alpha.T) - 0.5 * (inv_l + alpha ** 2).dot(phi) + g_const)
        lpi = np.log(pi + 1e-8)
        log_px = logsumexp(log_p + lpi, axis=-1)
        gamma = np.exp(log_p + lpi - log_px[:, None])
        pi = gamma.sum(axis=0)
        pi = pi / pi.sum()
        elbos.append(np.sum(log_px) + fb * 0.5 * np.sum(np.log(inv_l) - inv_l - alpha ** 2 + 1))
        if it > 0 and elbos[-1] - elbos[-2] < epsilon:
            break
    return gamma, pi


def vbx_clusters(embeddings: np.ndarray, binary: np.ndarray, plda_dir: str, args: dict,
                 dtype=np.float64) -> np.ndarray:
    """(chunks, speakers, dim) embeddings and (chunks, frames, speakers) binary
    segmentation -> (chunks, speakers) hard cluster of each local speaker."""
    embeddings = embeddings.astype(dtype)
    binary = binary.astype(dtype)
    n_chunks, n_spk, dim = embeddings.shape
    chunks, speakers = usable(embeddings, binary)
    train = embeddings[chunks, speakers]
    if len(train) < 2:
        return np.zeros((n_chunks, n_spk), np.int64)
    unit = train / np.maximum(np.linalg.norm(train, axis=1, keepdims=True), 1e-12)
    ahc = fcluster(linkage(unit, method="centroid", metric="euclidean"),
                   args["ahc_threshold"], criterion=args["ahc_criterion"]) - 1
    _, ahc = np.unique(ahc, return_inverse=True)
    xvec, plda, psi = plda_transforms(plda_dir, dtype)
    lda_dim = args["lda_dim"]
    fea = plda(xvec(train), lda_dim)
    qinit = np.zeros((len(ahc), ahc.max() + 1), dtype)
    qinit[np.arange(len(ahc)), ahc] = 1.0
    gamma, pi = vb_gmm(fea, psi[:lda_dim], softmax(qinit * 7.0, axis=1), args["Fa"], args["Fb"],
                       args["max_iters"])
    centroids = gamma[:, pi > 1e-7].T @ train
    an = np.maximum(np.linalg.norm(embeddings.reshape(-1, dim), axis=1, keepdims=True), 1e-12)
    bn = np.maximum(np.linalg.norm(centroids, axis=1, keepdims=True), 1e-12)
    with np.errstate(divide="ignore", invalid="ignore"):
        sim = (embeddings.reshape(-1, dim) @ centroids.T) / (an * bn.T)
    soft = (1.0 + sim).reshape(n_chunks, n_spk, -1)  # 2 - cosine distance
    soft = np.nan_to_num(soft, nan=np.nanmin(soft))
    hard = -2 * np.ones((n_chunks, n_spk), np.int64)
    for c, cost in enumerate(soft):
        rows, cols = linear_sum_assignment(cost, maximize=True)
        hard[c, rows] = cols
    _, hard = np.unique(hard, return_inverse=True)
    return hard.reshape(n_chunks, n_spk)
