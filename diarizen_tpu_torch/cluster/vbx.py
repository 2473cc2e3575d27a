"""VBx: variational-Bayes HMM / GMM clustering of x-vectors in PLDA space.

Same model as the reference (diarizen/clustering/VBx.py:27-196, itself derived
from BUTSpeechFIT/VBx): zero-mean PLDA with diagonal across-class covariance
Phi and identity within-class covariance; per-frame speaker responsibilities
via either a GMM update (loopProb <= 0 — the mode every DiariZen recipe uses)
or an HMM forward-backward (loopProb > 0; NOTE: the reference cites but does
not ship `forward_backward` — that path would crash there; implemented
properly here). ELBO-monitored, speaker priors pi shrink redundant speakers.

Host numpy: T ~ 1e3 embeddings, D = 128 — microseconds of work; keeping it on
host avoids a device round-trip per VB iteration.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.linalg import eigh
from scipy.special import logsumexp, softmax

from diarizen_tpu_torch.cluster.base import (
    constrained_argmax,
    cosine_cdist,
    filter_embeddings,
)
from diarizen_tpu_torch.cluster.ahc import ahc_cluster  # noqa: F401  (AHC init)
from scipy.cluster.hierarchy import fcluster, linkage


def forward_backward(
    log_p: np.ndarray, tr: np.ndarray, pi: np.ndarray
) -> Tuple[np.ndarray, float, np.ndarray, np.ndarray]:
    """Standard HMM forward-backward in the log domain.

    log_p : (T, S) per-frame log emission probabilities
    tr : (S, S) transition matrix, pi : (S,) initial distribution
    Returns (gamma (T, S), log_pX, logA (T, S), logB (T, S)).
    """
    t_len, s = log_p.shape
    ltr = np.log(np.maximum(tr, 1e-300))
    log_a = np.empty((t_len, s))
    log_b = np.empty((t_len, s))
    log_a[0] = log_p[0] + np.log(np.maximum(pi, 1e-300))
    for t in range(1, t_len):
        log_a[t] = log_p[t] + logsumexp(log_a[t - 1][:, None] + ltr, axis=0)
    log_b[-1] = 0.0
    for t in range(t_len - 2, -1, -1):
        log_b[t] = logsumexp(ltr + (log_p[t + 1] + log_b[t + 1])[None, :], axis=1)
    log_px = logsumexp(log_a[-1])
    gamma = np.exp(log_a + log_b - log_px)
    return gamma, log_px, log_a, log_b


def vbx(
    x: np.ndarray,
    phi: np.ndarray,
    loop_prob: float = 0.9,
    fa: float = 1.0,
    fb: float = 1.0,
    pi=10,
    gamma: Optional[np.ndarray] = None,
    max_iters: int = 10,
    epsilon: float = 1e-4,
    alpha_q_init: float = 1.0,
    rng: Optional[np.random.Generator] = None,
):
    """VB inference. x: (T, D) PLDA-space features, phi: (D,) across-class
    covariance diagonal. Returns (gamma (T, S), pi (S,), elbo_history)."""
    d = x.shape[1]
    if isinstance(pi, int):
        pi = np.ones(pi) / pi
    if gamma is None:
        rng = rng or np.random.default_rng()
        gamma = rng.gamma(alpha_q_init, size=(x.shape[0], len(pi)))
        gamma = gamma / gamma.sum(1, keepdims=True)

    g_const = -0.5 * (np.sum(x**2, axis=1, keepdims=True) + d * np.log(2 * np.pi))
    rho = x * np.sqrt(phi)
    elbos = []
    for it in range(max_iters):
        inv_l = 1.0 / (1 + fa / fb * gamma.sum(axis=0, keepdims=True).T * phi)
        alpha = fa / fb * inv_l * gamma.T.dot(rho)
        log_p = fa * (rho.dot(alpha.T) - 0.5 * (inv_l + alpha**2).dot(phi) + g_const)

        if loop_prob <= 0.0:
            lpi = np.log(pi + 1e-8)
            log_p_x = logsumexp(log_p + lpi, axis=-1)
            log_px_total = np.sum(log_p_x, axis=0)
            gamma = np.exp(log_p + lpi - log_p_x[:, None])
            pi = np.sum(gamma, axis=0)
        else:
            tr = np.eye(len(pi)) * loop_prob + (1 - loop_prob) * pi
            gamma, log_px_total, log_a, log_b = forward_backward(log_p, tr, pi)
            pi = gamma[0] + (1 - loop_prob) * pi * np.sum(
                np.exp(
                    logsumexp(log_a[:-1], axis=1, keepdims=True)
                    + log_p[1:]
                    + log_b[1:]
                    - log_px_total
                ),
                axis=0,
            )
        pi = pi / pi.sum()

        elbo = log_px_total + fb * 0.5 * np.sum(np.log(inv_l) - inv_l - alpha**2 + 1)
        elbos.append(elbo)
        if it > 0 and elbo - elbos[-2] < epsilon:
            break
    return gamma, pi, elbos


def cluster_vbx(
    ahc_init: np.ndarray,
    fea: np.ndarray,
    phi: np.ndarray,
    fa: float,
    fb: float,
    loop_prob: float = 0.0,
    max_iters: int = 20,
    init_smoothing: float = 7.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Softmax-smoothed AHC one-hot init -> VB (VBx.py:127-139)."""
    qinit = np.zeros((len(ahc_init), int(ahc_init.max()) + 1))
    qinit[range(len(ahc_init)), ahc_init.astype(int)] = 1.0
    if init_smoothing >= 0:
        qinit = softmax(qinit * init_smoothing, axis=1)
    gamma, pi, _ = vbx(
        fea, phi, loop_prob=loop_prob, fa=fa, fb=fb,
        pi=qinit.shape[1], gamma=qinit, max_iters=max_iters,
    )
    return gamma, pi


def l2_norm(x: np.ndarray) -> np.ndarray:
    if x.ndim == 1:
        return x / np.linalg.norm(x)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def vbx_setup(tf_dir: str):
    """Load x-vector-to-PLDA transform pipeline from `xvec_transform.npz`
    (mean1, mean2, lda) + `plda.npz` (mu, tr, psi); solve the generalized
    eigenproblem for simultaneous diagonalization (VBx.py:158-194).

    Returns (xvec_tf, plda_tf, plda_psi)."""
    x = np.load(f"{tf_dir}/xvec_transform.npz")
    mean1, mean2, lda = x["mean1"], x["mean2"], x["lda"]
    p = np.load(f"{tf_dir}/plda.npz")
    plda_mu, plda_tr, plda_psi = p["mu"], p["tr"], p["psi"]

    within = np.linalg.inv(plda_tr.T.dot(plda_tr))
    between = np.linalg.inv((plda_tr.T / plda_psi).dot(plda_tr))
    acvar, wccn = eigh(between, within)
    plda_psi = acvar[::-1]
    plda_tr = wccn.T[::-1]

    def xvec_tf(xv):
        h = np.sqrt(lda.shape[0]) * l2_norm(xv - mean1)
        return np.sqrt(lda.shape[1]) * l2_norm(lda.T.dot(h.T).T - mean2)

    def plda_tf(x0, lda_dim=lda.shape[1]):
        return (x0 - plda_mu).dot(plda_tr.T)[:, :lda_dim]

    return xvec_tf, plda_tf, plda_psi


class VBxClustering:
    """AHC init -> PLDA projection -> VBx -> gamma-weighted centroids
    (reference clustering.py:601-700)."""

    def __init__(
        self,
        plda_dir: str,
        ahc_criterion: str = "distance",
        ahc_threshold: float = 0.6,
        fa: float = 0.07,
        fb: float = 0.8,
        lda_dim: int = 128,
        max_iters: int = 20,
        constrained_assignment: bool = True,
        max_num_embeddings: Optional[int] = None,
        loop_prob: float = 0.0,
    ):
        self.plda_dir = plda_dir
        self.ahc_criterion = ahc_criterion
        self.ahc_threshold = ahc_threshold
        self.fa = fa
        self.fb = fb
        self.lda_dim = lda_dim
        self.max_iters = max_iters
        self.constrained_assignment = constrained_assignment
        self.max_num_embeddings = max_num_embeddings
        # loop_prob > 0 selects the HMM forward-backward mode (the recipes all
        # use the GMM mode, loop_prob=0 — clustering.py:654-673)
        self.loop_prob = loop_prob

    def __call__(
        self,
        embeddings: np.ndarray,
        binary_segmentations: np.ndarray,
        num_clusters=None,
        min_clusters=None,
        max_clusters=None,
    ):
        train_embeddings, _, _ = filter_embeddings(
            embeddings, binary_segmentations, min_frames_ratio=0.1,
            max_num_embeddings=self.max_num_embeddings,
        )
        num_chunks, num_speakers, dim = embeddings.shape
        if train_embeddings.shape[0] < 2:
            return (
                np.zeros((num_chunks, num_speakers), dtype=np.int8),
                np.ones((num_chunks, num_speakers, 1)),
                np.mean(train_embeddings, axis=0, keepdims=True),
            )

        normed = train_embeddings / np.maximum(
            np.linalg.norm(train_embeddings, axis=1, keepdims=True), 1e-12
        )
        dendrogram = linkage(normed, method="centroid", metric="euclidean")
        ahc_clusters = fcluster(dendrogram, self.ahc_threshold, criterion=self.ahc_criterion) - 1
        _, ahc_clusters = np.unique(ahc_clusters, return_inverse=True)

        xvec_tf, plda_tf, plda_psi = vbx_setup(self.plda_dir)
        fea = plda_tf(xvec_tf(train_embeddings), lda_dim=self.lda_dim)
        phi = plda_psi[: self.lda_dim]
        q, sp = cluster_vbx(
            ahc_clusters, fea, phi, fa=self.fa, fb=self.fb,
            loop_prob=self.loop_prob, max_iters=self.max_iters,
        )

        # gamma-weighted centroids over surviving speakers (pi > 1e-7);
        # no normalization needed, cosine similarity follows
        centroids = q[:, sp > 1e-7].T @ train_embeddings.reshape(-1, dim)

        dist = cosine_cdist(embeddings.reshape(-1, dim), centroids).reshape(
            num_chunks, num_speakers, -1
        )
        soft_clusters = 2 - dist
        if self.constrained_assignment:
            hard_clusters = constrained_argmax(soft_clusters)
        else:
            hard_clusters = np.argmax(soft_clusters, axis=2)
        _, hard_clusters = np.unique(hard_clusters, return_inverse=True)
        hard_clusters = hard_clusters.reshape(num_chunks, num_speakers)
        return hard_clusters, soft_clusters, centroids
