"""The comparison that decides `correct` for the serving cells.

For one served file it takes what the program handed back through the
pipeline's stage hook (the median-filtered binary segmentation, the frame
speaker counts, the embeddings, the hard clusters) and reads four numbers:

- `seg_flip_share`: share of (chunk, frame, speaker) entries of the binary
  segmentation that differ from the reference's, computed from the waveform
  (float32 scores, powerset argmax, median filter of 11 frames);
- `count_mismatch_share`: share of frames whose speaker count differs from
  the overlap-add of the program's own binary segmentation;
- `emb_rel_err`: the largest relative error of an embedding against the
  reference's, for the frame weights that the program's binary segmentation
  gives (its clean frames where enough remain);
- `cluster_mismatch_share`: share of local speakers whose cluster differs
  from reference VBx run on the program's own embeddings and segmentation.

The last three follow the program stage by stage from its own outputs
(PERF.md says so); the first checks the start from the waveform alone.
`reference_outputs` computes the same four outputs with the reference in the
program's place, at a given precision: the control.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch
from scipy.ndimage import median_filter

from portbench.reference.clustering import vbx_clusters
from portbench.reference.embedding import FRAME_LENGTH, Embedding
from portbench.reference.segmentation import (
    Precision,
    Segmentation,
    frame_grid,
    num_frames,
    powerset_mapping,
)

NUMBERS = ("seg_flip_share", "count_mismatch_share", "emb_rel_err", "cluster_mismatch_share")
BLOCK = 32  # windows a reference block computes


@contextmanager
def strict_float32():
    """float32 products stay float32 (no TF32) inside."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Layout:
    """Window and frame geometry of a configuration."""

    def __init__(self, cfg: dict):
        arch, inf = cfg["architecture"], cfg["inference"]["args"]
        self.arch = arch
        self.sample_rate = arch["eend"]["sample_rate"]
        self.duration = float(inf["seg_duration"])
        self.step = inf["segmentation_step"] * self.duration
        self.window = round(self.duration * self.sample_rate)
        self.hop = round(self.step * self.sample_rate)
        self.frames = num_frames(arch, self.window)
        self.frame_step, self.frame_duration = frame_grid(arch, self.sample_rate)
        self.mapping = powerset_mapping(arch["eend"]["max_speakers_per_chunk"],
                                        arch["eend"]["max_speakers_per_frame"])
        self.min_clean = math.ceil(self.frames * FRAME_LENGTH / self.window)

    def starts(self, num_samples: int) -> np.ndarray:
        """Start sample of every window: all complete ones, then one more
        over the rest when something is left."""
        complete = 1 + (num_samples - self.window) // self.hop if num_samples >= self.window else 0
        rest = num_samples < self.window or (num_samples - self.window) % self.hop > 0
        return np.arange(complete + int(rest), dtype=np.int64) * self.hop

    def padded(self, wave: np.ndarray, starts: np.ndarray) -> np.ndarray:
        out = np.zeros(max(int(starts[-1]) + self.window, len(wave)), np.float32)
        out[:len(wave)] = wave
        return out

    def count(self, binary: np.ndarray) -> np.ndarray:
        """Frame speaker counts: each chunk's per-frame speaker sums added
        where the chunk lies on the frame grid, divided by the chunks that
        cover the frame, rounded half to even; 0 where none covers."""
        n, f, _ = binary.shape
        first = np.rint(np.arange(n) * self.step / self.frame_step).astype(np.int64)
        total_frames = int(np.rint((self.duration + (n - 1) * self.step) / self.frame_step)) + 1
        total = np.zeros(total_frames, np.float64)
        cover = np.zeros(total_frames, np.float64)
        idx = (first[:, None] + np.arange(f)[None, :]).reshape(-1)
        np.add.at(total, idx, binary.sum(axis=2).reshape(-1))
        np.add.at(cover, idx, 1.0)
        out = np.where(cover > 0, total / np.maximum(cover, 1.0), 0.0)
        return np.rint(out).astype(np.uint8)

    def weights(self, binary: np.ndarray) -> np.ndarray:
        """(chunks, speakers, frames) embedding weights: a speaker's frames
        where nobody else speaks, if more than `min_clean` of them, else all
        its frames."""
        clean = binary * (binary.sum(axis=2, keepdims=True) < 2)
        use_clean = clean.sum(axis=1) > self.min_clean
        return np.where(use_clean[:, None, :], clean, binary).transpose(0, 2, 1)


def _blocks(n: int):
    for b0 in range(0, n, BLOCK):
        yield b0, min(n, b0 + BLOCK)


def _windows(wave_dev: torch.Tensor, starts: np.ndarray, length: int) -> torch.Tensor:
    idx = torch.as_tensor(starts, device=wave_dev.device)[:, None] + torch.arange(
        length, device=wave_dev.device)
    return wave_dev[idx]


def binary_segmentation(layout: Layout, seg: Segmentation, wave_dev, starts) -> np.ndarray:
    """(chunks, frames, speakers) median-filtered hard segmentation."""
    mapping = torch.as_tensor(layout.mapping, device=wave_dev.device)
    out = []
    for b0, b1 in _blocks(len(starts)):
        scores = seg(_windows(wave_dev, starts[b0:b1], layout.window))
        out.append(mapping[scores.argmax(dim=-1)].to(torch.uint8).cpu().numpy())
    return median_filter(np.concatenate(out), size=(1, 11, 1), mode="reflect")


def embeddings(layout: Layout, emb: Embedding, wave_dev, starts, weights) -> np.ndarray:
    out = []
    for b0, b1 in _blocks(len(starts)):
        w = torch.as_tensor(weights[b0:b1].astype(np.float32), device=wave_dev.device)
        out.append(emb(_windows(wave_dev, starts[b0:b1], layout.window), w).double().cpu().numpy())
    return np.concatenate(out)


def _share(a, b) -> float:
    if a is None or b is None or np.shape(a) != np.shape(b):
        return 1.0
    return float(np.mean(np.asarray(a) != np.asarray(b))) if np.size(a) else 0.0


def judge_file(layout: Layout, cfg: dict, params: dict, wave: np.ndarray, outputs: dict,
               plda_dir: str, device) -> dict:
    """The four numbers of one file (see the module's docstring)."""
    arch = cfg["architecture"]
    starts = layout.starts(len(wave))
    with strict_float32():
        wave_dev = torch.as_tensor(layout.padded(wave, starts), device=device)
        ref_binary = binary_segmentation(layout, Segmentation(arch, params["segmentation"]),
                                         wave_dev, starts)
        binary = outputs.get("binary")
        numbers = {"seg_flip_share": _share(binary, ref_binary)}
        if binary is None or binary.shape != ref_binary.shape:
            return {**numbers, **dict.fromkeys(NUMBERS[1:], 1.0)}
        binary = binary.astype(np.uint8)
        count = layout.count(binary)
        numbers["count_mismatch_share"] = _share(outputs.get("count"), count)
        speech = count.max(initial=0) > 0
        if outputs.get("embeddings") is None:  # the program found no speech
            numbers["emb_rel_err"] = numbers["cluster_mismatch_share"] = float(speech)
            return numbers
        weights = layout.weights(binary)
        ref_emb = embeddings(layout, Embedding(arch, params["embedding"]), wave_dev, starts,
                             weights)
    got = outputs["embeddings"]
    if got.shape != ref_emb.shape:
        numbers["emb_rel_err"] = float("inf")
    else:
        active = weights.sum(axis=2) > 0
        err = np.linalg.norm(got - ref_emb, axis=-1) / np.maximum(
            np.linalg.norm(ref_emb, axis=-1), 1e-12)
        numbers["emb_rel_err"] = float(err[active].max(initial=0.0))
    ref_hard = vbx_clusters(got, binary, plda_dir, cfg["clustering"]["args"])
    numbers["cluster_mismatch_share"] = _share(outputs.get("clusters"), ref_hard)
    return numbers


def reference_outputs(layout: Layout, cfg: dict, params: dict, wave: np.ndarray, plda_dir: str,
                      device, seg_precision: str, emb_precision: str, cluster_dtype) -> dict:
    """The four outputs with the reference in the program's place, its
    products rounded as `seg_precision` and `emb_precision` say and VBx in
    `cluster_dtype`: the control."""
    arch = cfg["architecture"]
    starts = layout.starts(len(wave))
    with strict_float32():
        wave_dev = torch.as_tensor(layout.padded(wave, starts), device=device)
        binary = binary_segmentation(
            layout, Segmentation(arch, params["segmentation"], Precision(seg_precision)),
            wave_dev, starts)
        count = layout.count(binary)
        if count.max(initial=0) == 0:
            return {"binary": binary.astype(np.float32), "count": count}
        emb = embeddings(layout, Embedding(arch, params["embedding"], Precision(emb_precision)),
                         wave_dev, starts, layout.weights(binary))
    clusters = vbx_clusters(emb, binary, plda_dir, cfg["clustering"]["args"], cluster_dtype)
    return {"binary": binary.astype(np.float32), "count": count, "embeddings": emb,
            "clusters": clusters}
