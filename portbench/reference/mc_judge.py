"""The comparison that decides `correct` for the multi-channel serving cell.

For one served (C, samples) file it takes what the program handed back
through the pipeline's stage hook (the median-filtered binary segmentation,
the frame speaker counts, the windows' channel weights, the fused
embeddings, the hard clusters) and reads five numbers:

- `seg_flip_share`: share of (chunk, frame, speaker) entries of the binary
  segmentation that differ from the reference's, computed from the C
  channels of the waveform (float32 scores, powerset argmax, median filter
  of 11 frames);
- `count_mismatch_share`: share of frames whose speaker count differs from
  the overlap-add of the program's own binary segmentation;
- `chan_weight_err`: the largest absolute difference of the (chunks, C)
  channel weights from the reference's, computed from the waveform;
- `emb_rel_err`: the largest relative error of a fused embedding against
  the reference's ResNet34 fed the program's masks (the plain masks, as
  the multi-channel recipe embeds) and the program's channel weights, so
  that the ResNet's error is read apart from the segmentation's;
- `cluster_mismatch_share`: share of local speakers whose cluster differs
  from reference VBx run on the program's own embeddings and segmentation.

`reference_outputs` computes the same outputs with the reference in the
program's place, its products rounded one precision down: the control.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import median_filter

from portbench.reference.clustering import vbx_clusters
from portbench.reference.embedding import Embedding
from portbench.reference.judge import Layout, _blocks, _share, strict_float32
from portbench.reference.mc import McSegmentation, fused_embeddings
from portbench.reference.segmentation import Precision

NUMBERS = ("seg_flip_share", "count_mismatch_share", "chan_weight_err", "emb_rel_err",
           "cluster_mismatch_share")


def padded(layout: Layout, wave: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """(C, samples) zero-padded so that every window lies inside."""
    out = np.zeros((wave.shape[0], max(int(starts[-1]) + layout.window, wave.shape[1])),
                   np.float32)
    out[:, :wave.shape[1]] = wave
    return out


def _windows(wave_dev: torch.Tensor, starts: np.ndarray, length: int) -> torch.Tensor:
    """(B, C, length) windows of a (C, samples) wave."""
    idx = torch.as_tensor(starts, device=wave_dev.device)[:, None] + torch.arange(
        length, device=wave_dev.device)
    return wave_dev[:, idx].transpose(0, 1)


def segmentation(layout: Layout, seg: McSegmentation, wave_dev, starts) -> tuple:
    """((chunks, frames, speakers) median-filtered hard segmentation,
    (chunks, C) channel weights)."""
    mapping = torch.as_tensor(layout.mapping, device=wave_dev.device)
    binary, weights = [], []
    for b0, b1 in _blocks(len(starts)):
        scores, w = seg(_windows(wave_dev, starts[b0:b1], layout.window))
        binary.append(mapping[scores.argmax(dim=-1)].to(torch.uint8).cpu().numpy())
        weights.append(w.cpu().numpy())
    return (median_filter(np.concatenate(binary), size=(1, 11, 1), mode="reflect"),
            np.concatenate(weights))


def embeddings(layout: Layout, emb: Embedding, wave_dev, starts, weights,
               channel_weights) -> np.ndarray:
    """(chunks, S, D) fused embeddings for the (chunks, S, frames) speaker
    weights and (chunks, C) channel weights given."""
    out = []
    for b0, b1 in _blocks(len(starts)):
        w = torch.as_tensor(weights[b0:b1].astype(np.float32), device=wave_dev.device)
        cw = torch.as_tensor(channel_weights[b0:b1].astype(np.float32), device=wave_dev.device)
        out.append(fused_embeddings(emb, _windows(wave_dev, starts[b0:b1], layout.window), w,
                                    cw).double().cpu().numpy())
    return np.concatenate(out)


def masks(binary: np.ndarray) -> np.ndarray:
    """(chunks, speakers, frames) embedding weights: the plain masks."""
    return binary.transpose(0, 2, 1)


def judge_file(layout: Layout, cfg: dict, params: dict, wave: np.ndarray, outputs: dict,
               plda_dir: str, device) -> dict:
    """The five numbers of one (C, samples) file (the module's docstring)."""
    arch = cfg["architecture"]
    starts = layout.starts(wave.shape[1])
    with strict_float32():
        wave_dev = torch.as_tensor(padded(layout, wave, starts), device=device)
        ref_binary, ref_weights = segmentation(
            layout, McSegmentation(arch, params["segmentation"]), wave_dev, starts)
        binary = outputs.get("binary")
        numbers = {"seg_flip_share": _share(binary, ref_binary)}
        if binary is None or binary.shape != ref_binary.shape:
            return {**numbers, **dict.fromkeys(NUMBERS[1:], 1.0)}
        binary = binary.astype(np.uint8)
        count = layout.count(binary)
        numbers["count_mismatch_share"] = _share(outputs.get("count"), count)
        got_weights = outputs.get("channel_weights")
        numbers["chan_weight_err"] = (
            float(np.abs(got_weights - ref_weights).max(initial=0.0))
            if got_weights is not None and got_weights.shape == ref_weights.shape
            else float("inf"))
        speech = count.max(initial=0) > 0
        if outputs.get("embeddings") is None:  # the program found no speech
            numbers["emb_rel_err"] = numbers["cluster_mismatch_share"] = float(speech)
            return numbers
        if not np.isfinite(numbers["chan_weight_err"]):
            return {**numbers, "emb_rel_err": float("inf"), "cluster_mismatch_share": 1.0}
        weights = masks(binary)
        ref_emb = embeddings(layout, Embedding(arch, params["embedding"]), wave_dev, starts,
                             weights, got_weights)
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
    """The outputs with the reference in the program's place, its
    segmentation and fusion products rounded as `seg_precision` says, its
    ResNet's as `emb_precision`, VBx in `cluster_dtype`: the control."""
    arch = cfg["architecture"]
    starts = layout.starts(wave.shape[1])
    with strict_float32():
        wave_dev = torch.as_tensor(padded(layout, wave, starts), device=device)
        binary, channel_weights = segmentation(
            layout, McSegmentation(arch, params["segmentation"], Precision(seg_precision)),
            wave_dev, starts)
        count = layout.count(binary)
        out = {"binary": binary.astype(np.float32), "count": count,
               "channel_weights": channel_weights}
        if count.max(initial=0) == 0:
            return out
        emb = embeddings(layout, Embedding(arch, params["embedding"], Precision(emb_precision)),
                         wave_dev, starts, masks(binary), channel_weights)
    clusters = vbx_clusters(emb, binary, plda_dir, cfg["clustering"]["args"], cluster_dtype)
    return {**out, "embeddings": emb, "clusters": clusters}
