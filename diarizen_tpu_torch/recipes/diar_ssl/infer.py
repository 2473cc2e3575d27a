"""Checkpoint-averaged full-pipeline inference and DER scoring (port of
recipes/diar_ssl/infer.py).

Selects the N best / previous / centred checkpoints of an experiment by a
validation metric, averages their weights, diarizes a wav.scp (WAV or FLAC)
through the streamed pipeline, writes one RTTM per recording and, with a
reference RTTM, scores DER (collar 0, overlap scored) into `der.json`.

    python -m diarizen_tpu_torch.recipes.diar_ssl.infer \\
        -C recipes/diar_ssl/conf/wavlm_updated_conformer.toml \\
        --exp_dir exp/wavlm_updated_conformer --wav_scp data/AMI/test/wav.scp \\
        --ref_rttm data/AMI/test/rttm --out_dir exp/infer/AMI \\
        --avg_ckpt_num 5 --avg_mode best [--embedding_ckpt resnet34.bin] [--clustering AHC]

It runs on the CUDA device; `main(argv, device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence, Union

import torch

from diarizen_tpu_torch.cluster import AgglomerativeClustering, VBxClustering
from diarizen_tpu_torch.config import instantiate_model_for_inference, load_toml
from diarizen_tpu_torch.core.audio import read_audio
from diarizen_tpu_torch.core.io_rttm import load_rttm, load_scp
from diarizen_tpu_torch.infer import DiarizationPipeline, EmbeddingInference, SlidingInference
from diarizen_tpu_torch.logger import init_logging
from diarizen_tpu_torch.ops.der import DERReport, der_report
from diarizen_tpu_torch.pipelines import load_resnet
from diarizen_tpu_torch.train.checkpoint import (
    average_checkpoints,
    load_metrics,
    select_checkpoints,
)
from diarizen_tpu_torch.utils import resolve_device

Device = Optional[Union[str, torch.device]]


def load_averaged_model(args: argparse.Namespace, config: dict):
    """(config, model) of the `[model]` section with the average of the
    experiment's selected checkpoints loaded (strict), on the host."""
    # the averaged checkpoints overwrite every weight, so a training-time
    # wavlm_src path that does not resolve here may fall back to the preset
    cfg, model = instantiate_model_for_inference(
        config["model"]["path"], config["model"].get("args", {}))

    exp_dir = Path(args.exp_dir)
    ckpts = select_checkpoints(load_metrics(exp_dir), exp_dir / "checkpoints",
                               num=args.avg_ckpt_num, metric=args.avg_metric,
                               mode=args.avg_mode)
    if not ckpts:
        # the model may be the preset's random weights: scoring them would
        # write meaningless RTTMs without a word
        raise RuntimeError(
            f"no checkpoints selected from {exp_dir}/checkpoints "
            f"(metric={args.avg_metric!r}, mode={args.avg_mode!r}): check "
            "--exp_dir and that metrics.jsonl exists")
    model.load_state_dict(average_checkpoints(ckpts), strict=True)
    print(f"averaged {len(ckpts)} checkpoints: {[c.name for c in ckpts]}")
    return cfg, model


def build_clustering(cl: dict, method: str, fa: float = 0.07, fb: float = 0.8):
    """The `[clustering.args]` table's AHC or VBx; `fa` and `fb` are the
    defaults of VBx's Fa and Fb."""
    if method in ("AHC", "AgglomerativeClustering"):
        return AgglomerativeClustering(threshold=cl.get("ahc_threshold", 0.70),
                                       min_cluster_size=cl.get("min_cluster_size", 30),
                                       method=cl.get("linkage", "centroid"))
    if method in ("VBx", "VBxClustering"):
        return VBxClustering(
            plda_dir=cl["plda_dir"], ahc_criterion=cl.get("ahc_criterion", "distance"),
            ahc_threshold=cl.get("ahc_threshold", 0.6), fa=cl.get("Fa", fa),
            fb=cl.get("Fb", fb), lda_dim=cl.get("lda_dim", 128),
            max_iters=cl.get("max_iters", 20))
    raise ValueError(f"unknown clustering {method}")


def build_pipeline(args: argparse.Namespace, config: dict,
                   device: Device = None) -> DiarizationPipeline:
    device = resolve_device(device)
    cfg, model = load_averaged_model(args, config)
    inference_args = config.get("inference", {}).get("args", {})
    seg_duration = float(inference_args.get("seg_duration", 8))
    batch_size = inference_args.get("batch_size", 32)
    seg_inf = SlidingInference(model, duration=seg_duration, step=0.1 * seg_duration,
                               batch_size=batch_size, device=device)

    if not args.embedding_ckpt:
        print("WARNING: no --embedding_ckpt; random embedding weights (smoke mode)")
    emb_inf = EmbeddingInference(load_resnet(args.embedding_ckpt or None),
                                 window_size=seg_inf.window_size,
                                 num_speakers=cfg.max_speakers_per_chunk,
                                 batch_size=batch_size, device=device)

    cl = config.get("clustering", {}).get("args", {})
    clustering = build_clustering(
        cl, args.clustering or cl.get("method", "AgglomerativeClustering"))
    return DiarizationPipeline(
        seg_inference=seg_inf, emb_inference=emb_inf, clustering=clustering, eend_cfg=cfg,
        min_speakers=cl.get("min_speakers", 1), max_speakers=cl.get("max_speakers", 8),
        apply_median_filtering=inference_args.get("apply_median_filtering", True),
    )


def score(refs: dict, hyps: dict) -> dict:
    """der.json's content: the overall rates and each file's components."""
    total = DERReport(0.0, 0.0, 0.0, 0.0)
    per_file = {}
    for uri, hyp in hyps.items():
        if uri not in refs:
            continue
        r = der_report(refs[uri], hyp)
        per_file[uri] = {"der": r.der, "fa": r.false_alarm, "miss": r.missed_detection,
                         "conf": r.confusion, "total": r.total}
        total = total + r
    denom = max(total.total, 1e-9)
    return {
        "der": total.der,
        "false_alarm": total.false_alarm / denom,
        "missed_detection": total.missed_detection / denom,
        "confusion": total.confusion / denom,
        "files": per_file,
    }


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("python -m diarizen_tpu_torch.recipes.diar_ssl.infer")
    parser.add_argument("-C", "--configuration", required=True)
    parser.add_argument("--exp_dir", required=True)
    parser.add_argument("--wav_scp", required=True)
    parser.add_argument("--ref_rttm", default=None)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--avg_ckpt_num", type=int, default=5)
    parser.add_argument("--avg_mode", default="best", choices=["best", "prev", "center"])
    parser.add_argument("--avg_metric", default="loss")
    parser.add_argument("--embedding_ckpt", default=None)
    parser.add_argument("--clustering", default=None)
    parser.add_argument("--max_files", type=int, default=None)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, device: Device = None) -> dict:
    """Runs the recipe; returns {uri: Annotation}."""
    args = parse_args(argv)
    config = load_toml(args.configuration)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    init_logging(out_dir, filename="infer.log")
    pipeline = build_pipeline(args, config, device)

    items = list(load_scp(args.wav_scp).items())[: args.max_files]

    def waves():
        # read while the previous file's device work runs (stream)
        for _, path in items:
            wave, sr = read_audio(path)
            if sr != 16000:
                raise ValueError(f"{path}: expected 16 kHz, got {sr}")
            yield wave

    hyps = {}
    uris = [uri for uri, _ in items]
    for uri, ann in zip(uris, pipeline.stream(waves(), 16000, uris=uris)):
        hyps[uri] = ann
        (out_dir / f"{uri}.rttm").write_text(ann.to_rttm())
        print(f"{uri}: {len(ann.labels())} speakers", flush=True)

    if args.ref_rttm:
        summary = score(load_rttm(args.ref_rttm), hyps)
        (out_dir / "der.json").write_text(json.dumps(summary, indent=2))
        print(json.dumps({k: v for k, v in summary.items() if k != "files"}, indent=2))
    return hyps


if __name__ == "__main__":
    main()
