"""Checkpoint-averaged multi-channel inference and DER scoring (port of
recipes/diar_ssl_mc/infer.py).

Averages the N best / previous / centred checkpoints of an experiment,
diarizes a wav.scp of multi-channel recordings through the serving path,
`DiarizationPipeline.stream` (a recording with fewer than `--num_channels`
channels is padded by wrapping its channels around, one with more is cut;
`SlidingInference.prepare_wave`), writes one RTTM per recording and, with a
reference RTTM, scores DER (collar 0, overlap scored) into `der.json`.

    python -m diarizen_tpu_torch.recipes.diar_ssl_mc.infer \\
        -C recipes/diar_ssl_mc/conf/wavlm_mc_chatt.toml \\
        --exp_dir exp/wavlm_mc_chatt --wav_scp data/test/wav.scp \\
        --ref_rttm data/test/rttm --out_dir exp/infer --num_channels 8 \\
        [--avg_ckpt_num 5] [--embedding_ckpt resnet34.bin] [--max_files N]

It runs on the CUDA device; `main(argv, device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

from diarizen_tpu_torch.config import load_toml
from diarizen_tpu_torch.core.audio import read_audio
from diarizen_tpu_torch.core.io_rttm import load_rttm, load_scp
from diarizen_tpu_torch.infer import DiarizationPipeline, EmbeddingInference, SlidingInference
from diarizen_tpu_torch.logger import init_logging
from diarizen_tpu_torch.pipelines import load_resnet
from diarizen_tpu_torch.recipes.diar_ssl.infer import (
    Device,
    build_clustering,
    load_averaged_model,
    score,
)
from diarizen_tpu_torch.utils import resolve_device


def build_pipeline(args: argparse.Namespace, config: dict,
                   device: Device = None) -> DiarizationPipeline:
    device = resolve_device(device)
    cfg, model = load_averaged_model(args, config)
    inference_args = config.get("inference", {}).get("args", {})
    batch_size = inference_args.get("batch_size", 16)
    seg_inf = SlidingInference(model, duration=float(inference_args.get("seg_duration", 8)),
                               batch_size=batch_size, device=device,
                               num_channels=args.num_channels)
    if not args.embedding_ckpt:
        print("WARNING: no --embedding_ckpt; random embedding weights (smoke mode)")
    emb_inf = EmbeddingInference(load_resnet(args.embedding_ckpt or None),
                                 window_size=seg_inf.window_size,
                                 num_speakers=cfg.max_speakers_per_chunk,
                                 batch_size=batch_size, device=device)
    cl = config.get("clustering", {}).get("args", {})
    return DiarizationPipeline(
        seg_inference=seg_inf, emb_inference=emb_inf,
        clustering=build_clustering(cl, cl.get("method", "VBxClustering"), fa=0.06, fb=0.9),
        eend_cfg=cfg, min_speakers=cl.get("min_speakers", 1),
        max_speakers=cl.get("max_speakers", 8),
        apply_median_filtering=inference_args.get("apply_median_filtering", True),
        embedding_exclude_overlap=False,  # the multi-channel recipe embeds with plain masks
    )


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("python -m diarizen_tpu_torch.recipes.diar_ssl_mc.infer")
    parser.add_argument("-C", "--configuration", required=True)
    parser.add_argument("--exp_dir", required=True)
    parser.add_argument("--wav_scp", required=True)
    parser.add_argument("--ref_rttm", default=None)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--num_channels", type=int, default=8)
    parser.add_argument("--avg_ckpt_num", type=int, default=5)
    parser.add_argument("--avg_mode", default="best", choices=["best", "prev", "center"])
    parser.add_argument("--avg_metric", default="loss")
    parser.add_argument("--embedding_ckpt", default=None)
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

    scp = list(load_scp(args.wav_scp).items())[: args.max_files]

    def waves():
        for _, path in scp:
            wave, sr = read_audio(path)
            if sr != pipeline.seg_inference.sample_rate:
                raise ValueError(f"{path}: resample {sr} -> {pipeline.seg_inference.sample_rate}")
            yield wave

    hyps = {}
    uris = [uri for uri, _ in scp]
    for uri, ann in zip(uris, pipeline.stream(waves(), uris=uris)):
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
