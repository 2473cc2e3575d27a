"""Collapse the HardConcrete gates of a distill-prune run into a smaller
WavLM (port of recipes/diar_ssl_pruning/apply_pruning.py).

Averages the N best-loss checkpoints after the loss peak (pruning first
raises the loss; after its peak the sparsity has settled), runs the
surgery, and writes the pruned WavLM as the JAX package writes it:
`params.npz` (its pytree layout) and `config.json`
(`dataclasses.asdict` of the config), plus `report.json` with the
parameters in millions, the sparsity and the MACs per second of audio
before and after.

    python -m diarizen_tpu_torch.recipes.diar_ssl_pruning.apply_pruning \\
        -C recipes/diar_ssl_pruning/conf/s80_base.toml --out_dir pruned/ [--avg_ckpt_num 5]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from diarizen_tpu_torch.config import load_toml
from diarizen_tpu_torch.models.build import _load_wavlm
from diarizen_tpu_torch.models.convert import save_pytree, wavlm_params_to_jax
from diarizen_tpu_torch.models.wavlm import count_macs, count_params
from diarizen_tpu_torch.prune.distill import split_distill_state_dict
from diarizen_tpu_torch.prune.surgery import apply_pruning
from diarizen_tpu_torch.train.checkpoint import (
    average_checkpoints,
    list_checkpoints,
    load_metrics,
)


def select_post_peak(metrics: List[Dict], ckpt_root, num: int = 5,
                     metric: str = "loss") -> List[Path]:
    """The `num` best checkpoints by `metric` from the epoch of its peak on."""
    existing = {int(p.name.split("_")[1]): p for p in list_checkpoints(ckpt_root)}
    rows = [m for m in metrics if m.get("epoch") in existing and metric in m]
    if not rows:
        return []
    rows = sorted(rows, key=lambda m: m["epoch"])
    peak_i = int(np.argmax([m[metric] for m in rows]))
    post = sorted(rows[peak_i:], key=lambda m: m[metric])[:num]
    return [existing[m["epoch"]] for m in post]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the recipe; returns the report."""
    parser = argparse.ArgumentParser(
        "python -m diarizen_tpu_torch.recipes.diar_ssl_pruning.apply_pruning")
    parser.add_argument("-C", "--configuration", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--avg_ckpt_num", type=int, default=5)
    args = parser.parse_args(argv)

    config_path = Path(args.configuration).resolve()
    config = load_toml(config_path)
    exp_dir = Path(config.get("meta", {}).get("save_dir", "exp")) / config_path.stem
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    wavlm_cfg, _ = _load_wavlm(config["model"]["args"]["wavlm_src"])
    ckpts = select_post_peak(load_metrics(exp_dir), exp_dir / "checkpoints",
                             num=args.avg_ckpt_num)
    if not ckpts:
        raise RuntimeError(f"no checkpoints to average under {exp_dir}/checkpoints")
    print(f"averaging {[c.name for c in ckpts]}")
    student, log_alphas, _ = split_distill_state_dict(average_checkpoints(ckpts),
                                                      wavlm_cfg.num_layers)

    teacher_params = count_params(student)
    pruned, pruned_cfg = apply_pruning(student, wavlm_cfg, log_alphas)
    student_params = count_params(pruned)
    save_pytree(out_dir / "params.npz", wavlm_params_to_jax(pruned, pruned_cfg))
    (out_dir / "config.json").write_text(json.dumps(dataclasses.asdict(pruned_cfg), indent=2))
    report = {
        "original_params_M": teacher_params / 1e6,
        "pruned_params_M": student_params / 1e6,
        "sparsity": 1 - student_params / teacher_params,
        "original_macs_G_per_s": count_macs(wavlm_cfg) / 1e9,
        "pruned_macs_G_per_s": count_macs(pruned_cfg) / 1e9,
        "checkpoints": [c.name for c in ckpts],
    }
    (out_dir / "report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
