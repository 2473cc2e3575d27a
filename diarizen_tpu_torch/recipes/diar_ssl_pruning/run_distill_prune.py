"""Joint distillation and structured pruning of a WavLM encoder (port of
recipes/diar_ssl_pruning/run_distill_prune.py).

The teacher comes from `[model.args] wavlm_src`: a preset name (seeded
random weights) or a reference-format `{config, state_dict}` file; the
student starts as its copy and carries HardConcrete gates. Training
minimises the distill loss plus the Lagrangian sparsity penalty in bfloat16;
`--further_distill` drops the sparsity objective and keeps distilling.
Each epoch appends its mean loss, expected and target sparsity and lambda1
to `metrics.jsonl` and saves a checkpoint (student, log-alphas, lambdas)
under `<exp>/checkpoints`, the experiment directory being
`<meta.save_dir>/<the TOML's stem>`.

    python -m diarizen_tpu_torch.recipes.diar_ssl_pruning.run_distill_prune \\
        -C recipes/diar_ssl_pruning/conf/s80_base.toml [--further_distill]

Each step runs under K1's exact f32 softmax schedule, the teacher's
forward included, as the JAX recipe's does. It runs on the CUDA device;
`main(argv, device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from diarizen_tpu_torch.config import load_toml
from diarizen_tpu_torch.logger import init_logging, log_config
from diarizen_tpu_torch.models.build import _wavlm
from diarizen_tpu_torch.models.wavlm import WavLM
from diarizen_tpu_torch.ops.flash_attention import softmax_mode_scope
from diarizen_tpu_torch.prune.distill import (
    DistillConfig,
    create_distill_prune_state,
    distill_state_dict,
    make_distill_prune_step,
)
from diarizen_tpu_torch.prune.gates import PruneConfig, init_gates
from diarizen_tpu_torch.train.checkpoint import append_metrics, save_checkpoint
from diarizen_tpu_torch.train.dataset import DataLoader, DiarizationDataset
from diarizen_tpu_torch.utils import resolve_device


def run(config: dict, exp_dir: Path, further_distill: bool = False, device=None,
        step_hook: Optional[Callable[[Dict], None]] = None) -> None:
    """`step_hook`, when given, is called with each step's metrics."""
    device = resolve_device(device)
    logger = init_logging(exp_dir)
    log_config(logger, config)
    margs = config["model"]["args"]
    seed = config.get("meta", {}).get("seed", 3407)

    wavlm_cfg, teacher = _wavlm(margs["wavlm_src"], seed)
    student = WavLM(wavlm_cfg)
    student.load_state_dict(teacher.state_dict())
    teacher.to(device)
    pcfg = PruneConfig(
        prune_conv_channels=margs.get("prune_conv_channels", False),
        prune_attention_heads=margs.get("prune_attention_heads", True),
        prune_attention_layer=margs.get("prune_attention_layer", True),
        prune_feed_forward_intermediate=margs.get("prune_feed_forward_intermediate", True),
        prune_feed_forward_layer=margs.get("prune_feed_forward_layer", True),
    )
    gates = init_gates(wavlm_cfg, pcfg, torch.Generator().manual_seed(seed + 1))

    targs = config["trainer"]["args"]
    ds_args = config["train_dataset"]["args"]
    dataset = DiarizationDataset(
        scp_file=ds_args["scp_file"], rttm_file=ds_args["rttm_file"],
        uem_file=ds_args["uem_file"],
        model_num_frames=wavlm_cfg.num_frames(int(ds_args.get("chunk_size", 8) * 16000)),
        model_rf_duration=0.025, model_rf_step=0.02,
        chunk_size=ds_args.get("chunk_size", 8), chunk_shift=ds_args.get("chunk_shift", 8))
    loader = DataLoader(dataset, batch_size=config["train_dataset"]["dataloader"]["batch_size"],
                        shuffle=True, seed=seed)
    steps_per_epoch = max(len(loader), 1)

    dcfg = DistillConfig(
        l2_weight=targs.get("l2_weight", 0.0),
        l1_weight=targs.get("l1_weight", 1.0),
        cos_weight=targs.get("cos_weight", 1.0),
        distill_layers=tuple(targs.get("distill_layers", [0, 4, 8, 12])),
        target_sparsity=0.0 if further_distill else targs.get("target_sparsity", 0.8),
        pre_train_updates=targs.get("pre_train_epochs", 0) * steps_per_epoch,
        sparsity_warmup_updates=targs.get("sparsity_warmup_epochs", 5) * steps_per_epoch,
        distill_lr=targs.get("distill_lr", 2e-4),
        reg_lr=targs.get("reg_lr", 2e-2),
        use_reg=not further_distill,
    )
    state = create_distill_prune_state(student, gates, dcfg, device)
    step = make_distill_prune_step(wavlm_cfg, dcfg, teacher)

    for epoch in range(targs.get("max_epochs", 30)):
        loader.set_epoch(epoch)
        t0 = time.time()
        losses = []
        for batch in loader:
            with softmax_mode_scope("f32"):  # the teacher's exact softmax
                metrics = step(state, batch["xs"][:, 0, :], seed)  # the SDM channel
            if step_hook is not None:
                step_hook(metrics)
            losses.append(metrics["loss"])
        record = {
            "epoch": epoch,
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "sparsity_expected": metrics["sparsity_expected"],
            "sparsity_target": metrics["sparsity_target"],
            "lambda1": metrics["lambda1"],
            "epoch_seconds": time.time() - t0,
        }
        append_metrics(exp_dir, record)
        logger.info("epoch %d: %s", epoch, json.dumps(record))
        save_checkpoint(exp_dir / "checkpoints", epoch, distill_state_dict(state), meta=record,
                        max_keep=targs.get("max_num_checkpoints", 100))


def main(argv: Optional[Sequence[str]] = None, device=None,
         step_hook: Optional[Callable[[Dict], None]] = None) -> Path:
    """Runs the recipe; returns the experiment directory."""
    parser = argparse.ArgumentParser(
        "python -m diarizen_tpu_torch.recipes.diar_ssl_pruning.run_distill_prune")
    parser.add_argument("-C", "--configuration", required=True)
    parser.add_argument("--further_distill", action="store_true")
    args = parser.parse_args(argv)
    config_path = Path(args.configuration).resolve()
    config = load_toml(config_path)
    exp_dir = Path(config.get("meta", {}).get("save_dir", "exp")) / config_path.stem
    run(config, exp_dir, args.further_distill, device, step_hook)
    return exp_dir


if __name__ == "__main__":
    main()
