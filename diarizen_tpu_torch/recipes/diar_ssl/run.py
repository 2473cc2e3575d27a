"""Train or validate a diarization segmentation model from a recipe TOML
(port of recipes/diar_ssl/run.py).

Builds the `[model]` section's model, loads the average of the `[finetune]`
checkpoints where asked, builds the dual-LR optimizer (`[optimizer_small]`
on WavLM, `[optimizer_big]` on the rest, or `freeze_wavlm`) or a single-LR
one (`[optimizer]`), with warmup, percentile AutoClip and gradient
accumulation from `[trainer.args]`, then resumes from the experiment's
latest checkpoint and trains or validates. The experiment directory is
`<meta.save_dir>/<the TOML's stem>`.

    python -m diarizen_tpu_torch.recipes.diar_ssl.run \\
        -C recipes/diar_ssl/conf/wavlm_updated_conformer.toml -M train|validate

It runs on the CUDA device; `main(argv, device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

from diarizen_tpu_torch.config import dump_toml, instantiate, load_toml
from diarizen_tpu_torch.logger import init_logging, log_config
from diarizen_tpu_torch.train.checkpoint import average_checkpoints
from diarizen_tpu_torch.train.dataset import DataLoader, DiarizationDataset
from diarizen_tpu_torch.train.optim import (
    adamw_with_warmup,
    dual_lr_optimizer,
    with_gradient_accumulation,
)
from diarizen_tpu_torch.train.trainer import Trainer, TrainerConfig


def build_dataset(section: dict, cfg, num_channels: int = 1,
                  channel_mode: str = "sdm") -> DiarizationDataset:
    """The dataset of a `[*_dataset]` section on the frame grid of `cfg`,
    the model's config of any family (its `num_frames` and `rf_info`);
    `num_channels` and `channel_mode` are the defaults of the section's own
    keys."""
    args = section["args"]
    step, duration = cfg.rf_info()
    chunk_size = args.get("chunk_size", cfg.chunk_size)
    return DiarizationDataset(
        scp_file=args["scp_file"], rttm_file=args["rttm_file"], uem_file=args["uem_file"],
        model_num_frames=cfg.num_frames(int(chunk_size * cfg.sample_rate)),
        model_rf_duration=duration, model_rf_step=step,
        chunk_size=chunk_size, chunk_shift=args.get("chunk_shift", 6),
        sample_rate=args.get("sample_rate", 16000),
        num_channels=args.get("num_channels", num_channels),
        channel_mode=args.get("channel_mode", channel_mode))


def build_optimizer(config: dict, model):
    trainer_args = config.get("trainer", {}).get("args", {})
    freeze_wavlm = trainer_args.get("freeze_wavlm", False)
    warmup = trainer_args.get("warmup_steps", 0)
    clip = trainer_args.get("gradient_percentile", 90)
    if "optimizer_small" in config or freeze_wavlm:
        # freeze_wavlm with a single [optimizer] (the frozen recipe) still
        # needs the split: the trunk stays, the rest moves at lr
        big = config.get("optimizer_big") or config.get("optimizer", {})
        small = config.get("optimizer_small", {}).get("args", {})
        optimizer = dual_lr_optimizer(
            model.param_groups(), lr_small=small.get("lr", 2e-5),
            lr_big=big.get("args", {}).get("lr", 1e-3), warmup_steps=warmup,
            clip_percentile=clip, freeze_wavlm=freeze_wavlm)
    else:
        optimizer = adamw_with_warmup(dict(model.named_parameters()),
                                      config["optimizer"]["args"].get("lr", 1e-3),
                                      warmup_steps=warmup, clip_percentile=clip)
    return with_gradient_accumulation(optimizer,
                                      trainer_args.get("gradient_accumulation_steps", 1))


def start(config: dict, exp_dir: Path) -> logging.Logger:
    """The experiment's log, and the config snapshot in its directory."""
    logger = init_logging(exp_dir)
    log_config(logger, config)
    dump_toml(config, exp_dir / "config.toml")
    return logger


def trainer_config(config: dict, exp_dir: Path, seed: int) -> TrainerConfig:
    trainer_args = config.get("trainer", {}).get("args", {})
    return TrainerConfig(
        exp_dir=str(exp_dir),
        max_epochs=trainer_args.get("max_epochs", 100),
        patience=trainer_args.get("max_patience", 10),
        max_num_checkpoints=trainer_args.get("max_num_checkpoints", 100),
        validation_interval=trainer_args.get("validation_interval", 1),
        monitor_mode="max" if trainer_args.get("save_max_score") else "min",
        compute_dtype=trainer_args.get("compute_dtype", "bfloat16"),
        seed=seed,
    )


def fit(trainer: Trainer, config: dict, cfg, mode: str, seed: int,
        **dataset_defaults) -> Dict[str, float]:
    """Resume from the experiment's latest checkpoint, then train and
    validate, or validate; returns the last validation metrics.
    `dataset_defaults`: `build_dataset`'s."""
    trainer.resume()
    val_loader = DataLoader(
        build_dataset(config["validate_dataset"], cfg, **dataset_defaults),
        batch_size=config["validate_dataset"]["dataloader"]["batch_size"], shuffle=False,
        max_speakers_per_chunk=cfg.max_speakers_per_chunk)
    if mode != "train":
        return trainer.validate(val_loader)
    train_loader = DataLoader(
        build_dataset(config["train_dataset"], cfg, **dataset_defaults),
        batch_size=config["train_dataset"]["dataloader"]["batch_size"], shuffle=True,
        seed=seed, max_speakers_per_chunk=cfg.max_speakers_per_chunk)
    return trainer.train(train_loader, val_loader)


def run(config: dict, mode: str, exp_dir: Path, device=None, step_hook=None) -> Dict[str, float]:
    """Train or validate; returns the last validation metrics."""
    logger = start(config, exp_dir)
    seed = config.get("meta", {}).get("seed", 3407)
    cfg, model = instantiate(config["model"]["path"], config["model"].get("args", {}), seed=seed)
    finetune = config.get("finetune", {})
    if finetune.get("finetune") and finetune.get("checkpoints"):
        model.load_state_dict(average_checkpoints(finetune["checkpoints"]))
        logger.info("finetuning from %d averaged checkpoints", len(finetune["checkpoints"]))

    trainer = Trainer(model, trainer_config(config, exp_dir, seed), build_optimizer(config, model),
                      device=device, step_hook=step_hook)
    final = fit(trainer, config, cfg, mode, seed)
    logger.info("%s done: %s", mode, final)
    return final


def parse_args(prog: str, argv: Optional[Sequence[str]] = None) -> Tuple[dict, str, Path]:
    """(config, mode, experiment directory) of `-C` / `-M`."""
    parser = argparse.ArgumentParser(prog)
    parser.add_argument("-C", "--configuration", required=True)
    parser.add_argument("-M", "--mode", default="train", choices=["train", "validate"])
    args = parser.parse_args(argv)
    config_path = Path(args.configuration).resolve()
    config = load_toml(config_path)
    return config, args.mode, Path(config.get("meta", {}).get("save_dir", "exp")) / config_path.stem


def main(argv: Optional[Sequence[str]] = None, device=None, step_hook=None) -> Dict[str, float]:
    config, mode, exp_dir = parse_args("python -m diarizen_tpu_torch.recipes.diar_ssl.run", argv)
    return run(config, mode, exp_dir, device, step_hook)


if __name__ == "__main__":
    main()
