"""Train or validate the multi-channel diarization model from a recipe TOML
(port of recipes/diar_ssl_mc/run.py).

As `recipes.diar_ssl.run`, with the multi-channel dataset (recordings padded
by wrapping or truncated to `num_channels`, `channel_mode = "multichannel"`
by default), the random channel truncation k in [1, num_channels] drawn
before each step from a generator seeded by `[meta] seed`, and a fine-tune
branch that keeps the model's freshly initialised fusions when the
`[finetune]` checkpoints are of a single-channel model.

    python -m diarizen_tpu_torch.recipes.diar_ssl_mc.run \\
        -C recipes/diar_ssl_mc/conf/wavlm_mc_chatt.toml -M train|validate

It runs on the CUDA device; `main(argv, device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from diarizen_tpu_torch.config import instantiate
from diarizen_tpu_torch.recipes.diar_ssl.run import (
    build_optimizer,
    fit,
    parse_args,
    start,
    trainer_config,
)
from diarizen_tpu_torch.train.checkpoint import average_checkpoints
from diarizen_tpu_torch.train.step import mc_train_step
from diarizen_tpu_torch.train.trainer import Trainer


def run(config: dict, mode: str, exp_dir: Path, device=None, step_hook=None) -> Dict[str, float]:
    """Train or validate; returns the last validation metrics."""
    logger = start(config, exp_dir)
    seed = config.get("meta", {}).get("seed", 3407)
    cfg, model = instantiate(config["model"]["path"], config["model"].get("args", {}), seed=seed)
    finetune = config.get("finetune", {})
    if finetune.get("finetune") and finetune.get("checkpoints"):
        # a single-channel checkpoint has no fusions: those stay as built
        fusions = {k: v for k, v in model.state_dict().items() if k.startswith("channel_fusions.")}
        model.load_state_dict({**fusions, **average_checkpoints(finetune["checkpoints"])})
        logger.info("finetuning from %d averaged checkpoints", len(finetune["checkpoints"]))

    channel_rng = np.random.default_rng(seed)
    trainer = Trainer(model, trainer_config(config, exp_dir, seed), build_optimizer(config, model),
                      device=device, step_hook=step_hook, train_step_fn=mc_train_step,
                      channel_sampler=lambda: int(channel_rng.integers(1, cfg.num_channels + 1)))
    final = fit(trainer, config, cfg, mode, seed, num_channels=cfg.num_channels,
                channel_mode="multichannel")
    logger.info("%s done: %s", mode, final)
    return final


def main(argv: Optional[Sequence[str]] = None, device=None, step_hook=None) -> Dict[str, float]:
    config, mode, exp_dir = parse_args("python -m diarizen_tpu_torch.recipes.diar_ssl_mc.run",
                                       argv)
    return run(config, mode, exp_dir, device, step_hook)


if __name__ == "__main__":
    main()
