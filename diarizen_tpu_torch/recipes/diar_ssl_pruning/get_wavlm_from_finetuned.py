"""Take the averaged WavLM trunk out of a fine-tuned diarization experiment
(port of recipes/diar_ssl_pruning/get_wavlm_from_finetuned.py).

Averages the N best checkpoints of an experiment of
`diarizen_tpu_torch.recipes.diar_ssl.run` by a validation metric and writes
the `wavlm_model.*` weights as the JAX package writes a WavLM:
`params.npz` (its pytree layout) and `config.json`.

    python -m diarizen_tpu_torch.recipes.diar_ssl_pruning.get_wavlm_from_finetuned \\
        --exp_dir exp/wavlm_updated_conformer --wavlm_src wavlm_base \\
        --out_dir wavlm_finetuned/ [--avg_ckpt_num 5] [--avg_metric loss]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Optional, Sequence

from diarizen_tpu_torch.models.build import _load_wavlm
from diarizen_tpu_torch.models.convert import save_pytree, wavlm_params_to_jax
from diarizen_tpu_torch.train.checkpoint import (
    average_checkpoints,
    load_metrics,
    select_checkpoints,
)

TRUNK = "wavlm_model."


def main(argv: Optional[Sequence[str]] = None) -> Path:
    """Runs the recipe; returns the output directory."""
    parser = argparse.ArgumentParser(
        "python -m diarizen_tpu_torch.recipes.diar_ssl_pruning.get_wavlm_from_finetuned")
    parser.add_argument("--exp_dir", required=True)
    parser.add_argument("--wavlm_src", default="wavlm_base")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--avg_ckpt_num", type=int, default=5)
    parser.add_argument("--avg_metric", default="loss")
    args = parser.parse_args(argv)

    exp_dir = Path(args.exp_dir)
    ckpts = select_checkpoints(load_metrics(exp_dir), exp_dir / "checkpoints",
                               num=args.avg_ckpt_num, metric=args.avg_metric)
    if not ckpts:
        raise RuntimeError(f"no checkpoints to average under {exp_dir}/checkpoints")
    print(f"averaging {[c.name for c in ckpts]}")
    trunk = {k[len(TRUNK):]: v for k, v in average_checkpoints(ckpts).items()
             if k.startswith(TRUNK)}
    if not trunk:
        raise RuntimeError("the checkpoints hold no WavLM trunk")

    cfg, _ = _load_wavlm(args.wavlm_src)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_pytree(out / "params.npz", wavlm_params_to_jax(trunk, cfg))
    (out / "config.json").write_text(json.dumps(dataclasses.asdict(cfg), indent=2))
    print(f"saved the WavLM trunk to {out}")
    return out


if __name__ == "__main__":
    main()
