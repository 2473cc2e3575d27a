"""Checkpoint save / load / garbage collection / averaging and structured
metric summaries (port of diarizen_tpu/train/checkpoint.py).

A checkpoint is a directory `<root>/epoch_NNNN/` holding
  * `pytorch_model.bin`: the model's `state_dict` in the reference key
    layout (BatchNorm running statistics included), so a trained checkpoint
    loads straight into the serving `EendModel`;
  * `optimizer.pt`: the optimizer state (moments, schedule counts, the
    AutoClip history), when given;
  * `meta.json`: the epoch and the trainer's bookkeeping.
Validation metrics are kept as JSON lines in `<exp>/metrics.jsonl`.
"""

from __future__ import annotations

import json
import re
import shutil
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

PathLike = Union[str, Path]
MODEL_FILE = "pytorch_model.bin"
OPTIMIZER_FILE = "optimizer.pt"


def save_checkpoint(ckpt_root: PathLike, epoch: int, state_dict: Dict[str, torch.Tensor],
                    optimizer_state: Optional[Dict] = None, meta: Optional[Dict] = None,
                    max_keep: Optional[int] = None, protect: Optional[set] = None) -> Path:
    """`protect`: epochs garbage collection never deletes (the trainer
    passes its best epoch)."""
    ckpt_dir = Path(ckpt_root) / f"epoch_{epoch:04d}"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, ckpt_dir / MODEL_FILE)
    if optimizer_state is not None:
        torch.save(_to_cpu(optimizer_state), ckpt_dir / OPTIMIZER_FILE)
    (ckpt_dir / "meta.json").write_text(json.dumps({"epoch": epoch, **(meta or {})}))
    if max_keep is not None:
        gc_checkpoints(ckpt_root, max_keep, protect=protect)
    return ckpt_dir


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def list_checkpoints(ckpt_root: PathLike) -> List[Path]:
    root = Path(ckpt_root)
    if not root.exists():
        return []
    return sorted(p for p in root.iterdir() if re.fullmatch(r"epoch_\d{4}", p.name))


def gc_checkpoints(ckpt_root: PathLike, max_keep: int, protect: Optional[set] = None) -> None:
    """Delete all but the newest `max_keep` checkpoints, sparing `protect`."""
    protected = {f"epoch_{e:04d}" for e in (protect or ())}
    for stale in list_checkpoints(ckpt_root)[:-max_keep]:
        if stale.name not in protected:
            shutil.rmtree(stale)


def load_checkpoint(ckpt_dir: PathLike):
    """(state_dict, optimizer_state or None, meta), tensors on the CPU."""
    ckpt_dir = Path(ckpt_dir)
    state_dict = torch.load(ckpt_dir / MODEL_FILE, map_location="cpu", weights_only=True)
    opt_path = ckpt_dir / OPTIMIZER_FILE
    optimizer_state = (torch.load(opt_path, map_location="cpu", weights_only=True)
                       if opt_path.exists() else None)
    meta = json.loads((ckpt_dir / "meta.json").read_text())
    return state_dict, optimizer_state, meta


def latest_checkpoint(ckpt_root: PathLike) -> Optional[Path]:
    ckpts = list_checkpoints(ckpt_root)
    return ckpts[-1] if ckpts else None


def average_checkpoints(ckpt_dirs: Sequence[PathLike]) -> Dict[str, torch.Tensor]:
    """Uniform average of the model state dicts of checkpoint directories:
    floating tensors in float64, cast back; other tensors (counters) from
    the first."""
    if not ckpt_dirs:
        raise ValueError("nothing to average")
    state_dicts = [torch.load(Path(d) / MODEL_FILE, map_location="cpu", weights_only=True)
                   for d in ckpt_dirs]
    out = {}
    for key, first in state_dicts[0].items():
        if first.is_floating_point():
            stacked = torch.stack([sd[key].double() for sd in state_dicts])
            out[key] = stacked.mean(dim=0).to(first.dtype)
        else:
            out[key] = first.clone()
    return out


def append_metrics(exp_dir: PathLike, record: Dict) -> None:
    with open(Path(exp_dir) / "metrics.jsonl", "a") as fh:
        fh.write(json.dumps(record) + "\n")


def load_metrics(exp_dir: PathLike) -> List[Dict]:
    path = Path(exp_dir) / "metrics.jsonl"
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def select_checkpoints(metrics: List[Dict], ckpt_root: PathLike, num: int = 5,
                       metric: str = "der", mode: str = "best") -> List[Path]:
    """Checkpoint directories to average. mode 'best': the `num` lowest
    epochs by `metric`; 'prev': the `num` epochs ending at the best one in
    epoch order; 'center': best +- num // 2. Slices are clamped at epoch 0;
    only epochs whose checkpoint exists count; a short selection warns."""
    existing = {int(p.name.split("_")[1]): p for p in list_checkpoints(ckpt_root)}
    rows = [m for m in metrics if m.get("epoch") in existing and metric in m]
    if not rows:
        return []
    if mode == "best":
        rows = sorted(rows, key=lambda m: m[metric])[:num]
    elif mode in ("prev", "center"):
        rows_sorted = sorted(rows, key=lambda m: m["epoch"])
        best_i = int(np.argmin([m[metric] for m in rows_sorted]))
        if mode == "prev":
            lo, hi = best_i - num + 1, best_i + 1
        else:
            lo, hi = best_i - num // 2, best_i + num // 2 + 1
        rows = rows_sorted[max(0, lo): hi]
    else:
        raise ValueError(f"unknown mode {mode}")
    if len(rows) < num:
        warnings.warn(f"select_checkpoints(mode={mode!r}): only {len(rows)} of the requested "
                      f"{num} checkpoints exist; averaging {len(rows)}", stacklevel=2)
    return [existing[m["epoch"]] for m in rows]
