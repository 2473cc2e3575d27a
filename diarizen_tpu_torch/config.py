"""Config system: TOML sections materialised by dynamic import (the port's
own copy of diarizen_tpu/config.py, with the alias table pointing at the
port).

Every TOML section has `path = "pkg.mod.ClassOrFn"` plus an `[section.args]`
table; CLI overrides change the dict before instantiation. tomllib is in the
standard library (3.11+).
"""

from __future__ import annotations

import copy
import importlib
import tomllib
from pathlib import Path
from typing import Any, Dict, Optional


def load_toml(path: str | Path) -> Dict[str, Any]:
    with open(path, "rb") as fh:
        return tomllib.load(fh)


def dump_toml(config: Dict[str, Any], path: str | Path) -> None:
    """Minimal TOML writer for the config snapshot written into an experiment
    directory. Handles the nested {section: {path, args: {...}}} shape plus
    scalars and lists."""

    def fmt(v: Any) -> str:
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, (int, float)):
            return repr(v)
        if isinstance(v, str):
            return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
        if isinstance(v, (list, tuple)):
            return "[" + ", ".join(fmt(x) for x in v) + "]"
        raise TypeError(f"cannot dump {type(v)}")

    lines = []

    def walk(table: Dict[str, Any], prefix: str) -> None:
        scalars = {k: v for k, v in table.items() if not isinstance(v, dict)}
        subtables = {k: v for k, v in table.items() if isinstance(v, dict)}
        if prefix and (scalars or not subtables):
            lines.append(f"[{prefix}]")
        for k, v in scalars.items():
            lines.append(f"{k} = {fmt(v)}")
        for k, v in subtables.items():
            walk(v, f"{prefix}.{k}" if prefix else k)

    walk(config, "")
    Path(path).write_text("\n".join(lines) + "\n")


# A released DiariZen snapshot's config.toml, and the reference's training
# TOMLs, name the REFERENCE's own classes (e.g. `[model] path =
# "diarizen.models.eend.model_wavlm_conformer.Model"`) and recipe-local
# modules ("trainer_dual_opt.Trainer", "dataset.DiarizationDataset"); this
# repository's recipe TOMLs (recipes/diar_ssl/conf) name the JAX package's
# factories and `optax.adamw`. Mapping them onto the port's factories and
# classes makes unedited snapshots and recipe TOMLs load without the JAX
# package.
REFERENCE_PATH_ALIASES = {
    "diarizen.models.eend.model_wavlm_conformer.Model":
        "diarizen_tpu_torch.models.build.wavlm_conformer",
    "trainer_dual_opt.Trainer": "diarizen_tpu_torch.train.trainer.Trainer",
    "trainer_single_opt.Trainer": "diarizen_tpu_torch.train.trainer.Trainer",
    "dataset.DiarizationDataset": "diarizen_tpu_torch.train.dataset.DiarizationDataset",
    "diarizen_tpu.models.build.wavlm_conformer":
        "diarizen_tpu_torch.models.build.wavlm_conformer",
    "diarizen.models.eend.model_wavlm_conformer_mc.Model":
        "diarizen_tpu_torch.models.build.wavlm_conformer_mc",
    "diarizen_tpu.models.build.wavlm_conformer_mc":
        "diarizen_tpu_torch.models.build.wavlm_conformer_mc",
    "diarizen_tpu.train.trainer.Trainer": "diarizen_tpu_torch.train.trainer.Trainer",
    "diarizen_tpu.train.dataset.DiarizationDataset":
        "diarizen_tpu_torch.train.dataset.DiarizationDataset",
    "optax.adamw": "diarizen_tpu_torch.train.optim.adamw_with_warmup",
    "diarizen.models.pruning.model_distill_prune.Model":
        "diarizen_tpu_torch.models.build.distill_prune",
    "diarizen.models.pruning.utils.DistillLoss":
        "diarizen_tpu_torch.prune.distill.distill_loss_fn",
    "diarizen_tpu.models.build.distill_prune": "diarizen_tpu_torch.models.build.distill_prune",
    "diarizen_tpu.prune.distill": "diarizen_tpu_torch.prune.distill",
    "diarizen_tpu.prune.distill.distill_loss_fn":
        "diarizen_tpu_torch.prune.distill.distill_loss_fn",
    "diarizen.models.eend.model_fbank_conformer.Model":
        "diarizen_tpu_torch.models.build.fbank_conformer",
    "diarizen_tpu.models.build.fbank_conformer": "diarizen_tpu_torch.models.build.fbank_conformer",
    "diarizen.models.eend.model_pyannote.Model":
        "diarizen_tpu_torch.models.build.pyannote_baseline",
    "diarizen_tpu.models.build.pyannote_baseline":
        "diarizen_tpu_torch.models.build.pyannote_baseline",
    "torch.optim.AdamW": "diarizen_tpu_torch.train.optim.adamw_torch_args",
    **{f"diarizen_tpu.train.optim.{name}": f"diarizen_tpu_torch.train.optim.{name}"
       for name in ("noam_schedule", "noam_adamw", "one_cycle_schedule", "reduce_on_plateau")},
    **{f"diarizen_tpu.utils.{name}": f"diarizen_tpu_torch.utils.{name}"
       for name in ("set_random_seed", "prepare_empty_dir", "clamp_inf_value", "Timer",
                    "print_env")},
    **{f"diarizen_tpu.parallel.distributed.{name}":
       f"diarizen_tpu_torch.parallel.distributed.{name}"
       for name in ("initialize_distributed", "is_main_process", "gather_to_host",
                    "broadcast_from_host", "process_window_shard", "reassemble_window_shards",
                    "gather_window_shards")},
    "diarizen_tpu.models.convert.wavlm_config_from_hf":
        "diarizen_tpu_torch.models.convert.wavlm_config_from_hf",
}


def resolve(path: str) -> Any:
    """'pkg.mod.Name' -> attribute. Reference and JAX-package paths are
    aliased to the port's factories and classes (REFERENCE_PATH_ALIASES); any
    other path into the JAX package raises NotImplementedError naming it,
    instead of importing the JAX package."""
    path = REFERENCE_PATH_ALIASES.get(path, path)
    if path.split(".")[0] == "diarizen_tpu":
        raise NotImplementedError(
            f"{path!r} has no counterpart in diarizen_tpu_torch: of the JAX package, the "
            "port lacks only parallel/mesh.py (make_mesh and the tensor-parallel `model` "
            "axis, eend_param_shardings); every model family, the trainer, dataset, "
            "optimizers and schedules, data parallelism and utils.py are ported")
    module_name, _, attr = path.rpartition(".")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def instantiate(path: str, args: Optional[Dict[str, Any]] = None, **extra) -> Any:
    """Import `path` and call it with args."""
    fn = resolve(path)
    return fn(**{**(args or {}), **extra})


def instantiate_section(config: Dict[str, Any], section: str, **extra) -> Any:
    sec = config[section]
    return instantiate(sec["path"], sec.get("args", {}), **extra)


def instantiate_model_for_inference(path: str, args: Optional[Dict[str, Any]] = None) -> Any:
    """Model-section instantiation for INFERENCE entry points
    (`from_pretrained`, the recipe infer CLIs): checkpoints loaded right
    after the build overwrite every weight, so a training-time `wavlm_src`
    path that doesn't resolve locally may fall back to the preset
    architecture. The `_allow_missing_wavlm_src` flag is injected only when
    the resolved factory actually accepts it (named param or **kwargs), so
    custom factories without the knob keep working."""
    fn = resolve(path)
    kwargs = dict(args or {})
    if "wavlm_src" in kwargs:
        import inspect

        try:
            params = inspect.signature(fn).parameters
            if "_allow_missing_wavlm_src" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
            ):
                kwargs["_allow_missing_wavlm_src"] = True
        except (TypeError, ValueError):
            pass
    return fn(**kwargs)


def apply_overrides(config: Dict[str, Any], overrides: Dict[str, Any]) -> Dict[str, Any]:
    """Apply {'a.b.c': value} dotted-path overrides to a nested config copy."""
    out = copy.deepcopy(config)
    for dotted, value in overrides.items():
        node = out
        *parents, leaf = dotted.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out
