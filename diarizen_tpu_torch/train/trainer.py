"""Epoch-driven trainer for EEND segmentation (port of
diarizen_tpu/train/trainer.py).

Per epoch: the train steps (NaN-batch skips counted, the mean loss and
gradient norm over the good batches); every `validation_interval` epochs a
validation pass accumulating the DER components on the device with one host
sync at the end; early stopping on the monitored value ("loss" or "der",
"min" or "max") with patience; a checkpoint every epoch, garbage-collected
to the newest `max_num_checkpoints` with the best epoch protected; metrics
as JSON lines; resume from the latest checkpoint; TensorBoard scalars when
TensorBoard is installed. Runs on the CUDA device unless `device="cpu"` is
passed. `step_hook`, when given, is called with each train step's metrics.
`train_step_fn` replaces the train step (`mc_train_step` for the
multi-channel model); with `channel_sampler` (a callable returning an int) it
is also given `num_channels=` a value drawn before each step, the random
channel truncation of multi-channel training.

Data parallel: in a process group, each process trains on its stripe of
the data (the DataLoader's `rank` / `world_size`), the train step averages
gradients and loss over the processes, validation sums its totals over
them, and only process 0 writes checkpoints, metrics and TensorBoard.

`mesh=` (the JAX trainer's; `parallel/mesh.py`): the caller stripes the
data by the data axis (the DataLoader's `rank` = the mesh's data index,
`world_size` = its n_data), the model is split over the model axis
(`shard_model_`, before the optimizer's first step) and holds the mesh from
then on, which the train step, validation's sum over the data axis and the
checkpoints read. Checkpoints hold the full reference layout, model and
optimizer state gathered from the model ranks, the same files as without a
mesh; resuming under a mesh cuts each rank's slices from them.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn

from diarizen_tpu_torch.ops.flash_attention import softmax_mode_scope
from diarizen_tpu_torch.parallel.distributed import all_reduce_sum, is_main_process
from diarizen_tpu_torch.parallel.mesh import (
    Mesh,
    gather_state,
    local_state,
    model_mesh,
    shard_model_,
)
from diarizen_tpu_torch.train.checkpoint import (
    append_metrics,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from diarizen_tpu_torch.train.step import create_train_state, eval_step, train_step

logger = logging.getLogger("diarizen_tpu_torch.trainer")

VAL_KEYS = ("false_alarm", "missed_detection", "confusion", "speech_total", "loss_sum",
            "num_chunks")


@dataclass
class TrainerConfig:
    exp_dir: str = "exp/default"
    max_epochs: int = 100
    patience: int = 10  # early stop after this many epochs without improvement
    monitor: str = "loss"  # "loss" | "der"
    max_num_checkpoints: int = 100
    compute_dtype: str = "bfloat16"
    log_every: int = 50
    seed: int = 3407
    validation_interval: int = 1  # validate every N epochs
    monitor_mode: str = "min"  # "min" | "max"


class Trainer:
    def __init__(self, model: nn.Module, trainer_cfg: TrainerConfig, optimizer, device=None,
                 step_hook: Optional[Callable[[Dict], None]] = None,
                 train_step_fn: Callable = train_step,
                 channel_sampler: Optional[Callable[[], int]] = None,
                 mesh: Optional[Mesh] = None):
        self.tc = trainer_cfg
        if mesh is not None:  # from here on the model holds its mesh
            shard_model_(model, mesh)
        self.step_hook = step_hook
        self.train_step_fn = train_step_fn
        self.channel_sampler = channel_sampler
        self.state = create_train_state(model, optimizer, device)
        self.compute_dtype = (torch.bfloat16 if trainer_cfg.compute_dtype == "bfloat16"
                              else torch.float32)
        self.exp_dir = Path(trainer_cfg.exp_dir)
        self.ckpt_root = self.exp_dir / "checkpoints"
        self.main_process = is_main_process()
        self.start_epoch = 0
        self.best_score = float("inf")
        self.best_epoch = -1
        self.epochs_without_improvement = 0
        self.tb = None
        if self.main_process:
            self.exp_dir.mkdir(parents=True, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(str(self.exp_dir / "tb"))
            except Exception:  # TensorBoard is optional
                pass

    @property
    def model(self) -> nn.Module:
        return self.state.model

    def _log_scalar(self, name: str, value: float, step: int) -> None:
        if self.tb is not None:
            self.tb.add_scalar(name, value, step)

    def _append_metrics(self, record: Dict) -> None:
        if self.main_process:
            append_metrics(self.exp_dir, record)

    def _meta(self, extra: Optional[Dict] = None) -> Dict:
        return {"step": self.state.step, "best_score": self.best_score,
                "best_epoch": self.best_epoch,
                "epochs_without_improvement": self.epochs_without_improvement, **(extra or {})}

    def _full(self, tree):
        """A state tree in the full layout (gathered over the model axis:
        every rank takes part)."""
        mesh = model_mesh(self.model)
        return tree if mesh is None else gather_state(tree, self.model, mesh)

    def _local(self, tree):
        mesh = model_mesh(self.model)
        return tree if mesh is None else local_state(tree, self.model, mesh)

    def save(self, epoch: int, extra: Optional[Dict] = None) -> Optional[Path]:
        state_dict = self._full(self.model.state_dict())
        optimizer_state = self._full(self.state.optimizer.state_dict())
        if not self.main_process:
            return None
        return save_checkpoint(
            self.ckpt_root, epoch, state_dict, optimizer_state,
            meta=self._meta(extra), max_keep=self.tc.max_num_checkpoints,
            protect={self.best_epoch} if self.best_epoch >= 0 else None)

    def resume(self) -> bool:
        ckpt = latest_checkpoint(self.ckpt_root)
        if ckpt is None:
            return False
        state_dict, optimizer_state, meta = load_checkpoint(ckpt)
        self.model.load_state_dict(self._local(state_dict))
        if optimizer_state is not None:
            self.state.optimizer.load_state_dict(self._local(optimizer_state))
        self.state.step = int(meta.get("step", 0))
        self.start_epoch = meta["epoch"] + 1
        self.best_score = meta.get("best_score", float("inf"))
        self.best_epoch = meta.get("best_epoch", -1)
        self.epochs_without_improvement = meta.get("epochs_without_improvement", 0)
        logger.info("resumed from %s (epoch %d)", ckpt, self.start_epoch)
        return True

    def train_epoch(self, loader: Iterable, epoch: int) -> Dict[str, float]:
        loss_sum = norm_sum = 0.0
        good = skipped = n = 0
        t0 = time.time()
        for i, batch in enumerate(loader):
            # the step under K1's exact f32 softmax, and validation too, so
            # that checkpoint selection does not depend on the serving
            # schedule; the scope restores the process's schedule on exit
            with softmax_mode_scope("f32"):
                extra = {} if self.channel_sampler is None else {
                    "num_channels": int(self.channel_sampler())}
                m = self.train_step_fn(self.state, batch, self.tc.seed, self.compute_dtype,
                                       **extra)
            if self.step_hook is not None:
                self.step_hook(m)
            n += 1
            if m["skipped"]:
                skipped += 1
            else:
                good += 1
                loss_sum += m["loss"]
                norm_sum += m["grad_norm"]
            if (i + 1) % self.tc.log_every == 0:
                self._log_scalar("train/loss", m["loss"], self.state.step)
                self._log_scalar("train/grad_norm", m["grad_norm"], self.state.step)
                logger.info("epoch %d step %d loss %.4f grad_norm %.3f", epoch,
                            self.state.step, m["loss"], m["grad_norm"])
        return {
            "train_loss": loss_sum / max(good, 1) if n else float("nan"),
            "train_grad_norm": norm_sum / max(good, 1) if n else float("nan"),
            "skipped_batches": skipped,
            "train_batches": n,
            "epoch_seconds": time.time() - t0,
        }

    def validate(self, loader: Iterable) -> Dict[str, float]:
        acc = None
        for batch in loader:
            with softmax_mode_scope("f32"):  # see train_epoch
                m = eval_step(self.model, batch, self.compute_dtype)
            acc = m if acc is None else {k: acc[k] + m[k] for k in VAL_KEYS}
        if acc is None:
            raise ValueError("the validation loader yielded no batch")
        # summed over the data axis: every metric is a ratio of these sums
        mesh = model_mesh(self.model)
        totals = all_reduce_sum(torch.stack([acc[k] for k in VAL_KEYS]),
                                None if mesh is None else mesh.data_group).tolist()  # one sync
        t = dict(zip(VAL_KEYS, totals))
        speech = max(t["speech_total"], 1e-9)
        return {
            "loss": t["loss_sum"] / max(t["num_chunks"], 1.0),
            "der": (t["false_alarm"] + t["missed_detection"] + t["confusion"]) / speech,
            "false_alarm": t["false_alarm"] / speech,
            "missed_detection": t["missed_detection"] / speech,
            "confusion": t["confusion"] / speech,
        }

    def train(self, train_loader, val_loader) -> Dict[str, float]:
        last_val: Dict[str, float] = {}
        for epoch in range(self.start_epoch, self.tc.max_epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            train_metrics = self.train_epoch(train_loader, epoch)
            if (epoch + 1) % self.tc.validation_interval != 0:
                # a checkpoint every epoch, validated or not
                self._append_metrics({"epoch": epoch, **train_metrics, "step": self.state.step})
                self.save(epoch)
                continue
            val = self.validate(val_loader)
            last_val = val
            logger.info("Validation Loss/DER on epoch %d: %.4f / %.4f", epoch, val["loss"],
                        val["der"])
            for k, v in val.items():
                self._log_scalar(f"val/{k}", v, self.state.step)
            score = val[self.tc.monitor]
            if self.tc.monitor_mode == "max":
                score = -score
            improved = score < self.best_score
            if improved:
                self.best_score, self.best_epoch = score, epoch
                self.epochs_without_improvement = 0
            else:
                self.epochs_without_improvement += 1
            self._append_metrics({"epoch": epoch, **train_metrics, **val, "best": improved,
                                  "step": self.state.step})
            self.save(epoch, val)
            if self.epochs_without_improvement >= self.tc.patience:
                logger.info("early stop at epoch %d (no %s improvement for %d epochs)",
                            epoch, self.tc.monitor, self.tc.patience)
                break
        return last_val
