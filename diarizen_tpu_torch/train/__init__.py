"""Training of the EEND segmentation model (port of diarizen_tpu/train)."""

from diarizen_tpu_torch.train.loss import der_metrics, segmentation_loss
from diarizen_tpu_torch.train.optim import (
    AutoClip,
    Optimizer,
    adamw_with_warmup,
    dual_lr_optimizer,
    warmup_schedule,
    with_gradient_accumulation,
)
from diarizen_tpu_torch.train.step import (
    TrainState,
    create_train_state,
    eval_step,
    mc_train_step,
    train_step,
)
from diarizen_tpu_torch.train.trainer import Trainer, TrainerConfig

__all__ = [
    "der_metrics", "segmentation_loss", "AutoClip", "Optimizer", "adamw_with_warmup",
    "dual_lr_optimizer", "warmup_schedule", "with_gradient_accumulation", "TrainState",
    "create_train_state", "eval_step", "mc_train_step", "train_step", "Trainer", "TrainerConfig",
]
