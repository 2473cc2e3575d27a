"""Structured pruning and distillation of WavLM (port of diarizen_tpu/prune):
HardConcrete gates, the Lagrangian distill-prune step and the surgery that
collapses the gates into a smaller WavLM."""

from diarizen_tpu_torch.prune.distill import (
    DistillConfig,
    DistillPruneModel,
    DistillPruneState,
    create_distill_prune_state,
    distill_loss,
    make_distill_prune_optimizer,
    make_distill_prune_step,
)
from diarizen_tpu_torch.prune.gates import (
    PruneConfig,
    compile_gates,
    expected_num_params,
    init_gates,
    sample_gates,
)
from diarizen_tpu_torch.prune.hardconcrete import (
    compiled_mask,
    init_log_alpha,
    l0_norm,
    sample_mask,
)
from diarizen_tpu_torch.prune.surgery import apply_pruning, count_params_pytree

__all__ = [
    "DistillConfig", "DistillPruneModel", "DistillPruneState", "create_distill_prune_state",
    "distill_loss", "make_distill_prune_optimizer", "make_distill_prune_step",
    "PruneConfig", "compile_gates", "expected_num_params", "init_gates",
    "sample_gates", "compiled_mask", "init_log_alpha", "l0_norm", "sample_mask",
    "apply_pruning", "count_params_pytree",
]
