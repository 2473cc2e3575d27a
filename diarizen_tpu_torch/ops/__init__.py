"""Operators: kernels K1-K5 and the host-side numpy stages."""

import torch

from diarizen_tpu_torch.ops.conv_chain import use_conv_chain
from diarizen_tpu_torch.ops.flash_attention import softmax_mode
from diarizen_tpu_torch.ops.fused_ln import use_fused_ln


def forward_switches() -> tuple:
    """The process state that a forward reads when it runs, and that a
    captured CUDA graph keeps as it was at its capture: K1's softmax
    schedule, the fused-LN (K3, K4) and conv-chain (K5) switches, and the
    float32 precision of cuDNN's convolutions and of matmuls (TF32 or not),
    which choose the library kernels. A graph replays only under the
    switches it was captured with (`infer/sliding.py`, `GraphedBatches`)."""
    return (softmax_mode(), use_fused_ln(), use_conv_chain(), torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
