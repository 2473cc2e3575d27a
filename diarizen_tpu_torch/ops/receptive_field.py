"""Receptive-field arithmetic for stacked 1-D convolutions.

Same formulas as the reference
(pyannote-audio/pyannote/audio/utils/receptive_field.py:26-160); used to map
model output frames back to sample times for rasterization and stitching.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# WavLM conv front-end geometry (reference models/eend/model_wavlm_conformer.py:113-116)
WAVLM_KERNELS = [10, 3, 3, 3, 3, 2, 2]
WAVLM_STRIDES = [5, 2, 2, 2, 2, 2, 2]


def conv1d_num_frames(
    num_samples: int, kernel_size: int, stride: int, padding: int = 0, dilation: int = 1
) -> int:
    return 1 + (num_samples + 2 * padding - dilation * (kernel_size - 1) - 1) // stride


def multi_conv_num_frames(
    num_samples: int,
    kernel_size: Sequence[int],
    stride: Sequence[int],
    padding: Sequence[int] | None = None,
    dilation: Sequence[int] | None = None,
) -> int:
    padding = padding or [0] * len(kernel_size)
    dilation = dilation or [1] * len(kernel_size)
    n = num_samples
    for k, s, p, d in zip(kernel_size, stride, padding, dilation):
        n = conv1d_num_frames(n, k, s, p, d)
    return n


def conv1d_receptive_field_size(
    num_frames: int, kernel_size: int, stride: int, dilation: int = 1
) -> int:
    effective = 1 + (kernel_size - 1) * dilation
    return effective + (num_frames - 1) * stride


def multi_conv_receptive_field_size(
    num_frames: int,
    kernel_size: Sequence[int],
    stride: Sequence[int],
    dilation: Sequence[int] | None = None,
) -> int:
    dilation = dilation or [1] * len(kernel_size)
    size = num_frames
    for k, s, d in reversed(list(zip(kernel_size, stride, dilation))):
        size = conv1d_receptive_field_size(size, k, s, d)
    return size


def conv1d_receptive_field_center(
    frame: int, kernel_size: int, stride: int, padding: int = 0, dilation: int = 1
) -> int:
    effective = 1 + (kernel_size - 1) * dilation
    return frame * stride + (effective - 1) // 2 - padding


def multi_conv_receptive_field_center(
    frame: int,
    kernel_size: Sequence[int],
    stride: Sequence[int],
    padding: Sequence[int] | None = None,
    dilation: Sequence[int] | None = None,
) -> int:
    padding = padding or [0] * len(kernel_size)
    dilation = dilation or [1] * len(kernel_size)
    center = frame
    for k, s, p, d in reversed(list(zip(kernel_size, stride, padding, dilation))):
        center = conv1d_receptive_field_center(center, k, s, p, d)
    return center


def wavlm_num_frames(num_samples: int) -> int:
    return multi_conv_num_frames(num_samples, WAVLM_KERNELS, WAVLM_STRIDES)


def wavlm_rf_info(chunk_size: float, sample_rate: int = 16000) -> Tuple[int, float, float]:
    """(num_frames, rf_duration_s, rf_step_s) for the WavLM front-end
    (reference model_wavlm_conformer.py:178-190 get_rf_info)."""
    rf_size = multi_conv_receptive_field_size(1, WAVLM_KERNELS, WAVLM_STRIDES)
    rf_step = (
        multi_conv_receptive_field_size(2, WAVLM_KERNELS, WAVLM_STRIDES) - rf_size
    )
    num_frames = wavlm_num_frames(int(chunk_size * sample_rate))
    return num_frames, rf_size / sample_rate, rf_step / sample_rate
