"""SincNet front end and the SincNet -> BiLSTM EEND baseline (port of
diarizen_tpu/models/sincnet_eend.py, pyannote's PyanNet).

SincNet: an instance norm of the waveform -> 80 sinc band-pass filters of
251 taps at stride 10, rebuilt from the trainable `low_hz_` / `band_hz_` on
every forward (mel-spaced at init, Hamming-windowed) -> |.| -> max-pool 3
-> instance norm -> leaky ReLU, then two conv(5) -> max-pool 3 -> instance
norm -> leaky ReLU stages to 60 channels. The baseline adds 4 BiLSTM(128)
layers, 2 x (Linear(128) + leaky ReLU) and the powerset head. The whole
family runs in float32, whatever compute type the caller asks for, as in
the JAX package.

Key layout after pyannote's PyanNet (with one LSTM module per layer):
`sincnet.wav_norm1d`, `sincnet.conv1d.0.{low_hz_,band_hz_}` (80 each),
`sincnet.conv1d.{1,2}` (Conv1d), `sincnet.norm1d.{0,1,2}` (affine
InstanceNorm1d), `lstm.{i}` (one bidirectional nn.LSTM each), `linear.{0,1}`,
`classifier`.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diarizen_tpu_torch.models.common import (
    TrainRandom,
    instance_norm,
    leaky_relu,
    lstm_layer,
    run_lstm,
)
from diarizen_tpu_torch.ops.powerset import Powerset, num_powerset_classes
from diarizen_tpu_torch.ops.receptive_field import (
    multi_conv_num_frames,
    multi_conv_receptive_field_size,
)
from diarizen_tpu_torch.utils import device_constant

SINC_FILTERS = 80
SINC_KERNEL = 251
SINC_STRIDE = 10
MIN_LOW_HZ = 50.0
MIN_BAND_HZ = 50.0
SAMPLE_RATE = 16000
SINCNET_CHANNELS = 60
LINEAR_HIDDEN = 128  # the head's width, fixed as in the JAX package

SINCNET_KERNELS = [251, 3, 5, 3, 5, 3]
SINCNET_STRIDES = [SINC_STRIDE, 3, 1, 3, 1, 3]


def _mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _imel(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@lru_cache(maxsize=1)
def _half_window() -> np.ndarray:
    return np.hamming(SINC_KERNEL)[: (SINC_KERNEL - 1) // 2].astype(np.float32)


class _SincFilterbank(nn.Module):
    """The trainable band edges of the sinc filterbank (Hz)."""

    def __init__(self, sample_rate: int = SAMPLE_RATE):
        super().__init__()
        edges = _imel(np.linspace(_mel(30.0), _mel(sample_rate / 2 - MIN_LOW_HZ - MIN_BAND_HZ),
                                  SINC_FILTERS + 1))
        self.low_hz_ = nn.Parameter(torch.tensor(edges[:-1], dtype=torch.float32))
        self.band_hz_ = nn.Parameter(torch.tensor(np.diff(edges), dtype=torch.float32))

    def filters(self) -> torch.Tensor:
        """(251, 80) float32 band-pass kernels as columns, rebuilt from the
        edges."""
        low = MIN_LOW_HZ + self.low_hz_.abs()
        high = torch.clamp(low + MIN_BAND_HZ + self.band_hz_.abs(), MIN_LOW_HZ, SAMPLE_RATE / 2)
        half = (SINC_KERNEL - 1) // 2
        device = low.device
        n = torch.arange(1, half + 1, dtype=torch.float32, device=device) / SAMPLE_RATE
        window = device_constant(("sincnet.window",), _half_window, device)
        f_times_t = 2.0 * torch.pi * n[:, None]  # (125, 1)
        left = ((torch.sin(f_times_t * high[None]) - torch.sin(f_times_t * low[None]))
                / (f_times_t / 2.0)) * window[:, None]
        center = 2.0 * (high - low)[None]
        filters = torch.cat([left, center, left.flip(0)], dim=0)  # (251, F)
        return filters / (2.0 * (high - low))[None]


class SincNet(nn.Module):
    """(B, num_samples) waveforms -> float32 (B, frames, 60) features."""

    def __init__(self, sample_rate: int = SAMPLE_RATE):
        super().__init__()
        self.wav_norm1d = nn.InstanceNorm1d(1, affine=True)
        self.conv1d = nn.ModuleList([
            _SincFilterbank(sample_rate),
            nn.Conv1d(SINC_FILTERS, SINCNET_CHANNELS, 5),
            nn.Conv1d(SINCNET_CHANNELS, SINCNET_CHANNELS, 5),
        ])
        self.norm1d = nn.ModuleList([nn.InstanceNorm1d(SINC_FILTERS, affine=True),
                                     nn.InstanceNorm1d(SINCNET_CHANNELS, affine=True),
                                     nn.InstanceNorm1d(SINCNET_CHANNELS, affine=True)])

    def forward(self, waveforms: torch.Tensor) -> torch.Tensor:
        x = instance_norm(self.wav_norm1d, waveforms.float()[:, None, :])
        # the sinc convolution (one input channel, 251 taps, stride 10) as a
        # product of the (B, T, 251) frames with the filters: cuDNN's
        # algorithms for this shape run at a few percent of its peak
        frames = x[:, 0].unfold(-1, SINC_KERNEL, SINC_STRIDE)
        x = (frames @ self.conv1d[0].filters()).transpose(1, 2).abs()
        x = leaky_relu(instance_norm(self.norm1d[0], F.max_pool1d(x, 3)))
        for conv, norm in zip(self.conv1d[1:], self.norm1d[1:]):
            x = leaky_relu(instance_norm(norm, F.max_pool1d(conv(x), 3)))
        return x.transpose(1, 2)


@dataclasses.dataclass(frozen=True)
class SincNetEendConfig:
    hidden_size: int = 128
    num_lstm_layers: int = 4
    lstm_dropout: float = 0.5
    max_speakers_per_chunk: int = 4
    max_speakers_per_frame: int = 2
    chunk_size: float = 8.0
    sample_rate: int = SAMPLE_RATE
    selected_channel: int = 0

    @property
    def num_powerset_classes(self) -> int:
        return num_powerset_classes(self.max_speakers_per_chunk, self.max_speakers_per_frame)

    @property
    def powerset(self) -> Powerset:
        return Powerset(self.max_speakers_per_chunk, self.max_speakers_per_frame)

    def num_frames(self, num_samples: int) -> int:
        return multi_conv_num_frames(num_samples, SINCNET_KERNELS, SINCNET_STRIDES)

    def rf_info(self) -> Tuple[float, float]:
        """(frame step seconds, frame duration seconds) of the SincNet stack."""
        size1 = multi_conv_receptive_field_size(1, SINCNET_KERNELS, SINCNET_STRIDES)
        size2 = multi_conv_receptive_field_size(2, SINCNET_KERNELS, SINCNET_STRIDES)
        return (size2 - size1) / self.sample_rate, size1 / self.sample_rate


class SincNetEendModel(nn.Module):
    def __init__(self, cfg: SincNetEendConfig):
        super().__init__()
        self.cfg = cfg
        self.sincnet = SincNet(cfg.sample_rate)
        h = cfg.hidden_size
        self.lstm = nn.ModuleList(lstm_layer(SINCNET_CHANNELS if i == 0 else 2 * h, h)
                                  for i in range(cfg.num_lstm_layers))
        self.linear = nn.ModuleList([nn.Linear(2 * h, LINEAR_HIDDEN),
                                     nn.Linear(LINEAR_HIDDEN, LINEAR_HIDDEN)])
        self.classifier = nn.Linear(LINEAR_HIDDEN, cfg.num_powerset_classes)

    def forward(self, waveforms: torch.Tensor, compute_dtype: torch.dtype = torch.float32,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, C, num_samples) or (B, num_samples) -> float32 log-powerset
        scores (B, F, P), in float32 whatever `compute_dtype` says. With
        `train` and a host `generator`, dropout between the LSTM layers."""
        del compute_dtype  # the family runs float32, as in the JAX package
        if waveforms.dim() == 3:
            waveforms = waveforms[:, self.cfg.selected_channel]
        gen = TrainRandom(generator, waveforms.device).device if (
            train and generator is not None) else None
        x = run_lstm(self.lstm, self.sincnet(waveforms), self.cfg.lstm_dropout, gen)
        for layer in self.linear:
            x = leaky_relu(layer(x))
        return torch.log_softmax(self.classifier(x), dim=-1)
