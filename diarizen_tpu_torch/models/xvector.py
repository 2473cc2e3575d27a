"""TDNN x-vector speaker embeddings with an MFCC or a SincNet front end
(port of diarizen_tpu/models/xvector.py, pyannote's XVectorMFCC and
XVectorSincNet).

Front end: torchaudio's MFCC defaults computed as matrix products (n_fft
400, hop 200, centred reflect padding, periodic Hann window, power
spectrum, 128 HTK mels without norm, power to dB, ortho DCT-II to 40
coefficients; no torchaudio), or the SincNet block of
`models/sincnet_eend.py` (60 channels). Then five TDNN layers (channels
512/512/512/512/1500, kernels 5/3/3/1/1, dilations 1/2/3/1/1), each conv ->
leaky ReLU -> BatchNorm with its running statistics; the weighted
statistics pooling of `models/resnet.py`; and a 3000 -> `dimension` linear
embedding. Inference only, in float32, as in the JAX package.

Key layout after pyannote's XVector*: `sincnet.*` (the SincNet front end
only), `tdnns.{i}.0` (Conv1d), `tdnns.{i}.2` (BatchNorm1d), `embedding`.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diarizen_tpu_torch.models.common import leaky_relu
from diarizen_tpu_torch.models.resnet import stats_pool
from diarizen_tpu_torch.models.sincnet_eend import (
    SINCNET_CHANNELS,
    SINCNET_KERNELS,
    SINCNET_STRIDES,
    SincNet,
)
from diarizen_tpu_torch.ops.receptive_field import multi_conv_num_frames
from diarizen_tpu_torch.utils import device_constant

SAMPLE_RATE = 16000
MFCC_N_FFT = 400
MFCC_HOP = 200
MFCC_N_MELS = 128
MFCC_N_COEFFS = 40

TDNN_CHANNELS = (512, 512, 512, 512, 1500)
TDNN_KERNELS = (5, 3, 3, 1, 1)
TDNN_DILATIONS = (1, 2, 3, 1, 1)


@lru_cache(maxsize=1)
def _mfcc_matrices() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The (400, 2 * 201) Hann-windowed cos and sin DFT columns, the
    (201, 128) HTK mel filterbank (torchaudio's `melscale_fbanks`,
    norm None) and the (128, 40) ortho DCT-II (torchaudio's `create_dct`)."""
    n_bins = MFCC_N_FFT // 2 + 1
    n = np.arange(MFCC_N_FFT)[:, None]
    angle = 2.0 * np.pi * n * np.arange(n_bins)[None, :] / MFCC_N_FFT
    hann = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(MFCC_N_FFT) / MFCC_N_FFT))[:, None]
    dft = np.concatenate([np.cos(angle), np.sin(angle)], axis=1) * hann

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    all_freqs = np.linspace(0.0, SAMPLE_RATE / 2, n_bins)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(SAMPLE_RATE / 2), MFCC_N_MELS + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / f_diff[:-1], slopes[:, 2:] / f_diff[1:]))

    dct = np.cos(np.pi / MFCC_N_MELS * (np.arange(MFCC_N_MELS)[:, None] + 0.5)
                 * np.arange(MFCC_N_COEFFS)[None, :])
    dct[:, 0] *= 1.0 / np.sqrt(2.0)
    dct *= np.sqrt(2.0 / MFCC_N_MELS)
    return dft.astype(np.float32), fb.astype(np.float32), dct.astype(np.float32)


def num_mfcc_frames(num_samples: int) -> int:
    """Centred STFT frames: 1 + num_samples // hop."""
    return 1 + num_samples // MFCC_HOP


def mfcc(waveforms: torch.Tensor) -> torch.Tensor:
    """(B, num_samples) -> float32 (B, num_frames, 40) MFCCs."""
    n = waveforms.shape[-1]
    x = F.pad(waveforms.float()[:, None], (MFCC_N_FFT // 2, MFCC_N_FFT // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, MFCC_N_FFT, MFCC_HOP)[:, :num_mfcc_frames(n)]  # (B, T, 400)
    dft, fb, dct = (device_constant(("xvector.mfcc", i), lambda i=i: _mfcc_matrices()[i],
                                    x.device) for i in range(3))
    re, im = (frames @ dft).chunk(2, dim=-1)
    mel = (re * re + im * im) @ fb
    return (10.0 * torch.log10(mel.clamp_min(1e-10))) @ dct  # power to dB, no top clamp


@dataclasses.dataclass(frozen=True)
class XVectorConfig:
    frontend: str = "mfcc"  # "mfcc" | "sincnet"
    dimension: int = 512
    sample_rate: int = SAMPLE_RATE

    @property
    def frontend_dim(self) -> int:
        return MFCC_N_COEFFS if self.frontend == "mfcc" else SINCNET_CHANNELS

    def num_frames(self, num_samples: int) -> int:
        if self.frontend == "mfcc":
            n = num_mfcc_frames(num_samples)
        else:
            n = multi_conv_num_frames(num_samples, SINCNET_KERNELS, SINCNET_STRIDES)
        return multi_conv_num_frames(n, TDNN_KERNELS, [1] * 5, dilation=TDNN_DILATIONS)


class XVectorModel(nn.Module):
    def __init__(self, cfg: XVectorConfig):
        super().__init__()
        if cfg.frontend not in ("mfcc", "sincnet"):
            raise ValueError(f"unknown x-vector front end {cfg.frontend!r}")
        self.cfg = cfg
        if cfg.frontend == "sincnet":
            self.sincnet = SincNet(cfg.sample_rate)
        widths = (cfg.frontend_dim,) + TDNN_CHANNELS
        self.tdnns = nn.ModuleList(
            nn.Sequential(nn.Conv1d(a, b, k, dilation=d), nn.LeakyReLU(), nn.BatchNorm1d(b))
            for a, b, k, d in zip(widths[:-1], widths[1:], TDNN_KERNELS, TDNN_DILATIONS))
        self.embedding = nn.Linear(2 * TDNN_CHANNELS[-1], cfg.dimension)

    def forward(self, waveforms: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, num_samples) or (B, C, num_samples) waveforms (channel 0), and
        optional pooling weights (B, frames) or (B, S, frames) -> float32
        embeddings (B, dimension) or (B, S, dimension)."""
        if waveforms.dim() == 3:
            waveforms = waveforms[:, 0]
        if self.cfg.frontend == "mfcc":
            x = mfcc(waveforms)
        else:
            x = self.sincnet(waveforms)
        x = x.transpose(1, 2)  # (B, C, T)
        for conv, _, bn in self.tdnns:
            x = leaky_relu(conv(x))
            inv = torch.rsqrt(bn.running_var + bn.eps)
            x = (x - bn.running_mean[:, None]) * (inv * bn.weight)[:, None] + bn.bias[:, None]
        return self.embedding(stats_pool(x, weights))
