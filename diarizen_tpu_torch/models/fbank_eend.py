"""Fbank -> Conformer EEND segmentation model (port of
diarizen_tpu/models/fbank_eend.py).

SpeechBrain-style 80-mel log filterbank (centred 25 ms / 10 ms Hamming STFT,
n_fft 400, HTK mels, dB with an 80 dB top clamp per batch item) -> Linear +
LayerNorm -> Conformer -> Linear -> log-softmax over the powerset classes.
The STFT is two DFT matrix products, as in the JAX package. Key layout as
the reference's `model_fbank_conformer.Model`: `proj`, `lnorm`,
`conformer.*`, `classifier`.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from diarizen_tpu_torch.models.common import TrainRandom, layer_norm, linear
from diarizen_tpu_torch.models.conformer import Conformer, ConformerConfig
from diarizen_tpu_torch.ops.powerset import Powerset, num_powerset_classes
from diarizen_tpu_torch.utils import device_constant

SAMPLE_RATE = 16000
N_FFT = 400
WIN = 400  # 25 ms
HOP = 160  # 10 ms
N_MELS = 80
TOP_DB = 80.0


@lru_cache(maxsize=1)
def _mel_banks() -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) HTK-mel triangular filters over [0, 8000] Hz."""
    def mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def imel(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    n_bins = N_FFT // 2 + 1
    pts = imel(np.linspace(mel(0.0), mel(SAMPLE_RATE / 2), N_MELS + 2))
    freqs = np.linspace(0, SAMPLE_RATE / 2, n_bins)
    banks = np.zeros((n_bins, N_MELS), dtype=np.float32)
    for m in range(N_MELS):
        left, center, right = pts[m], pts[m + 1], pts[m + 2]
        up = (freqs - left) / max(center - left, 1e-9)
        down = (right - freqs) / max(right - center, 1e-9)
        banks[:, m] = np.maximum(0.0, np.minimum(up, down))
    return banks


@lru_cache(maxsize=1)
def _dft() -> np.ndarray:
    """(WIN, 2 * (n_fft // 2 + 1)) Hamming-windowed cos and sin columns."""
    n = np.arange(WIN)[:, None]
    k = np.arange(N_FFT // 2 + 1)[None, :]
    angle = 2.0 * np.pi * n * k / N_FFT
    win = np.hamming(WIN)[:, None]
    return np.concatenate([np.cos(angle) * win, np.sin(angle) * win], axis=1).astype(np.float32)


def num_fbank_frames_centered(num_samples: int) -> int:
    return 1 + num_samples // HOP


def speechbrain_fbank(waveforms: torch.Tensor) -> torch.Tensor:
    """(B, num_samples) -> float32 (B, 1 + num_samples // 160, 80) log-mel
    in dB, clamped at each item's peak minus 80 dB."""
    n = waveforms.shape[-1]
    x = torch.nn.functional.pad(waveforms.float(), (N_FFT // 2, N_FFT // 2))
    frames = x.unfold(-1, WIN, HOP)[:, :num_fbank_frames_centered(n)]  # (B, T, WIN)
    dft = device_constant(("fbank_eend.dft",), _dft, x.device)
    banks = device_constant(("fbank_eend.mel",), _mel_banks, x.device)
    spec = frames @ dft
    re, im = spec.chunk(2, dim=-1)
    mel = (re * re + im * im) @ banks
    db = 10.0 * torch.log10(mel.clamp_min(1e-10))
    peak = db.amax(dim=(1, 2), keepdim=True)  # per batch item
    return torch.maximum(db, peak - TOP_DB)


@dataclasses.dataclass(frozen=True)
class FbankEendConfig:
    conformer: ConformerConfig = ConformerConfig()
    n_mels: int = N_MELS
    attention_in: int = 256
    max_speakers_per_chunk: int = 4
    max_speakers_per_frame: int = 2
    chunk_size: float = 5.0
    sample_rate: int = SAMPLE_RATE
    selected_channel: int = 0

    @property
    def num_powerset_classes(self) -> int:
        return num_powerset_classes(self.max_speakers_per_chunk, self.max_speakers_per_frame)

    @property
    def powerset(self) -> Powerset:
        return Powerset(self.max_speakers_per_chunk, self.max_speakers_per_frame)

    def num_frames(self, num_samples: int) -> int:
        return num_fbank_frames_centered(num_samples)

    def rf_info(self) -> Tuple[float, float]:
        """(frame step seconds, frame duration seconds): centred STFT frames."""
        return HOP / self.sample_rate, N_FFT / self.sample_rate


class FbankEendModel(nn.Module):
    def __init__(self, cfg: FbankEendConfig):
        super().__init__()
        self.cfg = cfg
        self.proj = nn.Linear(cfg.n_mels, cfg.attention_in)
        self.lnorm = nn.LayerNorm(cfg.attention_in)
        self.conformer = Conformer(cfg.conformer)
        self.classifier = nn.Linear(cfg.attention_in, cfg.num_powerset_classes)

    def forward(self, waveforms: torch.Tensor, compute_dtype: torch.dtype = torch.float32,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, C, num_samples) or (B, num_samples) -> float32 log-powerset
        scores (B, F, P). The fbank is float32; the rest runs in
        `compute_dtype`. `train` and `generator` as in `EendModel`."""
        if waveforms.dim() == 3:
            waveforms = waveforms[:, self.cfg.selected_channel]
        rng = TrainRandom(generator, waveforms.device) if (train and generator is not None) else None
        feats = speechbrain_fbank(waveforms).to(compute_dtype)
        x = layer_norm(self.lnorm, linear(self.proj, feats))
        x = self.conformer(x, train=train, rng=rng)
        return torch.log_softmax(linear(self.classifier, x).float(), dim=-1)
