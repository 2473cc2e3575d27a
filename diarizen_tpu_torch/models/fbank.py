"""Kaldi-compatible log-mel filterbank (port of diarizen_tpu/models/fbank.py).

`torchaudio.compliance.kaldi.fbank` with the WeSpeaker settings (80 mels,
25 ms frames, 10 ms shift, no dither, hamming window, no energy, snip
edges), written as matrix products so it needs no torchaudio: framing is an
unfold, the 512-point DFT of the 400 real samples is a (400, 257) cos/sin
product and the mel projection another product.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from diarizen_tpu_torch.utils import device_constant

SAMPLE_RATE = 16000
FRAME_LENGTH = 400  # 25 ms
FRAME_SHIFT = 160  # 10 ms
N_FFT = 512
NUM_MEL_BINS = 80
PREEMPH = 0.97
LOW_FREQ = 20.0
HIGH_FREQ = 0.0  # offset from nyquist
EPS = 1.1920928955078125e-07  # float32 eps (torchaudio _get_epsilon)


def num_fbank_frames(num_samples: int) -> int:
    """snip_edges frame count: 1 + (N - frame_length) // shift."""
    if num_samples < FRAME_LENGTH:
        return 0
    return 1 + (num_samples - FRAME_LENGTH) // FRAME_SHIFT


def _mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


@lru_cache(maxsize=1)
def _mel_banks() -> np.ndarray:
    """(257, 80) kaldi triangular mel filterbank, last FFT bin zero."""
    num_fft_bins = N_FFT // 2
    nyquist = 0.5 * SAMPLE_RATE
    high_freq = HIGH_FREQ if HIGH_FREQ > 0 else nyquist + HIGH_FREQ

    low_mel = _mel_scale(LOW_FREQ)
    high_mel = _mel_scale(high_freq)
    mel_delta = (high_mel - low_mel) / (NUM_MEL_BINS + 1)

    bins = np.arange(NUM_MEL_BINS)[:, None]
    left_mel = low_mel + bins * mel_delta
    center_mel = low_mel + (bins + 1.0) * mel_delta
    right_mel = low_mel + (bins + 2.0) * mel_delta

    fft_bin_width = SAMPLE_RATE / N_FFT
    mel = _mel_scale(fft_bin_width * np.arange(num_fft_bins))[None, :]

    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    banks = np.maximum(0.0, np.minimum(up_slope, down_slope))  # (80, 256)
    banks = np.pad(banks, ((0, 0), (0, 1)))  # (80, 257)
    return banks.T.astype(np.float32)


@lru_cache(maxsize=1)
def _dft_matrices() -> Tuple[np.ndarray, np.ndarray]:
    """(frame_len, 257) cos/sin matrices of the zero-padded 512-point DFT."""
    n_bins = N_FFT // 2 + 1
    n = np.arange(FRAME_LENGTH)[:, None]
    k = np.arange(n_bins)[None, :]
    angle = 2.0 * np.pi * n * k / N_FFT
    return np.cos(angle).astype(np.float32), np.sin(angle).astype(np.float32)


@lru_cache(maxsize=1)
def _hamming_window() -> np.ndarray:
    n = np.arange(FRAME_LENGTH)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * n / (FRAME_LENGTH - 1))).astype(np.float32)


def kaldi_fbank(waveforms: torch.Tensor) -> torch.Tensor:
    """(B, num_samples) waveforms in the 16-bit range -> float32
    (B, num_frames, 80) log-mel features."""
    device = waveforms.device
    t = num_fbank_frames(waveforms.shape[-1])
    frames = waveforms.float().unfold(-1, FRAME_LENGTH, FRAME_SHIFT)[:, :t]  # (B, T, 400)
    frames = frames - frames.mean(dim=-1, keepdim=True)  # remove DC per frame
    # preemphasis with the first sample duplicated (torchaudio semantics)
    offset = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = (frames - PREEMPH * offset) * device_constant("fbank.hamming", _hamming_window, device)

    re = frames @ device_constant("fbank.cos", lambda: _dft_matrices()[0], device)
    im = frames @ device_constant("fbank.sin", lambda: _dft_matrices()[1], device)
    mel = (re * re + im * im) @ device_constant("fbank.mel", _mel_banks, device)
    return torch.log(torch.clamp_min(mel, EPS))


def wespeaker_fbank(waveforms: torch.Tensor) -> torch.Tensor:
    """WeSpeaker front-end: x * 2^15 -> kaldi fbank -> per-utterance CMN."""
    feats = kaldi_fbank(waveforms * 32768.0)
    return feats - feats.mean(dim=1, keepdim=True)
