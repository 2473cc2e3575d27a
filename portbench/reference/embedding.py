"""Plain reference of the speaker-embedding stage: Kaldi log-mel filterbank
(80 mels, 25 ms frames every 10 ms, no dither, Hamming window, snip edges;
`torchaudio.compliance.kaldi.fbank`'s arithmetic), mean normalisation per
window, WeSpeaker's ResNet34 (`pyannote/wespeaker-voxceleb-resnet34-LM`:
basic blocks 3-4-6-3 at 32-64-128-256 channels, BatchNorm with running
statistics), weighted statistics pooling (mean and unbiased standard
deviation under per-speaker frame weights) and the linear head. Float32 with
TF32 off; `Precision` (segmentation.py) rounds the operands of every
convolution and of the head for the control. Imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.segmentation import Precision

SAMPLE_RATE = 16000
FRAME_LENGTH, FRAME_SHIFT, N_FFT, MELS = 400, 160, 512, 80
BN_EPS = 1e-5


def num_fbank_frames(num_samples: int) -> int:
    return 0 if num_samples < FRAME_LENGTH else 1 + (num_samples - FRAME_LENGTH) // FRAME_SHIFT


def _mel(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def _tables(device) -> tuple:
    """(hamming window, DFT cos, DFT sin, mel banks) of Kaldi's fbank."""
    n = np.arange(FRAME_LENGTH)
    window = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (FRAME_LENGTH - 1))
    k = np.arange(N_FFT // 2 + 1)
    angle = 2.0 * np.pi * n[:, None] * k[None, :] / N_FFT
    low, high = _mel(20.0), _mel(SAMPLE_RATE / 2)
    delta = (high - low) / (MELS + 1)
    b = np.arange(MELS)[:, None]
    left, center, right = low + b * delta, low + (b + 1) * delta, low + (b + 2) * delta
    mel = _mel(SAMPLE_RATE / N_FFT * np.arange(N_FFT // 2))[None, :]
    banks = np.maximum(0.0, np.minimum((mel - left) / (center - left),
                                       (right - mel) / (right - center)))
    banks = np.pad(banks, ((0, 0), (0, 1))).T
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (window, np.cos(angle), np.sin(angle), banks))


def fbank(waves: torch.Tensor) -> torch.Tensor:
    """(B, samples) in the 16-bit range -> (B, frames, 80) log-mel energies."""
    window, cos, sin, banks = _tables(waves.device)
    t = num_fbank_frames(waves.shape[-1])
    frames = waves.float().unfold(-1, FRAME_LENGTH, FRAME_SHIFT)[:, :t]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    previous = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = (frames - 0.97 * previous) * window
    power = (frames @ cos) ** 2 + (frames @ sin) ** 2
    return torch.log(torch.clamp_min(power @ banks, 1.1920928955078125e-07))


def param_specs(arch: dict) -> list:
    """(name, shape, kind, fan_in) of every tensor of the ResNet34, in
    WeSpeaker's key layout."""
    r = arch["resnet"]
    m, out = r["m_channels"], []

    def bn(name, c):
        out.extend([(f"{name}.weight", (c,), "norm_w", 1), (f"{name}.bias", (c,), "norm_b", 1),
                    (f"{name}.running_mean", (c,), "bn_mean", 1),
                    (f"{name}.running_var", (c,), "bn_var", 1),
                    (f"{name}.num_batches_tracked", (), "count", 1)])

    out.append(("conv1.weight", (m, 1, 3, 3), "w", 9))
    bn("bn1", m)
    c_in = m
    for li, blocks in enumerate(r["num_blocks"], start=1):
        c = m * 2 ** (li - 1)
        for bi in range(blocks):
            name = f"layer{li}.{bi}"
            out.append((f"{name}.conv1.weight", (c, c_in, 3, 3), "w", c_in * 9))
            bn(f"{name}.bn1", c)
            out.append((f"{name}.conv2.weight", (c, c, 3, 3), "w", c * 9))
            bn(f"{name}.bn2", c)
            if li > 1 and bi == 0:
                out.append((f"{name}.shortcut.0.weight", (c, c_in, 1, 1), "w", c_in))
                bn(f"{name}.shortcut.1", c)
            c_in = c
    stats = (r["feat_dim"] // 8) * m * 8 * 2
    out.append(("seg_1.weight", (r["embed_dim"], stats), "w", stats))
    out.append(("seg_1.bias", (r["embed_dim"],), "b", stats))
    return out


class Embedding:
    """Callable: (B, samples) windows and (B, S, frames) weights on the
    segmentation frame grid -> (B, S, embed) embeddings."""

    def __init__(self, arch: dict, params: dict, precision: Precision = Precision()):
        self.arch, self.p, self.r = arch, params, precision

    def _bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        p = self.p
        return F.batch_norm(x, p[name + ".running_mean"], p[name + ".running_var"],
                            p[name + ".weight"], p[name + ".bias"], False, 0.0, BN_EPS)

    def _conv(self, name: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        weight = self.p[name + ".weight"]
        return F.conv2d(self.r(x), self.r(weight), stride=stride, padding=weight.shape[-1] // 2)

    @torch.no_grad()
    def __call__(self, windows: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        feats = fbank(windows * 32768.0)
        feats = feats - feats.mean(dim=1, keepdim=True)
        x = feats.transpose(1, 2)[:, None]  # (B, 1, mels, frames)
        x = torch.relu(self._bn("bn1", self._conv("conv1", x)))
        for li, blocks in enumerate(self.arch["resnet"]["num_blocks"], start=1):
            for bi in range(blocks):
                name = f"layer{li}.{bi}"
                stride = 2 if (li > 1 and bi == 0) else 1
                out = torch.relu(self._bn(name + ".bn1", self._conv(name + ".conv1", x, stride)))
                out = self._bn(name + ".bn2", self._conv(name + ".conv2", out))
                if li > 1 and bi == 0:
                    x = self._bn(name + ".shortcut.1", self._conv(name + ".shortcut.0", x, stride))
                x = torch.relu(out + x)
        b, c, h, t = x.shape
        features = x.reshape(b, c * h, t)
        # the weights' frames are taken to the ResNet's frames by nearest index
        src = torch.as_tensor(np.floor(np.arange(t) * (weights.shape[-1] / t)).astype(np.int64),
                              device=x.device)
        w = weights.float()[..., src][:, :, None, :]  # (B, S, 1, t)
        f = features[:, None]
        total = w.sum(dim=-1) + 1e-8
        mean = (f * w).sum(dim=-1) / total
        var = ((f - mean[..., None]) ** 2 * w).sum(dim=-1) / (
            total - (w * w).sum(dim=-1) / total + 1e-8)
        std = torch.where(var > 0, torch.sqrt(var.clamp_min(1e-12)), torch.zeros_like(var))
        stats = torch.cat([mean, std], dim=-1)
        return F.linear(self.r(stats), self.r(self.p["seg_1.weight"]), self.p["seg_1.bias"])
