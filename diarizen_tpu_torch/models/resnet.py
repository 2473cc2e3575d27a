"""WeSpeaker ResNet34 speaker embedding (port of diarizen_tpu/models/resnet.py,
inference).

The fbank (B, T, 80) is a one-channel image with H = mel and W = time; four
stages of basic blocks, masked weighted statistics pooling (mean and
unbiased std) and a linear head give one embedding per weight row; with
`two_emb_layer` the head goes on through ReLU, an affine-free BatchNorm and a
second linear layer. Keys are WeSpeaker's (`conv1`, `bn1`, `layerN.M.*`,
`seg_1`, `seg_bn_1`, `seg_2`); BatchNorm uses its running statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diarizen_tpu_torch.models.fbank import num_fbank_frames
from diarizen_tpu_torch.utils import device_constant


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    m_channels: int = 32
    num_blocks: Tuple[int, ...] = (3, 4, 6, 3)
    feat_dim: int = 80
    embed_dim: int = 256
    two_emb_layer: bool = False

    @property
    def stats_dim(self) -> int:
        return (self.feat_dim // 8) * self.m_channels * 8

    def num_frames(self, num_samples: int) -> int:
        """Output frames for raw-audio input (fbank + 3 stride-2 stages)."""
        t = num_fbank_frames(num_samples)
        for _ in range(3):
            t = (t + 1) // 2
        return t


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), stride=conv.stride, padding=conv.padding)


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm folded into one scale and shift per channel."""
    inv = torch.rsqrt(bn.running_var + bn.eps)
    scale = (bn.weight * inv).to(x.dtype)
    shift = (bn.bias - bn.running_mean * bn.weight * inv).to(x.dtype)
    return x * scale[:, None, None] + shift[:, None, None]


class _BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=1, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride, bias=False),
                nn.BatchNorm2d(planes),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(_bn(self.bn1, _conv(self.conv1, x)))
        out = _bn(self.bn2, _conv(self.conv2, out))
        sc = _bn(self.shortcut[1], _conv(self.shortcut[0], x)) if len(self.shortcut) else x
        return torch.relu(out + sc)


def stats_pool(features: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted statistics pooling.

    features: (B, D, T); weights: (B, T) or (B, S, T), nearest-interpolated
    to T when their length differs. Returns (B, 2D) or (B, S, 2D) float32."""
    if weights is None:
        return torch.cat([features.mean(dim=-1), features.std(dim=-1)], dim=-1)
    squeeze = weights.dim() == 2
    if squeeze:
        weights = weights[:, None, :]
    t, tw = features.shape[-1], weights.shape[-1]
    if tw != t:  # nearest interpolation (F.interpolate mode='nearest')
        src = device_constant(("resnet.nearest", t, tw),
                              lambda: np.floor(np.arange(t) * (tw / t)).astype(np.int64),
                              weights.device)
        weights = weights[..., src]

    w = weights[:, :, None, :].float()  # (B, S, 1, T)
    f = features[:, None, :, :].float()  # (B, 1, D, T)
    v1 = w.sum(dim=-1) + 1e-8  # (B, S, 1)
    mean = (f * w).sum(dim=-1) / v1  # (B, S, D)
    dx2 = torch.square(f - mean[..., None])
    v2 = torch.square(w).sum(dim=-1)
    var = (dx2 * w).sum(dim=-1) / (v1 - v2 / v1 + 1e-8)
    std = torch.where(var > 0, torch.sqrt(var.clamp_min(1e-12)), torch.zeros_like(var))
    out = torch.cat([mean, std], dim=-1)
    return out[:, 0] if squeeze else out


class ResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        m = cfg.m_channels
        self.conv1 = nn.Conv2d(1, m, 3, stride=1, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(m)
        in_planes = m
        for li, n_blocks in enumerate(cfg.num_blocks, start=1):
            planes = m * 2 ** (li - 1)
            blocks = []
            for bi in range(n_blocks):
                blocks.append(_BasicBlock(in_planes, planes, 2 if (li > 1 and bi == 0) else 1))
                in_planes = planes
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.seg_1 = nn.Linear(cfg.stats_dim * 2, cfg.embed_dim)
        if cfg.two_emb_layer:
            self.seg_bn_1 = nn.BatchNorm1d(cfg.embed_dim, affine=False)
            self.seg_2 = nn.Linear(cfg.embed_dim, cfg.embed_dim)

    def forward(self, fbank: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, 80) fbank [+ (B, T') or (B, S, T') weights] -> float32
        (B, embed) or (B, S, embed) embeddings. Convolutions run in the
        fbank's type; pooling and the head in float32."""
        x = fbank.transpose(1, 2)[:, None]  # (B, 1, F, T)
        x = torch.relu(_bn(self.bn1, _conv(self.conv1, x)))
        for li in range(1, len(self.cfg.num_blocks) + 1):
            x = getattr(self, f"layer{li}")(x)
        b, c, h, w = x.shape
        stats = stats_pool(x.reshape(b, c * h, w), weights)
        emb = F.linear(stats, self.seg_1.weight.float(), self.seg_1.bias.float())
        if not self.cfg.two_emb_layer:
            return emb
        bn = self.seg_bn_1
        out = (torch.relu(emb) - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
        return F.linear(out, self.seg_2.weight.float(), self.seg_2.bias.float())
