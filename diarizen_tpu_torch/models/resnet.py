"""WeSpeaker ResNet34 speaker embedding (port of diarizen_tpu/models/resnet.py,
inference).

The fbank (B, T, 80) is a one-channel image with H = mel and W = time; four
stages of basic blocks, masked weighted statistics pooling (mean and
unbiased std) and a linear head give one embedding per weight row; with
`two_emb_layer` the head goes on through ReLU, an affine-free BatchNorm and a
second linear layer. Keys are WeSpeaker's (`conv1`, `bn1`, `layerN.M.*`,
`seg_1`, `seg_bn_1`, `seg_2`); BatchNorm uses its running statistics.

Each convolution's BatchNorm is folded into its weight and a bias once per
parameter state (`ResNet.folded`, kept outside the module's parameters and
buffers), and the trunk runs channels-last: on CUDA the stem is one CUDA
kernel that reads the fbank as it lies (`ops/resnet_stem.py`), and every
other convolution one cuDNN call that adds the bias and the block's residual
and applies the ReLU in its epilogue (`folded_conv`), so no pass over an
activation is left between two convolutions. Layer 4's output goes back to
channels first once, for the pooling.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diarizen_tpu_torch.models.fbank import num_fbank_frames
from diarizen_tpu_torch.ops import cuda_build
from diarizen_tpu_torch.ops.resnet_stem import stem_conv
from diarizen_tpu_torch.utils import device_constant, state_stamp


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


class FoldedConv(NamedTuple):
    """A convolution with the BatchNorm after it folded in: the weight
    (channels-last, in the compute type), the bias (None where a later
    epilogue adds it) and the convolution's stride and padding."""

    weight: torch.Tensor
    bias: Optional[torch.Tensor]
    stride: Tuple[int, int]
    padding: Tuple[int, int]


def fold_batch_norm(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weight, bias) in float64 of `conv` followed by eval-mode `bn`:
    w' = w * s and b' = beta - mean * s per output channel, s = gamma /
    sqrt(var + eps)."""
    scale = bn.weight.double() * torch.rsqrt(bn.running_var.double() + bn.eps)
    return (conv.weight.double() * scale[:, None, None, None],
            bn.bias.double() - bn.running_mean.double() * scale)


def _folded_conv(conv: nn.Conv2d, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 dtype: torch.dtype) -> FoldedConv:
    return FoldedConv(weight.to(dtype).contiguous(memory_format=torch.channels_last),
                      None if bias is None else bias.to(dtype), conv.stride, conv.padding)


def folded_conv(x: torch.Tensor, conv: FoldedConv, residual: Optional[torch.Tensor] = None,
                relu: bool = True) -> torch.Tensor:
    """conv(x) + bias [+ residual], then the ReLU unless `relu` is False,
    channels-last. On CUDA one cuDNN convolution with the bias, the residual
    and the ReLU in its epilogue, counted in the launch registry
    ("resnet_conv"); elsewhere the plain version."""
    if not x.is_cuda:
        return folded_conv_reference(x, conv, residual, relu)
    cuda_build.count("resnet_conv")
    if not relu:
        return F.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding)
    if residual is None:
        return torch.cudnn_convolution_relu(x, conv.weight, conv.bias, conv.stride,
                                            conv.padding, (1, 1), 1)
    return torch.cudnn_convolution_add_relu(x, conv.weight, residual, 1.0, conv.bias,
                                            conv.stride, conv.padding, (1, 1), 1)


def folded_conv_reference(x: torch.Tensor, conv: FoldedConv,
                          residual: Optional[torch.Tensor] = None,
                          relu: bool = True) -> torch.Tensor:
    """The plain version of `folded_conv`: the convolution with its bias,
    the add and the ReLU as separate operations."""
    y = F.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


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

    def fold(self, dtype: torch.dtype) -> Tuple[FoldedConv, FoldedConv, Optional[FoldedConv]]:
        """(conv1, conv2, the projection shortcut or None) with their
        BatchNorms folded in. The projection's bias goes into conv2's, which
        adds the shortcut in its epilogue, so the projection runs without one."""
        w1, b1 = fold_batch_norm(self.conv1, self.bn1)
        w2, b2 = fold_batch_norm(self.conv2, self.bn2)
        shortcut = None
        if len(self.shortcut):
            ws, bs = fold_batch_norm(self.shortcut[0], self.shortcut[1])
            shortcut = _folded_conv(self.shortcut[0], ws, None, dtype)
            b2 = b2 + bs
        return (_folded_conv(self.conv1, w1, b1, dtype), _folded_conv(self.conv2, w2, b2, dtype),
                shortcut)

    def forward(self, x: torch.Tensor, folded: tuple) -> torch.Tensor:
        """The block on channels-last `x`, with its `fold(x.dtype)`."""
        conv1, conv2, shortcut = folded
        out = folded_conv(x, conv1)
        if shortcut is not None:
            x = folded_conv(x, shortcut, relu=False)
        return folded_conv(out, conv2, residual=x)


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
        # the folded convolutions by compute type, and the `state_stamp` of
        # the parameters and buffers they were folded from: plain attributes,
        # which the stamp does not see
        self._folds: Dict[torch.dtype, tuple] = {}
        self._fold_stamp: Optional[list] = None

    def folded(self, dtype: torch.dtype) -> tuple:
        """(the stem, each block's `_BasicBlock.fold`) in `dtype`, folded once
        per parameter state and compute type, counted in the launch registry
        ("resnet_fold"). The same tensors come back until a parameter or
        buffer moves or changes in place, so a CUDA graph captured after an
        eager forward reads current folds for as long as the inference
        object's stamp (`GraphedBatches`) keeps it."""
        stamp = state_stamp(self)
        if stamp != self._fold_stamp:
            self._folds, self._fold_stamp = {}, stamp
        folds = self._folds.get(dtype)
        if folds is None:
            with torch.no_grad():
                stem = _folded_conv(self.conv1, *fold_batch_norm(self.conv1, self.bn1), dtype)
                blocks = [block.fold(dtype) for block in self.blocks()]
            folds = self._folds[dtype] = (stem, blocks)
            cuda_build.count("resnet_fold")
        return folds

    def blocks(self) -> Iterator[_BasicBlock]:
        for li in range(1, len(self.cfg.num_blocks) + 1):
            yield from getattr(self, f"layer{li}")

    def forward(self, fbank: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, 80) fbank [+ (B, T') or (B, S, T') weights] -> float32
        (B, embed) or (B, S, embed) embeddings. Convolutions run in the
        fbank's type, channels-last, each with its BatchNorm folded in
        (`folded`) and its bias, residual and ReLU in its epilogue
        (`folded_conv`); pooling and the head in float32."""
        stem, blocks = self.folded(fbank.dtype)
        x = stem_conv(fbank.contiguous(), stem.weight, stem.bias)  # (B, C, F, T)
        for block, folded in zip(self.blocks(), blocks):
            x = block(x, folded)
        b, c, h, w = x.shape  # back to channels first: (B, C * F', T') as seg_1 reads it
        stats = stats_pool(x.contiguous().view(b, c * h, w), weights)
        emb = F.linear(stats, self.seg_1.weight.float(), self.seg_1.bias.float())
        if not self.cfg.two_emb_layer:
            return emb
        bn = self.seg_bn_1
        out = (torch.relu(emb) - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
        return F.linear(out, self.seg_2.weight.float(), self.seg_2.bias.float())
