"""Conformer encoder (port of diarizen_tpu/models/conformer.py, inference).

N blocks of macaron FFN (half residual) -> MHSA -> conv module (GLU,
depthwise conv, eval BatchNorm, swish) -> FFN -> LayerNorm, with the
reference's key layout (`conformer_layer.{i}.{ffn1,mha,conv,ffn2,ln_norm}`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from diarizen_tpu_torch.models.common import attention, layer_norm, linear, swish


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    dim: int = 256
    ffn_hidden: int = 1024
    num_heads: int = 4
    num_layers: int = 4
    kernel_size: int = 31
    dropout: float = 0.1
    use_posi: bool = False
    posi_maxlen: int = 1000
    output_activation: Optional[str] = None  # None | "relu" | "tanh" | "sigmoid"


class _FFN(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.ln_norm = nn.LayerNorm(d)
        self.w_1 = nn.Linear(d, hidden)
        self.w_2 = nn.Linear(hidden, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = swish(linear(self.w_1, layer_norm(self.ln_norm, x)))
        return x + 0.5 * linear(self.w_2, h)


class _Projections(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.linearQ = nn.Linear(d, d)
        self.linearK = nn.Linear(d, d)
        self.linearV = nn.Linear(d, d)
        self.linearO = nn.Linear(d, d)


class _MHA(nn.Module):
    def __init__(self, d: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.ln_norm = nn.LayerNorm(d)
        self.mha = _Projections(d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = layer_norm(self.ln_norm, x)
        nh = self.num_heads

        def split(z):
            return z.reshape(b, t, nh, d // nh).transpose(1, 2)

        out = attention(split(linear(self.mha.linearQ, h)),
                        split(linear(self.mha.linearK, h)),
                        split(linear(self.mha.linearV, h)))
        return x + linear(self.mha.linearO, out.transpose(1, 2).reshape(b, t, d))


class _ConvModule(nn.Module):
    def __init__(self, d: int, kernel_size: int):
        super().__init__()
        self.ln_norm = nn.LayerNorm(d)
        self.pointwise_conv1 = nn.Conv1d(d, 2 * d, 1)
        self.depthwise_conv = nn.Conv1d(d, d, kernel_size, groups=d)
        self.bn_norm = nn.BatchNorm1d(d)
        self.pointwise_conv2 = nn.Conv1d(d, d, 1)

    @staticmethod
    def _conv(conv: nn.Conv1d, x: torch.Tensor, **kw) -> torch.Tensor:
        return F.conv1d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        h = layer_norm(self.ln_norm, x).transpose(1, 2)  # (B, C, T)
        a, g = self._conv(self.pointwise_conv1, h).chunk(2, dim=1)
        h = a * torch.sigmoid(g)  # GLU over channels
        k = self.depthwise_conv.kernel_size[0]
        h = self._conv(self.depthwise_conv, h, padding=(k - 1) // 2, groups=d)
        bn = self.bn_norm  # eval mode: running statistics
        y = (h.float() - bn.running_mean[:, None]) * torch.rsqrt(
            bn.running_var[:, None] + bn.eps)
        h = (y * bn.weight[:, None] + bn.bias[:, None]).to(h.dtype)
        h = self._conv(self.pointwise_conv2, swish(h))
        return x + h.transpose(1, 2)


class _ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.ffn1 = _FFN(cfg.dim, cfg.ffn_hidden)
        self.mha = _MHA(cfg.dim, cfg.num_heads)
        self.conv = _ConvModule(cfg.dim, cfg.kernel_size)
        self.ffn2 = _FFN(cfg.dim, cfg.ffn_hidden)
        self.ln_norm = nn.LayerNorm(cfg.dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.mha(self.ffn1(x))
        x = self.ffn2(self.conv(x))
        return layer_norm(self.ln_norm, x)


_ACTIVATIONS = {None: lambda x: x, "relu": torch.relu, "tanh": torch.tanh,
                "sigmoid": torch.sigmoid}


class Conformer(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        if cfg.use_posi:
            raise NotImplementedError("relative-position keys (use_posi) are not ported")
        if cfg.output_activation not in _ACTIVATIONS:
            raise ValueError(f"unknown output activation {cfg.output_activation}")
        self.cfg = cfg
        self.conformer_layer = nn.ModuleList(_ConformerBlock(cfg) for _ in range(cfg.num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, dim) -> (B, T, dim)."""
        for block in self.conformer_layer:
            x = block(x)
        return _ACTIVATIONS[self.cfg.output_activation](x)
