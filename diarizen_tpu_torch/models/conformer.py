"""Conformer encoder (port of diarizen_tpu/models/conformer.py).

N blocks of macaron FFN (half residual) -> MHSA -> conv module (GLU,
depthwise conv, BatchNorm, swish) -> FFN -> LayerNorm, with the
reference's key layout (`conformer_layer.{i}.{ffn1,mha,conv,ffn2,ln_norm}`).
With `use_posi` the attention logits of every block add relative-position
key scores q · pe_k[clip(i - j)] / sqrt(d_head), from one shared table
(`pos_emb.pe_k`).

Train mode: BatchNorm normalises with the batch statistics (biased
variance) and moves its running statistics in place with momentum 0.1
(unbiased variance), as torch does; across the processes of a group the
statistics are the global batch's; dropout in the FFNs, on the attention
weights and output, and after the conv module, from the device generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from diarizen_tpu_torch.models.common import (
    TrainRandom,
    attention,
    dropout,
    layer_norm,
    linear,
    swish,
)
from diarizen_tpu_torch.parallel.distributed import all_reduce_sum, process_count

BN_MOMENTUM = 0.1


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
    def __init__(self, d: int, hidden: int, rate: float):
        super().__init__()
        self.rate = rate
        self.ln_norm = nn.LayerNorm(d)
        self.w_1 = nn.Linear(d, hidden)
        self.w_2 = nn.Linear(hidden, d)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(swish(linear(self.w_1, layer_norm(self.ln_norm, x))), self.rate, gen)
        return x + 0.5 * dropout(linear(self.w_2, h), self.rate, gen)


class _Projections(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.linearQ = nn.Linear(d, d)
        self.linearK = nn.Linear(d, d)
        self.linearV = nn.Linear(d, d)
        self.linearO = nn.Linear(d, d)


class _MHA(nn.Module):
    def __init__(self, d: int, num_heads: int, rate: float):
        super().__init__()
        self.num_heads = num_heads
        self.rate = rate
        self.ln_norm = nn.LayerNorm(d)
        self.mha = _Projections(d)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None,
                pos_k: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, d = x.shape
        h = layer_norm(self.ln_norm, x)
        nh = self.num_heads

        def split(z):
            return z.reshape(b, t, nh, d // nh).transpose(1, 2)

        q = split(linear(self.mha.linearQ, h))
        bias = None
        if pos_k is not None:  # (T, T, d_head) relative-position keys
            bias = torch.einsum("bhtd,tsd->bhts", q.float(), pos_k.float()) / math.sqrt(d // nh)
        out = attention(q, split(linear(self.mha.linearK, h)),
                        split(linear(self.mha.linearV, h)), self.rate, gen, bias=bias)
        out = linear(self.mha.linearO, out.transpose(1, 2).reshape(b, t, d))
        return x + dropout(out, self.rate, gen)


class _ConvModule(nn.Module):
    def __init__(self, d: int, kernel_size: int, rate: float):
        super().__init__()
        self.rate = rate
        self.ln_norm = nn.LayerNorm(d)
        self.pointwise_conv1 = nn.Conv1d(d, 2 * d, 1)
        self.depthwise_conv = nn.Conv1d(d, d, kernel_size, groups=d)
        self.bn_norm = nn.BatchNorm1d(d)
        self.pointwise_conv2 = nn.Conv1d(d, d, 1)
        self.mesh = None  # the mesh a split model trains on (`parallel.mesh.shard_model_`)

    @staticmethod
    def _conv(conv: nn.Conv1d, x: torch.Tensor, **kw) -> torch.Tensor:
        return F.conv1d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        d = x.shape[-1]
        h = layer_norm(self.ln_norm, x).transpose(1, 2)  # (B, C, T)
        a, g = self._conv(self.pointwise_conv1, h).chunk(2, dim=1)
        h = a * torch.sigmoid(g)  # GLU over channels
        k = self.depthwise_conv.kernel_size[0]
        h = self._conv(self.depthwise_conv, h, padding=(k - 1) // 2, groups=d)
        h = self._batch_norm(h, train)
        h = self._conv(self.pointwise_conv2, swish(h))
        return x + dropout(h, self.rate, gen).transpose(1, 2)

    def _batch_norm(self, h: torch.Tensor, train: bool) -> torch.Tensor:
        """BatchNorm1d over (B, C, T) in float32: batch statistics in train
        mode (which also move the running ones), running ones otherwise. In
        a process group the batch statistics are those of the global batch,
        as the JAX package's batch sharded over the mesh has them: the sums
        are all-reduced over the data axis of `mesh` (the world without one;
        differentiably, so their gradients reach every process's inputs),
        and every process holds a batch of the same size."""
        bn, hf = self.bn_norm, h.float()
        if train:
            group = None if self.mesh is None else self.mesh.data_group
            n = hf.shape[0] * hf.shape[2] * process_count(group)
            mean = all_reduce_sum(hf.sum(dim=(0, 2)), group) / n
            var = all_reduce_sum(((hf - mean[:, None]) ** 2).sum(dim=(0, 2)), group) / n
            with torch.no_grad():
                m = BN_MOMENTUM
                bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
                bn.running_var.copy_((1 - m) * bn.running_var + m * (var * n / max(n - 1, 1)))
        else:
            mean, var = bn.running_mean, bn.running_var
        y = (hf - mean[:, None]) * torch.rsqrt(var[:, None] + bn.eps)
        return (y * bn.weight[:, None] + bn.bias[:, None]).to(h.dtype)


class _ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.ffn1 = _FFN(cfg.dim, cfg.ffn_hidden, cfg.dropout)
        self.mha = _MHA(cfg.dim, cfg.num_heads, cfg.dropout)
        self.conv = _ConvModule(cfg.dim, cfg.kernel_size, cfg.dropout)
        self.ffn2 = _FFN(cfg.dim, cfg.ffn_hidden, cfg.dropout)
        self.ln_norm = nn.LayerNorm(cfg.dim)

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None,
                pos_k: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.mha(self.ffn1(x, gen), gen, pos_k)
        x = self.ffn2(self.conv(x, train, gen), gen)
        return layer_norm(self.ln_norm, x)


_ACTIVATIONS = {None: lambda x: x, "relu": torch.relu, "tanh": torch.tanh,
                "sigmoid": torch.sigmoid}


class _RelativePositionKeys(nn.Module):
    def __init__(self, maxlen: int, head_dim: int):
        super().__init__()
        self.maxlen = maxlen
        self.pe_k = nn.Embedding(2 * maxlen, head_dim)

    def forward(self, t: int) -> torch.Tensor:
        """(T, T, head_dim) keys of the offsets i - j, clipped to
        [-maxlen, maxlen - 1]."""
        pos = torch.arange(t, device=self.pe_k.weight.device)
        offset = (pos[:, None] - pos[None, :]).clamp(-self.maxlen, self.maxlen - 1)
        return self.pe_k.weight[offset + self.maxlen]


class Conformer(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        if cfg.output_activation not in _ACTIVATIONS:
            raise ValueError(f"unknown output activation {cfg.output_activation}")
        self.cfg = cfg
        self.conformer_layer = nn.ModuleList(_ConformerBlock(cfg) for _ in range(cfg.num_layers))
        if cfg.use_posi:
            self.pos_emb = _RelativePositionKeys(cfg.posi_maxlen, cfg.dim // cfg.num_heads)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[TrainRandom] = None) -> torch.Tensor:
        """(B, T, dim) -> (B, T, dim). `train` selects BatchNorm's batch
        statistics; dropout needs `rng` as well."""
        gen = rng.device if (train and rng is not None) else None
        pos_k = self.pos_emb(x.shape[1]) if self.cfg.use_posi else None
        for block in self.conformer_layer:
            x = block(x, train, gen, pos_k)
        return _ACTIVATIONS[self.cfg.output_activation](x)
