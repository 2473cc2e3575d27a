"""Multi-channel front end: cross-channel fusion, the multi-channel WavLM
walk and the multi-channel EEND model (port of diarizen_tpu/models/mc.py).

- `CrossChannelAttention`: attention across the microphones at each (batch,
  frame), behind a LayerNorm whose scale starts near zero (`init_mult`), so
  that a fresh fusion is close to the identity; `TACFusion` is the
  transform-average-concatenate alternative. Both carry the reference's key
  names (`linearQ` ... `ln_norm`; `input_tf.0` / `.1` ... `norm`).
- `wavlm_hidden_states_mc`: the extractor, projection and pos-conv on B·C
  streams, fusion 0 on that input, fusions 1..N-1 after WavLM layers
  0..N-2, the channel mean after layer N-1, one stream a recording after
  that. The relative-position bias does not depend on the channel, so one
  padded bias serves every stream. No layer drop in this walk, as in JAX.
  `mc_extract`, `mc_fuse` and `mc_rest` are its three parts, which the
  serving path's stages also run.
- `McEendModel`: the EEND model with `channel_fusions`; returns the
  log-powerset scores and the head-mean spatial attention of each fusion,
  or, stage by stage for the serving path, the scores and one weight a
  channel reduced on the device.
- `attention_weighted_embeddings`: per-channel speaker embeddings fused
  with channel weights read from one fusion's spatial attention.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diarizen_tpu_torch.models.common import (
    TrainRandom,
    dropout,
    grad_multiply,
    layer_norm,
    linear,
)
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.wavlm import FEATURE_GRAD_MULT, WavLM


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    kind: str = "cross_attention"  # "cross_attention" | "tac"
    num_fusion_layers: int = 4  # fusion 0 on the input, then after WavLM layers 0..N-2
    hidden: int = 256  # h_units (cross attention) / hidden_dim (TAC)
    num_heads: int = 8
    dropout: float = 0.1
    init_mult: float = 1e-2  # the fusion LayerNorm's initial scale


@dataclasses.dataclass(frozen=True)
class McEendConfig(EendConfig):
    """The EEND config with the channel fusion and the number of channels
    the dataset pads or truncates recordings to."""

    fusion: FusionConfig = FusionConfig()
    num_channels: int = 8


class CrossChannelAttention(nn.Module):
    """(B, C, T, D) -> (fused (B, C, T, D), float32 attention (B, T, H, C, C)).
    Scores and softmax in float32; the attention dropout draws from the
    step's generator."""

    def __init__(self, n_units: int, fcfg: FusionConfig):
        super().__init__()
        self.num_heads, self.rate = fcfg.num_heads, fcfg.dropout
        self.linearQ = nn.Linear(n_units, fcfg.hidden)
        self.linearK = nn.Linear(n_units, fcfg.hidden)
        self.linearV = nn.Linear(n_units, fcfg.hidden)
        self.linearO = nn.Linear(fcfg.hidden, n_units)
        self.ln_norm = nn.LayerNorm(n_units)
        with torch.no_grad():
            self.ln_norm.weight.fill_(fcfg.init_mult)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        b, c, t, _ = x.shape
        nh = self.num_heads
        h = x.transpose(1, 2)  # (B, T, C, D)

        def split(layer):  # -> (B*T, H, C, hd)
            return linear(layer, h).reshape(b * t, c, nh, -1).transpose(1, 2)

        q, k, v = split(self.linearQ), split(self.linearK), split(self.linearV)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
        att = torch.softmax(scores, dim=-1)
        out = torch.matmul(dropout(att, self.rate, generator).to(v.dtype), v)
        out = out.transpose(1, 2).reshape(b, t, c, -1).transpose(1, 2)
        fused = layer_norm(self.ln_norm, linear(self.linearO, out)) + x
        return fused, att.reshape(b, t, nh, c, c)


def _prelu(block: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """Linear then PReLU, the reference's `nn.Sequential(Linear, PReLU)`."""
    y = linear(block[0], x)
    return torch.where(y >= 0, y, block[1].weight.to(y.dtype) * y)


class TACFusion(nn.Module):
    """(B, C, T, D) -> (fused, uniform attention (B, T, 1, C, C))."""

    def __init__(self, input_dim: int, fcfg: FusionConfig):
        super().__init__()
        hidden = fcfg.hidden
        self.input_tf = nn.Sequential(nn.Linear(input_dim, hidden), nn.PReLU())
        self.avg_tf = nn.Sequential(nn.Linear(hidden, hidden), nn.PReLU())
        self.concat_tf = nn.Sequential(nn.Linear(2 * hidden, input_dim), nn.PReLU())
        self.norm = nn.LayerNorm(input_dim)
        with torch.no_grad():
            self.norm.weight.fill_(fcfg.init_mult)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        del generator  # no dropout in TAC
        b, c, t, _ = x.shape
        out = _prelu(self.input_tf, x)
        mean = _prelu(self.avg_tf, out.mean(dim=1))
        out = _prelu(self.concat_tf, torch.cat([out, mean[:, None].expand_as(out)], dim=-1))
        fused = layer_norm(self.norm, out) + x
        return fused, torch.full((b, t, 1, c, c), 1.0 / c, dtype=torch.float32, device=x.device)


def make_fusions(n_units: int, fcfg: FusionConfig) -> nn.ModuleList:
    kinds = {"cross_attention": CrossChannelAttention, "tac": TACFusion}
    if fcfg.kind not in kinds:
        raise ValueError(f"unknown fusion kind {fcfg.kind!r}; options: {sorted(kinds)}")
    return nn.ModuleList(kinds[fcfg.kind](n_units, fcfg) for _ in range(fcfg.num_fusion_layers))


def wavlm_hidden_states_mc(
    wavlm: WavLM,
    fusions: nn.ModuleList,
    waveforms: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    train: bool = False,
    rng: Optional[TrainRandom] = None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(B, C, num_samples) -> (num_layers + 1 hidden states (B, F, D) in the
    compute type, one float32 spatial attention (B, F, H, C, C) a fusion).
    The first len(fusions) hidden states are channel means of the fused
    states, the rest single-stream."""
    if wavlm.mesh is not None:
        raise NotImplementedError(
            "wavlm_hidden_states_mc on a model axis: the multi-channel family runs data "
            "parallel only")
    b, c, _ = waveforms.shape
    x = mc_extract(wavlm, waveforms, compute_dtype, train, rng)
    hidden, attentions, x, position_bias = mc_fuse(wavlm, fusions, x, b, c, train, rng)
    hidden += mc_rest(wavlm, x, position_bias, len(fusions), train, rng)
    wavlm.layers_run = list(range(wavlm.cfg.num_layers))
    return hidden, attentions


def mc_extract(wavlm: WavLM, waveforms: torch.Tensor, compute_dtype: torch.dtype,
               train: bool = False, rng: Optional[TrainRandom] = None) -> torch.Tensor:
    """(B, C, num_samples) -> (B·C, F, D): every channel's stream through the
    waveform's norm, the extractor and the feature projection."""
    cfg = wavlm.cfg
    b, c, n = waveforms.shape
    if cfg.num_frames(n) < 1:
        raise ValueError(f"input of {n} samples is shorter than the conv receptive field")
    if cfg.normalize_waveform:
        waveforms = F.layer_norm(waveforms.float(), (n,), eps=1e-5)
    gen = rng.device if (train and rng is not None) else None
    x = wavlm._feature_extractor(waveforms.reshape(b * c, 1, n).to(compute_dtype), train)
    if train:
        x = grad_multiply(x, FEATURE_GRAD_MULT)
    fp = wavlm.encoder.feature_projection
    return dropout(linear(fp.projection, layer_norm(fp.layer_norm, x)), cfg.projection_dropout,
                   gen)


def mc_fuse(wavlm: WavLM, fusions: nn.ModuleList, x: torch.Tensor, b: int, c: int,
            train: bool = False, rng: Optional[TrainRandom] = None):
    """The encoder on B·C streams: `mc_extract`'s (B·C, F, D) through the
    positional conv, fusion 0, then WavLM layers 0..N-1 each followed by
    fusion i + 1 but the last, which the channel mean follows (N fusions).
    Returns (the N + 1 hidden states so far (B, F, D): the fused states'
    channel means, then the channel mean after layer N-1; the fusions'
    float32 attentions (B, F, H, C, C); the single stream (B, F, D); the
    position bias every layer reads)."""
    cfg = wavlm.cfg
    gen = rng.device if (train and rng is not None) else None
    transformer = wavlm.encoder.transformer
    x = x + wavlm._pos_conv(x)
    if not cfg.layer_norm_first:
        x = layer_norm(transformer.layer_norm, x)
    x = dropout(x, cfg.dropout, gen)
    f = x.shape[1]
    position_bias = wavlm._position_bias(f, x.dtype, x.device, train)

    hidden: List[torch.Tensor] = []
    attentions: List[torch.Tensor] = []

    def fuse(i: int, x: torch.Tensor) -> torch.Tensor:
        x4, att = fusions[i](x.reshape(b, c, f, -1), gen)
        hidden.append(x4.mean(dim=1))
        attentions.append(att)
        return x4.reshape(b * c, f, -1)

    x = fuse(0, x)
    for i, layer in enumerate(transformer.layers[:len(fusions)]):
        x, _ = wavlm._layer(i, layer, x, position_bias, train, rng)
        if i + 1 < len(fusions):
            x = fuse(i + 1, x)
    # the channel mean: one stream a recording from here
    x = x.reshape(b, c, f, -1).mean(dim=1)
    hidden.append(x)
    return hidden, attentions, x, position_bias


def mc_rest(wavlm: WavLM, x: torch.Tensor, position_bias: torch.Tensor, start: int,
            train: bool = False, rng: Optional[TrainRandom] = None) -> List[torch.Tensor]:
    """WavLM layers `start`.. on the single stream (B, F, D): their hidden
    states."""
    hidden = []
    for i, layer in enumerate(wavlm.encoder.transformer.layers[start:], start=start):
        x, _ = wavlm._layer(i, layer, x, position_bias, train, rng)
        hidden.append(x)
    return hidden


class McEendModel(EendModel):
    """EEND over (B, C, num_samples): `channel_fusions` inside the WavLM
    walk, then the weighted sum of the hidden states, the Conformer and the
    powerset head as in `EendModel`.

    `forward(..., stage=)` runs the inference forward in four parts, which
    in turn give the one-piece forward's scores exactly: "extract" the
    (B, C, num_samples) waveforms on B·C streams through the extractor and
    the feature projection (B, C, F, D); "fuse" that through the positional
    conv, the fusions and WavLM layers 0..N-1 to the channel mean, with the
    weighted sum of the hidden states so far and the channel weights;
    "encode" the single stream through the remaining layers to the float32
    weighted sum; "back_end" that through the projection, the Conformer and
    the classifier. Each stage hands the next one tuple of tensors, and the
    last gives (scores, channel weights): fusion `weight_fusion`'s
    head-mean attention averaged over frames and querying channels, (B, C)
    float32, the weights `attention_weighted_embeddings` reads."""

    inference_stages = ("extract", "fuse", "encode", "back_end")
    # the fusion whose attention weighs the channels' embeddings: the
    # reference reads fusion 3 of 4; clamped to the model's last
    weight_fusion = 3

    def __init__(self, cfg: McEendConfig):
        super().__init__(cfg)
        self.channel_fusions = make_fusions(cfg.wavlm.embed_dim, cfg.fusion)

    @property
    def num_channels(self) -> int:
        """The microphones a recording is served on (its channels wrapped or
        cut to these)."""
        return self.cfg.num_channels

    def forward(self, waveforms, compute_dtype: torch.dtype = torch.float32,
                train: bool = False, generator: Optional[torch.Generator] = None,
                num_train_channels: Optional[int] = None, stage: Optional[str] = None):
        """(B, C, num_samples) -> (float32 log-powerset scores (B, F, P),
        float32 head-mean spatial attention (B, L, F, C, C), L the fusions).
        `num_train_channels` keeps the first k channels (the training-time
        channel truncation); `train` and `generator` as in `EendModel`;
        `stage` runs one of `inference_stages` (class docstring)."""
        if stage is not None:
            return self._stage(stage, waveforms, compute_dtype)
        if num_train_channels is not None:
            waveforms = waveforms[:, :num_train_channels]
        rng = TrainRandom(generator, waveforms.device) if (train and generator is not None) else None
        hidden, atts = wavlm_hidden_states_mc(self.wavlm_model, self.channel_fusions, waveforms,
                                              compute_dtype, train, rng)
        feat = self._weighted_sum(hidden)
        scores = self._back_end(feat, compute_dtype, train, rng)
        return scores, torch.stack([a.mean(dim=2) for a in atts], dim=1)

    def _weighted_sum(self, hidden: List[torch.Tensor], start: int = 0,
                      acc: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The float32 sum of `hidden` (states start, start + 1, ...) under
        the layer weights, added to `acc` in order."""
        w = self.weight_sum.weight.reshape(-1).float()
        for wl, h in zip(w[start:], hidden):
            acc = wl * h.float() if acc is None else acc + wl * h.float()
        return acc

    def channel_weights(self, attention: torch.Tensor) -> torch.Tensor:
        """(B, F, H, C, C) float32 attention of fusion `weight_fusion` ->
        (B, C): the heads' mean, then the mean over frames and querying
        channels."""
        return attention.mean(dim=2).mean(dim=(1, 2))

    def _stage(self, stage: str, x, compute_dtype: torch.dtype):
        wavlm, fusions = self.wavlm_model, self.channel_fusions
        if stage == "extract":
            b, c = x.shape[:2]
            return mc_extract(wavlm, x, compute_dtype).reshape(b, c, -1, wavlm.cfg.embed_dim)
        if stage == "fuse":
            b, c, f, d = x.shape
            hidden, atts, x, bias = mc_fuse(wavlm, fusions, x.reshape(b * c, f, d), b, c)
            weights = self.channel_weights(atts[min(self.weight_fusion, len(atts) - 1)])
            return x, self._weighted_sum(hidden), weights, bias
        if stage == "encode":
            x, acc, weights, bias = x
            hidden = mc_rest(wavlm, x, bias, len(fusions))
            return self._weighted_sum(hidden, len(fusions) + 1, acc), weights
        if stage == "back_end":
            feat, weights = x
            return self._back_end(feat, compute_dtype), weights
        raise ValueError(f"unknown stage {stage!r}; the stages are {self.inference_stages}")


def attention_weighted_embeddings(per_channel_embeddings: np.ndarray,
                                  spatial_attention: np.ndarray,
                                  fusion_layer: int = 3) -> np.ndarray:
    """(chunks, C, S, D) embeddings and (chunks, L, F, C, C) attention ->
    (chunks, S, D): each channel weighted by the mean over frames and source
    channels of fusion `fusion_layer`'s attention (rows of a softmax, so the
    weights of a chunk sum to 1; used as they are)."""
    weights = spatial_attention[:, fusion_layer].mean(axis=(1, 2))  # (chunks, C)
    return np.einsum("ncsd,nc->nsd", per_channel_embeddings, weights)
