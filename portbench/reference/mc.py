"""Plain reference of DiariZen's multi-channel segmentation model and its
attention-weighted embeddings (`recipes/diar_ssl_mc`: WavLM + cross-channel
attention fusions + Conformer, SURVEY.md §3.5), inference only, in float32
with TF32 off, on a flat dict of tensors in the checkpoint's key layout
(`channel_fusions.<i>.linearQ` ... `ln_norm`). It imports nothing of the
program, and reuses the single-channel reference's layers
(`segmentation.py`: linear, LayerNorm, WavLM attention and feed-forward,
Conformer block; `embedding.py`: the ResNet34 with its fbank and pooling).

The forward of (B, C, samples) windows:

1. each channel's stream alone: the conv extractor, the feature projection,
   the positional convolution (and the post-LN stack's LayerNorm);
2. fusion 0 on that, then WavLM layers 0..N-2 each followed by fusion
   i + 1, then layer N-1 and the mean over the channels (N fusions);
3. one stream a window: the remaining layers, the weighted sum of the
   hidden states (the first N the fused states' channel means, then the
   channel mean after layer N-1), the projection, the Conformer, the
   powerset head;
4. the channel weights: fusion min(3, N-1)'s attention, averaged over its
   heads, the frames and the querying channels: (B, C), a softmax's rows'
   mean, so a window's weights sum to 1.

A fusion attends across the C channels at every (window, frame): q, k and v
are D -> hidden projections in H heads, the scores and softmax in float32,
the heads' outputs projected back to D, then LayerNorm(out) + input.

The embeddings: each channel's windows through the ResNet34 with the same
(B, S, frames) speaker weights, then summed over the channels under the
window's channel weights.

Departures from SURVEY.md §3.5, as the port and the JAX package have them:
one relative-position bias serves every stream, since it does not depend on
the channel; no layer drop and no dropout (inference); the channel weights
are used as they are (a softmax's mean, no renormalisation); the powerset
argmax, median filter and speaker count are the single-channel pipeline's,
and the embeddings read the plain masks (no exclusion of overlapped frames).

`Precision` (segmentation.py) rounds the operands of every product, the
fusions' included, for the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.embedding import Embedding
from portbench.reference.segmentation import EPS, Precision, Segmentation, relative_buckets
from portbench.reference.segmentation import param_specs as segmentation_specs

WEIGHT_FUSION = 3  # the fusion whose attention weighs the channels (clamped to the last)


def param_specs(arch: dict) -> list:
    """(name, shape, kind, fan_in) of every tensor of the multi-channel
    model: the single-channel model's, then the fusions' (cross-channel
    attention: four D <-> hidden products and a LayerNorm a fusion)."""
    d, fusion = arch["wavlm"]["embed_dim"], arch["fusion"]
    hidden = fusion["hidden"]
    out = list(segmentation_specs(arch))
    for i in range(fusion["num_fusion_layers"]):
        p = f"channel_fusions.{i}."
        for name in ("linearQ", "linearK", "linearV"):
            out.append((p + name + ".weight", (hidden, d), "w", d))
            out.append((p + name + ".bias", (hidden,), "b", d))
        out.append((p + "linearO.weight", (d, hidden), "w", hidden))
        out.append((p + "linearO.bias", (d,), "b", hidden))
        out.append((p + "ln_norm.weight", (d,), "norm_w", 1))
        out.append((p + "ln_norm.bias", (d,), "norm_b", 1))
    return out


class McSegmentation(Segmentation):
    """Callable: (B, C, samples) float32 windows -> ((B, frames, classes)
    log-powerset scores, (B, C) channel weights), from `params`."""

    @torch.no_grad()
    def __call__(self, waves: torch.Tensor) -> tuple:
        feat, weights = self._mc_wavlm(waves.float())
        x = self._norm("lnorm", self._linear("proj", feat))
        for i in range(self.arch["eend"]["conformer_layers"]):
            x = self._conformer_block(f"conformer.conformer_layer.{i}.", x)
        return torch.log_softmax(self._linear("classifier", x), dim=-1), weights

    def _streams(self, waves: torch.Tensor) -> torch.Tensor:
        """(N, samples) -> (N, frames, D): extractor, projection, positional
        convolution (and the LayerNorm of a post-LN stack)."""
        w, p, r = self.arch["wavlm"], self.p, self.r
        pre = "wavlm_model."
        x = waves[:, None, :]
        if w["normalize_waveform"]:
            x = F.layer_norm(x, x.shape[-1:], eps=EPS)
        for i, (c, _, stride) in enumerate(w["conv_layers"]):
            lp = f"{pre}feature_extractor.conv_layers.{i}."
            x = F.conv1d(r(x), r(p[lp + "conv.weight"]), p.get(lp + "conv.bias"), stride=stride)
            if w["extractor_mode"] == "layer_norm":
                x = self._norm(lp + "layer_norm", x.transpose(1, 2)).transpose(1, 2)
            elif i == 0:  # GroupNorm with one group a channel
                x = F.group_norm(x, c, p[lp + "layer_norm.weight"], p[lp + "layer_norm.bias"], EPS)
            x = F.gelu(x)
        x = x.transpose(1, 2) * p[pre + "feature_extractor.dummy_weight"]
        fp = pre + "encoder.feature_projection."
        x = self._linear(fp + "projection", self._norm(fp + "layer_norm", x))
        pc = pre + "encoder.transformer.pos_conv_embed.conv."
        v = p[pc + "weight_v"]
        weight = p[pc + "weight_g"] * v / v.norm(dim=(0, 1), keepdim=True)
        k = w["pos_conv_kernel"]
        pos = F.conv1d(r(x.transpose(1, 2)), r(weight), p[pc + "bias"], padding=k // 2,
                       groups=w["pos_conv_groups"])
        if k % 2 == 0:
            pos = pos[..., :-1]
        x = x + F.gelu(pos.transpose(1, 2))
        if not w["layer_norm_first"]:
            x = self._norm(pre + "encoder.transformer.layer_norm", x)
        return x

    def _layer(self, i: int, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """WavLM layer i on (N, frames, D)."""
        w = self.arch["wavlm"]
        lp = f"wavlm_model.encoder.transformer.layers.{i}."
        pre_ln = w["layer_norm_first"]
        if w["use_attention"][i]:
            h = self._norm(lp + "layer_norm", x) if pre_ln else x
            x = x + self._attention(i, lp + "attention.", h, bias)
        if pre_ln:
            if w["use_feed_forward"][i]:
                x = x + self._feed_forward(lp, self._norm(lp + "final_layer_norm", x))
            return x
        x = self._norm(lp + "layer_norm", x)
        if w["use_feed_forward"][i]:
            x = x + self._feed_forward(lp, x)
        return self._norm(lp + "final_layer_norm", x)

    def _fusion(self, i: int, x: torch.Tensor) -> tuple:
        """Cross-channel attention `i` on (B, C, frames, D) -> (fused
        (B, C, frames, D), head-mean attention (B, frames, C, C))."""
        p, r = f"channel_fusions.{i}.", self.r
        heads = self.arch["fusion"]["num_heads"]
        b, c, t, _ = x.shape
        h = x.transpose(1, 2)  # (B, frames, C, D)

        def split(z):  # -> (B, frames, heads, C, hd)
            return z.reshape(b, t, c, heads, -1).transpose(2, 3)

        q, k, v = (split(self._linear(p + n, h)) for n in ("linearQ", "linearK", "linearV"))
        scores = torch.matmul(r(q), r(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
        att = torch.softmax(scores, dim=-1)
        out = torch.matmul(r(att), r(v)).transpose(2, 3).reshape(b, t, c, -1)
        fused = self._norm(p + "ln_norm", self._linear(p + "linearO", out)) + h
        return fused.transpose(1, 2), att.mean(dim=2)

    def _mc_wavlm(self, waves: torch.Tensor) -> tuple:
        """(B, C, samples) -> (the float32 weighted sum of the hidden states
        (B, frames, D), the channel weights (B, C))."""
        w = self.arch["wavlm"]
        b, c, n = waves.shape
        x = self._streams(waves.reshape(b * c, n))
        t = x.shape[1]
        tp = "wavlm_model.encoder.transformer."
        table_name = (tp + "layers.0.attention.rel_attn_embed.weight" if w["use_attention"][0]
                      else tp + "rel_attn_embed.weight")
        buckets = torch.as_tensor(relative_buckets(t, w["num_buckets"], w["max_distance"]),
                                  device=x.device)
        bias = self.p[table_name][buckets].permute(2, 0, 1)  # (H, T, T), every stream's

        fusions = self.arch["fusion"]["num_fusion_layers"]
        hidden, attention = [], []
        x = x.reshape(b, c, t, -1)
        for i in range(fusions):
            x, att = self._fusion(i, x)
            hidden.append(x.mean(dim=1))
            attention.append(att)
            x = self._layer(i, x.reshape(b * c, t, -1), bias).reshape(b, c, t, -1)
        x = x.mean(dim=1)  # one stream a window from here
        hidden.append(x)
        for i in range(fusions, w["num_layers"]):
            x = self._layer(i, x, bias)
            hidden.append(x)
        mix = self.p["weight_sum.weight"].reshape(-1)
        acc = mix[0] * hidden[0]
        for m, h in zip(mix[1:], hidden[1:]):
            acc = acc + m * h
        weights = attention[min(WEIGHT_FUSION, fusions - 1)].mean(dim=(1, 2))
        return acc, weights


def fused_embeddings(emb: Embedding, windows: torch.Tensor, weights: torch.Tensor,
                     channel_weights: torch.Tensor) -> torch.Tensor:
    """(B, C, samples) windows, (B, S, frames) speaker weights and (B, C)
    channel weights -> (B, S, embed): each channel's embeddings, summed
    under the channel weights."""
    out = 0.0
    for c in range(windows.shape[1]):
        out = out + channel_weights[:, c, None, None] * emb(windows[:, c], weights)
    return out
