"""Plain reference of the segmentation model: WavLM (pruned shapes allowed) ->
weighted sum of the hidden states -> Linear + LayerNorm -> Conformer ->
Linear -> log-softmax over the powerset classes, inference only.

Written from the published architecture (WavLM, arXiv:2110.13900: gated
relative-position bias; Conformer, arXiv:2005.08100; DiariZen's
`model_wavlm_conformer.py`), in float32 with TF32 off, on a flat dict of
tensors in the released checkpoint's key layout. It imports nothing of the
program. `Precision` rounds the two operands of every product (linear,
convolution, attention), so the same code also computes the lower-precision
control.
"""

from __future__ import annotations

import math
from itertools import combinations

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-5
FP8_MAX = 448.0  # largest float8_e4m3fn value


class Precision:
    """Rounds an operand of a product: "f32" leaves it, "bf16" rounds it to
    bfloat16, "fp8" to float8 e4m3 with one scale per tensor (its largest
    magnitude at 448). The products themselves run in float32. The rounding
    passes gradients through unrounded (a training control rounds what its
    products read, not the gradients that flow back)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return x
        with torch.no_grad():
            if self.kind == "bf16":
                rounded = x.to(torch.bfloat16).float()
            else:
                scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
                rounded = (x / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (rounded - x).detach()


def powerset_mapping(num_speakers: int, max_per_frame: int) -> np.ndarray:
    """(classes, speakers) 0/1 matrix: classes by set size, then
    lexicographically ({}, {0}, {1}, ..., {0, 1}, ...)."""
    rows = [set(c) for size in range(max_per_frame + 1)
            for c in combinations(range(num_speakers), size)]
    mapping = np.zeros((len(rows), num_speakers), np.float32)
    for i, members in enumerate(rows):
        mapping[i, list(members)] = 1.0
    return mapping


def num_frames(arch: dict, num_samples: int) -> int:
    n = num_samples
    for _, kernel, stride in arch["wavlm"]["conv_layers"]:
        n = (n - kernel) // stride + 1
    return n


def frame_grid(arch: dict, sample_rate: int) -> tuple:
    """(step, duration) in seconds of the output frames: the receptive field
    of one frame of the conv stack, and the distance between two."""
    size, step = 1, 1
    for _, kernel, stride in reversed(arch["wavlm"]["conv_layers"]):
        size = (size - 1) * stride + kernel
    for _, _, stride in arch["wavlm"]["conv_layers"]:
        step *= stride
    return step / sample_rate, size / sample_rate


def param_specs(arch: dict) -> list:
    """(name, shape, kind, fan_in) of every tensor of the segmentation model,
    in the released checkpoint's key layout. `kind` tells the weight maker
    how to draw it (portbench/weights.py)."""
    w, e = arch["wavlm"], arch["eend"]
    d, hd = w["embed_dim"], w["embed_dim"] // w["total_num_heads"][0]
    out = []

    def linear(name, n_out, n_in, kind="w"):
        out.append((f"{name}.weight", (n_out, n_in), kind, n_in))
        out.append((f"{name}.bias", (n_out,), "b", n_in))

    def norm(name, n):
        out.append((f"{name}.weight", (n,), "norm_w", 1))
        out.append((f"{name}.bias", (n,), "norm_b", 1))

    p = "wavlm_model."
    convs = w["conv_layers"]
    out.append((p + "feature_extractor.dummy_weight", (convs[-1][0],), "ones", 1))
    c_in = 1
    for i, (c, k, _) in enumerate(convs):
        out.append((f"{p}feature_extractor.conv_layers.{i}.conv.weight", (c, c_in, k), "w",
                    c_in * k))
        if w["conv_bias"]:
            out.append((f"{p}feature_extractor.conv_layers.{i}.conv.bias", (c,), "b", c_in * k))
        if w["extractor_mode"] == "layer_norm" or i == 0:
            norm(f"{p}feature_extractor.conv_layers.{i}.layer_norm", c)
        c_in = c
    norm(p + "encoder.feature_projection.layer_norm", c_in)
    linear(p + "encoder.feature_projection.projection", d, c_in)
    pc = p + "encoder.transformer.pos_conv_embed.conv."
    groups, kpos = w["pos_conv_groups"], w["pos_conv_kernel"]
    out.append((pc + "weight_g", (1, 1, kpos), "weight_g", 1))
    out.append((pc + "weight_v", (d, d // groups, kpos), "w", d // groups * kpos))
    out.append((pc + "bias", (d,), "b", d // groups * kpos))
    norm(p + "encoder.transformer.layer_norm", d)
    for i in range(w["num_layers"]):
        lp = f"{p}encoder.transformer.layers.{i}."
        if w["use_attention"][i]:
            inner = len(w["remaining_heads"][i]) * hd
            a = lp + "attention."
            out.append((a + "gru_rel_pos_const", (1, w["total_num_heads"][i], 1, 1), "ones", 1))
            for proj in ("q_proj", "k_proj", "v_proj"):
                linear(a + proj, inner, d)
            linear(a + "out_proj", d, inner)
            linear(a + "gru_rel_pos_linear", 8, hd)
            if i == 0:
                out.append((a + "rel_attn_embed.weight",
                            (w["num_buckets"], w["total_num_heads"][0]), "embed", 1))
        norm(lp + "layer_norm", d)
        if w["use_feed_forward"][i]:
            linear(lp + "feed_forward.intermediate_dense", w["ff_interm_features"][i], d)
            linear(lp + "feed_forward.output_dense", d, w["ff_interm_features"][i])
        norm(lp + "final_layer_norm", d)
    if not w["use_attention"][0]:
        out.append((p + "encoder.transformer.rel_attn_embed.weight",
                    (w["num_buckets"], w["total_num_heads"][0]), "embed", 1))
    layers, a_in = e["wavlm_layer_num"], e["attention_in"]
    out.append(("weight_sum.weight", (1, layers), "w", layers))
    linear("proj", a_in, e["wavlm_feat_dim"])
    norm("lnorm", a_in)
    ffn = e["conformer_ffn_hidden"]
    for i in range(e["conformer_layers"]):
        cp = f"conformer.conformer_layer.{i}."
        for f in ("ffn1", "ffn2"):
            norm(cp + f + ".ln_norm", a_in)
            linear(cp + f + ".w_1", ffn, a_in)
            linear(cp + f + ".w_2", a_in, ffn)
        norm(cp + "mha.ln_norm", a_in)
        for proj in ("linearQ", "linearK", "linearV", "linearO"):
            linear(cp + "mha.mha." + proj, a_in, a_in)
        norm(cp + "conv.ln_norm", a_in)
        out.append((cp + "conv.pointwise_conv1.weight", (2 * a_in, a_in, 1), "w", a_in))
        out.append((cp + "conv.pointwise_conv1.bias", (2 * a_in,), "b", a_in))
        kc = e["conformer_kernel"]
        out.append((cp + "conv.depthwise_conv.weight", (a_in, 1, kc), "w", kc))
        out.append((cp + "conv.depthwise_conv.bias", (a_in,), "b", kc))
        norm(cp + "conv.bn_norm", a_in)
        out.append((cp + "conv.bn_norm.running_mean", (a_in,), "bn_mean", 1))
        out.append((cp + "conv.bn_norm.running_var", (a_in,), "bn_var", 1))
        out.append((cp + "conv.bn_norm.num_batches_tracked", (), "count", 1))
        out.append((cp + "conv.pointwise_conv2.weight", (a_in, a_in, 1), "w", a_in))
        out.append((cp + "conv.pointwise_conv2.bias", (a_in,), "b", a_in))
        norm(cp + "ln_norm", a_in)
    classes = len(powerset_mapping(e["max_speakers_per_chunk"], e["max_speakers_per_frame"]))
    linear("classifier", classes, a_in, kind="classifier")
    return out


def relative_buckets(t: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """WavLM's (T, T) bucket of each key offset: half the buckets for keys
    after the query, exact below a quarter of them, logarithmic above,
    saturating at `max_distance`."""
    rel = np.arange(t)[None, :] - np.arange(t)[:, None]
    half = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * half
    rel = np.abs(rel)
    exact = half // 2
    log_part = exact + (np.log(np.maximum(rel, 1).astype(np.float32) / exact)
                        / np.log(max_distance / exact) * (half - exact)).astype(np.int64)
    return buckets + np.where(rel < exact, rel, np.minimum(log_part, half - 1))


class Segmentation:
    """Callable: (B, samples) float32 waveforms -> (B, frames, classes)
    log-powerset scores, from the parameter dict `params`."""

    def __init__(self, arch: dict, params: dict, precision: Precision = Precision()):
        self.arch, self.p, self.r = arch, params, precision

    def _linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.r(x), self.r(self.p[name + ".weight"]), self.p[name + ".bias"])

    def _norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"], self.p[name + ".bias"], EPS)

    @torch.no_grad()
    def __call__(self, waves: torch.Tensor) -> torch.Tensor:
        x = self._norm("lnorm", self._linear("proj", self._wavlm(waves.float())))
        for i in range(self.arch["eend"]["conformer_layers"]):
            x = self._conformer_block(f"conformer.conformer_layer.{i}.", x)
        return torch.log_softmax(self._linear("classifier", x), dim=-1)

    # -- WavLM ------------------------------------------------------------

    def _wavlm(self, waves: torch.Tensor) -> torch.Tensor:
        w, p, r = self.arch["wavlm"], self.p, self.r
        pre = "wavlm_model."
        x = waves[:, None, :]
        if w["normalize_waveform"]:
            x = F.layer_norm(x, x.shape[-1:], eps=EPS)
        for i, (c, _, stride) in enumerate(w["conv_layers"]):
            lp = f"{pre}feature_extractor.conv_layers.{i}."
            bias = p.get(lp + "conv.bias")
            x = F.conv1d(r(x), r(p[lp + "conv.weight"]), bias, stride=stride)
            if w["extractor_mode"] == "layer_norm":
                x = self._norm(lp + "layer_norm", x.transpose(1, 2)).transpose(1, 2)
            elif i == 0:  # GroupNorm with one group a channel
                x = F.group_norm(x, c, p[lp + "layer_norm.weight"], p[lp + "layer_norm.bias"], EPS)
            x = F.gelu(x)
        x = x.transpose(1, 2) * p[pre + "feature_extractor.dummy_weight"]
        fp = pre + "encoder.feature_projection."
        x = self._linear(fp + "projection", self._norm(fp + "layer_norm", x))

        tp = pre + "encoder.transformer."
        pc = tp + "pos_conv_embed.conv."
        v = p[pc + "weight_v"]
        weight = p[pc + "weight_g"] * v / v.norm(dim=(0, 1), keepdim=True)
        k = w["pos_conv_kernel"]
        pos = F.conv1d(r(x.transpose(1, 2)), r(weight), p[pc + "bias"], padding=k // 2,
                       groups=w["pos_conv_groups"])
        if k % 2 == 0:
            pos = pos[..., :-1]
        x = x + F.gelu(pos.transpose(1, 2))
        pre_ln = w["layer_norm_first"]
        if not pre_ln:
            x = self._norm(tp + "layer_norm", x)

        t = x.shape[1]
        table_name = (tp + "layers.0.attention.rel_attn_embed.weight" if w["use_attention"][0]
                      else tp + "rel_attn_embed.weight")
        buckets = torch.as_tensor(relative_buckets(t, w["num_buckets"], w["max_distance"]),
                                  device=x.device)
        bias = p[table_name][buckets].permute(2, 0, 1)  # (H, T, T)

        mix = p["weight_sum.weight"].reshape(-1)
        acc = mix[0] * x
        for i in range(w["num_layers"]):
            lp = f"{tp}layers.{i}."
            if w["use_attention"][i]:
                h = self._norm(lp + "layer_norm", x) if pre_ln else x
                x = x + self._attention(i, lp + "attention.", h, bias)
            if pre_ln:
                if w["use_feed_forward"][i]:
                    x = x + self._feed_forward(lp, self._norm(lp + "final_layer_norm", x))
            else:
                x = self._norm(lp + "layer_norm", x)
                if w["use_feed_forward"][i]:
                    x = x + self._feed_forward(lp, x)
                x = self._norm(lp + "final_layer_norm", x)
            acc = acc + mix[i + 1] * x
        return acc

    def _attention(self, i: int, a: str, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        w, r = self.arch["wavlm"], self.r
        b, t, d = x.shape
        total = w["total_num_heads"][i]
        heads = list(w["remaining_heads"][i])
        hd = d // w["total_num_heads"][0]

        def split(z):
            return z.reshape(b, t, len(heads), hd).transpose(1, 2)

        q, k, v = (split(self._linear(a + n, x)) for n in ("q_proj", "k_proj", "v_proj"))
        # the gate reads every head of the layer's input, pruned ones too
        gru = self._linear(a + "gru_rel_pos_linear", x.reshape(b, t, total, hd))
        g = torch.sigmoid(gru.reshape(b, t, total, 2, 4).sum(-1))
        const = self.p[a + "gru_rel_pos_const"].reshape(1, 1, total)
        gate = (g[..., 0] * (g[..., 1] * const - 1.0) + 2.0).transpose(1, 2)[:, heads]
        scores = torch.matmul(r(q), r(k).transpose(-1, -2)) / math.sqrt(hd)
        scores = scores + gate[..., None] * bias[heads][None]
        out = torch.matmul(r(torch.softmax(scores, dim=-1)), r(v))
        return self._linear(a + "out_proj", out.transpose(1, 2).reshape(b, t, len(heads) * hd))

    def _feed_forward(self, lp: str, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self._linear(lp + "feed_forward.intermediate_dense", x))
        return self._linear(lp + "feed_forward.output_dense", h)

    # -- Conformer --------------------------------------------------------

    def _ffn(self, cp: str, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self._linear(cp + "w_1", self._norm(cp + "ln_norm", x)))
        return x + 0.5 * self._linear(cp + "w_2", h)

    def _conformer_block(self, cp: str, x: torch.Tensor) -> torch.Tensor:
        p, r = self.p, self.r
        x = self._ffn(cp + "ffn1.", x)
        # multi-head self-attention
        b, t, d = x.shape
        nh = self.arch["eend"]["conformer_heads"]
        h = self._norm(cp + "mha.ln_norm", x)

        def split(z):
            return z.reshape(b, t, nh, d // nh).transpose(1, 2)

        q, k, v = (split(self._linear(cp + "mha.mha." + n, h))
                   for n in ("linearQ", "linearK", "linearV"))
        scores = torch.matmul(r(q), r(k).transpose(-1, -2)) / math.sqrt(d // nh)
        out = torch.matmul(r(torch.softmax(scores, dim=-1)), r(v))
        x = x + self._linear(cp + "mha.mha.linearO", out.transpose(1, 2).reshape(b, t, d))
        # convolution module: pointwise, GLU, depthwise, BatchNorm, swish, pointwise
        cv = cp + "conv."
        h = self._norm(cv + "ln_norm", x).transpose(1, 2)
        h = F.conv1d(r(h), r(p[cv + "pointwise_conv1.weight"]), p[cv + "pointwise_conv1.bias"])
        h = F.glu(h, dim=1)
        kc = p[cv + "depthwise_conv.weight"].shape[-1]
        h = F.conv1d(r(h), r(p[cv + "depthwise_conv.weight"]), p[cv + "depthwise_conv.bias"],
                     padding=(kc - 1) // 2, groups=d)
        h = F.batch_norm(h, p[cv + "bn_norm.running_mean"], p[cv + "bn_norm.running_var"],
                         p[cv + "bn_norm.weight"], p[cv + "bn_norm.bias"], False, 0.0, EPS)
        h = F.conv1d(r(F.silu(h)), r(p[cv + "pointwise_conv2.weight"]),
                     p[cv + "pointwise_conv2.bias"])
        x = x + h.transpose(1, 2)
        x = self._ffn(cp + "ffn2.", x)
        return self._norm(cp + "ln_norm", x)
