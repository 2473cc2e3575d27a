"""Plain reference of the fine-tuning step: WavLM + Conformer + powerset
head in train mode (DiariZen's `recipes/diar_ssl`: dropout 0.1 after the
projection, after the positional convolution, on the attention output and
after the feed-forward; attention dropout 0.1; layer drop; GradMultiply 0.1
on the conv features; Conformer dropout 0.1 with BatchNorm on batch
statistics), permutation-invariant powerset NLL, and the recipe's optimizer
(AdamW at 2e-5 on WavLM and 1e-3 on the rest, weight decay 0.01, behind
AutoClip at the 90th percentile of the gradient-norm history). Float32, by
autograd; `Precision` rounds the operands of every product for the control.

The random draws follow the published recipe's order, and the order is
what makes two implementations of one seeded step comparable: a host
generator seeded with seed * 1000003 + step draws the device generator's
seed, then per layer the layer-drop uniform and, for a computed attention
layer, the seed of its attention-dropout mask; the device generator draws
each dropout mask in the forward's order. The attention-dropout mask is the
hash of (seed, batch index, head, row, column) that the JAX package's
kernel defines (`_dropout_mask`), applied to the normalised weights. Imports
nothing of the program.
"""

from __future__ import annotations

import math
from itertools import permutations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.segmentation import EPS, Precision, powerset_mapping, relative_buckets

U32 = 0xFFFFFFFF
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


class Randomness:
    """The draws of one training forward."""

    def __init__(self, seed: int, step: int, device):
        self.host = torch.Generator(device="cpu").manual_seed(seed * 1_000_003 + step)
        self.device = torch.Generator(device=device)
        self.device.manual_seed(self.seed())

    def seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.host)) % (2**31 - 1)

    def uniform(self) -> float:
        return float(torch.rand((1,), generator=self.host))


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    keep = 1.0 - rate
    mask = torch.empty(x.shape, device=x.device).bernoulli_(keep, generator=gen)
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def attention_keep(seed: int, b: int, h: int, t: int, rate: float, device) -> torch.Tensor:
    """(b, h, t, t) attention-dropout mask in {0, 1 / (1 - rate)}: keep where
    the hash of (seed, batch, head, row, column) is at least rate * (2^32 - 1)."""
    threshold = int(rate * (2**32 - 1))
    keep = float(np.float32(1.0) / np.float32(1.0 - rate))
    bi = torch.arange(b, device=device).view(-1, 1, 1, 1)
    hi = torch.arange(h, device=device).view(1, -1, 1, 1)
    s0 = ((int(seed) & U32) + _mul32(bi, 0x9E3779B1) + _mul32(hi, 0x85EBCA77)) & U32
    s0 = s0 ^ (s0 >> 16)
    s0 = _mul32(s0, 0x85EBCA6B)
    s0 = s0 ^ (s0 >> 13)
    s0 = _mul32(s0, 0xC2B2AE35)
    s1 = s0 ^ (s0 >> 16)
    s2 = _mul32(s1, 0x9E3779B1)
    r = torch.arange(t, device=device).view(1, 1, -1, 1)
    c = torch.arange(t, device=device).view(1, 1, 1, -1)

    def xorshift(x):
        x = x ^ ((x << 13) & U32)
        x = x ^ (x >> 17)
        return x ^ ((x << 5) & U32)

    x = ((((r + s1) & U32) << 16) & U32) ^ ((c + s2) & U32)
    x = xorshift(x)
    x = (x + (r ^ ((c << 11) & U32)) + s1) & U32
    x = xorshift(x)
    return torch.where(x >= threshold, torch.tensor(keep, device=device),
                       torch.tensor(0.0, device=device))


class _Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


class TrainForward:
    """The training forward on a dict of leaf tensors (requires_grad)."""

    def __init__(self, arch: dict, train: dict, params: dict, precision: Precision = Precision()):
        self.arch, self.t, self.p, self.r = arch, train, params, precision

    def _linear(self, name, x):
        return F.linear(self.r(x), self.r(self.p[name + ".weight"]), self.p[name + ".bias"])

    def _norm(self, name, x):
        return F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"], self.p[name + ".bias"], EPS)

    def __call__(self, waves: torch.Tensor, rnd: Randomness) -> torch.Tensor:
        w, p, r, tr = self.arch["wavlm"], self.p, self.r, self.t
        gen = rnd.device
        pre = "wavlm_model."
        x = waves[:, None, :]
        for i, (c, _, stride) in enumerate(w["conv_layers"]):
            lp = f"{pre}feature_extractor.conv_layers.{i}."
            x = F.conv1d(r(x), r(p[lp + "conv.weight"]), stride=stride)
            if i == 0:
                x = F.group_norm(x, c, p[lp + "layer_norm.weight"], p[lp + "layer_norm.bias"], EPS)
            x = F.gelu(x)
        x = x.transpose(1, 2) * p[pre + "feature_extractor.dummy_weight"]
        x = _Scale.apply(x, tr["feature_grad_mult"])
        fp = pre + "encoder.feature_projection."
        x = dropout(self._linear(fp + "projection", self._norm(fp + "layer_norm", x)),
                    tr["projection_dropout"], gen)
        tp = pre + "encoder.transformer."
        pc = tp + "pos_conv_embed.conv."
        v = p[pc + "weight_v"]
        weight = p[pc + "weight_g"] * v / v.norm(dim=(0, 1), keepdim=True)
        k = w["pos_conv_kernel"]
        pos = F.conv1d(r(x.transpose(1, 2)), r(weight), p[pc + "bias"], padding=k // 2,
                       groups=w["pos_conv_groups"])[..., :-1 if k % 2 == 0 else None]
        x = self._norm(tp + "layer_norm", x + F.gelu(pos.transpose(1, 2)))
        x = dropout(x, tr["dropout"], gen)
        t = x.shape[1]
        buckets = torch.as_tensor(relative_buckets(t, w["num_buckets"], w["max_distance"]),
                                  device=x.device)
        bias = p[tp + "layers.0.attention.rel_attn_embed.weight"][buckets].permute(2, 0, 1)
        mix = p["weight_sum.weight"].reshape(-1)
        acc = mix[0] * x
        for i in range(w["num_layers"]):
            if rnd.uniform() >= tr["layer_drop"]:
                lp = f"{tp}layers.{i}."
                h = dropout(self._attention(i, lp + "attention.", x, bias, rnd), tr["dropout"], gen)
                x = self._norm(lp + "layer_norm", x + h)
                f = F.gelu(self._linear(lp + "feed_forward.intermediate_dense", x))
                f = dropout(self._linear(lp + "feed_forward.output_dense", f), tr["dropout"], gen)
                x = self._norm(lp + "final_layer_norm", x + f)
            acc = acc + mix[i + 1] * x
        x = self._norm("lnorm", self._linear("proj", acc))
        for i in range(self.arch["eend"]["conformer_layers"]):
            x = self._conformer_block(f"conformer.conformer_layer.{i}.", x, gen)
        return torch.log_softmax(self._linear("classifier", x), dim=-1)

    def _attention(self, i, a, x, bias, rnd):
        w, r = self.arch["wavlm"], self.r
        b, t, d = x.shape
        total, heads = w["total_num_heads"][i], list(w["remaining_heads"][i])
        hd = d // w["total_num_heads"][0]

        def split(z):
            return z.reshape(b, t, len(heads), hd).transpose(1, 2)

        q, k, v = (split(self._linear(a + n, x)) for n in ("q_proj", "k_proj", "v_proj"))
        gru = self._linear(a + "gru_rel_pos_linear", x.reshape(b, t, total, hd))
        g = torch.sigmoid(gru.reshape(b, t, total, 2, 4).sum(-1))
        const = self.p[a + "gru_rel_pos_const"].reshape(1, 1, total)
        gate = (g[..., 0] * (g[..., 1] * const - 1.0) + 2.0).transpose(1, 2)[:, heads]
        seed = rnd.seed()
        scores = torch.matmul(r(q), r(k).transpose(-1, -2)) / math.sqrt(hd)
        weights = torch.softmax(scores + gate[..., None] * bias[heads][None], dim=-1)
        weights = weights * attention_keep(seed, b, len(heads), t, self.t["attention_dropout"],
                                           x.device)
        out = torch.matmul(r(weights), r(v)).transpose(1, 2).reshape(b, t, len(heads) * hd)
        return self._linear(a + "out_proj", out)

    def _ffn(self, cp, x, gen):
        rate = self.t["conformer_dropout"]
        h = dropout(F.silu(self._linear(cp + "w_1", self._norm(cp + "ln_norm", x))), rate, gen)
        return x + 0.5 * dropout(self._linear(cp + "w_2", h), rate, gen)

    def _conformer_block(self, cp, x, gen):
        p, r, rate = self.p, self.r, self.t["conformer_dropout"]
        x = self._ffn(cp + "ffn1.", x, gen)
        b, t, d = x.shape
        nh = self.arch["eend"]["conformer_heads"]
        h = self._norm(cp + "mha.ln_norm", x)

        def split(z):
            return z.reshape(b, t, nh, d // nh).transpose(1, 2)

        q, k, v = (split(self._linear(cp + "mha.mha." + n, h))
                   for n in ("linearQ", "linearK", "linearV"))
        scores = torch.matmul(r(q), r(k).transpose(-1, -2)) / math.sqrt(d // nh)
        weights = dropout(torch.softmax(scores, dim=-1), rate, gen)
        out = torch.matmul(r(weights), r(v)).transpose(1, 2).reshape(b, t, d)
        x = x + dropout(self._linear(cp + "mha.mha.linearO", out), rate, gen)
        cv = cp + "conv."
        h = self._norm(cv + "ln_norm", x).transpose(1, 2)
        h = F.glu(F.conv1d(r(h), r(p[cv + "pointwise_conv1.weight"]),
                           p[cv + "pointwise_conv1.bias"]), dim=1)
        kc = p[cv + "depthwise_conv.weight"].shape[-1]
        h = F.conv1d(r(h), r(p[cv + "depthwise_conv.weight"]), p[cv + "depthwise_conv.bias"],
                     padding=(kc - 1) // 2, groups=d)
        mean = h.mean(dim=(0, 2), keepdim=True)
        var = ((h - mean) ** 2).mean(dim=(0, 2), keepdim=True)
        h = ((h - mean) * torch.rsqrt(var + EPS) * p[cv + "bn_norm.weight"][:, None]
             + p[cv + "bn_norm.bias"][:, None])
        h = F.conv1d(r(F.silu(h)), r(p[cv + "pointwise_conv2.weight"]),
                     p[cv + "pointwise_conv2.bias"])
        x = x + dropout(h, rate, gen).transpose(1, 2)
        x = self._ffn(cp + "ffn2.", x, gen)
        return self._norm(cp + "ln_norm", x)


def pit_powerset_nll(scores: torch.Tensor, target: torch.Tensor, mapping: np.ndarray):
    """Permutation-invariant powerset NLL: the target's speakers permuted to
    the hard prediction's by the least mean squared difference (the first
    such permutation in lexicographic order), then the NLL of the powerset
    class with the most active speakers in common (the lowest on ties)."""
    m = torch.as_tensor(mapping, device=scores.device)
    pred = m[scores.argmax(dim=-1)]  # (B, F, K)
    k = target.shape[-1]
    perms = torch.as_tensor(list(permutations(range(k))), device=scores.device)
    candidates = target[:, :, perms].movedim(2, 1)  # (B, P, F, K)
    best = perms[((candidates - pred[:, None]) ** 2).mean(dim=(2, 3)).argmin(dim=1)]
    aligned = torch.gather(target, 2, best[:, None, :].expand(-1, target.shape[1], -1))
    classes = (aligned @ m.T).argmax(dim=-1)
    return -torch.gather(scores, -1, classes[..., None])[..., 0].mean()


class Optimizer:
    """AdamW (bias-corrected moments, decoupled weight decay, every parameter
    updated every step) at a learning rate a group, behind percentile
    AutoClip over a history of global gradient norms."""

    def __init__(self, params: dict, lrs: dict, group_of, weight_decay: float,
                 percentile: float, history: int = 1000):
        self.params, self.lrs, self.group_of = params, lrs, group_of
        self.wd, self.percentile, self.history = weight_decay, percentile, history
        self.norms, self.count = [], 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> float:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).item()
        self.norms = (self.norms + [norm])[-self.history:]
        clip = float(np.percentile(np.array(self.norms), self.percentile))
        scale = min(1.0, clip / max(norm, 1e-12))
        self.count += 1
        b1, b2 = BETAS
        for n, p in self.params.items():
            g = grads[n] * scale
            self.mu[n].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            update = (self.mu[n] / (1 - b1 ** self.count)) / (
                (self.nu[n] / (1 - b2 ** self.count)).sqrt() + ADAM_EPS)
            p.add_(update + self.wd * p, alpha=-self.lrs[self.group_of(n)])
        return norm


def reference_steps(arch: dict, train: dict, params: dict, batches: list, seed: int, device,
                    precision: str = "f32") -> dict:
    """The first len(batches) steps from `params` (not changed): each step's
    loss, the first step's gradient by parameter, and the parameters after
    the last step."""
    leaves = {n: t.detach().clone().float() for n, t in params.items() if t.is_floating_point()}
    trained = {n: t.requires_grad_() for n, t in leaves.items()
               if not n.endswith(("running_mean", "running_var"))}
    mapping = powerset_mapping(arch["eend"]["max_speakers_per_chunk"],
                               arch["eend"]["max_speakers_per_frame"])
    opt = Optimizer(trained, {"wavlm": train["lr_wavlm"], "other": train["lr_other"]},
                    lambda n: "wavlm" if n.startswith("wavlm_model.") else "other",
                    train["weight_decay"], train["clip_percentile"])
    forward = TrainForward(arch, train, leaves, Precision(precision))
    losses, first = [], None
    for step, batch in enumerate(batches):
        waves = torch.as_tensor(batch["xs"], device=device)[:, 0].float()
        target = torch.as_tensor(batch["target"], device=device).float()
        scores = forward(waves, Randomness(train["seed"], step, device))
        loss = pit_powerset_nll(scores, target, mapping)
        grads = torch.autograd.grad(loss, list(trained.values()), allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(trained[n]))
                 for n, g in zip(trained, grads)}
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grads": first,
            "params": {n: t.detach() for n, t in trained.items()}}
