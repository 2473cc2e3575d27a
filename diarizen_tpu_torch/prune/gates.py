"""Prunable-unit gate sets for WavLM and the analytic parameter count (port
of diarizen_tpu/prune/gates.py).

The prunable units: conv front-end channels (per conv layer), attention heads
and whole attention layers, feed-forward intermediate features and whole
feed-forward layers, with `layerwise_prune_range` forcing the layer gates
on inside a 1-based inclusive range of layers.

A gate tree has the JAX package's shape, `{"conv": [(C_i,) ...] (only when
conv channels are pruned), "layers": [{"heads", "attn_layer", "ff_interm",
"ff_layer"} ...]}`, so log-alphas carry across one for one. The trainable
tree holds float32 log-alphas; `sample_gates` and `compile_gates` turn it
into the mask tree that `WavLM(gates=)` applies. `gate_leaves` names the
leaves ("conv.0", "layers.3.heads") in the JAX package's flattening order
(dict keys sorted), which the optimizer groups and checkpoints use.
`expected_num_params` is the differentiable parameter count of the
Lagrangian sparsity objective.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from diarizen_tpu_torch.models.wavlm import WavLMConfig
from diarizen_tpu_torch.prune.hardconcrete import (
    compiled_mask,
    init_log_alpha,
    l0_norm,
    sample_mask,
)

GateTree = Dict


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    prune_conv_channels: bool = False
    prune_attention_heads: bool = True
    prune_attention_layer: bool = True
    prune_feed_forward_intermediate: bool = True
    prune_feed_forward_layer: bool = True
    layerwise_prune_range: Optional[Tuple[int, int]] = None  # 1-based inclusive

    def layer_gates_enabled(self, i: int) -> Tuple[bool, bool]:
        """(attn_layer, ff_layer) gates of 0-based layer i: both on inside
        the layerwise range, the global flags outside it."""
        if self.layerwise_prune_range is not None:
            lo, hi = self.layerwise_prune_range
            if lo - 1 <= i <= hi - 1:
                return True, True
        return self.prune_attention_layer, self.prune_feed_forward_layer


def init_gates(cfg: WavLMConfig, pcfg: PruneConfig,
               generator: Optional[torch.Generator] = None) -> GateTree:
    """The trainable log-alpha tree: init mean 0.01 for layer, head and
    channel gates, 0.5 for feed-forward intermediates."""
    gates: GateTree = {}
    if pcfg.prune_conv_channels:
        gates["conv"] = [init_log_alpha(out_ch, 0.01, generator=generator)
                         for out_ch, _, _ in cfg.conv_layers]
    layers = []
    for i in range(cfg.num_layers):
        attn_l, ff_l = pcfg.layer_gates_enabled(i)
        layer: Dict[str, torch.Tensor] = {}
        if cfg.use_attention[i]:
            if pcfg.prune_attention_heads:
                layer["heads"] = init_log_alpha(len(cfg.remaining_heads[i]), 0.01,
                                                generator=generator)
            if attn_l:
                layer["attn_layer"] = init_log_alpha(1, 0.01, generator=generator)
        if cfg.use_feed_forward[i]:
            if pcfg.prune_feed_forward_intermediate:
                layer["ff_interm"] = init_log_alpha(cfg.ff_interm_features[i], 0.5,
                                                    generator=generator)
            if ff_l:
                layer["ff_layer"] = init_log_alpha(1, 0.01, generator=generator)
        layers.append(layer)
    gates["layers"] = layers
    return gates


def gate_leaves(tree: GateTree) -> List[Tuple[str, torch.Tensor]]:
    """(name, leaf) pairs in the JAX package's flattening order."""
    out = [(f"conv.{i}", g) for i, g in enumerate(tree.get("conv") or [])]
    for i, layer in enumerate(tree.get("layers") or []):
        out += [(f"layers.{i}.{k}", layer[k]) for k in sorted(layer)]
    return out


def map_gates(fn: Callable, tree: GateTree) -> GateTree:
    """The tree of fn(leaf), same shape."""
    out: GateTree = {}
    if "conv" in tree:
        out["conv"] = [fn(g) for g in tree["conv"]]
    out["layers"] = [{k: fn(v) for k, v in layer.items()} for layer in tree.get("layers", [])]
    return out


def gates_from_flat(flat: Dict[str, torch.Tensor], num_layers: int) -> GateTree:
    """Inverse of `gate_leaves` (as a dict): layers without gates come back
    as empty dicts."""
    tree: GateTree = {"layers": [{} for _ in range(num_layers)]}
    conv = sorted(((int(k.split(".")[1]), v) for k, v in flat.items() if k.startswith("conv.")))
    if conv:
        tree["conv"] = [v for _, v in conv]
    for name, value in flat.items():
        if name.startswith("layers."):
            _, i, key = name.split(".")
            tree["layers"][int(i)][key] = value
    return tree


def sample_gates(log_alphas: GateTree, generator: Optional[torch.Generator] = None) -> GateTree:
    """Train-time stochastic masks (same tree), drawn from `generator`."""
    return map_gates(lambda la: sample_mask(la, generator), log_alphas)


def compile_gates(log_alphas: GateTree) -> GateTree:
    """Deterministic eval masks (host numpy), on the log-alphas' device."""
    return map_gates(lambda la: torch.as_tensor(
        compiled_mask(la.detach().cpu().numpy()), device=la.device), log_alphas)


def expected_num_params(cfg: WavLMConfig, log_alphas: GateTree) -> torch.Tensor:
    """Differentiable WavLM parameter count under the gate distribution: the
    conv chain threads expected channel counts; attention and feed-forward
    counts scale with the expected heads and intermediates and the layer
    gates' l0 norms."""
    total = torch.zeros(())
    conv_gates = log_alphas.get("conv")
    in_ch = torch.ones(())
    for i, (out_ch, kernel, _) in enumerate(cfg.conv_layers):
        ch = l0_norm(conv_gates[i]) if conv_gates is not None else torch.tensor(float(out_ch))
        n = in_ch * ch * kernel
        if cfg.conv_bias:
            n = n + ch
        if (cfg.extractor_mode == "group_norm" and i == 0) or cfg.extractor_mode == "layer_norm":
            n = n + 2 * ch
        total = total + n
        in_ch = ch
    total = total + in_ch  # the dummy weight slot of the reference's counter

    d = float(cfg.embed_dim)
    total = total + in_ch * 2 + (in_ch + 1) * d  # feature projection: LN + Linear
    total = total + cfg.pos_conv_kernel * d * d / cfg.pos_conv_groups + d  # pos conv
    total = total + 2 * d  # the transformer's LayerNorm

    hd = float(cfg.head_dim)
    layer_gates = log_alphas.get("layers", [None] * cfg.num_layers)
    for i in range(cfg.num_layers):
        g = layer_gates[i] or {}
        total = total + 4 * d  # two layer norms
        if cfg.use_attention[i]:
            nh = (l0_norm(g["heads"]) if g.get("heads") is not None
                  else torch.tensor(float(len(cfg.remaining_heads[i]))))
            attn = (d + 1) * nh * hd * 3 + (nh * hd + 1) * d
            if g.get("attn_layer") is not None:
                attn = attn * l0_norm(g["attn_layer"])
            total = total + attn
        if cfg.use_feed_forward[i]:
            ff = (l0_norm(g["ff_interm"]) if g.get("ff_interm") is not None
                  else torch.tensor(float(cfg.ff_interm_features[i])))
            ffn = (d + 1) * ff + (ff + 1) * d
            if g.get("ff_layer") is not None:
                ffn = ffn * l0_norm(g["ff_layer"])
            total = total + ffn
    # the relative-position table and the GRU gates: small and never pruned
    total = total + cfg.num_buckets * cfg.total_num_heads[0]
    for i in range(cfg.num_layers):
        if cfg.use_attention[i]:
            total = total + (hd + 1) * 8 + cfg.total_num_heads[i]
    return total
