"""Prune surgery: collapse compiled HardConcrete masks into a smaller WavLM
(port of diarizen_tpu/prune/surgery.py), on the port's state dict.

The kept units' soft mask values are folded into the weights downstream of
them, the pruned units' rows and columns are dropped, and a new
`WavLMConfig` comes out (per-layer remaining-head subsets, uneven
feed-forward widths, `use_attention` / `use_feed_forward` flags), field for
field the JAX package's. The last conv layer's mask stays a post-GELU
output scale (`dummy_weight`), since it does not fold through the projection
LayerNorm. Where layer 0's attention goes, its relative-position table,
which every layer reads, moves to `encoder.transformer.rel_attn_embed`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from diarizen_tpu_torch.models.wavlm import WavLMConfig, count_params
from diarizen_tpu_torch.prune.gates import GateTree
from diarizen_tpu_torch.prune.hardconcrete import compiled_mask

StateDict = Dict[str, torch.Tensor]
count_params_pytree = count_params  # the JAX package's name for the leaf count

_FE = "feature_extractor"
_ENC = "encoder.transformer"


def _masks(log_alphas: GateTree, num_layers: int):
    def host(la) -> np.ndarray:
        return compiled_mask(la.detach().cpu().numpy() if torch.is_tensor(la) else np.asarray(la))

    conv = [host(la) for la in log_alphas["conv"]] if "conv" in log_alphas else None
    layers = [{k: host(la) for k, la in layer.items()}
              for layer in log_alphas.get("layers", [{}] * num_layers)]
    return conv, layers


def _prune_conv(sd: StateDict, cfg: WavLMConfig, masks) -> Tuple:
    """Drop pruned channels of every conv layer; fold each mask into the next
    conv's input columns, the last one into `dummy_weight`."""
    new_layers = list(cfg.conv_layers)
    n = len(cfg.conv_layers)
    for i, mask in enumerate(masks):
        keep = torch.from_numpy(np.nonzero(mask)[0])
        if len(keep) == 0:
            raise ValueError(f"conv layer {i} pruned to zero channels")
        m = torch.from_numpy(mask)
        key = f"{_FE}.conv_layers.{i}"
        for name in (f"{key}.conv.weight", f"{key}.conv.bias", f"{key}.layer_norm.weight",
                     f"{key}.layer_norm.bias"):
            if name in sd:
                sd[name] = sd[name][keep]
        _, kernel, stride = new_layers[i]
        new_layers[i] = (len(keep), kernel, stride)
        if i + 1 < n:
            w = f"{_FE}.conv_layers.{i + 1}.conv.weight"  # (out, in, k)
            sd[w] = (sd[w] * m[None, :, None])[:, keep]
        else:
            sd[f"{_FE}.dummy_weight"] = (sd[f"{_FE}.dummy_weight"] * m)[keep]
            fp = "encoder.feature_projection"
            for name in (f"{fp}.layer_norm.weight", f"{fp}.layer_norm.bias"):
                sd[name] = sd[name][keep]
            sd[f"{fp}.projection.weight"] = sd[f"{fp}.projection.weight"][:, keep]
    return tuple(new_layers)


def _scale_out(sd: StateDict, key: str, scale: float) -> None:
    sd[f"{key}.weight"] = sd[f"{key}.weight"] * scale
    if f"{key}.bias" in sd:
        sd[f"{key}.bias"] = sd[f"{key}.bias"] * scale


def _drop(sd: StateDict, prefix: str) -> None:
    for name in [k for k in sd if k.startswith(prefix + ".")]:
        del sd[name]


def apply_pruning(state_dict: StateDict, cfg: WavLMConfig,
                  log_alphas: GateTree) -> Tuple[StateDict, WavLMConfig]:
    """(gated WavLM state dict, cfg, log-alphas) -> (pruned state dict on the
    CPU, pruned cfg); the state dict loads into `WavLM(pruned cfg)`."""
    sd = {k: v.detach().cpu().clone() for k, v in state_dict.items()}
    conv_masks, layer_masks = _masks(log_alphas, cfg.num_layers)
    conv_layers = cfg.conv_layers if conv_masks is None else _prune_conv(sd, cfg, conv_masks)

    hd = cfg.head_dim
    remaining_heads, use_attention, use_ff, ff_interm = [], [], [], []
    for i in range(cfg.num_layers):
        g = layer_masks[i] if i < len(layer_masks) else {}
        key = f"{_ENC}.layers.{i}"
        use_attn = cfg.use_attention[i]
        remaining = list(cfg.remaining_heads[i])
        if use_attn:
            a = f"{key}.attention"
            if "attn_layer" in g:
                lm = float(g["attn_layer"][0])
                _scale_out(sd, f"{a}.out_proj", lm)
                use_attn = lm != 0.0
            if use_attn and "heads" in g:
                keep_heads = np.nonzero(g["heads"])[0]
                if len(keep_heads) == 0:
                    use_attn = False
                else:
                    full_mask = torch.from_numpy(np.repeat(g["heads"], hd))
                    full_keep = torch.from_numpy(np.nonzero(full_mask.numpy())[0])
                    for proj in ("q_proj", "k_proj", "v_proj"):
                        sd[f"{a}.{proj}.weight"] = sd[f"{a}.{proj}.weight"][full_keep]
                        sd[f"{a}.{proj}.bias"] = sd[f"{a}.{proj}.bias"][full_keep]
                    w = f"{a}.out_proj.weight"  # (d, nh * hd)
                    sd[w] = (sd[w] * full_mask[None, :])[:, full_keep]
                    remaining = [remaining[j] for j in keep_heads]
            if not use_attn:
                if i == 0:
                    sd[f"{_ENC}.rel_attn_embed.weight"] = sd.pop(f"{a}.rel_attn_embed.weight")
                _drop(sd, a)
                remaining = []

        use_f = cfg.use_feed_forward[i]
        ff_dim = cfg.ff_interm_features[i]
        if use_f:
            f = f"{key}.feed_forward"
            if "ff_layer" in g:
                lm = float(g["ff_layer"][0])
                _scale_out(sd, f"{f}.output_dense", lm)
                use_f = lm != 0.0
            if use_f and "ff_interm" in g:
                im = g["ff_interm"]
                keep = torch.from_numpy(np.nonzero(im)[0])
                if len(keep) == 0:
                    use_f = False
                else:
                    for name in (f"{f}.intermediate_dense.weight", f"{f}.intermediate_dense.bias"):
                        sd[name] = sd[name][keep]
                    w = f"{f}.output_dense.weight"  # (d, ff)
                    sd[w] = (sd[w] * torch.from_numpy(im)[None, :])[:, keep]
                    ff_dim = len(keep)
            if not use_f:
                _drop(sd, f)
                ff_dim = 0

        remaining_heads.append(tuple(remaining))
        use_attention.append(use_attn)
        use_ff.append(use_f)
        ff_interm.append(ff_dim)

    new_cfg = dataclasses.replace(
        cfg, conv_layers=conv_layers, remaining_heads=tuple(remaining_heads),
        use_attention=tuple(use_attention), use_feed_forward=tuple(use_ff),
        ff_interm_features=tuple(ff_interm))
    return sd, new_cfg
