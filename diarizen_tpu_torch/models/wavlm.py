"""WavLM speech encoder (port of diarizen_tpu/models/wavlm.py).

Modules carry the reference's torch key layout (`feature_extractor.*`,
`encoder.feature_projection.*`, `encoder.transformer.*`), so a reference
WavLM state dict loads with `load_state_dict`. Heterogeneous pruned
configurations (per-layer head subsets and FF widths, layers without
attention) are supported. The self-attention with the gated relative-position
bias runs through kernel K1 (`ops/flash_attention.py`) at inference, and
through K1's training instance and K2 in train mode. With `set_fused_ln(True)`
the post-norm inference forward runs the residual adds, both LayerNorms and
the weighted-sum update of each layer through kernels K3 and K4
(`ops/fused_ln.py`). With `set_conv_chain(True)` the inference forward of an
extractor whose layers 1-6 are the unpruned 512-channel stack without norms
(WavLM-Base) runs those six convolutions and GELUs through kernel K5
(`ops/conv_chain.py`), with layer 0 computed straight into the channels-last
layout K5 takes.

`gates=` applies HardConcrete masks where the JAX package applies them
(pruning, `prune/`): conv channels after each extractor block's GELU, a
per-head mask on the attention output before `out_proj`, the `attn_layer`
scale after it, `ff_interm` after the feed-forward GELU and `ff_layer` on the
feed-forward output; with gates the fused-LN and conv-chain routes are off.
`hidden_states` returns the num_layers + 1 hidden states that the distill
loss reads, where `forward` returns their weighted sum. `extract` and
`encode` are the inference forward in two stages, split after the feature
projection (the EEND model's `forward(..., stage=)`).

On a mesh's model axis (`parallel/mesh.py`, `shard_model_` sets `mesh`) each
rank holds whole heads of every layer's remaining heads and a block of its
FF width. The layer input enters each sublayer through `copy_to_group`
(its gradient summed over the model group), the rank's heads run through
K1 (or K1's training instance with the dropout mask of its heads, and K2),
the rank's columns of out-proj and FF-out give partial sums that
`reduce_from_group` adds, and the replicated bias follows once. The GRU
gate reads every head of the full input, so every rank computes it and
keeps its heads' gates. A rank without heads in a layer launches no K1
there and adds zeros.

Train mode follows the JAX package's `wavlm_extract_features(train=True)`:
GradMultiply 0.1 on the extractor output; dropout after the projection,
after the pos-conv (and its LayerNorm), on the attention output and in the
feed-forward; attention dropout inside the kernels, one int32 seed per layer
drawn on the host; layer drop. A dropped layer is not computed at all (the
JAX package computes it and discards the result), so its parameters get no
gradient; the train step gives them zeros.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diarizen_tpu_torch.models.common import (
    TrainRandom,
    channel_norm_last,
    dropout,
    gelu,
    grad_multiply,
    group_norm,
    layer_norm,
    linear,
)
from diarizen_tpu_torch.ops.conv_chain import (  # noqa: F401 - the switch, public here too
    ConvChainWeights,
    fused_conv_chain,
    num_output_frames,
    pack_weights,
    set_conv_chain,
    use_conv_chain,
)
from diarizen_tpu_torch.ops.flash_attention import (
    bias_row_stride,
    flash_attention_gated_bias,
    flash_attention_gated_bias_trainable,
)
from diarizen_tpu_torch.ops.fused_ln import (  # noqa: F401 - the switch, public here too
    residual_ln,
    residual_ln_acc,
    set_fused_ln,
    use_fused_ln,
)
from diarizen_tpu_torch.parallel.distributed import copy_to_group, reduce_from_group
from diarizen_tpu_torch.parallel.mesh import Mesh
from diarizen_tpu_torch.utils import device_constant

FEATURE_GRAD_MULT = 0.1  # GradMultiply on the extractor output in train mode

DEFAULT_CONV_LAYERS: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 2, 2),
    (512, 2, 2),
)


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    """Architecture description; same fields as the JAX package's."""

    extractor_mode: str = "group_norm"  # "group_norm" (Base) | "layer_norm" (Large)
    conv_layers: Tuple[Tuple[int, int, int], ...] = DEFAULT_CONV_LAYERS
    conv_bias: bool = False
    embed_dim: int = 768
    projection_dropout: float = 0.1
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    num_layers: int = 12
    use_attention: Tuple[bool, ...] = (True,) * 12
    use_feed_forward: Tuple[bool, ...] = (True,) * 12
    total_num_heads: Tuple[int, ...] = (12,) * 12
    remaining_heads: Tuple[Tuple[int, ...], ...] = tuple(tuple(range(12)) for _ in range(12))
    num_buckets: int = 320
    max_distance: int = 800
    attention_dropout: float = 0.1
    ff_interm_features: Tuple[int, ...] = (3072,) * 12
    ff_interm_dropout: float = 0.0
    dropout: float = 0.1
    layer_norm_first: bool = False  # False = post-LN (Base), True = pre-LN (Large)
    layer_drop: float = 0.05
    normalize_waveform: bool = False

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.total_num_heads[0]

    @property
    def conv_out_channels(self) -> int:
        return self.conv_layers[-1][0]

    @property
    def frame_stride(self) -> int:
        s = 1
        for _, _, stride in self.conv_layers:
            s *= stride
        return s

    def num_frames(self, num_samples: int) -> int:
        n = num_samples
        for _, kernel, stride in self.conv_layers:
            n = max(0, (n - kernel) // stride + 1)
        return n

    @staticmethod
    def base() -> "WavLMConfig":
        """WavLM-Base / Base+: 12 layers, 768 wide, 12 heads of 64, ff 3072."""
        return WavLMConfig()

    @staticmethod
    def large() -> "WavLMConfig":
        """WavLM-Large: 24 pre-LN layers, 1024 wide, 16 heads of 64, ff 4096,
        a LayerNorm in every extractor block, normalised waveform."""
        n = 24
        return WavLMConfig(
            extractor_mode="layer_norm",
            conv_bias=False,
            embed_dim=1024,
            num_layers=n,
            use_attention=(True,) * n,
            use_feed_forward=(True,) * n,
            total_num_heads=(16,) * n,
            remaining_heads=tuple(tuple(range(16)) for _ in range(n)),
            ff_interm_features=(4096,) * n,
            layer_norm_first=True,
            layer_drop=0.1,
            normalize_waveform=True,
        )

    @staticmethod
    def base_s80_md() -> "WavLMConfig":
        """DiariZen-Base-s80 multi-domain pruned architecture (the released
        checkpoint's shapes)."""
        return WavLMConfig(
            extractor_mode="group_norm",
            conv_layers=((90, 10, 5), (161, 3, 2), (173, 3, 2), (181, 3, 2),
                         (351, 3, 2), (155, 2, 2), (137, 2, 2)),
            embed_dim=768,
            num_layers=12,
            use_attention=(True, True, True, True, True, True, True, True,
                           False, False, True, True),
            use_feed_forward=(True,) * 12,
            total_num_heads=(12,) * 12,
            remaining_heads=(
                (1, 6), (5, 7, 8), (0, 3, 9), (0, 1, 4, 8, 11), (6, 8), (0,),
                (7, 8, 10, 11), (0, 1, 4, 8), (), (), (4, 7), (5,),
            ),
            ff_interm_features=(666, 660, 649, 1080, 237, 299, 437, 573, 53,
                                80, 211, 334),
            layer_norm_first=False,
            layer_drop=0.05,
            normalize_waveform=False,
        )


    @staticmethod
    def large_s80_md() -> "WavLMConfig":
        """DiariZen-Large-s80 multi-domain pruned architecture (the released
        checkpoint's shapes)."""
        return WavLMConfig(
            extractor_mode="layer_norm",
            conv_layers=((512, 10, 5), (153, 3, 2), (224, 3, 2), (255, 3, 2),
                         (302, 3, 2), (368, 2, 2), (211, 2, 2)),
            embed_dim=1024,
            num_layers=24,
            use_attention=(True, True, True, True, True, True, True, True,
                           True, False, True, True, False, True, True, True,
                           False, False, True, True, True, True, True, True),
            use_feed_forward=(True,) * 24,
            total_num_heads=(16,) * 24,
            remaining_heads=(
                (1, 2, 4, 5, 6), (9, 10, 14), (0, 1, 2, 4, 5, 7),
                (1, 4, 7, 12, 13, 14), (0, 2, 3, 4, 13), (1, 7, 13, 14, 15),
                (11, 13, 15), (2, 3, 4, 8, 15), (2, 5, 6, 15), (), (0, 1),
                (1, 3, 5, 12), (), (4, 7, 11), (6, 9), (11,), (), (), (14,),
                (5, 15), (0, 2, 8, 11, 13, 15), (0, 1, 3, 4, 5, 6, 7, 10, 13),
                (0, 1, 3, 6, 7, 9, 10, 11, 12, 14), (1, 2, 3, 4, 7, 13, 14, 15),
            ),
            ff_interm_features=(1092, 925, 759, 646, 745, 615, 684, 958, 286,
                                294, 406, 377, 463, 542, 298, 236, 96, 104,
                                134, 211, 473, 1011, 1770, 1316),
            layer_norm_first=True,
            layer_drop=0.1,
            normalize_waveform=True,
        )

    @staticmethod
    def from_preset(name: str) -> "WavLMConfig":
        """The preset registry of the reference's `wavlm_src` names."""
        presets = {
            "wavlm_base": WavLMConfig.base,
            "wavlm_base_plus": WavLMConfig.base,
            "wavlm_large": WavLMConfig.large,
            "wavlm_base_s80_md": WavLMConfig.base_s80_md,
            "wavlm_large_s80_md": WavLMConfig.large_s80_md,
        }
        if name.lower() not in presets:
            raise ValueError(f"unknown preset {name}; options: {sorted(presets)}")
        return presets[name.lower()]()

    @staticmethod
    def from_dict(d: dict) -> "WavLMConfig":
        """Rebuild from `dataclasses.asdict` JSON (lists become tuples)."""
        d = dict(d)
        for k in ("conv_layers", "remaining_heads"):
            d[k] = tuple(tuple(x) for x in d[k])
        for k in ("use_attention", "use_feed_forward", "total_num_heads", "ff_interm_features"):
            d[k] = tuple(d[k])
        return WavLMConfig(**d)

    def to_reference_dict(self) -> dict:
        """The reference's factory-kwargs dict (the `config` payload of a
        `{config, state_dict}` checkpoint); `from_reference_dict` inverts it."""
        return {
            "extractor_mode": self.extractor_mode,
            "extractor_conv_layer_config": [list(l) for l in self.conv_layers],
            "extractor_conv_bias": self.conv_bias,
            "encoder_embed_dim": self.embed_dim,
            "encoder_projection_dropout": self.projection_dropout,
            "encoder_pos_conv_kernel": self.pos_conv_kernel,
            "encoder_pos_conv_groups": self.pos_conv_groups,
            "encoder_num_layers": self.num_layers,
            "encoder_use_attention": list(self.use_attention),
            "encoder_use_feed_forward": list(self.use_feed_forward),
            "encoder_total_num_heads": list(self.total_num_heads),
            "encoder_remaining_heads": [list(h) for h in self.remaining_heads],
            "encoder_num_buckets": self.num_buckets,
            "encoder_max_distance": self.max_distance,
            "encoder_attention_dropout": self.attention_dropout,
            "encoder_ff_interm_features": list(self.ff_interm_features),
            "encoder_ff_interm_dropout": self.ff_interm_dropout,
            "encoder_dropout": self.dropout,
            "encoder_layer_norm_first": self.layer_norm_first,
            "encoder_layer_drop": self.layer_drop,
            "normalize_waveform": self.normalize_waveform,
        }

    @staticmethod
    def from_reference_dict(cfg: dict) -> "WavLMConfig":
        """Build from the reference's factory-kwargs dict (its presets and the
        `config` payload of a pruned checkpoint)."""
        n = cfg["encoder_num_layers"]
        return WavLMConfig(
            extractor_mode=cfg["extractor_mode"],
            conv_layers=tuple(tuple(l) for l in cfg["extractor_conv_layer_config"]),
            conv_bias=cfg["extractor_conv_bias"],
            embed_dim=cfg["encoder_embed_dim"],
            projection_dropout=cfg.get("encoder_projection_dropout", 0.1),
            pos_conv_kernel=cfg["encoder_pos_conv_kernel"],
            pos_conv_groups=cfg["encoder_pos_conv_groups"],
            num_layers=n,
            use_attention=tuple(cfg.get("encoder_use_attention", [True] * n)),
            use_feed_forward=tuple(cfg.get("encoder_use_feed_forward", [True] * n)),
            total_num_heads=tuple(cfg["encoder_total_num_heads"]),
            remaining_heads=tuple(tuple(h) for h in cfg["encoder_remaining_heads"]),
            num_buckets=cfg["encoder_num_buckets"],
            max_distance=cfg["encoder_max_distance"],
            attention_dropout=cfg.get("encoder_attention_dropout", 0.1),
            ff_interm_features=tuple(cfg["encoder_ff_interm_features"]),
            ff_interm_dropout=cfg.get("encoder_ff_interm_dropout", 0.0),
            dropout=cfg.get("encoder_dropout", 0.1),
            layer_norm_first=cfg["encoder_layer_norm_first"],
            layer_drop=cfg.get("encoder_layer_drop", 0.05),
            normalize_waveform=cfg["normalize_waveform"],
        )

@lru_cache(maxsize=32)
def _rel_pos_buckets(seq_len: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """Static (T, T) bucket index matrix; the JAX package's numpy code
    verbatim, float32/float64 mix included, so the buckets agree exactly."""
    context = np.arange(seq_len, dtype=np.int64)[:, None]
    memory = np.arange(seq_len, dtype=np.int64)[None, :]
    rel = memory - context
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1).astype(np.float32) / max_exact)
        / np.log(max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(is_small, rel, large)
    return buckets


# ---------------------------------------------------------------------------
# parameter containers (reference key layout)


class _ConvLayerBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 bias: bool, norm: Optional[str]):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv1d(in_ch, out_ch, kernel, stride=stride, bias=bias)
        if norm == "group":
            self.layer_norm = nn.GroupNorm(out_ch, out_ch)
        elif norm == "layer":
            self.layer_norm = nn.LayerNorm(out_ch)
        else:
            self.layer_norm = None


class _FeatureExtractor(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        blocks, in_ch = [], 1
        for i, (out_ch, kernel, stride) in enumerate(cfg.conv_layers):
            if cfg.extractor_mode == "layer_norm":
                norm = "layer"
            else:
                norm = "group" if i == 0 else None
            blocks.append(_ConvLayerBlock(in_ch, out_ch, kernel, stride, cfg.conv_bias, norm))
            in_ch = out_ch
        self.conv_layers = nn.ModuleList(blocks)
        # per-channel scale on the extractor output (the reference's
        # dummy_weight: ones, or the last conv layer's soft prune mask)
        self.dummy_weight = nn.Parameter(torch.ones(cfg.conv_out_channels))


class _FeatureProjection(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.layer_norm = nn.LayerNorm(in_dim)
        self.projection = nn.Linear(in_dim, out_dim)


class _WeightNormConv(nn.Module):
    """Weight-normed grouped conv: w = g * v / ||v||, the norm taken over
    (out, in / groups) for each kernel tap (torch weight_norm, dim=2)."""

    def __init__(self, dim: int, kernel: int, groups: int):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel))
        self.weight_v = nn.Parameter(torch.zeros(dim, dim // groups, kernel))
        self.bias = nn.Parameter(torch.zeros(dim))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # state dicts saved with torch.nn.utils.parametrizations.weight_norm
        for name, old in (("weight_g", "parametrizations.weight.original0"),
                          ("weight_v", "parametrizations.weight.original1")):
            if prefix + old in state_dict:
                state_dict[prefix + name] = state_dict.pop(prefix + old)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class _PosConvEmbed(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.conv = _WeightNormConv(cfg.embed_dim, cfg.pos_conv_kernel, cfg.pos_conv_groups)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: WavLMConfig, i: int):
        super().__init__()
        d, hd = cfg.embed_dim, cfg.head_dim
        inner = len(cfg.remaining_heads[i]) * hd
        self.q_proj = nn.Linear(d, inner)
        self.k_proj = nn.Linear(d, inner)
        self.v_proj = nn.Linear(d, inner)
        self.out_proj = nn.Linear(inner, d)
        self.gru_rel_pos_linear = nn.Linear(hd, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, cfg.total_num_heads[i], 1, 1))
        if i == 0:  # the bias table of layer 0 serves every layer
            self.rel_attn_embed = nn.Embedding(cfg.num_buckets, cfg.total_num_heads[0])


class _FeedForward(nn.Module):
    def __init__(self, d: int, ff: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(d, ff)
        self.output_dense = nn.Linear(ff, d)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: WavLMConfig, i: int):
        super().__init__()
        d = cfg.embed_dim
        self.attention = _SelfAttention(cfg, i) if cfg.use_attention[i] else None
        self.layer_norm = nn.LayerNorm(d)
        self.feed_forward = (
            _FeedForward(d, cfg.ff_interm_features[i]) if cfg.use_feed_forward[i] else None
        )
        self.final_layer_norm = nn.LayerNorm(d)


class _Transformer(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.pos_conv_embed = _PosConvEmbed(cfg)
        self.layer_norm = nn.LayerNorm(cfg.embed_dim)
        self.layers = nn.ModuleList(_EncoderLayer(cfg, i) for i in range(cfg.num_layers))
        if not cfg.use_attention[0]:
            # layer 0's attention, which holds the bias table of every layer,
            # was pruned away: the table stays, here
            self.rel_attn_embed = nn.Embedding(cfg.num_buckets, cfg.total_num_heads[0])


class _Encoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.feature_projection = _FeatureProjection(cfg.conv_out_channels, cfg.embed_dim)
        self.transformer = _Transformer(cfg)


# ---------------------------------------------------------------------------
# forward


class WavLM(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureExtractor(cfg)
        self.encoder = _Encoder(cfg)
        self.layers_run: List[int] = []  # the layers the last forward computed
        self.mesh: Optional[Mesh] = None  # the mesh its layers are split over
        self._chain_cache: dict = {}  # (type, device) -> (parameter stamp, K5's weights)

    def forward(self, waveforms: torch.Tensor, layer_weights: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32, train: bool = False,
                rng: Optional[TrainRandom] = None, gates: Optional[dict] = None) -> torch.Tensor:
        """(B, num_samples) -> float32 (B, F, D) sum of the num_layers + 1
        hidden states weighted by `layer_weights`, accumulated in float32.
        `train` selects the differentiable attention and GradMultiply;
        dropout and layer drop need `rng` as well. `gates`: HardConcrete
        masks in the tree of `prune.gates`."""
        return self._encode(waveforms, compute_dtype, train, rng, gates, layer_weights)

    def hidden_states(self, waveforms: torch.Tensor, compute_dtype: torch.dtype = torch.float32,
                      train: bool = False, rng: Optional[TrainRandom] = None,
                      gates: Optional[dict] = None) -> List[torch.Tensor]:
        """(B, num_samples) -> the num_layers + 1 hidden states (B, F, D) in
        the compute type: the extractor's projection after the pos-conv, then
        each layer's output (a layer dropped in training repeats its input)."""
        return self._encode(waveforms, compute_dtype, train, rng, gates, None)

    def extract(self, waveforms: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The inference forward's first stage: (B, num_samples) -> (B, F, D)
        in the compute type, the waveform's norm, the conv stack with its
        norms and GELUs, and the feature projection. `encode` of it is
        `forward`."""
        return self._extract(waveforms, compute_dtype, False, None, None)

    def encode(self, features: torch.Tensor, layer_weights: torch.Tensor) -> torch.Tensor:
        """The inference forward's second stage: `extract`'s output through
        the positional conv and the transformer layers -> float32 (B, F, D),
        the hidden states' sum weighted by `layer_weights`."""
        return self._transform(features, False, None, None, layer_weights)

    def _encode(self, waveforms, compute_dtype, train, rng, gates, layer_weights):
        gates = gates or {}
        x = self._extract(waveforms, compute_dtype, train, rng, gates.get("conv"))
        return self._transform(x, train, rng, gates.get("layers"), layer_weights)

    def _extract(self, waveforms, compute_dtype, train, rng, conv_gates):
        cfg = self.cfg
        if cfg.num_frames(waveforms.shape[-1]) < 1:
            raise ValueError(
                f"input of {waveforms.shape[-1]} samples is shorter than the "
                "conv receptive field: zero output frames"
            )
        if cfg.normalize_waveform:
            waveforms = F.layer_norm(waveforms.float(), waveforms.shape[-1:], eps=1e-5)

        gen = rng.device if (train and rng is not None) else None
        x = self._feature_extractor(waveforms[:, None, :].to(compute_dtype), train, conv_gates)
        if train:
            x = grad_multiply(x, FEATURE_GRAD_MULT)
        fp = self.encoder.feature_projection
        x = linear(fp.projection, layer_norm(fp.layer_norm, x))
        return dropout(x, cfg.projection_dropout, gen)

    def _transform(self, x, train, rng, layer_gates, layer_weights):
        cfg = self.cfg
        gen = rng.device if (train and rng is not None) else None
        transformer = self.encoder.transformer
        x = x + self._pos_conv(x)
        if not cfg.layer_norm_first:
            x = layer_norm(transformer.layer_norm, x)
        x = dropout(x, cfg.dropout, gen)
        position_bias = self._position_bias(x.shape[1], x.dtype, x.device, train)

        hidden = [x]
        if layer_weights is not None:
            w = layer_weights.float()
            acc = w[0] * x.float()
        self.layers_run = []
        for i, layer in enumerate(transformer.layers):
            folded = None  # acc after a K4 that took the update into its pass
            if gen is None or cfg.layer_drop == 0.0 or rng.uniform() >= cfg.layer_drop:
                x, folded = self._layer(
                    i, layer, x, position_bias, train, rng,
                    ws_acc=None if layer_weights is None else (w[i + 1], acc),
                    gate=None if layer_gates is None else layer_gates[i])
                self.layers_run.append(i)
            if layer_weights is None:
                hidden.append(x)
            else:
                acc = folded if folded is not None else acc + w[i + 1] * x.float()
        return hidden if layer_weights is None else acc

    def _feature_extractor(self, x: torch.Tensor, train: bool = False,
                           conv_gates: Optional[list] = None) -> torch.Tensor:
        """(B, 1, num_samples) -> (B, F, C): conv stack, norm, GELU, and the
        channel gates after each block's GELU."""
        fe = self.feature_extractor
        if conv_gates is None and self._conv_chain_applies(train):
            # layers 1-6 through K5, which takes and gives channels last
            x = self._layer0_channels_last(x)
            x = fused_conv_chain(x, self._conv_chain_weights(x.dtype, x.device),
                                 num_output_frames(x.shape[1]))
            return x * fe.dummy_weight.to(x.dtype)
        for i, block in enumerate(fe.conv_layers):
            conv = block.conv
            bias = None if conv.bias is None else conv.bias.to(x.dtype)
            x = F.conv1d(x, conv.weight.to(x.dtype), bias, stride=block.stride)
            if isinstance(block.layer_norm, nn.GroupNorm):
                x = group_norm(block.layer_norm, x, num_groups=x.shape[1])
            elif block.layer_norm is not None:
                x = layer_norm(block.layer_norm, x.transpose(1, 2)).transpose(1, 2)
            x = gelu(x)
            if conv_gates is not None and conv_gates[i] is not None:
                x = x * conv_gates[i].to(x.dtype)[:, None]
        return x.transpose(1, 2) * fe.dummy_weight.to(x.dtype)

    def _layer0_channels_last(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, num_samples) -> layer 0's output (B, T0, C) in channels-last
        layout, no copy of a layout in between: the convolution (no bias) as a
        strided view of the waveform's windows times a (k, C) matrix, then the
        per-channel GroupNorm over time and the GELU."""
        block = self.feature_extractor.conv_layers[0]
        weight = block.conv.weight.to(x.dtype)  # (C, 1, k)
        windows = x[:, 0].unfold(-1, weight.shape[-1], block.stride)  # (B, T0, k)
        y = torch.matmul(windows, weight[:, 0].t())
        return gelu(channel_norm_last(block.layer_norm, y))

    def _conv_chain_applies(self, train: bool) -> bool:
        """K5's route: the toggle is on, inference, and layers 1-6 are the
        stack the kernel computes (no norm, no bias, the default widths)."""
        cfg = self.cfg
        return (use_conv_chain() and not train and cfg.extractor_mode == "group_norm"
                and not cfg.conv_bias and cfg.conv_layers[1:] == DEFAULT_CONV_LAYERS[1:])

    def _conv_chain_weights(self, dtype: torch.dtype, device: torch.device) -> ConvChainWeights:
        """Layers 1-6's weights in K5's layout, packed once per type and
        device and again only after the parameters have changed."""
        convs = [block.conv.weight for block in self.feature_extractor.conv_layers[1:]]
        stamp = tuple((w.data_ptr(), w._version) for w in convs)
        key = (dtype, device)
        cached = self._chain_cache.get(key)
        if cached is None or cached[0] != stamp:
            with torch.inference_mode(False), torch.no_grad():
                packed = pack_weights([w.detach().permute(2, 1, 0) for w in convs], dtype, device)
            cached = self._chain_cache[key] = (stamp, packed)
        return cached[1]

    def _pos_conv(self, x: torch.Tensor) -> torch.Tensor:
        """Weight-normed grouped conv positional embedding on (B, T, D); an
        even kernel's symmetric padding gives T + 1 frames, the last trimmed."""
        conv = self.encoder.transformer.pos_conv_embed.conv
        k = self.cfg.pos_conv_kernel
        v = conv.weight_v.float()
        norm = torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True))
        w = conv.weight_g.float() * v / norm.clamp_min(1e-12)
        y = F.conv1d(x.transpose(1, 2), w.to(x.dtype), conv.bias.to(x.dtype),
                     padding=k // 2, groups=self.cfg.pos_conv_groups)
        if k % 2 == 0:
            y = y[..., :-1]
        return gelu(y.transpose(1, 2))

    def _position_bias(self, t: int, dtype: torch.dtype, device: torch.device,
                       train: bool = False) -> torch.Tensor:
        """Layer 0's bucket embedding as the (H_total, T, T) bias, padded to
        (H_total, T, ldbias) rows whose `[..., :T]` view every layer's
        attention slices. Training keeps it in float32 and unpadded (ldbias
        = T): its gradient flows into the table, and the attention function
        rounds and pads it. Inference makes it once per forward in `dtype`
        with the rows K1 reads (`padded_bias`)."""
        cfg = self.cfg
        buckets = device_constant(
            ("wavlm.buckets", t, cfg.num_buckets, cfg.max_distance),
            lambda: _rel_pos_buckets(t, cfg.num_buckets, cfg.max_distance), device)
        transformer = self.encoder.transformer
        holder = transformer.layers[0].attention or transformer
        table = holder.rel_attn_embed.weight
        bias = table[buckets].permute(2, 0, 1)
        if train:
            return bias.float()
        padded = torch.zeros((bias.shape[0], t, bias_row_stride(t)), dtype=dtype, device=device)
        padded[..., :t] = bias
        return padded

    def _layer(self, i: int, layer: _EncoderLayer, x: torch.Tensor,
               position_bias: torch.Tensor, train: bool = False,
               rng: Optional[TrainRandom] = None,
               ws_acc: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               gate: Optional[dict] = None,
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One encoder layer. `ws_acc` is (w, acc) of the weighted sum: on the
        fused route the final norm's kernel K4 also adds `w * x` to the
        float32 `acc` in place. Returns (x, acc where that happened, else
        None: the caller then adds the layer's term itself). `gate`: the
        layer's HardConcrete masks."""
        cfg = self.cfg
        pre_ln = cfg.layer_norm_first
        gen = rng.device if (train and rng is not None) else None
        # the fused residual + LayerNorm kernels: inference only, post-norm stacks
        fused = use_fused_ln() and not train and not pre_ln and gate is None
        has_attn = layer.attention is not None
        if has_attn:
            h = layer_norm(layer.layer_norm, x) if pre_ln else x
            h = self._self_attention(i, layer.attention, h, position_bias, train, rng, gate)
            h = dropout(h, cfg.dropout, gen)
            if fused:  # the residual add rides in the post-norm attention LayerNorm
                norm = layer.layer_norm
                x = residual_ln(x, h, norm.weight, norm.bias)
            else:
                x = x + h
        if pre_ln:
            if layer.feed_forward is not None:
                x = x + self._feed_forward(
                    i, layer.feed_forward, layer_norm(layer.final_layer_norm, x), gen, gate)
            return x, None
        # post-LN: both norms apply even where a sublayer was pruned away
        if not (has_attn and fused):
            x = layer_norm(layer.layer_norm, x)
        if layer.feed_forward is not None:
            ff_out = self._feed_forward(i, layer.feed_forward, x, gen, gate)
            if fused:
                norm = layer.final_layer_norm
                if ws_acc is not None:
                    return residual_ln_acc(x, ff_out, norm.weight, norm.bias, *ws_acc)
                return residual_ln(x, ff_out, norm.weight, norm.bias), None
            x = x + ff_out
        return layer_norm(layer.final_layer_norm, x), None

    def _self_attention(self, i: int, attn: _SelfAttention, x: torch.Tensor,
                        position_bias: torch.Tensor, train: bool = False,
                        rng: Optional[TrainRandom] = None,
                        hc_gate: Optional[dict] = None) -> torch.Tensor:
        """Gated relative-position self-attention over the layer's remaining
        heads (this rank's share of them on a model axis). The GRU gate
        reads the raw input of ALL total_num_heads heads; the remaining
        heads are selected after it. `hc_gate`: the layer's HardConcrete
        masks, "heads" on the kernel's output, "attn_layer" after
        `out_proj`."""
        cfg = self.cfg
        b, t, _ = x.shape
        total_heads = cfg.total_num_heads[i]
        remaining = list(cfg.remaining_heads[i])
        h0, nh = (0, len(remaining)) if self.mesh is None else self.mesh.split(len(remaining))
        heads = remaining[h0:h0 + nh]  # this rank's heads
        hd = cfg.head_dim
        if self.mesh is not None:
            x = copy_to_group(x, self.mesh.model_group)

        weight = torch.cat([attn.q_proj.weight, attn.k_proj.weight, attn.v_proj.weight])
        bias = torch.cat([attn.q_proj.bias, attn.k_proj.bias, attn.v_proj.bias])
        qkv = F.linear(x, weight.to(x.dtype), bias.to(x.dtype))
        w = nh * hd
        q, k, v = (qkv[..., j * w:(j + 1) * w].reshape(b, t, nh, hd).transpose(1, 2).contiguous()
                   for j in range(3))

        gru = linear(attn.gru_rel_pos_linear, x.reshape(b, t, total_heads, hd))
        gates = torch.sigmoid(gru.float().reshape(b, t, total_heads, 2, 4).sum(-1))
        const = attn.gru_rel_pos_const.float().reshape(1, 1, total_heads)
        gate = gates[..., 0] * (gates[..., 1] * const - 1.0) + 2.0  # (B, T, Ht)
        # the heads' indices on the device once: a list index would copy
        # them from pageable host memory in every forward
        index = device_constant(("wavlm.heads", tuple(heads)),
                                lambda: np.asarray(heads, np.int64), x.device)
        gate = gate.transpose(1, 2).index_select(1, index).contiguous()  # (B, nh, T)

        if heads and heads == list(range(heads[0], heads[0] + nh)):
            pos = position_bias[heads[0]:heads[0] + nh]  # a view, no copy
        else:
            pos = position_bias.index_select(0, index)
        pos = pos[..., :t]  # (nh, T, T), rows of the padded stride
        # the layer's seed is drawn on every rank, one without heads too:
        # the host generator then stays in step across the model axis
        rate = cfg.attention_dropout if (train and rng is not None) else 0.0
        seed = rng.seed() if rate > 0.0 else 0
        if nh == 0:  # no head here: no launch, zeros through out_proj
            out = q
        elif train:
            # the bias gradient flows into layer 0's table from every layer
            out = flash_attention_gated_bias_trainable(q, k, v, pos, gate, rate, seed,
                                                       head_offset=h0)
        else:
            out = flash_attention_gated_bias(q, k, v, pos.to(q.dtype), gate)
        hc_gate = hc_gate or {}
        if hc_gate.get("heads") is not None:
            out = out * hc_gate["heads"][h0:h0 + nh].to(out.dtype)[None, :, None, None]
        out = out.transpose(1, 2).reshape(b, t, nh * hd)
        if self.mesh is None:
            out = linear(attn.out_proj, out)
        else:  # the ranks' partial products summed, then the bias once
            out = reduce_from_group(F.linear(out, attn.out_proj.weight.to(out.dtype)),
                                    self.mesh.model_group)
            out = out + attn.out_proj.bias.to(out.dtype)
        if hc_gate.get("attn_layer") is not None:
            out = out * hc_gate["attn_layer"].to(out.dtype)
        return out

    def _feed_forward(self, i: int, ff: _FeedForward, x: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      gate: Optional[dict] = None) -> torch.Tensor:
        """Layer i's feed-forward (this rank's block of its width on a model
        axis, whose interm dropout mask is the block of the full-width one)."""
        gate = gate or {}
        width = self.cfg.ff_interm_features[i]
        if self.mesh is None:
            f0, columns = 0, None
        else:
            x = copy_to_group(x, self.mesh.model_group)
            f0 = self.mesh.split(width)[0]
            columns = (width, f0)
        h = dropout(gelu(linear(ff.intermediate_dense, x)), self.cfg.ff_interm_dropout,
                    generator, columns)
        if gate.get("ff_interm") is not None:
            h = h * gate["ff_interm"][f0:f0 + h.shape[-1]].to(h.dtype)
        if self.mesh is None:
            y = linear(ff.output_dense, h)
        else:
            y = reduce_from_group(F.linear(h, ff.output_dense.weight.to(h.dtype)),
                                  self.mesh.model_group)
            y = y + ff.output_dense.bias.to(y.dtype)
        y = dropout(y, self.cfg.dropout, generator)
        if gate.get("ff_layer") is not None:
            y = y * gate["ff_layer"].to(y.dtype)
        return y


def count_params(state_dict: Dict[str, torch.Tensor]) -> int:
    """Parameters of a WavLM state dict as the JAX package counts its
    pytree's leaves: `dummy_weight` counts only where it is not the identity,
    as the JAX package keeps it (`output_scale`) only then."""
    total = 0
    for name, value in state_dict.items():
        if name.endswith("dummy_weight") and np.allclose(value.detach().cpu().numpy(), 1.0):
            continue
        total += value.numel()
    return total


def count_macs(cfg: WavLMConfig, num_samples: int = 16000) -> int:
    """Analytic MAC count for `num_samples` of audio (1 s by default)."""
    macs = 0
    t = num_samples
    in_ch = 1
    for out_ch, kernel, stride in cfg.conv_layers:
        t = (t - kernel) // stride + 1
        macs += t * kernel * in_ch * out_ch
        in_ch = out_ch
    d = cfg.embed_dim
    macs += t * in_ch * d  # projection
    macs += t * cfg.pos_conv_kernel * d * d // cfg.pos_conv_groups  # pos conv
    hd = cfg.head_dim
    for i in range(cfg.num_layers):
        if cfg.use_attention[i]:
            nh = len(cfg.remaining_heads[i])
            macs += 4 * t * nh * d * hd + 2 * t * t * nh * hd
        if cfg.use_feed_forward[i]:
            macs += 2 * t * d * cfg.ff_interm_features[i]
    return macs
