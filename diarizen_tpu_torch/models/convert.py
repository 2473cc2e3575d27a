"""Weights into the port's modules.

`eend_state_dict_from_jax`, `eend_mc_state_dict_from_jax` (with
`fusion_state_dict_from_jax`) and `resnet_state_dict_from_jax` take the JAX
package's parameter pytrees (nested dicts of numpy arrays) and return the
port's `state_dict`, in the reference's torch key layout. They are the exact
inverses of the JAX package's `eend_params_from_torch`,
`eend_mc_params_from_torch` (`fusion_params_from_torch`) and
`resnet_params_from_torch`: linear weights transpose, conv weights go from
(k, in/g, out) to (out, in/g, k), ResNet kernels from HWIO to OIHW, the
pos-conv weight norm to `weight_g` (1, 1, K) / `weight_v`, and `weight_sum`
from (L,) to (1, L).

`fbank_eend_state_dict_from_jax`, `sincnet_eend_state_dict_from_jax`,
`sserious_state_dict_from_jax` and `xvector_state_dict_from_jax` do the same
for the other families. The JAX package has no torch converter for them, so
their layout is the port's own, named after pyannote's modules where that is
natural (each model's docstring lists it): a JAX LSTM direction's `w_ih`
(in, 4h) and `w_hh` (h, 4h) become nn.LSTM's `weight_ih_l0[_reverse]` and
`weight_hh_l0[_reverse]` transposed, gates i, f, g, o; its one bias `b`
becomes `bias_ih_l0[_reverse]`, with `bias_hh_l0[_reverse]` zero; SincNet's
`low_hz` / `band_hz` become `sincnet.conv1d.0.low_hz_` / `band_hz_`, its
norms `wav_norm1d` and `norm1d.{0,1,2}`, its convs `conv1d.{1,2}`; the
x-vector's TDNN layer i becomes `tdnns.{i}.0` (conv) and `tdnns.{i}.2`
(BatchNorm with its running statistics).

`random_state_dict` gives seeded random weights at a module's shapes, for
runs without released checkpoints.

`load_reference_wavlm_checkpoint` and `load_eend_checkpoint` read the
reference's torch files. `wavlm_config_from_hf` and `wavlm_state_dict_from_hf`
take a HuggingFace `WavLMModel`'s config and state dict (HF's key layout
mapped onto the reference's), with no import of transformers;
`wavlm_state_dict_to_hf` is the inverse map. The port's modules keep the reference's key layout,
so what they return loads with `load_state_dict(strict=True)`.

`load_pytree` reads a pytree that the JAX package saved as `.npz` (its
trainer's `params.npz`) with numpy alone, and `eend_state_dict_from_params`
carries such params of a WavLM + Conformer, Fbank + Conformer or SincNet
model into it, keeping the model's own Conformer BatchNorm statistics as
the JAX loader keeps its initial state (the SincNet family has none).

The other way, `wavlm_params_to_jax` is the inverse of
`wavlm_state_dict_from_jax` (a port WavLM state dict as the JAX package's
numpy pytree) and `save_pytree` writes a pytree as the JAX package's
`save_pytree` does, so the port writes a (pruned) WavLM as `params.npz` that
the JAX package's `load_pytree` reads. `gates_from_jax` carries a JAX
log-alpha tree into the port's gate tree.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch
from torch import nn

from diarizen_tpu_torch.models.fbank_eend import FbankEendModel
from diarizen_tpu_torch.models.sincnet_eend import SincNetEendModel
from diarizen_tpu_torch.models.wavlm import WavLMConfig

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _linear(sd: StateDict, key: str, p: dict) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{key}.bias"] = _t(p["b"])


def _norm(sd: StateDict, key: str, p: dict) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _conv1d(sd: StateDict, key: str, p: dict) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["w"]).transpose(2, 1, 0))
    if "b" in p:
        sd[f"{key}.bias"] = _t(p["b"])


def _batch_norm(sd: StateDict, key: str, scale, bias, mean, var) -> None:
    sd[f"{key}.weight"] = _t(scale)
    sd[f"{key}.bias"] = _t(bias)
    sd[f"{key}.running_mean"] = _t(mean)
    sd[f"{key}.running_var"] = _t(var)
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def wavlm_state_dict_from_jax(params: dict, cfg, prefix: str = "") -> StateDict:
    sd: StateDict = {}
    fe = params["feature_extractor"]
    for i, block in enumerate(fe["conv_layers"]):
        key = f"{prefix}feature_extractor.conv_layers.{i}"
        _conv1d(sd, f"{key}.conv", block["conv"])
        if "norm" in block:
            _norm(sd, f"{key}.layer_norm", block["norm"])
    sd[f"{prefix}feature_extractor.dummy_weight"] = _t(
        fe.get("output_scale", np.ones(cfg.conv_out_channels, np.float32)))

    enc = f"{prefix}encoder"
    _norm(sd, f"{enc}.feature_projection.layer_norm", params["feature_projection"]["norm"])
    _linear(sd, f"{enc}.feature_projection.projection", params["feature_projection"]["proj"])
    pos = params["pos_conv"]
    conv = f"{enc}.transformer.pos_conv_embed.conv"
    sd[f"{conv}.weight_g"] = _t(np.asarray(pos["g"]).reshape(1, 1, -1))
    sd[f"{conv}.weight_v"] = _t(np.asarray(pos["v"]).transpose(2, 1, 0))
    sd[f"{conv}.bias"] = _t(pos["b"])
    _norm(sd, f"{enc}.transformer.layer_norm", params["encoder_norm"])

    for i, layer in enumerate(params["layers"]):
        key = f"{enc}.transformer.layers.{i}"
        _norm(sd, f"{key}.layer_norm", layer["attn_norm"])
        _norm(sd, f"{key}.final_layer_norm", layer["final_norm"])
        if "attn" in layer:
            a, akey = layer["attn"], f"{key}.attention"
            for name, jname in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                                ("out_proj", "out"), ("gru_rel_pos_linear", "gru_linear")):
                _linear(sd, f"{akey}.{name}", a[jname])
            sd[f"{akey}.gru_rel_pos_const"] = _t(a["gru_const"])
            if i == 0:
                sd[f"{akey}.rel_attn_embed.weight"] = _t(params["rel_attn_embed"])
        if "ff" in layer:
            _linear(sd, f"{key}.feed_forward.intermediate_dense", layer["ff"]["in"])
            _linear(sd, f"{key}.feed_forward.output_dense", layer["ff"]["out"])
    if "attn" not in params["layers"][0]:  # layer 0's attention pruned: the table stays
        sd[f"{enc}.transformer.rel_attn_embed.weight"] = _t(params["rel_attn_embed"])
    return sd


def _np(x) -> np.ndarray:
    return x.detach().cpu().float().numpy()


def wavlm_params_to_jax(sd: StateDict, cfg: WavLMConfig, prefix: str = "") -> dict:
    """The port's WavLM state dict -> the JAX package's WavLM pytree (numpy
    float32), the inverse of `wavlm_state_dict_from_jax`: `dummy_weight`
    becomes `output_scale` only where it is not the identity, as the JAX
    package's own converter keeps it."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    def linear(key):
        p = {"w": _np(sd[f"{key}.weight"]).T.copy()}
        if f"{key}.bias" in sd:
            p["b"] = _np(sd[f"{key}.bias"])
        return p

    def norm(key):
        return {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}

    blocks = []
    for i in range(len(cfg.conv_layers)):
        key = f"feature_extractor.conv_layers.{i}"
        conv = {"w": _np(sd[f"{key}.conv.weight"]).transpose(2, 1, 0).copy()}
        if f"{key}.conv.bias" in sd:
            conv["b"] = _np(sd[f"{key}.conv.bias"])
        block = {"conv": conv}
        if f"{key}.layer_norm.weight" in sd:
            block["norm"] = norm(f"{key}.layer_norm")
        blocks.append(block)
    feature_extractor: dict = {"conv_layers": blocks}
    dummy = _np(sd["feature_extractor.dummy_weight"])
    if not np.allclose(dummy, 1.0):
        feature_extractor["output_scale"] = dummy

    enc = "encoder.transformer"
    pos = f"{enc}.pos_conv_embed.conv"
    table = (f"{enc}.layers.0.attention.rel_attn_embed.weight" if cfg.use_attention[0]
             else f"{enc}.rel_attn_embed.weight")
    params = {
        "feature_extractor": feature_extractor,
        "feature_projection": {"norm": norm("encoder.feature_projection.layer_norm"),
                               "proj": linear("encoder.feature_projection.projection")},
        "pos_conv": {"v": _np(sd[f"{pos}.weight_v"]).transpose(2, 1, 0).copy(),
                     "g": _np(sd[f"{pos}.weight_g"]).reshape(-1),
                     "b": _np(sd[f"{pos}.bias"])},
        "encoder_norm": norm(f"{enc}.layer_norm"),
        "rel_attn_embed": _np(sd[table]),
        "layers": [],
    }
    for i in range(cfg.num_layers):
        key = f"{enc}.layers.{i}"
        layer = {"attn_norm": norm(f"{key}.layer_norm"),
                 "final_norm": norm(f"{key}.final_layer_norm")}
        if cfg.use_attention[i]:
            a = f"{key}.attention"
            layer["attn"] = {jname: linear(f"{a}.{name}") for name, jname in (
                ("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "out"),
                ("gru_rel_pos_linear", "gru_linear"))}
            layer["attn"]["gru_const"] = _np(sd[f"{a}.gru_rel_pos_const"])
        if cfg.use_feed_forward[i]:
            layer["ff"] = {"in": linear(f"{key}.feed_forward.intermediate_dense"),
                           "out": linear(f"{key}.feed_forward.output_dense")}
        params["layers"].append(layer)
    return params


def gates_from_jax(log_alphas: dict) -> dict:
    """A JAX log-alpha (or mask) tree -> the port's gate tree of float32
    tensors, same shape (`prune.gates`)."""
    out: dict = {}
    if "conv" in log_alphas:
        out["conv"] = [_t(g) for g in log_alphas["conv"]]
    out["layers"] = [{k: _t(v) for k, v in layer.items()} for layer in log_alphas["layers"]]
    return out


def conformer_state_dict_from_jax(params: dict, state: dict, prefix: str = "") -> StateDict:
    sd: StateDict = {}
    for i, (block, bstate) in enumerate(zip(params["blocks"], state["blocks"])):
        key = f"{prefix}conformer_layer.{i}"
        for ffn in ("ffn1", "ffn2"):
            _norm(sd, f"{key}.{ffn}.ln_norm", block[ffn]["norm"])
            _linear(sd, f"{key}.{ffn}.w_1", block[ffn]["w1"])
            _linear(sd, f"{key}.{ffn}.w_2", block[ffn]["w2"])
        _norm(sd, f"{key}.mha.ln_norm", block["mha"]["norm"])
        for name in ("q", "k", "v", "o"):
            _linear(sd, f"{key}.mha.mha.linear{name.upper()}", block["mha"][name])
        c = block["conv"]
        _norm(sd, f"{key}.conv.ln_norm", c["norm"])
        _conv1d(sd, f"{key}.conv.pointwise_conv1", c["pw1"])
        _conv1d(sd, f"{key}.conv.depthwise_conv", c["dw"])
        _batch_norm(sd, f"{key}.conv.bn_norm", c["bn"]["scale"], c["bn"]["bias"],
                    bstate["bn"]["mean"], bstate["bn"]["var"])
        _conv1d(sd, f"{key}.conv.pointwise_conv2", c["pw2"])
        _norm(sd, f"{key}.ln_norm", block["final_norm"])
    if "pos_emb" in params:
        sd[f"{prefix}pos_emb.pe_k.weight"] = _t(params["pos_emb"])
    return sd


def eend_state_dict_from_jax(params: dict, state: dict, cfg) -> StateDict:
    """JAX EEND (params, state) -> the port's `EendModel` state dict."""
    sd = wavlm_state_dict_from_jax(params["wavlm"], cfg.wavlm, prefix="wavlm_model.")
    sd["weight_sum.weight"] = _t(np.asarray(params["weight_sum"]).reshape(1, -1))
    _linear(sd, "proj", params["proj"])
    _norm(sd, "lnorm", params["lnorm"])
    sd.update(conformer_state_dict_from_jax(
        params["conformer"], state["conformer"], prefix="conformer."))
    _linear(sd, "classifier", params["classifier"])
    return sd


def fbank_eend_state_dict_from_jax(params: dict, state: dict, cfg=None) -> StateDict:
    """JAX Fbank + Conformer (params, state) -> the port's `FbankEendModel`
    state dict (`cfg`, the FbankEendConfig, sets nothing of the layout)."""
    del cfg
    sd: StateDict = {}
    _linear(sd, "proj", params["proj"])
    _norm(sd, "lnorm", params["lnorm"])
    sd.update(conformer_state_dict_from_jax(
        params["conformer"], state["conformer"], prefix="conformer."))
    _linear(sd, "classifier", params["classifier"])
    return sd


def _lstm(sd: StateDict, key: str, layer: dict) -> None:
    """One JAX LSTM layer ({"fwd", "bwd"}) -> nn.LSTM's keys at `key`."""
    for suffix, direction in (("", "fwd"), ("_reverse", "bwd")):
        if direction not in layer:
            continue
        p = layer[direction]
        sd[f"{key}.weight_ih_l0{suffix}"] = _t(np.asarray(p["w_ih"]).T)
        sd[f"{key}.weight_hh_l0{suffix}"] = _t(np.asarray(p["w_hh"]).T)
        sd[f"{key}.bias_ih_l0{suffix}"] = _t(p["b"])
        sd[f"{key}.bias_hh_l0{suffix}"] = torch.zeros(np.shape(p["b"]))


def sincnet_state_dict_from_jax(params: dict, prefix: str = "sincnet.") -> StateDict:
    """The JAX SincNet front end's params -> the port's `SincNet` keys."""
    sd: StateDict = {}
    _norm(sd, f"{prefix}wav_norm1d", params["wav_norm"])
    sd[f"{prefix}conv1d.0.low_hz_"] = _t(params["sinc"]["low_hz"])
    sd[f"{prefix}conv1d.0.band_hz_"] = _t(params["sinc"]["band_hz"])
    for i in (1, 2):
        _conv1d(sd, f"{prefix}conv1d.{i}", params[f"conv{i}"])
    for i in range(3):
        _norm(sd, f"{prefix}norm1d.{i}", params[f"norm{i}"])
    return sd


def sincnet_eend_state_dict_from_jax(params: dict, cfg=None) -> StateDict:
    """JAX SincNet-BiLSTM params -> the port's `SincNetEendModel` state dict
    (the family has no state; `cfg` sets nothing of the layout)."""
    del cfg
    sd = sincnet_state_dict_from_jax(params)
    for i, layer in enumerate(params["lstm"]):
        _lstm(sd, f"lstm.{i}", layer)
    _linear(sd, "linear.0", params["linear1"])
    _linear(sd, "linear.1", params["linear2"])
    _linear(sd, "classifier", params["classifier"])
    return sd


def sserious_state_dict_from_jax(params: dict, cfg) -> StateDict:
    """JAX SSeRiouSS params -> the port's `SSeRiouSSModel` state dict; `cfg`
    is the SSeRiouSSConfig."""
    sd = wavlm_state_dict_from_jax(params["wavlm"], cfg.wavlm, prefix="wav2vec.")
    sd["wav2vec_weights"] = _t(params["wav2vec_weights"])
    for i, layer in enumerate(params["lstm"]):
        _lstm(sd, f"lstm.{i}", layer)
    for i, layer in enumerate(params["linears"]):
        _linear(sd, f"linear.{i}", layer)
    _linear(sd, "classifier", params["classifier"])
    return sd


def xvector_state_dict_from_jax(params: dict, cfg) -> StateDict:
    """JAX x-vector params -> the port's `XVectorModel` state dict; `cfg` is
    the XVectorConfig."""
    sd = sincnet_state_dict_from_jax(params["sincnet"]) if cfg.frontend == "sincnet" else {}
    for i, layer in enumerate(params["tdnn"]):
        _conv1d(sd, f"tdnns.{i}.0", layer)
        bn = layer["bn"]
        _batch_norm(sd, f"tdnns.{i}.2", bn["scale"], bn["bias"], bn["mean"], bn["var"])
    _linear(sd, "embedding", params["embedding"])
    return sd


def fusion_state_dict_from_jax(params: dict, kind: str = "cross_attention",
                               prefix: str = "") -> StateDict:
    """JAX `CrossChannelAttention` / `TACFusion` params -> the port's fusion
    state dict (the reference's keys)."""
    sd: StateDict = {}
    if kind == "cross_attention":
        for name in ("q", "k", "v", "o"):
            _linear(sd, f"{prefix}linear{name.upper()}", params[name])
        _norm(sd, f"{prefix}ln_norm", params["norm"])
        return sd
    for name in ("input", "avg", "concat"):
        _linear(sd, f"{prefix}{name}_tf.0", params[f"{name}_tf"])
        sd[f"{prefix}{name}_tf.1.weight"] = _t(params[f"{name}_prelu"])
    _norm(sd, f"{prefix}norm", params["norm"])
    return sd


def eend_mc_state_dict_from_jax(params: dict, state: dict, cfg) -> StateDict:
    """JAX multi-channel EEND (params, state) -> the port's `McEendModel`
    state dict; `cfg` is the McEendConfig."""
    sd = eend_state_dict_from_jax(params, state, cfg)
    for i, fusion in enumerate(params["channel_fusions"]):
        sd.update(fusion_state_dict_from_jax(fusion, cfg.fusion.kind, f"channel_fusions.{i}."))
    return sd


def resnet_state_dict_from_jax(params: dict, cfg) -> StateDict:
    """JAX ResNet params -> the port's `ResNet` state dict (WeSpeaker keys)."""
    sd: StateDict = {}

    def conv(key, p):
        sd[f"{key}.weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))

    def bn(key, p):
        _batch_norm(sd, key, p["scale"], p["bias"], p["mean"], p["var"])

    conv("conv1", params["conv1"])
    bn("bn1", params["bn1"])
    for li in range(1, len(cfg.num_blocks) + 1):
        for bi, bp in enumerate(params[f"layer{li}"]):
            key = f"layer{li}.{bi}"
            conv(f"{key}.conv1", bp["conv1"])
            bn(f"{key}.bn1", bp["bn1"])
            conv(f"{key}.conv2", bp["conv2"])
            bn(f"{key}.bn2", bp["bn2"])
            if "shortcut_conv" in bp:
                conv(f"{key}.shortcut.0", bp["shortcut_conv"])
                bn(f"{key}.shortcut.1", bp["shortcut_bn"])
    _linear(sd, "seg_1", params["seg1"])
    if getattr(cfg, "two_emb_layer", False):  # ReLU, affine-free BatchNorm, seg_2
        sd["seg_bn_1.running_mean"] = _t(params["seg_bn1"]["mean"])
        sd["seg_bn_1.running_var"] = _t(params["seg_bn1"]["var"])
        sd["seg_bn_1.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        _linear(sd, "seg_2", params["seg2"])
    return sd


def random_state_dict(module: nn.Module, seed: int) -> StateDict:
    """Seeded random weights at `module`'s shapes, drawn with numpy: linear
    and conv weights uniform with variance 1 / fan_in, biases uniform in
    +-1/sqrt(fan_in), norms the identity, embedding tables N(0, 0.02^2),
    weight-normed convs with g = ||v|| per tap, and LSTM weights uniform in
    +-1/sqrt(hidden) with zero biases."""
    rng = np.random.default_rng(seed)

    def uniform(shape, bound):
        return torch.tensor(rng.uniform(-bound, bound, shape).astype(np.float32))

    sd = module.state_dict()
    out: StateDict = {}
    for name, mod in module.named_modules():
        key = f"{name}." if name else ""
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = math.prod(mod.weight.shape[1:])
            out[key + "weight"] = uniform(mod.weight.shape, math.sqrt(3.0 / fan_in))
            if mod.bias is not None:
                out[key + "bias"] = uniform(mod.bias.shape, math.sqrt(1.0 / fan_in))
        elif isinstance(mod, nn.Embedding):
            out[key + "weight"] = torch.tensor(
                0.02 * rng.standard_normal(tuple(mod.weight.shape)).astype(np.float32))
        elif isinstance(mod, nn.LSTM):  # the JAX package's init: zero biases
            bound = 1.0 / math.sqrt(mod.hidden_size)
            for pname, p in mod.named_parameters(recurse=False):
                out[key + pname] = (uniform(p.shape, bound) if pname.startswith("weight")
                                    else torch.zeros(p.shape))
        elif hasattr(mod, "weight_v") and hasattr(mod, "weight_g"):
            fan_in = math.prod(mod.weight_v.shape[1:])
            v = uniform(mod.weight_v.shape, math.sqrt(3.0 / fan_in))
            out[key + "weight_v"] = v
            out[key + "weight_g"] = torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True))
            out[key + "bias"] = uniform(mod.bias.shape, math.sqrt(1.0 / fan_in))
    # everything else keeps its constructed value: norms (ones / zeros),
    # running statistics, gates and per-channel scales (ones)
    for name, value in sd.items():
        out.setdefault(name, value.clone())
    return out


# ---------------------------------------------------------------------------
# HuggingFace `transformers.WavLMModel` checkpoints, read without transformers

# HF key prefix -> the reference's (the port's) key prefix
HF_WAVLM_RENAMES = (
    ("feature_projection.", "encoder.feature_projection."),
    ("encoder.layers.", "encoder.transformer.layers."),
    ("encoder.pos_conv_embed.conv.", "encoder.transformer.pos_conv_embed.conv."),
    ("encoder.layer_norm.", "encoder.transformer.layer_norm."),
)
_WEIGHT_NORM_KEYS = (("parametrizations.weight.original0", "weight_g"),
                     ("parametrizations.weight.original1", "weight_v"))


def wavlm_config_from_hf(hf_config) -> WavLMConfig:
    """The WavLMConfig of a `transformers.WavLMConfig`, or of the dict of
    its `config.json`."""
    c = hf_config if isinstance(hf_config, dict) else hf_config.to_dict()
    n, heads = c["num_hidden_layers"], c["num_attention_heads"]
    return WavLMConfig(
        extractor_mode="layer_norm" if c["feat_extract_norm"] == "layer" else "group_norm",
        conv_layers=tuple(zip(c["conv_dim"], c["conv_kernel"], c["conv_stride"])),
        conv_bias=c["conv_bias"],
        embed_dim=c["hidden_size"],
        projection_dropout=c["feat_proj_dropout"],
        pos_conv_kernel=c["num_conv_pos_embeddings"],
        pos_conv_groups=c["num_conv_pos_embedding_groups"],
        num_layers=n,
        use_attention=(True,) * n,
        use_feed_forward=(True,) * n,
        total_num_heads=(heads,) * n,
        remaining_heads=tuple(tuple(range(heads)) for _ in range(n)),
        num_buckets=c["num_buckets"],
        max_distance=c["max_bucket_distance"],
        attention_dropout=c["attention_dropout"],
        ff_interm_features=(c["intermediate_size"],) * n,
        ff_interm_dropout=c["activation_dropout"],
        dropout=c["hidden_dropout"],
        layer_norm_first=c["do_stable_layer_norm"],
        layer_drop=c["layerdrop"],
        normalize_waveform=c["feat_extract_norm"] == "layer",
    )


def wavlm_state_dict_from_hf(state_dict: Dict[str, Any]) -> StateDict:
    """A WavLM state dict in the HF `WavLMModel` layout (a `wavlm.` prefix
    of a model with a head stripped) or already in the reference's, in the
    reference layout that the port's `WavLM` loads: HF keys renamed
    (`HF_WAVLM_RENAMES`), `masked_spec_embed` dropped, the weight-norm keys
    of either torch style as `weight_g` / `weight_v`, and an identity
    `dummy_weight` where the checkpoint has none. Layer 0's relative
    position table is required, as the JAX package's converter requires it."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    if any(k.startswith("wavlm.") for k in sd):
        sd = {k[len("wavlm."):]: v for k, v in sd.items() if k.startswith("wavlm.")}
    if not any(k.startswith("encoder.transformer.") for k in sd):  # HF layout
        renamed = {}
        for key, value in sd.items():
            if key == "masked_spec_embed":
                continue
            for old, new in HF_WAVLM_RENAMES:
                if key.startswith(old):
                    key = new + key[len(old):]
                    break
            renamed[key] = value
        sd = renamed
    for old, new in _WEIGHT_NORM_KEYS:
        sd = {k[: -len(old)] + new if k.endswith(old) else k: v for k, v in sd.items()}
    if "feature_extractor.dummy_weight" not in sd:
        last = max(int(k.split(".")[2]) for k in sd if k.startswith("feature_extractor.conv_layers."))
        out_channels = sd[f"feature_extractor.conv_layers.{last}.conv.weight"].shape[0]
        sd["feature_extractor.dummy_weight"] = torch.ones(out_channels)
    if not any(k.endswith("rel_attn_embed.weight") for k in sd):
        raise ValueError("no rel_attn_embed found in state dict (layer 0 pruned?)")
    return sd


def wavlm_state_dict_to_hf(sd: StateDict) -> StateDict:
    """The inverse of `wavlm_state_dict_from_hf` for an unpruned WavLM: the
    port's WavLM state dict in the HF `WavLMModel` layout (weight norm in
    the `parametrizations` style, no `dummy_weight`, which must be ones)."""
    dummy = sd.get("feature_extractor.dummy_weight")
    if dummy is not None and not torch.all(dummy == 1):
        raise ValueError("a WavLM with a pruned extractor scale has no HF layout")
    out = {}
    for key, value in sd.items():
        if key == "feature_extractor.dummy_weight":
            continue
        for hf, ref in HF_WAVLM_RENAMES:
            if key.startswith(ref):
                key = hf + key[len(ref):]
                break
        for style, name in _WEIGHT_NORM_KEYS:
            if key.endswith("." + name) and "pos_conv_embed" in key:
                key = key[: -len(name)] + style
        out[key] = value
    return out


def load_reference_wavlm_checkpoint(path: str) -> Tuple[WavLMConfig, StateDict]:
    """Load a reference-format `{"config": dict, "state_dict": ...}` WavLM
    checkpoint (pruned s80 models included; the state dict in the reference
    or the HF layout): its architecture and its state dict in the layout of
    the port's `WavLM`."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    cfg = WavLMConfig.from_reference_dict(ckpt["config"])
    return cfg, wavlm_state_dict_from_hf(ckpt["state_dict"])


def load_eend_checkpoint(path: str) -> StateDict:
    """Load a reference EEND diarization checkpoint (`pytorch_model.bin`, or
    an averaged-checkpoint file that wraps it in `{"state_dict": ...}`): the
    state dict of the port's `EendModel`."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: torch.as_tensor(v) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# the JAX package's npz pytrees (diarizen_tpu/train/checkpoint.py), numpy only

SEP = "::"  # joins the path of a leaf: kind and key pairs, kinds d (dict), l (list), t (tuple)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """{joined path: leaf} of a pytree of dicts, lists and tuples, the JAX
    package's `_flatten` (a lone leaf is "leaf")."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{SEP}d{SEP}{k}" if prefix else f"d{SEP}{k}"))
    elif isinstance(tree, (list, tuple)):
        tag = "t" if isinstance(tree, tuple) else "l"
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{SEP}{tag}{SEP}{i}" if prefix else f"{tag}{SEP}{i}"))
    else:
        out[prefix or "leaf"] = np.asarray(tree)
    return out


def save_pytree(path: Union[str, Path], tree: Any) -> None:
    """Write a pytree of numpy arrays as the JAX package's `save_pytree`
    does (`.npz`, one entry per leaf under its joined path)."""
    np.savez(path, **_flatten(tree))


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    """The pytree of {joined path: leaf}, as the JAX package's `_unflatten`
    rebuilds it: dicts, lists and tuples, or the lone leaf under "leaf"."""
    if list(flat.keys()) == ["leaf"]:
        return flat["leaf"]

    def insert(node, tokens, value):
        kind, key = tokens[0], tokens[1]
        key = int(key) if kind in ("l", "t") else key
        if len(tokens) == 2:
            node[1][key] = value
        else:
            child = node[1].get(key)
            if child is None:
                child = (tokens[2], {})
                node[1][key] = child
            insert(child, tokens[2:], value)

    root = None
    store: Dict = {}
    for name, value in flat.items():
        tokens = name.split(SEP)
        if root is None:
            root = (tokens[0], store)
        insert(root, tokens, value)

    def build(node):
        kind, children = node
        items = {k: build(v) if isinstance(v, tuple) else v for k, v in children.items()}
        if kind == "d":
            return items
        seq = [items[i] for i in range(len(items))]
        return tuple(seq) if kind == "t" else seq

    return build(root)


def load_pytree(path: Union[str, Path]) -> Any:
    """A pytree saved by the JAX package's `save_pytree` (`.npz`)."""
    with np.load(path, allow_pickle=False) as data:
        return _unflatten({k: data[k] for k in data.files})


def eend_state_dict_from_params(params: dict, model: nn.Module) -> StateDict:
    """JAX params alone of a WavLM + Conformer, Fbank + Conformer or
    SincNet-BiLSTM model -> `model`'s state dict. The Conformer's BatchNorm
    running statistics are the model's current ones: the JAX loader of
    `params.npz` keeps the state its initialiser made."""
    if isinstance(model, SincNetEendModel):
        return sincnet_eend_state_dict_from_jax(params, model.cfg)
    current = model.state_dict()
    blocks = []
    for i in range(model.cfg.conformer.num_layers):
        key = f"conformer.conformer_layer.{i}.conv.bn_norm"
        blocks.append({"bn": {"mean": current[f"{key}.running_mean"].numpy(),
                              "var": current[f"{key}.running_var"].numpy()}})
    convert = (fbank_eend_state_dict_from_jax if isinstance(model, FbankEendModel)
               else eend_state_dict_from_jax)
    return convert(params, {"conformer": {"blocks": blocks}}, model.cfg)
