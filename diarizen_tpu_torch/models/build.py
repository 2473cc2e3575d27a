"""Model factories for the TOML config system (port of
diarizen_tpu/models/build.py).

A factory mirrors a reference model class's constructor (`[model] path = ...`,
`[model.args]`) and returns `(config, model)`, the model with seeded random
weights or, where `wavlm_src` names a checkpoint file, that WavLM. Every
builder of the JAX package is here: the WavLM + Conformer model, its
multi-channel model, the Fbank + Conformer and SincNet-BiLSTM baselines,
and WavLM's distill-prune pair. As in the JAX package, SSeRiouSS and the
x-vector have no builder.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional, Tuple

import torch

from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.convert import (
    StateDict,
    load_reference_wavlm_checkpoint,
    random_state_dict,
)
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.fbank_eend import FbankEendConfig, FbankEendModel
from diarizen_tpu_torch.models.mc import FusionConfig, McEendConfig, McEendModel
from diarizen_tpu_torch.models.sincnet_eend import SincNetEendConfig, SincNetEendModel
from diarizen_tpu_torch.models.wavlm import WavLM, WavLMConfig
from diarizen_tpu_torch.prune.distill import DistillPruneModel
from diarizen_tpu_torch.prune.gates import PruneConfig, init_gates


def _load_wavlm(wavlm_src: str,
                allow_missing: bool = False) -> Tuple[WavLMConfig, Optional[StateDict]]:
    """A preset name ("wavlm_base", "wavlm_large", ...: random weights, None
    returned for them) or the path of a reference `{config, state_dict}`
    checkpoint (pruned s80 models included).

    `allow_missing=True` (only the `from_pretrained` snapshot loader sets it):
    a checkpoint path that does not exist, as the training-time
    `wavlm_src = "/YOUR_PATH/WavLM-Base+.pt"` of a released config, falls back
    to the preset architecture named by the file name, because
    `from_pretrained` overwrites every weight from the snapshot's own
    `pytorch_model.bin` right after the build. Training entry points keep the
    default and fail loudly: a mistyped teacher path must never silently
    become random weights."""
    try:
        return WavLMConfig.from_preset(wavlm_src), None
    except ValueError:
        pass
    if not os.path.isfile(wavlm_src):
        name = os.path.basename(str(wavlm_src)).lower()
        inferred = None
        if "large" in name:
            inferred = "wavlm_large_s80_md" if "s80" in name else "wavlm_large"
        elif "base" in name:
            inferred = "wavlm_base_s80_md" if "s80" in name else "wavlm_base"
        if allow_missing and inferred is not None:
            warnings.warn(
                f"wavlm_src {wavlm_src!r} does not exist; using the "
                f"{inferred!r} preset architecture (random init — load the "
                "real weights from the model checkpoint afterwards)",
                stacklevel=2,
            )
            return WavLMConfig.from_preset(inferred), None
        raise FileNotFoundError(
            f"wavlm_src {wavlm_src!r} is neither a preset name nor an "
            "existing checkpoint file"
        )
    return load_reference_wavlm_checkpoint(wavlm_src)


def wavlm_conformer(
    wavlm_src: str = "wavlm_base",
    wavlm_layer_num: int = 13,
    wavlm_feat_dim: int = 768,
    attention_in: int = 256,
    ffn_hidden: int = 1024,
    num_head: int = 4,
    num_layer: int = 4,
    kernel_size: int = 31,
    dropout: float = 0.1,
    use_posi: bool = False,
    output_activate_function=False,
    max_speakers_per_chunk: int = 4,
    max_speakers_per_frame: int = 2,
    chunk_size: float = 8,
    num_channels: int = 8,
    selected_channel: int = 0,
    sample_rate: int = 16000,
    seed: int = 0,
    _allow_missing_wavlm_src: bool = False,
) -> Tuple[EendConfig, EendModel]:
    """The main WavLM + Conformer EEND model, the reference constructor's
    arguments one for one. `_allow_missing_wavlm_src` is set only by
    `pipelines.from_pretrained` (see `_load_wavlm`)."""
    del num_channels
    wavlm_cfg, wavlm_sd = _load_wavlm(wavlm_src, allow_missing=_allow_missing_wavlm_src)
    cfg = EendConfig(
        wavlm=wavlm_cfg,
        conformer=ConformerConfig(
            dim=attention_in,
            ffn_hidden=ffn_hidden,
            num_heads=num_head,
            num_layers=num_layer,
            kernel_size=kernel_size,
            dropout=dropout,
            use_posi=use_posi,
            output_activation=output_activate_function or None,
        ),
        wavlm_layer_num=wavlm_layer_num,
        wavlm_feat_dim=wavlm_feat_dim,
        attention_in=attention_in,
        max_speakers_per_chunk=max_speakers_per_chunk,
        max_speakers_per_frame=max_speakers_per_frame,
        chunk_size=float(chunk_size),
        sample_rate=sample_rate,
        selected_channel=selected_channel,
    )
    model = EendModel(cfg)
    model.load_state_dict(random_state_dict(model, seed))
    if wavlm_sd is not None:
        model.wavlm_model.load_state_dict(wavlm_sd, strict=True)
    return cfg, model


def fbank_conformer(
    attention_in: int = 256,
    ffn_hidden: int = 1024,
    num_head: int = 4,
    num_layer: int = 4,
    kernel_size: int = 31,
    dropout: float = 0.1,
    use_posi: bool = False,
    output_activate_function=False,
    max_speakers_per_chunk: int = 4,
    max_speakers_per_frame: int = 2,
    chunk_size: float = 5,
    num_channels: int = 8,
    selected_channel: int = 0,
    sample_rate: int = 16000,
    n_fft: int = 400,
    n_mels: int = 80,
    win_length: int = 25,
    hop_length: int = 10,
    seed: int = 0,
) -> Tuple[FbankEendConfig, FbankEendModel]:
    """The Fbank + Conformer EEND, the reference constructor's arguments one
    for one. As in the JAX package, the fbank is fixed at n_fft 400, 25 ms
    and 10 ms: `n_fft`, `win_length`, `hop_length` and `num_channels` are
    taken and not used."""
    del num_channels, n_fft, win_length, hop_length
    cfg = FbankEendConfig(
        conformer=ConformerConfig(
            dim=attention_in, ffn_hidden=ffn_hidden, num_heads=num_head,
            num_layers=num_layer, kernel_size=kernel_size, dropout=dropout,
            use_posi=use_posi, output_activation=output_activate_function or None,
        ),
        n_mels=n_mels,
        attention_in=attention_in,
        max_speakers_per_chunk=max_speakers_per_chunk,
        max_speakers_per_frame=max_speakers_per_frame,
        chunk_size=float(chunk_size),
        sample_rate=sample_rate,
        selected_channel=selected_channel,
    )
    model = FbankEendModel(cfg)
    model.load_state_dict(random_state_dict(model, seed))
    return cfg, model


def pyannote_baseline(
    max_speakers_per_chunk: int = 4,
    chunk_size: float = 8,
    num_channels: int = 8,
    selected_channel: int = 0,
    seed: int = 0,
) -> Tuple[SincNetEendConfig, SincNetEendModel]:
    """The SincNet-BiLSTM baseline, the reference constructor's arguments
    one for one (`num_channels` taken and not used, as in the JAX package)."""
    del num_channels
    cfg = SincNetEendConfig(max_speakers_per_chunk=max_speakers_per_chunk,
                            chunk_size=float(chunk_size), selected_channel=selected_channel)
    model = SincNetEendModel(cfg)
    model.load_state_dict(random_state_dict(model, seed))
    return cfg, model


def wavlm_conformer_mc(
    wavlm_src: str = "wavlm_base",
    fusion_kind: str = "cross_attention",
    num_fusion_layers: int = 4,
    fusion_hidden: int = 256,
    fusion_heads: int = 8,
    num_channels: int = 8,
    seed: int = 0,
    **kwargs,
) -> Tuple[McEendConfig, McEendModel]:
    """The multi-channel WavLM + Conformer EEND: `wavlm_conformer`'s model
    (the same weights for the same seed and `kwargs`) with
    `num_fusion_layers` channel fusions seeded from seed + 1."""
    cfg, base = wavlm_conformer(wavlm_src=wavlm_src, num_channels=num_channels, seed=seed,
                                **kwargs)
    fcfg = FusionConfig(kind=fusion_kind, num_fusion_layers=num_fusion_layers,
                        hidden=fusion_hidden, num_heads=fusion_heads)
    # a shallow field copy: asdict would turn the nested configs into dicts
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    mc_cfg = McEendConfig(**fields, fusion=fcfg, num_channels=num_channels)
    model = McEendModel(mc_cfg)
    fusions = random_state_dict(model.channel_fusions, seed + 1)
    model.load_state_dict({**base.state_dict(),
                           **{f"channel_fusions.{k}": v for k, v in fusions.items()}})
    return mc_cfg, model


def _wavlm(wavlm_src: str, seed: int) -> Tuple[WavLMConfig, WavLM]:
    """The WavLM of `wavlm_src`, with seeded random weights for a preset."""
    cfg, sd = _load_wavlm(wavlm_src)
    model = WavLM(cfg)
    model.load_state_dict(sd if sd is not None else random_state_dict(model, seed))
    return cfg, model


def distill_prune(teacher_ckpt: str, student_ckpt: Optional[str] = None,
                  pruning_units: str = "conv,head,interm", distill_layers: str = "0,4,8,12",
                  seed: int = 0):
    """The distill-prune "model": a frozen teacher and a gated student WavLM,
    the reference constructor's arguments one for one; `student_ckpt`
    defaults to the teacher's. Returns (WavLMConfig, DistillPruneModel)
    holding the teacher, the student, the student's log-alphas (seeded from
    seed + 1), the PruneConfig and the distill layers."""
    units = [u.strip() for u in str(pruning_units).split(",") if u.strip()]
    pcfg = PruneConfig(
        prune_conv_channels="conv" in units,
        prune_attention_heads="head" in units,
        prune_attention_layer="attlayer" in units,
        prune_feed_forward_intermediate="interm" in units,
        prune_feed_forward_layer="ffnlayer" in units,
    )
    cfg, teacher = _wavlm(teacher_ckpt, seed)
    student_sd = None
    if student_ckpt not in (None, teacher_ckpt):
        student_sd = _load_wavlm(student_ckpt)[1]
    student = WavLM(cfg)
    student.load_state_dict(student_sd if student_sd is not None else teacher.state_dict())
    gates = init_gates(cfg, pcfg, torch.Generator().manual_seed(seed + 1))
    layers = tuple(int(x) for x in str(distill_layers).split(","))
    return cfg, DistillPruneModel(teacher, student, gates, pcfg, layers)
