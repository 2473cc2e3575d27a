"""EEND segmentation model: WavLM + Conformer + powerset head (port of
diarizen_tpu/models/eend.py).

Waveforms -> WavLM hidden states summed with learned layer weights (float32)
-> Linear + LayerNorm -> Conformer -> Linear -> log-softmax over the powerset
classes; `forward(..., stage=)` runs the inference forward in three parts,
cut after WavLM's feature projection and after the weighted sum. Key layout
as the reference's `pytorch_model.bin`: `wavlm_model.*`, `weight_sum.weight`
(1, L), `proj`, `lnorm`, `conformer.*`, `classifier`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from diarizen_tpu_torch.models.common import TrainRandom, layer_norm, linear
from diarizen_tpu_torch.models.conformer import Conformer, ConformerConfig
from diarizen_tpu_torch.models.wavlm import WavLM, WavLMConfig
from diarizen_tpu_torch.ops.powerset import Powerset, num_powerset_classes
from diarizen_tpu_torch.ops.receptive_field import (
    multi_conv_receptive_field_center,
    multi_conv_receptive_field_size,
)


@dataclasses.dataclass(frozen=True)
class EendConfig:
    wavlm: WavLMConfig = WavLMConfig()
    conformer: ConformerConfig = ConformerConfig()
    wavlm_layer_num: int = 13  # hidden states incl. the conv output
    wavlm_feat_dim: int = 768
    attention_in: int = 256
    max_speakers_per_chunk: int = 4
    max_speakers_per_frame: int = 2
    chunk_size: float = 8.0  # seconds
    sample_rate: int = 16000
    selected_channel: int = 0

    @property
    def num_powerset_classes(self) -> int:
        return num_powerset_classes(self.max_speakers_per_chunk, self.max_speakers_per_frame)

    @property
    def powerset(self) -> Powerset:
        return Powerset(self.max_speakers_per_chunk, self.max_speakers_per_frame)

    def num_frames(self, num_samples: int) -> int:
        return self.wavlm.num_frames(num_samples)

    def rf_info(self) -> Tuple[float, float]:
        """(frame step seconds, frame duration seconds) of the output frames."""
        kernels = [k for _, k, _ in self.wavlm.conv_layers]
        strides = [s for _, _, s in self.wavlm.conv_layers]
        rf_size = multi_conv_receptive_field_size(1, kernels, strides)
        c0 = multi_conv_receptive_field_center(0, kernels, strides)
        c1 = multi_conv_receptive_field_center(1, kernels, strides)
        return (c1 - c0) / self.sample_rate, rf_size / self.sample_rate


class EendModel(nn.Module):
    # the inference forward's parts, in order (`forward(..., stage=)`)
    inference_stages = ("extract", "encode", "back_end")

    def __init__(self, cfg: EendConfig):
        super().__init__()
        self.cfg = cfg
        self.wavlm_model = WavLM(cfg.wavlm)
        self.weight_sum = nn.Linear(cfg.wavlm_layer_num, 1, bias=False)
        self.proj = nn.Linear(cfg.wavlm_feat_dim, cfg.attention_in)
        self.lnorm = nn.LayerNorm(cfg.attention_in)
        self.conformer = Conformer(cfg.conformer)
        self.classifier = nn.Linear(cfg.attention_in, cfg.num_powerset_classes)

    def forward(self, waveforms: torch.Tensor, compute_dtype: torch.dtype = torch.float32,
                train: bool = False, generator: Optional[torch.Generator] = None,
                stage: Optional[str] = None) -> torch.Tensor:
        """(B, C, num_samples) or (B, num_samples) -> float32 log-powerset
        scores (B, F, P).

        `train=True` is the training forward (differentiable attention
        kernels, GradMultiply, BatchNorm on batch statistics, which moves the
        running ones); with a host `generator` it also draws dropout, layer
        drop and the attention-dropout seeds.

        `stage` (inference) runs one of `inference_stages` on the output of
        the one before: "extract" the waveforms through WavLM's extractor
        and feature projection (`WavLM.extract`), "encode" that through its
        transformer to the float32 weighted sum of the hidden states
        (`WavLM.encode`), "back_end" that through the projection, the
        Conformer and the classifier to the scores. In turn they give the
        whole forward exactly; the serving path replays each as its own
        CUDA graph and times it on the stream (`infer/sliding.py`)."""
        if stage == "encode":
            return self.wavlm_model.encode(waveforms, self.weight_sum.weight.reshape(-1))
        if stage == "back_end":
            return self._back_end(waveforms, compute_dtype)
        if waveforms.dim() == 3:
            waveforms = waveforms[:, self.cfg.selected_channel]
        if stage == "extract":
            return self.wavlm_model.extract(waveforms, compute_dtype)
        if stage is not None:
            raise ValueError(f"unknown stage {stage!r}; the stages are {self.inference_stages}")
        rng = (TrainRandom(generator, waveforms.device, self.wavlm_model.mesh)
               if (train and generator is not None) else None)
        feat = self.wavlm_model(waveforms, self.weight_sum.weight.reshape(-1), compute_dtype,
                                train=train, rng=rng)
        return self._back_end(feat, compute_dtype, train, rng)

    def _back_end(self, feat: torch.Tensor, compute_dtype: torch.dtype, train: bool = False,
                  rng: Optional[TrainRandom] = None) -> torch.Tensor:
        x = layer_norm(self.lnorm, linear(self.proj, feat.to(compute_dtype)))
        x = self.conformer(x, train=train, rng=rng)
        return torch.log_softmax(linear(self.classifier, x).float(), dim=-1)

    def param_groups(self) -> Dict[str, Dict[str, nn.Parameter]]:
        """The dual-LR split of the JAX package's `non_wavlm_param_labels`:
        {"wavlm": the WavLM trunk's parameters, "other": the rest}, by name."""
        groups: Dict[str, Dict[str, nn.Parameter]] = {"wavlm": {}, "other": {}}
        for name, p in self.named_parameters():
            groups["wavlm" if name.startswith("wavlm_model.") else "other"][name] = p
        return groups
