"""SSeRiouSS: a frozen WavLM trunk with a BiLSTM head (port of
diarizen_tpu/models/sserious.py, pyannote's SSeRiouSS).

WavLM features, never trained here (the reference runs its trunk under
no_grad) -> a softmax-weighted sum over the transformer layers' outputs (or
one chosen layer, `wav2vec_layer >= 1`) -> the features rounded to the
compute type -> float32 BiLSTM layers -> Linear + leaky ReLU layers ->
powerset head -> log-softmax.

In eval with the weighted sum, WavLM's forward accumulates the sum in its
layer loop with weights [0, softmax(w)]: K1 for every attention layer and,
behind `set_fused_ln(True)`, K3 and K4 (K4 doing the sum's update), and on
an extractor it fits, K5 behind `set_conv_chain(True)`. In training the
trunk's hidden states are computed under `torch.no_grad()` (K1's training
instance, forward only, so K2 never runs) and the sum comes after it, so
`wav2vec_weights` still gets its gradient.

Key layout after pyannote's SSeRiouSS (one LSTM module per layer):
`wav2vec.*` (the port's WavLM), `wav2vec_weights` (L,), `lstm.{i}`,
`linear.{i}`, `classifier`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from diarizen_tpu_torch.models.common import TrainRandom, leaky_relu, lstm_layer, run_lstm
from diarizen_tpu_torch.models.wavlm import WavLM, WavLMConfig
from diarizen_tpu_torch.ops.powerset import Powerset, num_powerset_classes
from diarizen_tpu_torch.ops.receptive_field import (
    multi_conv_receptive_field_center,
    multi_conv_receptive_field_size,
)


@dataclasses.dataclass(frozen=True)
class SSeRiouSSConfig:
    wavlm: WavLMConfig = WavLMConfig()
    # -1: learned softmax weights over all transformer layer outputs; >= 1:
    # that layer's output alone
    wav2vec_layer: int = -1
    lstm_hidden: int = 128
    lstm_layers: int = 4
    bidirectional: bool = True
    lstm_dropout: float = 0.0
    linear_hidden: int = 128
    linear_layers: int = 2
    max_speakers_per_chunk: int = 4
    max_speakers_per_frame: int = 2
    chunk_size: float = 8.0
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
        """(frame step seconds, frame duration seconds) of WavLM's conv stack."""
        kernels = [k for _, k, _ in self.wavlm.conv_layers]
        strides = [s for _, _, s in self.wavlm.conv_layers]
        size = multi_conv_receptive_field_size(1, kernels, strides)
        c0 = multi_conv_receptive_field_center(0, kernels, strides)
        c1 = multi_conv_receptive_field_center(1, kernels, strides)
        return (c1 - c0) / self.sample_rate, size / self.sample_rate


class SSeRiouSSModel(nn.Module):
    def __init__(self, cfg: SSeRiouSSConfig):
        super().__init__()
        self.cfg = cfg
        self.wav2vec = WavLM(cfg.wavlm)
        # raw logits, softmax-normalised in the forward
        self.wav2vec_weights = nn.Parameter(torch.ones(cfg.wavlm.num_layers))
        out = cfg.lstm_hidden * (2 if cfg.bidirectional else 1)
        self.lstm = nn.ModuleList(
            lstm_layer(cfg.wavlm.embed_dim if i == 0 else out, cfg.lstm_hidden, cfg.bidirectional)
            for i in range(cfg.lstm_layers))
        widths = [out] + [cfg.linear_hidden] * cfg.linear_layers
        self.linear = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.classifier = nn.Linear(widths[-1], cfg.num_powerset_classes)

    def features(self, waveforms: torch.Tensor, compute_dtype: torch.dtype, train: bool,
                 rng: Optional[TrainRandom]) -> torch.Tensor:
        """(B, num_samples) -> float32 (B, F, D): the weighted sum of the
        transformer layers' outputs, or the chosen layer's."""
        w = torch.softmax(self.wav2vec_weights.float(), dim=0)
        if self.cfg.wav2vec_layer < 0 and not train:
            # the sum in WavLM's layer loop, zero weight on hidden state 0
            return self.wav2vec(waveforms, torch.cat([w.new_zeros(1), w]), compute_dtype)
        with torch.no_grad():
            hidden = self.wav2vec.hidden_states(waveforms, compute_dtype, train=train, rng=rng)
        if self.cfg.wav2vec_layer >= 0:
            return hidden[self.cfg.wav2vec_layer].float()
        # (L, B, F, D): a contiguous stack, then one product over the layers
        return torch.tensordot(w, torch.stack(hidden[1:]).float(), dims=1)

    def forward(self, waveforms: torch.Tensor, compute_dtype: torch.dtype = torch.float32,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, C, num_samples) or (B, num_samples) -> float32 log-powerset
        scores (B, F, P). `train` runs the trunk's training forward (no
        gradient reaches it); with a host `generator` it also draws the
        trunk's dropout and the dropout between the LSTM layers."""
        if waveforms.dim() == 3:
            waveforms = waveforms[:, self.cfg.selected_channel]
        rng = (TrainRandom(generator, waveforms.device, self.wav2vec.mesh)
               if (train and generator is not None) else None)
        x = self.features(waveforms, compute_dtype, train, rng).to(compute_dtype)
        x = run_lstm(self.lstm, x, self.cfg.lstm_dropout, None if rng is None else rng.device)
        for layer in self.linear:
            x = leaky_relu(layer(x))
        return torch.log_softmax(self.classifier(x), dim=-1)
