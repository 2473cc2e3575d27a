"""One segmentation forward for every ported model family (port of
diarizen_tpu/models/forward.py): `segmentation_forward(model)` gives

    fwd(waveforms, compute_dtype, train, generator) -> log-powerset scores (B, F, P)

so the train and eval steps need not know the family. The JAX package
dispatches on the config type; the port's models carry their config, so it
dispatches on the model.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from diarizen_tpu_torch.models.eend import EendModel
from diarizen_tpu_torch.models.mc import McEendModel


def segmentation_forward(model: nn.Module) -> Callable:
    """The normalised forward of a segmentation model."""
    if isinstance(model, McEendModel):
        def mc_fwd(waveforms, compute_dtype=torch.float32, train=False, generator=None):
            return model(waveforms, compute_dtype, train, generator)[0]

        return mc_fwd
    if isinstance(model, EendModel):
        return model
    raise NotImplementedError(
        f"no segmentation forward for {type(model).__name__}: the fbank, SincNet (pyannote), "
        "S-Serious and x-vector families are not ported; WavLM + Conformer (EendModel) and its "
        "multi-channel model (McEendModel) are")
