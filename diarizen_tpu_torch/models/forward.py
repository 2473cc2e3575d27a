"""One segmentation forward for every model family (port of
diarizen_tpu/models/forward.py): `segmentation_forward(model)` gives

    fwd(waveforms, compute_dtype, train, generator) -> log-powerset scores (B, F, P)

so the train and eval steps need not know the family. The JAX package
dispatches on the config type; the port's models carry their config, so it
dispatches on the model. The SincNet family runs float32 whatever compute
type it is given, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from diarizen_tpu_torch.models.eend import EendModel
from diarizen_tpu_torch.models.fbank_eend import FbankEendModel
from diarizen_tpu_torch.models.mc import McEendModel
from diarizen_tpu_torch.models.sincnet_eend import SincNetEendModel
from diarizen_tpu_torch.models.sserious import SSeRiouSSModel

# models whose forward already has the normalised signature
_DIRECT = (EendModel, FbankEendModel, SincNetEendModel, SSeRiouSSModel)


def segmentation_forward(model: nn.Module) -> Callable:
    """The normalised forward of a segmentation model."""
    if isinstance(model, McEendModel):
        def mc_fwd(waveforms, compute_dtype=torch.float32, train=False, generator=None):
            return model(waveforms, compute_dtype, train, generator)[0]

        return mc_fwd
    if isinstance(model, _DIRECT):
        return model
    raise NotImplementedError(
        f"no segmentation forward for {type(model).__name__}: the port's segmentation "
        "families are WavLM + Conformer (EendModel), its multi-channel model (McEendModel), "
        "Fbank + Conformer (FbankEendModel), SincNet-BiLSTM (SincNetEendModel) and SSeRiouSS "
        "(SSeRiouSSModel); what the JAX package has beyond the port (its learning-rate "
        "schedules, parallel/ and the rest of utils.py) holds no model")
