"""Seeded weights of a configuration, made on the device in one draw a model.

The shapes and key names come from the plain reference's parameter lists,
not from the program: `load_state_dict(strict=True)` into the program's
models then checks that both sides hold the same tensors. One normal draw
per model from a generator on the device, cut into tensors and scaled by
kind: products' weights with variance 1 / fan_in (the classifier's times
`classifier_scale`, for confident decisions), biases a third of that, norms
1 +- 0.1 and shifts of 0.1, BatchNorm running statistics near (0, 1),
embedding tables at 0.02, a weight-normed convolution's g the norm of its
v per tap.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.embedding import param_specs as embedding_specs
from portbench.reference.segmentation import param_specs as segmentation_specs


def _draw(specs: list, seed: int, device, classifier_scale: float) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, offset = {}, 0
    for (name, shape, kind, fan_in), size in zip(specs, sizes):
        z = flat[offset: offset + size].reshape(shape)
        offset += size
        if kind in ("w", "classifier"):
            t = z / math.sqrt(fan_in) * (classifier_scale if kind == "classifier" else 1.0)
        elif kind == "b":
            t = z / math.sqrt(3.0 * fan_in)
        elif kind == "norm_w":
            t = 1.0 + 0.1 * z
        elif kind in ("norm_b", "bn_mean"):
            t = 0.1 * z
        elif kind == "bn_var":
            t = 1.0 + 0.1 * z.abs()
        elif kind == "embed":
            t = 0.02 * z
        elif kind == "ones":
            t = torch.ones(shape, device=device)
        elif kind == "count":
            t = torch.zeros(shape, dtype=torch.int64, device=device)
        elif kind == "weight_g":
            t = None  # set from its v below
        else:
            raise ValueError(f"unknown parameter kind {kind!r} of {name}")
        out[name] = t
    for name in [n for n, v in out.items() if v is None]:
        v = out[name[: -len("weight_g")] + "weight_v"]
        out[name] = v.norm(dim=(0, 1), keepdim=True)
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{"segmentation": state dict[, "embedding": state dict]} of `cfg`
    (the embedding model where the configuration has one), float32 on
    `device`, from the configuration's `[weights] seed` where it gives one,
    else from `seed`."""
    arch, scale = cfg["architecture"], float(cfg["weights"]["classifier_scale"])
    seed = cfg["weights"].get("seed", seed)  # a configuration may fix its weights
    out = {"segmentation": _draw(segmentation_specs(arch), seed % 2**62, device, scale)}
    if "resnet" in arch:
        out["embedding"] = _draw(embedding_specs(arch), (seed + 1) % 2**62, device, 1.0)
    return out
