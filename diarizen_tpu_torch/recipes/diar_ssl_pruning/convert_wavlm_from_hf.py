"""Convert a HuggingFace `WavLMModel` directory into the JAX package's WavLM
snapshot (port of recipes/diar_ssl_pruning/convert_wavlm_from_hf.py, the
pruning recipe's first stage).

Reads the directory's `config.json` and its weights, `model.safetensors` or
else `pytorch_model.bin`, with neither transformers nor safetensors: a
safetensors file is an 8-byte little-endian header length, a JSON header of
dtypes, shapes and byte offsets, and the raw bytes. Writes what the JAX CLI
writes: `params.npz` (the JAX package's WavLM pytree) and `config.json` (the
WavLMConfig's fields).

    python -m diarizen_tpu_torch.recipes.diar_ssl_pruning.convert_wavlm_from_hf \\
        --hf_dir wavlm-base-plus --out_dir out/
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import torch

from diarizen_tpu_torch.models.convert import (
    save_pytree,
    wavlm_config_from_hf,
    wavlm_params_to_jax,
    wavlm_state_dict_from_hf,
)

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """The tensors of a `.safetensors` file, on the CPU."""
    data = Path(path).read_bytes()
    size = int.from_bytes(data[:8], "little")
    header = json.loads(data[8: 8 + size])
    body = memoryview(data)[8 + size:]
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        dtype = SAFETENSORS_DTYPES[meta["dtype"]]
        flat = (torch.frombuffer(bytearray(body[start:end]), dtype=dtype) if end > start
                else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(meta["shape"])
    return out


def load_hf_wavlm(hf_dir: Union[str, Path]):
    """(WavLMConfig, state dict in the port's WavLM layout) of an HF
    directory."""
    hf_dir = Path(hf_dir)
    cfg = wavlm_config_from_hf(json.loads((hf_dir / "config.json").read_text()))
    if (hf_dir / "model.safetensors").exists():
        raw = read_safetensors(hf_dir / "model.safetensors")
    else:
        raw = torch.load(hf_dir / "pytorch_model.bin", map_location="cpu", weights_only=True)
    return cfg, wavlm_state_dict_from_hf(raw)


def main(argv: Optional[Sequence[str]] = None) -> Path:
    """Runs the conversion; returns the output directory."""
    parser = argparse.ArgumentParser(
        "python -m diarizen_tpu_torch.recipes.diar_ssl_pruning.convert_wavlm_from_hf")
    parser.add_argument("--hf_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    args = parser.parse_args(argv)

    cfg, state_dict = load_hf_wavlm(args.hf_dir)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_pytree(out / "params.npz", wavlm_params_to_jax(state_dict, cfg))
    (out / "config.json").write_text(json.dumps(dataclasses.asdict(cfg), indent=2))
    print(f"saved {out}/params.npz + config.json")
    return out


if __name__ == "__main__":
    main()
