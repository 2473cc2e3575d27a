"""The HuggingFace WavLM import of the port
(`recipes/diar_ssl_pruning/convert_wavlm_from_hf.py`, `models/convert.py`)
against transformers and the JAX package's CLI.

A tiny random `WavLMModel`, post-LN (Base) and pre-LN (Large), as
tests/test_wavlm.py builds it, saved with `save_pretrained` once as
`model.safetensors` and once as `pytorch_model.bin`, goes through the port's
CLI and the JAX package's: the two `params.npz` agree within 1e-4 (leaf for
leaf, every leaf present in both) and the two `config.json` are equal. The
port's WavLM loaded from the HF directory gives HF's hidden states within
1e-4 (waveform normalisation off: HF does it in the processor; for pre-LN,
HF records the last state after the encoder's LayerNorm, which the test
applies). The port reads safetensors itself: its reader, and the writer of
`chip_smoke.py`'s HF-import phase, agree with the safetensors package
exactly.
"""

import dataclasses
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diarizen_tpu_torch.models.build import _load_wavlm
from diarizen_tpu_torch.models.convert import (
    load_pytree,
    wavlm_config_from_hf,
    wavlm_state_dict_from_hf,
    wavlm_state_dict_to_hf,
)
from diarizen_tpu_torch.models.wavlm import WavLM
from diarizen_tpu_torch.recipes.diar_ssl_pruning import convert_wavlm_from_hf as cli

ROOT = Path(__file__).resolve().parents[1]
JAX_CLI = ROOT / "recipes/diar_ssl_pruning/convert_wavlm_from_hf.py"
STYLES = {"base-postln": False, "large-preln": True}
FORMATS = {"safetensors": True, "bin": False}


@pytest.fixture(scope="module", params=sorted(STYLES))
def hf(request, tmp_path_factory):
    """{format: HF directory} of one tiny random WavLMModel, the model, and
    its hidden states on a seeded wave."""
    transformers = pytest.importorskip("transformers")
    stable = STYLES[request.param]
    hf_cfg = transformers.WavLMConfig(
        hidden_size=96, num_hidden_layers=3, num_attention_heads=4, intermediate_size=192,
        conv_dim=[32] * 7, num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16,
        num_buckets=40, max_bucket_distance=100, do_stable_layer_norm=stable,
        feat_extract_norm="layer" if stable else "group", conv_bias=stable, layerdrop=0.0)
    torch.manual_seed(3407)
    model = transformers.WavLMModel(hf_cfg).eval()
    dirs = {}
    for name, safe in FORMATS.items():
        dirs[name] = tmp_path_factory.mktemp(f"{request.param}_{name}")
        model.save_pretrained(dirs[name], safe_serialization=safe)
    wave = (0.1 * np.random.default_rng(0).standard_normal((2, 4000))).astype(np.float32)
    with torch.no_grad():
        hidden = model(torch.from_numpy(wave), output_hidden_states=True).hidden_states
    return dirs, model, wave, [h.numpy() for h in hidden]


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_cli_writes_what_the_jax_cli_writes(hf, fmt, tmp_path, monkeypatch):
    dirs, _, _, _ = hf
    assert (dirs[fmt] / ("model.safetensors" if FORMATS[fmt] else "pytorch_model.bin")).exists()
    cli.main(["--hf_dir", str(dirs[fmt]), "--out_dir", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["convert_wavlm_from_hf.py", "--hf_dir", str(dirs[fmt]),
                                      "--out_dir", str(tmp_path / "jax")])
    runpy.run_path(str(JAX_CLI), run_name="__main__")

    ours = np.load(tmp_path / "port/params.npz")
    ref = np.load(tmp_path / "jax/params.npz")
    assert sorted(ours.files) == sorted(ref.files)
    for key in ref.files:
        assert ours[key].shape == ref[key].shape, key
        np.testing.assert_allclose(ours[key], ref[key], rtol=0, atol=1e-4, err_msg=key)
    assert (json.loads((tmp_path / "port/config.json").read_text())
            == json.loads((tmp_path / "jax/config.json").read_text()))


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_hidden_states_match_hf(hf, fmt):
    dirs, _, wave, expected = hf
    cfg, state_dict = cli.load_hf_wavlm(dirs[fmt])
    model = WavLM(dataclasses.replace(cfg, normalize_waveform=False)).eval()
    model.load_state_dict(state_dict, strict=True)
    with torch.no_grad():
        got = model.hidden_states(torch.from_numpy(wave))
        if cfg.layer_norm_first:
            norm = model.encoder.transformer.layer_norm
            got[-1] = F.layer_norm(got[-1], got[-1].shape[-1:], norm.weight, norm.bias, norm.eps)
    assert len(got) == len(expected) == cfg.num_layers + 1
    for i, (a, b) in enumerate(zip(got, expected)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4, err_msg=f"hidden state {i}")


def test_key_maps_invert_and_the_reference_loader_takes_hf(hf, tmp_path):
    """HF -> reference -> HF gives HF's state dict back, bit for bit
    (`masked_spec_embed` aside), also from under a head model's `wavlm.`
    prefix; a reference `{config, state_dict}` file
    holding an HF-layout state dict loads through `_load_wavlm`; the
    params.npz the CLI wrote carries into the port's WavLM layout again."""
    dirs, model, _, _ = hf
    hf_sd = {k: v for k, v in model.state_dict().items() if k != "masked_spec_embed"}
    ours = wavlm_state_dict_from_hf(model.state_dict())
    assert not any(k.startswith(("feature_projection.", "encoder.layers.")) for k in ours)
    # a model with a head keeps its WavLM under `wavlm.`
    headed = {**{f"wavlm.{k}": v for k, v in model.state_dict().items()},
              "projector.weight": torch.zeros(2, 2)}
    assert {k: torch.equal(v, ours[k]) for k, v in wavlm_state_dict_from_hf(headed).items()
            } == {k: True for k in ours}
    back = wavlm_state_dict_to_hf(ours)
    assert sorted(back) == sorted(hf_sd)
    for key, value in hf_sd.items():
        assert torch.equal(back[key], value), key

    cfg, _ = cli.load_hf_wavlm(dirs["bin"])
    assert wavlm_config_from_hf(model.config) == cfg  # the config object or its config.json
    path = tmp_path / "wavlm.pt"
    torch.save({"config": cfg.to_reference_dict(), "state_dict": model.state_dict()}, path)
    loaded_cfg, loaded = _load_wavlm(str(path))
    assert loaded_cfg.num_layers == cfg.num_layers and sorted(loaded) == sorted(ours)
    WavLM(loaded_cfg).load_state_dict(loaded, strict=True)

    cli.main(["--hf_dir", str(dirs["safetensors"]), "--out_dir", str(tmp_path / "out")])
    params = load_pytree(tmp_path / "out/params.npz")
    assert len(params["layers"]) == cfg.num_layers and "output_scale" not in params[
        "feature_extractor"]

    with pytest.raises(ValueError, match="rel_attn_embed"):
        wavlm_state_dict_from_hf({k: v for k, v in model.state_dict().items()
                                  if "rel_attn_embed" not in k})


def test_safetensors_reader_and_writer_match_the_package(tmp_path):
    safetensors_torch = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(0)
    tensors = {
        "f32": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
        "bf16": torch.from_numpy(rng.standard_normal(7).astype(np.float32)).bfloat16(),
        "f16": torch.from_numpy(rng.standard_normal((2, 2, 2)).astype(np.float16)),
        "i64": torch.arange(-3, 4),
        "u8": torch.arange(5, dtype=torch.uint8),
        "flag": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }
    safetensors_torch.save_file(tensors, tmp_path / "ref.safetensors", metadata={"format": "pt"})
    import chip_smoke  # the writer of the card's HF-import phase

    chip_smoke.write_safetensors(tmp_path / "ours.safetensors", tensors)
    for got in (cli.read_safetensors(tmp_path / "ref.safetensors"),
                safetensors_torch.load_file(tmp_path / "ours.safetensors")):
        assert sorted(got) == sorted(tensors)
        for name, value in tensors.items():
            assert got[name].dtype == value.dtype and torch.equal(got[name], value), name
