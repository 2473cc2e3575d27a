"""A toy of the multi-channel cell's configuration, for tests on the CPU: 3
microphones, cross-channel fusions 16 wide in 4 heads, a post-LN WavLM of 4
layers 32 wide with uneven kept heads, the pipeline's own ResNet34 (at the
PLDA's 256), VBx. `setup_dir` writes the set-up directory that
`pipelines.from_pretrained` reads, as the benchmark writes one, with this
configuration in its config.toml; its `[weights]` and `[architecture]` are
what `traffic/mc_files.make_weights` and the reference read."""

from __future__ import annotations

import tomllib

import numpy as np
import torch

from portbench.traffic.files import write_setup_dir
from portbench.traffic.mc_files import synthesize

CHANNELS = 3
WAVLM = {"extractor_mode": "group_norm",
         "conv_layers": [[24, 10, 5], [12, 3, 2], [20, 3, 2], [16, 3, 2], [10, 3, 2], [18, 2, 2],
                         [14, 2, 2]],
         "conv_bias": False, "embed_dim": 32, "pos_conv_kernel": 8, "pos_conv_groups": 4,
         "num_layers": 4, "use_attention": [True, True, False, True],
         "use_feed_forward": [True] * 4, "total_num_heads": [4] * 4,
         "remaining_heads": [[0, 2, 3], [1], [], [0, 1, 2, 3]], "num_buckets": 32,
         "max_distance": 64, "ff_interm_features": [24, 40, 8, 16], "layer_norm_first": False,
         "normalize_waveform": False}
EEND = {"wavlm_layer_num": 5, "wavlm_feat_dim": 32, "attention_in": 16,
        "conformer_ffn_hidden": 24, "conformer_heads": 2, "conformer_layers": 2,
        "conformer_kernel": 5, "max_speakers_per_chunk": 4, "max_speakers_per_frame": 2,
        "sample_rate": 16000}
RESNET = {"m_channels": 32, "num_blocks": [3, 4, 6, 3], "feat_dim": 80, "embed_dim": 256}
TRAFFIC = {"speakers": [2, 3], "turn_s": [1.0, 3.0], "advance": [0.7, 1.0], "sample_rate": 16000,
           "microphones": CHANNELS, "delay_samples": [0, 31], "gain": [0.2, 1.0],
           "noise": 0.003}


def fusion(fusions: int) -> dict:
    return {"kind": "cross_attention", "num_fusion_layers": fusions, "hidden": 16,
            "num_heads": 4}


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    return repr(v)


def _toml(sections: dict) -> str:
    return "\n".join(f"[{name}]\n" + "".join(f"{k} = {_toml_value(v)}\n" for k, v in body.items())
                     for name, body in sections.items())


def wavlm_config():
    from diarizen_tpu_torch.models.wavlm import WavLMConfig

    w = WAVLM
    return WavLMConfig(
        extractor_mode=w["extractor_mode"], conv_layers=tuple(map(tuple, w["conv_layers"])),
        embed_dim=w["embed_dim"], pos_conv_kernel=w["pos_conv_kernel"],
        pos_conv_groups=w["pos_conv_groups"], num_layers=w["num_layers"],
        use_attention=tuple(w["use_attention"]), use_feed_forward=tuple(w["use_feed_forward"]),
        total_num_heads=tuple(w["total_num_heads"]),
        remaining_heads=tuple(map(tuple, w["remaining_heads"])), num_buckets=w["num_buckets"],
        max_distance=w["max_distance"], ff_interm_features=tuple(w["ff_interm_features"]),
        layer_norm_first=False, normalize_waveform=False, layer_drop=0.0)


def toml_text(wavlm_src: str, seed: int, fusions: int) -> str:
    """The toy configuration's config.toml."""
    return _toml({
        "model": {"path": "diarizen.models.eend.model_wavlm_conformer_mc.Model"},
        "model.args": {"wavlm_src": wavlm_src, "fusion_kind": "cross_attention",
                       "num_fusion_layers": fusions, "fusion_hidden": 16, "fusion_heads": 4,
                       "num_channels": CHANNELS, "wavlm_layer_num": 5, "wavlm_feat_dim": 32,
                       "attention_in": 16, "ffn_hidden": 24, "num_head": 2, "num_layer": 2,
                       "kernel_size": 5, "chunk_size": 2, "max_speakers_per_chunk": 4},
        "inference.args": {"seg_duration": 2, "segmentation_step": 0.1, "batch_size": 8,
                           "apply_median_filtering": True},
        "clustering.args": {"method": "VBxClustering", "min_speakers": 1, "max_speakers": 8,
                            "ahc_criterion": "distance", "ahc_threshold": 0.6, "Fa": 0.06,
                            "Fb": 0.9, "lda_dim": 128, "max_iters": 20},
        "weights": {"seed": seed, "classifier_scale": 10.0},
        "architecture": {"channels": CHANNELS},
        "architecture.wavlm": WAVLM, "architecture.eend": EEND, "architecture.resnet": RESNET,
        "architecture.fusion": fusion(fusions),
    })


def wavlm_checkpoint(root) -> str:
    """A toy WavLM checkpoint file, which `wavlm_src` names (its weights are
    replaced by the seeded ones)."""
    from diarizen_tpu_torch.models.wavlm import WavLM

    path = root / "wavlm_toy.pt"
    torch.save({"config": wavlm_config().to_reference_dict(),
                "state_dict": WavLM(wavlm_config()).state_dict()}, path)
    return str(path)


def setup_dir(root, seed: int, fusions: int):
    """(set-up directory, its configuration as a dict) for the toy model."""
    text = toml_text(wavlm_checkpoint(root), seed, fusions)
    setup = write_setup_dir(root / "model", "mc-chatt-base-s80-md", seed)
    (setup / "config.toml").write_text(text)
    return setup, tomllib.loads(text)


def toy_files(lengths=((6.3, 3), (4.1, 2), (2.5, 2)), seed: int = 5) -> list:
    """(3, samples) files of the cell's synthetic microphones."""
    rng, gen = np.random.default_rng(seed), torch.Generator().manual_seed(seed)
    return [synthesize(s, n, TRAFFIC, rng, gen, "cpu") for s, n in lengths]
