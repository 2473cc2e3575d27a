"""DiariZen-Large's kind of segmentation model on the port's serving path,
against the benchmark's plain reference (`portbench/reference`), on the CPU
at a toy size: the waveform normalised, a LayerNorm after every conv of the
extractor, pre-LN layers with uneven kept heads, one layer with its
attention removed, a feed-forward width a layer. The pipeline is built by
`pipelines.from_pretrained` from a set-up directory as the benchmark writes
one, with the benchmark's seeded weights, and its streamed outputs are held
to the reference with the tolerances of
`portbench/tests/test_portbench_reference.py`. Also: the three inference
stages compose to the one-piece forward exactly, and the benchmark's
configurations spell out the port's presets."""

import dataclasses
import tomllib

import numpy as np
import pytest
import torch

from diarizen_tpu_torch import pipelines
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.wavlm import WavLM, WavLMConfig
from portbench import core
from portbench.reference.judge import Layout, judge_file
from portbench.reference.segmentation import Segmentation
from portbench.traffic.files import Outputs, synthesize, write_setup_dir
from portbench.weights import make_weights

WAVLM = {"extractor_mode": "layer_norm",
         "conv_layers": [[24, 10, 5], [12, 3, 2], [20, 3, 2], [16, 3, 2], [10, 3, 2], [18, 2, 2],
                         [14, 2, 2]],
         "conv_bias": False, "embed_dim": 32, "pos_conv_kernel": 8, "pos_conv_groups": 4,
         "num_layers": 4, "use_attention": [True, True, False, True],
         "use_feed_forward": [True] * 4, "total_num_heads": [4] * 4,
         "remaining_heads": [[0, 2, 3], [1], [], [0, 1, 2, 3]], "num_buckets": 32,
         "max_distance": 64, "ff_interm_features": [24, 40, 8, 16], "layer_norm_first": True,
         "normalize_waveform": True}
EEND = {"wavlm_layer_num": 5, "wavlm_feat_dim": 32, "attention_in": 16,
        "conformer_ffn_hidden": 24, "conformer_heads": 2, "conformer_layers": 2,
        "conformer_kernel": 5, "max_speakers_per_chunk": 4, "max_speakers_per_frame": 2,
        "sample_rate": 16000}
# the pipeline's own ResNet34 (`pipelines.load_resnet`), at the PLDA's 256
RESNET = {"m_channels": 32, "num_blocks": [3, 4, 6, 3], "feat_dim": 80, "embed_dim": 256}
TRAFFIC = {"speakers": [2, 3], "turn_s": [1.0, 3.0], "advance": [0.7, 1.0], "sample_rate": 16000}
# the first seed whose scores hold silence, one and two speakers, each on 5% of the frames or more
WEIGHTS_SEED = 5


def toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(toml_value(x) for x in v) + "]"
    return repr(v)


def toml(sections: dict) -> str:
    return "\n".join(f"[{name}]\n" + "".join(f"{k} = {toml_value(v)}\n" for k, v in body.items())
                     for name, body in sections.items())


def wavlm_config() -> WavLMConfig:
    w = WAVLM
    return WavLMConfig(
        extractor_mode=w["extractor_mode"], conv_layers=tuple(map(tuple, w["conv_layers"])),
        embed_dim=w["embed_dim"], pos_conv_kernel=w["pos_conv_kernel"],
        pos_conv_groups=w["pos_conv_groups"], num_layers=w["num_layers"],
        use_attention=tuple(w["use_attention"]), use_feed_forward=tuple(w["use_feed_forward"]),
        total_num_heads=tuple(w["total_num_heads"]),
        remaining_heads=tuple(map(tuple, w["remaining_heads"])), num_buckets=w["num_buckets"],
        max_distance=w["max_distance"], ff_interm_features=tuple(w["ff_interm_features"]),
        layer_norm_first=True, normalize_waveform=True, layer_drop=0.0)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(cfg, weights, setup dir, [(wave, outputs)]): two files streamed
    through the pipeline that `from_pretrained` builds from the set-up
    directory, the benchmark's weights loaded as its run loads them."""
    torch.manual_seed(0)
    root = tmp_path_factory.mktemp("large-toy")
    wavlm_ckpt = root / "wavlm_toy.pt"
    torch.save({"config": wavlm_config().to_reference_dict(),
                "state_dict": WavLM(wavlm_config()).state_dict()}, wavlm_ckpt)
    sections = {
        "model": {"path": "diarizen.models.eend.model_wavlm_conformer.Model"},
        "model.args": {"wavlm_src": str(wavlm_ckpt), "wavlm_layer_num": 5, "wavlm_feat_dim": 32,
                       "attention_in": 16, "ffn_hidden": 24, "num_head": 2, "num_layer": 2,
                       "kernel_size": 5, "chunk_size": 2, "max_speakers_per_chunk": 4},
        "inference.args": {"seg_duration": 2, "segmentation_step": 0.1, "batch_size": 8,
                           "apply_median_filtering": True},
        "clustering.args": {"method": "VBxClustering", "min_speakers": 1, "max_speakers": 8,
                            "ahc_criterion": "distance", "ahc_threshold": 0.6, "Fa": 0.07,
                            "Fb": 0.8, "lda_dim": 128, "max_iters": 20},
        "weights": {"seed": WEIGHTS_SEED, "classifier_scale": 10.0},
        "architecture.wavlm": WAVLM, "architecture.eend": EEND, "architecture.resnet": RESNET,
    }
    setup = write_setup_dir(root / "model", "large-s80-md", WEIGHTS_SEED)
    (setup / "config.toml").write_text(toml(sections))
    cfg = tomllib.loads((setup / "config.toml").read_text())
    pipe = pipelines.from_pretrained(setup, device="cpu")
    # float32 segmentation: the reference's precision, for its tolerances
    pipe.seg_inference.compute_dtype = torch.float32
    weights = make_weights(cfg, 0, "cpu")
    pipe.seg_inference.model.load_state_dict(weights["segmentation"], strict=True)
    pipe.emb_inference.model.load_state_dict(weights["embedding"], strict=True)
    rng, gen = np.random.default_rng(5), torch.Generator().manual_seed(5)
    waves = [synthesize(s, n, TRAFFIC, rng, gen, "cpu") for s, n in ((6.3, 3), (4.1, 2))]
    outputs = Outputs()
    served = []
    for wave, _ in zip(waves, pipe.stream(iter(waves), 16000, hook=outputs)):
        served.append((wave, outputs.take()))
    return cfg, weights, setup, served, pipe


def test_toy_large_is_the_configured_model(served):
    _, _, _, _, pipe = served
    model = pipe.seg_inference.model
    assert model.cfg.wavlm == wavlm_config()
    assert model.cfg.wavlm_layer_num == 5
    assert model.inference_stages == ("extract", "encode", "back_end")


def test_scores_match_the_reference(served):
    cfg, weights, _, _, pipe = served
    arch = cfg["architecture"]
    waves = 0.1 * torch.randn(3, 32000, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = pipe.seg_inference.model(waves, torch.float32)
    got = Segmentation(arch, weights["segmentation"])(waves)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 1e-4


def test_served_outputs_match_the_reference(served):
    """The benchmark's comparison of each streamed file: the binary
    segmentation against the reference's from the waveform, the counts,
    the embeddings and VBx's clusters."""
    cfg, weights, setup, files, _ = served
    layout = Layout(cfg)
    first = files[0][1]  # speech of one and of two speakers, embedded and clustered
    assert set(np.unique(first["binary"].sum(axis=2))) == {0, 1, 2} and first["count"].max() == 2
    assert first["embeddings"].shape == (len(first["binary"]), 4, 256)
    assert len(first["clusters"]) == len(first["binary"])
    for wave, outputs in files:  # the second: the little speech the median filter keeps
        assert outputs["binary"].shape == (len(layout.starts(len(wave))), layout.frames, 4)
        numbers = judge_file(layout, cfg, weights, wave, outputs, str(setup / "plda"), "cpu")
        assert numbers["seg_flip_share"] == 0.0
        assert numbers["count_mismatch_share"] == 0.0
        assert numbers["emb_rel_err"] < 1e-4
        assert numbers["cluster_mismatch_share"] == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stages_compose_to_the_forward(dtype):
    """The three stages that the serving path replays as graphs and times
    apart give exactly the one-piece forward."""
    model = EendModel(EendConfig(
        wavlm=wavlm_config(), conformer=ConformerConfig(dim=16, ffn_hidden=24, num_heads=2,
                                                        num_layers=2, kernel_size=5),
        wavlm_layer_num=5, wavlm_feat_dim=32, attention_in=16)).eval()
    waves = 0.1 * torch.randn(2, 1, 16000, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = model(waves, compute_dtype=dtype)
        x = waves
        for stage in model.inference_stages:
            x = model(x, compute_dtype=dtype, stage=stage)
    assert x.dtype == want.dtype == torch.float32
    assert torch.equal(x, want)


@pytest.mark.parametrize("name, preset", [("base-s80-md", WavLMConfig.base_s80_md),
                                          ("large-s80-md", WavLMConfig.large_s80_md)])
def test_benchmark_configs_spell_out_the_presets(name, preset):
    """A configuration's [architecture], which the plain reference reads,
    is the port's preset of its `wavlm_src`, and its [model.args] the
    reference's EEND shapes."""
    cfg = core.load_config(name)
    arch, args = cfg["architecture"], cfg["model"]["args"]
    want = preset()
    assert WavLMConfig.from_preset(args["wavlm_src"]) == want
    got = WavLMConfig(**{k: (tuple(map(tuple, v)) if k in ("conv_layers", "remaining_heads")
                             else tuple(v) if isinstance(v, list) else v)
                         for k, v in arch["wavlm"].items()},
                      layer_drop=want.layer_drop)
    assert got == want
    eend = arch["eend"]
    assert (eend["wavlm_layer_num"], eend["wavlm_feat_dim"]) == (
        args["wavlm_layer_num"], args["wavlm_feat_dim"]) == (want.num_layers + 1, want.embed_dim)
    assert (eend["attention_in"], eend["conformer_ffn_hidden"], eend["conformer_heads"],
            eend["conformer_layers"], eend["max_speakers_per_chunk"]) == (
        args["attention_in"], args["ffn_hidden"], args["num_head"], args["num_layer"],
        args["max_speakers_per_chunk"])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
