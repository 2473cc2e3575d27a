"""The plain reference against the port's own plain (CPU) paths at a tiny
size: the same weights give the same scores, embeddings, counts, weights and
clusters. The reference imports nothing of the port; this test imports both."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from portbench.reference import judge
from portbench.reference.clustering import vbx_clusters
from portbench.reference.embedding import Embedding
from portbench.reference.segmentation import Segmentation
from portbench.traffic.files import write_setup_dir
from portbench.weights import make_weights

WAVLM = {"extractor_mode": "group_norm", "conv_layers": [[16, 10, 5], [16, 3, 2], [16, 2, 2]],
         "conv_bias": False, "embed_dim": 32, "pos_conv_kernel": 8, "pos_conv_groups": 4,
         "num_layers": 3, "use_attention": [True, False, True], "use_feed_forward": [True] * 3,
         "total_num_heads": [4, 4, 4], "remaining_heads": [[1, 3], [], [0, 2, 3]],
         "num_buckets": 32, "max_distance": 64, "ff_interm_features": [24, 8, 40],
         "layer_norm_first": False, "normalize_waveform": False}
EEND = {"wavlm_layer_num": 4, "wavlm_feat_dim": 32, "attention_in": 16,
        "conformer_ffn_hidden": 24, "conformer_heads": 2, "conformer_layers": 2,
        "conformer_kernel": 5, "max_speakers_per_chunk": 4, "max_speakers_per_frame": 2,
        "sample_rate": 16000}
RESNET = {"m_channels": 4, "num_blocks": [1, 2, 1, 1], "feat_dim": 80, "embed_dim": 16}
CFG = {"architecture": {"wavlm": WAVLM, "eend": EEND, "resnet": RESNET},
       "weights": {"classifier_scale": 10.0}}


def port_models(variant=None):
    from diarizen_tpu_torch.models.conformer import ConformerConfig
    from diarizen_tpu_torch.models.eend import EendConfig, EendModel
    from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig
    from diarizen_tpu_torch.models.wavlm import WavLMConfig

    w = {k: v for k, v in WAVLM.items()}
    wavlm = dataclasses.replace(
        WavLMConfig.base(), embed_dim=32, conv_layers=tuple(map(tuple, w["conv_layers"])),
        pos_conv_kernel=8, pos_conv_groups=4, num_layers=3,
        use_attention=tuple(w["use_attention"]), use_feed_forward=(True,) * 3,
        total_num_heads=(4,) * 3, remaining_heads=tuple(map(tuple, w["remaining_heads"])),
        num_buckets=32, max_distance=64, ff_interm_features=tuple(w["ff_interm_features"]),
        **(variant or {}))
    cfg = EendConfig(wavlm=wavlm, conformer=ConformerConfig(dim=16, ffn_hidden=24, num_heads=2,
                                                            num_layers=2, kernel_size=5),
                     wavlm_layer_num=4, wavlm_feat_dim=32, attention_in=16)
    resnet = ResNet(ResNetConfig(m_channels=4, num_blocks=(1, 2, 1, 1), embed_dim=16))
    return EendModel(cfg).eval(), resnet.eval()


@pytest.fixture(scope="module")
def weights():
    return make_weights(CFG, 2**31 + 3, "cpu")


PRE_LN = {"extractor_mode": "layer_norm", "layer_norm_first": True, "normalize_waveform": True}


@pytest.mark.parametrize("variant", [{}, PRE_LN], ids=["post_ln", "pre_ln"])
def test_segmentation_scores(variant):
    arch = {**CFG["architecture"], "wavlm": {**WAVLM, **variant}}
    weights = make_weights({**CFG, "architecture": arch}, 2**31 + 3, "cpu")
    model, _ = port_models(variant)
    model.load_state_dict(weights["segmentation"], strict=True)
    waves = 0.1 * torch.randn(3, 8000, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(waves, torch.float32)
    got = Segmentation(arch, weights["segmentation"])(waves)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 1e-4


def test_embeddings(weights):
    from diarizen_tpu_torch.models.fbank import kaldi_fbank

    _, resnet = port_models()
    resnet.load_state_dict(weights["embedding"], strict=True)
    gen = torch.Generator().manual_seed(1)
    windows = 0.1 * torch.randn(2, 16000, generator=gen)
    frame_weights = (torch.rand(2, 3, 49, generator=gen) > 0.4).float()
    feats = kaldi_fbank(windows * 32768.0)
    with torch.no_grad():
        want = resnet(feats - feats.mean(dim=1, keepdim=True), frame_weights)
    got = Embedding(CFG["architecture"], weights["embedding"])(windows, frame_weights)
    assert (got - want).abs().max().item() < 1e-4 * max(1.0, want.abs().max().item())


def test_count_and_weights_match_the_port():
    from diarizen_tpu_torch.core.segments import SlidingWindow, SlidingWindowFeature
    from diarizen_tpu_torch.infer.fused import make_fused_stitch
    from diarizen_tpu_torch.infer.pipeline import speaker_count
    from diarizen_tpu_torch.infer.sliding import receptive_field_window
    from diarizen_tpu_torch.models.conformer import ConformerConfig
    from diarizen_tpu_torch.models.eend import EendConfig
    from diarizen_tpu_torch.models.wavlm import WavLMConfig

    cfg = {"architecture": {"wavlm": {"conv_layers": [list(c) for c in
                                                      WavLMConfig.base().conv_layers]},
                            "eend": EEND},
           "inference": {"args": {"seg_duration": 8, "segmentation_step": 0.1}}}
    layout = judge.Layout(cfg)
    rng = np.random.default_rng(0)
    binary = (rng.uniform(size=(23, layout.frames, 4)) > 0.7).astype(np.uint8)
    eend = EendConfig(wavlm=WavLMConfig.base(), conformer=ConformerConfig())
    want = speaker_count(SlidingWindowFeature(binary.astype(np.float32),
                                              SlidingWindow(start=0.0, duration=8.0, step=0.8)),
                         receptive_field_window(eend), warm_up=(0.0, 0.0)).data.reshape(-1)
    assert np.array_equal(layout.count(binary), want)
    stitch = make_fused_stitch(eend, 128000, 8.0, 0.8, 4, 400, apply_median_filtering=False)
    _, counts, weights = stitch.stitch(torch.from_numpy(binary), stitch.plan(23))
    assert np.array_equal(layout.count(binary), counts.numpy())
    assert np.array_equal(layout.weights(binary), weights.numpy())
    assert layout.min_clean == math.ceil(layout.frames * 400 / layout.window)


def test_clusters_match_the_port(tmp_path):
    from diarizen_tpu_torch.cluster import VBxClustering

    plda = str(write_setup_dir(tmp_path / "model", "base-s80-md", 7) / "plda")
    rng = np.random.default_rng(1)
    centres = rng.standard_normal((3, 256))
    labels = rng.integers(0, 3, size=(40, 4))
    emb = centres[labels] + 0.3 * rng.standard_normal((40, 4, 256))
    binary = (rng.uniform(size=(40, 50, 4)) > 0.5).astype(np.float64)
    args = {"ahc_criterion": "distance", "ahc_threshold": 0.6, "Fa": 0.07, "Fb": 0.8,
            "lda_dim": 128, "max_iters": 20}
    port = VBxClustering(plda_dir=plda, ahc_criterion="distance", ahc_threshold=0.6, fa=0.07,
                         fb=0.8, lda_dim=128, max_iters=20)
    want, _, _ = port(emb, binary, min_clusters=1, max_clusters=8)
    assert np.array_equal(vbx_clusters(emb, binary, plda, args), want)
