"""DiariZen's multi-channel model on the port's serving path, against the
benchmark's plain reference (`portbench/reference/mc.py`), on the CPU at a
toy size: 3 microphones, 2 cross-channel fusions, a post-LN WavLM with
uneven kept heads. The pipeline is built by `pipelines.from_pretrained` from
a set-up directory as the benchmark writes one, with the benchmark's seeded
weights, and its streamed outputs are held to the reference: scores and
channel weights within 1e-4, binary segmentation, counts and clusters
exact, fused embeddings within 1e-4. Also: the four inference stages
compose to the one-piece forward exactly; the device-side channel weights
are those `attention_weighted_embeddings` reads; `stream` equals per-file
`__call__`, and both equal the former multi-channel pipeline's algorithm
(per-channel embeddings fused on the host); a single-channel model keeps its
graph key and stages. On a card (`test_card_*`, skipped without one): the
four stage graphs replay the eager forward bit for bit, and the file's stage
events are read. This file imports nothing of JAX:

    python -m pytest --noconftest -q tests/test_torch_mc_reference.py
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import median_filter

from diarizen_tpu_torch import pipelines, tracing
from diarizen_tpu_torch.cluster import AgglomerativeClustering
from diarizen_tpu_torch.core.segments import Annotation
from diarizen_tpu_torch.infer import (
    DiarizationPipeline,
    EmbeddingInference,
    SlidingInference,
    reconstruct,
    speaker_count,
)
from diarizen_tpu_torch.infer.sliding import (
    batch_row_spans,
    gather_rows,
    receptive_field_window,
    tail_size,
)
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.mc import (
    FusionConfig,
    McEendConfig,
    McEendModel,
    attention_weighted_embeddings,
)
from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig
from diarizen_tpu_torch.ops import forward_switches
from diarizen_tpu_torch.ops.binarize import Binarize
from portbench.reference.judge import Layout
from portbench.reference.mc import McSegmentation
from portbench.reference.mc_judge import judge_file
from portbench.tests.mc_toy import CHANNELS, setup_dir, toy_files, wavlm_config
from portbench.traffic.mc_files import McOutputs, make_weights

FUSIONS = 2  # fusion 3, which weighs the channels, clamped to the last of two
# the first seed whose float32 decisions on the first file hold two speakers
# each alone and two at once, each on 5% of the frames or more
WEIGHTS_SEED = 3


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(cfg, weights, setup dir, [(wave, outputs)], pipeline): three 3-channel
    files streamed through the pipeline that `from_pretrained` builds from
    the set-up directory, the benchmark's weights loaded as its run loads
    them, in float32 (the reference's precision, for its tolerances)."""
    torch.manual_seed(0)
    setup, cfg = setup_dir(tmp_path_factory.mktemp("mc-toy"), WEIGHTS_SEED, FUSIONS)
    pipe = pipelines.from_pretrained(setup, device="cpu")
    pipe.seg_inference.compute_dtype = torch.float32
    weights = make_weights(cfg, 0, "cpu")
    pipe.seg_inference.model.load_state_dict(weights["segmentation"], strict=True)
    pipe.emb_inference.model.load_state_dict(weights["embedding"], strict=True)
    waves = toy_files()
    outputs = McOutputs()
    files = []
    for wave, ann in zip(waves, pipe.stream(iter(waves), 16000, hook=outputs)):
        files.append((wave, outputs.take(), ann))
    return cfg, weights, setup, files, pipe


def test_toy_mc_is_the_configured_model(served):
    _, _, _, _, pipe = served
    model = pipe.seg_inference.model
    assert isinstance(model, McEendModel) and model.cfg.wavlm == wavlm_config()
    assert model.num_channels == pipe.seg_inference.num_channels == CHANNELS
    assert model.inference_stages == ("extract", "fuse", "encode", "back_end")
    assert pipe.embedding_exclude_overlap is False  # the recipe's plain masks


def test_scores_and_channel_weights_match_the_reference(served):
    cfg, weights, _, _, pipe = served
    waves = 0.1 * torch.randn(3, CHANNELS, 32000, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        got_scores, got_weights = staged(pipe.seg_inference.model, waves, torch.float32)
    want_scores, want_weights = McSegmentation(cfg["architecture"], weights["segmentation"])(waves)
    assert got_scores.shape == want_scores.shape and got_weights.shape == (3, CHANNELS)
    assert (got_scores - want_scores).abs().max().item() < 1e-4
    assert (got_weights - want_weights).abs().max().item() < 1e-4
    assert torch.allclose(got_weights.sum(dim=1), torch.ones(3))


def test_served_outputs_match_the_reference(served):
    """The benchmark's comparison of each streamed file: the binary
    segmentation and the channel weights against the reference's from the
    waveform, the counts, the fused embeddings and VBx's clusters."""
    cfg, weights, setup, files, _ = served
    layout = Layout(cfg)
    first = files[0][1]  # speech of one and of two speakers, embedded and clustered
    assert set(np.unique(first["binary"].sum(axis=2))) >= {1, 2} and first["count"].max() == 2
    assert first["embeddings"].shape == (len(first["binary"]), 4, 256)
    assert first["channel_weights"].shape == (len(first["binary"]), CHANNELS)
    assert len(first["clusters"]) == len(first["binary"])
    for wave, outputs, _ in files:
        assert outputs["binary"].shape == (len(layout.starts(wave.shape[1])), layout.frames, 4)
        numbers = judge_file(layout, cfg, weights, wave, outputs, str(setup / "plda"), "cpu")
        assert numbers["seg_flip_share"] == 0.0
        assert numbers["count_mismatch_share"] == 0.0
        assert numbers["chan_weight_err"] < 1e-4
        assert numbers["emb_rel_err"] < 1e-4
        assert numbers["cluster_mismatch_share"] == 0.0


def test_records_count_channels_and_rows(served):
    _, _, _, files, pipe = served
    mine = [r for r in tracing.records() if r.pipeline == pipe._trace_id]
    assert len(mine) == len(files)
    for record, (wave, _, _) in zip(mine, files):
        windows = len(pipe.seg_inference.prepare_wave(wave)[1])
        assert record.channels == CHANNELS and record.emb_rows == windows * CHANNELS
        assert record.seg_fuse_ms is None  # no stream to time off CUDA
        assert record.seg_eager_batches > 0 and record.emb_eager_batches > 0


def staged(model: McEendModel, waves: torch.Tensor, dtype: torch.dtype):
    """The model's inference stages in turn: (scores, channel weights)."""
    x = waves
    for stage in model.inference_stages:
        x = model(x, compute_dtype=dtype, stage=stage)
    return x


def toy_model() -> McEendModel:
    """The toy configuration's model, its weights moved off their initial
    values (the fusions' near-zero LayerNorm scales among them)."""
    model = McEendModel(toy_cfg()).eval()
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def toy_cfg() -> McEendConfig:
    return McEendConfig(
        wavlm=wavlm_config(), conformer=ConformerConfig(dim=16, ffn_hidden=24, num_heads=2,
                                                        num_layers=2, kernel_size=5),
        wavlm_layer_num=5, wavlm_feat_dim=32, attention_in=16,
        fusion=FusionConfig(hidden=16, num_heads=4, num_fusion_layers=FUSIONS),
        num_channels=CHANNELS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stages_compose_to_the_forward(dtype):
    """The four stages that the serving path replays as graphs and times
    apart give exactly the one-piece forward's scores, and the channel
    weights of its attention."""
    model = toy_model()
    waves = 0.1 * torch.randn(2, CHANNELS, 16000, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want, attention = model(waves, compute_dtype=dtype)
        x = waves
        for stage in model.inference_stages:
            x = model(x, compute_dtype=dtype, stage=stage)
    scores, weights = x
    assert scores.dtype == want.dtype == torch.float32
    assert torch.equal(scores, want)
    last = model.cfg.fusion.num_fusion_layers - 1  # fusion 3 clamped to the last of two
    assert torch.equal(weights, attention[:, last].contiguous().mean(dim=(1, 2)))


def test_device_channel_weights_are_attention_weighted_embeddings(served):
    """The weights reduced on the device are those that
    `attention_weighted_embeddings` reads from the whole attention, and the
    embeddings fused on the device equal that function's fusion of each
    channel's embeddings."""
    _, _, _, files, pipe = served
    seg, emb, model = pipe.seg_inference, pipe.emb_inference, pipe.seg_inference.model
    wave, starts = seg.prepare_wave(files[0][0])
    chunks = torch.stack([wave[:, s: s + seg.window_size] for s in starts[:6]])
    with torch.inference_mode():
        _, weights = staged(model, chunks, torch.float32)
        _, attention = model(chunks, compute_dtype=torch.float32)
    last = model.cfg.fusion.num_fusion_layers - 1
    np.testing.assert_allclose(weights.numpy(), attention[:, last].numpy().mean(axis=(1, 2)),
                               rtol=0, atol=1e-6)
    masks = torch.rand((6, 4, seg._frames_per_chunk), generator=torch.Generator().manual_seed(3))
    masks = (masks > 0.5).float()
    fused = emb(wave, starts[:6], masks.numpy(), channel_weights=weights.numpy())
    per_channel = np.stack([emb(wave[c], starts[:6], masks.numpy()) for c in range(CHANNELS)],
                           axis=1)
    want = attention_weighted_embeddings(per_channel, attention.numpy(), last)
    np.testing.assert_allclose(fused, want, rtol=1e-5, atol=1e-5)


def former_mc_pipeline(pipe, wave: np.ndarray) -> Annotation:
    """The multi-channel pipeline as it ran before the serving path took it
    over: the segmentation and the whole spatial attention fetched, the
    median filter and the count on the host, the embeddings of each channel
    in a host loop, fused on the host by `attention_weighted_embeddings`."""
    seg, emb, model = pipe.seg_inference, pipe.emb_inference, pipe.seg_inference.model
    dev, starts = seg.prepare_wave(wave)
    chunks = torch.stack([dev[:, s: s + seg.window_size] for s in starts])
    with torch.inference_mode():
        scores, attention = model(chunks, compute_dtype=seg.compute_dtype)
    binarized = seg.to_feature(seg.powerset.to_multilabel(scores).numpy().astype(np.float32))
    binarized.data = median_filter(binarized.data, size=(1, 11, 1), mode="reflect")
    count = speaker_count(binarized, receptive_field_window(pipe.eend_cfg), warm_up=(0.0, 0.0))
    masks = np.transpose(binarized.data, (0, 2, 1))
    per_channel = np.stack([emb(dev[c], starts, masks) for c in range(dev.shape[0])], axis=1)
    last = min(3, model.cfg.fusion.num_fusion_layers - 1)
    embeddings = attention_weighted_embeddings(per_channel, attention.numpy(), last)
    hard, _, _ = pipe.clustering(embeddings, binarized.data, min_clusters=pipe.min_speakers,
                                 max_clusters=pipe.max_speakers)
    count.data = np.minimum(count.data, pipe.max_speakers).astype(np.int8)
    hard[np.sum(binarized.data, axis=1) == 0] = -2
    result = Binarize(onset=0.5, offset=0.5)(reconstruct(binarized, hard, count))
    return result.rename_labels(
        {label: f"SPEAKER_{i:02d}" for i, label in enumerate(result.labels())})


def test_stream_equals_call_and_the_former_pipeline(served):
    _, _, _, files, pipe = served
    for wave, _, streamed in files:
        called = pipe(wave, 16000)
        assert streamed.to_rttm() == called.to_rttm()
        assert called.to_rttm() == former_mc_pipeline(pipe, wave).to_rttm()
    assert len(files[0][2].labels()) >= 2


def test_a_recording_is_fitted_to_the_models_channels(served):
    _, _, _, files, pipe = served
    seg = pipe.seg_inference
    wave = files[2][0]
    fewer, _ = seg.prepare_wave(wave[:2])  # wrapped around
    more, _ = seg.prepare_wave(np.concatenate([wave, wave[:1]]))  # cut
    assert torch.equal(fewer[2], fewer[0]) and torch.equal(more, seg.prepare_wave(wave)[0])


def test_single_channel_graph_key_and_stages_are_unchanged(monkeypatch):
    """A single-channel model's batches keep the key (soft, type, switches,
    rows) and the three stages, with channel 0 alone served."""
    model = EendModel(EendConfig(
        wavlm=wavlm_config(), conformer=ConformerConfig(dim=16, ffn_hidden=24, num_heads=2,
                                                        num_layers=2, kernel_size=5),
        wavlm_layer_num=5, wavlm_feat_dim=32, attention_in=16)).eval()
    seg = SlidingInference(model, batch_size=8, compute_dtype=torch.float32, device="cpu")
    assert seg.num_channels is None and len(seg._stages(False)) == 3
    wave, _ = seg.prepare_wave(np.zeros((2, 40000), np.float32))
    assert wave.dim() == 1
    monkeypatch.setattr(type(seg), "_graphs_apply", lambda self, x: True)
    assert seg._graph_key(wave, False, torch.float32) == (False, torch.float32) + \
        forward_switches()


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_stage_graphs_replay_the_eager_forward(card, dtype):
    """Each batch shape's four stage graphs give the eager stages' outputs
    bit for bit (the multilabel and the channel weights), and a file's
    stage events give its extractor, encoder and fused-channel stream
    milliseconds."""
    model = toy_model()
    seg = SlidingInference(model, duration=2.0, batch_size=8, compute_dtype=dtype, device=card)
    for seconds in (4.5, 5.3):  # 14 and 18 windows: tails of 8 rows, full batches
        wave, starts = seg.prepare_wave(toy_files()[0][:, : int(seconds * 16000)])
        want, want_w = None, None
        with torch.inference_mode():
            starts_dev = torch.as_tensor(starts, device=card)
            want = torch.zeros((len(starts), seg._frames_per_chunk, 4), dtype=torch.uint8,
                               device=card)
            want_w = torch.zeros((len(starts), CHANNELS), device=card)
            for off, blen, pad in batch_row_spans(len(starts), 8, lambda n: tail_size(n, 8)):
                chunks = gather_rows(wave.t(), starts_dev[off: off + blen], seg.window_size,
                                     pad).transpose(1, 2)
                ml, w = seg._forward(chunks, False)
                want[off: off + blen], want_w[off: off + blen] = ml[:blen], w[:blen]
        for _ in range(2):  # eager and captured, then replayed
            got, got_w = seg.dispatch(wave, starts)
            assert torch.equal(got, want) and torch.equal(got_w, want_w)
    assert {k[-1] for k in seg._graphs} == {8}
    pipe = DiarizationPipeline(
        seg, EmbeddingInference(ResNet(ResNetConfig(m_channels=8, num_blocks=(1, 1, 1, 1))),
                                seg.window_size, 4, batch_size=8, device=card),
        AgglomerativeClustering(threshold=0.7, min_cluster_size=2), model.cfg,
        embedding_exclude_overlap=False)
    list(pipe.stream(toy_files()[:2]))
    record = tracing.records()[-1]
    assert record.channels == CHANNELS and record.seg_fuse_ms is not None
    assert 0 < record.seg_fuse_ms <= record.seg_encode_ms
    assert record.seg_extract_ms > 0 and record.seg_eager_batches == 0
