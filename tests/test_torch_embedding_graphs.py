"""The speaker embeddings' CUDA-graph batches (`EmbeddingInference` in
`diarizen_tpu_torch/infer/pipeline.py`, on `GraphedBatches` of
`infer/sliding.py`).

On the CPU: every batch runs eagerly and a file's record counts it, on the
device-stitch and the host route; the batch shapes are a bounded set; an
out-of-memory error drops the graphs; the weights' stamp sees the ResNet
change. On a card (the tests named `test_card_*` skip without one): replay
against the eager forward bit for bit at every row count, on both fbank
routes and both compute types, graphs reused across files and captured again
after the weights change, a BatchNorm statistic changed in place refolds and
recaptures, the fused convolutions (`models/resnet.py`) against their plain
versions and counted 36 a batch on replays, and `stream` with the graphs on
against per-file calls. This file imports nothing of JAX, so on the machine with the card it
runs without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_embedding_graphs.py
"""

import numpy as np
import pytest
import torch

from diarizen_tpu_torch import tracing
from diarizen_tpu_torch.cluster import AgglomerativeClustering
from diarizen_tpu_torch.infer import DiarizationPipeline, EmbeddingInference, SlidingInference
from diarizen_tpu_torch.infer.sliding import batch_row_spans, gather_rows, state_stamp, tail_size
from diarizen_tpu_torch.models.convert import random_state_dict
from diarizen_tpu_torch.models.fbank import FRAME_SHIFT, kaldi_fbank
from diarizen_tpu_torch.models import resnet as resnet_module
from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig
from diarizen_tpu_torch.ops import cuda_build, resnet_stem
from test_torch_sliding_graphs import LAST_ROWS, make_wave, num_batches, seconds_for, tiny_eend

SR = 16000
WINDOW = 8 * SR  # 8 s windows at a 0.8 s hop, as the served models'
HOP = WINDOW // 10
SPEAKERS = 4


def tiny_resnet() -> ResNet:
    resnet = ResNet(ResNetConfig(m_channels=8, num_blocks=(1, 1, 1, 1), embed_dim=32))
    resnet.load_state_dict(random_state_dict(resnet, 1))
    return resnet.eval()


def resnet34() -> ResNet:
    """WeSpeaker's ResNet34 at its widths, seeded."""
    resnet = ResNet(ResNetConfig())
    resnet.load_state_dict(random_state_dict(resnet, 3))
    return resnet.eval()


def file_inputs(windows: int, frames: int, device, seed: int = 0) -> tuple:
    """(device waveform, window starts, (windows, S, frames) 0/1 weights on
    the device as the device stitch gives them) of a file of `windows`
    8 s windows."""
    starts = np.arange(windows, dtype=np.int64) * HOP
    samples = np.zeros(starts[-1] + WINDOW, np.float32)  # every window in bounds
    audio = make_wave(seconds_for(windows), seed)[0][: len(samples)]
    samples[: len(audio)] = audio
    wave = torch.as_tensor(samples, device=device)
    gen = torch.Generator().manual_seed(seed)
    weights = (torch.rand((windows, SPEAKERS, frames), generator=gen) < 0.4).to(torch.uint8)
    return wave, starts, weights.to(device)


def eager(emb: EmbeddingInference, wave: torch.Tensor, starts: np.ndarray,
          weights: torch.Tensor) -> torch.Tensor:
    """The embeddings of every window through the model's forward, batch by
    batch as `dispatch` cuts them, with no graph."""
    shared = emb.shared_fbank and not (starts % FRAME_SHIFT).any()
    if shared:
        source, length = kaldi_fbank(wave[None] * 32768.0)[0], emb._frames_per_window
        starts = starts // FRAME_SHIFT
    else:
        source, length = wave, emb.window_size
    starts_dev = torch.as_tensor(starts, device=wave.device)
    out = torch.zeros((len(starts), emb.num_speakers, emb.embed_dim), device=wave.device)
    with torch.inference_mode():
        for off, blen, pad in batch_row_spans(len(starts), emb.batch_size,
                                              lambda n: tail_size(n, emb.batch_size)):
            windows = gather_rows(source, starts_dev[off: off + blen], length, pad)
            wb = weights[off: off + blen].float()
            if pad:
                wb = torch.cat([wb, wb.new_zeros((pad,) + tuple(wb.shape[1:]))])
            out[off: off + blen] = emb._forward(shared, windows, wb)[:blen]
    return out


def counted(emb: EmbeddingInference, wave, starts, weights) -> tuple:
    """(dispatch's output, the file record it counted on)."""
    record = tracing.FileRecord(-1, 0, 0.0)
    with tracing.span("diarize.embed", record):
        out = emb.dispatch(wave, starts, weights)
    return out, record


# ---------------------------------------------------------------------------
# on the CPU


@pytest.mark.parametrize("batch_size", [8, 16, 24, 32])
def test_batch_rows_are_a_bounded_set(batch_size):
    """`dispatch` cuts every file into batches of a multiple of 8 rows up
    to `batch_size`, so an instance holds at most batch_size / 8 graphs of
    a key, and the batches cover every window."""
    emb = EmbeddingInference(tiny_resnet(), WINDOW, SPEAKERS, batch_size=batch_size,
                             device="cpu")
    rows = set()

    def run_batch(key, stages, inputs, events=tracing.NO_EVENTS):
        """Each row's embedding: its window's first fbank value."""
        windows, weights = inputs
        rows.add(len(windows))
        assert len(weights) == len(windows)
        return windows[:, 0, 0, None, None].expand(-1, SPEAKERS, emb.embed_dim), False

    emb._run_batch = run_batch
    wave, _, _ = file_inputs(120, 10, "cpu")
    fbank = kaldi_fbank(wave[None] * 32768.0)[0]
    for total in range(1, 121):
        starts = np.arange(total, dtype=np.int64) * HOP
        out = emb.dispatch(wave, starts, np.ones((total, SPEAKERS, 10), np.float32))
        want = fbank[torch.as_tensor(starts // FRAME_SHIFT), 0]
        assert torch.equal(out[:, 0, 0], want), total  # every window, in its place
    assert rows == set(range(8, batch_size + 1, 8))


@pytest.mark.parametrize("fused", [True, False])
def test_cpu_runs_every_embedding_batch_eagerly(fused):
    """Off CUDA no graph is captured; a streamed file's record counts every
    embedding batch as eager, on the device-stitch route and on the host
    route."""
    seg = SlidingInference(tiny_eend(), batch_size=8, compute_dtype=torch.float32, device="cpu")
    emb = EmbeddingInference(tiny_resnet(), seg.window_size, num_speakers=4, batch_size=8,
                             device="cpu")
    pipe = DiarizationPipeline(seg, emb, AgglomerativeClustering(), seg.cfg, max_speakers=4,
                               fused_stitch=fused)
    waves = [make_wave(12.5), make_wave(9.2, seed=1), make_wave(30.3, seed=2)]
    assert len(list(pipe.stream(iter(waves), SR))) == 3
    records = [r for r in tracing.records() if r.pipeline == pipe._trace_id]
    assert len(records) == 3
    for r, w in zip(records, waves):
        total = len(seg.prepare_wave(w)[1])
        assert r.emb_graph_batches == 0
        assert r.emb_eager_batches == num_batches(total, emb.batch_size) > 0
    assert not emb._graphs and emb._graph_pool is None and emb._graph_stamp is None


def test_cpu_dispatch_matches_the_eager_forward():
    """Both fbank routes give, batch by batch, what the eager forward gives."""
    for shared in (True, False):
        emb = EmbeddingInference(tiny_resnet(), WINDOW, SPEAKERS, batch_size=8, device="cpu",
                                 shared_fbank=shared)
        wave, starts, weights = file_inputs(13, 50, "cpu")
        out, record = counted(emb, wave, starts, weights)
        assert record.emb_eager_batches == 2 and record.emb_graph_batches == 0
        assert torch.equal(out, eager(emb, wave, starts, weights)), shared


class FailingResNet(torch.nn.Module):
    """The ResNet, raising a device out-of-memory error on its first call."""

    def __init__(self, inner: ResNet):
        super().__init__()
        self.inner, self.cfg, self.calls = inner, inner.cfg, 0

    def forward(self, *args):
        self.calls += 1
        if self.calls == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return self.inner(*args)


def test_halving_the_batch_drops_the_graphs():
    resnet = tiny_resnet()
    emb = EmbeddingInference(FailingResNet(resnet), WINDOW, SPEAKERS, batch_size=16,
                             device="cpu")
    emb._graphs[(True, torch.float32, 16)] = object()
    emb._graph_pool = object()
    wave, starts, weights = file_inputs(21, 50, "cpu")
    got = emb(wave, starts, weights)  # the OOM, then the file again at batch 8
    assert emb.batch_size == 8 and not emb._graphs and emb._graph_pool is None
    ref = EmbeddingInference(resnet, WINDOW, SPEAKERS, batch_size=8, device="cpu")
    np.testing.assert_array_equal(got, ref(wave, starts, weights))
    emb._graphs[(True, torch.float32, 8)] = object()
    with pytest.raises(KeyError):
        emb.halve_batch(KeyError("not an OOM"))
    assert emb.batch_size == 8 and emb._graphs


def test_state_stamp_sees_every_change_of_the_resnet():
    model = tiny_resnet()
    stamp = state_stamp(model)
    assert len(stamp) == len(list(model.parameters()) + list(model.buffers()))
    conv, bn = model.layer1[0].conv1, model.layer2[0].bn2
    changes = (lambda: conv.weight.mul_(2.0),  # a weight in place
               lambda: bn.running_var.add_(1.0),  # a BatchNorm statistic in place
               lambda: setattr(model.seg_1.weight, "data", model.seg_1.weight.data.clone()),
               lambda: model.load_state_dict(random_state_dict(model, 9)))
    for change in changes:
        with torch.no_grad():
            change()
        assert state_stamp(model) != stamp
        stamp = state_stamp(model)


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_resnet(card):
    return resnet34().to(card)


FRAMES = 399  # the served segmentation's frames a window


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [True, False])
def test_card_graphs_match_the_eager_forward(card, card_resnet, shared, compute_dtype):
    """At 8, 16, 24 and 32 rows, on the shared and the per-window fbank
    route, in float32 (TF32 convolutions) and bfloat16: a new shape's first
    batch runs eagerly and is captured, every later one replays, and both
    give the eager forward's embeddings bit for bit."""
    emb = EmbeddingInference(card_resnet, WINDOW, SPEAKERS, batch_size=32,
                             compute_dtype=compute_dtype, device=card, shared_fbank=shared)
    seen = set()
    for windows, rows in LAST_ROWS.items():
        wave, starts, weights = file_inputs(windows, FRAMES, card, seed=windows)
        shapes = {blen + pad for _, blen, pad in batch_row_spans(
            windows, 32, lambda n: tail_size(n, 32))}
        want = eager(emb, wave, starts, weights)
        first, rec1 = counted(emb, wave, starts, weights)
        again, rec2 = counted(emb, wave, starts, weights)
        assert rec1.emb_eager_batches == len(shapes - seen) and rec2.emb_eager_batches == 0
        seen |= shapes
        assert rec2.emb_graph_batches == num_batches(windows, 32)
        assert any(k[-1] == rows and k[0] == shared for k in emb._graphs)
        assert first.dtype == torch.float32
        assert torch.equal(first, want) and torch.equal(again, want), (windows, shared)
    assert sorted(k[-1] for k in emb._graphs) == [8, 16, 24, 32]


def test_card_graphs_are_reused_and_recaptured(card):
    emb = EmbeddingInference(resnet34(), WINDOW, SPEAKERS, batch_size=32, device=card)
    for windows in LAST_ROWS:
        counted(emb, *file_inputs(windows, FRAMES, card))
    graphs = dict(emb._graphs)
    assert len(graphs) == 4
    # another file, another length: replays only, no new capture
    wave, starts, weights = file_inputs(113, FRAMES, card, seed=3)
    out, record = counted(emb, wave, starts, weights)
    assert record.emb_eager_batches == 0 and record.emb_graph_batches == num_batches(113, 32)
    assert emb._graphs == graphs
    assert torch.equal(out, eager(emb, wave, starts, weights))
    # a weight changed in place, a BatchNorm statistic, one given new
    # storage: captured afresh, no stale replay
    model = emb.model
    for change in (lambda: model.layer1[0].conv1.weight.mul_(-1.0),
                   lambda: model.layer3[1].bn1.running_mean.add_(0.5),
                   lambda: setattr(model.seg_1.weight, "data", model.seg_1.weight.data * 2)):
        with torch.no_grad():
            change()
        before = dict(emb._graphs)
        want = eager(emb, wave, starts, weights)
        out, record = counted(emb, wave, starts, weights)
        assert record.emb_eager_batches >= 1
        assert all(g is not before.get(k) for k, g in emb._graphs.items())
        assert torch.equal(out, want)
        out, record = counted(emb, wave, starts, weights)
        assert record.emb_eager_batches == 0 and torch.equal(out, want)


def test_card_statistic_change_refolds_and_recaptures(card):
    """A BatchNorm statistic changed in place: the graphs drop, the next
    file's first batch of each shape runs eagerly and folds once more, the
    graphs are captured again from the new folds, and the embeddings are the
    eager forward's with the new statistics."""
    emb = EmbeddingInference(resnet34(), WINDOW, SPEAKERS, batch_size=32, device=card)
    wave, starts, weights = file_inputs(45, FRAMES, card, seed=4)  # one batch of 32, one of 16
    counted(emb, wave, starts, weights)
    old, record = counted(emb, wave, starts, weights)
    assert record.emb_eager_batches == 0
    folds = cuda_build.launches["resnet_fold"]
    with torch.no_grad():
        emb.model.layer2[1].bn2.running_var.mul_(4.0)
    want = eager(emb, wave, starts, weights)
    assert cuda_build.launches["resnet_fold"] == folds + 1
    out, record = counted(emb, wave, starts, weights)
    assert record.emb_eager_batches == 2 and cuda_build.launches["resnet_fold"] == folds + 1
    assert torch.equal(out, want) and not torch.equal(out, old)
    out, record = counted(emb, wave, starts, weights)
    assert record.emb_eager_batches == 0 and record.emb_graph_batches == 2
    assert torch.equal(out, want) and cuda_build.launches["resnet_fold"] == folds + 1


def test_card_replays_count_36_fused_convolutions_a_batch(card):
    """Every batch of a file, replayed, counts the ResNet34's 36
    convolutions (the stem's kernel and 35 fused cuDNN calls) in the launch
    registry, and no fold."""
    emb = EmbeddingInference(resnet34(), WINDOW, SPEAKERS, batch_size=32, device=card)
    wave, starts, weights = file_inputs(77, FRAMES, card, seed=8)
    counted(emb, wave, starts, weights)  # captures
    cuda_build.reset_launches()
    _, record = counted(emb, wave, starts, weights)
    batches = num_batches(77, 32)
    assert record.emb_graph_batches == batches and record.emb_eager_batches == 0
    assert cuda_build.launches["resnet_stem"] == batches
    assert cuda_build.launches["resnet_conv"] == 35 * batches
    assert cuda_build.launch_totals()["resnet_conv"] == 36 * batches
    assert cuda_build.launches["resnet_fold"] == 0


def test_card_fused_path_matches_the_plain_version(card, card_resnet, monkeypatch):
    """The ResNet34 at 32 rows x 8 s through the stem's kernel and cuDNN's
    fused convolutions, against the same folds through the plain versions
    on the card (`stem_conv_reference`, `folded_conv_reference`). Both round
    the trunk's convolutions to TF32 (cuDNN's default), in other kernels and
    other orders of summation: each can move a window's embedding by about
    TF32's rounding of 2^-11 (4.9e-4) of its norm, the size of the
    program's own error against the float32 reference (`emb_rel_err`
    7.5e-4-8.5e-4), so the two may differ by 1e-3 of the norm and no more.
    The stem alone, in float32 without TF32 on either side, agrees within
    float32 rounding; in bfloat16 within one rounding of the output."""
    gen = torch.Generator().manual_seed(0)
    fbank = torch.randn((32, 798, 80), generator=gen).to(card)
    fbank = fbank - fbank.mean(dim=1, keepdim=True)
    weights = (torch.rand((32, SPEAKERS, 100), generator=gen) < 0.4).float().to(card)
    with torch.inference_mode():
        fused = card_resnet(fbank, weights)
        monkeypatch.setattr(resnet_module, "stem_conv", resnet_stem.stem_conv_reference)
        monkeypatch.setattr(resnet_module, "folded_conv", resnet_module.folded_conv_reference)
        plain = card_resnet(fbank, weights)
        monkeypatch.undo()
        err = ((fused - plain).norm(dim=-1) / plain.norm(dim=-1)).max().item()
        assert err <= 1e-3, err
        stem = card_resnet.folded(torch.float32)[0]
        for dtype, limit in ((torch.float32, 1e-6), (torch.bfloat16, 2.0**-8)):
            folded = card_resnet.folded(dtype)[0] if dtype != torch.float32 else stem
            x = fbank.to(dtype)
            saved = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                want = resnet_stem.stem_conv_reference(x, folded.weight, folded.bias).float()
            finally:
                torch.backends.cudnn.allow_tf32 = saved
            got = resnet_stem.stem_conv(x, folded.weight, folded.bias)
            assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
            worst = (got.float() - want).abs().max().item() / want.abs().max().item()
            assert worst <= limit, (dtype, worst)


def test_card_stream_matches_per_file_calls(card):
    """Three files of different lengths through `stream` with both models'
    graphs on: the Annotations of per-file calls, and after one warm file
    of each batch shape no embedding batch runs eagerly."""
    seg = SlidingInference(tiny_eend(), batch_size=32, compute_dtype=torch.bfloat16, device=card)
    emb = EmbeddingInference(resnet34(), seg.window_size, num_speakers=4, batch_size=32,
                             device=card)
    pipe = DiarizationPipeline(seg, emb, AgglomerativeClustering(), seg.cfg, max_speakers=4)
    warm = [make_wave(seconds_for(w), seed=w) for w in LAST_ROWS]
    assert len(list(pipe.stream(iter(warm), SR))) == len(warm)
    waves = [make_wave(61.3, seed=5), make_wave(150.7, seed=6), make_wave(97.3, seed=7)]
    streamed = list(pipe.stream(iter(waves), SR))
    records = [r for r in tracing.records() if r.pipeline == pipe._trace_id][-3:]
    for r, w in zip(records, waves):
        total = len(seg.prepare_wave(w)[1])
        assert r.emb_eager_batches == 0 and r.seg_eager_batches == 0
        assert r.emb_graph_batches == num_batches(total, 32)
    assert [a.to_rttm() for a in streamed] == [pipe(w, SR).to_rttm() for w in waves]
