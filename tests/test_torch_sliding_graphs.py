"""The segmentation's CUDA-graph batches (`diarizen_tpu_torch/infer/sliding.py`).

On the CPU: the batch shapes are a bounded set, the graph path never
engages, a file's record counts every batch, every process switch a forward
reads is in both inference classes' graph key, and a capture's launch counts
move to its replays. On a card (the tests named `test_card_*` skip without
one): graph replay against the eager forward bit for bit at every row
count, graphs reused across files, captured again after a switch flips
(TF32 too) or a parameter changes, and the launch registry's counts of K1,
K3, K4 and K5 the same either way; a pre-LN model with WavLM-Large's
extractor (a LayerNorm after every conv, the waveform normalised) in its
three stage graphs, with the file's stage events read. This file imports
nothing of JAX, so on the machine with the card it runs without the suite's
conftest:

    python -m pytest --noconftest -q tests/test_torch_sliding_graphs.py
"""

import contextlib

import numpy as np
import pytest
import torch

from diarizen_tpu_torch import tracing
from diarizen_tpu_torch.cluster import AgglomerativeClustering
from diarizen_tpu_torch.infer import DiarizationPipeline, EmbeddingInference, SlidingInference
from diarizen_tpu_torch.infer.sliding import (
    BatchGraph,
    GraphedBatches,
    batch_row_spans,
    gather_rows,
    state_stamp,
    tail_size,
)
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.convert import random_state_dict
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.fbank_eend import FbankEendConfig, FbankEendModel
from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig
from diarizen_tpu_torch.models.sincnet_eend import SincNetEendConfig, SincNetEendModel
from diarizen_tpu_torch.models.wavlm import (
    WavLMConfig,
    set_conv_chain,
    set_fused_ln,
    use_conv_chain,
    use_fused_ln,
)
from diarizen_tpu_torch.ops import cuda_build
from diarizen_tpu_torch.ops.flash_attention import set_softmax_mode, softmax_mode

SR = 16000


def tiny_eend() -> EendModel:
    """The tracing test's geometry: a 7-layer conv front, two attention
    layers with 2 and 3 of 4 heads, 8 s windows, 4 speakers; the classifier
    widened so that the powerset decisions vary."""
    n = 2
    wavlm = WavLMConfig(
        conv_layers=((16, 10, 5), (16, 3, 2), (16, 3, 2), (16, 3, 2), (16, 3, 2),
                     (16, 2, 2), (16, 2, 2)),
        embed_dim=64, num_layers=n, use_attention=(True,) * n, use_feed_forward=(True,) * n,
        total_num_heads=(4,) * n, remaining_heads=((0, 2), (1, 2, 3)),
        ff_interm_features=(48, 32), layer_drop=0.0)
    model = EendModel(EendConfig(
        wavlm=wavlm, conformer=ConformerConfig(dim=32, ffn_hidden=64, num_heads=4, num_layers=1),
        wavlm_layer_num=n + 1, wavlm_feat_dim=64, attention_in=32))
    sd = random_state_dict(model, 0)
    sd["classifier.weight"] = sd["classifier.weight"] * 100.0
    model.load_state_dict(sd)
    return model.eval()


def tiny_pre_ln_eend() -> EendModel:
    """WavLM-Large's kind of model at the same geometry: the waveform
    normalised, a LayerNorm after every conv of uneven widths, pre-LN
    layers keeping 3, 1 and 4 of 4 heads, one layer with its attention
    removed, a feed-forward width a layer."""
    n = 4
    wavlm = WavLMConfig(
        extractor_mode="layer_norm",
        conv_layers=((24, 10, 5), (12, 3, 2), (20, 3, 2), (16, 3, 2), (10, 3, 2),
                     (18, 2, 2), (14, 2, 2)),
        embed_dim=64, num_layers=n, use_attention=(True, True, False, True),
        use_feed_forward=(True,) * n, total_num_heads=(4,) * n,
        remaining_heads=((0, 2, 3), (1,), (), (0, 1, 2, 3)), ff_interm_features=(48, 24, 40, 16),
        layer_norm_first=True, normalize_waveform=True, layer_drop=0.0)
    model = EendModel(EendConfig(
        wavlm=wavlm, conformer=ConformerConfig(dim=32, ffn_hidden=64, num_heads=4, num_layers=1),
        wavlm_layer_num=n + 1, wavlm_feat_dim=64, attention_in=32))
    sd = random_state_dict(model, 2)
    sd["classifier.weight"] = sd["classifier.weight"] * 100.0
    model.load_state_dict(sd)
    return model.eval()


def make_wave(dur_s: float, seed: int = 0) -> np.ndarray:
    """(1, samples) tones of two alternating speakers with noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(dur_s * SR)) / SR
    wave = 0.01 * rng.standard_normal(len(t))
    pos, spk = 0.0, 0
    while pos < dur_s - 1:
        seg = rng.uniform(1.0, 4.0)
        m = (t >= pos) & (t < pos + seg)
        wave[m] += 0.2 * np.sin(2 * np.pi * (180 + 90 * spk) * t[m])
        pos += seg * rng.uniform(0.6, 1.0)
        spk = 1 - spk
    return wave[None].astype(np.float32)


def eager(seg: SlidingInference, wave: torch.Tensor, starts: np.ndarray,
          soft: bool = False) -> torch.Tensor:
    """The multilabel of every window through the model's forward, batch by
    batch as `dispatch` cuts them, with no graph."""
    starts_dev = torch.as_tensor(starts, device=wave.device)
    out = None
    with torch.inference_mode():
        for off, blen, pad in batch_row_spans(len(starts), seg.batch_size,
                                              lambda n: tail_size(n, seg.batch_size)):
            chunks = gather_rows(wave, starts_dev[off: off + blen], seg.window_size, pad)
            rows = seg._forward(chunks, soft)[:blen]
            if out is None:
                out = rows.new_zeros((len(starts),) + tuple(rows.shape[1:]))
            out[off: off + blen] = rows
    return out


def counted(seg: SlidingInference, wave: torch.Tensor, starts: np.ndarray,
            soft: bool = False) -> tuple:
    """(dispatch's output, the file record it counted on)."""
    record = tracing.FileRecord(-1, 0, 0.0)
    with tracing.span("diarize.segment", record):
        out = seg.dispatch(wave, starts, soft=soft)
    return out, record


def num_batches(total: int, batch_size: int) -> int:
    return len(list(batch_row_spans(total, batch_size, lambda n: tail_size(n, batch_size))))


# ---------------------------------------------------------------------------
# on the CPU


@pytest.mark.parametrize("batch_size", [32, 16])
def test_batch_rows_are_a_bounded_set(batch_size):
    """Every batch has a multiple of 8 rows up to `batch_size`, so a
    `SlidingInference` holds at most batch_size / 8 graphs of a key, and the
    spans cover every window."""
    shapes = set()
    for total in range(1, 301):
        covered = np.zeros(total, bool)
        for off, blen, pad in batch_row_spans(total, batch_size,
                                              lambda n: tail_size(n, batch_size)):
            shapes.add(blen + pad)
            covered[off: off + blen] = True
        assert covered.all(), total
    assert shapes == set(range(8, batch_size + 1, 8))


@pytest.fixture(scope="module")
def cpu_seg():
    return SlidingInference(tiny_eend(), batch_size=8, compute_dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def cpu_emb(cpu_seg):
    resnet = ResNet(ResNetConfig(m_channels=8, num_blocks=(1, 1, 1, 1), embed_dim=32))
    resnet.load_state_dict(random_state_dict(resnet, 1))
    return EmbeddingInference(resnet.eval(), cpu_seg.window_size, num_speakers=4, batch_size=8,
                              device="cpu")


@pytest.mark.parametrize("soft", [False, True])
def test_cpu_runs_every_batch_eagerly(cpu_seg, soft):
    wave, starts = cpu_seg.prepare_wave(make_wave(30.3))
    out, record = counted(cpu_seg, wave, starts, soft=soft)
    assert len(starts) == 29  # batches of 8 rows, the last from the last 8 windows
    assert record.seg_graph_batches == 0
    assert record.seg_eager_batches == num_batches(len(starts), cpu_seg.batch_size) == 4
    assert not cpu_seg._graphs and cpu_seg._graph_pool is None
    assert torch.equal(out, eager(cpu_seg, wave, starts, soft))


def test_cpu_runs_a_staged_model_eagerly():
    """The pre-LN model runs in its three stages, every batch eagerly,
    as its one-piece forward does."""
    seg = SlidingInference(tiny_pre_ln_eend(), batch_size=8, compute_dtype=torch.float32,
                           device="cpu")
    assert len(seg._stages(False)) == 3
    wave, starts = seg.prepare_wave(make_wave(20.3))
    out, record = counted(seg, wave, starts)
    assert record.seg_graph_batches == 0
    assert record.seg_eager_batches == num_batches(len(starts), 8)
    assert not seg._graphs and seg._graph_pool is None
    with torch.inference_mode():
        chunks = gather_rows(wave, torch.as_tensor(starts[:8]), seg.window_size, 0)
        whole = seg.powerset.to_multilabel(seg.model(chunks, compute_dtype=torch.float32))
    assert torch.equal(out[:8], whole)
    assert torch.equal(out, eager(seg, wave, starts))


def test_state_stamp_sees_every_change_of_the_weights():
    model = tiny_eend()
    stamp = state_stamp(model)
    assert state_stamp(model) == stamp and len(stamp) == len(
        list(model.parameters()) + list(model.buffers()))
    weight = model.classifier.weight
    changes = (lambda: weight.mul_(2.0),  # in place
               lambda: setattr(weight, "data", weight.data.clone()),  # new storage
               lambda: setattr(model.classifier, "weight", torch.nn.Parameter(weight.data)),
               lambda: setattr(model, "lnorm", torch.nn.LayerNorm(32)))  # a new module
    for change in changes:
        with torch.no_grad():
            change()
        assert state_stamp(model) != stamp
        stamp = state_stamp(model)


def test_halve_batch_drops_the_graphs(cpu_seg):
    seg = SlidingInference(cpu_seg.model, batch_size=32, device="cpu")
    seg._graphs[(False, 32)] = object()
    seg._graph_pool = object()
    seg.halve_batch(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert seg.batch_size == 16 and not seg._graphs and seg._graph_pool is None
    with pytest.raises(KeyError):
        seg.halve_batch(KeyError("not an OOM"))
    assert seg.batch_size == 16


@pytest.mark.parametrize("fused", [True, False])
def test_records_count_every_batch(cpu_seg, cpu_emb, fused):
    """A streamed file's two counters sum to its segmentation batches, on
    the device-stitch route and on the host route."""
    pipe = DiarizationPipeline(cpu_seg, cpu_emb, AgglomerativeClustering(), cpu_seg.cfg,
                               max_speakers=4, fused_stitch=fused)
    waves = [make_wave(12.5), make_wave(9.2, seed=1), make_wave(30.3, seed=2)]
    assert len(list(pipe.stream(iter(waves), SR))) == 3
    records = [r for r in tracing.records() if r.pipeline == pipe._trace_id]
    assert len(records) == 3
    for r, w in zip(records, waves):
        total = len(cpu_seg.prepare_wave(w)[1])
        assert r.seg_graph_batches == 0
        assert r.seg_eager_batches == num_batches(total, cpu_seg.batch_size)


def set_cudnn_tf32(enabled: bool) -> None:
    torch.backends.cudnn.allow_tf32 = enabled


# each process switch a forward reads (`ops.forward_switches`): how to read
# it, how to set it, and another value than a given one
SWITCHES = {
    "softmax_mode": (softmax_mode, set_softmax_mode, lambda v: "bf16" if v == "f32" else "f32"),
    "fused_ln": (use_fused_ln, set_fused_ln, lambda v: not v),
    "conv_chain": (use_conv_chain, set_conv_chain, lambda v: not v),
    "cudnn_tf32": (lambda: torch.backends.cudnn.allow_tf32, set_cudnn_tf32, lambda v: not v),
    "matmul_precision": (torch.get_float32_matmul_precision, torch.set_float32_matmul_precision,
                         lambda v: "high" if v == "highest" else "highest"),
}


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_every_switch_the_forward_reads_keys_both_graphs(cpu_seg, cpu_emb, switch, monkeypatch):
    """Flipping a process switch that a forward reads gives the batches of
    the segmentation and of the embeddings another graph key, and restoring
    it restores the keys: no graph replays under a switch it was not
    captured under."""
    monkeypatch.setattr(GraphedBatches, "_graphs_apply", lambda self, x: True)
    wave = torch.zeros(8)

    def keys():
        return (cpu_seg._graph_key(wave, False, cpu_seg.compute_dtype),
                cpu_emb._graph_key(wave, True, cpu_emb.compute_dtype))

    read, write, other = SWITCHES[switch]
    before, original = keys(), read()
    assert None not in before
    write(other(original))
    try:
        flipped = keys()
    finally:
        write(original)
    assert flipped[0] != before[0] and flipped[1] != before[1]
    assert keys() == before


def test_a_capture_moves_its_launch_counts_to_the_replays(monkeypatch):
    """A capture runs nothing on the card, so the launches its stages count
    in the registry are taken back out, and each replay adds them, whichever
    kernels they are; counts from before the capture stay."""
    class Graph:  # records no kernel: only the bookkeeping around it runs
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, pool=None: contextlib.nullcontext())

    def extractor(x):
        cuda_build.count("fwd_deferred")
        cuda_build.count("k3")
        cuda_build.count("k3")
        return x + 1

    def back_end(x):
        cuda_build.count("k5")
        return 2 * x

    cuda_build.reset_launches()
    cuda_build.count("k4")
    before = dict(cuda_build.launches)
    graph = BatchGraph([extractor, back_end], (torch.zeros(2),), pool=None)
    assert cuda_build.launches == before
    assert graph.launches == {"fwd_deferred": 1, "k3": 2, "k5": 1}
    for replays in (1, 2):
        assert torch.equal(graph((torch.ones(2),)), torch.full((2,), 2.0))
        assert cuda_build.launch_totals() == {"k1": replays, "k1_train": 0, "k2": 0,
                                              "k3": 2 * replays, "k4": 1, "k5": replays,
                                              "resnet_conv": 0, "resnet_fold": 0}
    cuda_build.reset_launches()


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def on_card(seconds: float, seg: SlidingInference, seed: int = 0):
    return seg.prepare_wave(make_wave(seconds, seed))


# windows of a file -> the rows of its last batch at batch 32: 8, 16, 24, 32
LAST_ROWS = {40: 8, 44: 16, 52: 24, 60: 32}


def seconds_for(windows: int) -> float:
    return 8.0 + (windows - 1) * 0.8


@pytest.fixture(scope="module")
def card_seg(card):
    return SlidingInference(tiny_eend(), batch_size=32, compute_dtype=torch.bfloat16,
                            device=card)


@pytest.mark.parametrize("soft", [False, True])
def test_card_graphs_match_the_eager_forward(card_seg, soft):
    seg = card_seg
    seg.drop_graphs()
    seen = set()
    for windows, rows in LAST_ROWS.items():
        wave, starts = on_card(seconds_for(windows), seg)
        assert len(starts) == windows
        shapes = {blen + pad for _, blen, pad in batch_row_spans(
            windows, 32, lambda n: tail_size(n, 32))}
        want = eager(seg, wave, starts, soft)
        first, rec1 = counted(seg, wave, starts, soft)  # a new shape's first batch is eager
        again, rec2 = counted(seg, wave, starts, soft)  # every batch replays
        assert rec1.seg_eager_batches == len(shapes - seen) and rec2.seg_eager_batches == 0
        seen |= shapes
        assert rec2.seg_graph_batches == num_batches(windows, 32)
        assert any(k[-1] == rows and k[0] == soft for k in seg._graphs)
        assert first.dtype == (torch.float32 if soft else torch.uint8)
        assert torch.equal(first, want) and torch.equal(again, want), (windows, soft)
    assert sorted(k[-1] for k in seg._graphs if k[0] == soft) == [8, 16, 24, 32]


def test_card_graphs_are_reused_and_recaptured(card_seg):
    seg = card_seg
    seg.drop_graphs()
    for windows in LAST_ROWS:
        counted(seg, *on_card(seconds_for(windows), seg))
    graphs = dict(seg._graphs)
    assert len(graphs) == 4
    # another file, another length: replays only, no new capture
    wave, starts = on_card(97.3, seg, seed=3)
    out, record = counted(seg, wave, starts)
    assert record.seg_eager_batches == 0 and record.seg_graph_batches == num_batches(
        len(starts), 32)
    assert seg._graphs == graphs
    assert torch.equal(out, eager(seg, wave, starts))
    # a switch the forward reads: new keys, captured afresh
    set_fused_ln(True)
    try:
        want = eager(seg, wave, starts)
        out, record = counted(seg, wave, starts)
        assert record.seg_eager_batches >= 1 and len(seg._graphs) > 4
        assert torch.equal(out, want)
        out, record = counted(seg, wave, starts)
        assert record.seg_eager_batches == 0 and torch.equal(out, want)
    finally:
        set_fused_ln(None)
    # a parameter changed in place, and one given new storage: no stale replay
    weight = seg.model.classifier.weight
    for change in (lambda: weight.mul_(-1.0), lambda: setattr(weight, "data", weight.data * 2)):
        with torch.no_grad():
            change()
        before = dict(seg._graphs)
        want = eager(seg, wave, starts)
        out, record = counted(seg, wave, starts)
        assert record.seg_eager_batches >= 1
        assert all(g is not before.get(k) for k, g in seg._graphs.items())
        assert torch.equal(out, want)


@pytest.mark.parametrize("soft", [False, True])
def test_card_staged_graphs_of_a_pre_ln_model(card, soft):
    """Three graphs a batch shape (extractor, encoder, back end) replay
    bit for bit what the eager forward gives; the file's events, recorded
    between the graphs, read both stages inside the segmentation's span."""
    seg = SlidingInference(tiny_pre_ln_eend(), batch_size=32, compute_dtype=torch.bfloat16,
                           device=card)
    for windows in LAST_ROWS:
        wave, starts = on_card(seconds_for(windows), seg)
        want = eager(seg, wave, starts, soft)
        for _ in range(2):  # the new shapes' eager batches and captures, then replays only
            events = tracing.StageEvents.take([], torch.cuda.current_stream())
            record = tracing.FileRecord(-1, 0, 0.0)
            events.mark(0)
            with tracing.span("diarize.segment", record):
                out = seg.dispatch(wave, starts, soft=soft, events=events)
            events.mark(1)
            events.mark(2)
            torch.cuda.synchronize()
            events.read(record, [])
            assert torch.equal(out, want), windows
            assert 0 < record.seg_extract_ms and 0 < record.seg_encode_ms
            assert record.seg_extract_ms + record.seg_encode_ms < record.seg_stream_ms
        assert record.seg_eager_batches == 0
        assert record.seg_graph_batches == num_batches(windows, 32)
    assert sorted(k[-1] for k in seg._graphs) == [8, 16, 24, 32]
    assert all(len(g.graphs) == 3 for g in seg._graphs.values())


@pytest.mark.parametrize("fused", [False, True])
def test_card_launch_counters_count_alike(card_seg, fused):
    """Eager, captured and replayed batches count the same launches in the
    registry: K1's, and with the fused-LN route K3's and K4's."""
    seg = card_seg
    wave, starts = on_card(seconds_for(60), seg)
    set_fused_ln(fused)
    try:
        cuda_build.reset_launches()
        eager(seg, wave, starts)
        want = dict(cuda_build.launches)
        batches = num_batches(60, 32)
        assert want["fwd_deferred"] == 2 * batches  # two attention layers a batch
        assert (want["k3"], want["k4"]) == ((2 * batches, 2 * batches) if fused else (0, 0))
        seg.drop_graphs()
        for what in ("eager passes and captures", "replays"):
            cuda_build.reset_launches()
            counted(seg, wave, starts)
            assert cuda_build.launches == want, what
    finally:
        set_fused_ln(None)


def test_card_conv_chain_replays_alike(card):
    """K5 (the 512-wide extractor's layers 1-6, `set_conv_chain`) inside the
    graphs: the same multilabel and the same count as eagerly."""
    n = 1
    wavlm = WavLMConfig(embed_dim=64, num_layers=n, use_attention=(True,), use_feed_forward=(True,),
                        total_num_heads=(4,), remaining_heads=((0, 1, 2, 3),),
                        ff_interm_features=(48,), layer_drop=0.0)
    model = EendModel(EendConfig(
        wavlm=wavlm, conformer=ConformerConfig(dim=32, ffn_hidden=64, num_heads=4, num_layers=1),
        wavlm_layer_num=n + 1, wavlm_feat_dim=64, attention_in=32))
    sd = random_state_dict(model, 5)
    sd["classifier.weight"] = sd["classifier.weight"] * 100.0
    model.load_state_dict(sd)
    seg = SlidingInference(model.eval(), batch_size=32, compute_dtype=torch.bfloat16,
                           device=card)
    wave, starts = seg.prepare_wave(make_wave(seconds_for(44)))
    set_conv_chain(True)
    try:
        cuda_build.reset_launches()
        want = eager(seg, wave, starts)
        assert cuda_build.launches["k5"] == num_batches(44, 32)
        for what in ("eager passes and captures", "replays"):
            cuda_build.reset_launches()
            out, record = counted(seg, wave, starts)
            assert cuda_build.launches["k5"] == num_batches(44, 32), what
            assert torch.equal(out, want), what
        assert record.seg_eager_batches == 0
    finally:
        set_conv_chain(None)


def family_models():
    sinc = SincNetEendModel(SincNetEendConfig(hidden_size=16, num_lstm_layers=2))
    fbank = FbankEendModel(FbankEendConfig(
        conformer=ConformerConfig(dim=32, ffn_hidden=64, num_heads=4, num_layers=1),
        attention_in=32))
    return {"sincnet": sinc, "fbank": fbank}


@pytest.mark.parametrize("family", ["sincnet", "fbank"])
def test_card_other_families_replay_alike(card, family):
    """SincNet (cuDNN's LSTM) and the fbank EEND capture and replay too, in
    float32; with cuDNN's TF32 switch flipped between two files the next
    file's batches are captured afresh, not replayed with the kernels that
    the old setting chose."""
    model = family_models()[family]
    model.load_state_dict(random_state_dict(model, 4))
    seg = SlidingInference(model.eval(), batch_size=32, compute_dtype=torch.float32, device=card)
    wave, starts = seg.prepare_wave(make_wave(60.0))
    want = eager(seg, wave, starts)
    counted(seg, wave, starts)
    out, record = counted(seg, wave, starts)
    assert record.seg_eager_batches == 0 and record.seg_graph_batches >= 1
    assert torch.equal(out, want)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = not tf32
    try:
        graphs = dict(seg._graphs)
        wave, starts = seg.prepare_wave(make_wave(60.0, seed=1))
        want = eager(seg, wave, starts)
        out, record = counted(seg, wave, starts)
        assert record.seg_eager_batches >= 1 and len(seg._graphs) > len(graphs)
        assert torch.equal(out, want)
        out, record = counted(seg, wave, starts)
        assert record.seg_eager_batches == 0 and torch.equal(out, want)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
