"""The serving pipeline's spans and per-file records (`diarizen_tpu_torch.tracing`)
on the CPU, on a small pipeline of `tests/test_torch_stream.py`'s geometry with
seeded port weights: one record a file, spans nested at the layer boundaries
on both routes, the same spans in a profiler's Chrome trace, no
`record_function` without a profiler, and the same RTTMs as with the spans
taken out (`tests/test_torch_stream.py` holds those RTTMs to the JAX
package's)."""

import dataclasses
import json
from collections import deque

import numpy as np
import pytest
import torch

from diarizen_tpu_torch import tracing
from diarizen_tpu_torch.cluster import AgglomerativeClustering
from diarizen_tpu_torch.infer import DiarizationPipeline, EmbeddingInference, SlidingInference
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.convert import random_state_dict
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig
from diarizen_tpu_torch.models.wavlm import WavLMConfig

# child -> parent, as tracing.py's docstring draws them
FUSED_PARENTS = {"diarize.segment": "diarize.dispatch", "diarize.stitch": "diarize.dispatch",
                 "diarize.embed": "diarize.dispatch", "diarize.wait": "diarize.finish",
                 "diarize.cluster": "diarize.finish", "diarize.reconstruct": "diarize.finish"}
HOST_PARENTS = {"diarize.segment": "diarize.dispatch", "diarize.stitch": "diarize.finish",
                "diarize.embed": "diarize.finish", "diarize.cluster": "diarize.finish",
                "diarize.reconstruct": "diarize.finish"}
TOP = {"diarize.dispatch", "diarize.finish", "diarize.trim"}


def make_wave(dur_s, sr=16000):
    """Two speakers taking turns, PCM16-quantised (`tests/test_torch_pipeline.py`'s
    wave, here so that this file imports nothing of JAX)."""
    t = np.arange(dur_s * sr) / sr
    wave = np.zeros_like(t, dtype=np.float32)
    rng = np.random.default_rng(0)
    pos, spk = 0.0, 0
    while pos < dur_s - 2:
        seg = rng.uniform(2.0, 6.0)
        m = (t >= pos) & (t < pos + seg)
        wave[m] += 0.2 * np.sin(2 * np.pi * (180 + 90 * spk) * t[m]).astype(np.float32)
        wave[m] += 0.01 * rng.standard_normal(int(m.sum())).astype(np.float32)
        pos += seg * rng.uniform(0.6, 1.0)
        spk = 1 - spk
    wave = np.clip(np.rint(wave * 32767.0), -32768, 32767) / 32768.0
    return wave[None].astype(np.float32)


@pytest.fixture(scope="module")
def small():
    """(build(fused) -> DiarizationPipeline, waves): the stream test's
    geometry (7-layer conv front, 8 s windows, 4 speakers) with seeded port
    weights, the classifier widened so that the powerset decisions vary."""
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
    resnet = ResNet(ResNetConfig(m_channels=8, num_blocks=(1, 1, 1, 1), embed_dim=32))
    resnet.load_state_dict(random_state_dict(resnet, 1))
    seg = SlidingInference(model, batch_size=6, compute_dtype=torch.float32, device="cpu")
    emb = EmbeddingInference(resnet, seg.window_size, num_speakers=4, batch_size=6, device="cpu")

    def build(fused=True):
        return DiarizationPipeline(seg, emb, AgglomerativeClustering(), model.cfg,
                                   max_speakers=4, fused_stitch=fused)

    wave = make_wave(12)
    return build, [wave, np.ascontiguousarray(wave[:, ::-1]), wave[:, : 9 * 16000 + 3000]]


def mine(pipe):
    return [r for r in tracing.records() if r.pipeline == pipe._trace_id]


def check_nesting(spans, parents):
    """Every span lies inside one span of its parent's name, and the
    top-level spans do not overlap."""
    for name, a, b in spans:
        assert b >= a
        if name in parents:
            assert any(n == parents[name] and pa <= a and b <= pb for n, pa, pb in spans), name
    top = sorted((a, b) for n, a, b in spans if n in TOP)
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(top, top[1:]))


@pytest.mark.parametrize("fused", [True, False])
def test_stream_records_every_file_with_nested_spans(small, fused):
    build, waves = small
    pipe = build(fused)
    rttms = [a.to_rttm() for a in pipe.stream(iter(waves), 16000, trim_every=2)]
    records = mine(pipe)
    assert len(records) == len(waves) == len(rttms)
    assert [r.file for r in records] == [0, 1, 2]
    assert [r.audio_s for r in records] == [w.shape[1] / 16000 for w in waves]
    for j, r in enumerate(records):
        names = [n for n, _, _ in r.spans]
        assert all(n.startswith("diarize.") for n in names)
        for once in ("diarize.dispatch", "diarize.finish", "diarize.segment",
                     "diarize.cluster", "diarize.reconstruct"):
            assert names.count(once) == 1, (once, names)
        assert names.count("diarize.trim") == (j == 1)  # the second file's finish set it off
        assert names.count("diarize.wait") == (1 if fused else 2)
        check_nesting(r.spans, FUSED_PARENTS if fused else HOST_PARENTS)
        if fused:
            assert set(names) == set(FUSED_PARENTS) | TOP - ({"diarize.trim"} if j != 1 else set())
        else:  # the segmentation's fetch, before the next file is enqueued; the embeddings' inside
            (w0, _), (w1, w1_end) = sorted((a, b) for n, a, b in r.spans if n == "diarize.wait")
            embed = [(a, b) for n, a, b in r.spans if n == "diarize.embed"]
            assert embed and embed[0][0] <= w1 and w1_end <= embed[0][1]
        assert r.ms("diarize.finish") >= r.ms("diarize.cluster") + r.ms("diarize.reconstruct")
        assert r.seg_stream_ms is r.embed_stream_ms is None  # no CUDA
    # a copy made by dataclasses.replace is another pipeline, its files counted anew
    other = dataclasses.replace(pipe)
    assert other._trace_id != pipe._trace_id
    other(waves[2], 16000)
    assert [r.file for r in mine(other)] == [0] and len(mine(pipe)) == 3


def test_profiler_trace_holds_the_spans_and_rttms_are_unchanged(small, tmp_path, monkeypatch):
    build, waves = small
    pipe = build()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = [a.to_rttm() for a in pipe.stream(iter(waves), 16000, trim_every=2)]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e["name"].startswith("diarize.")]
    assert not {e["name"] for e in events} & {"dispatch", "finish", "cluster"}
    recorded = sorted(n for r in mine(pipe) for n, _, _ in r.spans)
    assert sorted(n for n, _, _ in spans) == recorded
    check_nesting(spans, FUSED_PARENTS)

    # no profiler: the same RTTMs, and the same again with every span taken out
    untraced = [a.to_rttm() for a in build().stream(iter(waves), 16000, trim_every=2)]

    class Off:
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr(tracing, "span", Off)
    bare = [build()(w, 16000).to_rttm() for w in waves]
    assert traced == untraced == bare
    assert all(len(r.splitlines()) > 1 for r in bare)


def test_no_profiler_never_enters_record_function(small, monkeypatch):
    build, waves = small

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    pipe = build()
    list(pipe.stream(iter(waves[:2]), 16000, trim_every=1))
    assert len(mine(pipe)) == 2


def test_spans_records_and_events_alone(monkeypatch):
    monkeypatch.setattr(tracing, "_records", deque(maxlen=tracing.KEEP))
    with tracing.span("diarize.wait"):  # no current file: times nothing, raises nothing
        pass
    rec = tracing.FileRecord(7, 0, 2.5)
    with tracing.span("diarize.finish", rec):
        with tracing.span("diarize.wait"):
            pass
    with tracing.span("diarize.trim"):
        pass
    assert [n for n, _, _ in rec.spans] == ["diarize.wait", "diarize.finish"]
    free = []
    events = tracing.StageEvents.take(free, None)  # off CUDA: records and reads nothing
    for stage in range(3):
        events.mark(stage)
    events.read(rec, free)
    assert rec.seg_stream_ms is rec.embed_stream_ms is None and free == []

    class Event:  # a CUDA timing event, on a clock that `record` sets
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self, stream):
            self.t = stream.pop(0)

        def elapsed_time(self, end):
            return end.t - self.t

    monkeypatch.setattr(torch.cuda, "Event", Event)
    stream = [10.0, 14.5, 16.0, 20.0, 21.0, 25.0]  # the times two files' marks reach
    events = tracing.StageEvents.take(free, stream)
    for stage in range(3):
        events.mark(stage)
    events.read(rec, free)
    assert (rec.seg_stream_ms, rec.embed_stream_ms) == (4.5, 1.5) and free == [events]
    again = tracing.StageEvents.take(free, stream)  # the same events, no new ones
    assert again is events and free == []
    for stage in range(3):
        again.mark(stage)
    again.read(rec, free)
    assert (rec.seg_stream_ms, rec.embed_stream_ms) == (1.0, 4.0) and free == [events]
    for k in range(tracing.KEEP + 5):
        tracing.finished(tracing.FileRecord(7, k, 1.0))
    kept = tracing.records()
    assert len(kept) == tracing.KEEP and kept[0].file == 5 and kept[-1].file == tracing.KEEP + 4


def test_stage_fields_are_none_off_cuda(small):
    """Off CUDA no event is recorded: the extractor's and the encoder's
    stream milliseconds stay None, and the record keeps its other fields; a
    single-channel model's file has no microphones, (window, microphone)
    rows or fused-channel stream milliseconds."""
    build, waves = small
    pipe = build()
    list(pipe.stream(iter(waves[:2]), 16000, trim_every=0))
    for r, w in zip(mine(pipe), waves):
        assert r.seg_extract_ms is r.seg_encode_ms is r.seg_stream_ms is None
        assert r.channels is None and r.emb_rows == 0 and r.seg_fuse_ms is None
        assert r.audio_s == w.shape[1] / 16000 and r.seg_eager_batches > 0
        assert r.seg_graph_batches == 0 and r.ms("diarize.dispatch") > 0


def test_batch_events_sum_over_a_files_batches(monkeypatch):
    """Each batch's three events time its extractor and its encoder; a
    file's record sums them, and the next file reuses the events."""
    made = []

    class Event:  # a CUDA timing event, on a clock that `record` sets
        def __init__(self, enable_timing=False):
            self.t = None
            made.append(self)

        def record(self, stream):
            self.t = stream.pop(0)

        def elapsed_time(self, end):
            return end.t - self.t

    monkeypatch.setattr(torch.cuda, "Event", Event)
    free = []
    # file 1: mark 0, two batches (extract 2 + 3, encode 5 + 4), marks 1 and 2
    stream = [0.0, 1.0, 3.0, 8.0, 9.0, 12.0, 16.0, 18.0, 20.0]
    events = tracing.StageEvents.take(free, stream)
    events.mark(0)
    for _ in range(2):
        events.batch()
        for boundary in range(3):
            events.mark_batch(boundary)
    events.mark(1)
    events.mark(2)
    rec = tracing.FileRecord(7, 0, 2.5)
    events.read(rec, free)
    assert (rec.seg_extract_ms, rec.seg_encode_ms) == (5.0, 9.0)
    assert (rec.seg_stream_ms, rec.embed_stream_ms) == (18.0, 2.0) and free == [events]
    assert len(made) == 9 and events.batches == [] and len(events.spare) == 2
    # file 2: one batch, on the spare events; no event made
    stream = [30.0, 31.0, 32.5, 36.0, 37.0, 38.0]
    again = tracing.StageEvents.take(free, stream)
    again.mark(0)
    again.batch()
    for boundary in range(3):
        again.mark_batch(boundary)
    again.mark(1)
    again.mark(2)
    rec2 = tracing.FileRecord(7, 1, 1.0)
    again.read(rec2, free)
    assert again is events and len(made) == 9
    assert (rec2.seg_extract_ms, rec2.seg_encode_ms) == (1.5, 3.5)
    # a file whose model ran in one piece: no batch events, the fields None
    plain = tracing.StageEvents.take(free, [40.0, 41.0, 42.0])
    for stage in range(3):
        plain.mark(stage)
    rec3 = tracing.FileRecord(7, 2, 1.0)
    plain.read(rec3, free)
    assert rec3.seg_extract_ms is rec3.seg_encode_ms is None and rec3.seg_stream_ms == 1.0


def test_batch_events_of_four_stages(monkeypatch):
    """A multi-channel model's batches mark four stages: the extractor, the
    encoder on every channel's stream through the channel mean (fused), the
    single-stream rest; the encoder's milliseconds hold the fused part."""

    class Event:  # as above
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self, stream):
            self.t = stream.pop(0)

        def elapsed_time(self, end):
            return end.t - self.t

    monkeypatch.setattr(torch.cuda, "Event", Event)
    free = []
    # mark 0; two batches (extract 1 + 2, fused 4 + 3, rest 2 + 1); marks 1 and 2
    stream = [0.0, 1.0, 2.0, 6.0, 8.0, 9.0, 11.0, 14.0, 15.0, 16.0, 17.0]
    events = tracing.StageEvents.take(free, stream)
    events.mark(0)
    for _ in range(2):
        events.batch()
        for boundary in range(4):
            events.mark_batch(boundary)
    events.mark(1)
    events.mark(2)
    rec = tracing.FileRecord(8, 0, 2.0)
    events.read(rec, free)
    assert (rec.seg_extract_ms, rec.seg_fuse_ms, rec.seg_encode_ms) == (3.0, 7.0, 10.0)
    assert (rec.seg_stream_ms, rec.embed_stream_ms) == (16.0, 1.0)
    # the next file, of a three-stage model, on the same events: no fused part
    stream = [20.0, 21.0, 22.0, 25.0, 26.0, 27.0]
    again = tracing.StageEvents.take(free, stream)
    again.mark(0)
    again.batch()
    for boundary in range(3):
        again.mark_batch(boundary)
    again.mark(1)
    again.mark(2)
    rec2 = tracing.FileRecord(8, 1, 1.0)
    again.read(rec2, free)
    assert again is events and rec2.seg_fuse_ms is None
    assert (rec2.seg_extract_ms, rec2.seg_encode_ms) == (1.0, 3.0)
