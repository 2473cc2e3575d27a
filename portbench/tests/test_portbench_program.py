"""The selection of the program's per-file records (portbench/program.py) and
the six readers of them, on hand-made records."""

from dataclasses import dataclass, field

import pytest

from portbench import core, program

MS = 1_000_000  # ns


@dataclass
class Rec:
    pipeline: int
    file: int
    audio_s: float
    spans: list = field(default_factory=list)
    seg_stream_ms: float = None
    embed_stream_ms: float = None

    def ms(self, name):  # as tracing.FileRecord.ms
        return sum(end - start for n, start, end in self.spans if n == name) / 1e6


def rec(pipeline, file, audio_s=30.0, cluster=None, dispatch=20.0, wait=2.0, recon=5.0,
        trim=None, device=True):
    """A file of `pipeline` with its spans laid end to end."""
    spans, t = [], file * 10_000 * MS

    def add(name, ms):
        nonlocal t
        spans.append((name, t, t + int(ms * MS)))
        t += int(ms * MS)

    add("diarize.dispatch", dispatch)
    add("diarize.wait", wait)
    if cluster is not None:
        add("diarize.cluster", cluster)
    add("diarize.reconstruct", recon)
    if trim is not None:
        add("diarize.trim", trim)
    r = Rec(pipeline, file, audio_s, spans)
    if device:
        r.seg_stream_ms, r.embed_stream_ms = 40.0, 20.0
    return r


WORKLOAD = {"warm_chunks": [4, 12]}


def run(pipeline=3, files=4):
    """Two warm-up files (the second trims), then the window: `files`
    untraced (the second trims) and one traced (it trims too)."""
    warm = [rec(pipeline, k, cluster=50.0, trim=900.0 if k else None) for k in range(2)]
    window = [rec(pipeline, 2 + k, audio_s=15.0 * (k + 1), cluster=10.0 + k,
                  dispatch=20.0 + 4 * k, trim=300.0 if k == 1 else None)
              for k in range(files)]
    return warm + window + [rec(pipeline, 2 + files, cluster=99.0, trim=100.0)]


CTX = {"workload": WORKLOAD, "files": 4, "cluster_ms": [10.2, 11.0, 11.9, 13.0]}


def test_selection_takes_the_newest_pipeline_after_its_warm_up():
    records = [rec(1, k, cluster=7.0) for k in range(8)] + run()
    chosen = program.select(records, CTX)
    assert [(r.pipeline, r.file) for r in chosen] == [(3, 2), (3, 3), (3, 4), (3, 5)]
    # a file without clustering (no speech) is skipped in the call-for-call match
    records = run()
    records[3].spans = [s for s in records[3].spans if s[0] != "diarize.cluster"]
    ctx = {**CTX, "cluster_ms": [10.2, 11.9, 13.0]}
    assert [r.file for r in program.select(records, ctx)] == [2, 3, 4, 5]


@pytest.mark.parametrize("ctx", [
    {**CTX, "files": 6},  # fewer records than the benchmark counted
    {**CTX, "cluster_ms": [10.2, 11.0, 11.9]},  # a clustering call more than the benchmark's
    {**CTX, "cluster_ms": [10.2, 11.0, 13.2, 13.0]},  # one call 1.3 ms apart
    {**CTX, "files": 0},
])
def test_selection_refuses_what_does_not_line_up(ctx):
    assert program.select(run(), ctx) is None


def test_readers_on_hand_made_records(monkeypatch):
    from diarizen_tpu_torch import tracing

    monkeypatch.setattr(tracing, "records", run)
    read = {name: core.metric_reader(name) for name in (
        "dispatch_ms_per_file.serve", "wait_ms_per_file.serve", "reconstruct_ms_per_file.serve",
        "trim_ms_per_trim.serve", "seg_stream_ms_per_audio_min.serve",
        "embed_stream_ms_per_audio_min.serve")}
    assert read["dispatch_ms_per_file.serve"](CTX) == pytest.approx(26.0)  # 20, 24, 28, 32
    assert read["wait_ms_per_file.serve"](CTX) == pytest.approx(2.0)
    assert read["reconstruct_ms_per_file.serve"](CTX) == pytest.approx(5.0)
    # the window's trims, the traced file's too; not the warm-up's
    assert read["trim_ms_per_trim.serve"](CTX) == pytest.approx(200.0)
    # 15 + 30 + 45 + 60 s = 2.5 audio minutes; 4 files x 40 and x 20 stream ms
    assert read["seg_stream_ms_per_audio_min.serve"](CTX) == pytest.approx(64.0)
    assert read["embed_stream_ms_per_audio_min.serve"](CTX) == pytest.approx(32.0)
    for reader in read.values():  # what does not line up reads nothing
        assert reader({**CTX, "cluster_ms": [1.0, 2.0, 3.0, 4.0]}) is None
        assert reader(None) is None


def test_device_readers_without_events_read_nothing(monkeypatch):
    from diarizen_tpu_torch import tracing

    def without_events():
        records = run()
        records[4].seg_stream_ms = records[4].embed_stream_ms = None  # a host-route file
        return records

    # the CPU's records: no events on any file (and here no clustering either)
    monkeypatch.setattr(tracing, "records", lambda: [rec(3, k, device=False) for k in range(7)])
    assert core.metric_reader("wait_ms_per_file.serve")({**CTX, "cluster_ms": []}) == 2.0
    assert core.metric_reader("trim_ms_per_trim.serve")({**CTX, "cluster_ms": []}) is None
    for name in ("seg_stream_ms_per_audio_min.serve", "embed_stream_ms_per_audio_min.serve"):
        assert core.metric_reader(name)({**CTX, "cluster_ms": []}) is None
    monkeypatch.setattr(tracing, "records", without_events)
    for name in ("seg_stream_ms_per_audio_min.serve", "embed_stream_ms_per_audio_min.serve"):
        assert core.metric_reader(name)(CTX) is None
    assert core.metric_reader("dispatch_ms_per_file.serve")(CTX) == pytest.approx(26.0)


def test_a_program_without_records_reads_nothing(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_tracing(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "diarizen_tpu_torch" and fromlist and "tracing" in fromlist:
            raise ImportError("cannot import name 'tracing'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_tracing)
    assert program.program_records() == []
    assert core.metric_reader("wait_ms_per_file.serve")(CTX) is None
