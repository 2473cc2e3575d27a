"""The readers of the segmentation's two stage spans on the stream
(`extract_stream_ms_per_audio_min.serve`, `encode_stream_ms_per_audio_min.serve`)
over hand-made records: the per-audio-minute arithmetic, and None where any
file of the untraced part lacks the field (a program without stages, or one
older than the fields)."""

from dataclasses import dataclass, field

import pytest

from portbench import core

MS = 1_000_000  # ns
READERS = {"extract_stream_ms_per_audio_min.serve": "seg_extract_ms",
           "encode_stream_ms_per_audio_min.serve": "seg_encode_ms"}


@dataclass
class Rec:
    pipeline: int
    file: int
    audio_s: float
    spans: list = field(default_factory=list)
    seg_extract_ms: float = None
    seg_encode_ms: float = None

    def ms(self, name):  # as tracing.FileRecord.ms
        return sum(end - start for n, start, end in self.spans if n == name) / 1e6


def records():
    """One warm-up file, then four untraced files (15, 30, 45 and 60 audio
    seconds, extractor 6 and encoder 20 stream ms each), then a traced one."""
    out = []
    for k in range(6):
        t = k * 10_000 * MS
        r = Rec(3, k, 15.0 * k if 1 <= k <= 4 else 30.0,
                [("diarize.cluster", t, t + (10 + k) * MS)])
        r.seg_extract_ms, r.seg_encode_ms = 6.0 * (k + 1), 20.0 * (k + 1)
        out.append(r)
    return out


CTX = {"workload": {"warm_chunks": [36]}, "files": 4, "cluster_ms": [11.0, 12.0, 13.0, 14.0]}


def test_stage_readers_per_audio_minute(monkeypatch):
    from diarizen_tpu_torch import tracing

    monkeypatch.setattr(tracing, "records", records)
    # files 1-4: 2.5 audio minutes; extractor 12 + 18 + 24 + 30 = 84 ms, encoder 280 ms
    assert core.metric_reader("extract_stream_ms_per_audio_min.serve")(CTX) == pytest.approx(33.6)
    assert core.metric_reader("encode_stream_ms_per_audio_min.serve")(CTX) == pytest.approx(112.0)
    for name in READERS:  # what does not line up reads nothing
        assert core.metric_reader(name)({**CTX, "cluster_ms": [1.0, 2.0, 3.0, 4.0]}) is None
        assert core.metric_reader(name)(None) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_stage_readers_need_every_file(monkeypatch, name):
    from diarizen_tpu_torch import tracing

    def one_without():
        out = records()
        setattr(out[2], READERS[name], None)  # a file of the untraced part
        return out

    monkeypatch.setattr(tracing, "records", one_without)
    assert core.metric_reader(name)(CTX) is None

    @dataclass
    class Older:  # a record from before the fields: no such attribute at all
        pipeline: int
        file: int
        audio_s: float
        spans: list

        def ms(self, n):
            return sum(end - start for m, start, end in self.spans if m == n) / 1e6

    monkeypatch.setattr(tracing, "records", lambda: [Older(r.pipeline, r.file, r.audio_s, r.spans)
                                                     for r in records()])
    assert core.metric_reader(name)(CTX) is None
