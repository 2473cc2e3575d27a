"""The reading of a profiler trace: the slice, the busy union, the idle gaps
by host span, and the per-layer readers on a hand-made trace."""

import pytest

from portbench import core


def kernel(name, ts, dur, grid=None):
    e = {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {}}
    if grid:
        e["args"]["grid"] = list(grid)
    return e


def span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


EVENTS = [
    span(core.SLICE, 1000, 1000),  # the slice: 1000-2000 us
    span("dispatch", 900, 300),
    span("finish", 1400, 500),
    kernel("before", 800, 150),  # wholly before the slice: not read
    kernel("gated_bias_attention_bf16_kernel<64, 1>", 990, 30, (7, 64, 1)),  # cut at the start
    kernel("gated_bias_attention_bf16_kernel<64, 1>", 1100, 100, (7, 96, 1)),
    kernel("gated_bias_attention_bf16_kernel<64, 1>", 1250, 50, (7, 32, 1)),
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1300, "dur": 50},
    kernel("other", 1900, 200),  # cut at the end
]


def test_busy_gaps_and_breakdown():
    t = core.Trace(EVENTS, ("dispatch", "finish", "cluster"))
    assert (t.begin, t.end) == (1e-3, 2e-3)
    # busy: 1000-1020, 1100-1200, 1250-1350, 1900-2000 us
    assert t.busy_s() == pytest.approx(320e-6)
    gaps = t.gaps()
    assert [round(b - a, 9) for a, b in gaps] == [80e-6, 50e-6, 550e-6]
    bd = t.breakdown()
    assert bd["idle_gaps"][0] == ["finish", pytest.approx(550e-6)]
    assert bd["idle_gaps"][1][0] == "dispatch"
    assert len(t.matching(["gated_bias_attention_bf16_kernel"])) == 2  # the cut one is left out


def test_readers_on_the_trace():
    cfg = {"architecture": {"wavlm": {"remaining_heads": [[0, 1, 2], [0]],
                                      "use_attention": [True, True]}}}
    layout = type("L", (), {"frames": 399})()
    peaks = {"hbm_bytes_per_s": 3.35e12, "bf16_flop_per_s": 989e12}
    ctx = {"trace": core.Trace(EVENTS, ()), "config": cfg, "layout": layout, "peaks": peaks,
           "untraced_seconds": 2.0, "untraced_flops": 989e12 * 0.5, "files": 4,
           "cluster_ms": [10.0, 30.0], "latencies": [0.1, 0.2, 0.3, 0.5]}
    assert core.metric_reader("device_idle.serve")(ctx) == pytest.approx(68.0)
    assert core.metric_reader("mfu.serve")(ctx) == pytest.approx(25.0)
    assert core.metric_reader("cluster_ms_per_file.serve")(ctx) == pytest.approx(10.0)
    # 95% of the way from the lowest to the highest of 4: 0.3 + 0.85 * (0.5 - 0.3)
    assert core.metric_reader("file_p95_s.serve")(ctx) == pytest.approx(0.47)
    assert core.metric_reader("file_p95_s.serve")({**ctx, "latencies": []}) is None
    # grids 96 and 32 at heads 3 then 1: one batch of 32
    from portbench import flops

    least = (flops.attention_bound_s(32, 3, 399, 64, 2, peaks)
             + flops.attention_bound_s(32, 1, 399, 64, 2, peaks))
    assert core.metric_reader("k1_roofline.serve")(ctx) == pytest.approx(100 * least / 150e-6)
    assert core.metric_reader("k1_roofline.serve")({**ctx, "trace": core.Trace(
        [span(core.SLICE, 0, 10)], ())}) is None


def test_a_trace_without_a_slice_is_refused():
    with pytest.raises(RuntimeError):
        core.Trace([kernel("k", 0, 1)], ())
