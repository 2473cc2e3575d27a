"""The serving pipeline's own per-file records (`diarizen_tpu_torch.tracing`)
of a `--trace 1` window, for the readers of the metrics that time the
program from inside.

The newest pipeline's records are the run's: the warm-up files
(`warm_chunks`, one a shape) come first, then the window's files in the
order they finished. The untraced part is the `files` after the warm-up.
The records stand only where both sides line up: as many records as the
benchmark counted, and their `diarize.cluster` spans within 1 ms, call for
call, of the benchmark's own clock around the same clustering calls
(`cluster_ms`). A program without the records (an older one) gives None.
"""

from __future__ import annotations

CLUSTER_MS_TOLERANCE = 1.0


def window(records: list, ctx: dict):
    """The records of the window's files (the untraced part first), or None
    where the untraced part does not line up with the benchmark's count."""
    if not records or not ctx or not ctx.get("files") or ctx.get("cluster_ms") is None:
        return None
    newest = records[-1].pipeline
    run = [r for r in records if r.pipeline == newest][len(ctx["workload"]["warm_chunks"]):]
    chosen = run[:ctx["files"]]
    if len(chosen) != ctx["files"]:
        return None
    clustered = [r.ms("diarize.cluster") for r in chosen
                 if any(n == "diarize.cluster" for n, _, _ in r.spans)]
    if len(clustered) != len(ctx["cluster_ms"]) or any(
            abs(a - b) > CLUSTER_MS_TOLERANCE for a, b in zip(clustered, ctx["cluster_ms"])):
        return None
    return run


def select(records: list, ctx: dict):
    """The records of the untraced part of the window, or None."""
    run = window(records, ctx)
    return run[:ctx["files"]] if run else None


def program_records() -> list:
    """The program's records; none for a program that keeps none."""
    try:
        from diarizen_tpu_torch import tracing
    except ImportError:
        return []
    return tracing.records()


def mean_span_ms(ctx: dict, name: str):
    """Host milliseconds of the spans called `name` over the untraced
    part's files, per file."""
    chosen = select(program_records(), ctx)
    if not chosen:
        return None
    return sum(r.ms(name) for r in chosen) / len(chosen)


def ms_per_span(ctx: dict, name: str):
    """Host milliseconds of each span called `name` in the window's files,
    traced ones too, on average; None where there is none."""
    run = window(program_records(), ctx)
    spans = [end - start for r in run or () for n, start, end in r.spans if n == name]
    return sum(spans) / len(spans) / 1e6 if spans else None


def stream_ms_per_audio_min(ctx: dict, field: str):
    """A stage's stream milliseconds (a record field) over the untraced
    part's audio minutes; None unless every file has them."""
    chosen = select(program_records(), ctx)
    if not chosen or any(getattr(r, field, None) is None for r in chosen):
        return None
    minutes = sum(r.audio_s for r in chosen) / 60.0
    return sum(getattr(r, field) for r in chosen) / minutes if minutes > 0 else None
