"""file_p95_s.serve: the 95th percentile (linear interpolation) of the time
from `DiarizationPipeline.stream` pulling a file's waveform to yielding its
Annotation, over the files of the untraced part of a `--trace 1` window.
Stream's heap trim every few files lands in some of these times, so the tail
swings from run to run more than an end-to-end bound can hold."""

from portbench import core


def read(ctx):
    if not ctx or not ctx.get("latencies"):
        return None
    return core.percentile(ctx["latencies"], 95)
