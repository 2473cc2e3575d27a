"""wait_ms_per_file.serve: host milliseconds inside the pipeline's
`diarize.wait` spans (every blocking device-to-host fetch: the fused route's
one `HostFetch.wait`) per file, over the files of the untraced part of a
`--trace 1` window (portbench/program.py)."""

from portbench import program


def read(ctx):
    return program.mean_span_ms(ctx, "diarize.wait")
