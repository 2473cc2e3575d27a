"""trim_ms_per_trim.serve: host milliseconds of each of the pipeline's
`diarize.trim` spans (`stream`'s heap trim, every 10th file) over the files
of a `--trace 1` window, traced ones too, on average. Meetings hold one
trim a run, clips about two dozen (portbench/program.py)."""

from portbench import program


def read(ctx):
    return program.ms_per_span(ctx, "diarize.trim")
