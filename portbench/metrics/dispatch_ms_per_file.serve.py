"""dispatch_ms_per_file.serve: host milliseconds inside the pipeline's
`diarize.dispatch` span (`DiarizationPipeline._dispatch_file`: enqueueing a
file's segmentation, stitch and embeddings) per file, over the files of the
untraced part of a `--trace 1` window (portbench/program.py)."""

from portbench import program


def read(ctx):
    return program.mean_span_ms(ctx, "diarize.dispatch")
