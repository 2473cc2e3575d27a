"""reconstruct_ms_per_file.serve: host milliseconds inside the pipeline's
`diarize.reconstruct` span (reconstruction, binarization, relabelling and
the centroids' alignment after clustering) per file, over the files of the
untraced part of a `--trace 1` window (portbench/program.py)."""

from portbench import program


def read(ctx):
    return program.mean_span_ms(ctx, "diarize.reconstruct")
