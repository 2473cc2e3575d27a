"""seg_stream_ms_per_audio_min.serve: the milliseconds on the card's stream
from the pipeline's CUDA event before a file's segmentation enqueue to its
event after the device stitch's (read after the file's one wait), over the
audio minutes of the files of the untraced part of a `--trace 1` window.
A span on the stream, not the card's busy time: it holds every stretch in
which the card waited for the host to enqueue the stage, so while the
host's launches set the pace it reads that pace. None off the card
(portbench/program.py)."""

from portbench import program


def read(ctx):
    return program.stream_ms_per_audio_min(ctx, "seg_stream_ms")
