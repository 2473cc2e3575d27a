"""fuse_stream_ms_per_audio_min.serve: the milliseconds on the card's stream
from the pipeline's CUDA event before each segmentation batch's encoder to
its event after the channel mean (a multi-channel model's positional conv,
cross-channel fusions and WavLM layers on every microphone's stream: the part
of the encoder that runs once a channel), summed over a file's batches (read
after the file's one wait), over the audio minutes of the files of the
untraced part of a `--trace 1` window. A span on the stream, not the card's
busy time. None off the card, for a single-channel model, and for a program
whose records lack the field (portbench/program.py)."""

from portbench import program


def read(ctx):
    return program.stream_ms_per_audio_min(ctx, "seg_fuse_ms")
