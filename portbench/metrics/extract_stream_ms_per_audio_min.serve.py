"""extract_stream_ms_per_audio_min.serve: the milliseconds on the card's
stream from the pipeline's CUDA event before each segmentation batch's
extractor (the waveform's norm, the conv stack with its norms and GELUs,
the feature projection) to its event before the encoder, summed over a
file's batches (read after the file's one wait), over the audio minutes of
the files of the untraced part of a `--trace 1` window. A span on the
stream, not the card's busy time: it holds every stretch in which the card
waited for the host to enqueue the stage. None off the card, and for a
program whose records lack the field (portbench/program.py)."""

from portbench import program


def read(ctx):
    return program.stream_ms_per_audio_min(ctx, "seg_extract_ms")
