"""Sliding-window inference, the device-side stitch and the diarization pipeline."""

from diarizen_tpu_torch.infer.fused import FusedStitch, make_fused_stitch
from diarizen_tpu_torch.infer.pipeline import (
    DiarizationPipeline,
    EmbeddingInference,
    reconstruct,
    speaker_count,
    to_diarization,
)
from diarizen_tpu_torch.infer.sliding import SlidingInference, receptive_field_window

__all__ = [
    "DiarizationPipeline", "EmbeddingInference", "reconstruct", "speaker_count",
    "to_diarization", "SlidingInference", "receptive_field_window", "FusedStitch",
    "make_fused_stitch",
]
