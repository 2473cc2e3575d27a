"""Sliding-window inference and the diarization pipeline."""

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
    "to_diarization", "SlidingInference", "receptive_field_window",
]
