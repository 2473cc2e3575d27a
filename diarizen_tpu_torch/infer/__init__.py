"""Sliding-window inference, the device-side stitch, the diarization
pipeline (single- and multi-channel models) and the frame-level pipelines
(VAD, OSD, multi-label, resegmentation)."""

from diarizen_tpu_torch.infer.fused import FusedStitch, make_fused_stitch
from diarizen_tpu_torch.infer.multilabel import MultiLabelSegmentation
from diarizen_tpu_torch.infer.pipeline import (
    DiarizationPipeline,
    EmbeddingInference,
    reconstruct,
    speaker_count,
    to_diarization,
)
from diarizen_tpu_torch.infer.resegmentation import Resegmentation
from diarizen_tpu_torch.infer.sliding import SlidingInference, receptive_field_window
from diarizen_tpu_torch.infer.vad import OverlappedSpeechDetection, VoiceActivityDetection

__all__ = [
    "DiarizationPipeline", "EmbeddingInference", "reconstruct", "speaker_count",
    "to_diarization", "SlidingInference", "receptive_field_window", "FusedStitch",
    "make_fused_stitch", "MultiLabelSegmentation", "Resegmentation",
    "VoiceActivityDetection", "OverlappedSpeechDetection",
]
