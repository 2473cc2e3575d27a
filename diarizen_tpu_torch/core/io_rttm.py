"""Kaldi-style metadata io: RTTM, UEM, wav.scp (port of
diarizen_tpu/core/io_rttm.py)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

from diarizen_tpu_torch.core.segments import Annotation, Segment, Timeline

PathLike = Union[str, Path]


def _lines(path: PathLike):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith(";"):
                yield line


def load_rttm(path: PathLike) -> Dict[str, Annotation]:
    """Parse an RTTM file into per-recording Annotations."""
    annotations: Dict[str, Annotation] = {}
    for line in _lines(path):
        fields = line.split()
        if fields[0] != "SPEAKER":
            continue
        uri, start, duration = fields[1], float(fields[3]), float(fields[4])
        ann = annotations.setdefault(uri, Annotation(uri=uri))
        ann[Segment(start, start + duration), len(ann)] = fields[7]
    return annotations


def load_uem(path: PathLike) -> Dict[str, Timeline]:
    """Parse a UEM file: `<uri> <channel> <start> <end>` per line."""
    uems: Dict[str, Timeline] = {}
    for line in _lines(path):
        uri, _channel, start, end = line.split()[:4]
        uems.setdefault(uri, Timeline()).add(Segment(float(start), float(end)))
    return uems


def load_scp(path: PathLike) -> Dict[str, str]:
    """Parse wav.scp: `<uri> <path>` per line."""
    out: Dict[str, str] = {}
    for line in _lines(path):
        uri, wav_path = line.split(maxsplit=1)
        out[uri] = wav_path
    return out
