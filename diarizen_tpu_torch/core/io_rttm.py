"""Kaldi-style metadata io: RTTM, UEM, wav.scp (port of
diarizen_tpu/core/io_rttm.py)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Tuple, Union

import numpy as np

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


def write_rttm(path: PathLike, annotations: Iterable[Annotation]) -> None:
    """Write Annotations to one RTTM file, in the given order."""
    with open(path, "w") as f:
        for ann in annotations:
            f.write(ann.to_rttm())


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


def rttm_to_arrays(
    annotations: Dict[str, Annotation],
) -> Tuple[np.ndarray, List[str], Dict[str, List[str]]]:
    """Flatten RTTM annotations into one structured array for fast chunk
    cropping during training.

    Returns (data, sessions, speakers): `data` has the fields session_idx
    (int32), start, end (float64) and speaker_idx (int32); `sessions` lists the uris
    in sorted order (index = session_idx); `speakers[uri]` lists the
    session's speakers in sorted order (index = speaker_idx)."""
    sessions = sorted(annotations)
    speakers: Dict[str, List[str]] = {}
    rows = []
    for si, uri in enumerate(sessions):
        ann = annotations[uri]
        speakers[uri] = ann.labels()
        spk_index = {s: i for i, s in enumerate(speakers[uri])}
        rows += [(si, seg.start, seg.end, spk_index[label])
                 for seg, _, label in ann.itertracks()]
    dtype = np.dtype([("session_idx", np.int32), ("start", np.float64),
                      ("end", np.float64), ("speaker_idx", np.int32)])
    return np.array(rows, dtype=dtype), sessions, speakers
