"""Audio io (port of diarizen_tpu/core/audio.py).

WAV files (any PCM width or IEEE float) are read with the standard library's
byte layout and numpy, with random access by `start_frame` / `num_frames`,
into float32 in [-1, 1]; FLAC files through the native decoder of
`core/flac.py`. `read_audio` and `get_audio_info` choose by the file name's
suffix, or, for a file object, by the `fLaC` magic. `Audio` adds downmix,
resampling and padded crops.
"""

from __future__ import annotations

import wave
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
from scipy.signal import resample_poly

from diarizen_tpu_torch.core.flac import get_flac_info, read_flac
from diarizen_tpu_torch.core.segments import Segment


def read_wav(path, start_frame: int = 0,
             num_frames: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read a WAV file (path or seekable binary file object) into float32
    (channels, samples) in [-1, 1]; returns (waveform, sample_rate)."""
    if hasattr(path, "read"):
        path.seek(0)
        return _read_wav_stream(path, "<file-like>", start_frame, num_frames)
    with open(path, "rb") as fh:
        return _read_wav_stream(fh, str(path), start_frame, num_frames)


def _read_wav_stream(fh, name: str, start_frame: int,
                     num_frames: Optional[int]) -> Tuple[np.ndarray, int]:
    header = fh.read(12)
    if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
        raise ValueError(f"{name}: not a RIFF/WAVE file")
    fmt = data_offset = data_size = None
    while True:
        chunk_header = fh.read(8)
        if len(chunk_header) < 8:
            break
        chunk_id = chunk_header[:4]
        chunk_size = int.from_bytes(chunk_header[4:8], "little")
        if chunk_id == b"fmt ":
            fmt_bytes = fh.read(chunk_size)
            audio_format = int.from_bytes(fmt_bytes[0:2], "little")
            channels = int.from_bytes(fmt_bytes[2:4], "little")
            sample_rate = int.from_bytes(fmt_bytes[4:8], "little")
            bits = int.from_bytes(fmt_bytes[14:16], "little")
            if audio_format == 0xFFFE and chunk_size >= 40:  # extensible
                audio_format = int.from_bytes(fmt_bytes[24:26], "little")
            fmt = (audio_format, channels, sample_rate, bits)
            if chunk_size & 1:
                fh.seek(1, 1)
        elif chunk_id == b"data":
            data_offset, data_size = fh.tell(), chunk_size
            fh.seek(chunk_size + (chunk_size & 1), 1)
        else:
            fh.seek(chunk_size + (chunk_size & 1), 1)
    if fmt is None or data_offset is None:
        raise ValueError(f"{name}: missing fmt/data chunk")
    audio_format, channels, sample_rate, bits = fmt
    bytes_per_frame = channels * bits // 8
    total_frames = data_size // bytes_per_frame
    if num_frames is None:
        num_frames = total_frames - start_frame
    num_frames = max(0, min(num_frames, total_frames - start_frame))
    fh.seek(data_offset + start_frame * bytes_per_frame)
    raw = fh.read(num_frames * bytes_per_frame)

    if audio_format == 3:  # IEEE float
        x = np.frombuffer(raw, dtype=np.float32 if bits == 32 else np.float64).astype(np.float32)
    elif audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
            x = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
            x = np.where(x >= (1 << 23), x - (1 << 24), x).astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"unsupported PCM width: {bits}")
    else:
        raise ValueError(f"unsupported WAV format code: {audio_format}")
    return np.ascontiguousarray(x.reshape(-1, channels).T), sample_rate


def _is_flac(path) -> bool:
    """A file object by its first four bytes, a path by its suffix."""
    if hasattr(path, "read"):
        path.seek(0)
        magic = path.read(4)
        path.seek(0)
        return magic == b"fLaC"
    return Path(path).suffix.lower() == ".flac"


def read_audio(path, start_frame: int = 0,
               num_frames: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read a WAV or FLAC file (path or seekable file object) into float32
    (channels, samples); other formats raise."""
    if _is_flac(path):
        return read_flac(path, start_frame=start_frame, num_frames=num_frames)
    if not hasattr(path, "read") and Path(path).suffix.lower() not in (".wav", ".wave"):
        raise ValueError(
            f"{path}: only WAV and FLAC are decoded by diarizen_tpu_torch; convert to WAV "
            "(e.g. ffmpeg -i in.mp3 out.wav)")
    return read_wav(path, start_frame=start_frame, num_frames=num_frames)


def get_wav_info(path) -> Tuple[int, int, int]:
    """(num_samples, sample_rate, num_channels) without reading the payload."""
    if hasattr(path, "read"):
        path.seek(0)
        with wave.open(path, "rb") as w:
            return w.getnframes(), w.getframerate(), w.getnchannels()
    with wave.open(str(path), "rb") as w:
        return w.getnframes(), w.getframerate(), w.getnchannels()


def get_audio_info(path) -> Tuple[int, int, int]:
    """(num_samples, sample_rate, num_channels) of a WAV or FLAC file, from
    its header."""
    if _is_flac(path):
        return get_flac_info(path)
    return get_wav_info(path)


def write_wav(path, waveform: np.ndarray, sample_rate: int) -> None:
    """Write a float waveform (channels, samples) or (samples,) as PCM16."""
    if waveform.ndim == 1:
        waveform = waveform[None]
    pcm = np.clip(waveform.T * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(waveform.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def resample(waveform: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling along the last axis; float32 out."""
    if orig_sr == target_sr:
        return waveform
    g = np.gcd(orig_sr, target_sr)
    return resample_poly(waveform, target_sr // g, orig_sr // g, axis=-1).astype(np.float32)


@dataclass
class Audio:
    """File loader with resample + downmix + padded crop.

    mono: None keeps all channels; "downmix" averages channels; "random"
    picks one channel at random (training-time augmentation, deterministic
    under `rng`)."""

    sample_rate: int = 16000
    mono: Optional[str] = "downmix"
    rng: Optional[np.random.Generator] = None

    def _post(self, waveform: np.ndarray, sr: int) -> np.ndarray:
        if waveform.shape[0] > 1:
            if self.mono == "downmix":
                waveform = waveform.mean(axis=0, keepdims=True)
            elif self.mono == "random":
                rng = self.rng if self.rng is not None else np.random.default_rng()
                ch = int(rng.integers(waveform.shape[0]))
                waveform = waveform[ch: ch + 1]
        if sr != self.sample_rate:
            waveform = resample(waveform, sr, self.sample_rate)
        return waveform.astype(np.float32)

    def __call__(self, path) -> Tuple[np.ndarray, int]:
        waveform, sr = read_audio(path)
        return self._post(waveform, sr), self.sample_rate

    def get_duration(self, path) -> float:
        n, sr, _ = get_audio_info(path)
        return n / sr

    def crop(self, path, segment: Segment, duration: Optional[float] = None,
             mode: str = "pad") -> Tuple[np.ndarray, int]:
        """Extract `segment` (optionally forced to `duration` seconds);
        mode="pad" zero-pads the parts that lie outside the file."""
        n_total, file_sr, _ = get_audio_info(path)
        start = int(round(segment.start * file_sr))
        if duration is None:
            duration = segment.duration
        num = int(round(duration * file_sr))
        read_start = max(0, start)
        read_end = min(n_total, start + num)
        waveform, sr = read_audio(path, read_start, max(0, read_end - read_start))
        pad_left = max(0, -start)
        pad_right = num - pad_left - waveform.shape[-1]
        if mode == "pad" and (pad_left > 0 or pad_right > 0):
            waveform = np.pad(waveform, ((0, 0), (pad_left, max(0, pad_right))))
        return self._post(waveform, sr), self.sample_rate
