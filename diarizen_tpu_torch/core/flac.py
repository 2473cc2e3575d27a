"""Native FLAC decoding through a small C++ library loaded with ctypes (port
of diarizen_tpu/core/flac.py).

`core/_flac/flacdec.cpp` is a self-contained FLAC bitstream decoder. It is
compiled at first use with `g++ -O2 -shared -fPIC` into
`build/diarizen_tpu_torch/`, under a name keyed on a hash of the source, so a
changed source builds anew; the library is renamed into place, so processes
that build at the same time all load a whole file. A host without g++
raises. The decoder is host code.

- `read_flac` -> (float32 (channels, samples), sample_rate)
- `get_flac_info` -> (num_samples, sample_rate, num_channels)

FLAC has no per-sample random access, so a cropped read decodes the whole
file once and keeps it in a small byte-bounded cache: the training dataset's
per-chunk reads then cost one decode per file, not per chunk.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from diarizen_tpu_torch.ops.cuda_build import BUILD_DIR

_SRC = Path(__file__).parent / "_flac" / "flacdec.cpp"
_LOCK = threading.Lock()
_LIB = None

_ERRORS = {
    -1: "bad magic / truncated metadata",
    -2: "missing STREAMINFO",
    -3: "bad frame header / lost sync",
    -4: "bad subframe or residual",
    -5: "frame header CRC-8 mismatch",
    -6: "frame CRC-16 mismatch",
    -7: "allocation failure",
}


def library_path() -> Path:
    """Where the decoder library of the current source lives."""
    tag = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libflacdec_{tag}.so"


def _build_library() -> Path:
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(suffix=".so", dir=BUILD_DIR, delete=False) as tmp:
        tmp_path = tmp.name
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp_path, str(_SRC)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp_path, lib_path)  # atomic: concurrent builds both win
    except FileNotFoundError:
        os.unlink(tmp_path)
        raise RuntimeError(
            "FLAC decoding needs g++ to build the native decoder "
            f"({_SRC}); install g++ or convert the file to WAV") from None
    except subprocess.CalledProcessError as e:
        os.unlink(tmp_path)
        raise RuntimeError(f"FLAC decoder build failed:\n{e.stderr}") from None
    return lib_path


def _lib():
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(str(_build_library()))
                lib.flac_decode.restype = ctypes.c_int
                lib.flac_decode.argtypes = [
                    ctypes.c_char_p,
                    ctypes.c_int64,
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                ]
                lib.flac_free.restype = None
                lib.flac_free.argtypes = [ctypes.POINTER(ctypes.c_int32)]
                _LIB = lib
    return _LIB


def decode_flac_bytes(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Decode a FLAC byte string -> (int32 (channels, samples), rate, bits)."""
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_int32)()
    frames, channels = ctypes.c_int64(), ctypes.c_int32()
    rate, bits = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.flac_decode(data, len(data), ctypes.byref(out), ctypes.byref(frames),
                         ctypes.byref(channels), ctypes.byref(rate), ctypes.byref(bits))
    if rc != 0:
        raise ValueError(f"FLAC decode failed: {_ERRORS.get(rc, rc)}")
    try:
        n = frames.value * channels.value
        interleaved = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.flac_free(out)
    x = interleaved.reshape(frames.value, channels.value).T
    return np.ascontiguousarray(x), rate.value, bits.value


def _read_all_bytes(path) -> bytes:
    if hasattr(path, "read"):
        path.seek(0)
        return path.read()
    return Path(path).read_bytes()


# Decoded waveforms, least recently used first, keyed by (path, mtime, size);
# file objects are not cached. Bounded in bytes (an hour of 16 kHz mono
# float32 is about 230 MB, so a count of files could pin gigabytes across
# data-loader workers); DIARIZEN_FLAC_CACHE_MB=0 turns the cache off.
_CACHE: "OrderedDict[tuple, Tuple[np.ndarray, int]]" = OrderedDict()
_CACHE_MAX_BYTES = int(os.environ.get("DIARIZEN_FLAC_CACHE_MB", "512")) * (1 << 20)
_CACHE_BYTES = 0


def _decode_cached(path) -> Tuple[np.ndarray, int]:
    global _CACHE_BYTES
    key = None
    if not hasattr(path, "read"):
        st = os.stat(path)
        key = (str(path), st.st_mtime_ns, st.st_size)
        with _LOCK:
            if key in _CACHE:
                _CACHE.move_to_end(key)
                return _CACHE[key]
    x, rate, bits = decode_flac_bytes(_read_all_bytes(path))
    wave = (x.astype(np.float32) / float(1 << (bits - 1))).astype(np.float32)
    wave.flags.writeable = False  # callers get copies; the cache stays as decoded
    if key is not None and wave.nbytes <= _CACHE_MAX_BYTES:
        with _LOCK:
            _CACHE[key] = (wave, rate)
            _CACHE_BYTES += wave.nbytes
            while _CACHE_BYTES > _CACHE_MAX_BYTES and _CACHE:
                _, (old, _rate) = _CACHE.popitem(last=False)
                _CACHE_BYTES -= old.nbytes
    return wave, rate


def read_flac(path, start_frame: int = 0,
              num_frames: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read a FLAC file (path or seekable binary file object) into float32
    in [-1, 1]: ((channels, samples), sample_rate)."""
    wave, rate = _decode_cached(path)
    total = wave.shape[-1]
    if num_frames is None:
        num_frames = total - start_frame
    start = max(0, min(start_frame, total))
    stop = max(start, min(start_frame + num_frames, total))
    # always a copy: a full-range slice would alias the read-only cached array
    return wave[:, start:stop].copy(), rate


def get_flac_info(path) -> Tuple[int, int, int]:
    """(num_samples, sample_rate, num_channels) from STREAMINFO only."""
    if hasattr(path, "read"):
        path.seek(0)
        head = path.read(256)
    else:
        with open(path, "rb") as fh:
            head = fh.read(256)
    if head[:4] != b"fLaC":
        raise ValueError(f"{path}: not a FLAC file")
    pos = 4
    while pos + 4 <= len(head):
        hdr = head[pos]
        length = int.from_bytes(head[pos + 1: pos + 4], "big")
        pos += 4
        if hdr & 0x7F == 0:  # STREAMINFO
            s = head[pos: pos + 34]
            rate = (s[10] << 12) | (s[11] << 4) | (s[12] >> 4)
            channels = ((s[12] >> 1) & 0x7) + 1
            total = ((s[13] & 0x0F) << 32) | int.from_bytes(s[14:18], "big")
            return total, rate, channels
        pos += length
        if hdr & 0x80:
            break
    raise ValueError(f"{path}: missing STREAMINFO")
