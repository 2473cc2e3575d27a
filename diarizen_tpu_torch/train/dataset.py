"""Training data: Kaldi-style inputs -> fixed-shape batches (port of
diarizen_tpu/train/dataset.py).

`wav.scp` (recording -> path), `rttm` and a UEM (recording -> [start, end],
the last span of a recording kept); chunks of `chunk_size` seconds every
`chunk_shift` seconds inside [start + 1, end - 1); the RTTM rasterised to
(num_frames, num_speakers) binary masks at the model's receptive-field
resolution; speakers sorted by talkativeness and padded or cut to
max_speakers_per_chunk; the multi-channel `channel_mode` options. The loader
yields numpy batches of static shape (drop_last), shuffled per epoch with
`default_rng(seed + epoch)`, striped by (rank, world_size), with a
background thread one batch ahead. Waveforms stay float32.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from diarizen_tpu_torch.core.audio import read_audio
from diarizen_tpu_torch.core.io_rttm import load_scp


def load_uem_spans(uem_file: str) -> Dict[str, Tuple[float, float]]:
    """recording -> (start_sec, end_sec), the last span per recording."""
    spans = {}
    with open(uem_file) as f:
        for line in f:
            parts = line.split()
            spans[parts[0]] = (float(parts[-2]), float(parts[-1]))
    return spans


def gen_chunk_indices(start_sec: float, end_sec: float, size: float, step: float):
    """`size`-second windows every `step` seconds in [start + 1, end - 1)."""
    init = int(start_sec + 1)
    end = int(end_sec - 1)
    cur_len = end - init
    if cur_len <= size:
        return
    for i in range(int((cur_len - size + step) / step)):
        yield init + i * step, init + i * step + size


def parse_rttm_to_array(rttm_file: str, session_order: List[str]) -> np.ndarray:
    """RTTM -> structured array (session_idx, start, end, label_idx); labels
    are indexed per session in order of first appearance."""
    session_idx_map = {s: i for i, s in enumerate(session_order)}
    per_session_labels: Dict[str, Dict[str, int]] = {}
    rows = []
    with open(rttm_file) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] != "SPEAKER":
                continue
            session, start, dur = parts[1], float(parts[3]), float(parts[4])
            spk = parts[7] if parts[7] != "<NA>" else parts[6]
            if session not in session_idx_map:
                continue
            labels = per_session_labels.setdefault(session, {})
            labels.setdefault(spk, len(labels))
            rows.append((session_idx_map[session], start, start + dur, labels[spk]))
    return np.array(
        rows, dtype=[("session_idx", "i4"), ("start", "f4"), ("end", "f4"), ("label_idx", "i4")])


@dataclass
class DiarizationDataset:
    """Chunked diarization dataset over Kaldi-style files."""

    scp_file: str
    rttm_file: str
    uem_file: str
    model_num_frames: int
    model_rf_duration: float
    model_rf_step: float
    chunk_size: float = 8.0
    chunk_shift: float = 6.0
    sample_rate: int = 16000
    num_channels: int = 1
    channel_mode: str = "sdm"  # sdm | random | average | multichannel
    # "pad" zero-pads reads truncated at the end of a file; "resample" draws
    # another chunk instead
    short_chunk_mode: str = "pad"

    def __post_init__(self):
        self.rec_scp = load_scp(self.scp_file)
        self.sessions = list(self.rec_scp.keys())
        self.reco2span = load_uem_spans(self.uem_file)
        self.chunk_indices: List[Tuple[str, str, float, float]] = []
        for rec, (start, end) in self.reco2span.items():
            if rec not in self.rec_scp:
                continue
            if self.chunk_size > 0:
                for st, ed in gen_chunk_indices(start, end, self.chunk_size, self.chunk_shift):
                    self.chunk_indices.append((rec, self.rec_scp[rec], st, ed))
            else:
                self.chunk_indices.append((rec, self.rec_scp[rec], start, end))
        self.annotations = parse_rttm_to_array(self.rttm_file, self.sessions)

    def __len__(self) -> int:
        return len(self.chunk_indices)

    def _read_chunk(self, path: str, start: float, end: float, rng,
                    pad_short: bool = True) -> np.ndarray:
        s0 = int(start * self.sample_rate)
        n = int(end * self.sample_rate) - s0
        data, sr = read_audio(path, start_frame=s0, num_frames=n)
        if sr != self.sample_rate:
            raise ValueError(f"{path}: sample rate {sr}, expected {self.sample_rate}")
        if data.shape[1] < n and pad_short:
            data = np.pad(data, ((0, 0), (0, n - data.shape[1])))
        c = data.shape[0]
        mode = self.channel_mode
        if mode == "sdm" or c == 1:
            data = data[:1]
        elif mode == "random":
            data = data[rng.integers(0, c)][None] if rng is not None else data[:1]
        elif mode == "average":
            data = data.mean(axis=0, keepdims=True)
        elif mode == "multichannel":
            if c >= self.num_channels:
                data = data[: self.num_channels]
            else:
                data = np.pad(data, ((0, self.num_channels - c), (0, 0)), mode="wrap")
        else:
            raise ValueError(f"unknown channel_mode {mode}")
        return data.astype(np.float32)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        session, path, chunk_start, chunk_end = self.chunk_indices[idx]
        if self.short_chunk_mode == "resample":
            def expected_len(start, end):
                return int(end * self.sample_rate) - int(start * self.sample_rate)

            local_rng = rng if rng is not None else np.random.default_rng(idx)
            for _ in range(100):
                data = self._read_chunk(path, chunk_start, chunk_end, rng, pad_short=False)
                if data.shape[1] == expected_len(chunk_start, chunk_end):
                    break
                idx = int(local_rng.integers(0, len(self.chunk_indices)))
                session, path, chunk_start, chunk_end = self.chunk_indices[idx]
            else:
                raise RuntimeError(
                    "short_chunk_mode='resample': no full-length chunk found in 100 "
                    "draws; check the UEM against the audio lengths")
        else:
            data = self._read_chunk(path, chunk_start, chunk_end, rng)

        session_idx = self.sessions.index(session)
        ann = self.annotations[self.annotations["session_idx"] == session_idx]
        chunked = ann[(ann["start"] < chunk_end) & (ann["end"] > chunk_start)]

        # rasterise at the model's receptive-field resolution
        step = self.model_rf_step
        half = 0.5 * self.model_rf_duration
        start = np.maximum(chunked["start"], chunk_start) - chunk_start - half
        start_idx = np.maximum(0, np.round(start / step)).astype(int)
        end = np.minimum(chunked["end"], chunk_end) - chunk_start - half
        end_idx = np.round(end / step).astype(int)

        labels = list(np.unique(chunked["label_idx"]))
        mask = np.zeros((self.model_num_frames, max(len(labels), 1)), dtype=np.uint8)
        mapping = {label: i for i, label in enumerate(labels)}
        for s, e, label in zip(start_idx, end_idx, chunked["label_idx"]):
            mask[s: min(e + 1, self.model_num_frames), mapping[label]] = 1
        return data, mask, session


def collate(batch, max_speakers_per_chunk: int = 4) -> Dict[str, np.ndarray]:
    """Stack (waveform, mask, session) items: speakers sorted by
    talkativeness and cut, or zero-padded, to max_speakers_per_chunk.
    Returns {"xs": float32 (B, C, N), "target": uint8 (B, F, K), "names"}."""
    xs, ys, names = [], [], []
    for x, y, name in batch:
        k = y.shape[-1]
        if k > max_speakers_per_chunk:
            order = np.argsort(-np.sum(y, axis=0), axis=0)
            y = y[:, order[:max_speakers_per_chunk]]
        elif k < max_speakers_per_chunk:
            y = np.pad(y, ((0, 0), (0, max_speakers_per_chunk - k)))
        xs.append(x)
        ys.append(y)
        names.append(name)
    return {"xs": np.stack(xs).astype(np.float32), "target": np.stack(ys).astype(np.uint8),
            "names": names}


class DataLoader:
    """Static-shape batch iterator with epoch shuffling, index striping by
    (rank, world_size), and one background thread that reads ahead."""

    def __init__(self, dataset: DiarizationDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 3407, max_speakers_per_chunk: int = 4, rank: int = 0,
                 world_size: int = 1, drop_last: bool = True, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.max_speakers = max_speakers_per_chunk
        self.rank = rank
        self.world_size = world_size
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset) // self.world_size
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx[self.rank:: self.world_size]

    def _produce(self, out_q: queue.Queue) -> None:
        rng = np.random.default_rng(self.seed * 7919 + self.epoch)
        idx = self._indices()
        try:
            for b in range(len(self)):
                rows = idx[b * self.batch_size: (b + 1) * self.batch_size]
                out_q.put(collate([self.dataset.__getitem__(int(i), rng=rng) for i in rows],
                                  self.max_speakers))
        except Exception as exc:  # handed to the consumer, which raises it
            out_q.put(exc)
        finally:
            out_q.put(None)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._produce, args=(q,), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                t.join()
                raise item
            yield item
        t.join()
