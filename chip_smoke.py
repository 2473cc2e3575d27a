"""Smoke run of the PyTorch/CUDA port (diarizen_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the last line is printed):
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build kernel K1 (csrc/gated_bias_attention.cu) with nvcc;
  3. K1 against its plain PyTorch version on the card at the main path's
     shapes, with CUDA-event timings of the kernel, the plain version and
     one PyTorch call computing the same function (yardstick only);
  4. the slice: DiariZen-Base-s80 EEND and the WeSpeaker ResNet34 at full
     width with seeded random weights; the card's output checked against
     the CPU's on two windows; then a 120 s synthetic two-speaker file
     through DiarizationPipeline once to warm up and once timed, counting
     K1's launches over the timed call;
  5. one more pipeline call under torch.profiler: device time by kernel and
     the device's busy share;
  6. a JSON line with the kernels' numbers, the nvidia-smi line, and a last
     JSON line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from diarizen_tpu_torch.cluster import AgglomerativeClustering
from diarizen_tpu_torch.infer import DiarizationPipeline, EmbeddingInference, SlidingInference
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.convert import random_state_dict
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.fbank import wespeaker_fbank
from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig
from diarizen_tpu_torch.models.wavlm import WavLMConfig
from diarizen_tpu_torch.ops import flash_attention as k1

# H100 SXM data-sheet peaks (dense): HBM bandwidth and bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

BATCH, FRAMES, HEAD_DIM = 32, 399, 64  # one segmentation batch of 8 s windows
AUDIO_SECONDS = 120


def make_wave(dur_s: int, sr: int = 16000) -> np.ndarray:
    """Synthetic two-speaker meeting, quantised like PCM16 (bench.py's)."""
    t = np.arange(dur_s * sr) / sr
    wave = np.zeros_like(t, dtype=np.float32)
    rng = np.random.default_rng(0)
    pos, spk = 0.0, 0
    while pos < dur_s - 2:
        seg = rng.uniform(2.0, 6.0)
        m = (t >= pos) & (t < pos + seg)
        f = 180 + 90 * spk
        wave[m] += 0.2 * np.sin(2 * np.pi * f * t[m]).astype(np.float32)
        wave[m] += 0.01 * rng.standard_normal(int(m.sum())).astype(np.float32)
        pos += seg * rng.uniform(0.6, 1.0)
        spk = 1 - spk
    wave = np.clip(np.rint(wave * 32767.0), -32768, 32767) / 32768.0
    return wave[None].astype(np.float32)


@contextlib.contextmanager
def strict_float32():
    """float32 stays float32 inside: no TF32 in matrix products or
    convolutions (cuDNN takes TF32 for float32 convolutions by default)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


def median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of per-launch CUDA-event times; the 50 MB L2 is overwritten
    before each timed launch, as the main path finds it cold."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def attention_inputs(b, h, t, d, dtype, gen):
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    pos = torch.randn((h, t, t), generator=gen, device="cuda").to(dtype)
    gate = 1.0 + torch.rand((b, h, t), generator=gen, device="cuda")  # the GRU gate's range
    return q, k, v, pos, gate


def attention_bound_s(b, h, t, d, itemsize) -> tuple:
    """(bytes / HBM rate, flops / bf16 peak) for one launch: q, k, v read and
    o written once, the bias and gate read once; two T x T x D products."""
    moved = 4 * b * h * t * d * itemsize + h * t * t * itemsize + b * h * t * 4
    flops = 4 * b * h * t * t * d
    return moved / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S


def library_attention(q, k, v, pos, gate):
    """One PyTorch call computing K1's function: timed as a yardstick only."""
    return F.scaled_dot_product_attention(q, k, v, attn_mask=(gate[..., None] * pos).to(q.dtype))


def phase_kernel(heads_per_layer) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    tolerance = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # unit-scale inputs
    cases = [(BATCH, h, FRAMES) for h in (1, 2, 5)] + [(BATCH, 2, 37), (BATCH, 2, 799)]
    slice_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, t in cases:
            args = attention_inputs(b, h, t, HEAD_DIM, dtype, gen)
            got = k1.flash_attention_gated_bias(*args)
            torch.cuda.synchronize()
            want = k1.flash_attention_gated_bias_reference(*args)
            err = (got.float() - want.float()).abs().max().item()
            print(f"K1 vs plain {str(dtype)[6:]} B={b} H={h} T={t} D={HEAD_DIM}: "
                  f"max abs err {err:.3e} (tolerance {tolerance[dtype]:.0e})")
            check(np.isfinite(err) and err <= tolerance[dtype],
                  f"K1 disagrees with its plain version: {err} at {dtype} H={h} T={t}")
            if dtype == torch.bfloat16 and t == FRAMES:
                slice_err = max(slice_err, err)

    # timings at the slice's shapes: the 10 attention layers of one batch
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    by_bytes = by_flops = 0.0
    for h in heads_per_layer:
        args = attention_inputs(BATCH, h, FRAMES, HEAD_DIM, torch.bfloat16, gen)
        row = {
            "ms": median_ms(lambda: k1.flash_attention_gated_bias(*args)),
            "plain_ms": median_ms(lambda: k1.flash_attention_gated_bias_reference(*args)),
            "library_ms": median_ms(lambda: library_attention(*args)),
        }
        mem_s, op_s = attention_bound_s(BATCH, h, FRAMES, HEAD_DIM, 2)
        by_bytes += mem_s
        by_flops += op_s
        print(f"K1 bf16 B={BATCH} H={h} T={FRAMES}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
              f"bound {1e3 * max(mem_s, op_s):.4f} ms")
        for key in totals:
            totals[key] += row[key]
    return {
        "name": "gated_bias_attention",
        "route": "cuda",
        "source": "diarizen_tpu_torch/csrc/gated_bias_attention.cu",
        "replaces": "diarizen_tpu/ops/flash_attention.py:201",
        "max_abs_err": slice_err,
        # times and bound: one segmentation batch, all its attention layers
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": 1e3 * max(by_bytes, by_flops),
        "bound_by": "bytes" if by_bytes >= by_flops else "operations",
        "library_ms": totals["library_ms"],
    }


def phase_reference(eend_sd, resnet_sd, eend_cfg, wave) -> None:
    """The card's float32 output (kernel path) against the CPU's (plain
    path) on two 8 s windows, for the segmentation scores and the masked
    embeddings."""
    windows = torch.from_numpy(np.stack([wave[0, :128000], wave[0, 12800:140800]]))
    scores = {}
    for device in ("cpu", "cuda"):
        model = EendModel(eend_cfg)
        model.load_state_dict(eend_sd)
        with torch.inference_mode():
            scores[device] = model.to(device).eval()(windows.to(device)).cpu()
    err = (scores["cuda"] - scores["cpu"]).abs().max().item()
    print(f"EEND f32 card vs CPU: scores {tuple(scores['cuda'].shape)}, max abs err {err:.3e}")
    check(scores["cuda"].shape == (2, 399, eend_cfg.num_powerset_classes), "EEND shape")
    check(bool(torch.isfinite(scores["cuda"]).all()) and err <= 1e-3,
          f"EEND output on the card disagrees with the CPU: {err}")

    fbank = wespeaker_fbank(windows)
    weights = torch.from_numpy((np.random.default_rng(2).uniform(size=(2, 4, 399)) > 0.5)
                               .astype(np.float32))
    embs = {}
    for device in ("cpu", "cuda"):
        resnet = ResNet(ResNetConfig())
        resnet.load_state_dict(resnet_sd)
        with torch.inference_mode():
            embs[device] = resnet.to(device).eval()(fbank.to(device), weights.to(device)).cpu()
    err = (embs["cuda"] - embs["cpu"]).abs().max().item()
    print(f"ResNet34 f32 card vs CPU: embeddings {tuple(embs['cuda'].shape)}, max abs err {err:.3e}")
    check(bool(torch.isfinite(embs["cuda"]).all()) and err <= 1e-3,
          f"embeddings on the card disagree with the CPU: {err}")


def phase_profile(pipeline, wave, top: int = 15) -> None:
    """One more pipeline call under torch.profiler: device time by kernel,
    and the share of the call's span in which any kernel ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipeline(wave, 16000, uri="profile")
        torch.cuda.synchronize()
    events = prof.events()
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == DeviceType.CUDA)
    check(len(kernels) > 0, "the profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for a, b in kernels:  # union of kernel intervals
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    device_ms = sum(b - a for a, b in kernels) / 1e3
    print(f"profile: {len(kernels)} kernels, {device_ms:.3f} ms of device time in a "
          f"{span / 1e3:.3f} ms call; device busy {100 * busy / span:.1f}% of the span")
    rows = sorted((a for a in prof.key_averages() if a.device_type == DeviceType.CUDA),
                  key=lambda a: -a.self_device_time_total)
    for a in rows[:top]:
        print(f"  {a.self_device_time_total / 1e3:9.3f} ms  x{a.count:<5d} {a.key[:100]}")


class StageTimer:
    """Pipeline hook: seconds since the previous stage ended."""

    def __init__(self):
        self.last = time.perf_counter()
        self.seconds = {}

    def __call__(self, step, artifact):
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds[step] = now - self.last
        self.last = now


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {name}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    report = k1.build()
    print(f"K1 build: {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    eend_cfg = EendConfig(wavlm=WavLMConfig.base_s80_md(), conformer=ConformerConfig())
    heads = [len(h) for h, a in zip(eend_cfg.wavlm.remaining_heads,
                                     eend_cfg.wavlm.use_attention) if a]
    eend_sd = random_state_dict(EendModel(eend_cfg), seed=0)
    resnet_sd = random_state_dict(ResNet(ResNetConfig()), seed=1)
    wave = make_wave(AUDIO_SECONDS)
    with strict_float32():
        kernel = phase_kernel(heads)
        phase_reference(eend_sd, resnet_sd, eend_cfg, wave)

    model = EendModel(eend_cfg)
    model.load_state_dict(eend_sd)
    resnet = ResNet(ResNetConfig())
    resnet.load_state_dict(resnet_sd)
    seg = SlidingInference(model, batch_size=BATCH)  # bf16 segmentation
    emb = EmbeddingInference(resnet, seg.window_size,  # f32 embeddings
                             num_speakers=eend_cfg.max_speakers_per_chunk)
    pipeline = DiarizationPipeline(
        seg, emb, AgglomerativeClustering(threshold=0.7, min_cluster_size=30),
        eend_cfg, max_speakers=8)

    t0 = time.perf_counter()
    pipeline(wave, 16000, uri="warmup")
    torch.cuda.synchronize()
    print(f"pipeline warm-up: {time.perf_counter() - t0:.3f} s")

    timer = StageTimer()
    k1.launches = 0
    t0 = timer.last = time.perf_counter()
    ann = pipeline(wave, 16000, uri="smoke", hook=timer)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = k1.launches

    num_chunks = sum(seg.num_chunks(wave.shape[1]))
    print("pipeline with PyTorch's float32 defaults: matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    print(f"pipeline {card}: {AUDIO_SECONDS} s of audio in {seconds:.4f} s = "
          f"{AUDIO_SECONDS / seconds:.2f} audio-s/s; {num_chunks} chunks; "
          f"K1 launches {launches}")
    for step, s in timer.seconds.items():
        print(f"  stage {step} {card}: {s:.4f} s")
    check(launches == 50, f"expected 50 K1 launches (5 batches x 10 layers), got {launches}")
    rttm = ann.to_rttm().splitlines()
    check(len(rttm) > 0 and "embeddings" in timer.seconds, "no speech found: embeddings did not run")
    for line in rttm:
        parts = line.split()
        check(len(parts) == 10 and parts[0] == "SPEAKER" and parts[1] == "smoke"
              and float(parts[3]) >= 0 and float(parts[4]) > 0, f"bad RTTM line {line!r}")
    print(f"RTTM: {len(rttm)} segments, speakers {ann.labels()}")

    phase_profile(pipeline, wave)

    kernel["launches"] = launches
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
