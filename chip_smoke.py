"""Smoke run of the PyTorch/CUDA port (diarizen_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the last line is printed):
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build kernels K1 and K2 (csrc/gated_bias_attention.cu) and K3 and K4
     (csrc/residual_layer_norm.cu) with nvcc, the two sources side by side;
  3. K1 against its plain PyTorch version on the card at the serving path's
     shapes, with CUDA-event timings of the kernel, the plain version and
     one PyTorch call computing the same function (yardstick only);
  4. K1's training instance (attention dropout) and K2 (the backward)
     against the plain version and its autograd, output and all five
     gradients, in float32 and bfloat16, at T in {37, 399, 799}, rate 0 and
     0.1; then timed at the WavLM-Base training shapes;
  5. serving: DiariZen-Base-s80 EEND and the WeSpeaker ResNet34 at full
     width with seeded random weights; the card's output checked against
     the CPU's on two windows; then a 120 s synthetic two-speaker file
     through DiarizationPipeline once to warm up and once timed, counting
     K1's launches over the timed call;
  6. one more pipeline call under torch.profiler: device time by kernel and
     the device's busy share;
  7. training: one float32 train step of a narrow model on the card against
     the CPU; then WavLM-Base + Conformer (the flagship recipe's model) from
     seeded random weights on a synthetic Kaldi directory, through the
     DataLoader and the Trainer with the recipe's dual-LR optimizer: one
     epoch of 8 steps at batch 16 x 8 s in bfloat16, a validation pass and a
     checkpoint, counting K1's and K2's launches per step; the checkpoint
     loaded back into EendModel; one more step under torch.profiler;
  8. K3 and K4 (residual add + LayerNorm, with and without the weighted-sum
     update) against their plain versions in bfloat16 and float32 at four
     shapes, K4's accumulator checked to be updated in place; timed against
     the plain versions and PyTorch's own layer_norm calls; then the float32
     EEND scores with the fused-LN route on against off;
  9. streamed serving with the fused-LN route on: four different 120 s files
     through DiarizationPipeline.stream (device-side stitch), once to warm up
     and once timed, counting K1, K3 and K4 launches; every annotation must
     equal the per-file call's, and in float32 segmentation the device-side
     stitch must equal the host stages exactly; streamed and single-file
     audio-s/s with the fused-LN route on and off, the host time of one
     file's dispatch beside its device time, and one profiled streamed pass;
 10. a JSON line with the kernels' numbers, the nvidia-smi line, and a last
     JSON line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from diarizen_tpu_torch.cluster import AgglomerativeClustering
from diarizen_tpu_torch.core.audio import write_wav
from diarizen_tpu_torch.infer import DiarizationPipeline, EmbeddingInference, SlidingInference
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.convert import random_state_dict
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.fbank import wespeaker_fbank
from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig
from diarizen_tpu_torch.models.wavlm import WavLMConfig, set_fused_ln
from diarizen_tpu_torch.ops import flash_attention as k1
from diarizen_tpu_torch.ops import fused_ln as k3
from diarizen_tpu_torch.train import Trainer, TrainerConfig, dual_lr_optimizer, train_step
from diarizen_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint
from diarizen_tpu_torch.train.dataset import DataLoader, DiarizationDataset
from diarizen_tpu_torch.train.step import create_train_state

# H100 SXM data-sheet peaks (dense): HBM bandwidth, bf16 tensor-core rate, and
# the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

BATCH, FRAMES, HEAD_DIM = 32, 399, 64  # one segmentation batch of 8 s windows
AUDIO_SECONDS = 120
TRAIN_BATCH, TRAIN_HEADS, TRAIN_STEPS = 16, 12, 8  # WavLM-Base, the recipe's batch
DROPOUT_RATE, DROPOUT_SEED = 0.1, 1234
LR_SMALL, LR_BIG = 2e-5, 1e-3  # the recipe's learning rates: WavLM, the rest
EMBED_DIM = 768  # WavLM-Base width: the rows K3 and K4 normalise
STREAM_FILES = 4
STREAM_REPEATS = 3  # timed passes per configuration; the median is reported


def make_wave(dur_s: int, sr: int = 16000, seed: int = 0) -> np.ndarray:
    """Synthetic two-speaker meeting, quantised like PCM16 (bench.py's)."""
    t = np.arange(dur_s * sr) / sr
    wave = np.zeros_like(t, dtype=np.float32)
    rng = np.random.default_rng(seed)
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
    before each timed launch, as the main path finds it cold. A matrix
    product is queued first to keep the device busy while the host enqueues
    `fn`: otherwise the events around a kernel of a few tens of microseconds
    time the host's launch path, not the kernel."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    delay = torch.zeros((4096, 4096), dtype=torch.bfloat16, device="cuda")
    delayed = torch.empty_like(delay)
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.mm(delay, delay, out=delayed)
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


def trainable_bound_s(b, h, t, d, itemsize) -> dict:
    """(bytes / HBM rate, flops / bf16 peak) of K1's training instance and of
    K2, one call each. K1: q, k, v read, o written, the bias and the gate
    read, the f32 log-sum-exp written; two T x T x D products. K2: q, k, v,
    o, dO read, dq, dk, dv written, the bias, gate and log-sum-exp read,
    d pos_bias (f32) and dgate written; five T x T x D products."""
    act, bias, row = b * h * t * d * itemsize, h * t * t, b * h * t * 4
    return {
        "fwd": ((4 * act + bias * itemsize + 2 * row) / HBM_BYTES_PER_S,
                4 * b * h * t * t * d / BF16_FLOP_PER_S),
        "bwd": ((8 * act + bias * itemsize + bias * 4 + 3 * row) / HBM_BYTES_PER_S,
                10 * b * h * t * t * d / BF16_FLOP_PER_S),
    }


def trainable_inputs(b, h, t, dtype, gen):
    q, k, v, do = (torch.randn((b, h, t, HEAD_DIM), generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    pos = torch.randn((h, t, t), generator=gen, device="cuda")  # float32, as WavLM's table
    gate = 1.0 + torch.rand((b, h, t), generator=gen, device="cuda")
    return (q, k, v, pos, gate), do


def phase_trainable_kernels() -> list:
    """K1's training instance and K2 against the plain version's forward and
    autograd backward on the same inputs and cotangent. Tolerance, of each
    tensor's largest magnitude: 1e-4 in float32 (reassociation; one wrong
    mask bit at T = 399 costs about 2.5e-3), 2e-2 in bfloat16 (the kernels
    round p, dS and W * m to bf16 for the tensor-core products, and sum in
    another order)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    tolerance = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    names = ("o", "dq", "dk", "dv", "dpos_bias", "dgate")
    main_err = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, t in ((2, 3, 37), (TRAIN_BATCH, TRAIN_HEADS, FRAMES), (2, 3, 799)):
            for rate in (0.0, DROPOUT_RATE):
                inputs, do = trainable_inputs(b, h, t, dtype, gen)
                results = []
                for fn in (k1.flash_attention_gated_bias_trainable,
                           k1.flash_attention_gated_bias_reference):
                    leaves = [x.clone().requires_grad_() for x in inputs]
                    out = fn(*leaves, dropout_rate=rate, seed=DROPOUT_SEED)
                    out.backward(do)
                    results.append([out.detach()] + [x.grad for x in leaves])
                torch.cuda.synchronize()
                rel = []
                for name, got, want in zip(names, *results):
                    err = (got.float() - want.float()).abs().max().item()
                    scale = want.float().abs().max().item()
                    rel.append(err / scale)
                    check(np.isfinite(err) and err <= tolerance[dtype] * scale,
                          f"{name} of K1/K2 disagrees with the plain version: {err} of "
                          f"{scale} at {dtype} B={b} H={h} T={t} rate={rate}")
                    if dtype == torch.bfloat16 and t == FRAMES and rate > 0:
                        key = "fwd" if name == "o" else "bwd"
                        main_err[key] = max(main_err[key], err)
                print(f"K1+K2 vs plain {str(dtype)[6:]} B={b} H={h} T={t} rate={rate}: "
                      + ", ".join(f"{n} {e:.2e}" for n, e in zip(names, rel))
                      + f" of max magnitude (tolerance {tolerance[dtype]:.0e})")

    # timings at WavLM-Base training shapes, bf16, rate 0.1
    (q, k, v, pos, gate), do = trainable_inputs(TRAIN_BATCH, TRAIN_HEADS, FRAMES,
                                                torch.bfloat16, gen)
    bias = pos.to(torch.bfloat16)
    mask = (gate[..., None] * pos).to(torch.bfloat16)
    args = (q, k, v, pos, gate, DROPOUT_RATE, DROPOUT_SEED)
    out, lse = k1._forward_train(q, k, v, bias, gate, DROPOUT_RATE, DROPOUT_SEED)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, pos, gate)]
    plain = k1.flash_attention_gated_bias_reference(*leaves, DROPOUT_RATE, DROPOUT_SEED)
    lib_leaves = [x.clone().requires_grad_() for x in (q, k, v, mask)]
    lib = F.scaled_dot_product_attention(*lib_leaves[:3], attn_mask=lib_leaves[3],
                                         dropout_p=DROPOUT_RATE)
    fwd = {
        "ms": median_ms(lambda: k1._forward_train(q, k, v, bias, gate, DROPOUT_RATE,
                                                  DROPOUT_SEED)),
        "plain_ms": median_ms(lambda: k1.flash_attention_gated_bias_reference(*args)),
        "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=DROPOUT_RATE)),
    }
    bwd = {
        "ms": median_ms(lambda: k1._backward(q, k, v, bias, gate, out, lse, do, DROPOUT_RATE,
                                             DROPOUT_SEED)),
        "plain_ms": median_ms(lambda: torch.autograd.grad(plain, leaves, do,
                                                          retain_graph=True)),
        "library_ms": median_ms(lambda: torch.autograd.grad(lib, lib_leaves, do,
                                                            retain_graph=True)),
    }
    bounds = trainable_bound_s(TRAIN_BATCH, TRAIN_HEADS, FRAMES, HEAD_DIM, 2)
    entries = []
    for key, row, name, replaces in (
            ("fwd", fwd, "gated_bias_attention_train", "diarizen_tpu/ops/flash_attention.py:201"),
            ("bwd", bwd, "gated_bias_attention_bwd", "diarizen_tpu/ops/flash_attention.py:326")):
        mem_s, op_s = bounds[key]
        print(f"{name} bf16 B={TRAIN_BATCH} H={TRAIN_HEADS} T={FRAMES} rate={DROPOUT_RATE}: "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {1e3 * max(mem_s, op_s):.4f} ms "
              f"({1e3 * mem_s:.4f} bytes, {1e3 * op_s:.4f} operations)")
        entries.append({
            "name": name, "route": "cuda",
            "source": "diarizen_tpu_torch/csrc/gated_bias_attention.cu", "replaces": replaces,
            "max_abs_err": main_err[key], **row,
            "bound_ms": 1e3 * max(mem_s, op_s),
            "bound_by": "bytes" if mem_s >= op_s else "operations",
        })
    return entries


def write_kaldi_dir(root: Path, name: str, durations, seed: int) -> Path:
    """A synthetic Kaldi directory: per recording two to four speakers
    (tones with noise) in turns of 1-5 s that overlap, PCM16 WAVs, RTTM and
    UEM."""
    rng = np.random.default_rng(seed)
    out = root / name
    out.mkdir(parents=True)
    scp, rttm, uem = [], [], []
    for r, dur in enumerate(durations):
        rec = f"{name}{r}"
        t = np.arange(dur * 16000) / 16000
        wave = 0.005 * rng.standard_normal(t.shape)
        num_spk = int(rng.integers(2, 5))
        pos = 0.5
        while pos < dur - 1.5:
            spk = int(rng.integers(num_spk))
            seg = float(rng.uniform(1.0, 5.0))
            end = min(pos + seg, dur - 0.5)
            m = (t >= pos) & (t < end)
            wave[m] += 0.15 * np.sin(2 * np.pi * (150 + 70 * spk) * t[m])
            rttm.append(f"SPEAKER {rec} 1 {pos:.2f} {end - pos:.2f} <NA> <NA> spk{spk} <NA> <NA>")
            pos += seg * float(rng.uniform(0.6, 1.1))  # overlaps where < 1
        path = out / f"{rec}.wav"
        write_wav(path, wave[None].astype(np.float32), 16000)
        scp.append(f"{rec} {path}")
        uem.append(f"{rec} 1 0.00 {dur:.2f}")
    for fname, lines in (("wav.scp", scp), ("rttm", rttm), ("all.uem", uem)):
        (out / fname).write_text("\n".join(lines) + "\n")
    return out


def kaldi_dataset(path: Path, cfg: EendConfig, shift: float) -> DiarizationDataset:
    step, dur = cfg.rf_info()
    return DiarizationDataset(str(path / "wav.scp"), str(path / "rttm"), str(path / "all.uem"),
                              model_num_frames=cfg.num_frames(128000), model_rf_duration=dur,
                              model_rf_step=step, chunk_size=8.0, chunk_shift=shift)


def recipe_optimizer(model: EendModel):
    """The flagship recipe's optimizer: AdamW at 2e-5 on WavLM and 1e-3 on
    the rest, behind percentile AutoClip at 90."""
    return dual_lr_optimizer(model.param_groups(), lr_small=LR_SMALL, lr_big=LR_BIG,
                             clip_percentile=90.0)


# parameters whose gradient is zero in exact arithmetic: attention key biases
# (softmax ignores a per-row shift) and the depthwise-conv bias in front of a
# BatchNorm on batch statistics (the mean takes it out)
NULL_GRADIENT = ("k_proj.bias", "linearK.bias", "depthwise_conv.bias")


def phase_train_reference() -> None:
    """One float32 train step of a narrow model (all dropouts 0) on the card
    (K1 and K2 in float32) against the CPU (the plain attention): loss,
    gradient norm and the updated parameters within 1e-3. Adam's first step
    moves a parameter by about its learning rate whatever the size of its
    gradient, so a parameter of NULL_GRADIENT, whose gradient is rounding
    noise of either sign on each device, is held only to twice the step."""
    wavlm = dataclasses.replace(
        WavLMConfig.base(), embed_dim=256, num_layers=2, use_attention=(True,) * 2,
        use_feed_forward=(True,) * 2, total_num_heads=(4,) * 2,
        remaining_heads=((0, 1, 2, 3),) * 2, ff_interm_features=(512,) * 2,
        projection_dropout=0.0, attention_dropout=0.0, dropout=0.0, layer_drop=0.0)
    cfg = EendConfig(wavlm=wavlm, conformer=ConformerConfig(dim=64, ffn_hidden=128, num_layers=2,
                                                            dropout=0.0),
                     wavlm_layer_num=3, wavlm_feat_dim=256, attention_in=64)
    rng = np.random.default_rng(5)
    nf = cfg.num_frames(32000)
    batch = {"xs": (0.1 * rng.standard_normal((4, 1, 32000))).astype(np.float32),
             "target": (rng.uniform(size=(4, nf, 4)) > 0.6).astype(np.uint8)}
    sd = random_state_dict(EendModel(cfg), seed=3)
    results = {}
    for device in ("cpu", "cuda"):
        model = EendModel(cfg)
        model.load_state_dict(sd)
        state = create_train_state(model, recipe_optimizer(model), device)
        metrics = train_step(state, batch, seed=0, compute_dtype=torch.float32)
        results[device] = (metrics, {k: v.detach().cpu() for k, v in model.state_dict().items()})
    (m_cpu, p_cpu), (m_gpu, p_gpu) = results["cpu"], results["cuda"]
    errs = sorted(((p_gpu[k].float() - p_cpu[k].float()).abs().max().item(), k) for k in p_cpu
                  if not k.endswith(NULL_GRADIENT))
    param_err, worst = errs[-1]
    null_err = max((p_gpu[k].float() - p_cpu[k].float()).abs().max().item() for k in p_cpu
                   if k.endswith(NULL_GRADIENT))
    moved = max((p_cpu[k].float() - sd[k].float()).abs().max().item() for k in p_cpu)
    print(f"f32 train step card vs CPU: loss {m_gpu['loss']:.6f} vs {m_cpu['loss']:.6f}, "
          f"grad norm {m_gpu['grad_norm']:.6f} vs {m_cpu['grad_norm']:.6f}, updated parameters "
          f"max abs err {param_err:.3e} in {worst}, {null_err:.3e} where the gradient is "
          f"zero in exact arithmetic (largest move {moved:.3e})")
    check(abs(m_gpu["loss"] - m_cpu["loss"]) <= 1e-3 * max(1.0, abs(m_cpu["loss"])),
          "train-step loss on the card disagrees with the CPU")
    check(abs(m_gpu["grad_norm"] - m_cpu["grad_norm"]) <= 1e-3 * max(1.0, m_cpu["grad_norm"]),
          "train-step gradient norm on the card disagrees with the CPU")
    check(param_err <= 1e-3 and null_err <= 2 * LR_BIG and moved > 0,
          "updated parameters on the card disagree with the CPU")


class StepRecorder:
    """Trainer step hook: each step's metrics, wall time since the previous
    step ended (the step reads its loss and gradient norm, so the device has
    finished it), and K1's and K2's launches during the step."""

    def __init__(self):
        self.steps = []
        self.last = time.perf_counter()
        self.counts = (0, 0)

    def __call__(self, metrics) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = (k1.train_launches, k1.bwd_launches)
        self.steps.append({**metrics, "ms": 1e3 * (now - self.last),
                           "k1": counts[0] - self.counts[0], "k2": counts[1] - self.counts[1]})
        self.last, self.counts = now, counts


def profile_train_step(trainer, batch, card: str, top: int = 12) -> None:
    """One more train step under torch.profiler: device time by kernel, the
    share of K1 and K2, and the operators (with their input shapes) whose
    kernels take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        train_step(trainer.state, batch, trainer.tc.seed, trainer.compute_dtype)
        torch.cuda.synchronize()
    ops = sorted((a for a in prof.key_averages(group_by_input_shape=True)
                  if a.device_type == DeviceType.CPU and a.key.startswith("aten::")
                  and a.key not in ("aten::to", "aten::_to_copy")),
                 key=lambda a: -a.device_time_total)
    for a in ops[:5]:
        print(f"  operator {a.device_time_total / 1e3:9.3f} ms device time x{a.count:<4d} "
              f"{a.key} {str(a.input_shapes)[:120]}")
    rows = sorted((a for a in prof.key_averages() if a.device_type == DeviceType.CUDA),
                  key=lambda a: -a.self_device_time_total)
    check(len(rows) > 0, "the profiler recorded no device activity")
    total = sum(a.self_device_time_total for a in rows) / 1e3
    k1_ms = sum(a.self_device_time_total for a in rows
                if "gated_bias_attention_bf16_kernel" in a.key) / 1e3
    k2_ms = sum(a.self_device_time_total for a in rows if "attention_bwd_" in a.key) / 1e3
    print(f"profiled train step {card}: {total:.3f} ms of device time; K1 {k1_ms:.3f} ms "
          f"({100 * k1_ms / total:.1f}%), K2 {k2_ms:.3f} ms ({100 * k2_ms / total:.1f}%)")
    for a in rows[:top]:
        print(f"  {a.self_device_time_total / 1e3:9.3f} ms  x{a.count:<5d} {a.key[:100]}")


def phase_training(card: str) -> dict:
    """WavLM-Base + Conformer trained for one epoch of TRAIN_STEPS steps on a
    synthetic Kaldi directory through the DataLoader and the Trainer; returns
    the launches of K1's training instance and K2 in that run."""
    cfg = EendConfig(wavlm=WavLMConfig.base(), conformer=ConformerConfig())
    model = EendModel(cfg)
    model.load_state_dict(random_state_dict(model, seed=0))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        # 4 x 200 s at 8 s / 6 s: 128 chunks = 8 batches of 16; dev 70 s at 8 s / 8 s: 8 chunks
        train_ds = kaldi_dataset(write_kaldi_dir(root, "train", [200] * 4, seed=0), cfg, 6.0)
        dev_ds = kaldi_dataset(write_kaldi_dir(root, "dev", [70], seed=1), cfg, 8.0)
        train_loader = DataLoader(train_ds, batch_size=TRAIN_BATCH, shuffle=True, seed=3407)
        val_loader = DataLoader(dev_ds, batch_size=8, shuffle=False)
        check(len(train_loader) == TRAIN_STEPS and len(val_loader) == 1,
              f"expected {TRAIN_STEPS} train batches and 1 dev batch")
        recorder = StepRecorder()
        trainer = Trainer(model, TrainerConfig(exp_dir=str(root / "exp"), max_epochs=1,
                                               compute_dtype="bfloat16", log_every=1000,
                                               max_num_checkpoints=1),
                          recipe_optimizer(model), step_hook=recorder)
        torch.cuda.reset_peak_memory_stats()
        k1.launches = k1.train_launches = k1.bwd_launches = 0
        t0 = recorder.last = time.perf_counter()
        val = trainer.train(train_loader, val_loader)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"inference": k1.launches, "train": k1.train_launches, "bwd": k1.bwd_launches}
        peak = torch.cuda.max_memory_allocated()

        steps = recorder.steps
        for i, st in enumerate(steps):
            print(f"  train step {i}: loss {st['loss']:.5f} grad norm {st['grad_norm']:.4f} "
                  f"{st['ms']:.2f} ms; attention layers {st['attention_layers']}, K1 "
                  f"{st['k1']}, K2 {st['k2']}")
        step_ms = float(np.median([st["ms"] for st in steps[2:]]))
        print(f"training {card}: {len(steps)} steps of {TRAIN_BATCH} x 8 s in {seconds:.3f} s "
              f"with validation and checkpoint; median {step_ms:.2f} ms/step after 2 warm-up "
              f"steps; peak device memory {peak / 2**30:.3f} GiB")
        print(f"validation: loss {val['loss']:.5f}, DER {val['der']:.5f}; launches in the run: "
              f"K1 training {launches['train']}, K2 {launches['bwd']}, K1 inference "
              f"{launches['inference']}")
        check(len(steps) == TRAIN_STEPS and all(np.isfinite(st["loss"]) and not st["skipped"]
                                                for st in steps), "a train step was not finite")
        check(all(st["k1"] == st["k2"] == st["attention_layers"] > 0 for st in steps),
              "K1/K2 launches per step differ from the attention layers the step ran")
        check(launches["inference"] == cfg.wavlm.num_layers * len(val_loader),
              f"expected {cfg.wavlm.num_layers} K1 inference launches in validation")
        check(np.isfinite(val["loss"]) and np.isfinite(val["der"]), "validation not finite")

        ckpt = latest_checkpoint(root / "exp" / "checkpoints")
        check(ckpt is not None and ckpt.name == "epoch_0000", "no checkpoint was saved")
        state_dict, _, meta = load_checkpoint(ckpt)
        served = EendModel(cfg)
        served.load_state_dict(state_dict)
        trained = trainer.model.state_dict()
        check(all(torch.equal(v, trained[k].cpu()) for k, v in served.state_dict().items()),
              "the checkpoint does not hold the trained weights")
        batch = next(iter(val_loader))
        with torch.inference_mode():
            scores = served.to("cuda").eval()(torch.from_numpy(batch["xs"]).cuda(),
                                              torch.bfloat16)
        check(scores.shape == (8, FRAMES, cfg.num_powerset_classes)
              and bool(torch.isfinite(scores).all()), "the reloaded model's scores")
        print(f"checkpoint {ckpt.name} (step {meta['step']}) reloaded into EendModel: scores "
              f"{tuple(scores.shape)} finite")
        profile_train_step(trainer, next(iter(train_loader)), card)
    return launches


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


def phase_profile(what: str, run, top: int = 15) -> float:
    """`run()` under torch.profiler: device time by kernel, and the share of
    the run's span in which any kernel ran. Returns the milliseconds in
    which any kernel ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
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
    print(f"profile of {what}: {len(kernels)} kernels, {device_ms:.3f} ms of device time in a "
          f"{span / 1e3:.3f} ms span; device busy {100 * busy / span:.1f}% of the span")
    rows = sorted((a for a in prof.key_averages() if a.device_type == DeviceType.CUDA),
                  key=lambda a: -a.self_device_time_total)
    for a in rows[:top]:
        print(f"  {a.self_device_time_total / 1e3:9.3f} ms  x{a.count:<5d} {a.key[:100]}")
    return busy / 1e3


def fused_ln_bound_s(rows: int, d: int, itemsize: int, with_acc: bool) -> tuple:
    """(bytes / HBM rate, flops / float32 peak) of one K3 or K4 launch: a and
    b read and y written once, gamma and beta read once, for K4 also w and the
    float32 accumulator read and written; about 10 float operations an
    element (K4 two more)."""
    moved = 3 * rows * d * itemsize + 2 * d * 4
    flops = 10 * rows * d
    if with_acc:
        moved += 2 * rows * d * 4 + 4
        flops += 2 * rows * d
    return moved / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S


def fused_ln_inputs(shape, dtype, gen):
    a, b = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(2))
    d = shape[-1]
    gamma = 0.5 + torch.rand(d, generator=gen, device="cuda")
    beta = torch.randn(d, generator=gen, device="cuda")
    acc = torch.randn(shape, generator=gen, device="cuda")
    w = torch.full((), 0.37, device="cuda")
    return a, b, gamma, beta, w, acc


def phase_fused_ln() -> list:
    """K3 and K4 against their plain versions on the card. Limits: float32
    1e-5 (the kernel contracts multiply-adds and sums a row in another
    order); bfloat16 y within 2e-2 of max(1, |y|), one output ulp where a
    rounding falls the other way; K4's accumulator within 1e-5 (float32) and
    1e-3 (bfloat16) of acc0 + w * float32(y) for the y it returned, and
    updated in place."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    y_limit = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    acc_limit = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
    main_shape = (BATCH * FRAMES, EMBED_DIM)
    main_err = {"k3": 0.0, "k4": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in (main_shape, (BATCH, FRAMES, 1024), (2, 7, 128), (3, 41, 96)):
            a, b, gamma, beta, w, acc0 = fused_ln_inputs(shape, dtype, gen)
            want = k3.residual_ln_plain(a, b, gamma, beta).float()
            scale = want.abs().clamp_min(1.0)
            y3 = k3.residual_ln(a, b, gamma, beta)
            acc = acc0.clone()
            y4, acc_out = k3.residual_ln_acc(a, b, gamma, beta, w, acc)
            torch.cuda.synchronize()
            err3 = (y3.float() - want).abs()
            err4 = (y4.float() - want).abs()
            err_acc = (acc - (acc0 + w * y4.float())).abs().max().item()
            rel3, rel4 = (err3 / scale).max().item(), (err4 / scale).max().item()
            print(f"K3/K4 vs plain {str(dtype)[6:]} {shape}: y max abs err {err3.max().item():.3e} "
                  f"/ {err4.max().item():.3e} (of max(1, |y|): {rel3:.3e} / {rel4:.3e}, limit "
                  f"{y_limit[dtype]:.0e}); acc {err_acc:.3e} (limit {acc_limit[dtype]:.0e})")
            check(y3.dtype == dtype and y3.shape == a.shape and y4.dtype == dtype,
                  "K3/K4 output type or shape")
            check(np.isfinite(rel3) and rel3 <= y_limit[dtype],
                  f"K3 disagrees with its plain version: {rel3} at {dtype} {shape}")
            check(np.isfinite(rel4) and rel4 <= y_limit[dtype],
                  f"K4's y disagrees with the plain version: {rel4} at {dtype} {shape}")
            check(acc_out.data_ptr() == acc.data_ptr() and acc_out is acc,
                  "K4 did not update its accumulator in place")
            check(np.isfinite(err_acc) and err_acc <= acc_limit[dtype],
                  f"K4's accumulator is off by {err_acc} at {dtype} {shape}")
            if dtype == torch.bfloat16 and shape == main_shape:
                main_err = {"k3": err3.max().item(), "k4": max(err4.max().item(), err_acc)}

    # timings at the serving shape: one batch of 32 windows x 399 frames, bf16
    a, b, gamma, beta, w, acc = fused_ln_inputs(main_shape, torch.bfloat16, gen)
    g16, b16 = gamma.to(a.dtype), beta.to(a.dtype)

    def library_ln():
        """One PyTorch call computing K3's function: a yardstick only."""
        return F.layer_norm(a + b, (EMBED_DIM,), g16, b16)

    rows = (
        ("k3", "residual_layer_norm", "diarizen_tpu/ops/fused_ln.py:41", False, {
            "ms": median_ms(lambda: k3.residual_ln(a, b, gamma, beta)),
            "plain_ms": median_ms(lambda: k3.residual_ln_plain(a, b, gamma, beta)),
            "library_ms": median_ms(library_ln)}),
        ("k4", "residual_layer_norm_acc", "diarizen_tpu/ops/fused_ln.py:48", True, {
            "ms": median_ms(lambda: k3.residual_ln_acc(a, b, gamma, beta, w, acc)),
            "plain_ms": median_ms(lambda: k3.residual_ln_acc_plain(a, b, gamma, beta, w, acc)),
            "library_ms": median_ms(lambda: acc.add_(library_ln().float(), alpha=0.37))}),
    )
    entries = []
    for key, name, replaces, with_acc, row in rows:
        mem_s, op_s = fused_ln_bound_s(main_shape[0], EMBED_DIM, 2, with_acc)
        print(f"{name} bf16 {main_shape}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
              f"ms, library {row['library_ms']:.4f} ms, bound {1e3 * max(mem_s, op_s):.4f} ms "
              f"({1e3 * mem_s:.4f} bytes, {1e3 * op_s:.4f} operations)")
        entries.append({
            "name": name, "route": "cuda",
            "source": "diarizen_tpu_torch/csrc/residual_layer_norm.cu", "replaces": replaces,
            "max_abs_err": main_err[key], **row,
            "bound_ms": 1e3 * max(mem_s, op_s),
            "bound_by": "bytes" if mem_s >= op_s else "operations",
        })
    return entries


def phase_fused_ln_model(eend_sd, eend_cfg, wave) -> None:
    """The float32 EEND scores on the card with the fused-LN route (K3, K4)
    against the unfused route, on two 8 s windows, within 1e-4."""
    windows = torch.from_numpy(np.stack([wave[0, :128000], wave[0, 12800:140800]])).cuda()
    model = EendModel(eend_cfg)
    model.load_state_dict(eend_sd)
    model = model.cuda().eval()
    scores = {}
    try:
        for fused in (False, True):
            set_fused_ln(fused)
            k3.launches = k3.acc_launches = 0
            with torch.inference_mode():
                scores[fused] = model(windows)
            counts = (k3.launches, k3.acc_launches)
            wavlm = eend_cfg.wavlm
            expected = (sum(wavlm.use_attention), sum(wavlm.use_feed_forward)) if fused else (0, 0)
            check(counts == expected, f"fused-LN {fused}: K3, K4 launches {counts}, not {expected}")
    finally:
        set_fused_ln(None)
    err = (scores[True] - scores[False]).abs().max().item()
    print(f"EEND f32 on the card, fused-LN route vs unfused: max abs err {err:.3e} (limit 1e-4)")
    check(bool(torch.isfinite(scores[True]).all()) and err <= 1e-4,
          f"the fused-LN route's scores disagree with the unfused route's: {err}")


def timed_pass(run) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_stream(card: str, model, eend_cfg, pipeline) -> dict:
    """Streamed serving of STREAM_FILES different 120 s files at full width,
    the fused-LN route on; returns the launches of K1, K3 and K4 over the
    timed streamed pass."""
    waves = [make_wave(AUDIO_SECONDS, seed=i) for i in range(STREAM_FILES)]
    uris = [f"file{i}" for i in range(STREAM_FILES)]
    wavlm = eend_cfg.wavlm
    batches = -(-sum(pipeline.seg_inference.num_chunks(waves[0].shape[1])) // BATCH)
    expected = {"k1": STREAM_FILES * batches * sum(wavlm.use_attention),
                "k3": STREAM_FILES * batches * sum(wavlm.use_attention),
                "k4": STREAM_FILES * batches * sum(wavlm.use_feed_forward)}

    def stream():
        return [a.to_rttm() for a in pipeline.stream(iter(waves), 16000, uris=uris)]

    def one_by_one():
        return [pipeline(w, 16000, uri=u).to_rttm() for w, u in zip(waves, uris)]

    try:
        set_fused_ln(True)
        print(f"stream warm-up: {timed_pass(stream):.3f} s")
        k1.launches = k3.launches = k3.acc_launches = 0
        streamed = []
        seconds = timed_pass(lambda: streamed.extend(stream()))
        launches = {"k1": k1.launches, "k3": k3.launches, "k4": k3.acc_launches}
        print(f"streamed pass {card}: {STREAM_FILES} x {AUDIO_SECONDS} s in {seconds:.4f} s = "
              f"{STREAM_FILES * AUDIO_SECONDS / seconds:.2f} audio-s/s; launches K1 "
              f"{launches['k1']}, K3 {launches['k3']}, K4 {launches['k4']}")
        check(launches == expected, f"expected launches {expected}, got {launches}")
        single = one_by_one()
        for uri, got, want in zip(uris, streamed, single):
            check(len(want.splitlines()) > 0, f"{uri}: no speech found")
            check(got == want, f"{uri}: the streamed annotation differs from the per-file call's")
        print(f"streamed annotations equal the per-file calls': "
              f"{[len(r.splitlines()) for r in streamed]} segments")

        # float32 segmentation: the device-side stitch against the host stages
        seg32 = SlidingInference(model, batch_size=BATCH, compute_dtype=torch.float32)
        routes = {}
        with strict_float32():
            for fused_stitch in (True, False):
                pipe32 = dataclasses.replace(pipeline, seg_inference=seg32,
                                             fused_stitch=fused_stitch)
                routes[fused_stitch] = [a.to_rttm() for a in pipe32.stream(iter(waves), 16000,
                                                                           uris=uris)]
        check(routes[True] == routes[False] and all(routes[True]),
              "float32: the device-side stitch and the host stages give different annotations")
        print("float32 segmentation: device-side stitch equals the host stages on "
              f"{STREAM_FILES} files")

        # one file's dispatch on the host's clock beside its device time
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        state = pipeline._dispatch_file(waves[0], 16000, "dispatch", None)
        dispatch_s = time.perf_counter() - t0
        end.record()
        t0 = time.perf_counter()
        pipeline._finish_file(state, None, None)
        finish_s = time.perf_counter() - t0
        end.synchronize()
        print(f"one file {card}: _dispatch_file returned after {1e3 * dispatch_s:.2f} ms on the "
              f"host; the device took {start.elapsed_time(end):.2f} ms for what it enqueued; "
              f"_finish_file (wait, clustering, reconstruction) {1e3 * finish_s:.2f} ms")

        # throughput: streamed and one by one, the fused-LN route on and off, in turns
        times = {(mode, fused): [] for mode in ("streamed", "single-file") for fused in (True, False)}
        set_fused_ln(False)
        timed_pass(stream)  # warm the unfused route
        for _ in range(STREAM_REPEATS):
            for fused in (True, False):
                set_fused_ln(fused)
                times[("streamed", fused)].append(timed_pass(stream))
                times[("single-file", fused)].append(timed_pass(one_by_one))
        audio = STREAM_FILES * AUDIO_SECONDS
        for (mode, fused), secs in times.items():
            rates = sorted(audio / t for t in secs)
            print(f"throughput {card}: {mode}, fused-LN {'on' if fused else 'off'}: median "
                  f"{float(np.median(rates)):.2f} audio-s/s of {STREAM_REPEATS} passes over "
                  f"{STREAM_FILES} x {AUDIO_SECONDS} s ({', '.join(f'{r:.2f}' for r in rates)})")

        # the profiler slows the host, so the busy share of a pass as users run
        # it is the profiled device time over the unprofiled pass's wall clock
        for fused in (True, False):
            set_fused_ln(fused)
            route = f"fused-LN {'on' if fused else 'off'}"
            busy_ms = phase_profile(f"one streamed pass, {route}", stream, top=15 if fused else 6)
            wall_ms = 1e3 * float(np.median(times[("streamed", fused)]))
            print(f"streamed pass {card}, {route}: {busy_ms:.1f} ms of device time against a "
                  f"median unprofiled pass of {wall_ms:.1f} ms: device busy "
                  f"{100 * busy_ms / wall_ms:.1f}%")
    finally:
        set_fused_ln(None)
    return launches


class StageTimer:
    """Pipeline hook: seconds since the previous stage ended (the per-batch
    progress calls are passed over)."""

    def __init__(self):
        self.last = time.perf_counter()
        self.seconds = {}

    def __call__(self, step, artifact=None, total=None, completed=None):
        if artifact is None:
            return
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
    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc per source, side by side
        reports = [f.result() for f in [pool.submit(k1.build), pool.submit(k3.build)]]
    print(f"K1 + K2 and K3 + K4 build: {time.perf_counter() - t0:.1f} s")
    for line in "\n".join(reports).splitlines():
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
        trainable = phase_trainable_kernels()
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
    k1.launches = k1.train_launches = k1.bwd_launches = 0
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

    phase_profile("one pipeline call", lambda: pipeline(wave, 16000, uri="profile"))

    with strict_float32():
        phase_train_reference()
    train_launches = phase_training(card)

    with strict_float32():
        fused_ln = phase_fused_ln()
        phase_fused_ln_model(eend_sd, eend_cfg, wave)
    stream_launches = phase_stream(card, model, eend_cfg, pipeline)

    kernel["launches"] = launches
    trainable[0]["launches"] = train_launches["train"]
    trainable[1]["launches"] = train_launches["bwd"]
    fused_ln[0]["launches"] = stream_launches["k3"]
    fused_ln[1]["launches"] = stream_launches["k4"]
    print(json.dumps({"kernels": [kernel, *trainable, *fused_ln]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
