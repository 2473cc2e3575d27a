"""Smoke run of the PyTorch/CUDA port (diarizen_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the last line is printed):
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build kernels K1 and K2 (csrc/gated_bias_attention.cu), K3 and K4
     (csrc/residual_layer_norm.cu), K5 (csrc/conv_chain.cu) and the ResNet
     stem (csrc/resnet_stem.cu) with nvcc, the four sources side by side;
  3. K1 against its plain PyTorch version on the card at the serving path's
     shapes, with CUDA-event timings of the kernel, the plain version and
     one PyTorch call computing the same function (yardstick only): the 10
     launches of one Base-s80-md batch, and one launch at the unpruned
     `base` model's shape (B 32, H 12), each beside its bound, and the 10
     launches of one `whole` forward over 30 s (B 1, T 1499); the bf16
     kernel's shared memory and blocks per SM;
  4. K1's training instance (attention dropout) and K2 (the backward)
     against the plain version and its autograd, output and all five
     gradients, in float32 and bfloat16, at T in {37, 399, 799} and at
     B in {1, 5, 13} (one chunk of pass A; one element a chunk; chunks of
     unequal sizes, as at B 16), rate 0 and 0.1; K2's d pos_bias bit for
     bit the same in two calls; then timed at the WavLM-Base training
     shapes, with pass A (and the sum of its partial slices) and pass B
     also timed alone, and pass A at other numbers of chunks than the
     plan's; then K1's softmax schedules ("f32", "deferred", "bf16") at the
     `base` shape and at B 16, T 1499, the training forward (f32 schedule)
     and K2 at rate 0.1 and at rate 0 (the instances without the dropout
     hash), each against the plain version of its schedule, with the
     instance counters showing which instance ran, and timed beside its
     bound, plain version and SDPA; the training forward at rate 0 also
     beside the deferred schedule's with the log-sum-exp;
  5. serving: DiariZen-Base-s80 EEND and the WeSpeaker ResNet34 at full
     width with seeded random weights; the card's output checked against
     the CPU's on two windows; the ResNet34 at 32 rows x 8 s with its
     BatchNorms folded, channels-last and one fused epilogue a convolution
     (`phase_resnet`): the stem's kernel against its plain version,
     the forward against the same folds through the plain versions and
     against the unfolded channels-first formula, the registry's counts of
     one forward, the forward timed as a CUDA graph beside its bound and
     beside the unfolded formula's, the stem timed beside its bound, its
     plain version and cuDNN's fused convolution, and the kernels of one
     replay, with no cuDNN layout transpose among them; then a 120 s
     synthetic two-speaker file through DiarizationPipeline once to warm up
     and once timed, counting K1's launches, the ResNet34's fused
     convolutions (36 an embedding batch) and its folds (none after the
     warm-up) over the timed call;
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
  9. streamed serving with the fused-LN route on: two different 120 s files
     through DiarizationPipeline.stream (device-side stitch), once to warm up
     and once timed, counting K1, K3 and K4 launches; every annotation must
     equal the per-file call's, and in float32 segmentation the device-side
     stitch must equal the host stages exactly; streamed and single-file
     audio-s/s with the fused-LN route on and off, the host time of one
     file's dispatch beside its device time, and one profiled streamed pass;
 10. K5 (the WavLM extractor's conv layers 1-6: six implicit GEMMs in
     bfloat16, one launch in float32) against its plain version in bfloat16
     and float32 at ragged sizes, the input exactly as long as needed and
     longer, inside a NaN-filled buffer; timed at the serving shape against
     the plain version, six PyTorch convolutions and the bound, with the
     CUDA launches of one call and each bfloat16 stage timed alone;
 11. snapshot directories to RTTM files: two directories laid out like
     released ones (config.toml with the reference's class path and VBx
     clustering, pytorch_model.bin, plda/) written from seeds for WavLM-Base
     and Large-s80-md at full width, two 120 s WAV files and a wav.scp; each
     through `pipelines.from_pretrained` and the wav.scp CLI, once to warm up
     and once timed. WavLM-Base runs with the conv-chain route on (10 K5 and
     120 K1 launches expected): its scores with the route on against off
     (float32 within 1e-4; bfloat16 flips only at small top-2 margins), its
     annotations against `diarize_file` with the route off, streamed
     audio-s/s with the route on and off, the extractor's time, a profiled
     pass. Large-s80-md (pre-LN, 200 K1 launches, no K3, K4 or K5): float32
     scores on the card against the CPU, streamed audio-s/s, a profiled pass;
 12. scoring and the frame-level modes at Base-s80-md's full width: four
     120 s files written as WAV and as FLAC (encoded by
     tests/flac_ref_encoder.py in worker processes started at the beginning
     of the run) must read back bit for bit equal; an experiment directory
     of three seeded checkpoints with a recipe TOML naming the repository's
     own class path; the float32 pipeline's RTTMs of the WAV copies as the
     reference; the recipe CLI (`recipes.diar_ssl.infer.main`: three
     checkpoints averaged, bf16, AHC, the FLAC wav.scp) with its K1
     launches, its `der.json` against `der_report` and its DER against the
     reference (at most 0.5%); aggregated speech and overlap decisions in
     bf16 against float32, VAD, OSD, multi-label segmentation and
     resegmentation of the recipe's output; the per-window fbank route of
     the embedding stage against the shared one (float32, within 1e-4); and
     `whole` over 30 s (T 1499): bf16 scores against float32 within the
     margin-aware bar, K1's launches;
 13. fine-tune, distill-prune and collapse WavLM-Base through the recipe CLIs
     on synthetic Kaldi directories: `recipes.diar_ssl.run` trains the
     flagship TOML's model for one epoch of 8 steps (16 x 8 s, bf16) and
     validates it (`-M validate` must read the epoch's validation again),
     `get_wavlm_from_finetuned` takes its trunk out; `run_distill_prune` with
     s80_base.toml's settings distill-prunes a seeded reference-format
     WavLM-Base teacher file for 8 steps at 16 x 8 s in bf16 (12 launches
     each of K1 inference, K1 training and K2 a step), one more step profiled;
     K1's training instance and K2 at dropout rate 0 against their plain
     versions (2e-2), timed
     beside their bounds and SDPA; `apply_pruning` on the run's checkpoints;
     the surgery of seeded log-alphas (about 80% of the units, 1-12 heads a
     layer, layer 0's attention and one feed-forward pruned): the pruned
     model against the gated one with compiled masks (f32 within 1e-4), its
     K1 launches, and K1 at its head counts;
 14. the multi-channel recipe at full width (Base-s80-md, 4 cross-channel
     fusions of hidden 256 and 8 heads, 8 microphones, Conformer 4 x 256),
     seeded: an 8-channel 120 s WAV, three checkpoints, a seeded PLDA
     directory; the f32 pipeline's RTTM as the reference, the card's f32
     scores and spatial attention against the CPU's (1e-3), the infer CLI in
     bf16 with VBx (seconds a file with loading, audio-s/s, K1 launches, DER
     against the reference at most 0.5%), its stage seconds and a profiled
     call; K1 at layers 0-3's heads at B 128 (16 windows x 8 channels) and
     at B 16 against its plain version, timed; the run CLI for one epoch of
     8 steps at 8 x 8 s
     (k drawn by the recipe's sampler) and `-M validate`; ms/step, peak
     memory and launches at each drawn k and k = 8, one profiled step at
     k = 8; K1's training instance and K2 at B = 8 k against their plain
     versions, timed beside SDPA and the bound;
 15. the remaining model families at full width, seeded: the repository's
     `fbank_conformer.toml` (Conformer 4 x 256, 80 mels) and
     `pyannote_baseline.toml` (SincNet + 4 BiLSTM(128)), unedited but for
     their data and epochs, each through `recipes.diar_ssl.run` for one epoch
     of 8 steps at the TOML's batch (16 and 32 x 8 s; bf16 requested, the
     SincNet family runs float32) and `-M validate`, then three seeded
     checkpoints, the card's f32 scores against the CPU's, the float32
     pipeline's RTTMs as the reference and `recipes.diar_ssl.infer` on the
     four 120 s FLAC files (bf16, AHC; warm-up, then timed) with its DER (at
     most 0.5%); SSeRiouSS on WavLM-Base with 4 BiLSTM(128) layers at 32 x
     8 s: the bf16 eval with the fused-LN and conv-chain routes on (K1 12 a
     batch, K3, K4 and K5 counted), its f32 scores with the routes on
     against off (1e-4) and against the CPU (1e-3), a training forward and
     backward that leaves WavLM without gradients, timed bf16 train steps
     (K1's training instance 12 a step, K2 never) and K1's training instance
     alone at B 32; the x-vector with MFCC and SincNet front ends on 32 x
     8 s, with and without pooling weights, against the CPU (1e-3), timed;
 16. the HuggingFace import, the schedules and data parallelism: the port's
     seeded WavLM-Base written as an HF directory (config.json and the
     HF-layout state dict as model.safetensors), converted by
     `recipes.diar_ssl_pruning.convert_wavlm_from_hf` and loaded back from
     its params.npz: f32 hidden states equal to the seeded model's (1e-5),
     bf16 through K1 against f32; WavLM-Base + Conformer at 16 x 8 s in bf16
     for four steps with `noam_adamw` and four on a one-cycle schedule, each
     step's learning rate printed beside its formula; one pipeline call and
     one train step without a process group and in a world-size-1 NCCL group
     started by `initialize_distributed` at 127.0.0.1: the same RTTM and loss;
 17. tensor parallelism: WavLM-Large + Conformer 4 x 256 at full width,
     seeded, on 8 x 8 s (16 rows cut to 8: the one-process reference and
     two ranks share the card): the one-process float32 scores and train
     step (dropout and layer drop on) in this process, then two rank
     processes on the card in a (1, 2) mesh under gloo (their float32
     scores, loss, gradient norm and gathered per-leaf gradients against
     the one process; two bf16 steps with K1's training instance and K2 at
     the ranks' 8 heads, the model group's all-reduces counted); K1's
     training instance and K2 at a head offset against the plain version,
     and timed at H 8 and H 16 (B 8);
 18. a JSON line with the six kernels' numbers, the nvidia-smi line, and a
     last JSON line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import socket
import subprocess
import sys
import tempfile
import time
import wave as wavefile
from collections import Counter
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from diarizen_tpu_torch.cluster import AgglomerativeClustering
from diarizen_tpu_torch import config as port_config
from diarizen_tpu_torch import pipelines, tracing
from diarizen_tpu_torch.core.audio import read_audio, write_wav
from diarizen_tpu_torch.core.io_rttm import load_rttm, write_rttm
from diarizen_tpu_torch.infer import (
    DiarizationPipeline,
    EmbeddingInference,
    MultiLabelSegmentation,
    OverlappedSpeechDetection,
    Resegmentation,
    SlidingInference,
    VoiceActivityDetection,
)
from diarizen_tpu_torch.models import build
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.convert import (
    load_pytree,
    random_state_dict,
    wavlm_config_from_hf,
    wavlm_state_dict_from_jax,
    wavlm_state_dict_to_hf,
)
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.fbank import wespeaker_fbank
from diarizen_tpu_torch.models.fbank_eend import FbankEendModel
from diarizen_tpu_torch.models.mc import McEendModel
from diarizen_tpu_torch.models import resnet as resnet_module
from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig
from diarizen_tpu_torch.models.sincnet_eend import SincNetEendModel
from diarizen_tpu_torch.models.sserious import SSeRiouSSConfig, SSeRiouSSModel
from diarizen_tpu_torch.models.wavlm import (
    WavLM,
    WavLMConfig,
    count_params,
    set_conv_chain,
    set_fused_ln,
)
from diarizen_tpu_torch.ops import conv_chain as k5
from diarizen_tpu_torch.ops import cuda_build
from diarizen_tpu_torch.ops import flash_attention as k1
from diarizen_tpu_torch.ops import fused_ln as k3
from diarizen_tpu_torch.ops import resnet_stem
from diarizen_tpu_torch.ops.binarize import binarize_hysteresis
from diarizen_tpu_torch.ops.der import der_report
from diarizen_tpu_torch.prune import (
    DistillConfig,
    PruneConfig,
    apply_pruning,
    compile_gates,
    compiled_mask,
    create_distill_prune_state,
    init_gates,
    make_distill_prune_step,
)
from diarizen_tpu_torch.recipes.diar_ssl import infer as recipe_infer
from diarizen_tpu_torch.recipes.diar_ssl import run as recipe_run
from diarizen_tpu_torch.recipes.diar_ssl_mc import infer as mc_infer
from diarizen_tpu_torch.recipes.diar_ssl_mc import run as mc_run
from diarizen_tpu_torch.recipes.diar_ssl_pruning import apply_pruning as apply_pruning_cli
from diarizen_tpu_torch.recipes.diar_ssl_pruning import convert_wavlm_from_hf
from diarizen_tpu_torch.recipes.diar_ssl_pruning import get_wavlm_from_finetuned, run_distill_prune
from diarizen_tpu_torch.models.xvector import XVectorConfig, XVectorModel
from diarizen_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    adamw_with_warmup,
    dual_lr_optimizer,
    segmentation_loss,
    train_step,
)
from diarizen_tpu_torch.train.checkpoint import (
    append_metrics,
    average_checkpoints,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from diarizen_tpu_torch.train.dataset import DataLoader, DiarizationDataset
from diarizen_tpu_torch.train.optim import Optimizer, noam_adamw, one_cycle_schedule
from diarizen_tpu_torch.train.step import TrainState, create_train_state, mc_train_step
from diarizen_tpu_torch.parallel import distributed as dp

# H100 SXM data-sheet peaks (dense): HBM bandwidth, bf16 tensor-core rate, and
# the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

BATCH, FRAMES, HEAD_DIM = 32, 399, 64  # one segmentation batch of 8 s windows
WHOLE_SECONDS, WHOLE_FRAMES = 30, 1499  # `whole`: one forward over a 30 s file
AUDIO_SECONDS = 120
TRAIN_BATCH, TRAIN_HEADS, TRAIN_STEPS = 16, 12, 8  # WavLM-Base, the recipe's batch
DROPOUT_RATE, DROPOUT_SEED = 0.1, 1234
LR_SMALL, LR_BIG = 2e-5, 1e-3  # the recipe's learning rates: WavLM, the rest
EMBED_DIM = 768  # WavLM-Base width: the rows K3 and K4 normalise
STREAM_FILES = 4  # the evaluation and families phases' eval set
SERVING_FILES = 2  # files of the streamed and snapshot phases
STREAM_REPEATS = 2  # timed passes per configuration; the median is reported


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


_START = time.perf_counter()


def elapsed(phase: str) -> None:
    """One line saying how far into the run a phase ended."""
    print(f"[{time.perf_counter() - _START:7.1f} s] {phase} done", flush=True)


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


def path_head_counts() -> list:
    """Every head count at which a main path launches K1's inference
    instance: the kept heads of each attention layer of the three models."""
    counts = set()
    for cfg in (WavLMConfig.base_s80_md(), WavLMConfig.base(), WavLMConfig.large_s80_md()):
        counts |= {len(h) for h, a in zip(cfg.remaining_heads, cfg.use_attention) if a}
    return sorted(counts)


def phase_kernel(heads_per_layer) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    tolerance = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # unit-scale inputs
    # T 1499: `whole` over a 30 s file, one sequence at each Base-s80-md
    # head count and at the unpruned 12 (partial last query block and key tile)
    cases = ([(BATCH, h, FRAMES) for h in path_head_counts()] + [(13, 12, FRAMES)]
             + [(BATCH, 2, 37), (BATCH, 2, 799)]
             + [(1, h, WHOLE_FRAMES) for h in sorted(set(heads_per_layer) | {12})])
    slice_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, t in cases:
            args = attention_inputs(b, h, t, HEAD_DIM, dtype, gen)
            got = k1.flash_attention_gated_bias(*args)
            torch.cuda.synchronize()
            # the plain version of the schedule the wrapper ran (the serving default)
            want = k1.flash_attention_gated_bias_reference(*args, softmax_mode=k1.softmax_mode())
            err = (got.float() - want.float()).abs().max().item()
            print(f"K1 vs plain {str(dtype)[6:]} B={b} H={h} T={t} D={HEAD_DIM}: "
                  f"max abs err {err:.3e} (tolerance {tolerance[dtype]:.0e})")
            check(np.isfinite(err) and err <= tolerance[dtype],
                  f"K1 disagrees with its plain version: {err} at {dtype} H={h} T={t}")
            if dtype == torch.bfloat16 and t == FRAMES:
                slice_err = max(slice_err, err)

    blocks, smem = k1.forward_occupancy(HEAD_DIM)
    print(f"K1 bf16 kernel at D={HEAD_DIM}: {smem} bytes of dynamic shared memory a block, "
          f"{blocks} blocks an SM")

    def timed(h, b=BATCH, t=FRAMES):
        """One launch at (b, h, t) in bf16: the kernel on the bias layout
        WavLM hands it (a padded buffer's view), the plain version, the
        library call, and the bound."""
        args = attention_inputs(b, h, t, HEAD_DIM, torch.bfloat16, gen)
        padded = (*args[:3], k1.padded_bias(args[3], torch.bfloat16), args[4])
        row = {
            "ms": median_ms(lambda: k1.flash_attention_gated_bias(*padded)),
            "plain_ms": median_ms(lambda: k1.flash_attention_gated_bias_reference(
                *args, softmax_mode=k1.softmax_mode())),
            "library_ms": median_ms(lambda: library_attention(*args)),
        }
        mem_s, op_s = attention_bound_s(b, h, t, HEAD_DIM, 2)
        print(f"K1 bf16 B={b} H={h} T={t}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
              f"bound {1e3 * max(mem_s, op_s):.4f} ms")
        return row, mem_s, op_s

    def timed_layers(what, b, t):
        """The attention layers of one Base-s80-md forward at (b, t), one
        launch each, summed."""
        totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
        by_bytes = by_flops = 0.0
        for h in heads_per_layer:
            row, mem_s, op_s = timed(h, b, t)
            by_bytes += mem_s
            by_flops += op_s
            for key in totals:
                totals[key] += row[key]
        print(f"K1 bf16 {what} ({len(heads_per_layer)} launches): kernel "
              f"{totals['ms']:.4f} ms, plain {totals['plain_ms']:.4f} ms, library "
              f"{totals['library_ms']:.4f} ms, bound {1e3 * max(by_bytes, by_flops):.4f} ms "
              f"(by {'bytes' if by_bytes >= by_flops else 'operations'})")
        return totals, by_bytes, by_flops

    # timings at the slice's shapes: the 10 attention layers of one batch
    totals, by_bytes, by_flops = timed_layers("one Base-s80-md batch", BATCH, FRAMES)
    # one launch at the unpruned base model's shape: every layer has 12 heads
    base_row, mem_s, op_s = timed(12)
    base_row["bound_ms"] = 1e3 * max(mem_s, op_s)
    # `whole` over a 30 s file: the same layers at B 1, T 1499
    whole, mem_s, op_s = timed_layers(f"one Base-s80-md `whole` forward over {WHOLE_SECONDS} s",
                                      1, WHOLE_FRAMES)
    whole["bound_ms"] = 1e3 * max(mem_s, op_s)
    whole["bound_by"] = "bytes" if mem_s >= op_s else "operations"
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
        "base_launch": base_row,  # one launch at B 32, H 12 (the `base` model)
        "whole_t1499": whole,  # the launches of one `whole` forward (B 1, T 1499)
    }


def trainable_bound_s(b, h, t, d, itemsize) -> dict:
    """(bytes / HBM rate, flops / bf16 peak) of K1's training instance and of
    K2, one call each. K1: q, k, v read, o written, the bias and the gate
    read, the f32 log-sum-exp written; two T x T x D products. K2: q, k, v,
    dO read (not o: D is the rowsum of W dW' m, as the TPU kernel's r), dq,
    dk, dv written, the bias, gate and log-sum-exp read, d pos_bias (f32)
    and dgate written; five T x T x D products."""
    act, bias, row = b * h * t * d * itemsize, h * t * t, b * h * t * 4
    return {
        "fwd": ((4 * act + bias * itemsize + 2 * row) / HBM_BYTES_PER_S,
                4 * b * h * t * t * d / BF16_FLOP_PER_S),
        "bwd": ((7 * act + bias * itemsize + bias * 4 + 3 * row) / HBM_BYTES_PER_S,
                10 * b * h * t * t * d / BF16_FLOP_PER_S),
    }


def trainable_inputs(b, h, t, dtype, gen):
    q, k, v, do = (torch.randn((b, h, t, HEAD_DIM), generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    pos = torch.randn((h, t, t), generator=gen, device="cuda")  # float32, as WavLM's table
    gate = 1.0 + torch.rand((b, h, t), generator=gen, device="cuda")
    return (q, k, v, pos, gate), do


def pass_a_by_chunks(run, planned: int, batch: int) -> dict:
    """K2's pass A (with the sum of its slices) timed at other numbers of
    batch chunks than the plan's, up to one element a chunk, to show where
    the plan stands: two rounds in opposite orders, so that a drift of the
    card's clock favours none. Returns {S: [ms, ms]}."""
    counts = tuple(sorted({s for s in (1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 24, 32, 48, 64)
                           if s <= batch} | {planned}))
    times = {s: [] for s in counts}
    plan = k1.pass_a_chunks
    try:
        for order in (counts, counts[::-1]):
            for s in order:
                k1.pass_a_chunks = lambda *_, s=s: s
                times[s].append(median_ms(run))
    finally:
        k1.pass_a_chunks = plan
    best = min(times, key=lambda s: sum(times[s]))
    print(f"K2 pass A with its sum by chunks S, two rounds (the plan takes S={planned}): "
          + ", ".join(f"S={s} {t[0]:.4f}/{t[1]:.4f}" for s, t in times.items()) + " ms; "
          f"best S={best}, the plan at {sum(times[planned]) / sum(times[best]):.3f}x of it")
    return times


def pass_a_and_sum(q, k, v, bias, gate, out, lse, do, rate):
    """K2's pass A and the sum of its partial slices: (dq, dbias, ...)."""
    a = k1._bwd_pass_a(q, k, v, bias, gate, out, lse, do, rate, DROPOUT_SEED)
    return a[0], k1._dbias_sum(a[1], q.shape[2])


def pass_times(q, k, v, bias, gate, out, lse, do, rate) -> dict:
    """K2's pass A, the sum of its partial slices and pass B, each timed
    alone, in ms."""
    seed, t = DROPOUT_SEED, q.shape[2]
    a = k1._bwd_pass_a(q, k, v, bias, gate, out, lse, do, rate, seed)
    row = {"pass_a_ms": median_ms(lambda: k1._bwd_pass_a(q, k, v, bias, gate, out, lse, do,
                                                         rate, seed)),
           "sum_ms": median_ms(lambda: k1._dbias_sum(a[1], t)),
           "pass_b_ms": median_ms(lambda: k1._bwd_pass_b(q, k, v, bias, gate, lse, a[3], a[4],
                                                         do, rate, seed))}
    b, h, _, _ = q.shape
    print(f"gated_bias_attention_bwd passes bf16 B={b} H={h} T={t} rate={rate}: pass A "
          f"{row['pass_a_ms']:.4f} ms, the sum of its {a[1].shape[0]} partial slices "
          f"{row['sum_ms']:.4f} ms, pass B {row['pass_b_ms']:.4f} ms")
    return row


def launches_per_call(run, want: set) -> dict:
    """The kernels one `run()` (a K2 call) launched on the card, read from
    the profiler's device events: {"cuda_launches_per_call": N,
    "cuda_kernels_per_call": {name: n}, "other_device_events": {name: n}}
    (events not named as a kernel of this repo, such as the profiler's
    own); fails unless the kernels are `want`, one launch each. 20 calls
    (60 kernels) before the one counted, past the kernels the profiler
    missed late in the process."""
    kernels, other = Counter(), Counter()
    for _, n, name in kernel_rows(profiled_events(run, warmup=20)):
        found = re.search(r"(\w+_kernel)\b", name)
        if found:
            kernels[found.group(1)] += n
        else:
            other[name] += n
    kernels, other = dict(sorted(kernels.items())), dict(sorted(other.items()))
    print(f"K2 call on the card: {sum(kernels.values())} kernel launches {kernels}; other "
          f"device events {other}")
    check(kernels == dict.fromkeys(sorted(want), 1),
          f"a K2 call launched {kernels}, not pass A, the sum and pass B once each")
    return {"cuda_launches_per_call": sum(kernels.values()), "cuda_kernels_per_call": kernels,
            "other_device_events": other}


K2_BF16_KERNELS = {"attention_bwd_dq_bf16_kernel", "dbias_sum_kernel",
                   "attention_bwd_dkdv_bf16_kernel"}


def check_keep_bits(b, h, t, gen) -> None:
    """The packed keep mask K2's pass A writes (bf16, rate 0.1, pass B's only
    source of the mask) against `pack_keep_bits` of the plain mask, bit for
    bit; and pass A at rate 0 (the instance without the mask) handed a keep
    buffer full of a sentinel, which it must leave as it was."""
    (q, k, v, pos, gate), do = trainable_inputs(b, h, t, torch.bfloat16, gen)
    bias = k1.padded_bias(pos, torch.bfloat16)
    out, lse = k1._forward_train(q, k, v, bias, gate, DROPOUT_RATE, DROPOUT_SEED)
    bits = k1._bwd_pass_a(q, k, v, bias, gate, out, lse, do, DROPOUT_RATE, DROPOUT_SEED)[4]
    want = k1.pack_keep_bits(k1.dropout_mask(DROPOUT_SEED, b, h, t, t, DROPOUT_RATE, "cuda"))
    torch.cuda.synchronize()
    wrong = int((bits != want).sum().item())
    print(f"K2 packed keep mask B={b} H={h} T={t}: {bits.numel()} words, {wrong} differ from "
          f"the plain mask's")
    check(wrong == 0, f"K2's packed keep mask differs from the plain mask in {wrong} words")
    # the rate-0 entry with a keep buffer and the rate-0.1 constants: only
    # the dropout flag may select the instance without the mask
    sentinel = torch.full_like(bits, 0x5A5A5A5A)
    rows = torch.empty((b * h, bits.shape[3], 4), dtype=torch.float32, device="cuda")
    dq, dgate = torch.empty_like(q), torch.empty((b, h, t), dtype=torch.float32, device="cuda")
    ldb = -(-t // 4) * 4
    part = torch.empty((b, h, t, ldb), dtype=torch.float32, device="cuda")
    threshold, keep = k1.dropout_constants(DROPOUT_RATE)
    rc = k1._library().gated_bias_attention_bwd_a_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), bias.data_ptr(), bias.stride(1),
        gate.data_ptr(), lse.data_ptr(), rows.data_ptr(), sentinel.data_ptr(), dq.data_ptr(),
        dgate.data_ptr(), part.data_ptr(), b, h, t, HEAD_DIM, b, ldb, 0, DROPOUT_SEED,
        threshold, keep, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    touched = int((sentinel != 0x5A5A5A5A).sum().item())
    print(f"K2 pass A at rate 0 with a sentinel keep buffer: rc {rc}, {touched} of "
          f"{sentinel.numel()} words written")
    check(rc == 0 and touched == 0, f"K2's rate-0 pass A wrote {touched} keep words (rc {rc})")


def check_head_dim_128(gen) -> None:
    """K1's training instance and K2 at head dim 128 (no served model has it;
    the wrapper takes it: two 64-column halves per tile) against the plain
    version's forward and autograd, bf16, rate 0 and 0.1, within 2e-2 of each
    tensor's largest magnitude."""
    for t in (37, 130):
        for rate in (0.0, DROPOUT_RATE):
            q, k, v, do = (torch.randn((2, 3, t, 128), generator=gen, device="cuda").bfloat16()
                           for _ in range(4))
            pos = torch.randn((3, t, t), generator=gen, device="cuda")
            gate = 1.0 + torch.rand((2, 3, t), generator=gen, device="cuda")
            results = []
            for fn in (k1.flash_attention_gated_bias_trainable,
                       k1.flash_attention_gated_bias_reference):
                leaves = [x.clone().requires_grad_() for x in (q, k, v, pos, gate)]
                out = fn(*leaves, dropout_rate=rate, seed=DROPOUT_SEED)
                out.backward(do)
                results.append([out.detach()] + [x.grad for x in leaves])
            torch.cuda.synchronize()
            rel = [((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
                   for g, w in zip(*results)]
            print(f"K1+K2 vs plain bfloat16 D=128 B=2 H=3 T={t} rate={rate}: o and five gradients "
                  + ", ".join(f"{e:.2e}" for e in rel) + " of max magnitude (tolerance 2e-02)")
            check(all(np.isfinite(e) and e <= 2e-2 for e in rel),
                  f"K1/K2 at head dim 128 disagree with the plain version at T={t} rate={rate}")


def phase_trainable_kernels() -> list:
    """K1's training instance and K2 against the plain version's forward and
    autograd backward on the same inputs and cotangent, at the training shape,
    T in {37, 799} and B in {1, 5, 13} (pass A in one chunk, in chunks of one
    element, in chunks of unequal sizes); K2's d pos_bias bit for bit the same
    in two calls. Tolerance, of each
    tensor's largest magnitude: 1e-4 in float32 (reassociation; one wrong
    mask bit at T = 399 costs about 2.5e-3), 2e-2 in bfloat16 (the kernels
    round p, dS and W * m to bf16 for the tensor-core products, and sum in
    another order). K2's packed keep mask (bf16, pass B's only source of the
    mask) equal to the plain mask's bit for bit at T 37, 70, 399 and 799;
    head dim 128 at T 37 and 130; K2's passes timed alone at rate 0.1 and 0,
    and pass A at other numbers of batch chunks."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    tolerance = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    names = ("o", "dq", "dk", "dv", "dpos_bias", "dgate")
    main_err = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, t in ((2, 3, 37), (TRAIN_BATCH, TRAIN_HEADS, FRAMES), (2, 3, 799),
                        (1, TRAIN_HEADS, FRAMES), (5, TRAIN_HEADS, FRAMES),
                        (13, TRAIN_HEADS, FRAMES)):
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

    for b, h, t in ((2, 3, 37), (2, 3, 70), (TRAIN_BATCH, TRAIN_HEADS, FRAMES), (2, 3, 799)):
        check_keep_bits(b, h, t, gen)
    check_head_dim_128(gen)

    # timings at WavLM-Base training shapes, bf16, rate 0.1
    (q, k, v, pos, gate), do = trainable_inputs(TRAIN_BATCH, TRAIN_HEADS, FRAMES,
                                                torch.bfloat16, gen)
    bias = k1.padded_bias(pos, torch.bfloat16)  # as the trainable function saves it
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
    grads = [k1._backward(q, k, v, bias, gate, out, lse, do, DROPOUT_RATE, DROPOUT_SEED)
             for _ in range(2)]
    check(torch.equal(grads[0][3], grads[1][3]),
          "K2's d pos_bias differs between two calls on the same inputs")
    print("K2 d pos_bias: bit for bit the same in two calls on the same inputs")
    passes = {rate: pass_times(q, k, v, bias, gate, out, lse, do, rate)
              for rate in (DROPOUT_RATE, 0.0)}
    chunks = k1._pass_a_plan(q, DROPOUT_RATE)
    sweep = pass_a_by_chunks(lambda: pass_a_and_sum(q, k, v, bias, gate, out, lse, do,
                                                    DROPOUT_RATE), chunks, q.shape[0])
    bwd = {
        "ms": median_ms(lambda: k1._backward(q, k, v, bias, gate, out, lse, do, DROPOUT_RATE,
                                             DROPOUT_SEED)),
        "plain_ms": median_ms(lambda: torch.autograd.grad(plain, leaves, do,
                                                          retain_graph=True)),
        "library_ms": median_ms(lambda: torch.autograd.grad(lib, lib_leaves, do,
                                                            retain_graph=True)),
        **launches_per_call(lambda: k1._backward(q, k, v, bias, gate, out, lse, do,
                                                 DROPOUT_RATE, DROPOUT_SEED), K2_BF16_KERNELS),
        "passes": passes[DROPOUT_RATE],
        "passes_rate0": passes[0.0],
        "pass_a_chunks_by_s": {s: t for s, t in sweep.items()},
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


# K1's output tolerance per schedule, of the largest magnitude, bf16 inputs.
# f32 and bf16 (two passes, the row's max before any p is rounded, as the
# plain version): their p or w agree with the plain version's to f32
# rounding, so the outputs differ by at most one bf16 step of the output
# (2^-7 of the largest magnitude) where a sum lands near a rounding
# boundary. deferred (one pass, the online softmax): p is rounded relative
# to the running max, a different realisation of the same rounding, so the
# 2e-2 bound that phase_kernel holds K1 to stays.
SCHEDULE_TOLERANCE = {"f32": 2.0**-7, "deferred": 2e-2, "bf16": 2.0**-7}
GRAD_TOLERANCE = 2e-2  # K2 rounds dS and W * m to bf16 for its products


K1_K2 = {n for k in ("k1", "k1_train", "k2") for n in cuda_build.KERNEL_INSTANCES[k]}


def launched() -> dict:
    """The instances of K1 and K2 launched since the counters were last reset."""
    return {name: n for name, n in cuda_build.launches.items() if n and name in K1_K2}


def launch_counts(*kernels: str) -> dict:
    """The launches of `kernels` (keys of `cuda_build.KERNEL_INSTANCES`: "k1"
    is K1's inference instances) since the counters were last reset."""
    totals = cuda_build.launch_totals()
    return {kernel: totals[kernel] for kernel in kernels}


# each main path's run (single-file and streamed serving, the training
# epoch with validation, the distill-prune run) -> the instances of K1 and
# K2 it launched, read from the counters; an instance's `launches` in the
# kernels line is their sum
PATH_INSTANCES: dict = {}


def path_run(name: str, instances: dict) -> dict:
    PATH_INSTANCES[name] = dict(instances)
    return instances


def path_launches(instance: str) -> dict:
    """`launches` (the sum) and `launches_by_path` of `instance`."""
    by_path = {name: run.get(instance, 0) for name, run in PATH_INSTANCES.items()}
    return {"launches": sum(by_path.values()), "launches_by_path": by_path}


def worst_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst error over the largest magnitude."""
    return (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()


def abs_error(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


# The schedules told apart. In bf16 the worst error cannot do it: it is one
# rounding step of the output for every schedule. The mean error over the
# mean magnitude counts how many outputs moved and by how much. The f32 and
# bf16 instances round w or p as their plain versions do (but for rare
# flips where the f32 sums differ); another schedule's plain version rounds
# every weight differently. So an instance's mean error against its own
# plain version must be below SCHEDULE_APART of that against each other
# schedule's. The deferred instance rounds p relative to the running max:
# within one key tile (T <= KEY_TILE) that is the row max and the rule
# holds; over several tiles those before a row's max round differently from
# its plain version as well (a CPU emulation of the online max: 0.40 of the
# nearest other's at T 399, 0.48 at T 1499), and there DEFERRED_APART holds.
SCHEDULE_APART = 0.5
DEFERRED_APART = 0.75
KEY_TILE = 64  # keys per tile of K1's bf16 kernel (kBlockK)


def mean_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The mean error over the mean magnitude."""
    return ((got.float() - want.float()).abs().mean() / want.float().abs().mean()).item()


def schedules_apart(label: str, mode: str, got: torch.Tensor, plain: dict, margin: float) -> dict:
    """`got`'s mean error against each schedule's plain version in `plain`;
    fails unless its own (`mode`'s) is below `margin` times each other's."""
    means = {m: mean_error(got, want) for m, want in plain.items()}
    nearest_other = min(e for m, e in means.items() if m != mode)
    print(f"  {label}: mean error of the mean magnitude against the plain version of "
          + ", ".join(f"{m} {e:.3e}" for m, e in means.items())
          + f"; its own over the nearest other's {means[mode] / nearest_other:.3f} (limit {margin})")
    check(np.isfinite(means[mode]) and means[mode] < margin * nearest_other,
          f"{label} is not told apart from another schedule: {means}")
    return means


def phase_softmax_schedules() -> dict:
    """Every instance of K1's softmax schedules and the rate-0 instances of
    K1's training forward and K2, on the card, each held against the plain
    version of the same schedule and told apart from the others' plain
    versions (`schedules_apart`), the counters showing which instance
    launched, and timed beside its bound, its plain version and SDPA (L2
    flushed, median of 25): K1 inference in each schedule in float32, and
    in bf16 at the `base` shape (B 32, H 12, T 399), at B 16, T 1499
    (`whole`) and within one key tile (B 64, T 64; not timed); the f32
    schedule's instance with the dropout mask; the training forward (f32)
    and K2 at rate 0.1 and 0 at B 16, H 12, T 399, beside the deferred
    forward that the training instance ran before it took the f32
    schedule."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {"inference": {}, "train": {}, "bwd": {}}
    # float32 inputs (the CUDA-core kernel): "f32" and "deferred" differ by
    # reassociation only; "bf16" still rounds the shifted scores and p
    f32_tolerance = {"f32": 1e-4, "deferred": 1e-4, "bf16": 2.0**-7}
    for b, h, t in ((4, 12, FRAMES), (2, 3, 37)):
        args = attention_inputs(b, h, t, HEAD_DIM, torch.float32, gen)
        plain = {m: k1.flash_attention_gated_bias_reference(*args, softmax_mode=m)
                 for m in k1.SOFTMAX_MODES}
        for mode in k1.SOFTMAX_MODES:
            with k1.softmax_mode_scope(mode):
                cuda_build.reset_launches()
                got = k1.flash_attention_gated_bias(*args)
                torch.cuda.synchronize()
                instances = launched()
            err = worst_error(got, plain[mode])
            label = f"K1 {mode} schedule float32 B={b} H={h} T={t}"
            print(f"{label}: worst error {err:.3e} of the largest magnitude (tolerance "
                  f"{f32_tolerance[mode]:.1e}); launched {instances}")
            check(instances == {f"fwd_{mode}": 1} and err <= f32_tolerance[mode],
                  f"{label}: {err}, {instances}")
            # in float32 "f32" and "deferred" are one function up to
            # reassociation: each is told apart from "bf16" only
            schedules_apart(label, mode, got, plain if mode == "bf16" else
                            {m: plain[m] for m in (mode, "bf16")}, SCHEDULE_APART)
    # inference with dropout: the f32 schedule's instance with the mask
    for dtype, b, h, t in ((torch.float32, 2, 3, 37), (torch.bfloat16, BATCH, 12, FRAMES)):
        args = attention_inputs(b, h, t, HEAD_DIM, dtype, gen)
        tolerance = (f32_tolerance if dtype == torch.float32 else SCHEDULE_TOLERANCE)["f32"]
        with k1.softmax_mode_scope("f32"):
            cuda_build.reset_launches()
            got = k1.flash_attention_gated_bias(*args, dropout_rate=DROPOUT_RATE,
                                                seed=DROPOUT_SEED)
            torch.cuda.synchronize()
            instances = launched()
        err = worst_error(got, k1.flash_attention_gated_bias_reference(
            *args, DROPOUT_RATE, DROPOUT_SEED))
        label = f"K1 f32 schedule {str(dtype)[6:]} B={b} H={h} T={t} rate={DROPOUT_RATE}"
        print(f"{label}: worst error {err:.3e} of the largest magnitude (tolerance "
              f"{tolerance:.1e}); launched {instances}")
        check(instances == {"fwd_f32": 1} and err <= tolerance, f"{label}: {err}, {instances}")
    # bf16 at the `base` and `whole` shapes, timed, and within one key tile
    for b, t in ((BATCH, FRAMES), (16, WHOLE_FRAMES), (64, KEY_TILE)):
        timed = t > KEY_TILE
        args = attention_inputs(b, 12, t, HEAD_DIM, torch.bfloat16, gen)
        padded = (*args[:3], k1.padded_bias(args[3], torch.bfloat16), args[4])
        plain = {m: k1.flash_attention_gated_bias_reference(*args, softmax_mode=m)
                 for m in k1.SOFTMAX_MODES}
        if timed:
            library_ms = median_ms(lambda: library_attention(*args))
            mem_s, op_s = attention_bound_s(b, 12, t, HEAD_DIM, 2)
        for mode in k1.SOFTMAX_MODES:
            with k1.softmax_mode_scope(mode):
                cuda_build.reset_launches()
                got = k1.flash_attention_gated_bias(*padded)
                torch.cuda.synchronize()
                instances = launched()
                ms = median_ms(lambda: k1.flash_attention_gated_bias(*padded)) if timed else None
            errs = {m: worst_error(got, want) for m, want in plain.items()}
            label = f"K1 {mode} schedule bf16 B={b} H=12 T={t}"
            print(f"{label}: worst error {errs[mode]:.3e} of the largest magnitude against its "
                  f"plain version (tolerance {SCHEDULE_TOLERANCE[mode]:.2e}; against the "
                  "others' " + ", ".join(f"{m} {e:.3e}" for m, e in errs.items() if m != mode)
                  + f"); launched {instances}")
            check(instances == {f"fwd_{mode}": 1}, f"K1 {mode}: launched {instances}")
            check(np.isfinite(errs[mode]) and errs[mode] <= SCHEDULE_TOLERANCE[mode],
                  f"K1's {mode} schedule disagrees with its plain version: {errs[mode]}")
            means = schedules_apart(label, mode, got, plain, DEFERRED_APART
                                    if mode == "deferred" and t > KEY_TILE else SCHEDULE_APART)
            if not timed:
                continue
            row = {"instance": f"fwd_{mode}", "launched": instances,
                   "max_abs_err": abs_error(got, plain[mode]), "max_rel_err": errs[mode],
                   "tolerance": SCHEDULE_TOLERANCE[mode], "mean_rel_err": means, "ms": ms,
                   "plain_ms": median_ms(lambda: k1.flash_attention_gated_bias_reference(
                       *args, softmax_mode=mode)),
                   "bound_ms": 1e3 * max(mem_s, op_s),
                   "bound_by": "bytes" if mem_s >= op_s else "operations",
                   "library_ms": library_ms}
            out["inference"][(mode, b, t)] = row
            print(f"  kernel {ms:.4f} ms, plain {row['plain_ms']:.4f} ms, SDPA {library_ms:.4f} "
                  f"ms, bound {row['bound_ms']:.4f} ms (by {row['bound_by']})")

    (q, k, v, pos, gate), do = trainable_inputs(TRAIN_BATCH, TRAIN_HEADS, FRAMES,
                                                torch.bfloat16, gen)
    bias = k1.padded_bias(pos, torch.bfloat16)  # as the trainable function saves it
    mask = (gate[..., None] * pos).to(torch.bfloat16)
    bounds = trainable_bound_s(TRAIN_BATCH, TRAIN_HEADS, FRAMES, HEAD_DIM, 2)
    names = ("o", "dq", "dk", "dv", "dpos_bias", "dgate")
    for rate in (DROPOUT_RATE, 0.0):
        results = []
        with k1.softmax_mode_scope("deferred"):  # the training forward is f32 whatever is set
            for fn in (k1.flash_attention_gated_bias_trainable,
                       k1.flash_attention_gated_bias_reference):
                cuda_build.reset_launches()
                leaves = [x.clone().requires_grad_() for x in (q, k, v, pos, gate)]
                o = fn(*leaves, dropout_rate=rate, seed=DROPOUT_SEED)
                o.backward(do)
                results.append([o.detach()] + [x.grad for x in leaves])
                if fn is k1.flash_attention_gated_bias_trainable:
                    torch.cuda.synchronize()
                    instances = launched()
        errs = [worst_error(got, want) for got, want in zip(*results)]
        suffix = "" if rate > 0 else "_rate0"
        want = {f"train{suffix}": 1, f"bwd{suffix}": 1}
        check(instances == want, f"rate {rate}: launched {instances}, expected {want}")
        check(errs[0] <= SCHEDULE_TOLERANCE["f32"] and max(errs[1:]) <= GRAD_TOLERANCE,
              f"K1 training / K2 at rate {rate} disagree with the plain version: {errs}")
        # timings: the f32 forward, at rate 0 the deferred forward with the
        # log-sum-exp (K1 has no deferred instance with the mask), K2, each
        # beside the plain version and SDPA
        _, lse = k1._forward_train(q, k, v, bias, gate, rate, DROPOUT_SEED)
        fwd_out = k1._forward_train(q, k, v, bias, gate, rate, DROPOUT_SEED)[0]
        leaves = [x.clone().requires_grad_() for x in (q, k, v, pos, gate)]
        plain = k1.flash_attention_gated_bias_reference(*leaves, rate, DROPOUT_SEED)
        lib_leaves = [x.clone().requires_grad_() for x in (q, k, v, mask)]
        lib = F.scaled_dot_product_attention(*lib_leaves[:3], attn_mask=lib_leaves[3],
                                             dropout_p=rate)
        fwd = {"instance": f"train{suffix}", "launched": {f"train{suffix}": 1},
               "max_abs_err": abs_error(results[0][0], results[1][0]), "max_rel_err": errs[0],
               "tolerance": SCHEDULE_TOLERANCE["f32"],
               "ms": median_ms(lambda: k1._forward_train(q, k, v, bias, gate, rate,
                                                         DROPOUT_SEED)),
               "plain_ms": median_ms(lambda: k1.flash_attention_gated_bias_reference(
                   q, k, v, pos, gate, rate, DROPOUT_SEED)),
               "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask, dropout_p=rate))}
        bwd = {"instance": f"bwd{suffix}", "launched": {f"bwd{suffix}": 1},
               "max_abs_err": max(abs_error(g, w) for g, w in zip(results[0][1:], results[1][1:])),
               "max_rel_err": max(errs[1:]), "tolerance": GRAD_TOLERANCE,
               "ms": median_ms(lambda: k1._backward(q, k, v, bias, gate, fwd_out, lse, do, rate,
                                                    DROPOUT_SEED)),
               "plain_ms": median_ms(lambda: torch.autograd.grad(plain, leaves, do,
                                                                 retain_graph=True)),
               "library_ms": median_ms(lambda: torch.autograd.grad(lib, lib_leaves, do,
                                                                   retain_graph=True))}
        if rate == 0.0:
            fwd["deferred_ms"] = median_ms(lambda: k1._forward(q, k, v, bias, gate, "deferred",
                                                               0.0, 0, lse=True))
        for key, row in (("train", fwd), ("bwd", bwd)):
            mem_s, op_s = bounds["fwd" if key == "train" else key]
            row["bound_ms"] = 1e3 * max(mem_s, op_s)
            row["bound_by"] = "bytes" if mem_s >= op_s else "operations"
            out[key][rate] = row
        print(f"K1 training (f32 schedule) + K2 bf16 B={TRAIN_BATCH} H={TRAIN_HEADS} T={FRAMES} "
              f"rate={rate}: launched {instances}; worst error of the largest magnitude "
              + ", ".join(f"{n} {e:.2e}" for n, e in zip(names, errs))
              + f" (tolerance o {SCHEDULE_TOLERANCE['f32']:.2e}, gradients {GRAD_TOLERANCE:.0e})")
        deferred = (f" (the deferred schedule's forward {fwd['deferred_ms']:.4f} ms)"
                    if rate == 0.0 else "")
        print(f"  K1 training rate={rate}: kernel {fwd['ms']:.4f} ms{deferred}, plain "
              f"{fwd['plain_ms']:.4f} ms, SDPA {fwd['library_ms']:.4f} ms, bound "
              f"{fwd['bound_ms']:.4f} ms")
        print(f"  K2 rate={rate}: kernel {bwd['ms']:.4f} ms, plain {bwd['plain_ms']:.4f} ms, "
              f"SDPA's backward {bwd['library_ms']:.4f} ms "
              f"({'slower' if bwd['ms'] > bwd['library_ms'] else 'faster'} than SDPA by "
              f"{bwd['ms'] / bwd['library_ms']:.2f}x), bound {bwd['bound_ms']:.4f} ms")
    return out


def write_kaldi_dir(root: Path, name: str, durations, seed: int, channels: int = 1) -> Path:
    """A synthetic Kaldi directory: per recording two to four speakers
    (tones with noise) in turns of 1-5 s that overlap, PCM16 WAVs, RTTM and
    UEM; with `channels` > 1 each recording is heard by that many
    microphones (`microphones`)."""
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
        write_wav(path, microphones(wave.astype(np.float32), channels, seed + r), 16000)
        scp.append(f"{rec} {path}")
        uem.append(f"{rec} 1 0.00 {dur:.2f}")
    for fname, lines in (("wav.scp", scp), ("rttm", rttm), ("all.uem", uem)):
        (out / fname).write_text("\n".join(lines) + "\n")
    return out


def microphones(wave: np.ndarray, channels: int, seed: int) -> np.ndarray:
    """(channels, N) recordings of one source: per microphone a delay of
    0-31 samples, a gain of 0.5-1 and noise of its own; one channel is the
    wave itself."""
    if channels == 1:
        return wave[None]
    rng = np.random.default_rng(seed)
    delays, gains = rng.integers(0, 32, channels), rng.uniform(0.5, 1.0, channels)
    mics = np.stack([g * np.roll(wave, d) for d, g in zip(delays, gains)])
    return (mics + 0.003 * rng.standard_normal(mics.shape)).astype(np.float32)


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
        counts = tuple(launch_counts("k1_train", "k2").values())
        self.steps.append({**metrics, "ms": 1e3 * (now - self.last),
                           "k1": counts[0] - self.counts[0], "k2": counts[1] - self.counts[1]})
        self.last, self.counts = now, counts


def profiled_events(run, record_shapes: bool = False, warmup: int = 1) -> list:
    """The profiler's events of one `run()`. It runs `warmup` times and once
    more under the profiler, a synchronisation between, and only the events
    of the last call are kept: late in this long process the profiler missed
    about the first 30 kernels of a session (in a fresh process it does
    not), which on a short call is a whole stage (a SSeRiouSS eval batch
    lost its extractor), so a call of a few kernels needs more warm-up
    calls than one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        for _ in range(warmup):
            run()
        torch.cuda.synchronize()
        with record_function("measured call"):
            run()
            torch.cuda.synchronize()
    events = prof.events()
    begin = min(e.time_range.start for e in events
                if e.name == "measured call" and e.device_type == DeviceType.CPU)
    kept = [e for e in events if e.time_range.start >= begin and e.name != "measured call"]
    check(any(e.device_type == DeviceType.CUDA for e in kept),
          "the profiler recorded no device activity")
    return kept


def kernel_rows(events) -> list:
    """(device ms, launches, name) of each kernel name, largest first."""
    from torch.autograd import DeviceType

    rows = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            ms, n = rows.get(e.name, (0.0, 0))
            rows[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    return sorted(((ms, n, name) for name, (ms, n) in rows.items()), reverse=True)


def profile_train_step(step, card: str, top: int = 12) -> float:
    """One more train step (`step()`) under torch.profiler: device time by
    kernel, the share of K1 and K2, and the operators (with their input
    shapes) whose kernels take the most device time. Returns the step's
    device milliseconds."""
    from torch.autograd import DeviceType

    events = profiled_events(step, record_shapes=True)
    ops = {}
    for e in events:
        if (e.device_type == DeviceType.CPU and e.name.startswith("aten::")
                and e.name not in ("aten::to", "aten::_to_copy")):
            key = (e.name, str(e.input_shapes)[:120])
            ms, n = ops.get(key, (0.0, 0))
            ops[key] = (ms + e.device_time_total / 1e3, n + 1)
    for (name, shapes), (ms, n) in sorted(ops.items(), key=lambda kv: -kv[1][0])[:5]:
        print(f"  operator {ms:9.3f} ms device time x{n:<4d} {name} {shapes}")
    rows = kernel_rows(events)
    total = sum(ms for ms, _, _ in rows)
    k1_ms = sum(ms for ms, _, name in rows if "gated_bias_attention_bf16_kernel" in name)
    k2_ms = sum(ms for ms, _, name in rows if "attention_bwd_" in name)
    print(f"profiled train step {card}: {total:.3f} ms of device time; K1 {k1_ms:.3f} ms "
          f"({100 * k1_ms / total:.1f}%), K2 {k2_ms:.3f} ms ({100 * k2_ms / total:.1f}%)")
    for ms, n, name in rows[:top]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {name[:100]}")
    return total


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
        cuda_build.reset_launches()
        t0 = recorder.last = time.perf_counter()
        val = trainer.train(train_loader, val_loader)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(zip(("inference", "train", "bwd"),
                            launch_counts("k1", "k1_train", "k2").values()))
        instances = path_run("training with validation", launched())
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
        # the steps at rate 0.1 (f32 schedule), validation in the f32 schedule
        print(f"instances launched in the run: {instances}")
        check(instances == {"train": launches["train"], "bwd": launches["bwd"],
                            "fwd_f32": launches["inference"]},
              f"the training run launched other instances: {instances}")
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
        batch = next(iter(train_loader))
        profile_train_step(lambda: train_step(trainer.state, batch, trainer.tc.seed,
                                              trainer.compute_dtype), card)
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


def unfolded_resnet(model: ResNet, fbank: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The ResNet34 as the port ran it before its BatchNorms were folded:
    channels first, each convolution then its BatchNorm's scale and
    shift computed from the running statistics, the ReLUs and residual adds
    on their own. `phase_resnet`'s yardstick."""
    def conv(c, x):
        return F.conv2d(x, c.weight, stride=c.stride, padding=c.padding)

    def bn(b, x):
        inv = torch.rsqrt(b.running_var + b.eps)
        return (x * (b.weight * inv)[:, None, None]
                + (b.bias - b.running_mean * b.weight * inv)[:, None, None])

    x = torch.relu(bn(model.bn1, conv(model.conv1, fbank.transpose(1, 2)[:, None])))
    for block in model.blocks():
        out = torch.relu(bn(block.bn1, conv(block.conv1, x)))
        out = bn(block.bn2, conv(block.conv2, out))
        sc = bn(block.shortcut[1], conv(block.shortcut[0], x)) if len(block.shortcut) else x
        x = torch.relu(out + sc)
    b, c, h, w = x.shape
    stats = resnet_module.stats_pool(x.reshape(b, c * h, w), weights)
    return F.linear(stats, model.seg_1.weight, model.seg_1.bias)


def graphed(run):
    """`run` captured as a CUDA graph after three eager calls on a side
    stream: the replay, as the serving path runs the ResNet."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    return graph.replay


RESNET_ROWS, RESNET_FRAMES = 32, 798  # a batch of 8 s windows' fbank frames


def phase_resnet(resnet_sd) -> dict:
    """The ResNet34 at 32 rows x 8 s with its BatchNorms folded, channels-last,
    each convolution's bias, residual and ReLU in its epilogue: the stem's
    kernel against its plain version (float32 without TF32, bfloat16), the
    forward against the same folds through the plain versions and against
    the unfolded channels-first formula (TF32, as served), the launch
    registry's counts, the forward's time as a CUDA graph beside its bound
    and beside the unfolded formula's, the stem's beside its bound, its
    plain version and cuDNN's fused convolution, and the kernels of one
    replay: no cuDNN layout transpose among them. Returns the stem's row
    of the kernels line."""
    from portbench.flops import resnet_flops

    model = ResNet(ResNetConfig())
    model.load_state_dict(resnet_sd)
    model = model.cuda().eval()
    cfg = model.cfg
    gen = torch.Generator().manual_seed(0)
    fbank = torch.randn((RESNET_ROWS, RESNET_FRAMES, cfg.feat_dim), generator=gen).cuda()
    fbank = fbank - fbank.mean(dim=1, keepdim=True)
    t_out = cfg.num_frames(160 * (RESNET_FRAMES - 1) + 400)
    weights = (torch.rand((RESNET_ROWS, 4, t_out), generator=gen) < 0.4).float().cuda()
    with torch.inference_mode():
        stem = model.folded(torch.float32)[0]
        for dtype, limit in ((torch.float32, 1e-6), (torch.bfloat16, 2.0**-8)):
            folded = model.folded(dtype)[0]
            x = fbank.to(dtype)
            with strict_float32():
                want = resnet_stem.stem_conv_reference(x, folded.weight, folded.bias).float()
            got = resnet_stem.stem_conv(x, folded.weight, folded.bias).float()
            err = worst_error(got, want)
            print(f"ResNet stem kernel vs plain version, {dtype}: worst error {err:.3e} "
                  f"of the largest magnitude")
            check(err <= limit, f"the stem kernel disagrees with its plain version in {dtype}")

        fused = model(fbank, weights)
        saved = resnet_module.stem_conv, resnet_module.folded_conv
        resnet_module.stem_conv = resnet_stem.stem_conv_reference
        resnet_module.folded_conv = resnet_module.folded_conv_reference
        try:
            plain = model(fbank, weights)
        finally:
            resnet_module.stem_conv, resnet_module.folded_conv = saved
        unfolded = unfolded_resnet(model, fbank, weights)
        with strict_float32():
            reference = unfolded_resnet(model, fbank, weights)
        rel = {name: ((out - reference).norm() / reference.norm()).item()
               for name, out in (("fused", fused), ("plain", plain), ("unfolded", unfolded))}
        fused_vs_plain = ((fused - plain).norm(dim=-1) / plain.norm(dim=-1)).max().item()
        print(f"ResNet34 32 x 8 s, TF32: error against the float32 unfolded formula "
              f"{rel}; fused against plain versions, worst row {fused_vs_plain:.3e}")
        check(fused_vs_plain <= 1e-3, "the fused ResNet path disagrees with its plain versions")
        check(rel["fused"] <= 3e-3, "the fused ResNet path disagrees with the float32 formula")

        cuda_build.reset_launches()
        model(fbank, weights)
        counts = {n: cuda_build.launches[n] for n in ("resnet_stem", "resnet_conv", "resnet_fold")}
        print(f"ResNet34 forward launches: {counts}")
        check(counts == {"resnet_stem": 1, "resnet_conv": 35, "resnet_fold": 0},
              f"expected 1 stem, 35 fused convolutions and no fold: {counts}")

        arch = {"resnet": {"m_channels": cfg.m_channels, "feat_dim": cfg.feat_dim,
                           "num_blocks": list(cfg.num_blocks), "embed_dim": cfg.embed_dim}}
        bound = resnet_flops(arch, RESNET_FRAMES, 4) * RESNET_ROWS / 495e12 * 1e3
        new_ms = median_ms(graphed(lambda: model(fbank, weights)))
        old_ms = median_ms(graphed(lambda: unfolded_resnet(model, fbank, weights)))
        print(f"ResNet34 forward at 32 x 8 s as a CUDA graph: folded channels-last "
              f"{new_ms:.4f} ms, unfolded channels-first {old_ms:.4f} ms, bound {bound:.4f} ms "
              f"(TF32 at 495 TFLOP/s)")

        stem_ms = median_ms(lambda: resnet_stem.stem_conv(fbank, stem.weight, stem.bias))
        plain_ms = median_ms(lambda: resnet_stem.stem_conv_reference(fbank, stem.weight, stem.bias))
        library_ms = median_ms(lambda: torch.cudnn_convolution_relu(
            fbank.transpose(1, 2)[:, None].contiguous(memory_format=torch.channels_last),
            stem.weight, stem.bias, (1, 1), (1, 1), (1, 1), 1))
        out_bytes = RESNET_ROWS * cfg.m_channels * cfg.feat_dim * RESNET_FRAMES * 4
        stem_bound = (out_bytes + fbank.numel() * 4) / 3.35e12 * 1e3
        print(f"ResNet stem at 32 x 8 s, float32: kernel {stem_ms:.4f} ms, bound {stem_bound:.4f} "
              f"ms (bytes), plain version {plain_ms:.4f} ms, cuDNN's fused convolution on the "
              f"channels-last image {library_ms:.4f} ms")

        replay = graphed(lambda: model(fbank, weights))
        events = profiled_events(replay)
        rows = kernel_rows(events)
        print(f"kernels of one ResNet34 replay: {sum(n for _, n, _ in rows)} launches, "
              f"{sum(ms for ms, _, _ in rows):.4f} ms")
        for ms, n, name in rows[:12]:
            print(f"  {ms:9.4f} ms  x{n:<4d} {name[:110]}")
        transposes = [name for _, _, name in rows if "nchwToNhwc" in name or "nhwcToNchw" in name]
        check(not transposes, f"cuDNN transposed a layout in the ResNet34: {transposes}")
    return {"name": "resnet_stem", "route": "cuda",
            "source": "diarizen_tpu_torch/csrc/resnet_stem.cu", "replaces": None,
            "ms": stem_ms, "bound_ms": stem_bound, "plain_ms": plain_ms,
            "library_ms": library_ms, "resnet34_ms": new_ms, "unfolded_resnet34_ms": old_ms,
            "resnet34_bound_ms": bound}


def phase_profile(what: str, run, top: int = 15) -> float:
    """`run()` under torch.profiler: device time by kernel (the `top`
    kernels and every kernel of the port's), and the share of the run's
    span in which any kernel ran. Returns the milliseconds in which any
    kernel ran."""
    from torch.autograd import DeviceType

    events = profiled_events(run)
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in kernels:  # union of kernel intervals
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    device_ms = sum(b - a for a, b in kernels) / 1e3
    print(f"profile of {what}: {len(kernels)} kernels, {device_ms:.3f} ms of device time in a "
          f"{span / 1e3:.3f} ms span; device busy {100 * busy / span:.1f}% of the span")
    ours = ("gated_bias_attention", "attention_bwd", "dbias_sum", "residual_layer_norm",
            "conv_stage", "conv_chain")
    for i, (ms, n, name) in enumerate(kernel_rows(events)):
        if i < top or any(k in name for k in ours):  # and the port's own wherever they rank
            print(f"  {ms:9.3f} ms  x{n:<5d} {name[:100]}")
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


def conv_chain_inputs(b, t1, dtype, gen, guard: int = 4 * 512):
    """x1 (b, t1, 512) and the six (k, 512, 512) weights at unit output scale.
    x1 is a view into a larger buffer with NaN before and after it: a read
    outside the tensor poisons the output."""
    n = b * t1 * k5.C
    buf = torch.full((n + 2 * guard,), float("nan"), dtype=dtype, device="cuda")
    x = buf[guard:guard + n].view(b, t1, k5.C)
    x.copy_(torch.randn((b, t1, k5.C), generator=gen, device="cuda"))
    weights = [(1.5 / (k * k5.C) ** 0.5) * torch.randn((k, k5.C, k5.C), generator=gen,
                                                        device="cuda") for k in k5.KERNELS]
    return x, weights


def conv_chain_bound_s(b: int, t_out: int, itemsize: int, flop_rate: float) -> tuple:
    """(bytes / HBM rate, flops / peak) of one K5 launch: the input frames
    that t_out outputs read and the weights read once, the output written
    once; each stage's product on the frames the next stage reads."""
    frames, flops = t_out, 0
    for k in reversed(k5.KERNELS):
        flops += 2 * k * k5.C * k5.C * frames * b
        frames = 2 * (frames - 1) + k
    weights = sum(k5.KERNELS) * k5.C * k5.C
    moved = (b * (frames + t_out) * k5.C + weights) * itemsize
    return moved / HBM_BYTES_PER_S, flops / flop_rate


def library_conv_chain(x_cf, weights_oik):
    """Six PyTorch convolutions and GELUs, channels first, computing K5's
    function the way the model does with the route off: a yardstick only."""
    for w in weights_oik:
        x_cf = F.gelu(F.conv1d(x_cf, w, stride=2))
    return x_cf


def conv_chain_stages(x, packed) -> None:
    """Each bfloat16 stage GEMM of one K5 call timed alone (its library
    function called the way the wrapper calls it), with its share of the
    tensor cores' peak."""
    lib = k5._library()
    stream = torch.cuda.current_stream().cuda_stream
    src, t_in, w_ptr = x, x.shape[1], packed.flat.data_ptr()
    for s, (k, t_s) in enumerate(zip(k5.KERNELS, k5.stage_frames(FRAMES))):
        dst = torch.empty((x.shape[0], t_s, k5.C), dtype=x.dtype, device=x.device)
        args = (src.data_ptr(), w_ptr, dst.data_ptr(), x.shape[0], t_in, t_s, k, stream)
        check(lib.conv_chain_stage_bf16(*args) == 0, f"K5 stage {s + 1} did not launch")
        ms = median_ms(lambda: lib.conv_chain_stage_bf16(*args), reps=9)
        flops = 2 * x.shape[0] * t_s * k * k5.C * k5.C
        print(f"  conv_chain stage {s + 1} ({x.shape[0]} x {t_s} frames, {k} taps): {ms:.4f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s ({100 * flops / ms / 1e-3 / BF16_FLOP_PER_S:.1f}% "
              f"of the bf16 peak)")
        src, t_in, w_ptr = dst, t_s, w_ptr + 2 * k * k5.C * k5.C


def phase_conv_chain() -> dict:
    """K5 against its plain version on the card, within 1e-4 (float32: the
    kernel sums in another order than cuDNN) and 2e-2 (bfloat16: the plain
    version rounds each convolution to bfloat16 before its GELU, the kernel
    after it) of the output's largest magnitude, at ragged sizes with the
    input exactly as long as the outputs need and, once, longer, and at the
    two shapes the `base` path gives it (a full batch and the 13-window tail
    batch of a 120 s file, T1 = 25599 from layer 0), and at (5, 200) from a
    longer input; then timed at the serving shape, each bf16 stage alone
    too."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    tolerance = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    main_err = 0.0
    path_t1 = (128000 - 10) // 5 + 1  # layer 0's output frames for an 8 s window
    tail = ((AUDIO_SECONDS * 10 - 80) // 8 + 1) % BATCH  # the last batch of a file: 8 s windows, 0.8 s hop
    exact = [(b, t_out, k5.min_input_frames(t_out))
             for b, t_out in ((1, 1), (2, 32), (3, 65), (tail, FRAMES), (BATCH, FRAMES))]
    # (5, 200) with a longer input: every stage's frames per batch element are odd
    cases = exact + [(3, 65, k5.min_input_frames(65) + 37), (5, 200, k5.min_input_frames(200) + 301),
                     (tail, FRAMES, path_t1), (BATCH, FRAMES, path_t1)]
    for dtype in (torch.bfloat16, torch.float32):
        for b, t_out, t1 in cases:
            x, weights = conv_chain_inputs(b, t1, dtype, gen)
            got = k5.fused_conv_chain(x, weights, t_out)
            torch.cuda.synchronize()
            want = k5.conv_chain_plain(x, [w.to(dtype) for w in weights], t_out)
            scale = want.float().abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            print(f"K5 vs plain {str(dtype)[6:]} B={b} T1={t1} t_out={t_out}: max abs err "
                  f"{err:.3e} of max magnitude {scale:.3f} (tolerance {tolerance[dtype]:.0e})")
            check(got.shape == (b, t_out, k5.C) and got.dtype == dtype, "K5 output type or shape")
            check(np.isfinite(err) and err <= tolerance[dtype] * scale,
                  f"K5 disagrees with its plain version: {err} of {scale} at {dtype} B={b} "
                  f"t_out={t_out}")
            if dtype == torch.bfloat16 and (b, t_out, t1) == (BATCH, FRAMES, path_t1):
                main_err = err
            del x, got, want

    # timings at the serving shape: layer 0's output for one batch of 32 windows of 8 s
    t1 = path_t1
    x, weights = conv_chain_inputs(BATCH, t1, torch.bfloat16, gen)
    packed = k5.pack_weights(weights, torch.bfloat16, "cuda")
    x_cf = x.transpose(1, 2).contiguous()
    weights_oik = [w.to(torch.bfloat16).permute(2, 1, 0).contiguous() for w in weights]
    row = {
        "ms": median_ms(lambda: k5.fused_conv_chain(x, packed, FRAMES), reps=9),
        "plain_ms": median_ms(lambda: k5.conv_chain_plain(x, packed.taps, FRAMES), reps=9),
        "library_ms": median_ms(lambda: library_conv_chain(x_cf, weights_oik), reps=9),
    }
    mem_s, op_s = conv_chain_bound_s(BATCH, FRAMES, 2, BF16_FLOP_PER_S)
    print(f"conv_chain bf16 B={BATCH} T1={t1} t_out={FRAMES}: kernel {row['ms']:.4f} ms in "
          f"{k5.CUDA_LAUNCHES[torch.bfloat16]} CUDA launches, plain {row['plain_ms']:.4f} ms, "
          f"library {row['library_ms']:.4f} ms, bound {1e3 * max(mem_s, op_s):.4f} ms "
          f"({1e3 * mem_s:.4f} bytes, {1e3 * op_s:.4f} operations)")
    conv_chain_stages(x, packed)
    x32, w32 = conv_chain_inputs(BATCH, t1, torch.float32, gen)
    packed32 = k5.pack_weights(w32, torch.float32, "cuda")
    f32_ms = median_ms(lambda: k5.fused_conv_chain(x32, packed32, FRAMES), reps=3, warmup=1)
    mem32_s, op32_s = conv_chain_bound_s(BATCH, FRAMES, 4, F32_FLOP_PER_S)
    print(f"conv_chain f32 at the same shape: kernel {f32_ms:.3f} ms in "
          f"{k5.CUDA_LAUNCHES[torch.float32]} CUDA launch, bound {1e3 * max(mem32_s, op32_s):.4f} ms")
    return {
        "name": "conv_chain", "route": "cuda",
        "source": "diarizen_tpu_torch/csrc/conv_chain.cu",
        "replaces": "diarizen_tpu/ops/conv_chain.py:83",
        "max_abs_err": main_err, **row,
        "bound_ms": 1e3 * max(mem_s, op_s),
        "bound_by": "bytes" if mem_s >= op_s else "operations",
    }


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
            cuda_build.reset_launches()
            with torch.inference_mode():
                scores[fused] = model(windows)
            counts = tuple(launch_counts("k3", "k4").values())
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
    """Streamed serving of SERVING_FILES different 120 s files at full width,
    the fused-LN route on; returns the launches of K1, K3 and K4 over the
    timed streamed pass."""
    waves = [make_wave(AUDIO_SECONDS, seed=i) for i in range(SERVING_FILES)]
    uris = [f"file{i}" for i in range(SERVING_FILES)]
    wavlm = eend_cfg.wavlm
    batches = -(-sum(pipeline.seg_inference.num_chunks(waves[0].shape[1])) // BATCH)
    expected = {"k1": SERVING_FILES * batches * sum(wavlm.use_attention),
                "k3": SERVING_FILES * batches * sum(wavlm.use_attention),
                "k4": SERVING_FILES * batches * sum(wavlm.use_feed_forward)}

    def stream():
        return [a.to_rttm() for a in pipeline.stream(iter(waves), 16000, uris=uris)]

    def one_by_one():
        return [pipeline(w, 16000, uri=u).to_rttm() for w, u in zip(waves, uris)]

    try:
        set_fused_ln(True)
        print(f"stream warm-up: {timed_pass(stream):.3f} s")
        cuda_build.reset_launches()
        streamed = []
        seconds = timed_pass(lambda: streamed.extend(stream()))
        launches = launch_counts("k1", "k3", "k4")
        path_run("streamed serving", launched())
        print(f"streamed pass {card}: {SERVING_FILES} x {AUDIO_SECONDS} s in {seconds:.4f} s = "
              f"{SERVING_FILES * AUDIO_SECONDS / seconds:.2f} audio-s/s; launches K1 "
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
              f"{SERVING_FILES} files")

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
        audio = SERVING_FILES * AUDIO_SECONDS
        for (mode, fused), secs in times.items():
            rates = sorted(audio / t for t in secs)
            print(f"throughput {card}: {mode}, fused-LN {'on' if fused else 'off'}: median "
                  f"{float(np.median(rates)):.2f} audio-s/s of {STREAM_REPEATS} passes over "
                  f"{SERVING_FILES} x {AUDIO_SECONDS} s ({', '.join(f'{r:.2f}' for r in rates)})")

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


SNAPSHOT_TOML = """\
[model]
path = "diarizen.models.eend.model_wavlm_conformer.Model"
[model.args]
wavlm_src = "{wavlm_src}"
wavlm_layer_num = {layer_num}
wavlm_feat_dim = {feat_dim}
attention_in = 256
ffn_hidden = 1024
num_head = 4
num_layer = 4
dropout = 0.1
chunk_size = 8
use_posi = false
output_activate_function = false
selected_channel = 0
max_speakers_per_chunk = 4

[inference]
[inference.args]
seg_duration = 8
segmentation_step = 0.1
batch_size = 32
apply_median_filtering = true

[clustering]
[clustering.args]
method = "VBxClustering"
min_speakers = 1
max_speakers = 8
ahc_criterion = "distance"
ahc_threshold = 0.6
Fa = 0.07
Fb = 0.8
lda_dim = 128
max_iters = 20
"""

# the two served models: preset, WavLM width, hidden states in the weighted sum
SNAPSHOT_MODELS = {"base": ("wavlm_base", 768, 13), "large_s80_md": ("wavlm_large_s80_md", 1024, 25)}


def write_snapshot(root: Path, name: str) -> Path:
    """A snapshot directory the way a released one looks: config.toml with
    the reference's class path and VBx clustering, pytorch_model.bin (seeded
    random weights at the preset's full width) and a plda/ directory at the
    ResNet34's 256 -> 128 dimensions."""
    wavlm_src, feat_dim, layer_num = SNAPSHOT_MODELS[name]
    snap = root / name
    (snap / "plda").mkdir(parents=True)
    (snap / "config.toml").write_text(SNAPSHOT_TOML.format(
        wavlm_src=wavlm_src, feat_dim=feat_dim, layer_num=layer_num))
    cfg = EendConfig(wavlm=WavLMConfig.from_preset(wavlm_src), conformer=ConformerConfig(),
                     wavlm_layer_num=layer_num, wavlm_feat_dim=feat_dim)
    torch.save(random_state_dict(EendModel(cfg), seed=10 + len(name)), snap / "pytorch_model.bin")
    write_plda(snap / "plda")
    return snap


def write_plda(plda: Path) -> None:
    """A seeded PLDA directory at the ResNet34's 256 -> 128 dimensions."""
    rng = np.random.default_rng(3)
    np.savez(plda / "xvec_transform.npz", mean1=0.1 * rng.standard_normal(256),
             mean2=0.1 * rng.standard_normal(128), lda=rng.standard_normal((256, 128)) / 16.0)
    tr = rng.standard_normal((128, 128)) / 12.0 + np.eye(128)
    psi = np.sort(rng.uniform(0.5, 5.0, size=128))[::-1]
    np.savez(plda / "plda.npz", mu=0.1 * rng.standard_normal(128), tr=tr, psi=psi)


def check_rttm(text: str, uri: str) -> int:
    lines = text.splitlines()
    check(len(lines) > 0, f"{uri}: no speech found")
    for line in lines:
        parts = line.split()
        check(len(parts) == 10 and parts[0] == "SPEAKER" and parts[1] == uri
              and float(parts[3]) >= 0 and float(parts[4]) > 0, f"bad RTTM line {line!r}")
    return len(lines)


def rttm_disagreement(a: str, b: str, step: float = 0.01) -> float:
    """Share of the speech time on which two RTTM texts disagree, speakers
    matched one to one for the largest overlap, on a grid of `step` s."""
    def grid(text):
        turns = [(line.split()[7], float(line.split()[3]), float(line.split()[4]))
                 for line in text.splitlines()]
        end = max((t0 + d for _, t0, d in turns), default=0.0)
        labels = sorted({spk for spk, _, _ in turns})
        out = np.zeros((len(labels), int(round(end / step)) + 1), bool)
        for spk, t0, d in turns:
            out[labels.index(spk), int(round(t0 / step)): int(round((t0 + d) / step))] = True
        return out
    ga, gb = grid(a), grid(b)
    n, k = max(ga.shape[1], gb.shape[1]), max(ga.shape[0], gb.shape[0])
    pa, pb = np.zeros((k, n), bool), np.zeros((k, n), bool)
    pa[: ga.shape[0], : ga.shape[1]] = ga
    pb[: gb.shape[0], : gb.shape[1]] = gb
    overlap = (pa[:, None, :] & pb[None, :, :]).sum(-1)
    rows, cols = linear_sum_assignment(-overlap)
    wrong = sum(int((pa[r] ^ pb[c]).sum()) for r, c in zip(rows, cols))
    return wrong / max(1, int(pa.sum()))


def file_windows(seg, wave: np.ndarray) -> torch.Tensor:
    """(num_chunks, window) windows of one file on the card."""
    dev_wave, starts = seg.prepare_wave(wave)
    idx = torch.as_tensor(starts, device=dev_wave.device)[:, None] + torch.arange(
        seg.window_size, device=dev_wave.device)
    return dev_wave[idx]


def route_scores(model, windows: torch.Tensor, dtype: torch.dtype, chain: bool) -> torch.Tensor:
    set_conv_chain(chain)
    try:
        with torch.inference_mode():
            return torch.cat([model(windows[i: i + BATCH], compute_dtype=dtype)
                              for i in range(0, len(windows), BATCH)])
    finally:
        set_conv_chain(None)


def compare_routes(model, windows, dtype, score_limit: float, flip_limit: float) -> None:
    """Powerset scores of one file's windows with the conv-chain route on
    against off. A hard decision can flip only where the top-2 margin is
    below twice the score difference; the scores must agree within
    `score_limit` and at most `flip_limit` of the frames may flip."""
    before = cuda_build.launch_totals()["k5"]
    off = route_scores(model, windows, dtype, False)
    check(cuda_build.launch_totals()["k5"] == before, "the ordinary route launched K5")
    on = route_scores(model, windows, dtype, True)
    check(cuda_build.launch_totals()["k5"] - before == -(-len(windows) // BATCH),
          "the conv-chain route did not launch K5 once per batch")
    check_scores(on, off, score_limit, flip_limit,
                 f"base scores {str(dtype)[6:]}, conv-chain route on vs off on "
                 f"{len(windows)} windows")


def check_scores(got, want, score_limit: float, flip_limit: float, what: str) -> None:
    """Powerset scores `got` against `want`: within `score_limit`, and a
    hard decision may flip only where want's top-2 margin is below twice
    the score difference, on at most `flip_limit` of the frames."""
    err = (got - want).abs().max().item()
    top2 = want.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    flipped = got.argmax(-1) != want.argmax(-1)
    share = flipped.float().mean().item()
    worst = margin[flipped].max().item() if bool(flipped.any()) else 0.0
    print(f"{what}: max abs err {err:.3e} (limit {score_limit:.0e}); {int(flipped.sum())} of "
          f"{flipped.numel()} hard decisions differ ({100 * share:.4f}%, limit "
          f"{100 * flip_limit:.2f}%), the largest top-2 margin among them {worst:.3e}")
    check(bool(torch.isfinite(got).all()) and err <= score_limit,
          f"{what}: the scores disagree: {err}")
    check(share <= flip_limit and worst <= 2 * err,
          f"{what}: hard decisions flip away from small margins: {share}, margin {worst}")


def stream_rate(pipe, waves, uris, repeats: int = STREAM_REPEATS) -> list:
    """audio-s/s of `repeats` streamed passes over the files, sorted."""
    def run():
        return [a for a in pipe.stream(iter(waves), 16000, uris=uris)]
    audio = len(waves) * AUDIO_SECONDS
    return sorted(audio / timed_pass(run) for _ in range(repeats))


def run_cli(snap: Path, scp: Path, resnet_ckpt: Path, out: Path) -> float:
    t0 = time.perf_counter()
    pipelines.main(["--in_wav_scp", str(scp), "--model_dir", str(snap), "--embedding_model",
                    str(resnet_ckpt), "--rttm_out_dir", str(out)])
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_snapshots(card: str, resnet_sd) -> dict:
    """Snapshot directory -> RTTM files through `from_pretrained` and the
    wav.scp CLI with VBx clustering, at full width, for WavLM-Base (the
    conv-chain route on: K5 and K1) and Large-s80-md (pre-LN: K1 only).
    Returns the launches of K1 and K5 over the timed `base` CLI run."""
    waves = [make_wave(AUDIO_SECONDS, seed=i) for i in range(SERVING_FILES)]
    uris = [f"rec{i}" for i in range(SERVING_FILES)]
    audio = SERVING_FILES * AUDIO_SECONDS
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        resnet_ckpt = root / "resnet34.bin"
        torch.save({"state_dict": resnet_sd}, resnet_ckpt)
        scp = root / "wav.scp"
        lines = []
        for uri, wave in zip(uris, waves):
            write_wav(root / f"{uri}.wav", wave, 16000)
            lines.append(f"{uri} {root / (uri + '.wav')}")
        scp.write_text("\n".join(lines) + "\n")
        snaps = {name: write_snapshot(root, name) for name in SNAPSHOT_MODELS}

        # ---- WavLM-Base, the conv-chain route on --------------------------
        pipe = pipelines.from_pretrained(snaps["base"], embedding_ckpt=resnet_ckpt)
        model, seg = pipe.seg_inference.model, pipe.seg_inference
        wavlm = pipe.eend_cfg.wavlm
        batches = -(-sum(seg.num_chunks(waves[0].shape[1])) // BATCH)
        windows = file_windows(seg, waves[0])
        with strict_float32():
            compare_routes(model, windows, torch.float32, 1e-4, 1e-3)
        compare_routes(model, windows, torch.bfloat16, 0.1, 0.01)
        try:
            set_conv_chain(True)
            print(f"base CLI warm-up (loading included): "
                  f"{run_cli(snaps['base'], scp, resnet_ckpt, root / 'warm'):.3f} s")
            cuda_build.reset_launches()
            seconds = run_cli(snaps["base"], scp, resnet_ckpt, root / "base_rttm")
            launches = launch_counts("k1", "k5", "k3", "k4")
        finally:
            set_conv_chain(None)
        expected = {"k1": SERVING_FILES * batches * wavlm.num_layers,
                    "k5": SERVING_FILES * batches, "k3": 0, "k4": 0}
        print(f"base snapshot through the CLI {card}: {SERVING_FILES} x {AUDIO_SECONDS} s in "
              f"{seconds:.3f} s with loading; launches K1 {launches['k1']}, K5 "
              f"{launches['k5']}, K3 {launches['k3']}, K4 {launches['k4']}")
        check(launches == expected, f"base: expected launches {expected}, got {launches}")
        cli = {uri: (root / "base_rttm" / f"{uri}.rttm").read_text() for uri in uris}
        segments = [check_rttm(cli[uri], uri) for uri in uris]
        # the same files one at a time through diarize_file, the route off
        single = {uri: pipelines.diarize_file(pipe, root / f"{uri}.wav").to_rttm() for uri in uris}
        worst = max(rttm_disagreement(cli[uri], single[uri]) for uri in uris)
        equal = sum(cli[uri] == single[uri] for uri in uris)
        print(f"base bf16: CLI (route on) vs diarize_file (route off): {segments} segments, "
              f"{equal} of {SERVING_FILES} annotations identical, the largest disagreement "
              f"{100 * worst:.3f}% of the speech time (limit 0.5%)")
        check(worst <= 0.005, f"the routes' bf16 annotations disagree on {worst} of the speech")

        # float32: the hard segmentation and the annotations with the route on against off
        seg.compute_dtype = torch.float32
        with strict_float32():
            routes = {}
            for chain in (False, True):
                set_conv_chain(chain)
                try:
                    routes[chain] = [
                        (seg(w, 16000).data, pipe(w, 16000, uri=u).to_rttm())
                        for w, u in zip(waves, uris)]
                finally:
                    set_conv_chain(None)
        seg.compute_dtype = torch.bfloat16
        flips = [int((a[0] != b[0]).sum()) for a, b in zip(routes[True], routes[False])]
        same = [a[1] == b[1] for a, b in zip(routes[True], routes[False])]
        print(f"base f32, route on vs off: hard-segmentation entries that differ per file "
              f"{flips} of {routes[True][0][0].size}; annotations identical {same}")
        check(all(len(a[1]) > 0 for a in routes[True]), "f32: no speech found")
        check(max(flips) == 0 and all(same),
              f"f32: the conv-chain route changes the result: {flips}, {same}")

        rates = {}
        for chain in (True, False):
            set_conv_chain(chain)
            try:
                stream_rate(pipe, waves, uris, repeats=1)  # warm this route
                rates[chain] = stream_rate(pipe, waves, uris)
            finally:
                set_conv_chain(None)
        for chain, vals in rates.items():
            print(f"throughput {card}: base + VBx streamed, conv-chain {'on' if chain else 'off'}: "
                  f"median {float(np.median(vals)):.2f} audio-s/s of {len(vals)} passes over "
                  f"{SERVING_FILES} x {AUDIO_SECONDS} s ({', '.join(f'{r:.2f}' for r in sorted(vals))})")

        # the extractor alone, one batch, and a profiled pass with the route on
        batch = windows[:BATCH, None, :].to(torch.bfloat16)
        extractor = {}
        for chain in (True, False):
            set_conv_chain(chain)
            try:
                with torch.inference_mode():
                    extractor[chain] = median_ms(
                        lambda: model.wavlm_model._feature_extractor(batch), reps=9)
            finally:
                set_conv_chain(None)
        print(f"base extractor {card}, one batch of {BATCH} x 8 s in bf16: {extractor[True]:.3f} "
              f"ms with the conv-chain route on, {extractor[False]:.3f} ms off")
        timer = StageTimer()
        timer.last = time.perf_counter()
        pipe(waves[0], 16000, uri="stages", hook=timer)
        for step, sec in timer.seconds.items():
            print(f"  base stage {step} {card}: {sec:.4f} s")
        set_conv_chain(True)
        try:
            phase_profile("one streamed base pass, conv-chain on",
                          lambda: list(pipe.stream(iter(waves), 16000, uris=uris)), top=12)
        finally:
            set_conv_chain(None)
        del pipe, model, seg, windows, batch, routes
        torch.cuda.empty_cache()

        # ---- Large-s80-md --------------------------------------------------
        print(f"large_s80_md CLI warm-up (loading included): "
              f"{run_cli(snaps['large_s80_md'], scp, resnet_ckpt, root / 'warm_l'):.3f} s")
        cuda_build.reset_launches()
        seconds = run_cli(snaps["large_s80_md"], scp, resnet_ckpt, root / "large_rttm")
        large = launch_counts("k1", "k5", "k3", "k4")
        pipe = pipelines.from_pretrained(snaps["large_s80_md"], embedding_ckpt=resnet_ckpt)
        wavlm = pipe.eend_cfg.wavlm
        expected = {"k1": SERVING_FILES * batches * sum(wavlm.use_attention), "k5": 0, "k3": 0,
                    "k4": 0}
        print(f"large_s80_md snapshot through the CLI {card}: {SERVING_FILES} x {AUDIO_SECONDS} s "
              f"in {seconds:.3f} s with loading; launches K1 {large['k1']}, K5 {large['k5']}, "
              f"K3 {large['k3']}, K4 {large['k4']}")
        check(large == expected, f"large_s80_md: expected launches {expected}, got {large}")
        texts = {uri: (root / "large_rttm" / f"{uri}.rttm").read_text() for uri in uris}
        print(f"large_s80_md RTTM: {[check_rttm(texts[uri], uri) for uri in uris]} segments")
        two = torch.from_numpy(np.stack([waves[0][0, :128000], waves[0][0, 12800:140800]]))
        with strict_float32(), torch.inference_mode():
            on_card = pipe.seg_inference.model(two.cuda()).cpu()
            cpu_pipe = pipelines.from_pretrained(snaps["large_s80_md"],
                                                 embedding_ckpt=resnet_ckpt, device="cpu")
            on_cpu = cpu_pipe.seg_inference.model(two)
        err = (on_card - on_cpu).abs().max().item()
        print(f"large_s80_md EEND f32 card vs CPU: scores {tuple(on_card.shape)}, max abs err "
              f"{err:.3e}")
        check(on_card.shape == (2, FRAMES, 11) and bool(torch.isfinite(on_card).all())
              and err <= 1e-3, f"large_s80_md scores on the card disagree with the CPU: {err}")
        stream_rate(pipe, waves, uris, repeats=1)
        vals = stream_rate(pipe, waves, uris)
        print(f"throughput {card}: large_s80_md + VBx streamed: median "
              f"{float(np.median(vals)):.2f} audio-s/s of {len(vals)} passes over "
              f"{SERVING_FILES} x {AUDIO_SECONDS} s ({', '.join(f'{r:.2f}' for r in vals)})")
        timer = StageTimer()
        timer.last = time.perf_counter()
        pipe(waves[0], 16000, uri="stages", hook=timer)
        for step, sec in timer.seconds.items():
            print(f"  large_s80_md stage {step} {card}: {sec:.4f} s")
        phase_profile("one streamed large_s80_md pass",
                      lambda: list(pipe.stream(iter(waves), 16000, uris=uris)), top=8)
    return launches


# The repository's recipe TOML layout, with its own (JAX package) class path,
# for the released Base-s80-md model
EVAL_TOML = """\
[model]
path = "diarizen_tpu.models.build.wavlm_conformer"
[model.args]
wavlm_src = "wavlm_base_s80_md"
wavlm_layer_num = 13
wavlm_feat_dim = 768
attention_in = 256
ffn_hidden = 1024
num_head = 4
num_layer = 4
dropout = 0.1
chunk_size = 8
use_posi = false
output_activate_function = false
selected_channel = 0
max_speakers_per_chunk = 4

[inference]
[inference.args]
seg_duration = 8
batch_size = 32
apply_median_filtering = true

[clustering]
[clustering.args]
method = "AgglomerativeClustering"
ahc_threshold = 0.70
min_cluster_size = 30
min_speakers = 1
max_speakers = 8
"""
EVAL_CHECKPOINTS = 3
DER_LIMIT = 0.005  # bf16 recipe against the f32 reference: rttm_disagreement's limit


def pcm16(wave: np.ndarray) -> np.ndarray:
    """The int16 samples of a PCM16-quantised waveform (channels, samples)."""
    return np.rint(wave * 32768.0).astype(np.int64)


def encode_flac_copy(pcm: np.ndarray) -> bytes:
    """FLAC bytes of int16 samples by the repository's reference encoder
    (tests/flac_ref_encoder.py, numpy only); run in worker processes."""
    from flac_ref_encoder import encode_flac

    return encode_flac(pcm, 16000)


def write_pcm16(path: Path, pcm: np.ndarray) -> None:
    with wavefile.open(str(path), "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.T.astype("<i2").tobytes())


def frame_decisions(agg) -> tuple:
    """Speech (largest speaker score) and overlap (second largest) of an
    aggregated soft feature, binarized at 0.5 as VAD and OSD do."""
    top2 = np.sort(agg.data, axis=-1)[:, -2:]
    return tuple(binarize_hysteresis(top2[:, i][None], 0.5, 0.5)[0] for i in (1, 0))


def seeded_checkpoints(model, exp: Path, seed: int, count: int) -> dict:
    """`count` nearby checkpoints of `model`'s shapes with their metrics in
    `exp`, as successive epochs of one run are; returns the seeded state
    dict they vary. Seeded weights spread the powerset probability over many
    classes: the checkpoints' head is 10x sharper, for the confident scores
    of a trained model."""
    seeded = random_state_dict(model, seed=seed)
    base = {**seeded, "classifier.weight": seeded["classifier.weight"] * 10.0}
    rng = np.random.default_rng(seed + 1)
    for epoch in range(count):
        sd = {k: v + 0.01 * v.abs().mean() * torch.from_numpy(
                  rng.standard_normal(tuple(v.shape)).astype(np.float32))
              if v.is_floating_point() and v.dim() > 1 else v for k, v in base.items()}
        save_checkpoint(exp / "checkpoints", epoch, sd)
        append_metrics(exp, {"epoch": epoch, "loss": 1.0 - 0.1 * epoch})
    return seeded


def phase_evaluation(card: str, resnet_sd, flac_jobs) -> dict:
    """Scoring and the frame-level modes at the full width of Base-s80-md:
    an experiment directory of seeded checkpoints, FLAC and WAV copies of
    four 120 s files, the float32 pipeline's RTTMs as the reference, then the
    recipe CLI (`recipes.diar_ssl.infer.main`, bf16, AHC, three checkpoints
    averaged, FLAC in) with its DER; VAD/OSD bf16 against f32, multi-label
    segmentation, resegmentation, the per-window embedding route against the
    shared one, and `whole` over a 30 s file (K1 at T 1499). Returns K1's
    launches in the recipe run and in one `whole` forward."""
    waves = [make_wave(AUDIO_SECONDS, seed=i) for i in range(STREAM_FILES)]
    uris = [f"rec{i}" for i in range(STREAM_FILES)]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        # ---- inputs: WAV and FLAC copies of the same int16 samples ---------
        t0 = time.perf_counter()
        flac_lines = []
        for uri, wave, job in zip(uris, waves, flac_jobs):
            write_pcm16(root / f"{uri}.wav", pcm16(wave))
            (root / f"{uri}.flac").write_bytes(job.result())
            flac_lines.append(f"{uri} {root / (uri + '.flac')}")
            from_flac, from_wav = read_audio(root / f"{uri}.flac"), read_audio(root / f"{uri}.wav")
            check(from_flac[1] == from_wav[1] == 16000
                  and np.array_equal(from_flac[0], from_wav[0])
                  and np.array_equal(from_wav[0], wave),
                  f"{uri}: the FLAC copy does not read back as the WAV copy")
        (root / "wav.scp").write_text("\n".join(flac_lines) + "\n")
        print(f"evaluation inputs: {STREAM_FILES} x {AUDIO_SECONDS} s as WAV and FLAC, read back "
              f"bit for bit equal ({time.perf_counter() - t0:.1f} s with the FLAC decoding)")

        # ---- the experiment directory --------------------------------------
        (root / "conf.toml").write_text(EVAL_TOML)
        model_section = port_config.load_toml(root / "conf.toml")["model"]
        eend_cfg, model = build.wavlm_conformer(**model_section["args"])
        # with the seeded head, no speaker's soft score would reach the
        # resegmentation onset (0.81)
        seeded = seeded_checkpoints(model, root / "exp", seed=30, count=EVAL_CHECKPOINTS)
        resnet_ckpt = root / "resnet34.bin"
        torch.save({"state_dict": resnet_sd}, resnet_ckpt)

        # ---- the float32 reference on the WAV copies -----------------------
        model.load_state_dict(average_checkpoints(
            [root / "exp" / "checkpoints" / f"epoch_{e:04d}" for e in range(EVAL_CHECKPOINTS)]))
        seg32 = SlidingInference(model, batch_size=BATCH, compute_dtype=torch.float32)
        emb = EmbeddingInference(pipelines.load_resnet(resnet_ckpt), seg32.window_size,
                                 num_speakers=eend_cfg.max_speakers_per_chunk, batch_size=BATCH)
        ahc = AgglomerativeClustering(threshold=0.70, min_cluster_size=30)
        with strict_float32():
            reference = [DiarizationPipeline(seg32, emb, ahc, eend_cfg, max_speakers=8)(
                read_audio(root / f"{uri}.wav")[0], 16000, uri=uri) for uri in uris]
        write_rttm(root / "ref.rttm", reference)

        # ---- the recipe CLI, bf16, on the FLAC wav.scp ---------------------
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        hyps = recipe_infer.main([
            "-C", str(root / "conf.toml"), "--exp_dir", str(root / "exp"),
            "--wav_scp", str(root / "wav.scp"), "--out_dir", str(root / "out"),
            "--avg_ckpt_num", str(EVAL_CHECKPOINTS), "--embedding_ckpt", str(resnet_ckpt),
            "--clustering", "AHC", "--ref_rttm", str(root / "ref.rttm")])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        recipe_k1 = cuda_build.launch_totals()["k1"]
        batches = -(-sum(seg32.num_chunks(waves[0].shape[1])) // BATCH)
        expected = STREAM_FILES * batches * sum(eend_cfg.wavlm.use_attention)
        check(recipe_k1 == expected, f"recipe: expected {expected} K1 launches, got {recipe_k1}")
        segments = [check_rttm((root / "out" / f"{uri}.rttm").read_text(), uri) for uri in uris]
        summary = json.loads((root / "out" / "der.json").read_text())
        refs = load_rttm(root / "ref.rttm")
        check(summary == json.loads(json.dumps(recipe_infer.score(refs, hyps))),
              "der.json differs from der_report on the same annotations")
        for uri in uris:
            r = der_report(refs[uri], hyps[uri])
            check(summary["files"][uri]["der"] == r.der, f"{uri}: der.json {summary['files'][uri]}")
        print(f"recipe CLI {card}: {STREAM_FILES} x {AUDIO_SECONDS} s FLAC, {EVAL_CHECKPOINTS} "
              f"checkpoints averaged, bf16, AHC: {seconds:.3f} s with loading = "
              f"{seconds / STREAM_FILES:.3f} s a file; K1 launches {recipe_k1}; segments "
              f"{segments}; DER against the f32 reference {100 * summary['der']:.4f}% (false "
              f"alarm {100 * summary['false_alarm']:.4f}%, miss "
              f"{100 * summary['missed_detection']:.4f}%, confusion "
              f"{100 * summary['confusion']:.4f}%; limit {100 * DER_LIMIT:.1f}%)")
        check(summary["der"] <= DER_LIMIT, f"recipe DER {summary['der']} above {DER_LIMIT}")

        # ---- frame-level modes on one 120 s file ---------------------------
        wave = waves[0]
        seg16 = SlidingInference(model, batch_size=BATCH)
        with strict_float32():
            agg32 = seg32.aggregated(wave, 16000)
        agg16 = seg16.aggregated(wave, 16000)
        print(f"aggregated soft scores bf16 vs f32 on {agg32.data.shape}: max abs err "
              f"{float(np.abs(agg16.data - agg32.data).max()):.3e}")
        for what, a, b in zip(("speech", "overlap"), frame_decisions(agg16),
                              frame_decisions(agg32)):
            share = float(np.mean(a != b))
            print(f"aggregated {what} bf16 vs f32: {int((a != b).sum())} of {a.size} frames "
                  f"differ ({100 * share:.4f}%, limit 0.5%); {int(b.sum())} frames active in f32")
            check(share <= 0.005, f"aggregated {what}: bf16 and f32 differ on {share}")
        vad = VoiceActivityDetection(seg16)(wave, 16000, uri="vad").to_rttm()
        osd = OverlappedSpeechDetection(seg16)(wave, 16000, uri="osd").to_rttm()
        multi = MultiLabelSegmentation(seg16, [f"spk{k}" for k in range(4)])(
            wave, 16000, uri="multi")
        reseg = Resegmentation(seg16)(wave, 16000, hyps[uris[0]], uri=uris[0])
        print(f"VAD {check_rttm(vad, 'vad')} segments, OSD {len(osd.splitlines())}, multi-label "
              f"{check_rttm(multi.to_rttm(), 'multi')} ({multi.labels()}), resegmentation of "
              f"the recipe's {uris[0]} {check_rttm(reseg.to_rttm(), uris[0])} "
              f"({reseg.labels()} from {hyps[uris[0]].labels()})")
        check(set(multi.labels()) <= {f"spk{k}" for k in range(4)}, "multi-label labels")

        # the per-window fbank route against the shared whole-file fbank
        dev_wave, starts = seg32.prepare_wave(wave)
        starts = starts[:BATCH]
        frames = seg32._frames_per_chunk
        weights = (np.random.default_rng(4).uniform(size=(len(starts), 4, frames)) > 0.5
                   ).astype(np.float32)
        with strict_float32():
            routes = [EmbeddingInference(emb.model, seg32.window_size, 4, batch_size=BATCH,
                                         shared_fbank=shared)(dev_wave, starts, weights)
                      for shared in (True, False)]
        err = float(np.abs(routes[0] - routes[1]).max())
        print(f"embeddings f32, per-window fbank vs the shared one on {len(starts)} windows: "
              f"max abs err {err:.3e} (limit 1e-4)")
        check(np.isfinite(routes[1]).all() and err <= 1e-4, f"per-window route: {err}")

        # ---- `whole` over 30 s: one forward at T 1499 -----------------------
        # the seeded head, whose log-probabilities are on the scale the
        # score limit of check_scores is set for
        model.load_state_dict(seeded)
        short = make_wave(WHOLE_SECONDS, seed=7)
        x = torch.from_numpy(short).cuda()
        with torch.inference_mode():
            with strict_float32():
                want = model(x, compute_dtype=torch.float32)
            got = model(x, compute_dtype=torch.bfloat16)
        check(tuple(want.shape) == (1, WHOLE_FRAMES, eend_cfg.num_powerset_classes),
              f"whole: scores {tuple(want.shape)}")
        check_scores(got.float(), want, 0.1, 0.01,
                     f"whole over {WHOLE_SECONDS} s (T {WHOLE_FRAMES}), bf16 vs f32 scores")
        cuda_build.reset_launches()
        hard = seg16.whole(short, 16000)
        torch.cuda.synchronize()
        whole_k1 = cuda_build.launch_totals()["k1"]
        t0 = time.perf_counter()
        seg16.whole(short, 16000)
        torch.cuda.synchronize()
        print(f"whole {card}: {WHOLE_SECONDS} s in one forward, {hard.shape} {hard.dtype}, "
              f"K1 launches {whole_k1}, {time.perf_counter() - t0:.4f} s")
        check(hard.shape == (WHOLE_FRAMES, 4) and whole_k1 == sum(eend_cfg.wavlm.use_attention),
              f"whole: {hard.shape}, {whole_k1} K1 launches")
    return {"recipe": recipe_k1, "whole": whole_k1}


PRUNE_DURATIONS = [136] * 4  # 8 s / 8 s: 17 chunks each, 4 batches of 16 an epoch
PRUNE_EPOCHS = 2  # 8 distill steps
# kept heads of each layer in the collapse surgery: 1 to 12, layer 0's attention pruned
PRUNED_HEADS = (12, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12)
PRUNED_FF_LAYER = 9  # its feed-forward goes


def recipe_toml(path: Path, root: Path, changes: dict) -> Path:
    """A repository recipe TOML with `changes` ({"section.key": value}) and
    its experiments under `root/exp`, written to `root`."""
    config = port_config.apply_overrides(port_config.load_toml(path),
                                         {"meta.save_dir": str(root / "exp"), **changes})
    out = root / path.name
    port_config.dump_toml(config, out)
    return out


def data_changes(section: str, data: Path) -> dict:
    return {f"{section}.args.{key}": str(data / name) for key, name in
            (("scp_file", "wav.scp"), ("rttm_file", "rttm"), ("uem_file", "all.uem"))}


class LaunchRecorder:
    """Recipe step hook: each step's metrics, wall ms since the previous
    step ended (a step reads its metrics, so the device has finished it) and
    K1's and K2's launches during the step."""

    def __init__(self):
        self.steps = []
        self.reset()

    def reset(self) -> None:
        cuda_build.reset_launches()
        self.counts = (0, 0, 0)
        self.instances = dict(cuda_build.launches)
        self.last = time.perf_counter()

    def __call__(self, metrics) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = tuple(launch_counts("k1", "k1_train", "k2").values())
        instances = {n: c - self.instances[n] for n, c in cuda_build.launches.items()
                     if c != self.instances[n]}
        self.steps.append({**metrics, "ms": 1e3 * (now - self.last), "instances": instances,
                           **dict(zip(("k1", "k1_train", "k2"),
                                      (a - b for a, b in zip(counts, self.counts))))})
        self.last, self.counts = now, counts
        self.instances = dict(cuda_build.launches)


def rate0_trainable_kernels(gen) -> list:
    """K1's training instance and K2 at dropout rate 0 (the distill step's
    student: the instances without the dropout mask) at (B 16, H 12, T 399)
    bf16 against the plain version's forward and autograd, within 2e-2 of
    each tensor's largest magnitude; timed beside their bounds and SDPA, and
    K2's passes alone."""
    (q, k, v, pos, gate), do = trainable_inputs(TRAIN_BATCH, TRAIN_HEADS, FRAMES,
                                                torch.bfloat16, gen)
    results = []
    for fn in (k1.flash_attention_gated_bias_trainable, k1.flash_attention_gated_bias_reference):
        cuda_build.reset_launches()
        leaves = [x.clone().requires_grad_() for x in (q, k, v, pos, gate)]
        out = fn(*leaves, dropout_rate=0.0)
        out.backward(do)
        results.append([out.detach()] + [x.grad for x in leaves])
        if fn is k1.flash_attention_gated_bias_trainable:
            torch.cuda.synchronize()
            instances = launched()
    torch.cuda.synchronize()
    check(instances == {"train_rate0": 1, "bwd_rate0": 1}, f"rate 0 launched {instances}")
    errs = []
    for name, got, want in zip(("o", "dq", "dk", "dv", "dpos_bias", "dgate"), *results):
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        errs.append(err)
        check(np.isfinite(err) and err <= 2e-2 * scale,
              f"{name} of K1/K2 at rate 0 disagrees with the plain version: {err} of {scale}")
        print(f"K1+K2 rate 0 vs plain bf16 B={TRAIN_BATCH} H={TRAIN_HEADS} T={FRAMES} {name}: "
              f"{err / scale:.2e} of max magnitude (tolerance 2e-2)")
    bias = k1.padded_bias(pos, torch.bfloat16)
    mask = (gate[..., None] * pos).to(torch.bfloat16)
    out, lse = k1._forward_train(q, k, v, bias, gate, 0.0, 0)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, pos, gate)]
    plain = k1.flash_attention_gated_bias_reference(*leaves, 0.0)
    lib_leaves = [x.clone().requires_grad_() for x in (q, k, v, mask)]
    lib = F.scaled_dot_product_attention(*lib_leaves[:3], attn_mask=lib_leaves[3])
    rows = {
        "fwd": {"ms": median_ms(lambda: k1._forward_train(q, k, v, bias, gate, 0.0, 0)),
                "plain_ms": median_ms(
                    lambda: k1.flash_attention_gated_bias_reference(q, k, v, pos, gate, 0.0)),
                "library_ms": median_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
                "max_abs_err": errs[0]},
        "bwd": {"ms": median_ms(lambda: k1._backward(q, k, v, bias, gate, out, lse, do, 0.0, 0)),
                "plain_ms": median_ms(lambda: torch.autograd.grad(plain, leaves, do,
                                                                  retain_graph=True)),
                "library_ms": median_ms(lambda: torch.autograd.grad(lib, lib_leaves, do,
                                                                    retain_graph=True)),
                "max_abs_err": max(errs[1:]),
                **launches_per_call(lambda: k1._backward(q, k, v, bias, gate, out, lse, do,
                                                         0.0, 0), K2_BF16_KERNELS),
                "passes": pass_times(q, k, v, bias, gate, out, lse, do, 0.0)},
    }
    bounds = trainable_bound_s(TRAIN_BATCH, TRAIN_HEADS, FRAMES, HEAD_DIM, 2)
    for key, row in rows.items():
        mem_s, op_s = bounds[key]
        row["bound_ms"] = 1e3 * max(mem_s, op_s)
        row["bound_by"] = "bytes" if mem_s >= op_s else "operations"
        print(f"{'K1 training' if key == 'fwd' else 'K2'} bf16 B={TRAIN_BATCH} H={TRAIN_HEADS} "
              f"T={FRAMES} rate=0 (instances {instances}): kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms (by {row['bound_by']})")
    bwd = rows["bwd"]
    print(f"K2 at rate 0: {bwd['ms']:.4f} ms against SDPA's backward {bwd['library_ms']:.4f} ms: "
          f"{'slower' if bwd['ms'] > bwd['library_ms'] else 'faster'} "
          f"({bwd['ms'] / bwd['library_ms']:.2f}x)")
    return [rows["fwd"], rows["bwd"]]


def collapse_log_alphas(cfg: WavLMConfig, seed: int) -> dict:
    """Seeded log-alphas whose compiled masks prune about 80% of the units:
    PRUNED_HEADS heads kept per layer (scattered, layer 0's attention gone),
    200-699 of 3072 intermediates (soft values 0.97-1 on the kept ones), one
    feed-forward gone, half to two thirds of the channels of conv layers
    0-5 (the last one keeps all its channels: its mask becomes dummy_weight)."""
    rng = np.random.default_rng(seed)

    def units(n: int, keep: int, soft: bool = False) -> torch.Tensor:
        la = np.full(n, -20.0, np.float32)
        kept = rng.choice(n, keep, replace=False)
        la[kept] = rng.uniform(3.0, 20.0, keep) if soft else 20.0
        return torch.from_numpy(la)

    conv = [units(c, c if i == len(cfg.conv_layers) - 1 else int(rng.integers(c // 2, 2 * c // 3)),
                  soft=True) for i, (c, _, _) in enumerate(cfg.conv_layers)]
    layers = [{"heads": units(12, h),
               "attn_layer": torch.tensor([-20.0 if i == 0 else 5.0]),
               "ff_interm": units(3072, int(rng.integers(200, 700)), soft=True),
               "ff_layer": torch.tensor([-20.0 if i == PRUNED_FF_LAYER else 5.0])}
              for i, h in enumerate(PRUNED_HEADS)]
    return {"conv": conv, "layers": layers}


def hidden_errors(got, want) -> float:
    """Largest |got - want| of the hidden states, each over max(1, its
    largest magnitude)."""
    return max((g.float() - w.float()).abs().max().item() / max(1.0, w.float().abs().max().item())
               for g, w in zip(got, want))


def phase_pruning(card: str) -> dict:
    """Fine-tune, distill-prune and collapse WavLM-Base through the recipe
    CLIs, on synthetic Kaldi directories in a temporary directory:
    `recipes.diar_ssl.run` trains the flagship TOML's model (WavLM-Base +
    Conformer, 16 x 8 s, bf16) for one epoch and validates it, and
    `get_wavlm_from_finetuned` takes its trunk out; `run_distill_prune`
    distill-prunes a seeded reference-format WavLM-Base teacher file with
    s80_base.toml's settings for 8 steps at 16 x 8 s in bf16 (12 launches
    each of K1 inference, K1 training and K2 a step); one more distill step
    under the profiler; K1 training and K2 at rate 0 against their plain
    versions, timed; `apply_pruning` on the run's
    checkpoints; then the surgery of seeded log-alphas (about 80% of the
    units, 1-12 heads a layer, layer 0's attention pruned): the pruned
    model's forward against the gated one with compiled masks (float32
    within 1e-4; bf16 within 1e-1, its rounding compounding over 12
    layers), its K1 launches, and K1 at its head counts. Returns the rate-0
    rows and the launches."""
    repo = Path(__file__).resolve().parent
    base = WavLMConfig.base()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        # ---- fine-tune the flagship recipe's model for one epoch ----------------
        t0 = time.perf_counter()
        train = write_kaldi_dir(root, "train", [200] * 4, seed=0)
        dev = write_kaldi_dir(root, "dev", [70], seed=1)
        finetune = recipe_toml(repo / "recipes/diar_ssl/conf/wavlm_updated_conformer.toml", root, {
            "trainer.args.max_epochs": 1, "trainer.args.max_num_checkpoints": 1,
            **data_changes("train_dataset", train), **data_changes("validate_dataset", dev)})
        recorder = LaunchRecorder()
        trained = recipe_run.main(["-C", str(finetune), "-M", "train"], step_hook=recorder)
        validated = recipe_run.main(["-C", str(finetune), "-M", "validate"])
        steps = recorder.steps
        check(len(steps) == TRAIN_STEPS and all(np.isfinite(s["loss"]) and not s["skipped"]
                                                for s in steps), "a fine-tune step failed")
        check(all(np.isfinite(validated[k]) and abs(validated[k] - trained[k])
                  <= 1e-3 * max(1.0, abs(trained[k])) for k in ("loss", "der")),
              f"-M validate {validated} disagrees with the epoch's validation {trained}")
        exp = root / "exp" / finetune.stem
        get_wavlm_from_finetuned.main(["--exp_dir", str(exp), "--wavlm_src", "wavlm_base",
                                       "--out_dir", str(root / "trunk"), "--avg_ckpt_num", "1"])
        # the trunk's params.npz carries back into WavLM-Base whole
        WavLM(base).load_state_dict(wavlm_state_dict_from_jax(
            load_pytree(root / "trunk/params.npz"), base), strict=True)
        print(f"fine-tune recipe {card}: {len(steps)} steps, median "
              f"{np.median([s['ms'] for s in steps[2:]]):.2f} ms/step after 2 warm-up steps; "
              f"validation loss {trained['loss']:.5f} DER {trained['der']:.5f}, -M validate "
              f"{validated['loss']:.5f} / {validated['der']:.5f}; trunk taken out "
              f"({time.perf_counter() - t0:.1f} s in all)")

        # ---- distill-prune a seeded WavLM-Base teacher --------------------------
        t0 = time.perf_counter()
        teacher_path = root / "wavlm_base_teacher.pt"
        teacher = WavLM(base)
        teacher_sd = random_state_dict(teacher, seed=11)
        torch.save({"config": base.to_reference_dict(), "state_dict": teacher_sd}, teacher_path)
        data = write_kaldi_dir(root, "prune", PRUNE_DURATIONS, seed=2)
        prune_toml = recipe_toml(repo / "recipes/diar_ssl_pruning/conf/s80_base.toml", root, {
            "trainer.args.max_epochs": PRUNE_EPOCHS, "model.args.wavlm_src": str(teacher_path),
            **data_changes("train_dataset", data)})
        torch.cuda.reset_peak_memory_stats()
        recorder = LaunchRecorder()
        run_distill_prune.main(["-C", str(prune_toml)], step_hook=recorder)
        peak = torch.cuda.max_memory_allocated()
        steps = recorder.steps
        for i, s in enumerate(steps):
            print(f"  distill step {i}: loss {s['loss']:.5f} (distill {s['loss_distill']:.5f}), "
                  f"sparsity expected {s['sparsity_expected']:.5f} target "
                  f"{s['sparsity_target']:.5f}, lambda1 {s['lambda1']:.3e}; {s['ms']:.2f} ms; "
                  f"K1 inference {s['k1']}, K1 training {s['k1_train']}, K2 {s['k2']}")
        step_ms = float(np.median([s["ms"] for s in steps[2:]]))
        print(f"distill-prune {card}: {len(steps)} steps of {TRAIN_BATCH} x 8 s (WavLM-Base teacher "
              f"and student, bf16), median {step_ms:.2f} ms/step after 2 warm-up steps, peak "
              f"device memory {peak / 2**30:.3f} GiB ({time.perf_counter() - t0:.1f} s in all)")
        check(len(steps) == PRUNE_EPOCHS * 4 and all(np.isfinite(s["loss"]) and not s["skipped"]
                                                     for s in steps), "a distill step failed")
        check(all(s["k1"] == s["k1_train"] == s["k2"] == base.num_layers for s in steps),
              "K1 inference, K1 training and K2 must each launch 12 times a distill step")
        # the teacher in the exact f32 schedule, the student at rate 0
        distill_instances = {"fwd_f32": base.num_layers, "train_rate0": base.num_layers,
                             "bwd_rate0": base.num_layers}
        print(f"distill step instances: {steps[0]['instances']}")
        check(all(s["instances"] == distill_instances for s in steps),
              f"a distill step launched other instances than {distill_instances}")
        path_run("distill-prune", sum((Counter(s["instances"]) for s in steps), Counter()))
        # the student, whose sampled masks make it differ from the teacher,
        # moves towards it; the lambdas and the target move
        check(steps[-1]["loss_distill"] < steps[0]["loss_distill"] and steps[-1]["lambda1"] != 0.0
              and steps[-1]["sparsity_target"] > steps[0]["sparsity_target"],
              "the distill-prune dynamics")

        # one more distill step of the library's, under the profiler
        teacher.load_state_dict(teacher_sd)
        teacher.cuda()
        student = WavLM(base)
        student.load_state_dict(teacher_sd)
        dcfg = DistillConfig()
        state = create_distill_prune_state(
            student, init_gates(base, PruneConfig(), torch.Generator().manual_seed(1)), dcfg)
        step = make_distill_prune_step(base, dcfg, teacher)
        wave = torch.from_numpy(make_wave(8)[:, :128000].repeat(TRAIN_BATCH, 0)).cuda()
        wave = wave + 0.01 * torch.randn(wave.shape, device="cuda",
                                         generator=torch.Generator(device="cuda").manual_seed(5))
        with k1.softmax_mode_scope("f32"):  # as the recipe runs it
            for _ in range(2):
                step(state, wave)
            cuda_build.reset_launches()
            phase_profile(f"one distill step {card}", lambda: step(state, wave))
            profiled = launched()
        want = {n: 2 * c for n, c in distill_instances.items()}  # the profiler runs it twice
        print(f"profiled distill steps' instances: {profiled}")
        check(profiled == want, f"the profiled distill steps launched {profiled}, not {want}")
        del state, step, student

        rate0 = rate0_trainable_kernels(torch.Generator(device="cuda").manual_seed(3))

        # ---- collapse: the run's checkpoints, then seeded log-alphas ------------
        report = apply_pruning_cli.main(["-C", str(prune_toml), "--out_dir",
                                         str(root / "pruned"), "--avg_ckpt_num", "2"])
        check(0 <= report["sparsity"] < 1 and report["pruned_params_M"] > 0, "apply_pruning")
        la = collapse_log_alphas(base, seed=4)
        sd, cfg = apply_pruning(teacher_sd, base, la)
        leaves = [*la["conv"], *(v for layer in la["layers"] for v in layer.values())]
        kept = sum(int(np.count_nonzero(compiled_mask(x.numpy()))) for x in leaves)
        total = sum(x.numel() for x in leaves)
        print(f"collapse: {kept} of {total} units kept; "
              f"{count_params(sd) / 1e6:.3f} M of {count_params(teacher_sd) / 1e6:.3f} M "
              f"parameters; heads {[len(h) for h in cfg.remaining_heads]}, feed-forward "
              f"{list(cfg.ff_interm_features)}, conv {[c for c, _, _ in cfg.conv_layers]}")
        check(0.7 <= 1 - kept / total <= 0.9 and not cfg.use_attention[0]
              and not cfg.use_feed_forward[PRUNED_FF_LAYER]
              and [len(h) for h in cfg.remaining_heads][1:] == list(PRUNED_HEADS[1:]),
              "the collapse surgery's config")
        pruned = WavLM(cfg)
        pruned.load_state_dict(sd, strict=True)
        pruned.cuda()
        masks = compile_gates({"conv": [x.cuda() for x in la["conv"]],
                               "layers": [{k: v.cuda() for k, v in layer.items()}
                                          for layer in la["layers"]]})
        errors = {}
        with torch.no_grad():
            with strict_float32():
                errors["f32"] = hidden_errors(pruned.hidden_states(wave),
                                              teacher.hidden_states(wave, gates=masks))
            gated = teacher.hidden_states(wave, torch.bfloat16, gates=masks)
            cuda_build.reset_launches()
            got = pruned.hidden_states(wave, torch.bfloat16)
            torch.cuda.synchronize()
            pruned_launches = cuda_build.launch_totals()["k1"]
            errors["bf16"] = hidden_errors(got, gated)
        attention_layers = sum(cfg.use_attention)
        print(f"pruned model against the gated one with compiled masks, {TRAIN_BATCH} x 8 s: "
              f"f32 {errors['f32']:.3e} (tolerance 1e-4), bf16 {errors['bf16']:.3e} (tolerance "
              f"1e-1) of max(1, |hidden state|); K1 launches in the bf16 forward "
              f"{pruned_launches} for {attention_layers} layers with attention")
        check(errors["f32"] <= 1e-4 and errors["bf16"] <= 1e-1,
              "the pruned model disagrees with the gated one")
        check(pruned_launches == attention_layers,
              f"expected {attention_layers} K1 launches in the pruned forward")
        heads = [len(h) for h, a in zip(cfg.remaining_heads, cfg.use_attention) if a]
        pruned_row = pruned_k1_layers(heads)
        pruned_row["launches"] = pruned_launches
    return {"rate0": rate0, "pruned": pruned_row, "distill_step": steps[-1]["instances"]}


def pruned_k1_layers(heads: list) -> dict:
    """K1 (inference, bf16) at each attention layer's head count of the
    pruned model, B 16, T 399: checked against the plain version (2e-2 of
    unit-scale inputs) and timed, one launch a layer, summed."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    by_bytes = by_flops = err_max = 0.0
    for h in heads:
        args = attention_inputs(TRAIN_BATCH, h, FRAMES, HEAD_DIM, torch.bfloat16, gen)
        padded = (*args[:3], k1.padded_bias(args[3], torch.bfloat16), args[4])
        err = (k1.flash_attention_gated_bias(*padded).float()
               - k1.flash_attention_gated_bias_reference(*args).float()).abs().max().item()
        check(np.isfinite(err) and err <= 2e-2, f"K1 at H={h} disagrees: {err}")
        err_max = max(err_max, err)
        totals["ms"] += median_ms(lambda: k1.flash_attention_gated_bias(*padded))
        totals["plain_ms"] += median_ms(lambda: k1.flash_attention_gated_bias_reference(*args))
        totals["library_ms"] += median_ms(lambda: library_attention(*args))
        mem_s, op_s = attention_bound_s(TRAIN_BATCH, h, FRAMES, HEAD_DIM, 2)
        by_bytes += mem_s
        by_flops += op_s
    row = {**totals, "bound_ms": 1e3 * max(by_bytes, by_flops),
           "bound_by": "bytes" if by_bytes >= by_flops else "operations", "max_abs_err": err_max}
    print(f"K1 bf16 at the pruned model's head counts {heads}, B={TRAIN_BATCH} T={FRAMES} "
          f"({len(heads)} launches): kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"(by {row['bound_by']}); max abs err {err_max:.3e}")
    return row


MC_CHANNELS, MC_BATCH, MC_TRAIN_BATCH = 8, 16, 8  # the MC recipe's microphones and batches
MC_CHECKPOINTS = 3
MC_STREAM_LAYERS = 4  # WavLM layers 0-3 run on every channel's stream (4 fusions)


def make_mc_wave(dur_s: int, seed: int) -> np.ndarray:
    """`make_wave`'s meeting heard by MC_CHANNELS microphones (delays, gains,
    noise of their own), quantised like PCM16."""
    mics = microphones(make_wave(dur_s, seed=seed)[0], MC_CHANNELS, seed + 50)
    return (np.clip(np.rint(mics * 32767.0), -32768, 32767) / 32768.0).astype(np.float32)


def mc_k1_layers(heads: list, b: int, gen) -> dict:
    """K1 (inference) at the multi-channel streams' shape: each of `heads`
    at (b, h, 399, 64) checked against the plain version (bf16 within 2e-2,
    f32 within 1e-4 of the largest magnitude), then the bf16 launches timed,
    one a layer, summed, beside the bound and SDPA with the mask."""
    tolerance = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    err_max = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for h in sorted(set(heads)):
            args = attention_inputs(b, h, FRAMES, HEAD_DIM, dtype, gen)
            want = k1.flash_attention_gated_bias_reference(*args).float()
            err = (k1.flash_attention_gated_bias(*args).float() - want).abs().max().item()
            scale = want.abs().max().item()
            print(f"K1 vs plain {str(dtype)[6:]} B={b} H={h} T={FRAMES}: max abs err {err:.3e} "
                  f"of {scale:.3e} (tolerance {tolerance[dtype]:.0e} of it)")
            check(np.isfinite(err) and err <= tolerance[dtype] * scale,
                  f"K1 at B={b} H={h} {dtype} disagrees with its plain version: {err}")
            if dtype == torch.bfloat16:
                err_max = max(err_max, err)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    by_bytes = by_flops = 0.0
    for h in heads:
        args = attention_inputs(b, h, FRAMES, HEAD_DIM, torch.bfloat16, gen)
        padded = (*args[:3], k1.padded_bias(args[3], torch.bfloat16), args[4])
        totals["ms"] += median_ms(lambda: k1.flash_attention_gated_bias(*padded))
        totals["plain_ms"] += median_ms(lambda: k1.flash_attention_gated_bias_reference(*args))
        totals["library_ms"] += median_ms(lambda: library_attention(*args))
        mem_s, op_s = attention_bound_s(b, h, FRAMES, HEAD_DIM, 2)
        by_bytes += mem_s
        by_flops += op_s
    row = {**totals, "bound_ms": 1e3 * max(by_bytes, by_flops),
           "bound_by": "bytes" if by_bytes >= by_flops else "operations", "max_abs_err": err_max}
    print(f"K1 bf16 at heads {heads}, B={b} T={FRAMES} ({len(heads)} launches): kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} "
          f"ms, bound {row['bound_ms']:.4f} ms (by {row['bound_by']}); max abs err {err_max:.3e}")
    return row


def mc_trainable(b: int, heads: list, gen) -> tuple:
    """K1's training instance and K2 at (b, h, 399, 64) bf16, rate 0.1, for
    each of `heads`: the output and five gradients against the plain
    version's forward and autograd (2e-2 of each tensor's largest
    magnitude), each timed beside the plain version, SDPA (forward with the
    mask and dropout_p, its backward) and the bound, one call a layer,
    summed; S, the chunks of K2's pass A the plan picks, for each head
    count. Returns (K1 training row, K2 row)."""
    rows = {key: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0} for key in ("fwd", "bwd")}
    by_bytes = {"fwd": 0.0, "bwd": 0.0}
    by_flops, err_max = dict(by_bytes), dict(by_bytes)
    chunks, sweeps, passes = {}, {}, {}
    for h in heads:
        (q, k, v, pos, gate), do = trainable_inputs(b, h, FRAMES, torch.bfloat16, gen)
        results = []
        for fn in (k1.flash_attention_gated_bias_trainable,
                   k1.flash_attention_gated_bias_reference):
            leaves = [x.clone().requires_grad_() for x in (q, k, v, pos, gate)]
            out = fn(*leaves, dropout_rate=DROPOUT_RATE, seed=DROPOUT_SEED)
            out.backward(do)
            results.append([out.detach()] + [x.grad for x in leaves])
        for name, got, want in zip(("o", "dq", "dk", "dv", "dpos_bias", "dgate"), *results):
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            check(np.isfinite(err) and err <= 2e-2 * scale,
                  f"{name} of K1/K2 at B={b} H={h} disagrees with the plain version: {err} of "
                  f"{scale}")
            key = "fwd" if name == "o" else "bwd"
            err_max[key] = max(err_max[key], err / scale)
        bias = k1.padded_bias(pos, torch.bfloat16)
        mask = (gate[..., None] * pos).to(torch.bfloat16)
        out, lse = k1._forward_train(q, k, v, bias, gate, DROPOUT_RATE, DROPOUT_SEED)
        leaves = [x.clone().requires_grad_() for x in (q, k, v, pos, gate)]
        plain = k1.flash_attention_gated_bias_reference(*leaves, DROPOUT_RATE, DROPOUT_SEED)
        lib_leaves = [x.clone().requires_grad_() for x in (q, k, v, mask)]
        lib = F.scaled_dot_product_attention(*lib_leaves[:3], attn_mask=lib_leaves[3],
                                             dropout_p=DROPOUT_RATE)
        timings = {
            "fwd": (lambda: k1._forward_train(q, k, v, bias, gate, DROPOUT_RATE, DROPOUT_SEED),
                    lambda: k1.flash_attention_gated_bias_reference(q, k, v, pos, gate,
                                                                    DROPOUT_RATE, DROPOUT_SEED),
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                           dropout_p=DROPOUT_RATE)),
            "bwd": (lambda: k1._backward(q, k, v, bias, gate, out, lse, do, DROPOUT_RATE,
                                         DROPOUT_SEED),
                    lambda: torch.autograd.grad(plain, leaves, do, retain_graph=True),
                    lambda: torch.autograd.grad(lib, lib_leaves, do, retain_graph=True)),
        }
        bounds = trainable_bound_s(b, h, FRAMES, HEAD_DIM, 2)
        for key, fns in timings.items():
            for field, fn in zip(("ms", "plain_ms", "library_ms"), fns):
                rows[key][field] += median_ms(fn)
            by_bytes[key] += bounds[key][0]
            by_flops[key] += bounds[key][1]
        chunks[h] = k1._pass_a_plan(q, DROPOUT_RATE)
        if b == MC_TRAIN_BATCH * MC_CHANNELS and h in (min(heads), max(heads)):
            print(f"K2 pass A at B={b} H={h}:")
            sweeps[h] = pass_a_by_chunks(
                lambda: pass_a_and_sum(q, k, v, bias, gate, out, lse, do, DROPOUT_RATE),
                chunks[h], b)
        if b in (MC_TRAIN_BATCH, 3 * MC_TRAIN_BATCH, MC_TRAIN_BATCH * MC_CHANNELS):
            passes[h] = pass_times(q, k, v, bias, gate, out, lse, do, DROPOUT_RATE)
        del plain, lib
    for key, what in (("fwd", "K1 training"), ("bwd", "K2")):
        row = rows[key]
        row.update(bound_ms=1e3 * max(by_bytes[key], by_flops[key]),
                   bound_by="bytes" if by_bytes[key] >= by_flops[key] else "operations",
                   max_rel_err=err_max[key])
        print(f"{what} bf16 rate {DROPOUT_RATE} B={b} heads {heads} ({len(heads)} calls): kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, SDPA "
              f"{'forward' if key == 'fwd' else 'backward'} {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms (by {row['bound_by']}); max error "
              f"{err_max[key]:.2e} of the largest magnitude")
    rows["bwd"]["pass_a_chunks"] = chunks
    rows["bwd"]["pass_a_chunks_by_s"] = sweeps
    rows["bwd"]["passes"] = passes
    print(f"K2 at B={b}: pass A chunks S {chunks}")
    return rows["fwd"], rows["bwd"]


def phase_multichannel(card: str, resnet_sd) -> dict:
    """The multi-channel recipe at its full width (Base-s80-md + 4 cross-
    channel fusions, hidden 256, 8 heads; 8 microphones; Conformer 4 x 256),
    seeded weights, in a temporary directory: an 8-channel 120 s WAV, an
    experiment directory of three checkpoints, a seeded PLDA directory.
    Serving: the float32 pipeline's RTTM as the reference; the card's f32
    scores and spatial attention against the CPU's; the infer CLI in bf16 with
    VBx (warm-up, then timed: seconds with loading, audio-s/s, K1 launches,
    DER against the reference), the stage seconds of one more call and a
    profiled call. K1 at
    the shape of layers 0-3 (B 16 x 8 streams). Training: the run CLI for one
    epoch of 8 steps at 8 x 8 s, bf16, k drawn by the recipe's sampler, and
    `-M validate`; one profiled step at k = 8; K1's training instance and K2
    at B = 8 k for every k.
    Returns the rows and launches for the kernels line."""
    repo = Path(__file__).resolve().parent
    uri = "mc0"
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        wave = make_mc_wave(AUDIO_SECONDS, seed=8)
        write_pcm16(root / f"{uri}.wav", pcm16(wave))
        (root / "wav.scp").write_text(f"{uri} {root / uri}.wav\n")
        (root / "plda").mkdir()
        write_plda(root / "plda")
        train = write_kaldi_dir(root, "train", [200] * 2, seed=20, channels=MC_CHANNELS)
        dev = write_kaldi_dir(root, "dev", [70], seed=21, channels=MC_CHANNELS)
        conf = recipe_toml(repo / "recipes/diar_ssl_mc/conf/wavlm_mc_chatt.toml", root, {
            "trainer.args.max_epochs": 1, "trainer.args.max_num_checkpoints": 1,
            "clustering.args.plda_dir": str(root / "plda"),
            **data_changes("train_dataset", train), **data_changes("validate_dataset", dev)})
        config = port_config.load_toml(conf)
        cfg, model = port_config.instantiate_section(config, "model")
        check(isinstance(model, McEendModel) and cfg.num_channels == MC_CHANNELS
              and cfg.fusion.num_fusion_layers == MC_STREAM_LAYERS, "the MC recipe's model")
        exp = root / "exp" / "infer"
        seeded_checkpoints(model, exp, seed=40, count=MC_CHECKPOINTS)
        resnet_ckpt = root / "resnet34.bin"
        torch.save({"state_dict": resnet_sd}, resnet_ckpt)
        print(f"multichannel inputs: {MC_CHANNELS} x {AUDIO_SECONDS} s WAV, {MC_CHECKPOINTS} "
              f"checkpoints, Kaldi directories ({time.perf_counter() - t0:.1f} s)")

        # ---- the float32 reference and the card against the CPU ---------------
        model.load_state_dict(average_checkpoints(sorted((exp / "checkpoints").iterdir())))
        cl = config["clustering"]["args"]
        seg32 = SlidingInference(model, batch_size=MC_BATCH, compute_dtype=torch.float32)
        emb = EmbeddingInference(pipelines.load_resnet(resnet_ckpt), seg32.window_size,
                                 num_speakers=cfg.max_speakers_per_chunk, batch_size=MC_BATCH)
        vbx = recipe_infer.build_clustering(cl, "VBxClustering", fa=0.06, fb=0.9)
        n_windows = len(seg32.prepare_wave(wave)[1])
        t0 = time.perf_counter()
        with strict_float32():
            reference = DiarizationPipeline(seg32, emb, vbx, cfg, max_speakers=8,
                                            embedding_exclude_overlap=False)(wave, 16000, uri=uri)
        write_rttm(root / "ref.rttm", [reference])
        print(f"multichannel f32 reference: {check_rttm(reference.to_rttm(), uri)} segments, "
              f"speakers {reference.labels()} ({time.perf_counter() - t0:.1f} s)")
        windows = torch.from_numpy(np.stack([wave[:, :128000], wave[:, 12800:140800]]))
        outs = {}
        for device in ("cpu", "cuda"):
            m = McEendModel(cfg)
            m.load_state_dict(model.state_dict())
            with torch.inference_mode(), strict_float32():
                outs[device] = [o.cpu() for o in m.to(device).eval()(windows.to(device))]
        errs = [(g - w).abs().max().item() for g, w in zip(outs["cuda"], outs["cpu"])]
        print(f"MC EEND f32 card vs CPU on 2 windows x {MC_CHANNELS} channels: scores "
              f"{tuple(outs['cuda'][0].shape)} max abs err {errs[0]:.3e}, spatial attention "
              f"{tuple(outs['cuda'][1].shape)} max abs err {errs[1]:.3e} (limit 1e-3)")
        check(tuple(outs["cuda"][1].shape) == (2, MC_STREAM_LAYERS, FRAMES, MC_CHANNELS,
                                               MC_CHANNELS)
              and all(bool(torch.isfinite(o).all()) for o in outs["cuda"]) and max(errs) <= 1e-3,
              f"MC EEND on the card disagrees with the CPU: {errs}")
        del seg32, emb, m

        # ---- serving: the recipe's infer CLI, bf16, VBx -------------------------
        argv = ["-C", str(conf), "--exp_dir", str(exp), "--wav_scp", str(root / "wav.scp"),
                "--embedding_ckpt", str(resnet_ckpt), "--num_channels", str(MC_CHANNELS),
                "--avg_ckpt_num", str(MC_CHECKPOINTS), "--ref_rttm", str(root / "ref.rttm")]
        mc_infer.main(argv + ["--out_dir", str(root / "warmup")])
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        hyps = mc_infer.main(argv + ["--out_dir", str(root / "out")])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        serving_k1 = cuda_build.launch_totals()["k1"]
        attention_layers = sum(cfg.wavlm.use_attention)
        batches = -(-n_windows // MC_BATCH)
        summary = json.loads((root / "out" / "der.json").read_text())
        record = tracing.records()[-1]  # the timed call's file, on the serving path
        print(f"MC record: channels {record.channels}, emb_rows {record.emb_rows}, segmentation "
              f"batches graph {record.seg_graph_batches} eager {record.seg_eager_batches}, "
              f"embedding batches graph {record.emb_graph_batches} eager "
              f"{record.emb_eager_batches}; stream ms: segmentation {record.seg_stream_ms}, "
              f"extractor {record.seg_extract_ms}, encoder {record.seg_encode_ms} (of it the "
              f"fused channels {record.seg_fuse_ms}), embeddings {record.embed_stream_ms}")
        check(record.channels == MC_CHANNELS and record.emb_rows == n_windows * MC_CHANNELS
              and record.seg_graph_batches + record.seg_eager_batches == batches
              and record.seg_fuse_ms is not None,
              f"the MC file's record: {record}")
        print(f"MC recipe CLI {card}: {MC_CHANNELS} x {AUDIO_SECONDS} s, {MC_CHECKPOINTS} "
              f"checkpoints averaged, bf16, VBx: {seconds:.3f} s a file with loading = "
              f"{AUDIO_SECONDS / seconds:.2f} audio-s/s; K1 launches {serving_k1}; segments "
              f"{check_rttm(hyps[uri].to_rttm(), uri)}, speakers {hyps[uri].labels()}; DER "
              f"against the f32 reference {100 * summary['der']:.4f}% (limit "
              f"{100 * DER_LIMIT:.1f}%)")
        check(serving_k1 == batches * attention_layers,
              f"expected {batches * attention_layers} K1 launches, got {serving_k1}")
        check(summary["der"] <= DER_LIMIT, f"MC recipe DER {summary['der']} above {DER_LIMIT}")
        timer = StageTimer()
        pipe = mc_infer.build_pipeline(mc_infer.parse_args(argv + ["--out_dir", str(root)]),
                                       config)
        timer.last = time.perf_counter()
        pipe(wave, 16000, uri=uri, hook=timer)
        for step, sec in timer.seconds.items():
            print(f"  MC stage {step} {card}: {sec:.4f} s")
        phase_profile(f"one MC pipeline call {card}", lambda: pipe(wave, 16000, uri=uri))
        del pipe, hyps

        gen = torch.Generator(device="cuda").manual_seed(9)
        heads = [len(h) for h, a in zip(cfg.wavlm.remaining_heads[:MC_STREAM_LAYERS],
                                        cfg.wavlm.use_attention) if a]
        with strict_float32():
            k1_row = mc_k1_layers(heads, MC_BATCH * MC_CHANNELS, gen)
            k1_row["per_stream_b16"] = mc_k1_layers(heads, MC_BATCH, gen)
        k1_row["launches_per_file"] = serving_k1
        elapsed("multichannel serving")

        # ---- training: the recipe's run CLI, then -M validate -------------------
        recorder = LaunchRecorder()
        t0 = time.perf_counter()
        trained = mc_run.main(["-C", str(conf), "-M", "train"], step_hook=recorder)
        validated = mc_run.main(["-C", str(conf), "-M", "validate"])
        seconds = time.perf_counter() - t0
        steps = recorder.steps
        for i, st in enumerate(steps):  # step 0's wall time includes the recipe's set-up
            print(f"  MC train step {i}: k {st['num_channels']}, loss {st['loss']:.5f}, "
                  f"{st['ms']:.2f} ms; K1 training {st['k1_train']}, K2 {st['k2']}")
        print(f"MC train recipe {card}: {len(steps)} steps of {MC_TRAIN_BATCH} x 8 s (bf16), k "
              f"{[st['num_channels'] for st in steps]}, and validation in {seconds:.1f} s; "
              f"validation loss {trained['loss']:.5f} DER {trained['der']:.5f}, -M validate "
              f"{validated['loss']:.5f} / {validated['der']:.5f}")
        check(len(steps) == TRAIN_STEPS and all(np.isfinite(st["loss"]) and not st["skipped"]
                                                for st in steps), "an MC train step failed")
        check(all(st["k1_train"] == st["k2"] == attention_layers for st in steps),
              f"K1 training and K2 must each launch {attention_layers} times an MC step")
        check(all(np.isfinite(validated[k]) and abs(validated[k] - trained[k])
                  <= 1e-3 * max(1.0, abs(trained[k])) for k in ("loss", "der")),
              f"-M validate {validated} disagrees with the epoch's validation {trained}")

        # every k the sampler drew, and k = 8: a warm-up step and 3 timed
        # steps each from the run's checkpoint, then one profiled step at k = 8
        run_exp = root / "exp" / conf.stem
        model.load_state_dict(load_checkpoint(latest_checkpoint(run_exp / "checkpoints"))[0])
        state = create_train_state(model, recipe_run.build_optimizer(config, model))
        batch = next(iter(DataLoader(recipe_run.build_dataset(
            config["train_dataset"], cfg, num_channels=MC_CHANNELS, channel_mode="multichannel"),
            batch_size=MC_TRAIN_BATCH, shuffle=False)))
        per_k = {}
        for k in sorted({st["num_channels"] for st in steps} | {MC_CHANNELS}):
            mc_train_step(state, batch, 0, torch.bfloat16, k)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_build.reset_launches()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                mc_train_step(state, batch, 0, torch.bfloat16, k)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            per_k[k] = {"ms": float(np.median(times)),
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                        **{k: n // 3 for k, n in launch_counts("k1_train", "k2").items()}}
            print(f"MC train step {card} at k {k} ({MC_TRAIN_BATCH * k} streams in layers 0-3): "
                  f"{per_k[k]['ms']:.2f} ms/step (median of 3), peak "
                  f"{per_k[k]['peak_gib']:.3f} GiB, K1 training {per_k[k]['k1_train']} and K2 "
                  f"{per_k[k]['k2']} launches a step")
        profiled_ms = profile_train_step(
            lambda: mc_train_step(state, batch, 0, torch.bfloat16, MC_CHANNELS),
            f"at k {MC_CHANNELS} {card}")
        del state, model
        torch.cuda.empty_cache()

        trainable = {k: mc_trainable(MC_TRAIN_BATCH * k, heads, gen) for k in per_k}
        elapsed("multichannel training")
    rows = {"k1_train": {}, "k2": {}}
    for k, pair in trainable.items():
        for key, row in zip(rows, pair):
            rows[key][k] = {**row, "launches_per_step": per_k[k][key]}
    return {"k1": k1_row, "per_k": per_k, **rows, "profiled_ms_k8": profiled_ms}


FAMILY_TOMLS = {  # the baselines' recipe TOMLs: model class, train durations (s)
    "fbank_conformer": (FbankEendModel, [200] * 4),  # 16 x 8 s: 132 chunks, 8 steps
    "pyannote_baseline": (SincNetEendModel, [200] * 8),  # 32 x 8 s: 264 chunks, 8 steps
}
FAMILY_DEV = [136]  # 17 chunks of 8 s at shift 8: one validation batch of 16


def card_against_cpu(make, state_dict, inputs, what: str, limit: float = 1e-3) -> list:
    """A model's float32 outputs on the card (kernel path, no TF32) against
    the CPU's (plain path) on the same inputs: `make()` builds it, `inputs`
    is a list of argument tuples. Returns the card's outputs."""
    outs = {}
    for device in ("cpu", "cuda"):
        model = make()
        model.load_state_dict(state_dict)
        model.to(device).eval()
        with torch.inference_mode(), strict_float32():
            outs[device] = [model(*(a.to(device) for a in args)).cpu() for args in inputs]
    errs = [(g - w).abs().max().item() for g, w in zip(outs["cuda"], outs["cpu"])]
    print(f"{what} f32 card vs CPU: outputs {[tuple(o.shape) for o in outs['cuda']]}, max abs "
          f"err {max(errs):.3e} (limit {limit:.0e}), largest magnitude "
          f"{max(o.abs().max().item() for o in outs['cpu']):.3e}")
    check(all(bool(torch.isfinite(o).all()) for o in outs["cuda"]) and max(errs) <= limit,
          f"{what} on the card disagrees with the CPU: {errs}")
    return outs["cuda"]


def family_recipe(card: str, root: Path, stem: str, waves, flac_jobs, resnet_ckpt: Path) -> dict:
    """One baseline's recipe TOML, unedited but for its data, epochs and
    experiment directory: `recipes.diar_ssl.run` for one epoch of 8 steps
    (bf16 requested) and `-M validate`; then an experiment of three seeded
    checkpoints, the float32 pipeline's RTTMs of the four WAV files as the
    reference, the card's f32 scores against the CPU's, and
    `recipes.diar_ssl.infer` on the FLAC copies in bf16 with the TOML's AHC
    (warm-up, then timed) with its DER. Returns its numbers."""
    repo = Path(__file__).resolve().parent
    model_class, durations = FAMILY_TOMLS[stem]
    t0 = time.perf_counter()
    train = write_kaldi_dir(root, f"{stem}_train", durations, seed=50)
    dev = write_kaldi_dir(root, f"{stem}_dev", FAMILY_DEV, seed=51)
    conf = recipe_toml(repo / f"recipes/diar_ssl/conf/{stem}.toml", root, {
        "trainer.args.max_epochs": 1, "trainer.args.max_num_checkpoints": 1,
        **data_changes("train_dataset", train), **data_changes("validate_dataset", dev)})
    config = port_config.load_toml(conf)
    batch = config["train_dataset"]["dataloader"]["batch_size"]
    print(f"{stem} inputs: Kaldi directories of {sum(durations)} s and {sum(FAMILY_DEV)} s "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- training: the recipe's run CLI, then -M validate -----------------------
    torch.cuda.reset_peak_memory_stats()
    recorder = LaunchRecorder()
    t0 = time.perf_counter()
    trained = recipe_run.main(["-C", str(conf), "-M", "train"], step_hook=recorder)
    validated = recipe_run.main(["-C", str(conf), "-M", "validate"])
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = recorder.steps
    step_ms = float(np.median([st["ms"] for st in steps[2:]]))
    print(f"{stem} train recipe {card}: {len(steps)} steps of {batch} x 8 s (bf16 requested), "
          f"median {step_ms:.2f} ms/step after 2 warm-up steps "
          f"({', '.join(f'{ms:.1f}' for ms in (st['ms'] for st in steps))} ms), peak device "
          f"memory {peak:.3f} "
          f"GiB; validation loss {trained['loss']:.5f} DER {trained['der']:.5f}, -M validate "
          f"{validated['loss']:.5f} / {validated['der']:.5f} ({seconds:.1f} s in all)")
    check(len(steps) == TRAIN_STEPS and all(np.isfinite(st["loss"]) and not st["skipped"]
                                            and st["attention_layers"] == 0 for st in steps),
          f"a {stem} train step failed")
    check(all(st["k1"] == st["k1_train"] == st["k2"] == 0 for st in steps),
          f"{stem} launched an attention kernel")
    check(all(np.isfinite(validated[k]) and abs(validated[k] - trained[k])
              <= 1e-3 * max(1.0, abs(trained[k])) for k in ("loss", "der")),
          f"{stem}: -M validate {validated} disagrees with the epoch's validation {trained}")

    # one more train step from the run's checkpoint, under the profiler
    cfg, model = port_config.instantiate_section(config, "model")
    check(isinstance(model, model_class), f"{stem} builds {type(model).__name__}")
    model.load_state_dict(load_checkpoint(latest_checkpoint(root / "exp" / conf.stem
                                                            / "checkpoints"))[0])
    state = create_train_state(model, recipe_run.build_optimizer(config, model))
    data = next(iter(DataLoader(recipe_run.build_dataset(config["train_dataset"], cfg),
                                batch_size=batch, shuffle=False)))
    train_step(state, data, 0, torch.bfloat16)  # the optimizer's state
    profile_train_step(lambda: train_step(state, data, 1, torch.bfloat16), f"{stem} {card}")
    del state, model
    cfg, model = port_config.instantiate_section(config, "model")  # fresh, on the host

    # ---- serving: three checkpoints, the f32 reference, the infer CLI -----------
    exp = root / "exp" / f"{stem}_infer"
    seeded_checkpoints(model, exp, seed=52, count=EVAL_CHECKPOINTS)
    model.load_state_dict(average_checkpoints(sorted((exp / "checkpoints").iterdir())))
    uris = [f"{stem}{i}" for i in range(STREAM_FILES)]
    for uri, wave, job in zip(uris, waves, flac_jobs):
        write_pcm16(root / f"{uri}.wav", pcm16(wave))
        (root / f"{uri}.flac").write_bytes(job.result())
    (root / f"{stem}.scp").write_text("".join(f"{u} {root / u}.flac\n" for u in uris))
    frames = cfg.num_frames(128000)
    windows = torch.from_numpy(np.stack([waves[0][0, :128000], waves[0][0, 12800:140800]]))
    card_against_cpu(lambda: model_class(cfg), model.state_dict(), [(windows,)],
                     f"{stem} scores ({frames} frames a window)")
    seg32 = SlidingInference(model, batch_size=BATCH, compute_dtype=torch.float32)
    emb = EmbeddingInference(pipelines.load_resnet(resnet_ckpt), seg32.window_size,
                             num_speakers=cfg.max_speakers_per_chunk, batch_size=BATCH)
    cl = config["clustering"]["args"]
    ahc = AgglomerativeClustering(threshold=cl["ahc_threshold"],
                                  min_cluster_size=cl["min_cluster_size"])
    t0 = time.perf_counter()
    with strict_float32():
        reference = [DiarizationPipeline(seg32, emb, ahc, cfg, max_speakers=cl["max_speakers"])(
            read_audio(root / f"{uri}.wav")[0], 16000, uri=uri) for uri in uris]
    write_rttm(root / f"{stem}_ref.rttm", reference)
    print(f"{stem} f32 reference: {[check_rttm(r.to_rttm(), u) for r, u in zip(reference, uris)]}"
          f" segments ({time.perf_counter() - t0:.1f} s)")
    del seg32, emb

    argv = ["-C", str(conf), "--exp_dir", str(exp), "--wav_scp", str(root / f"{stem}.scp"),
            "--avg_ckpt_num", str(EVAL_CHECKPOINTS), "--embedding_ckpt", str(resnet_ckpt),
            "--ref_rttm", str(root / f"{stem}_ref.rttm")]
    recipe_infer.main(argv + ["--out_dir", str(root / f"{stem}_warmup")])
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    hyps = recipe_infer.main(argv + ["--out_dir", str(root / f"{stem}_out")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    summary = json.loads((root / f"{stem}_out" / "der.json").read_text())
    segments = [check_rttm(hyps[u].to_rttm(), u) for u in uris]
    print(f"{stem} recipe CLI {card}: {STREAM_FILES} x {AUDIO_SECONDS} s FLAC, "
          f"{EVAL_CHECKPOINTS} checkpoints averaged, bf16 requested, AHC: {seconds:.3f} s with "
          f"loading = {seconds / STREAM_FILES:.3f} s a file; {frames} frames a window; segments "
          f"{segments}; DER against the f32 reference {100 * summary['der']:.4f}% (false alarm "
          f"{100 * summary['false_alarm']:.4f}%, miss {100 * summary['missed_detection']:.4f}%, "
          f"confusion {100 * summary['confusion']:.4f}%; limit {100 * DER_LIMIT:.1f}%)")
    check(not any(launch_counts("k1", "k3", "k4", "k5").values()),
          f"{stem} serving launched a WavLM kernel")
    check(summary["der"] <= DER_LIMIT, f"{stem} recipe DER {summary['der']} above {DER_LIMIT}")
    timer = StageTimer()
    pipe = recipe_infer.build_pipeline(recipe_infer.parse_args(argv + ["--out_dir", str(root)]),
                                       config)
    wave = read_audio(root / f"{uris[0]}.flac")[0]
    timer.last = time.perf_counter()
    pipe(wave, 16000, uri=uris[0], hook=timer)
    for step, sec in timer.seconds.items():
        print(f"  {stem} stage {step} {card}: {sec:.4f} s")
    phase_profile(f"one {stem} pipeline call {card}", lambda: pipe(wave, 16000, uri=uris[0]))
    del pipe
    return {"step_ms": step_ms, "peak_gib": peak, "seconds_a_file": seconds / STREAM_FILES,
            "der": summary["der"], "frames": frames}


def sserious_k1_train_row(gen) -> dict:
    """K1's training instance forward alone (no K2 follows it in SSeRiouSS)
    at the trunk's training shape (B 32, H 12, T 399) bf16, rate 0.1: against
    the plain version (2e-2 of the largest magnitude), timed beside it, SDPA
    with dropout and the bound."""
    (q, k, v, pos, gate), _ = trainable_inputs(BATCH, TRAIN_HEADS, FRAMES, torch.bfloat16, gen)
    bias = k1.padded_bias(pos, torch.bfloat16)
    mask = (gate[..., None] * pos).to(torch.bfloat16)
    args = (q, k, v, pos, gate, DROPOUT_RATE, DROPOUT_SEED)
    with torch.no_grad():
        got = k1.flash_attention_gated_bias_trainable(*args)
        want = k1.flash_attention_gated_bias_reference(*args)
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        check(err <= 2e-2 * scale, f"K1 training instance at B {BATCH}: {err} of {scale}")
        row = {
            "ms": median_ms(lambda: k1._forward_train(q, k, v, bias, gate, DROPOUT_RATE,
                                                      DROPOUT_SEED)),
            "plain_ms": median_ms(lambda: k1.flash_attention_gated_bias_reference(*args)),
            "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=DROPOUT_RATE)),
        }
    mem_s, op_s = trainable_bound_s(BATCH, TRAIN_HEADS, FRAMES, HEAD_DIM, 2)["fwd"]
    row.update(max_abs_err=err, bound_ms=1e3 * max(mem_s, op_s),
               bound_by="bytes" if mem_s >= op_s else "operations")
    print(f"gated_bias_attention_train forward only bf16 B={BATCH} H={TRAIN_HEADS} T={FRAMES} "
          f"rate={DROPOUT_RATE} (the SSeRiouSS trunk's training forward): kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} "
          f"ms, bound {row['bound_ms']:.4f} ms; max abs err {err:.3e} of {scale:.3e}")
    return row


def phase_sserious(card: str) -> dict:
    """SSeRiouSS on WavLM-Base with 4 BiLSTM(128) layers, seeded, 32 windows
    of 8 s: the bf16 eval with the fused-LN and conv-chain routes on (K1, K3,
    K4 and K5 counted; K1 12 a batch), its f32 scores with the routes on
    against off (1e-4) and on the card against the CPU (1e-3, two windows);
    one bf16 training forward and backward (no WavLM gradient), then timed
    train steps (K1's training instance 12 a step, K2 never), and K1's
    training instance alone at that shape."""
    scfg = SSeRiouSSConfig(wavlm=WavLMConfig.base())
    model = SSeRiouSSModel(scfg)
    sd = random_state_dict(model, seed=55)
    sd["wav2vec_weights"] = torch.from_numpy(
        np.random.default_rng(56).standard_normal(scfg.wavlm.num_layers).astype(np.float32))
    model.load_state_dict(sd)
    wave = make_wave(AUDIO_SECONDS, seed=9)[0]
    hop = 12800  # the pipeline's 0.8 s step
    windows = np.stack([wave[i * hop: i * hop + 128000] for i in range(BATCH)])
    card_against_cpu(lambda: SSeRiouSSModel(scfg), sd, [(torch.from_numpy(windows[:2]),)],
                     "SSeRiouSS scores")
    model.cuda()
    x = torch.from_numpy(windows).cuda()

    set_fused_ln(True)
    set_conv_chain(True)
    try:
        with torch.inference_mode():
            model(x, torch.bfloat16)
            torch.cuda.synchronize()
            cuda_build.reset_launches()
            scores16 = model(x, torch.bfloat16)
            torch.cuda.synchronize()
            counts = launch_counts("k1", "k3", "k4", "k5")
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                model(x, torch.bfloat16)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            with strict_float32():
                on32 = model(x, torch.float32)
            phase_profile(f"one SSeRiouSS eval batch {card}", lambda: model(x, torch.bfloat16))
    finally:
        set_fused_ln(None)
        set_conv_chain(None)
    with torch.inference_mode(), strict_float32():
        off32 = model(x, torch.float32)
    eval_ms = float(np.median(times))
    err = (on32 - off32).abs().max().item()
    print(f"SSeRiouSS eval {card}: {BATCH} x 8 s in bf16 with fused-LN and conv-chain on, "
          f"{eval_ms:.2f} ms a batch (median of 5); launches a batch: K1 {counts['k1']}, K3 "
          f"{counts['k3']}, K4 {counts['k4']}, K5 {counts['k5']}; f32 routes on vs off max abs "
          f"err {err:.3e} (limit 1e-4)")
    check(tuple(off32.shape) == (BATCH, FRAMES, scfg.num_powerset_classes), "SSeRiouSS shape")
    check(counts["k1"] == scfg.wavlm.num_layers and min(counts.values()) > 0,
          f"SSeRiouSS eval launches {counts}")
    check(bool(torch.isfinite(on32).all()) and err <= 1e-4, f"SSeRiouSS routes on vs off: {err}")
    check_scores(scores16.float(), off32, 0.1, 0.01, "SSeRiouSS bf16 (routes on) vs f32 scores")

    # ---- training: no gradient reaches WavLM; K1's training instance, no K2 ------
    target = (np.random.default_rng(57).uniform(size=(BATCH, FRAMES, 4)) > 0.7
              ).astype(np.float32)
    head = {n: p for n, p in model.named_parameters() if not n.startswith("wav2vec.")}
    state = create_train_state(model, adamw_with_warmup(head, 1e-3))
    scores = model(x, torch.bfloat16, train=True, generator=torch.Generator().manual_seed(0))
    segmentation_loss(scfg.powerset, scores, torch.from_numpy(target).cuda()).backward()
    trunk_grads = [n for n, p in model.named_parameters()
                   if n.startswith("wav2vec.") and p.grad is not None]
    head_grads = [n for n, p in head.items() if p.requires_grad and p.grad is None]
    check(not trunk_grads and not head_grads,
          f"SSeRiouSS gradients: trunk {trunk_grads[:3]}, head without one {head_grads[:3]}")
    model.zero_grad(set_to_none=True)
    batch = {"xs": windows[:, None], "target": target}
    train_step(state, batch, 0, torch.bfloat16)  # warm-up: the optimizer's state
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times, steps = [], []
    for i in range(3):
        t0 = time.perf_counter()
        steps.append(train_step(state, batch, 1 + i, torch.bfloat16))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    step_ms = float(np.median(times))
    # layer drop (0.05 in WavLM-Base's training) skips a layer now and then:
    # one K1 training launch for each attention layer a step computed
    layers = [st["attention_layers"] for st in steps]
    launches = launch_counts("k1", "k1_train", "k2")
    print(f"SSeRiouSS train step {card}: {BATCH} x 8 s bf16, {step_ms:.2f} ms/step (median of "
          f"3: {', '.join(f'{t:.1f}' for t in times)}), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; losses "
          f"{[round(st['loss'], 5) for st in steps]}; attention layers computed {layers}; K1 "
          f"training {launches['k1_train']} in 3 steps, K1 inference {launches['k1']}, K2 "
          f"{launches['k2']}; WavLM gradients None")
    check(all(np.isfinite(st["loss"]) and not st["skipped"] for st in steps),
          f"SSeRiouSS steps {steps}")
    check(launches == {"k1": 0, "k1_train": sum(layers), "k2": 0} and min(layers) > 0,
          f"SSeRiouSS train launches {launches} for attention layers {layers}")
    profile_train_step(lambda: train_step(state, batch, 4, torch.bfloat16), f"SSeRiouSS {card}")
    del state, model
    torch.cuda.empty_cache()
    row = sserious_k1_train_row(torch.Generator(device="cuda").manual_seed(58))
    per_step = {"k1_train": launches["k1_train"] / 3, "k2": launches["k2"] / 3}
    return {"eval": counts, "eval_ms": eval_ms, "step_ms": step_ms, "train": per_step,
            "k1_train": {**row, "launches_per_step": per_step["k1_train"]}}


def phase_xvector(card: str) -> dict:
    """The x-vector with its MFCC and SincNet front ends, seeded, on 32
    windows of 8 s with and without pooling weights on the segmentation
    grid: the card's f32 embeddings against the CPU's (1e-3), and one batch
    timed on the card."""
    wave = make_wave(AUDIO_SECONDS, seed=10)[0]
    windows = torch.from_numpy(np.stack([wave[i * 12800: i * 12800 + 128000]
                                         for i in range(BATCH)]))
    weights = torch.from_numpy(np.random.default_rng(61).uniform(size=(BATCH, 3, FRAMES))
                               .astype(np.float32))
    out = {}
    for frontend in ("mfcc", "sincnet"):
        xcfg = XVectorConfig(frontend=frontend)
        sd = random_state_dict(XVectorModel(xcfg), seed=62)
        embs = card_against_cpu(lambda: XVectorModel(xcfg), sd,
                                [(windows,), (windows, weights)], f"x-vector {frontend}")
        check(tuple(embs[0].shape) == (BATCH, xcfg.dimension)
              and tuple(embs[1].shape) == (BATCH, 3, xcfg.dimension), "x-vector shapes")
        model = XVectorModel(xcfg)
        model.load_state_dict(sd)
        model.cuda().eval()
        xw = windows.cuda()
        with torch.inference_mode():
            ms = median_ms(lambda: model(xw), reps=10)
        print(f"x-vector {frontend} {card}: {BATCH} x 8 s ({xcfg.num_frames(128000)} TDNN "
              f"frames a window), {ms:.3f} ms a batch")
        out[frontend] = ms
    return out


def phase_families(card: str, resnet_sd, flac_jobs) -> dict:
    """The remaining model families at full width, seeded: the Fbank +
    Conformer and SincNet-BiLSTM recipe TOMLs (`family_recipe`), SSeRiouSS
    (`phase_sserious`) and the x-vector (`phase_xvector`)."""
    t0 = time.perf_counter()
    waves = [make_wave(AUDIO_SECONDS, seed=i) for i in range(STREAM_FILES)]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        resnet_ckpt = root / "resnet34.bin"
        torch.save({"state_dict": resnet_sd}, resnet_ckpt)
        for stem in FAMILY_TOMLS:
            out[stem] = family_recipe(card, root, stem, waves, flac_jobs, resnet_ckpt)
            torch.cuda.empty_cache()
    elapsed("the baselines' recipes")
    out["sserious"] = phase_sserious(card)
    out["xvector"] = phase_xvector(card)
    print(f"the remaining families: {time.perf_counter() - t0:.1f} s")
    return out


def hf_config_dict(cfg: WavLMConfig) -> dict:
    """The `config.json` of an HF `WavLMModel` of `cfg`'s architecture (an
    unpruned WavLM; the inverse of `wavlm_config_from_hf`)."""
    return {
        "model_type": "wavlm", "architectures": ["WavLMModel"],
        "hidden_size": cfg.embed_dim, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.total_num_heads[0],
        "intermediate_size": cfg.ff_interm_features[0],
        "feat_extract_norm": "layer" if cfg.extractor_mode == "layer_norm" else "group",
        "conv_dim": [c for c, _, _ in cfg.conv_layers],
        "conv_kernel": [k for _, k, _ in cfg.conv_layers],
        "conv_stride": [st for _, _, st in cfg.conv_layers], "conv_bias": cfg.conv_bias,
        "feat_proj_dropout": cfg.projection_dropout,
        "num_conv_pos_embeddings": cfg.pos_conv_kernel,
        "num_conv_pos_embedding_groups": cfg.pos_conv_groups, "num_buckets": cfg.num_buckets,
        "max_bucket_distance": cfg.max_distance, "attention_dropout": cfg.attention_dropout,
        "activation_dropout": cfg.ff_interm_dropout, "hidden_dropout": cfg.dropout,
        "do_stable_layer_norm": cfg.layer_norm_first, "layerdrop": cfg.layer_drop,
    }


def write_safetensors(path: Path, tensors: dict) -> None:
    """Write tensors as a `.safetensors` file (the header padded with spaces
    to a multiple of 8 bytes, as the format asks): the HF directory of
    `phase_hf_import`, without the safetensors package."""
    names = {dtype: name for name, dtype in
             convert_wavlm_from_hf.SAFETENSORS_DTYPES.items()}
    header, chunks, offset = {}, [], 0
    for name, t in tensors.items():
        raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    Path(path).write_bytes(len(text).to_bytes(8, "little") + text + b"".join(chunks))


def phase_hf_import(card: str) -> int:
    """The pruning recipe's first stage at WavLM-Base's width (768 wide, 12
    layers of 12 heads): the port's seeded WavLM written as an HF directory
    (`config.json`, the HF-layout state dict as `model.safetensors`) through
    the inverse key map, converted by the port's CLI, its `params.npz` loaded
    back; the imported model's f32 hidden states on the card equal the seeded
    model's (1e-5), and its bf16 forward through K1 (one launch a layer) is
    within 1e-1 of max(1, |hidden state|) of f32, the bar of the pruning
    phase's bf16 hidden states. Returns K1's launches in that forward."""
    cfg = WavLMConfig.base()
    seeded = WavLM(cfg)
    seeded.load_state_dict(random_state_dict(seeded, seed=61))
    wave = make_wave(AUDIO_SECONDS, seed=11)[0]
    x = torch.from_numpy(np.stack([wave[i * 12800: i * 12800 + 128000]
                                   for i in range(TRAIN_BATCH)])).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        hf_dir, out = Path(tmp) / "wavlm-base-hf", Path(tmp) / "converted"
        hf_dir.mkdir()
        (hf_dir / "config.json").write_text(json.dumps(hf_config_dict(cfg), indent=2))
        write_safetensors(hf_dir / "model.safetensors",
                          wavlm_state_dict_to_hf(seeded.state_dict()))
        t0 = time.perf_counter()
        convert_wavlm_from_hf.main(["--hf_dir", str(hf_dir), "--out_dir", str(out)])
        seconds = time.perf_counter() - t0
        converted_cfg = WavLMConfig(**{
            k: tuple(tuple(x) if isinstance(x, list) else x for x in v) if isinstance(v, list)
            else v for k, v in json.loads((out / "config.json").read_text()).items()})
        imported = WavLM(converted_cfg)
        imported.load_state_dict(wavlm_state_dict_from_jax(load_pytree(out / "params.npz"),
                                                           converted_cfg), strict=True)
        size = (hf_dir / "model.safetensors").stat().st_size
    check(converted_cfg == cfg == wavlm_config_from_hf(hf_config_dict(cfg)),
          "the converted config differs from WavLM-Base's")
    seeded.cuda().eval()
    imported.cuda().eval()
    with torch.no_grad():
        with strict_float32():
            want = seeded.hidden_states(x)
            f32_err = hidden_errors(imported.hidden_states(x), want)
        cuda_build.reset_launches()
        got = imported.hidden_states(x, torch.bfloat16)
        torch.cuda.synchronize()
        launches = cuda_build.launch_totals()["k1"]
        bf16_err = hidden_errors(got, want)
    print(f"HF import {card}: WavLM-Base ({size / 2**20:.1f} MiB of safetensors) converted in "
          f"{seconds:.2f} s; imported against seeded f32 hidden states {f32_err:.3e} (limit "
          f"1e-5), bf16 against f32 {bf16_err:.3e} of max(1, |h|) (limit 1e-1), K1 launches in "
          f"the bf16 forward {launches}")
    check(f32_err <= 1e-5 and bf16_err <= 1e-1, "the imported WavLM disagrees with the seeded one")
    check(launches == cfg.num_layers, f"expected {cfg.num_layers} K1 launches, got {launches}")
    return launches


def train_batch(cfg: EendConfig, seed: int) -> dict:
    """A seeded batch of TRAIN_BATCH x 8 s: noise waveforms and sparse targets."""
    rng = np.random.default_rng(seed)
    return {"xs": (0.1 * rng.standard_normal((TRAIN_BATCH, 1, 128000))).astype(np.float32),
            "target": (rng.uniform(size=(TRAIN_BATCH, cfg.num_frames(128000), 4)) > 0.7
                       ).astype(np.uint8)}


def phase_schedules(card: str) -> None:
    """WavLM-Base + Conformer at 16 x 8 s in bf16 through K1 and K2, four
    steps each with `noam_adamw` (model size 256, warmup 2, factor 0.05: a
    peak of 2.2e-3) and with AdamW on
    a `one_cycle_schedule` (peak 1e-3 over 4 steps, warmup 25%): each step's
    learning rate beside its formula in float64 (noam within 1e-6, the port
    computing it in float32; one-cycle within 1e-12), finite losses, one K1
    training and one K2 launch per attention layer a step."""
    cfg = EendConfig(wavlm=WavLMConfig.base(), conformer=ConformerConfig())
    sd = random_state_dict(EendModel(cfg), seed=62)
    batch = train_batch(cfg, seed=63)
    total, peak, pct = 4, 1e-3, 0.25

    def noam(step):
        s = step + 1
        return 0.05 * 256 ** -0.5 * min(s ** -0.5, s * 2 ** -1.5)

    def cycle(step):
        lo, hi = (0, 1) if step < 1 else (1, total)
        start, end = (peak / 25, peak) if step < 1 else (peak, peak / 25 / 1e4)
        if step >= total:
            return end
        return end + (start - end) / 2 * (math.cos(math.pi * (step - lo) / (hi - lo)) + 1)

    for name, make, formula, limit in (
            ("noam_adamw", lambda p: noam_adamw(p, model_size=256, warmup=2, factor=0.05), noam,
             1e-6),
            ("one_cycle", lambda p: Optimizer({"all": p}, {"all": one_cycle_schedule(
                peak, total, pct)}), cycle, 1e-12)):
        model = EendModel(cfg)
        model.load_state_dict(sd)
        state = create_train_state(model, make(dict(model.named_parameters())))
        for step in range(total):
            lr = state.optimizer.schedules["all"](state.optimizer.state["count"]["all"])
            cuda_build.reset_launches()
            t0 = time.perf_counter()
            m = train_step(state, batch, seed=0, compute_dtype=torch.bfloat16)
            ms = 1e3 * (time.perf_counter() - t0)
            counts = tuple(launch_counts("k1_train", "k2").values())
            print(f"  {name} step {step} {card}: lr {lr:.6e}, formula {formula(step):.6e}; loss "
                  f"{m['loss']:.5f}, {ms:.1f} ms, K1 training {counts[0]}, K2 {counts[1]}")
            check(abs(lr - formula(step)) <= limit * formula(step), f"{name} lr at step {step}")
            check(np.isfinite(m["loss"]) and not m["skipped"], f"{name} step {step} not finite")
            check(counts[0] == counts[1] == m["attention_layers"] > 0,
                  f"{name} step {step}: K1/K2 launches {counts}")
        del model, state
    torch.cuda.empty_cache()


def free_local_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_data_parallel(card: str, eend_sd, resnet_sd, eend_cfg, wave) -> dict:
    """The data-parallel wiring in a world-size-1 NCCL group started by
    `initialize_distributed` at 127.0.0.1: one Base-s80-md pipeline call
    (bf16, AHC) on a 120 s file and one WavLM-Base + Conformer train step at
    16 x 8 s (bf16, K1 and K2) without a group and then in it must give the
    same RTTM text and the same loss (1e-6 relative; the gradient norm within
    1e-3, since the backward is not bitwise repeatable on the card). In the
    group the collectives run: the pipeline takes the host route, gathers
    its embeddings and broadcasts its clusters, and the step all-reduces the
    BatchNorm sums (forward and backward) and the gradients; each kind must
    have run, on the card. Returns the step's K1 training and K2
    launches."""
    def pipeline():
        model = EendModel(eend_cfg)
        model.load_state_dict(eend_sd)
        resnet = ResNet(ResNetConfig())
        resnet.load_state_dict(resnet_sd)
        seg = SlidingInference(model, batch_size=BATCH)
        return DiarizationPipeline(
            seg, EmbeddingInference(resnet, seg.window_size,
                                    num_speakers=eend_cfg.max_speakers_per_chunk),
            AgglomerativeClustering(threshold=0.7, min_cluster_size=30), eend_cfg,
            max_speakers=8)

    cfg = EendConfig(wavlm=WavLMConfig.base(), conformer=ConformerConfig())
    train_sd = random_state_dict(EendModel(cfg), seed=64)
    batch = train_batch(cfg, seed=65)

    def run() -> dict:
        rttm = pipeline()(wave, 16000, uri="dp").to_rttm()
        model = EendModel(cfg)
        model.load_state_dict(train_sd)
        state = create_train_state(model, recipe_optimizer(model))
        cuda_build.reset_launches()
        m = train_step(state, batch, seed=0, compute_dtype=torch.bfloat16)
        return {"rttm": rttm, "loss": m["loss"], "grad_norm": m["grad_norm"],
                **launch_counts("k1_train", "k2")}

    alone = run()
    calls = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}
    devices = set()
    originals = {name: getattr(torch.distributed, name) for name in calls}

    def counted(name):
        def collective(*args, **kwargs):
            calls[name] += 1
            devices.add(str(args[1 if name == "all_gather" else 0].device))
            return originals[name](*args, **kwargs)
        return collective

    port = free_local_port()
    t0 = time.perf_counter()
    dp.initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    init_s = time.perf_counter() - t0
    try:
        probe = torch.arange(4.0, device="cuda")
        torch.distributed.all_reduce(probe)
        check(torch.distributed.get_backend() == "nccl" and dp.process_count() == 1
              and dp.is_main_process() and torch.equal(probe.cpu(), torch.arange(4.0)),
              "the NCCL group of one process")
        for name in calls:
            setattr(torch.distributed, name, counted(name))
        grouped = run()
    finally:
        for name, fn in originals.items():
            setattr(torch.distributed, name, fn)
        torch.distributed.destroy_process_group()
    print(f"data parallel {card}: NCCL group of 1 at 127.0.0.1:{port} in {init_s:.2f} s; RTTM "
          f"{len(alone['rttm'].splitlines())} segments, equal: {grouped['rttm'] == alone['rttm']}; "
          f"loss {grouped['loss']:.7f} vs {alone['loss']:.7f}, grad norm "
          f"{grouped['grad_norm']:.6f} vs {alone['grad_norm']:.6f}; K1 training "
          f"{grouped['k1_train']}, K2 {grouped['k2']} launches in the step; collectives in "
          f"the group {calls} on {sorted(devices)}")
    check(min(calls.values()) > 0 and devices == {"cuda:0"},
          "the collectives did not all run on the card in the group of one")
    check(grouped["rttm"] == alone["rttm"] and len(alone["rttm"].splitlines()) > 0,
          "the RTTM in a group of one differs from the one without")
    check(abs(grouped["loss"] - alone["loss"]) <= 1e-6 * abs(alone["loss"]),
          "the train step's loss in a group of one differs from the one without")
    # the backward is not bitwise repeatable on the card (ROADMAP.md section 3)
    check(abs(grouped["grad_norm"] - alone["grad_norm"]) <= 1e-3 * alone["grad_norm"],
          "the train step's gradient norm in a group of one differs from the one without")
    check(grouped["k1_train"] == grouped["k2"] > 0, "K1/K2 launches of the data-parallel step")
    return {"k1_train": grouped["k1_train"], "k2": grouped["k2"]}


TP_BATCH = 8  # rows of 8 s: the one-process reference and both ranks share the card's 80 GB
TP_SEED = 7
TP_TIMEOUT = 900  # seconds for the two rank processes


class GradRecorder:
    """The train step's optimizer interface that moves nothing: it keeps the
    gradients the step hands it, after their mean over the mesh."""

    def __init__(self, model: torch.nn.Module):
        self.params = dict(model.named_parameters())
        self.recorded = {}

    def grads(self):
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params.values()]

    @torch.no_grad()
    def step(self, grads, value=None, norm=None):
        self.recorded = {n: g.detach().clone() for n, g in zip(self.params, grads)}


def tensor_parallel_config() -> EendConfig:
    """WavLM-Large (24 x 1024, 16 heads, FF 4096) + Conformer 4 x 256."""
    return EendConfig(wavlm=WavLMConfig.large(), conformer=ConformerConfig(),
                      wavlm_layer_num=25, wavlm_feat_dim=1024)


def tensor_parallel_rank(rank: int, port: int, work: str) -> int:
    """One rank of `phase_tensor_parallel`: a (1, 2) mesh under gloo on
    cuda:0. The f32 forward and one f32 train step (gradients gathered to
    the full layout), then two bf16 steps with the recipe's optimizer, each
    counting K1 and K2 launches and the model group's all-reduces; the
    results go to `work`/rank<rank>.pt."""
    from diarizen_tpu_torch.parallel import gather_state, make_mesh, shard_model_
    from diarizen_tpu_torch.train import TrainState

    torch.cuda.set_device(0)
    inputs = torch.load(Path(work) / "inputs.pt", weights_only=False, mmap=True)
    cfg, batch = inputs["cfg"], inputs["batch"]
    dp.initialize_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    mesh = make_mesh(1, 2)

    def split_model():
        model = EendModel(cfg)
        model.load_state_dict(inputs["sd"])
        return shard_model_(model, mesh).cuda()

    out = {"place": (mesh.data_index, mesh.model_index)}
    with strict_float32():  # as the one-process reference ran
        model = split_model()
        cuda_build.reset_launches()
        with torch.no_grad():
            out["scores"] = model(torch.from_numpy(batch["xs"]).cuda(), torch.float32).cpu()
        out["k1_forward"] = cuda_build.launch_totals()["k1"]
        recorder = GradRecorder(model)
        cuda_build.reset_launches()
        dp.model_reduces = 0
        m = train_step(TrainState(model=model, optimizer=recorder), batch, seed=TP_SEED,
                       compute_dtype=torch.float32)
        out["f32"] = {**m, **launch_counts("k1_train", "k2"), "reduces": dp.model_reduces}
    grads = gather_state(recorder.recorded, model, mesh)
    if rank == 0:
        out["grads"] = {n: g.cpu() for n, g in grads.items()}
    del model, recorder, grads
    torch.cuda.empty_cache()

    model = split_model()
    state = TrainState(model=model, optimizer=recipe_optimizer(model))
    out["bf16"] = []
    for _ in range(2):
        cuda_build.reset_launches()
        dp.model_reduces = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(state, batch, seed=TP_SEED, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        out["bf16"].append({**m, "ms": 1e3 * (time.perf_counter() - t0),
                            **launch_counts("k1_train", "k2"),
                            "reduces": dp.model_reduces,
                            "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    torch.save(out, Path(work) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def trainable_rows(b: int, h: int, gen) -> list:
    """K1's training instance and K2 at (b, h, 399, 64) in bf16, rate 0.1,
    against the plain version (max abs error), timed beside the plain
    version, SDPA's forward and backward and the bound."""
    (q, k, v, pos, gate), do = trainable_inputs(b, h, FRAMES, torch.bfloat16, gen)
    bias = k1.padded_bias(pos, torch.bfloat16)
    mask = (gate[..., None] * pos).to(torch.bfloat16)
    rate, seed = DROPOUT_RATE, DROPOUT_SEED
    out, lse = k1._forward_train(q, k, v, bias, gate, rate, seed)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, pos, gate)]
    plain = k1.flash_attention_gated_bias_reference(*leaves, rate, seed)
    want = torch.autograd.grad(plain, leaves, do, retain_graph=True)
    got = k1._backward(q, k, v, bias, gate, out, lse, do, rate, seed)
    lib_leaves = [x.clone().requires_grad_() for x in (q, k, v, mask)]
    lib = F.scaled_dot_product_attention(*lib_leaves[:3], attn_mask=lib_leaves[3],
                                         dropout_p=rate)
    errors = {"fwd": (out.float() - plain.float()).abs().max().item(),
              "bwd": max((g.float() - w.float()).abs().max().item()
                         for g, w in zip(got, want))}
    rows = {
        "fwd": {"ms": median_ms(lambda: k1._forward_train(q, k, v, bias, gate, rate, seed)),
                "plain_ms": median_ms(lambda: k1.flash_attention_gated_bias_reference(
                    q, k, v, pos, gate, rate, seed)),
                "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, dropout_p=rate))},
        "bwd": {"ms": median_ms(lambda: k1._backward(q, k, v, bias, gate, out, lse, do, rate,
                                                     seed)),
                "plain_ms": median_ms(lambda: torch.autograd.grad(plain, leaves, do,
                                                                  retain_graph=True)),
                "library_ms": median_ms(lambda: torch.autograd.grad(lib, lib_leaves, do,
                                                                    retain_graph=True))},
    }
    bounds = trainable_bound_s(b, h, FRAMES, HEAD_DIM, 2)
    result = []
    for key in ("fwd", "bwd"):
        mem_s, op_s = bounds[key]
        row = {"b": b, "h": h, "t": FRAMES, "d": HEAD_DIM, **rows[key],
               "bound_ms": 1e3 * max(mem_s, op_s),
               "bound_by": "bytes" if mem_s >= op_s else "operations",
               "max_abs_err": errors[key]}
        check(np.isfinite(errors[key]) and errors[key] <= 2e-2 * max(
            plain.float().abs().max().item() if key == "fwd" else
            max(w.float().abs().max().item() for w in want), 1e-6),
            f"K1/K2 {key} at B={b} H={h} disagrees with the plain version: {errors[key]}")
        print(f"{'K1 training' if key == 'fwd' else 'K2'} bf16 B={b} H={h} T={FRAMES} rate {rate}: "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, SDPA "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"max abs err {errors[key]:.3e}")
        result.append(row)
    return result


def head_offset_check(gen) -> None:
    """K1's training instance and K2 on heads 8-15 of a 16-head layer with
    `head_offset=8` (the seed shifted, the CUDA source unchanged) against
    the plain version at that offset, and K1's output against the 16-head
    launch's slice bit for bit (f32, rate 0.1)."""
    (q, k, v, pos, gate), do = trainable_inputs(TP_BATCH, 16, FRAMES, torch.float32, gen)
    full = k1.flash_attention_gated_bias_trainable(q, k, v, pos, gate, DROPOUT_RATE,
                                                   DROPOUT_SEED).detach()
    part = [x[:, 8:].contiguous() for x in (q, k, v)] + [pos[8:].contiguous(),
                                                         gate[:, 8:].contiguous()]
    results = []
    for fn in (k1.flash_attention_gated_bias_trainable, k1.flash_attention_gated_bias_reference):
        leaves = [x.clone().requires_grad_() for x in part]
        o = fn(*leaves, DROPOUT_RATE, DROPOUT_SEED, head_offset=8)
        o.backward(do[:, 8:])
        results.append([o.detach()] + [x.grad for x in leaves])
    rel = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(*results)]
    print(f"head offset 8 of 16 (f32, rate {DROPOUT_RATE}): K1 training + K2 against the plain "
          f"version at the offset, o and five gradients: "
          + ", ".join(f"{e:.2e}" for e in rel) + " of max magnitude; K1 output equal to the "
          f"16-head launch's heads 8-15: {torch.equal(results[0][0], full[:, 8:])}")
    check(max(rel) <= 1e-4, "K1/K2 at a head offset disagree with the plain version")
    check(torch.equal(results[0][0], full[:, 8:]),
          "K1 at head offset 8 is not the slice of the 16-head launch")


def phase_tensor_parallel(card: str) -> dict:
    """WavLM-Large + Conformer 4 x 256 at full width (seeded) on 8 x 8 s:
    the one-process float32 scores and train step (dropout and layer drop
    on) in this process, then two rank processes on cuda:0 in a (1, 2) mesh
    under gloo (NCCL refuses two ranks on one card), started with a timeout
    of their own: their float32 scores within 1e-4 of the largest
    magnitude, the step's loss within 1e-5 relative and gradient norm within
    1e-3, every gathered gradient within 1e-3 of its leaf's largest
    magnitude (a leaf of NULL_GRADIENT, whose gradient is rounding noise,
    within 1e-3 of the largest gradient), and two bf16 steps with K1's
    training instance and K2 launched once per computed attention layer on
    each rank at H 8 and the model group's all-reduces counted. K1's
    training instance and K2 are timed at the ranks' H 8 and the whole
    layer's H 16 (B 8), and checked at a head offset."""
    t_phase = time.perf_counter()
    cfg = tensor_parallel_config()
    sd = random_state_dict(EendModel(cfg), seed=66)
    rng = np.random.default_rng(67)
    batch = {"xs": (0.1 * rng.standard_normal((TP_BATCH, 1, 128000))).astype(np.float32),
             "target": (rng.uniform(size=(TP_BATCH, cfg.num_frames(128000), 4)) > 0.7
                        ).astype(np.uint8)}
    with strict_float32():
        model = EendModel(cfg)
        model.load_state_dict(sd)
        model.cuda()
        with torch.no_grad():
            ref_scores = model(torch.from_numpy(batch["xs"]).cuda(), torch.float32).cpu()
        recorder = GradRecorder(model)
        ref = train_step(TrainState(model=model, optimizer=recorder), batch, seed=TP_SEED,
                         compute_dtype=torch.float32)
        ref_grads = {n: g.cpu() for n, g in recorder.recorded.items()}
        del model, recorder
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(8)
        head_offset_check(gen)
    rows = {h: trainable_rows(TP_BATCH, h, gen) for h in (8, 16)}
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as work:
        torch.save({"cfg": cfg, "sd": sd, "batch": batch}, Path(work) / "inputs.pt")
        del sd
        port = free_local_port()
        code = ("import sys, chip_smoke; sys.exit(chip_smoke.tensor_parallel_rank("
                "int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))")
        t_ranks = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", code, str(rank), str(port), work],
                                  cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
        try:
            errors = [proc.communicate(timeout=TP_TIMEOUT)[1] for proc in procs]
        finally:
            for proc in procs:
                proc.kill()
                proc.wait()
        for rank, (proc, err) in enumerate(zip(procs, errors)):
            check(proc.returncode == 0,
                  f"tensor-parallel rank {rank} failed ({proc.returncode}):\n{err[-6000:]}")
        ranks = [torch.load(Path(work) / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
        ranks_s = time.perf_counter() - t_ranks

    scale = ref_scores.abs().max().item()
    largest = max(g.abs().max().item() for g in ref_grads.values())
    worst = (0.0, "")
    for name, want in ref_grads.items():
        got = ranks[0]["grads"][name]
        check(got.shape == want.shape, f"gathered gradient {name}: {tuple(got.shape)}")
        err = (got - want).abs().max().item()
        bar = 1e-3 * (largest if name.endswith(NULL_GRADIENT) else want.abs().max().item())
        check(np.isfinite(err) and err <= bar,
              f"TP gradient of {name} disagrees with one process: {err} > {bar}")
        if not name.endswith(NULL_GRADIENT):
            worst = max(worst, (err / max(want.abs().max().item(), 1e-30), name))
    heads = [cfg.wavlm.total_num_heads[0] // 2] * 2
    for rank, res in enumerate(ranks):
        f32 = res["f32"]
        score_err = (res["scores"] - ref_scores).abs().max().item()
        print(f"tensor parallel {card} rank {rank} at {res['place']} (H {heads[rank]}): f32 "
              f"scores max abs err {score_err:.3e} of {scale:.3f}; f32 step loss "
              f"{f32['loss']:.7f} vs {ref['loss']:.7f}, grad norm {f32['grad_norm']:.6f} vs "
              f"{ref['grad_norm']:.6f}; K1 {res['k1_forward']} launches in the forward, K1 "
              f"training {f32['k1_train']} and K2 {f32['k2']} in the step of "
              f"{f32['attention_layers']} attention layers; {f32['reduces']} model-group "
              f"all-reduces")
        check(score_err <= 1e-4 * scale, f"rank {rank}: TP f32 scores disagree: {score_err}")
        check(abs(f32["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"]),
              f"rank {rank}: TP f32 loss {f32['loss']} vs {ref['loss']}")
        check(abs(f32["grad_norm"] - ref["grad_norm"]) <= 1e-3 * ref["grad_norm"],
              f"rank {rank}: TP f32 gradient norm {f32['grad_norm']} vs {ref['grad_norm']}")
        check(res["k1_forward"] == cfg.wavlm.num_layers and f32["attention_layers"]
              == ref["attention_layers"] == f32["k1_train"] == f32["k2"] > 0,
              f"rank {rank}: K1/K2 launches {res['k1_forward']}, {f32}")
        for i, step in enumerate(res["bf16"]):
            print(f"  bf16 step {i} {card} rank {rank}: loss {step['loss']:.5f}, grad norm "
                  f"{step['grad_norm']:.4f}, {step['ms']:.1f} ms (collectives staged through "
                  f"the host), K1 training {step['k1_train']}, K2 {step['k2']} of "
                  f"{step['attention_layers']} attention layers, {step['reduces']} model-group "
                  f"all-reduces, peak {step['peak_gib']:.2f} GiB")
            check(np.isfinite(step["loss"]) and not step["skipped"]
                  and step["k1_train"] == step["k2"] == step["attention_layers"] > 0
                  and step["reduces"] > 0, f"rank {rank}: bf16 step {i}: {step}")
            check(step["loss"] == ranks[0]["bf16"][i]["loss"],
                  f"bf16 step {i}: the ranks' losses differ")
    print(f"tensor parallel {card}: gathered gradients, worst {worst[0]:.3e} of the leaf's "
          f"largest magnitude in {worst[1]}; ranks {ranks_s:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    per_rank = {"heads": heads[0], "b": TP_BATCH, "t": FRAMES}
    return {
        "k1": {**per_rank, "launches_per_forward_per_rank": ranks[0]["k1_forward"]},
        "k1_train": {**per_rank, "launches_per_step_per_rank": [
            s["k1_train"] for s in ranks[0]["bf16"]], "h8": rows[8][0], "h16": rows[16][0]},
        "k2": {**per_rank, "launches_per_step_per_rank": [s["k2"] for s in ranks[0]["bf16"]],
               "h8": rows[8][1], "h16": rows[16][1]},
        "reduces_per_step": [s["reduces"] for s in ranks[0]["bf16"]],
    }


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


def kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name, e.g.
    attention_bwd_dq_bf16_kernel<64, 1> (the name is the one that ends in
    "kernel" and follows its own length)."""
    end = mangled.rfind("kernel") + len("kernel")
    name = mangled
    for start in range(end - 1, 0, -1):
        digits = str(end - start)
        if mangled[start - len(digits):start] == digits:
            name = mangled[start:end]
            break
    args = re.match(r"I((?:L[a-z]+\d+E)+)E", mangled[end:])
    if args:
        name += "<" + ", ".join(re.findall(r"L[a-z]+(\d+)E", args.group(1))) + ">"
    return name


def print_ptxas(report: str) -> list:
    """One line per kernel of the compiler's report: registers and spills;
    returns the lines that report wgmma instructions serialised."""
    name, spill = "?", ""
    serialised = [line.strip() for line in report.splitlines()
                  if "wgmma" in line and "serializ" in line]
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            print(f"  ptxas: {name}: {line.split(':', 1)[1].strip()}; {spill}")
        elif "setmaxnreg" in line or "wgmma" in line:
            print(f"  ptxas: {line.strip()}")
    return serialised


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # the evaluation phase's FLAC copies are encoded in worker processes
    # while the kernels build and the earlier phases run
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    with ProcessPoolExecutor(max_workers=STREAM_FILES, mp_context=get_context("spawn")) as pool:
        flac_jobs = [pool.submit(encode_flac_copy, pcm16(make_wave(AUDIO_SECONDS, seed=i)))
                     for i in range(STREAM_FILES)]
        return run_phases(flac_jobs)


def run_phases(flac_jobs) -> int:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {name}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:  # one nvcc per source, side by side
        reports = [f.result() for f in [pool.submit(k1.build), pool.submit(k3.build),
                                        pool.submit(k5.build), pool.submit(resnet_stem.build)]]
    print(f"K1 + K2, K3 + K4, K5 and the ResNet stem build: {time.perf_counter() - t0:.1f} s")
    serialised = print_ptxas("\n".join(reports))
    k2_serialised = [line for line in serialised if "attention_bwd" in line]
    print(f"ptxas: {len(serialised)} wgmma serialisation lines, {len(k2_serialised)} of them K2's")
    check(not k2_serialised, "ptxas serialised the wgmma of a K2 instance")

    eend_cfg = EendConfig(wavlm=WavLMConfig.base_s80_md(), conformer=ConformerConfig())
    heads = [len(h) for h, a in zip(eend_cfg.wavlm.remaining_heads,
                                     eend_cfg.wavlm.use_attention) if a]
    eend_sd = random_state_dict(EendModel(eend_cfg), seed=0)
    resnet_sd = random_state_dict(ResNet(ResNetConfig()), seed=1)
    wave = make_wave(AUDIO_SECONDS)
    with strict_float32():
        kernel = phase_kernel(heads)
        trainable = phase_trainable_kernels()
        schedules = phase_softmax_schedules()
        phase_reference(eend_sd, resnet_sd, eend_cfg, wave)
    elapsed("K1, K2 and the card-against-CPU reference")
    resnet_row = phase_resnet(resnet_sd)
    elapsed("ResNet34")

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
    cuda_build.reset_launches()
    t0 = timer.last = time.perf_counter()
    ann = pipeline(wave, 16000, uri="smoke", hook=timer)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = cuda_build.launch_totals()["k1"]
    serving_instances = path_run("single-file serving", launched())
    record = tracing.records()[-1]
    emb_batches = record.emb_graph_batches + record.emb_eager_batches
    resnet_counts = launch_counts("resnet_conv", "resnet_fold")
    print(f"ResNet34 in the timed call: {resnet_counts['resnet_conv']} fused convolutions over "
          f"{emb_batches} embedding batches ({record.emb_eager_batches} eager), "
          f"{resnet_counts['resnet_fold']} folds")
    check(emb_batches > 0 and record.emb_eager_batches == 0
          and resnet_counts == {"resnet_conv": 36 * emb_batches, "resnet_fold": 0},
          f"expected 36 fused convolutions a replayed batch and no fold: {resnet_counts}")

    num_chunks = sum(seg.num_chunks(wave.shape[1]))
    print("pipeline with PyTorch's float32 defaults: matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    print(f"pipeline {card}: {AUDIO_SECONDS} s of audio in {seconds:.4f} s = "
          f"{AUDIO_SECONDS / seconds:.2f} audio-s/s; {num_chunks} chunks; "
          f"K1 launches {launches}")
    for step, s in timer.seconds.items():
        print(f"  stage {step} {card}: {s:.4f} s")
    check(launches == 50, f"expected 50 K1 launches (5 batches x 10 layers), got {launches}")
    check(serving_instances == {"fwd_deferred": 50},
          f"serving must run the deferred schedule: {serving_instances}")
    rttm = ann.to_rttm().splitlines()
    check(len(rttm) > 0 and "embeddings" in timer.seconds, "no speech found: embeddings did not run")
    for line in rttm:
        parts = line.split()
        check(len(parts) == 10 and parts[0] == "SPEAKER" and parts[1] == "smoke"
              and float(parts[3]) >= 0 and float(parts[4]) > 0, f"bad RTTM line {line!r}")
    print(f"RTTM: {len(rttm)} segments, speakers {ann.labels()}")

    phase_profile("one pipeline call", lambda: pipeline(wave, 16000, uri="profile"))
    elapsed("single-file serving")

    with strict_float32():
        phase_train_reference()
    train_launches = phase_training(card)
    elapsed("training")

    with strict_float32():
        fused_ln = phase_fused_ln()
        phase_fused_ln_model(eend_sd, eend_cfg, wave)
    stream_launches = phase_stream(card, model, eend_cfg, pipeline)
    elapsed("K3, K4 and streamed serving")
    del model, resnet, seg, emb, pipeline
    torch.cuda.empty_cache()

    with strict_float32():
        conv_chain = phase_conv_chain()
    elapsed("K5")
    snapshot_launches = phase_snapshots(card, resnet_sd)
    elapsed("snapshot directories to RTTM")
    conv_chain["launches"] = snapshot_launches["k5"]
    evaluation_launches = phase_evaluation(card, resnet_sd, flac_jobs)
    elapsed("scoring and the frame-level modes")
    pruning = phase_pruning(card)
    elapsed("fine-tune, distill-prune and collapse")
    multichannel = phase_multichannel(card, resnet_sd)
    families = phase_families(card, resnet_sd, flac_jobs)
    elapsed("the remaining families")
    hf_launches = phase_hf_import(card)
    phase_schedules(card)
    data_parallel = phase_data_parallel(card, eend_sd, resnet_sd, eend_cfg, wave)
    elapsed("HF import, schedules and data parallelism")
    tensor_parallel = phase_tensor_parallel(card)
    elapsed("tensor parallelism")

    kernel["launches"] = launches
    kernel["instance"] = "fwd_deferred"
    kernel["whole_t1499"]["launches"] = evaluation_launches["whole"]
    kernel["recipe_launches"] = evaluation_launches["recipe"]
    kernel["pruned"] = pruning["pruned"]  # the collapsed model's forward, B 16
    trainable[0]["launches"] = train_launches["train"]
    trainable[1]["launches"] = train_launches["bwd"]
    trainable[0]["instance"], trainable[1]["instance"] = "train", "bwd"
    # K1's f32 and bf16 inference schedules (f32: validation and the distill
    # teacher; bf16 runs only where a caller sets it) at the `base` shape and
    # `whole` (B 16, T 1499), and the rate-0 instances (the distill student)
    source = {"route": "cuda", "source": "diarizen_tpu_torch/csrc/gated_bias_attention.cu"}
    instances = []
    for mode in ("f32", "bf16"):
        rows = {(b, t): row for (m, b, t), row in schedules["inference"].items() if m == mode}
        instances.append({"name": f"gated_bias_attention_{mode}", **source,
                          "replaces": "diarizen_tpu/ops/flash_attention.py:201",
                          **rows[(BATCH, FRAMES)], **path_launches(f"fwd_{mode}"),
                          "whole_t1499_b16": rows[(16, WHOLE_FRAMES)],
                          "distill_launches_per_step":
                              pruning["distill_step"].get(f"fwd_{mode}", 0)})
    for instance, row, replaces in zip(
            ("train_rate0", "bwd_rate0"), pruning["rate0"],
            ("diarizen_tpu/ops/flash_attention.py:201", "diarizen_tpu/ops/flash_attention.py:326")):
        instances.append({"name": "gated_bias_attention_" + instance, **source,
                          "replaces": replaces, "instance": instance, **row,
                          **path_launches(instance),
                          "launches_per_distill_step": pruning["distill_step"].get(instance, 0)})
    # the training forward at rate 0 beside the deferred schedule's with lse
    instances[2]["deferred_ms"] = schedules["train"][0.0]["deferred_ms"]
    # the multi-channel recipe: K1 at B 16 x 8 streams (layers 0-3) with its
    # launches a file; K1 training and K2 launches a step at each k, K2 at 8 k
    kernel["multichannel"] = multichannel["k1"]
    trainable[0]["multichannel"] = multichannel["k1_train"]
    trainable[1]["multichannel"] = multichannel["k2"]
    fused_ln[0]["launches"] = stream_launches["k3"]
    fused_ln[1]["launches"] = stream_launches["k4"]
    # SSeRiouSS on WavLM-Base, one batch of 32 x 8 s: K1, K3, K4 and K5 at the
    # `base` shapes timed above; K1's training instance alone, K2 never
    sserious = families["sserious"]
    kernel["sserious_launches_per_batch"] = sserious["eval"]["k1"]
    fused_ln[0]["sserious_launches_per_batch"] = sserious["eval"]["k3"]
    fused_ln[1]["sserious_launches_per_batch"] = sserious["eval"]["k4"]
    conv_chain["sserious_launches_per_batch"] = sserious["eval"]["k5"]
    trainable[0]["sserious_forward_only"] = sserious["k1_train"]
    trainable[1]["sserious_launches_per_step"] = sserious["train"]["k2"]
    # the HF-imported WavLM-Base's bf16 forward; the train step in a group
    kernel["hf_import_launches_per_forward"] = hf_launches
    trainable[0]["data_parallel_launches_per_step"] = data_parallel["k1_train"]
    trainable[1]["data_parallel_launches_per_step"] = data_parallel["k2"]
    # WavLM-Large on a (1, 2) model axis: each rank's 8 heads of 16, B 8
    kernel["tensor_parallel"] = tensor_parallel["k1"]
    trainable[0]["tensor_parallel"] = tensor_parallel["k1_train"]
    trainable[1]["tensor_parallel"] = tensor_parallel["k2"]
    print(json.dumps({"kernels": [kernel, *instances[:2], *trainable, *instances[2:], *fused_ln,
                                  conv_chain, resnet_row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
