"""Traffic of whole multi-microphone recordings through
`DiarizationPipeline.stream`, in a closed loop: one caller streams a cycled
pool of (C, samples) files and takes each Annotation as it comes, the way a
far-field eval set (AMI-MDM, AISHELL-4, AliMeeting, NOTSOFAR-1) is scored
from all of its channels at once.

The workload file's `traffic` gives the pool as `files.py` reads it (how
many files, their lengths, speakers a file, turn lengths, how far the next
turn starts into the last), and the array: `microphones`, each (speaker,
microphone) pair's `delay_samples` and `gain` ranges, and each microphone's
`noise`. Every seed gets the same files by length, speaker count and
microphones, in an order drawn from the seed, and its own audio and room:
`files.synthesize`'s turns and voices, each speaker's track delayed and
scaled into every microphone, noise a microphone, PCM16-quantised, made on
the device.

`run` is the cell, as `files.run` is for mono files: set-up (the pipeline
through `pipelines.from_pretrained` from a set-up directory, seeded weights,
the pool, a warm-up over every batch shape), the measured window, the traced
slice when asked, and the comparison that decides `correct`
(`reference/mc_judge.py`). A program that cannot serve the configuration's
microphones stops in set-up, before the pool is made.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from portbench import core
from portbench.flops_mc import mc_file_flops
from portbench.reference.embedding import param_specs as embedding_specs
from portbench.reference.judge import Layout
from portbench.reference.mc import param_specs as mc_specs
from portbench.reference.mc_judge import NUMBERS, judge_file
from portbench.traffic.files import (
    SPANS,
    Outputs,
    TimedClustering,
    pool_sizes,
    sample,
    write_setup_dir,
)
from portbench.weights import _draw


def synthesize(seconds: float, speakers: int, traffic: dict, rng: np.random.Generator,
               gen: torch.Generator, device) -> np.ndarray:
    """One (microphones, samples) file: turns and voices drawn as
    `files.synthesize` draws them, each speaker's track delayed and scaled
    into each microphone by the pair's own delay and gain, and each
    microphone's own noise."""
    sr, mics = traffic["sample_rate"], traffic["microphones"]
    n = int(round(seconds * sr))
    turns, pos, last = [], 0.5, -1
    while pos < seconds - 1.0:
        choices = [s for s in range(speakers) if s != last] or [0]
        spk = int(rng.choice(choices))
        seg = float(rng.uniform(*traffic["turn_s"]))
        turns.append((spk, int(pos * sr), int(min(pos + seg, seconds - 0.5) * sr)))
        pos += seg * float(rng.uniform(*traffic["advance"]))
        last = spk
    delays = rng.integers(traffic["delay_samples"][0], traffic["delay_samples"][1] + 1,
                          size=(speakers, mics))
    gains = rng.uniform(*traffic["gain"], size=(speakers, mics))
    edges = torch.zeros((speakers, n + 1), device=device)
    for spk, a, b in turns:
        edges[spk, a] += 1.0
        edges[spk, b] -= 1.0
    active = (torch.cumsum(edges, dim=1)[:, :n] > 0).float()
    t = torch.arange(n, device=device, dtype=torch.float64) / sr
    wave = traffic["noise"] * torch.randn((mics, n), generator=gen, device=device)
    for spk in range(speakers):
        f0 = 100.0 + 45.0 * spk + float(rng.uniform(0.0, 20.0))
        phase = float(rng.uniform(0.0, 2 * np.pi))
        voice = sum(a * torch.sin(2 * np.pi * h * f0 * t)
                    for h, a in ((1, 1.0), (2, 0.5), (3, 0.25)))
        envelope = 0.6 + 0.4 * torch.sin(2 * np.pi * 4.0 * t + phase)
        track = (0.12 * active[spk] * (voice * envelope)).float()
        for m in range(mics):
            wave[m] += float(gains[spk, m]) * F.pad(track, (int(delays[spk, m]), 0))[:n]
    pcm = torch.clamp(torch.round(wave * 32767.0), -32768, 32767) / 32768.0
    return pcm.float().cpu().numpy()


def make_pool(traffic: dict, seed: int, device) -> list:
    """[{"wave", "seconds", "speakers"}] in the order the loop serves them.
    Only the order, the audio and the room follow the seed: a length keeps
    its speaker count, every file its microphones."""
    seconds, speakers = pool_sizes(traffic)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(seconds))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**62)
    pool = []
    for i in order:
        wave = synthesize(float(seconds[i]), int(speakers[i]), traffic, rng, gen, device)
        pool.append({"wave": wave, "seconds": wave.shape[1] / traffic["sample_rate"],
                     "speakers": int(speakers[i])})
    return pool


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{"segmentation", "embedding"} state dicts of the multi-channel model
    and the ResNet34, drawn as `weights.make_weights` draws a configuration's
    over the plain reference's specs (the fusions' included), from the
    configuration's `[weights] seed` where it gives one."""
    arch, scale = cfg["architecture"], float(cfg["weights"]["classifier_scale"])
    seed = cfg["weights"].get("seed", seed)
    return {"segmentation": _draw(mc_specs(arch), seed % 2**62, device, scale),
            "embedding": _draw(embedding_specs(arch), (seed + 1) % 2**62, device, 1.0)}


class McOutputs(Outputs):
    """`files.Outputs`, and the windows' channel weights the pipeline hands
    back for the file it is finishing."""

    def __call__(self, step, artifact, total=None, completed=None):
        if step == "channel_weights" and artifact is not None:
            self.current["channel_weights"] = np.array(artifact)
        else:
            super().__call__(step, artifact, total, completed)


def build_pipeline(cfg: dict, config_name: str, seed: int, device, setup_root: Path,
                   trace: bool):
    from diarizen_tpu_torch import pipelines

    setup = write_setup_dir(setup_root, config_name, cfg["weights"].get("seed", seed))
    pipe = pipelines.from_pretrained(setup, device=device)
    channels = cfg["architecture"]["channels"]
    served = getattr(pipe.seg_inference, "num_channels", None)
    if served != channels:
        core.fail(f"the program's pipeline serves {served or 1} channel(s) of this "
                  f"configuration's {channels}: no multi-channel serving path")
    weights = make_weights(cfg, seed, device)
    pipe.seg_inference.model.load_state_dict(weights["segmentation"], strict=True)
    pipe.emb_inference.model.load_state_dict(weights["embedding"], strict=True)
    clustering = TimedClustering(pipe.clustering, span=trace)
    pipe = dataclasses.replace(pipe, clustering=clustering)
    if trace:
        pipe._dispatch_file = core.spanned("dispatch", pipe._dispatch_file)
        pipe._finish_file = core.spanned("finish", pipe._finish_file)
    return pipe, clustering, weights, setup


def run(cell: str, workload: dict, cfg: dict, seed: int, seconds: float, trace: bool,
        device, started: float, tmp_root: Path) -> tuple:
    """One run of the multi-channel serving cell. Returns (measured, checks,
    extra) as `files.run` does."""
    traffic = workload["traffic"]
    layout = Layout(cfg)
    arch = cfg["architecture"]
    speakers = arch["eend"]["max_speakers_per_chunk"]  # local speakers embedded a window
    channels = arch["channels"]
    setup_root = Path(tempfile.mkdtemp(prefix="portbench-", dir=tmp_root))
    try:
        pipe, clustering, weights, setup = build_pipeline(cfg, workload["config"], seed, device,
                                                          setup_root / "model", trace)
        pool = make_pool(traffic, seed, device)
        warm_traffic = {**traffic, "files": 1}
        warm_rng, warm_gen = np.random.default_rng(0), torch.Generator(device=device)
        warm_gen.manual_seed(0)
        # one file for each shape of a partial last batch (`warm_chunks` windows)
        warm = [synthesize(layout.duration + (c - 1) * layout.step, 2, warm_traffic, warm_rng,
                           warm_gen, device) for c in workload["warm_chunks"]]
        for _ in pipe.stream(warm):
            pass
        core.synchronize(device)
        clustering.calls.clear()
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()

        outputs, pulls, done = McOutputs(), [], []

        def feed():
            for k in itertools.count():
                item = pool[k % len(pool)]
                pulls.append((item, time.perf_counter()))
                yield item["wave"]

        phase, prof, slice_span, untraced = "untraced", None, None, None
        stream = pipe.stream(feed(), hook=outputs)
        for j, _ in enumerate(stream):
            now = time.perf_counter()
            item, pulled = pulls[j]
            done.append({"item": item, "latency": now - pulled, "done": now,
                         "outputs": outputs.take()})
            elapsed = now - pulls[0][1]
            if not trace:
                if elapsed >= seconds:
                    break
            elif phase == "untraced" and elapsed >= seconds * workload["untraced_share"]:
                untraced = {"seconds": elapsed, "files": j + 1}
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                phase = "warm"  # the first file under the profiler is not read
            elif phase == "warm":
                slice_span = torch.profiler.record_function(core.SLICE)
                slice_span.__enter__()
                phase, slice_start = "slice", j
            elif phase == "slice" and j - slice_start >= workload["trace_files"]:
                slice_span.__exit__(None, None, None)
                break
        stream.close()
        window_s = done[-1]["done"] - pulls[0][1]
        setup_s = pulls[0][1] - started
        core.synchronize(device)
        events = None
        if prof is not None:
            prof.__exit__(None, None, None)
            events = core.trace_events(prof, setup_root)
        memory = (torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda"
                  else 0)
        del pipe, stream, prof
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

        audio = sum(d["item"]["seconds"] for d in done)
        measured = {"setup_s": setup_s, "audio_s_per_s": audio / window_s}
        context = None
        if trace:
            first = untraced["files"]
            context = {
                "config": cfg, "workload": workload, "peaks": core.peaks(), "layout": layout,
                "trace": core.Trace(events, SPANS),
                "untraced_seconds": untraced["seconds"],
                "untraced_flops": sum(
                    mc_file_flops(arch, len(layout.starts(d["item"]["wave"].shape[1])),
                                  d["item"]["wave"].shape[1], layout.window, speakers, channels)
                    for d in done[:first]),
                "cluster_ms": [1e3 * dt for t, dt in clustering.calls
                               if t <= done[first - 1]["done"]],
                "files": first,
                "latencies": [d["latency"] for d in done[:first]],
            }
        checks, failed = compare(workload, cfg, layout, weights, done, seed, setup, device)
        return measured, checks, {"attempted": len(done), "failed": failed,
                                  "memory_peak_bytes": memory, "context": context}
    finally:
        shutil.rmtree(setup_root, ignore_errors=True)


def compare(workload, cfg, layout, weights, done, seed, setup, device) -> tuple:
    """Worst of each number over the sampled files, beside its limit; and
    how many of those files broke a limit."""
    limits = workload["limits"]
    worst = dict.fromkeys(NUMBERS, 0.0)
    failed = 0
    for j in sample(done, workload["check_files"], seed):
        numbers = judge_file(layout, cfg, weights, done[j]["item"]["wave"], done[j]["outputs"],
                             str(setup / "plda"), device)
        failed += any(numbers[k] > limits[k] for k in NUMBERS)
        for k in NUMBERS:
            worst[k] = max(worst[k], numbers[k])
    return {k: {"value": worst[k], "limit": limits[k]} for k in NUMBERS}, failed
