"""Traffic of whole audio files through `DiarizationPipeline.stream`, in a
closed loop: one caller streams a cycled pool of files and takes each
Annotation as it comes, the way an eval set or a labelling job is scored.

The workload file's `traffic` gives the pool: how many files, their lengths
(`uniform` or `loguniform` between `min_s` and `max_s`), speakers per file,
turn lengths and how far the next turn starts into the last (`advance`,
below 1 overlaps). Every seed gets the same files by length and speaker
count, each length with a fixed count, in an order drawn from the seed,
and its own audio: speech-like
tones (a pitch and three harmonics a speaker, syllable-rate amplitude
modulation) with noise, PCM16-quantised, made on the device.

`run` is the cell: set-up (the pipeline through `pipelines.from_pretrained`
from a set-up directory, seeded weights, the pool, a warm-up over every
batch shape), the measured window, the traced slice when asked, and the
comparison that decides `correct`.
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

from portbench import core
from portbench.flops import file_flops
from portbench.reference.judge import NUMBERS, Layout, judge_file
from portbench.weights import make_weights

SPANS = ("dispatch", "finish", "cluster")


def pool_sizes(traffic: dict) -> tuple:
    """(seconds, speakers) of every file of the pool: the distribution's
    quantiles at (i + 0.5) / n, and speaker counts cycling over the range."""
    n, lo, hi = traffic["files"], traffic["min_s"], traffic["max_s"]
    q = (np.arange(n) + 0.5) / n
    if traffic["lengths"] == "uniform":
        seconds = lo + q * (hi - lo)
    elif traffic["lengths"] == "loguniform":
        seconds = np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
    else:
        raise ValueError(f"unknown length distribution {traffic['lengths']!r}")
    s_lo, s_hi = traffic["speakers"]
    speakers = s_lo + np.arange(n) % (s_hi - s_lo + 1)
    return np.round(seconds, 2), speakers


def synthesize(seconds: float, speakers: int, traffic: dict, rng: np.random.Generator,
               gen: torch.Generator, device, turns_out: list = None) -> np.ndarray:
    """One file: turns drawn on the host, the audio made on the device;
    `turns_out` receives (speaker, first sample, end sample) of each turn."""
    sr = traffic["sample_rate"]
    n = int(round(seconds * sr))
    turns, pos, last = [], 0.5, -1
    while pos < seconds - 1.0:
        choices = [s for s in range(speakers) if s != last] or [0]
        spk = int(rng.choice(choices))
        seg = float(rng.uniform(*traffic["turn_s"]))
        turns.append((spk, int(pos * sr), int(min(pos + seg, seconds - 0.5) * sr)))
        pos += seg * float(rng.uniform(*traffic["advance"]))
        last = spk
    edges = torch.zeros((speakers, n + 1), device=device)
    for spk, a, b in turns:
        edges[spk, a] += 1.0
        edges[spk, b] -= 1.0
    active = (torch.cumsum(edges, dim=1)[:, :n] > 0).float()
    t = torch.arange(n, device=device, dtype=torch.float64) / sr
    wave = 0.01 * torch.randn(n, generator=gen, device=device)
    for spk in range(speakers):
        f0 = 100.0 + 45.0 * spk + float(rng.uniform(0.0, 20.0))
        phase = float(rng.uniform(0.0, 2 * np.pi))
        voice = sum(a * torch.sin(2 * np.pi * h * f0 * t) for h, a in ((1, 1.0), (2, 0.5), (3, 0.25)))
        envelope = 0.6 + 0.4 * torch.sin(2 * np.pi * 4.0 * t + phase)
        wave += (0.12 * active[spk] * (voice * envelope)).float()
    pcm = torch.clamp(torch.round(wave * 32767.0), -32768, 32767) / 32768.0
    if turns_out is not None:
        turns_out.extend(turns)
    return pcm.float().cpu().numpy()


def make_pool(traffic: dict, seed: int, device) -> list:
    """[{"wave", "seconds", "speakers"}] in the order the loop serves them.
    Only the order and the audio follow the seed: a length keeps its speaker
    count, so that every seed's pool is the same work."""
    seconds, speakers = pool_sizes(traffic)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(seconds))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**62)
    pool = []
    for i in order:
        wave = synthesize(float(seconds[i]), int(speakers[i]), traffic, rng, gen, device)
        pool.append({"wave": wave, "seconds": len(wave) / traffic["sample_rate"],
                     "speakers": int(speakers[i])})
    return pool


def write_setup_dir(root: Path, config_name: str, seed: int) -> Path:
    """The directory `from_pretrained` reads: the configuration's
    config.toml and a seeded PLDA at the ResNet34's 256 -> 128 dimensions."""
    (root / "plda").mkdir(parents=True)
    shutil.copyfile(core.BENCH / "configs" / f"{config_name}.toml", root / "config.toml")
    rng = np.random.default_rng(seed % 2**63)
    np.savez(root / "plda" / "xvec_transform.npz", mean1=0.1 * rng.standard_normal(256),
             mean2=0.1 * rng.standard_normal(128), lda=rng.standard_normal((256, 128)) / 16.0)
    tr = rng.standard_normal((128, 128)) / 12.0 + np.eye(128)
    psi = np.sort(rng.uniform(0.5, 5.0, size=128))[::-1]
    np.savez(root / "plda" / "plda.npz", mu=0.1 * rng.standard_normal(128), tr=tr, psi=psi)
    return root


class TimedClustering:
    """The pipeline's clustering, timed on the host clock per call."""

    def __init__(self, inner, span: bool):
        self.inner, self.span, self.calls = inner, span, []

    def __call__(self, *args, **kwargs):
        t = time.perf_counter()
        if self.span:
            with torch.profiler.record_function("cluster"):
                out = self.inner(*args, **kwargs)
        else:
            out = self.inner(*args, **kwargs)
        now = time.perf_counter()
        self.calls.append((now, now - t))
        return out


class Outputs:
    """The pipeline's stage hook: what it hands back for the file it is
    finishing, kept for the comparison once the window has closed."""

    def __init__(self):
        self.current = {}

    def __call__(self, step, artifact, total=None, completed=None):
        if artifact is None:  # progress of a batch
            return
        if step == "segmentation":
            self.current["binary"] = artifact.data
        elif step == "speaker_counting":
            self.current["count"] = np.array(artifact.data).reshape(-1)
        elif step == "embeddings":
            self.current["embeddings"] = artifact
        elif step == "clustering":
            self.current["clusters"] = np.array(artifact)  # the pipeline marks it after

    def take(self) -> dict:
        out, self.current = self.current, {}
        return out


def build_pipeline(cfg: dict, config_name: str, seed: int, device, setup_root: Path, trace: bool):
    from diarizen_tpu_torch import pipelines

    setup = write_setup_dir(setup_root, config_name, cfg["weights"].get("seed", seed))
    pipe = pipelines.from_pretrained(setup, device=device)
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
    """One run of a serving cell. Returns (measured, checks, extra): the
    values it can give by metric name, the compared numbers with their
    limits, and what the result line needs besides."""
    traffic = workload["traffic"]
    layout = Layout(cfg)
    arch = cfg["architecture"]
    speakers = arch["eend"]["max_speakers_per_chunk"]  # local speakers embedded a window
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

        outputs, pulls, done = Outputs(), [], []

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
                    file_flops(arch, len(layout.starts(len(d["item"]["wave"]))),
                               len(d["item"]["wave"]), layout.window, speakers)
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


def sample(done: list, count: int, seed: int) -> list:
    """Indices of the files the comparison reads: the longest served, and
    the rest drawn from the seed."""
    longest = max(range(len(done)), key=lambda j: done[j]["item"]["seconds"])
    rest = [j for j in range(len(done)) if j != longest]
    rng = np.random.default_rng((seed ^ 0x5EED) % 2**63)
    picked = rng.choice(len(rest), size=min(count - 1, len(rest)), replace=False)
    return [longest] + sorted(rest[int(i)] for i in picked)


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
