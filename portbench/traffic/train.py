"""Fine-tuning steps through `Trainer.train_epoch`, epoch after epoch over a
synthetic Kaldi directory, until the window closes at a step boundary.

The workload file's `traffic` gives the data: `recordings` of `seconds`
each, speakers per recording cycling over a range (paired by the seed),
turns and overlaps as for served files (`files.synthesize`), written as
PCM16 WAV files with their RTTM and UEM under the run's temporary
directory. The loader shuffles with the run's seed.

`run` is the cell: set-up builds the Trainer (the recipe's model and
optimizer, seeded weights) and drives it through its first three steps by
the window's own call and feed, keeping what the comparison needs; the
window then goes on with the same Trainer; the comparison runs the plain
reference over the same three batches from the same weights.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
import wave as wavefile
from pathlib import Path

import numpy as np
import torch

from portbench import core
from portbench.flops import train_step_flops
from portbench.reference.segmentation import num_frames
from portbench.reference.training import BETAS, reference_steps
from portbench.traffic.files import synthesize
from portbench.weights import make_weights

SPANS = ("loader", "step")
CHECKED_STEPS = 3


def write_kaldi(root: Path, traffic: dict, seed: int, device) -> Path:
    """wav.scp, rttm and all.uem of `recordings` synthetic recordings."""
    root.mkdir(parents=True)
    sr, n = traffic["sample_rate"], traffic["recordings"]
    s_lo, s_hi = traffic["speakers"]
    speakers = (s_lo + np.arange(n) % (s_hi - s_lo + 1))
    rng = np.random.default_rng(seed % 2**63)
    speakers = speakers[rng.permutation(n)]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**62)
    scp, rttm, uem = [], [], []
    for r in range(n):
        rec, turns = f"rec{r}", []
        audio = synthesize(float(traffic["seconds"]), int(speakers[r]), traffic, rng, gen, device,
                           turns)
        path = root / f"{rec}.wav"
        with wavefile.open(str(path), "wb") as fh:
            fh.setnchannels(1)
            fh.setsampwidth(2)
            fh.setframerate(sr)
            fh.writeframes(np.round(audio * 32768.0).astype("<i2").tobytes())
        scp.append(f"{rec} {path}")
        for spk, a, b in turns:
            rttm.append(f"SPEAKER {rec} 1 {a / sr:.3f} {(b - a) / sr:.3f} <NA> <NA> spk{spk} "
                        "<NA> <NA>")
        uem.append(f"{rec} 1 0.00 {len(audio) / sr:.2f}")
    for name, lines in (("wav.scp", scp), ("rttm", rttm), ("all.uem", uem)):
        (root / name).write_text("\n".join(lines) + "\n")
    return root


class Feed:
    """The batches, epoch after epoch, with the host's wait for each timed
    and, while `keep` is set, each batch kept. `session(go)` yields until
    `go()` says stop; it is asked before each batch, after the last step."""

    def __init__(self, loader, trace: bool):
        self.loader, self.trace = loader, trace
        self.epoch, self.it = 0, None
        self.waits, self.kept, self.keep = [], [], False

    def _next(self):
        while True:
            if self.it is None:
                self.loader.set_epoch(self.epoch)
                self.it = iter(self.loader)
            try:
                return next(self.it)
            except StopIteration:
                self.it, self.epoch = None, self.epoch + 1

    def session(self, go):
        while go():
            t = time.perf_counter()
            if self.trace:
                with torch.profiler.record_function("loader"):
                    batch = self._next()
            else:
                batch = self._next()
            now = time.perf_counter()
            self.waits.append((now, now - t))
            if self.keep:
                self.kept.append({"xs": batch["xs"].copy(), "target": batch["target"].copy()})
            yield batch


class Steps:
    """The Trainer's step hook: each step's end time and metrics, and the
    optimizer's first moments after the first step."""

    def __init__(self):
        self.steps, self.trainer, self.first_moments = [], None, None

    def __call__(self, metrics):
        self.steps.append((time.perf_counter(), metrics))
        if len(self.steps) == 1:
            mu = self.trainer.state.optimizer.state["mu"]
            self.first_moments = {n: t.detach().clone() for n, t in mu.items()}


def build(cfg: dict, seed: int, device, data: Path, exp: Path, trace: bool):
    from diarizen_tpu_torch.models.build import wavlm_conformer
    from diarizen_tpu_torch.train import Trainer, TrainerConfig, dual_lr_optimizer
    from diarizen_tpu_torch.train.dataset import DataLoader, DiarizationDataset

    tr = cfg["train"]
    eend_cfg, model = wavlm_conformer(**cfg["model"]["args"])
    model.load_state_dict(make_weights(cfg, seed, device)["segmentation"], strict=True)
    step_s, duration_s = eend_cfg.rf_info()
    sr = cfg["architecture"]["eend"]["sample_rate"]
    dataset = DiarizationDataset(
        str(data / "wav.scp"), str(data / "rttm"), str(data / "all.uem"),
        model_num_frames=eend_cfg.num_frames(int(tr["chunk_size"] * sr)),
        model_rf_duration=duration_s, model_rf_step=step_s, chunk_size=tr["chunk_size"],
        chunk_shift=tr["chunk_shift"], sample_rate=sr)
    loader = DataLoader(dataset, batch_size=tr["batch_size"], shuffle=True, seed=seed % 2**62)
    optimizer = dual_lr_optimizer(model.param_groups(), lr_small=tr["lr_wavlm"],
                                  lr_big=tr["lr_other"], weight_decay=tr["weight_decay"],
                                  clip_percentile=tr["clip_percentile"])
    steps = Steps()
    trainer = Trainer(model, TrainerConfig(exp_dir=str(exp), compute_dtype=tr["compute_dtype"],
                                           seed=tr["seed"], log_every=10**9),
                      optimizer, device=device, step_hook=steps)
    steps.trainer = trainer
    if trace:
        trainer.train_step_fn = core.spanned("step", trainer.train_step_fn)
    return trainer, Feed(loader, trace), steps


def run(cell: str, workload: dict, cfg: dict, seed: int, seconds: float, trace: bool,
        device, started: float, tmp_root: Path) -> tuple:
    """One run of a training cell: (measured, checks, extra) as `files.run`."""
    arch, tr = cfg["architecture"], cfg["train"]
    root = Path(tempfile.mkdtemp(prefix="portbench-", dir=tmp_root))
    try:
        data = write_kaldi(root / "data", workload["traffic"], seed, device)
        trainer, feed, steps = build(cfg, seed, device, data, root / "exp", trace)
        before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}

        # set-up: the first steps through the window's own call and feed
        feed.keep = True
        trainer.train_epoch(feed.session(lambda: len(steps.steps) < CHECKED_STEPS), 0)
        feed.keep = False
        after = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        losses = [m["loss"] for _, m in steps.steps[:CHECKED_STEPS]]
        core.synchronize(device)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()

        state = {"phase": "untraced", "prof": None, "span": None, "untraced": None}
        first = len(steps.steps)
        t0 = time.perf_counter()

        def go() -> bool:
            now, done = time.perf_counter(), len(steps.steps) - first
            if not trace:
                return now - t0 < seconds
            if state["phase"] == "untraced" and now - t0 >= seconds * workload["untraced_share"]:
                state["untraced"] = (now - t0, done)
                state["prof"] = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                state["prof"].__enter__()
                state["phase"], state["mark"] = "warm", done
            elif state["phase"] == "warm" and done > state["mark"]:
                state["span"] = torch.profiler.record_function(core.SLICE)
                state["span"].__enter__()
                state["phase"], state["mark"] = "slice", done
            elif state["phase"] == "slice" and done - state["mark"] >= workload["trace_steps"]:
                state["span"].__exit__(None, None, None)
                return False
            return True

        epoch = 1
        while go():
            trainer.train_epoch(feed.session(go), epoch)
            epoch += 1
        window_s = time.perf_counter() - t0
        window_steps = len(steps.steps) - first
        core.synchronize(device)
        events = None
        if state["prof"] is not None:
            state["prof"].__exit__(None, None, None)
            events = core.trace_events(state["prof"], root)
        memory = (torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda"
                  else 0)
        first_grads = {n: mu / (1.0 - BETAS[0]) for n, mu in steps.first_moments.items()}
        batches, waits = feed.kept[:CHECKED_STEPS], feed.waits
        del trainer, feed
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

        measured = {"setup_s": t0 - started, "train_step_ms": 1e3 * window_s / window_steps}
        context = None
        if trace:
            untraced_s, untraced_steps = state["untraced"]
            samples = int(tr["chunk_size"] * arch["eend"]["sample_rate"])
            attention = [i for i, on in enumerate(arch["wavlm"]["use_attention"]) if on]
            context = {
                "config": cfg, "workload": workload, "peaks": core.peaks(),
                "trace": core.Trace(events, SPANS),
                "untraced_seconds": untraced_s, "steps": untraced_steps,
                # the layers a step computed, by count: WavLM-Base's layers are alike
                "untraced_flops": sum(
                    train_step_flops(arch, tr["batch_size"], samples,
                                     attention[:m["attention_layers"]])
                    for _, m in steps.steps[first:first + untraced_steps]),
                "data_wait_ms": [1e3 * w for t, w in waits[first:first + untraced_steps]],
                "batch": tr["batch_size"],
                "frames": num_frames(arch, samples),
            }
        checks, failed = compare(workload, cfg, device, before, after, first_grads, losses,
                                 batches)
        return measured, checks, {"attempted": window_steps, "failed": failed,
                                  "memory_peak_bytes": memory, "context": context}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def leaf_gaps(got: dict, want: dict, counted: list) -> list:
    """Each counted leaf's gap between the two sides' norms, against the
    larger of the reference's norm of that leaf and of the median leaf."""
    norms = {n: float(want[n].double().norm()) for n in counted}
    median = float(np.median(list(norms.values())))
    return [abs((float(got[n].double().norm()) if n in got else 0.0) - norms[n])
            / max(norms[n], median) for n in counted]


def gaps(before: dict, losses: list, first_grads: dict, after: dict, ref: dict) -> dict:
    """The numbers of one side against the reference `ref`. Leaves whose
    reference gradient is under a thousandth of the median leaf's (nought to
    rounding, as a key's bias under softmax) are left out."""
    grad_norms = {n: float(g.double().norm()) for n, g in ref["first_grads"].items()}
    median = float(np.median(list(grad_norms.values())))
    counted = [n for n, v in grad_norms.items() if v >= 1e-3 * median]
    grad = leaf_gaps(first_grads, ref["first_grads"], counted)
    change = leaf_gaps({n: after[n] - before[n] for n in counted},
                       {n: ref["params"][n] - before[n] for n in counted}, counted)
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    return {"first_loss_gap": loss[0], "loss_gap": max(loss),
            "grad_gap": max(grad), "grad_median_gap": float(np.median(grad)),
            "change_gap": max(change), "change_median_gap": float(np.median(change))}


def compare(workload, cfg, device, before, after, first_grads, losses, batches) -> tuple:
    """The three numbers beside their limits: each step's loss, the first
    step's gradient by leaf (from the optimizer's first moments), and each
    leaf's change over the steps, against the reference from the same
    weights over the same batches."""
    limits = workload["limits"]
    ref = reference_steps(cfg["architecture"], cfg["train"], before, batches, cfg["train"]["seed"],
                          device)
    numbers = gaps(before, losses, first_grads, after, ref)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return checks, int(any(numbers[k] > limits[k] for k in limits))


def control_readings(workload: dict, seed: int, device, tmp_root: Path,
                     fault: str = "control") -> dict:
    """The numbers of the reference put in the program's place, over the
    cell's first batches from the cell's weights: "control" computes its
    products in float8 (the configuration states bf16); "half_batch" leaves
    half of each batch out and takes the mean over the rest."""
    from diarizen_tpu_torch.models.build import wavlm_conformer
    from diarizen_tpu_torch.train.dataset import DataLoader, DiarizationDataset

    cfg = core.load_config(workload["config"])
    arch, tr = cfg["architecture"], cfg["train"]
    root = Path(tempfile.mkdtemp(prefix="portbench-control-", dir=tmp_root))
    try:
        data = write_kaldi(root / "data", workload["traffic"], seed, device)
        eend_cfg, _ = wavlm_conformer(**cfg["model"]["args"])
        step_s, duration_s = eend_cfg.rf_info()
        sr = arch["eend"]["sample_rate"]
        dataset = DiarizationDataset(
            str(data / "wav.scp"), str(data / "rttm"), str(data / "all.uem"),
            model_num_frames=eend_cfg.num_frames(int(tr["chunk_size"] * sr)),
            model_rf_duration=duration_s, model_rf_step=step_s, chunk_size=tr["chunk_size"],
            chunk_shift=tr["chunk_shift"], sample_rate=sr)
        batches = []
        for batch in DataLoader(dataset, batch_size=tr["batch_size"], shuffle=True,
                                seed=seed % 2**62):
            batches.append({"xs": batch["xs"], "target": batch["target"]})
            if len(batches) == CHECKED_STEPS:
                break
        weights = make_weights(cfg, seed, device)["segmentation"]
        before = {n: t for n, t in weights.items()
                  if t.is_floating_point() and not n.endswith(("running_mean", "running_var"))}
        ref = reference_steps(arch, tr, weights, batches, tr["seed"], device)
        if fault == "half_batch":
            half = [{k: v[: len(v) // 2] for k, v in b.items()} for b in batches]
            got = reference_steps(arch, tr, weights, half, tr["seed"], device)
        else:
            got = reference_steps(arch, tr, weights, batches, tr["seed"], device, "fp8")
        return gaps(before, got["losses"], got["first_grads"], got["params"], ref)
    finally:
        shutil.rmtree(root, ignore_errors=True)
