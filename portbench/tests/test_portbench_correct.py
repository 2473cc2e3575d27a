"""`correct` comes out false when the timed path is broken underneath it,
and true when it is not: a whole run of a serving cell on the CPU (every
step but the look for a chip) at a small pool, with the program patched
where it produces its answers. The control, the reference one precision
below the configuration's in the program's place, fails too; on the card
at the cell's own size (marked `card`)."""

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import control, core
from portbench.run import run_cell

CELL = "base-s80-md.clips"
SMALL = {"files": 2, "min_s": 10.0, "max_s": 12.0}


def small_cell():
    workload = core.load_workload(CELL)
    return {**workload, "traffic": {**workload["traffic"], **SMALL}, "warm_chunks": [4],
            "check_files": 1}


def run_small(seed=2**31 + 21):
    result, checks = run_cell(core.manifest(), CELL, small_cell(), seed, 0.05, False, "cpu", 1,
                              Path(tempfile.mkdtemp()))
    return result, checks


def half_batch_left_out(monkeypatch):
    from diarizen_tpu_torch.models.eend import EendModel

    forward = EendModel.forward

    def broken(self, *args, **kwargs):
        scores = forward(self, *args, **kwargs).clone()
        half = scores.shape[0] // 2
        scores[half:] = torch.log_softmax(torch.zeros_like(scores[half:]), dim=-1)
        return scores

    monkeypatch.setattr(EendModel, "forward", broken)


def embeddings_altered(monkeypatch):
    from diarizen_tpu_torch.infer.pipeline import EmbeddingInference

    dispatch = EmbeddingInference.dispatch
    monkeypatch.setattr(EmbeddingInference, "dispatch",
                        lambda self, *a, **k: dispatch(self, *a, **k) * 1.05)


def counts_altered(monkeypatch):
    from diarizen_tpu_torch.infer.fused import FusedStitch

    stitch = FusedStitch.stitch

    def broken(self, *args, **kwargs):
        binary, counts, weights = stitch(self, *args, **kwargs)
        counts = counts.clone()
        counts[counts.numel() // 2] += 1
        return binary, counts, weights

    monkeypatch.setattr(FusedStitch, "stitch", broken)


def cluster_altered(monkeypatch):
    from diarizen_tpu_torch.cluster import VBxClustering

    call = VBxClustering.__call__

    def broken(self, *args, **kwargs):
        hard, soft, centroids = call(self, *args, **kwargs)
        hard = hard.copy()
        hard[0, 0] = hard.max() + 1
        return hard, soft, centroids

    monkeypatch.setattr(VBxClustering, "__call__", broken)


def test_sound_run_is_correct():
    result, checks = run_small()
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"audio_s_per_s", "setup_s"}


@pytest.mark.parametrize("fault", [half_batch_left_out, embeddings_altered, counts_altered,
                                   cluster_altered])
def test_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    result, checks = run_small()
    assert not result["correct"], checks
    assert result["failed"] >= 1


def test_control_fails_small():
    workload = small_cell()
    worst = control.readings(workload, 2**31 + 5, "cpu", Path(tempfile.mkdtemp()))
    assert any(worst[k] > workload["limits"][k] for k in worst), worst


@pytest.mark.card
@pytest.mark.parametrize("cell", ["base-s80-md.meetings", "base-s80-md.clips"])
def test_control_fails_at_cell_size(card, cell):
    workload = core.load_workload(cell)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        worst = control.readings(workload, seed, card, Path(tempfile.mkdtemp()))
        print("control", cell, seed, worst)
        assert any(worst[k] > workload["limits"][k] for k in worst), (cell, seed, worst)


@pytest.mark.card
@pytest.mark.parametrize("fault", ["control", "half_batch"])
def test_training_control_and_fault_fail_at_cell_size(card, fault):
    from portbench.traffic.train import control_readings

    workload = core.load_workload("wavlm-base-conformer.train")
    for seed in (2**31 + 104, 2**31 + 105, 2**31 + 106):
        got = control_readings(workload, seed, card, Path(tempfile.mkdtemp()), fault)
        print(fault, seed, got)
        limits = workload["limits"]
        assert any(got[k] > limits[k] for k in limits), (fault, seed, got)


TRAIN_CELL = "wavlm-base-conformer.train"


def run_small_training(monkeypatch, seed=2**31 + 31):
    workload = core.load_workload(TRAIN_CELL)
    workload = {**workload, "traffic": {**workload["traffic"], "recordings": 2, "seconds": 20}}
    cfg = core.load_config(workload["config"])
    cfg["train"].update(batch_size=2, chunk_size=2.0, chunk_shift=2.0)  # a CPU-sized step
    monkeypatch.setattr(core, "load_config", lambda name: cfg)
    return run_cell(core.manifest(), TRAIN_CELL, workload, seed, 0.5, False, "cpu", 1,
                    Path(tempfile.mkdtemp()))


def state_unchanged(monkeypatch):
    from diarizen_tpu_torch.train.optim import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self, *args, **kwargs: None)


def half_of_each_batch(monkeypatch):
    from diarizen_tpu_torch.train import step

    inner = step._step

    def broken(state, xs, target, *args, **kwargs):
        half = xs.shape[0] // 2
        return inner(state, xs[:half], target[:half], *args, **kwargs)

    monkeypatch.setattr(step, "_step", broken)


def test_sound_training_run_is_correct(monkeypatch):
    result, checks = run_small_training(monkeypatch)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", [state_unchanged, half_of_each_batch])
def test_training_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    result, checks = run_small_training(monkeypatch)
    assert not result["correct"], checks
