"""Data parallelism of the port (diarizen_tpu_torch/parallel/distributed.py)
against the JAX package's helpers, and one two-process gloo run.

In one process every helper is a copy and every touch point a no-op: the
cases of tests/test_distributed.py and tests/test_utils_config.py run on
both packages. Two processes on the CPU (gloo, one spawn of two ranks with a
timeout of its own) run a tiny pipeline and the Trainer for one step at
dropout and layer drop 0: a step cannot equal the one-process step with
dropout on, since each process draws its masks for its own batch rows. Rank
0 first runs both without a group, then both ranks join one: the RTTM must
be the same text; the validation metrics before the step, and the first
step's loss, gradient norm and parameters, those of one process on the
whole batch (float32: 1e-6 relative for the loss, the norm and the
validation metrics, each parameter within 1e-6 of its one-process value,
which moves by about lr = 1e-3 in the step); and only rank 0 writes the
experiment directory.
"""

import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from diarizen_tpu.parallel import distributed as jax_dist
from diarizen_tpu_torch.parallel import distributed as dist

ROOT = Path(__file__).resolve().parents[1]


def test_process_window_shard_partitions_as_jax():
    for n, P in [(11, 3), (8, 8), (5, 8), (1, 2), (0, 4), (7, 1)]:
        shards = [dist.process_window_shard(n, p, P) for p in range(P)]
        for p in range(P):
            np.testing.assert_array_equal(shards[p], jax_dist.process_window_shard(n, p, P))
        all_idx = np.sort(np.concatenate(shards)) if n else np.array([])
        np.testing.assert_array_equal(all_idx, np.arange(n))
        sizes = [len(s) for s in shards]
        assert max(sizes) - min(sizes) <= 1


def test_reassemble_window_shards_roundtrip():
    rng = np.random.default_rng(0)
    for n, P in [(11, 3), (8, 2), (5, 4)]:
        data = rng.standard_normal((n, 2, 3)).astype(np.float32)
        per = -(-n // P)
        shards = []
        for p in range(P):
            padded = np.zeros((per, 2, 3), np.float32)
            padded[: len(data[p::P])] = data[p::P]
            shards.append(padded)
        np.testing.assert_array_equal(dist.reassemble_window_shards(shards, n), data)
        np.testing.assert_array_equal(jax_dist.reassemble_window_shards(shards, n), data)


def test_single_process_paths():
    dist.initialize_distributed()  # WORLD_SIZE unset: a no-op, not a crash
    dist.initialize_distributed()
    assert not torch.distributed.is_initialized()
    assert dist.is_main_process() and jax_dist.is_main_process()
    assert (dist.process_index(), dist.process_count()) == (0, 1)
    for x in (np.arange(6, dtype=np.float32).reshape(2, 3), np.arange(4.0)):
        for fn in ("gather_to_host", "broadcast_from_host"):
            got = getattr(dist, fn)(x)
            np.testing.assert_array_equal(got, getattr(jax_dist, fn)(x))
            got[0] = -1  # a copy: callers mutate the result
            assert x.flat[0] == 0
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(dist.gather_window_shards(x, 2), x)
    np.testing.assert_array_equal(dist.process_window_shard(5), np.arange(5))
    t = torch.arange(3.0)
    dist.all_reduce_mean_([t])
    assert torch.equal(t, torch.arange(3.0)) and dist.all_reduce_sum(t) is t


def test_entry_points_take_the_card_of_their_local_rank(monkeypatch):
    from diarizen_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert resolve_device(None) == torch.device("cuda:1")
    assert resolve_device("cpu") == torch.device("cpu")


def _localhost_sockets_work() -> bool:
    """The rendezvous needs bind + connect + accept on 127.0.0.1 (restricted
    runners may allow bind but refuse connections); the guard of
    tests/test_multihost.py."""
    try:
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        port = srv.getsockname()[1]
        cli = socket.socket()
        cli.settimeout(2.0)
        cli.connect(("127.0.0.1", port))
        conn, _ = srv.accept()
        conn.close()
        cli.close()
        srv.close()
        return True
    except OSError:
        return False


def _free_local_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_each_process_draws_its_own_dropout(monkeypatch):
    """The seeds of K1's attention dropout and of the device generator are
    offset by the process index, so each process draws its own masks for its
    own rows; the host's uniform draws (layer drop) stay the same on every
    process. Process 0 keeps the seeds of a run without a group (exact)."""
    from diarizen_tpu_torch.models import common

    def draws(rank):
        monkeypatch.setattr(common, "process_index", lambda: rank)
        rng = common.TrainRandom(torch.Generator().manual_seed(7), torch.device("cpu"))
        seeds, uniforms = [], []
        for _ in range(4):
            seeds.append(rng.seed())
            uniforms.append(rng.uniform())
        return seeds, uniforms, torch.rand(8, generator=rng.device)

    host = torch.Generator().manual_seed(7)
    plain = [int(torch.randint(0, 2**31 - 1, (1,), generator=host)) for _ in range(2)]
    (s0, u0, d0), (s1, u1, d1) = draws(0), draws(1)
    assert s0[0] == plain[1]  # the first host draw seeded the device generator
    assert u0 == u1
    assert all(0 <= s < 2**31 - 1 for s in s0 + s1)
    assert all(a != b for a, b in zip(s0, s1)) and not torch.equal(d0, d1)


def test_group_of_one_runs_the_collectives():
    """In a live gloo group of one process the collectives run (no early
    return) and give what no group gives: exact copies, a (1, ...) gather,
    the Conformer's train-mode BatchNorm output, running statistics and
    input gradient bit for bit."""
    if not _localhost_sockets_work():
        pytest.skip("localhost sockets unavailable in this environment")
    from diarizen_tpu_torch.models.conformer import Conformer, ConformerConfig
    from diarizen_tpu_torch.models.convert import random_state_dict

    conformer = Conformer(ConformerConfig(dim=16, ffn_hidden=32, num_heads=2, num_layers=1,
                                          dropout=0.0))
    sd = random_state_dict(conformer, 0)
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 11, 16)).astype(np.float32))

    def bn_run():
        conformer.load_state_dict(sd)
        x = x0.clone().requires_grad_(True)
        y = conformer(x, train=True)
        (y ** 2).sum().backward()
        stats = [b.clone() for name, b in conformer.named_buffers() if "running" in name]
        return y.detach(), x.grad, stats

    alone = bn_run()
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    dist.initialize_distributed(f"127.0.0.1:{_free_local_port()}", 1, 0)
    try:
        assert dist.in_group() and torch.distributed.get_backend() == "gloo"
        np.testing.assert_array_equal(dist.gather_to_host(a), a[None])
        np.testing.assert_array_equal(dist.broadcast_from_host(a), a)
        np.testing.assert_array_equal(dist.gather_window_shards(a, 2), a)
        t = torch.arange(3.0, requires_grad=True)
        summed = dist.all_reduce_sum(t)
        assert summed is not t and torch.equal(summed.detach(), torch.arange(3.0))
        (summed * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
        assert torch.equal(t.grad, torch.tensor([1.0, 2.0, 3.0]))
        u = torch.arange(4.0)
        dist.all_reduce_mean_([u])
        assert torch.equal(u, torch.arange(4.0))
        grouped = bn_run()
    finally:
        torch.distributed.destroy_process_group()
    assert not dist.in_group()
    for got, want in zip([grouped[0], grouped[1], *grouped[2]], [alone[0], alone[1], *alone[2]]):
        assert torch.equal(got, want)


# one rank of the two-process run; rank 0 also runs the one-process
# reference before it joins the group
_RANK = r"""
import json, sys
class Block:  # TensorBoard's writer works without TensorFlow, which takes seconds to import
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "tensorflow":
            raise ImportError(name + " is blocked")
sys.meta_path.insert(0, Block())
import numpy as np
import torch
from diarizen_tpu_torch.cluster import AgglomerativeClustering
from diarizen_tpu_torch.infer import DiarizationPipeline, EmbeddingInference, SlidingInference
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.convert import random_state_dict
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig
from diarizen_tpu_torch.models.wavlm import WavLMConfig
from diarizen_tpu_torch.parallel import initialize_distributed, process_count, process_index
from diarizen_tpu_torch.train.optim import dual_lr_optimizer
from diarizen_tpu_torch.train.trainer import Trainer, TrainerConfig

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
n = 2
CFG = EendConfig(
    wavlm=WavLMConfig(
        conv_layers=((16, 10, 5), (16, 3, 2), (16, 3, 2), (16, 3, 2), (16, 3, 2),
                     (16, 2, 2), (16, 2, 2)),
        embed_dim=32, num_layers=n, use_attention=(True,) * n, use_feed_forward=(True,) * n,
        total_num_heads=(2,) * n, remaining_heads=((0, 1),) * n, ff_interm_features=(48,) * n,
        num_buckets=40, max_distance=100, projection_dropout=0.0, attention_dropout=0.0,
        dropout=0.0, layer_drop=0.0),
    conformer=ConformerConfig(dim=16, ffn_hidden=32, num_heads=2, num_layers=1, dropout=0.0),
    wavlm_layer_num=n + 1, wavlm_feat_dim=32, attention_in=16, chunk_size=2.0)


def make_wave(dur_s, sr=16000):
    t = np.arange(dur_s * sr) / sr
    wave = np.zeros_like(t, dtype=np.float32)
    rng = np.random.default_rng(0)
    pos, spk = 0.0, 0
    while pos < dur_s - 2:
        seg = rng.uniform(2.0, 6.0)
        m = (t >= pos) & (t < pos + seg)
        wave[m] += 0.2 * np.sin(2 * np.pi * (180 + 90 * spk) * t[m]).astype(np.float32)
        wave[m] += 0.01 * rng.standard_normal(int(m.sum())).astype(np.float32)
        pos += seg * rng.uniform(0.6, 1.0)
        spk = 1 - spk
    return wave[None]


def model(confident=False):
    m = EendModel(CFG)
    sd = random_state_dict(m, 0)
    if confident:  # decisions far from ties, for the pipeline
        sd["classifier.weight"] = sd["classifier.weight"] * 100.0
    m.load_state_dict(sd)
    return m


def diarize():
    seg = SlidingInference(model(confident=True), duration=2.0, step=0.5, batch_size=4,
                           compute_dtype=torch.float32, device="cpu")
    resnet = ResNet(ResNetConfig(m_channels=8, num_blocks=(1, 1, 1, 1), embed_dim=32))
    resnet.load_state_dict(random_state_dict(resnet, 1))
    emb = EmbeddingInference(resnet, seg.window_size, num_speakers=4, batch_size=4, device="cpu")
    pipe = DiarizationPipeline(seg, emb, AgglomerativeClustering(min_cluster_size=2), CFG,
                               max_speakers=4)
    return pipe(make_wave(12), 16000, uri="synth").to_rttm()


def batch():
    rng = np.random.default_rng(2)
    frames = CFG.num_frames(32000)
    return {"xs": (0.1 * rng.standard_normal((4, 1, 32000))).astype(np.float32),
            "target": (rng.uniform(size=(4, frames, 4)) > 0.7).astype(np.uint8)}


def train(exp):
    m = model()
    full = batch()
    rows = slice(process_index(), None, process_count())  # this process's stripe
    local = {k: v[rows] for k, v in full.items()}
    steps = []
    trainer = Trainer(m, TrainerConfig(exp_dir=exp, max_epochs=1, compute_dtype="float32"),
                      dual_lr_optimizer(m.param_groups(), lr_small=1e-3, lr_big=1e-3),
                      device="cpu", step_hook=steps.append)
    val = trainer.validate([local])  # the totals summed over the processes
    trainer.train([local], [local])
    return {"loss": steps[0]["loss"], "grad_norm": steps[0]["grad_norm"], "val": val}, m.state_dict()


results = {}
if rank == 0:
    results["ref"] = {"rttm": diarize()}
    results["ref"]["train"], ref_sd = train(out + "/exp_ref")
    torch.save(ref_sd, out + "/ref.pt")
initialize_distributed(f"127.0.0.1:{port}", 2, rank)
results["dp"] = {"rttm": diarize(), "world": process_count(),
                 "backend": torch.distributed.get_backend()}
results["dp"]["train"], dp_sd = train(out + f"/exp_dp{rank}")
torch.save(dp_sd, out + f"/dp{rank}.pt")
torch.distributed.destroy_process_group()
print(json.dumps(results))
"""


def test_two_ranks_equal_one(tmp_path):
    if not _localhost_sockets_work():
        pytest.skip("localhost sockets unavailable in this environment")
    port = _free_local_port()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(rank), str(port), str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in (0, 1)]
    outputs = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=240)
            assert proc.returncode == 0, stderr[-4000:]
            outputs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
    ref = outputs[0]["ref"]
    assert len(ref["rttm"].splitlines()) > 1
    for rank, out in enumerate(outputs):
        dp = out["dp"]
        assert (dp["world"], dp["backend"]) == (2, "gloo")
        assert dp["rttm"] == ref["rttm"], f"rank {rank}"
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(dp["train"][key], ref["train"][key], rtol=1e-6)
        for key, value in ref["train"]["val"].items():
            np.testing.assert_allclose(dp["train"]["val"][key], value, rtol=1e-6, err_msg=key)
    ref_sd = torch.load(tmp_path / "ref.pt")
    for rank in (0, 1):
        sd = torch.load(tmp_path / f"dp{rank}.pt")
        for name, value in ref_sd.items():
            # a gradient that is zero in exact arithmetic (key biases before
            # the softmax, the depthwise-conv bias before batch-statistics
            # BatchNorm) is rounding noise, which AdamW's first step scales
            # up to +-lr in either run: those parameters stay within 2 lr
            noise = name.endswith(("k_proj.bias", "linearK.bias", "depthwise_conv.bias"))
            np.testing.assert_allclose(sd[name].numpy(), value.numpy(), rtol=0,
                                       atol=2e-3 if noise else 1e-6,
                                       err_msg=f"rank {rank}: {name}")
    # only the main process writes: rank 1's experiment directory never appeared
    metrics = [json.loads(line) for line in (tmp_path / "exp_dp0/metrics.jsonl").read_text()
               .splitlines()]
    ref_metrics = json.loads((tmp_path / "exp_ref/metrics.jsonl").read_text())
    assert len(metrics) == 1
    np.testing.assert_allclose(metrics[0]["train_loss"], ref_metrics["train_loss"], rtol=1e-6)
    assert (tmp_path / "exp_dp0/checkpoints/epoch_0000").is_dir()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "dp0.pt", "dp1.pt", "exp_dp0", "exp_ref", "ref.pt"]
