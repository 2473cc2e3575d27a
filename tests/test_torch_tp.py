"""Tensor parallelism of the port (diarizen_tpu_torch/parallel/mesh.py, the
`model` axis of WavLM) against the JAX package's `model` axis and against
the port on one process, on the CPU.

The cases of tests/test_tp_parity.py, on the JAX package's virtual CPU
devices and on gloo ranks of the port started with `subprocess` (one spawn
of four ranks at (data, model) = (2, 2) and one of two at (1, 2), side by
side, each rank on one thread, with a timeout of their own), on the same
weights carried across by `eend_state_dict_from_jax`:
  (a) the sharded keys and dims equal JAX's golden set through the converter,
      but for `gru_linear`, which the port keeps whole;
  (b) the forward equals JAX's sharded and replicated forward (f32, 2e-5);
  (c) per-leaf gradients, gathered, equal JAX's and the port's one-process
      gradients (1e-5 abs / 1e-3 rel);
  (d) one train step under SGD (parameters 1e-7 / 1e-5) and under the
      dual-LR AdamW with AutoClip (loss 1e-5, gradient norm 1e-3) equals the
      one-process step;
  (e) with dropout and layer drop on at (1, 2), the scores of the training
      forward and the replicated parameters and statistics after a step are
      bit-identical on both model ranks, and the loss is the one-process
      step's (1e-5);
  (f) the attention-dropout mask and the trainable plain attention at a head
      offset are the slice of the whole layer's;
  (g) a pruned configuration with uneven heads, a rank holding none of a
      layer's heads and odd FF widths gives the one-process forward and
      gradients, and with dropout and layer drop on the one-process step,
      both ranks computing the same layers;
  (h) a checkpoint written at (2, 2) loads into a one-process model and
      optimizer, and resuming under the mesh cuts each rank's slices back
      out of it, bit for bit;
  (i) the pipeline at (1, 2) (also with the WavLM split over the model axis)
      and at (2, 2) writes the one-process RTTM.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from diarizen_tpu.models.eend import eend_forward, init_eend_params
from diarizen_tpu.parallel.mesh import eend_param_shardings as jax_param_shardings
from diarizen_tpu.parallel.mesh import make_mesh as jax_make_mesh
from diarizen_tpu.train.loss import segmentation_loss as jax_segmentation_loss
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.convert import eend_state_dict_from_jax, random_state_dict
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.wavlm import WavLMConfig
from diarizen_tpu_torch.ops.flash_attention import (
    dropout_mask,
    flash_attention_gated_bias_reference,
    flash_attention_gated_bias_trainable,
    head_seed,
)
from diarizen_tpu_torch.parallel import mesh as tp
from diarizen_tpu_torch.train import TrainState, dual_lr_optimizer, segmentation_loss, train_step
from diarizen_tpu_torch.train.step import step_generator

sys.path.insert(0, os.path.dirname(__file__))
from test_pipeline import tiny_eend_cfg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 0.5  # seconds: 399 frames of the tiny extractor
SPAWN_TIMEOUT = 150

# the optimizer interface of the train step around optax.sgd, shared by the
# test and its ranks
_SGD = '''
class SGD:
    """p <- p - lr * g over the model's named parameters."""

    def __init__(self, model, lr):
        self.params = dict(model.named_parameters())
        self.lr = lr

    def grads(self):
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params.values()]

    @torch.no_grad()
    def step(self, grads, value=None, norm=None):
        for p, g in zip(self.params.values(), grads):
            p.sub_(self.lr * g)
'''
exec(_SGD)


def port_cfg(jcfg, **wavlm):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["wavlm"] = WavLMConfig(**{**dataclasses.asdict(jcfg.wavlm), **wavlm})
    fields["conformer"] = ConformerConfig(**dataclasses.asdict(jcfg.conformer))
    return EendConfig(**fields)


def without_dropout(cfg: EendConfig) -> EendConfig:
    return dataclasses.replace(
        cfg, wavlm=dataclasses.replace(cfg.wavlm, dropout=0.0, attention_dropout=0.0,
                                       projection_dropout=0.0, layer_drop=0.0,
                                       ff_interm_dropout=0.0),
        conformer=dataclasses.replace(cfg.conformer, dropout=0.0))


def pruned_cfg(cfg: EendConfig) -> EendConfig:
    """Four layers: 3 heads (split 2 + 1), 1 head (rank 1 holds none), 2
    heads, no attention; odd FF widths (37 = 19 + 18, 21, 9, 5)."""
    w = cfg.wavlm
    n = 4
    return dataclasses.replace(
        without_dropout(cfg), wavlm_layer_num=n + 1,
        wavlm=dataclasses.replace(
            without_dropout(cfg).wavlm, num_layers=n, use_attention=(True, True, True, False),
            use_feed_forward=(True,) * n, total_num_heads=(w.total_num_heads[0],) * n,
            remaining_heads=((0, 1, 3), (2,), (0, 3), ()), ff_interm_features=(37, 21, 9, 5)))


def with_dropout(cfg: EendConfig) -> EendConfig:
    """Dropout, attention dropout, FF-interm dropout and layer drop on."""
    return dataclasses.replace(
        cfg, wavlm=dataclasses.replace(cfg.wavlm, dropout=0.1, attention_dropout=0.1,
                                       ff_interm_dropout=0.1, layer_drop=0.3),
        conformer=dataclasses.replace(cfg.conformer, dropout=0.1))


def make_batch(cfg, batch_size=4, seed=1):
    num_samples = int(cfg.chunk_size * cfg.sample_rate)
    rng = np.random.default_rng(seed)
    return {"xs": (rng.standard_normal((batch_size, 1, num_samples)) * 0.1).astype(np.float32),
            "target": (rng.uniform(size=(batch_size, cfg.num_frames(num_samples),
                                         cfg.max_speakers_per_chunk)) > 0.7).astype(np.float32)}


def model_of(cfg, sd):
    m = EendModel(cfg)
    m.load_state_dict(sd)
    return m


def grads_of(model, batch, train=False, seed=None):
    model.zero_grad()
    kwargs = {"train": True} if train else {}
    if seed is not None:  # dropout and layer drop on
        kwargs["generator"] = step_generator(seed, 0)
    scores = model(torch.from_numpy(batch["xs"]), torch.float32, **kwargs)
    loss = segmentation_loss(model.cfg.powerset, scores, torch.from_numpy(batch["target"]))
    loss.backward()
    return float(loss), {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                         for n, p in model.named_parameters()}


def adamw(model):
    return dual_lr_optimizer(model.param_groups(), lr_small=1e-4, lr_big=3e-3,
                             clip_percentile=90)


def one_step(cfg, sd, batch, make_opt, seed=3):
    m = model_of(cfg, sd)
    state = TrainState(model=m, optimizer=make_opt(m))
    metrics = train_step(state, batch, seed=seed, compute_dtype=torch.float32)
    return metrics, m.state_dict()


# ---------------------------------------------------------------------------
# the pipeline's model and audio (those of tests/test_torch_distributed.py)


def pipeline_cfg():
    n = 2
    return EendConfig(
        wavlm=WavLMConfig(
            conv_layers=((16, 10, 5), (16, 3, 2), (16, 3, 2), (16, 3, 2), (16, 3, 2),
                         (16, 2, 2), (16, 2, 2)),
            embed_dim=32, num_layers=n, use_attention=(True,) * n,
            use_feed_forward=(True,) * n, total_num_heads=(2,) * n,
            remaining_heads=((0, 1),) * n, ff_interm_features=(48,) * n, num_buckets=40,
            max_distance=100, projection_dropout=0.0, attention_dropout=0.0, dropout=0.0,
            layer_drop=0.0),
        conformer=ConformerConfig(dim=16, ffn_hidden=32, num_heads=2, num_layers=1,
                                  dropout=0.0),
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


_DIARIZE = '''
def diarize(inputs, mesh=None, split=False):
    from diarizen_tpu_torch.cluster import AgglomerativeClustering
    from diarizen_tpu_torch.infer import DiarizationPipeline, EmbeddingInference, SlidingInference
    from diarizen_tpu_torch.models.eend import EendModel
    from diarizen_tpu_torch.models.resnet import ResNet
    from diarizen_tpu_torch.parallel import shard_model_

    cfg = inputs["pipe_cfg"]
    model = EendModel(cfg)
    model.load_state_dict(inputs["pipe_sd"])
    if split:
        shard_model_(model, mesh)
    seg = SlidingInference(model, duration=2.0, step=0.5, batch_size=4,
                           compute_dtype=torch.float32, device="cpu", mesh=mesh)
    resnet = ResNet(inputs["resnet_cfg"])
    resnet.load_state_dict(inputs["resnet_sd"])
    emb = EmbeddingInference(resnet, seg.window_size, num_speakers=4, batch_size=4, device="cpu")
    pipe = DiarizationPipeline(seg, emb, AgglomerativeClustering(min_cluster_size=2), cfg,
                               max_speakers=4, mesh=mesh)
    return pipe(inputs["wave"], 16000, uri="synth").to_rttm()
'''
exec(_DIARIZE)


# ---------------------------------------------------------------------------
# one rank of a spawn

_RANK = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from diarizen_tpu_torch.models.eend import EendModel
from diarizen_tpu_torch.parallel import (gather_state, initialize_distributed, make_mesh,
                                         shard_batch, shard_model_)
from diarizen_tpu_torch.parallel.mesh import eend_param_shardings, mean_gradients_
from diarizen_tpu_torch.train import TrainState, dual_lr_optimizer, segmentation_loss, train_step
from diarizen_tpu_torch.train.step import step_generator
from diarizen_tpu_torch.train.trainer import Trainer, TrainerConfig
""" + _SGD + _DIARIZE + r"""
rank, world, n_model, port, out = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                   sys.argv[4], sys.argv[5])
inputs = torch.load(out + "/inputs.pt", weights_only=False)
initialize_distributed(f"127.0.0.1:{port}", world, rank)
mesh = make_mesh(world // n_model, n_model)
res = {"mesh": (mesh.n_data, mesh.n_model, mesh.data_index, mesh.model_index)}


def split_model(cfg, sd):
    m = EendModel(cfg)
    m.load_state_dict(sd)
    return shard_model_(m, mesh)


def local(batch):
    return shard_batch(batch, mesh)


def gathered_grads(m, batch, train=False, seed=None):
    m.zero_grad()
    kwargs = {"train": True} if train else {}
    if seed is not None:
        kwargs["generator"] = step_generator(seed, 0)
    scores = m(torch.from_numpy(batch["xs"]), torch.float32, **kwargs)
    loss = segmentation_loss(m.cfg.powerset, scores, torch.from_numpy(batch["target"]))
    loss.backward()
    names = [n for n, _ in m.named_parameters()]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in m.parameters()]
    shared = loss.detach().reshape(1)
    mean_gradients_(m, names, grads, [shared])
    return float(shared), gather_state(dict(zip(names, grads)), m, mesh)


batch = local(inputs["batch"])
m = split_model(inputs["cfg"], inputs["sd"])
with torch.no_grad():
    res["scores"] = m(torch.from_numpy(batch["xs"]), torch.float32)  # (b)
res["grad_loss"], res["grads"] = gathered_grads(m, batch)  # (c)

for name in ("sgd", "adamw"):  # (d)
    m = split_model(inputs["cfg0"], inputs["sd"])
    opt = SGD(m, 1e-2) if name == "sgd" else dual_lr_optimizer(
        m.param_groups(), lr_small=1e-4, lr_big=3e-3, clip_percentile=90)
    metrics = train_step(TrainState(model=m, optimizer=opt), batch, seed=3,
                         compute_dtype=torch.float32)
    res[name] = {"metrics": metrics, "state": gather_state(m.state_dict(), m, mesh)}

if mesh.n_data == 1:
    # (e) dropout, attention dropout, FF-interm dropout and layer drop on
    m = split_model(inputs["cfg_drop"], inputs["sd"])
    res["drop_scores"] = m(torch.from_numpy(batch["xs"]), torch.float32, train=True,
                           generator=step_generator(5, 0)).detach()
    m = split_model(inputs["cfg_drop"], inputs["sd"])
    opt = dual_lr_optimizer(m.param_groups(), lr_small=1e-4, lr_big=3e-3, clip_percentile=90)
    metrics = train_step(TrainState(model=m, optimizer=opt), batch, seed=5,
                         compute_dtype=torch.float32)
    dims = eend_param_shardings(m, mesh)
    res["drop"] = {"metrics": metrics,
                   "replicated": {k: v for k, v in m.state_dict().items() if dims[k] is None}}
    # (g) uneven heads, a rank without heads, odd FF widths
    m = split_model(inputs["cfg_pruned"], inputs["sd_pruned"])
    with torch.no_grad():
        res["pruned_scores"] = m(torch.from_numpy(batch["xs"]), torch.float32)
    res["pruned_grads"] = gathered_grads(m, batch, train=True)
    # and with dropout and layer drop on, gradients and a train step: the
    # rank without layer 1's head draws that layer's attention seed all the same
    m = split_model(inputs["cfg_pruned_drop"], inputs["sd_pruned"])
    res["pruned_drop_grads"] = gathered_grads(m, batch, train=True, seed=5)
    m = split_model(inputs["cfg_pruned_drop"], inputs["sd_pruned"])
    opt = dual_lr_optimizer(m.param_groups(), lr_small=1e-4, lr_big=3e-3, clip_percentile=90)
    metrics = train_step(TrainState(model=m, optimizer=opt), batch, seed=5,
                         compute_dtype=torch.float32)
    dims = eend_param_shardings(m, mesh)
    res["pruned_drop"] = {
        "metrics": metrics, "layers_run": list(m.wavlm_model.layers_run),
        "replicated": {k: v for k, v in m.state_dict().items() if dims[k] is None}}

# (h) a checkpoint written under the mesh, then resumed under it
exp = out + "/exp"
m = EendModel(inputs["cfg0"])
m.load_state_dict(inputs["sd"])
trainer = Trainer(m, TrainerConfig(exp_dir=exp, max_epochs=1, compute_dtype="float32"),
                  dual_lr_optimizer(m.param_groups(), lr_small=1e-4, lr_big=3e-3),
                  device="cpu", mesh=mesh)
trainer.train([batch], [batch])
res["trained"] = {k: v.clone() for k, v in m.state_dict().items()}
res["trained_opt"] = trainer.state.optimizer.state_dict()
torch.distributed.barrier()  # rank 0 has written the checkpoint
m = EendModel(inputs["cfg0"])
m.load_state_dict(inputs["sd"])
resumed = Trainer(m, TrainerConfig(exp_dir=exp, max_epochs=1, compute_dtype="float32"),
                  dual_lr_optimizer(m.param_groups(), lr_small=1e-4, lr_big=3e-3),
                  device="cpu", mesh=mesh)
res["resumed_ok"] = resumed.resume()
res["resumed"] = m.state_dict()
res["resumed_opt"] = resumed.state.optimizer.state_dict()

res["rttm"] = diarize(inputs, mesh)  # (i)
if mesh.n_data == 1:
    res["rttm_split"] = diarize(inputs, mesh, split=True)
torch.save(res, f"{out}/rank{rank}.pt")
torch.distributed.destroy_process_group()
"""


def _localhost_sockets_work() -> bool:
    try:
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        cli = socket.socket()
        cli.settimeout(2.0)
        cli.connect(("127.0.0.1", srv.getsockname()[1]))
        conn, _ = srv.accept()
        for s in (conn, cli, srv):
            s.close()
        return True
    except OSError:
        return False


def _free_local_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world, n_model, out):
    port = str(_free_local_port())
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(rank), str(world), str(n_model), port, str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]


def _wait(procs, out):
    try:
        errors = [proc.communicate(timeout=SPAWN_TIMEOUT)[1] for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    failed = [f"rank {r}: {err[-3000:]}" for r, (proc, err) in enumerate(zip(procs, errors))
              if proc.returncode != 0]
    assert not failed, "\n".join(failed)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


def _jax_grads(params, state, jcfg, batch, mesh=None):
    def loss_fn(p, xs, target):
        scores, _ = eend_forward(p, state, jcfg, xs, train=False, compute_dtype=jnp.float32)
        return jax_segmentation_loss(jcfg.powerset, scores, target)

    xs, target, p = batch["xs"], batch["target"], params
    if mesh is not None:
        p = jax.device_put(params, jax_param_shardings(params, mesh))
        xs = jax.device_put(xs, NamedSharding(mesh, P("data")))
        target = jax.device_put(target, NamedSharding(mesh, P("data")))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(p, xs, target)
    return float(loss), jax.device_get(grads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns, and meanwhile the JAX package's and the one-process
    port's references on the same weights and batch."""
    if not _localhost_sockets_work():
        pytest.skip("localhost sockets unavailable in this environment")
    jcfg = tiny_eend_cfg(chunk_size=CHUNK)
    params, state = init_eend_params(jax.random.PRNGKey(0), jcfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    cfg = port_cfg(jcfg)
    sd = eend_state_dict_from_jax(params, state, jcfg)
    cfg0 = without_dropout(cfg)
    cfg_drop = dataclasses.replace(
        cfg, wavlm=dataclasses.replace(cfg.wavlm, ff_interm_dropout=0.1, layer_drop=0.3))
    cfg_pruned = pruned_cfg(cfg)
    sd_pruned = random_state_dict(EendModel(cfg_pruned), 4)
    cfg_pruned_drop = with_dropout(cfg_pruned)
    pipe_cfg = pipeline_cfg()
    pipe_sd = random_state_dict(EendModel(pipe_cfg), 0)
    pipe_sd["classifier.weight"] = pipe_sd["classifier.weight"] * 100.0  # far from ties
    from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig

    resnet_cfg = ResNetConfig(m_channels=8, num_blocks=(1, 1, 1, 1), embed_dim=32)
    batch = make_batch(cfg)
    inputs = {"cfg": cfg, "cfg0": cfg0, "cfg_drop": cfg_drop, "cfg_pruned": cfg_pruned,
              "cfg_pruned_drop": cfg_pruned_drop, "sd": sd, "sd_pruned": sd_pruned,
              "batch": batch, "pipe_cfg": pipe_cfg, "pipe_sd": pipe_sd, "resnet_cfg": resnet_cfg,
              "resnet_sd": random_state_dict(ResNet(resnet_cfg), 1), "wave": make_wave(12)}
    dirs = {}
    procs = {}
    for n_data, n_model in ((2, 2), (1, 2)):
        out = tmp_path_factory.mktemp(f"tp{n_data}x{n_model}")
        torch.save(inputs, out / "inputs.pt")
        dirs[n_data, n_model] = out
        procs[n_data, n_model] = _spawn(n_data * n_model, n_model, out)

    ref = {}
    try:
        # the JAX package: replicated, and over its model axis at (2, 2) and (1, 2)
        fwd = jax.jit(lambda p, s, x: eend_forward(p, s, jcfg, x, train=False,
                                                   compute_dtype=jnp.float32)[0])
        ref["jax_scores"] = np.asarray(fwd(params, state, batch["xs"]))
        jmesh = jax_make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
        ref["jax_scores_tp"] = np.asarray(fwd(
            jax.device_put(params, jax_param_shardings(params, jmesh)),
            jax.device_put(state, NamedSharding(jmesh, P())),
            jax.device_put(batch["xs"], NamedSharding(jmesh, P("data")))))
        ref["jax_grads"] = _jax_grads(params, state, jcfg, batch)
        for n_data, n_model in ((2, 2), (1, 2)):
            jm = jax_make_mesh(n_data=n_data, n_model=n_model,
                               devices=jax.devices()[: n_data * n_model])
            ref["jax_grads", n_data, n_model] = _jax_grads(params, state, jcfg, batch, jm)
        # the port on one process
        m = model_of(cfg, sd)
        with torch.no_grad():
            ref["scores"] = m(torch.from_numpy(batch["xs"]), torch.float32)
        ref["grads"] = grads_of(m, batch)
        ref["sgd"] = one_step(cfg0, sd, batch, lambda m: SGD(m, 1e-2))
        ref["adamw"] = one_step(cfg0, sd, batch, adamw)
        ref["drop"] = one_step(cfg_drop, sd, batch, adamw, seed=5)
        m = model_of(cfg_pruned, sd_pruned)
        with torch.no_grad():
            ref["pruned_scores"] = m(torch.from_numpy(batch["xs"]), torch.float32)
        ref["pruned_grads"] = grads_of(m, batch, train=True)
        m = model_of(cfg_pruned_drop, sd_pruned)
        ref["pruned_drop_grads"] = grads_of(m, batch, train=True, seed=5)
        m = model_of(cfg_pruned_drop, sd_pruned)
        metrics = train_step(TrainState(model=m, optimizer=adamw(m)), batch, seed=5,
                             compute_dtype=torch.float32)
        ref["pruned_drop"] = metrics, list(m.wavlm_model.layers_run)
        ref["rttm"] = diarize(inputs)
        ranks = {key: _wait(p, dirs[key]) for key, p in procs.items()}
    finally:
        for p in procs.values():
            for proc in p:
                proc.kill()
    return {"ref": ref, "ranks": ranks, "dirs": dirs, "inputs": inputs, "jax_params": params,
            "jcfg": jcfg}


def _close(got, want, atol, rtol, what):
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w), atol=atol, rtol=rtol,
                                   err_msg=f"{what}: {name}")


# ---------------------------------------------------------------------------
# in one process


def test_param_shardings_match_jax_golden_set():
    """(a) Each leaf JAX shards over 'model' carries the index along its
    sharded axis; through the converter that index varies along the port's
    sharded dim. gru_linear is the one difference: the port keeps it whole."""
    jcfg = tiny_eend_cfg()
    params, state = init_eend_params(jax.random.PRNGKey(0), jcfg)
    specs = jax_param_shardings(params, jax_make_mesh(n_data=4, n_model=2))

    def marker(x, s):
        x = np.zeros(np.shape(x), np.float32)
        if "model" not in s.spec:
            return x
        axis = list(s.spec).index("model")
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        return x + np.arange(x.shape[axis], dtype=np.float32).reshape(shape)

    marked = jax.tree_util.tree_map(marker, params, specs)
    sd = eend_state_dict_from_jax(marked, jax.tree_util.tree_map(np.asarray, state), jcfg)
    want = {}
    for key, t in sd.items():
        varying = [d for d in range(t.dim()) if t.shape[d] > 1
                   and not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
        if varying and "gru_rel_pos_linear" not in key:
            want[key] = varying[0]
    model = EendModel(port_cfg(jcfg))
    got = tp.eend_param_shardings(model, tp.Mesh(4, 2))
    assert set(got) == set(model.state_dict())
    assert {k: d for k, d in got.items() if d is not None} == want
    assert len(want) == 10 * jcfg.wavlm.num_layers
    assert all(d is None for d in tp.eend_param_shardings(model, tp.Mesh(8, 1)).values())


def test_split_range_is_array_split():
    for n in (0, 1, 3, 5, 16, 37):
        for parts in (1, 2, 3, 4):
            blocks = np.array_split(np.arange(n), parts)
            for i, block in enumerate(blocks):
                start, length = tp.split_range(n, parts, i)
                assert length == len(block) and (length == 0 or start == block[0])


def test_one_process_mesh_is_trivial():
    mesh = tp.make_mesh()
    assert (mesh.shape, mesh.data_index, mesh.model_index) == ({"data": 1, "model": 1}, 0, 0)
    x = np.arange(12.0).reshape(4, 3)
    np.testing.assert_array_equal(tp.shard_batch({"xs": [x]}, mesh)["xs"][0], x)
    assert tp.replicated(mesh).spec == () and tp.data_sharding(mesh, 2).spec == ("data", None)
    np.testing.assert_array_equal(tp.data_sharding(tp.Mesh(2, 2, 3), 2).local(x), x[2:])
    with pytest.raises(ValueError, match="mesh needs"):
        tp.make_mesh(n_data=2)
    model = EendModel(pipeline_cfg())
    assert tp.shard_model_(model, mesh) is model and tp.model_mesh(model) is None
    assert tp.gather_state_dict(model, mesh).keys() == model.state_dict().keys()


def test_model_axis_refuses_the_multichannel_family_and_distill():
    from diarizen_tpu_torch.models.mc import FusionConfig, McEendConfig, McEendModel
    from diarizen_tpu_torch.prune.distill import (
        DistillConfig,
        create_distill_prune_state,
        make_distill_prune_step,
    )
    from diarizen_tpu_torch.prune.gates import PruneConfig, init_gates
    from diarizen_tpu_torch.models.wavlm import WavLM

    cfg = pipeline_cfg()
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    mc = McEendModel(McEendConfig(**fields, fusion=FusionConfig(num_fusion_layers=1)))
    with pytest.raises(NotImplementedError, match="McEendModel"):
        tp.shard_model_(mc, tp.Mesh(1, 2))
    student = WavLM(cfg.wavlm)
    tp.shard_model_(student, tp.Mesh(1, 2))
    dcfg = DistillConfig(distill_layers=(1, 2))
    state = create_distill_prune_state(student, init_gates(cfg.wavlm, PruneConfig()), dcfg,
                                       device="cpu")
    step = make_distill_prune_step(cfg.wavlm, dcfg, WavLM(cfg.wavlm))
    with pytest.raises(NotImplementedError, match="distill-prune step"):
        step(state, np.zeros((1, 16000), np.float32))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_mask_at_a_head_offset_is_the_slice(rate):
    """(f) The mask of heads o .. o + k - 1 is the slice of the whole
    layer's, and equals the mask at head 0 of the seed the kernels get."""
    full = dropout_mask(1234567, 3, 7, 17, 19, rate)
    for o, k in ((0, 3), (3, 4), (5, 2), (6, 1)):
        part = dropout_mask(1234567, 3, k, 17, 19, rate, head_offset=o)
        assert torch.equal(part, full[:, o:o + k])
        assert torch.equal(dropout_mask(head_seed(1234567, o), 3, k, 17, 19, rate), part)


def test_trainable_plain_attention_at_a_head_offset_is_the_slice():
    """(f) The trainable plain version with dropout on the heads from an
    offset gives the slice of the whole layer's output and gradients."""
    rng = np.random.default_rng(0)
    b, h, t, d = 2, 5, 23, 8

    def make(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, k, v, dout = make(b, h, t, d), make(b, h, t, d), make(b, h, t, d), make(b, h, t, d)
    pos, gate = make(h, t, t), make(b, h, t)
    leaves = [x.requires_grad_(True) for x in (q, k, v, pos, gate)]
    out = flash_attention_gated_bias_trainable(q, k, v, pos, gate, 0.2, 99)
    (out * dout).sum().backward()
    full_grads = [x.grad.clone() for x in leaves]
    for o, n in ((0, 2), (2, 3), (4, 1)):
        sl = [x.detach()[:, o:o + n].clone().requires_grad_(True) for x in (q, k, v)]
        p_sl = pos.detach()[o:o + n].clone().requires_grad_(True)
        g_sl = gate.detach()[:, o:o + n].clone().requires_grad_(True)
        part = flash_attention_gated_bias_trainable(*sl, p_sl, g_sl, 0.2, 99, head_offset=o)
        torch.testing.assert_close(part, out.detach()[:, o:o + n], rtol=0, atol=0)
        (part * dout[:, o:o + n]).sum().backward()
        for x, g in zip(sl, full_grads[:3]):
            torch.testing.assert_close(x.grad, g[:, o:o + n], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(p_sl.grad, full_grads[3][o:o + n], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(g_sl.grad, full_grads[4][:, o:o + n], rtol=1e-6, atol=1e-6)
    plain = flash_attention_gated_bias_reference(q.detach()[:, 1:3], k.detach()[:, 1:3],
                                                 v.detach()[:, 1:3], pos.detach()[1:3],
                                                 gate.detach()[:, 1:3], 0.2, 99, head_offset=1)
    torch.testing.assert_close(plain, out.detach()[:, 1:3], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# on the gloo ranks


MESHES = [(2, 2), (1, 2)]


def test_ranks_hold_their_mesh_places(runs):
    for (n_data, n_model), ranks in runs["ranks"].items():
        places = [r["mesh"] for r in ranks]
        assert places == [(n_data, n_model, i // n_model, i % n_model)
                          for i in range(n_data * n_model)]


@pytest.mark.parametrize("n_data,n_model", MESHES)
def test_tp_forward_matches_jax(runs, n_data, n_model):
    """(b) The forward over the model axis equals JAX's replicated and
    sharded forward and the one-process port's (float32, 2e-5)."""
    ref = runs["ref"]
    ranks = runs["ranks"][n_data, n_model]
    # each data index holds its rows; its model ranks hold the same scores
    scores = torch.cat([ranks[d * n_model]["scores"] for d in range(n_data)]).numpy()
    for d in range(n_data):
        for m in range(1, n_model):
            assert torch.equal(ranks[d * n_model + m]["scores"], ranks[d * n_model]["scores"])
    np.testing.assert_allclose(scores, ref["jax_scores"], atol=2e-5)
    np.testing.assert_allclose(scores, ref["jax_scores_tp"], atol=2e-5)
    np.testing.assert_allclose(scores, ref["scores"].numpy(), atol=2e-5)


@pytest.mark.parametrize("n_data,n_model", MESHES)
def test_tp_gradients_match_jax_and_one_process(runs, n_data, n_model):
    """(c) Per-leaf gradients of the PIT loss, gathered over the model axis,
    equal JAX's on its mesh and replicated, and the port's one process."""
    ref = runs["ref"]
    jcfg = runs["jcfg"]
    state = jax.tree_util.tree_map(np.asarray, init_eend_params(jax.random.PRNGKey(0), jcfg)[1])
    for rank in runs["ranks"][n_data, n_model]:
        loss, grads = rank["grad_loss"], rank["grads"]
        for jax_loss, jax_grads in (ref["jax_grads"], ref["jax_grads", n_data, n_model]):
            np.testing.assert_allclose(loss, jax_loss, rtol=1e-5)
            want = eend_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax_grads),
                                            state, jcfg)
            # the JAX package keeps no leaf for an identity dummy_weight
            _close(grads, {n: want[n] for n in grads if not n.endswith("dummy_weight")},
                   1e-5, 1e-3, "vs JAX")
        np.testing.assert_allclose(loss, ref["grads"][0], rtol=1e-5)
        _close(grads, ref["grads"][1], 1e-5, 1e-3, "vs one process")


@pytest.mark.parametrize("n_data,n_model", MESHES)
@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_tp_train_step_matches_one_process(runs, optimizer, n_data, n_model):
    """(d) One train step over the mesh equals the one-process step: the
    parameters under SGD, the loss and the gradient norm (AutoClip's input)
    under the dual-LR AdamW."""
    ref_metrics, ref_state = runs["ref"][optimizer]
    params = dict(EendModel(runs["inputs"]["cfg0"]).named_parameters())
    for rank in runs["ranks"][n_data, n_model]:
        got = rank[optimizer]
        np.testing.assert_allclose(got["metrics"]["loss"], ref_metrics["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["grad_norm"], ref_metrics["grad_norm"],
                                   rtol=1e-3)
        if optimizer == "sgd":
            _close(got["state"], {n: ref_state[n] for n in params}, 1e-7, 1e-5, "SGD step")


def test_tp_dropout_step_keeps_the_model_ranks_identical(runs):
    """(e) With dropout, attention dropout (K1's hash at the head offset),
    FF-interm dropout (a full-width mask, sliced) and layer drop on, both
    model ranks of (1, 2) hold bit-identical replicated activations and
    parameters, and the step's loss is the one-process step's."""
    r0, r1 = runs["ranks"][1, 2]
    assert torch.equal(r0["drop_scores"], r1["drop_scores"])
    assert r0["drop"]["replicated"].keys() == r1["drop"]["replicated"].keys()
    for name, value in r0["drop"]["replicated"].items():
        assert torch.equal(value, r1["drop"]["replicated"][name]), name
    ref_metrics, ref_state = runs["ref"]["drop"]
    for rank in (r0, r1):
        np.testing.assert_allclose(rank["drop"]["metrics"]["loss"], ref_metrics["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(rank["drop"]["metrics"]["grad_norm"],
                                   ref_metrics["grad_norm"], rtol=1e-3)
        assert rank["drop"]["metrics"]["attention_layers"] == ref_metrics["attention_layers"]


def test_tp_uneven_heads_and_widths(runs):
    """(g) 3 heads split 2 + 1, a layer whose one head leaves rank 1 none
    (no launch there, zeros into the all-reduce), 2 heads, a layer without
    attention, FF widths 37, 21, 9 and 5: the forward and the training
    gradients equal one process's. With dropout and layer drop on, so do
    the gradients, both ranks compute the same layers and hold bit-identical
    replicated parameters after a step, and the step's loss and gradient
    norm are one process's."""
    ref = runs["ref"]
    for rank in runs["ranks"][1, 2]:
        np.testing.assert_allclose(rank["pruned_scores"].numpy(),
                                   ref["pruned_scores"].numpy(), atol=2e-5)
        loss, grads = rank["pruned_grads"]
        np.testing.assert_allclose(loss, ref["pruned_grads"][0], rtol=1e-5)
        _close(grads, ref["pruned_grads"][1], 1e-5, 1e-3, "pruned")
        loss, grads = rank["pruned_drop_grads"]
        np.testing.assert_allclose(loss, ref["pruned_drop_grads"][0], rtol=1e-5)
        _close(grads, ref["pruned_drop_grads"][1], 1e-5, 1e-3, "pruned, dropout on")
    r0, r1 = (rank["pruned_drop"] for rank in runs["ranks"][1, 2])
    ref_metrics, ref_layers = ref["pruned_drop"]
    assert 1 in ref_layers  # the layer whose head rank 1 lacks was computed
    assert r0["layers_run"] == r1["layers_run"] == ref_layers
    assert r0["metrics"]["loss"] == r1["metrics"]["loss"]
    for name, value in r0["replicated"].items():
        assert torch.equal(value, r1["replicated"][name]), name
    for rank in (r0, r1):
        np.testing.assert_allclose(rank["metrics"]["loss"], ref_metrics["loss"], rtol=1e-5)
        np.testing.assert_allclose(rank["metrics"]["grad_norm"], ref_metrics["grad_norm"],
                                   rtol=1e-3)


def test_tp_checkpoint_is_the_one_process_layout(runs):
    """(h) The checkpoint written at (2, 2) holds the full reference layout:
    it loads into a one-process model and optimizer, each rank's trained
    slices are cut from it bit for bit, and resuming under the mesh gives
    every rank its slices (model and optimizer state) back exactly."""
    from diarizen_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint

    cfg0 = runs["inputs"]["cfg0"]
    ckpt = latest_checkpoint(runs["dirs"][2, 2] / "exp" / "checkpoints")
    state_dict, opt_state, meta = load_checkpoint(ckpt)
    one = EendModel(cfg0)
    one.load_state_dict(state_dict, strict=True)
    adamw(one).load_state_dict(opt_state)
    assert meta["step"] == 1
    for rank, res in enumerate(runs["ranks"][2, 2]):
        assert res["resumed_ok"]
        mesh = tp.Mesh(2, 2, rank)
        local = tp.shard_model_(EendModel(cfg0), mesh)
        want = tp.local_state(state_dict, local, mesh)
        want_opt = tp.local_state(opt_state, local, mesh)
        for name, value in want.items():
            assert torch.equal(res["trained"][name], value), name
            assert torch.equal(res["resumed"][name], value), name
        for moment in ("mu", "nu"):
            for name, value in want_opt[moment].items():
                assert torch.equal(res["trained_opt"][moment][name], value), name
                assert torch.equal(res["resumed_opt"][moment][name], value), name


@pytest.mark.parametrize("key", ["2x2", "1x2", "1x2-split"])
def test_tp_pipeline_writes_the_one_process_rttm(runs, key):
    """(i) Segmentation and embedding windows sharded over the data axis,
    parameters replicated (and, at 1x2-split, WavLM split over the model
    axis): every rank writes the one-process RTTM."""
    n_data = int(key[0])
    ref = runs["ref"]["rttm"]
    assert len(ref.splitlines()) > 1
    for rank in runs["ranks"][n_data, 2]:
        assert rank["rttm_split" if key.endswith("split") else "rttm"] == ref
