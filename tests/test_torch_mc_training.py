"""The port's multi-channel training against the JAX package on the CPU, in
float32 at dropout 0: `mc_train_step`'s loss, gradient norm and gradients
against `make_mc_train_step` with the channels truncated to k = 3 and k = 2,
and `eval_step`'s loss and DER components against `make_mc_eval_step`. Then
the multi-channel recipe CLIs, in a subprocess with the JAX package
blocked, on a tiny 2-channel Kaldi directory: `recipes.diar_ssl_mc.run`
trains one epoch and validates (`-M validate` reads the epoch's validation
again), and `recipes.diar_ssl_mc.infer` averages the checkpoint, diarizes
and writes `der.json`; the fine-tune branch keeps the model's own fusions
when the checkpoint is single-channel."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from diarizen_tpu.models.conformer import ConformerConfig as JaxConformerConfig
from diarizen_tpu.models.mc import FusionConfig as JaxFusionConfig
from diarizen_tpu.models.mc import McEendConfig as JaxMcEendConfig
from diarizen_tpu.models.mc import init_eend_mc_params
from diarizen_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from diarizen_tpu.train.step import create_train_state as jax_create_train_state
from diarizen_tpu.train.step import make_mc_eval_step, make_mc_train_step
from diarizen_tpu_torch.config import load_toml
from diarizen_tpu_torch.core.audio import write_wav
from diarizen_tpu_torch.models import build
from diarizen_tpu_torch.models.convert import eend_mc_state_dict_from_jax, random_state_dict
from diarizen_tpu_torch.models.mc import McEendModel
from diarizen_tpu_torch.models.wavlm import WavLM, WavLMConfig
from diarizen_tpu_torch.recipes.diar_ssl.run import build_dataset
from diarizen_tpu_torch.recipes.diar_ssl_mc import run as mc_run
from diarizen_tpu_torch.train import TrainState, Trainer, TrainerConfig, eval_step, mc_train_step
from diarizen_tpu_torch.train.checkpoint import average_checkpoints, load_metrics, save_checkpoint
from diarizen_tpu_torch.train.dataset import DataLoader

from test_torch_mc import port_cfg
from test_torch_pretrained import TINY_WAVLM

ROOT = Path(__file__).resolve().parents[1]
NULL_GRADIENT = ("k_proj.bias", "linearK.bias", "depthwise_conv.bias")


def tiny_mc_cfg():
    """tests/test_mc_training.py's tiny multi-channel model, dropout 0."""
    n = 2
    wavlm = JaxWavLMConfig(
        conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)), embed_dim=64, num_layers=n,
        use_attention=(True,) * n, use_feed_forward=(True,) * n, total_num_heads=(4,) * n,
        remaining_heads=(tuple(range(4)),) * n, ff_interm_features=(128,) * n, num_buckets=40,
        max_distance=100, layer_drop=0.0, dropout=0.0, attention_dropout=0.0,
        projection_dropout=0.0)
    return JaxMcEendConfig(
        wavlm=wavlm, conformer=JaxConformerConfig(dim=32, ffn_hidden=64, num_heads=4,
                                                  num_layers=1, dropout=0.0),
        wavlm_layer_num=n + 1, wavlm_feat_dim=64, attention_in=32, chunk_size=0.125,
        fusion=JaxFusionConfig(hidden=16, num_heads=4, num_fusion_layers=2, dropout=0.0),
        num_channels=3)


@pytest.fixture(scope="module")
def jax_model():
    cfg = tiny_mc_cfg()
    params, state = init_eend_mc_params(jax.random.PRNGKey(0), cfg, cfg.fusion)
    rng = np.random.default_rng(1)
    # vectors moved off their init (the fusion norms off 1e-2), and the
    # extractor's output scale, which the port always has, as a parameter
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (0.3 * rng.standard_normal(x.shape).astype(np.float32)
                                   if np.ndim(x) == 1 else 0.0), params)
    params["wavlm"]["feature_extractor"]["output_scale"] = rng.uniform(0.5, 1.5, 32).astype(
        np.float32)
    state = jax.tree_util.tree_map(np.asarray, state)
    nf = cfg.num_frames(2000)
    batch = {"xs": (0.1 * rng.standard_normal((2, 3, 2000))).astype(np.float32),
             "target": (rng.uniform(size=(2, nf, 4)) > 0.5).astype(np.float32)}
    return cfg, params, state, batch


def port_model(cfg, params, state) -> McEendModel:
    model = McEendModel(port_cfg(cfg))
    model.load_state_dict(eend_mc_state_dict_from_jax(params, state, cfg), strict=True)
    return model


class CaptureGrads:
    """Optimizer stand-in: keeps the gradients the train step hands it."""

    def __init__(self, model):
        self.params = dict(model.named_parameters())

    def grads(self):
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params.values()]

    def step(self, grads, norm=None):
        self.captured = {name: g.clone() for name, g in zip(self.params, grads)}


def capture_transform() -> optax.GradientTransformation:
    """optax stand-in: its state after an update holds that update's
    gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, _s, _p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("k", [3, 2])
def test_mc_train_step_matches_jax(jax_model, k):
    cfg, params, state, batch = jax_model
    optimizer = capture_transform()
    step = jax.jit(make_mc_train_step(cfg, optimizer, compute_dtype=jnp.float32),
                   static_argnums=(3,))
    new_state, metrics = step(jax_create_train_state(params, state, optimizer),
                              jax.tree_util.tree_map(jnp.asarray, batch),
                              jax.random.PRNGKey(2), k)
    want = eend_mc_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, new_state.opt_state),
                                       jax.tree_util.tree_map(np.asarray, new_state.model_state),
                                       cfg)

    model = port_model(cfg, params, state)
    capture = CaptureGrads(model)
    m = mc_train_step(TrainState(model, capture), batch, seed=0, compute_dtype=torch.float32,
                      num_channels=k)
    assert not m["skipped"] and m["attention_layers"] == 2 and m["num_channels"] == k
    np.testing.assert_allclose(m["loss"], float(metrics["loss"]), rtol=1e-4)
    np.testing.assert_allclose(m["grad_norm"], float(metrics["grad_norm"]), rtol=1e-4)
    # each gradient within 1e-4 of its largest magnitude. Those that are zero
    # in exact arithmetic (attention key biases: softmax ignores a per-row
    # shift; the depthwise-conv bias before a BatchNorm on batch statistics)
    # are rounding noise of either sign on both sides: both below 1e-5 of
    # the global gradient norm
    assert set(capture.captured) <= set(want)
    for name, got in capture.captured.items():
        w = want[name].numpy()
        if name.endswith(NULL_GRADIENT):
            assert max(float(got.abs().max()), float(np.abs(w).max())) <= 1e-5 * m["grad_norm"]
            continue
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=f"grad of {name}")
    # the BatchNorm statistics moved as in JAX
    buffers = dict(model.named_buffers())
    for name in (k for k in buffers if k.endswith(("running_mean", "running_var"))):
        np.testing.assert_allclose(buffers[name].numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_mc_eval_step_matches_jax(jax_model):
    cfg, params, state, batch = jax_model
    want = make_mc_eval_step(cfg, compute_dtype=jnp.float32)(
        jax_create_train_state(params, state, optax.sgd(0.0)),
        jax.tree_util.tree_map(jnp.asarray, batch))
    got = eval_step(port_model(cfg, params, state), batch, compute_dtype=torch.float32)
    assert set(got) == set(want)
    for key in ("false_alarm", "missed_detection", "confusion", "speech_total", "num_chunks"):
        assert float(got[key]) == float(want[key]), key
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# the recipe CLIs

MC_TOML = """\
[meta]
save_dir = "{root}/exp"
seed = 7

[trainer]
path = "diarizen_tpu.train.trainer.Trainer"
[trainer.args]
max_epochs = 1
gradient_percentile = 90
compute_dtype = "float32"

[optimizer_small]
path = "optax.adamw"
[optimizer_small.args]
lr = 2e-5

[optimizer_big]
path = "optax.adamw"
[optimizer_big.args]
lr = 1e-3

[model]
path = "diarizen_tpu.models.build.wavlm_conformer_mc"
[model.args]
wavlm_src = "{wavlm_src}"
fusion_kind = "cross_attention"
num_fusion_layers = 2
fusion_hidden = 16
fusion_heads = 4
num_channels = 2
wavlm_layer_num = 4
wavlm_feat_dim = 64
attention_in = 32
ffn_hidden = 64
num_head = 4
num_layer = 1
chunk_size = 2
max_speakers_per_chunk = 4
{finetune}
[inference]
[inference.args]
seg_duration = 2
batch_size = 8

[clustering]
[clustering.args]
method = "AgglomerativeClustering"
ahc_threshold = 0.7
min_cluster_size = 2
max_speakers = 4

[train_dataset]
path = "diarizen_tpu.train.dataset.DiarizationDataset"
[train_dataset.args]
scp_file = "{root}/data/wav.scp"
rttm_file = "{root}/data/rttm"
uem_file = "{root}/data/all.uem"
chunk_size = 2
chunk_shift = 2
[train_dataset.dataloader]
batch_size = 4

[validate_dataset]
path = "diarizen_tpu.train.dataset.DiarizationDataset"
[validate_dataset.args]
scp_file = "{root}/data/wav.scp"
rttm_file = "{root}/data/rttm"
uem_file = "{root}/data/all.uem"
chunk_size = 2
chunk_shift = 2
[validate_dataset.dataloader]
batch_size = 4
"""

FINETUNE = """
[finetune]
finetune = true
checkpoints = ["{ckpt}"]
"""

# an import of jax, optax or the JAX package raises ImportError (a finder,
# not a None entry in sys.modules, which scipy's array-API probe would read)
_RUN_MC_RECIPES = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "optax", "diarizen_tpu"):
            raise ImportError(name + " is blocked")
sys.meta_path.insert(0, Block())
import json
from diarizen_tpu_torch.recipes.diar_ssl_mc import infer, run
root = sys.argv[1]
steps = []
trained = run.main(["-C", f"{root}/mc.toml", "-M", "train"], device="cpu", step_hook=steps.append)
validated = run.main(["-C", f"{root}/mc.toml", "-M", "validate"], device="cpu")
hyps = infer.main(["-C", f"{root}/mc.toml", "--exp_dir", f"{root}/exp/mc", "--wav_scp",
                   f"{root}/infer.scp", "--ref_rttm", f"{root}/data/rttm", "--out_dir",
                   f"{root}/out", "--num_channels", "2", "--avg_ckpt_num", "1"], device="cpu")
print(json.dumps({"trained": trained, "validated": validated, "steps": steps,
                  "speakers": {uri: ann.labels() for uri, ann in hyps.items()}}))
"""


def write_kaldi_dir(path: Path) -> None:
    """Two 12 s recordings on 2 microphones (the second attenuated and one
    sample late) of two overlapping tones, and a one-channel 4 s copy of the
    first one's start for inference (wrap-padded to 2 channels)."""
    path.mkdir()
    scp, rttm, uem = [], [], []
    t = np.arange(12 * 16000) / 16000
    rng = np.random.default_rng(3)
    for rec, freq in (("rec1", 220), ("rec2", 330)):
        wave = np.zeros((2, t.size), np.float32)
        for i, (spk, s, e) in enumerate([("A", 1.0, 5.0), ("B", 4.5, 9.0)]):
            m = (t >= s) & (t < e)
            tone = 0.2 * np.sin(2 * np.pi * freq * (1 + 0.5 * i) * t[m])
            wave[0, m] += tone
            wave[1, np.roll(m, 1)] += 0.7 * tone
            rttm.append(f"SPEAKER {rec} 1 {s:.2f} {e - s:.2f} <NA> <NA> {spk} <NA> <NA>")
        wave += 0.01 * rng.standard_normal(wave.shape).astype(np.float32)
        write_wav(path / f"{rec}.wav", wave, 16000)
        scp.append(f"{rec} {path / rec}.wav")
        uem.append(f"{rec} 1 0.0 12.0")
        if rec == "rec1":
            write_wav(path.parent / "rec1_mono.wav", wave[:1, : 4 * 16000], 16000)
    for name, lines in (("wav.scp", scp), ("rttm", rttm), ("all.uem", uem)):
        (path / name).write_text("\n".join(lines) + "\n")
    (path.parent / "infer.scp").write_text(f"rec1 {path.parent / 'rec1_mono.wav'}\n")


@pytest.fixture(scope="module")
def recipes(tmp_path_factory):
    root = tmp_path_factory.mktemp("mc_recipes")
    write_kaldi_dir(root / "data")
    wavlm_src = root / "wavlm_tiny.pt"
    torch.save({"config": TINY_WAVLM, "state_dict": random_state_dict(
        WavLM(WavLMConfig.from_reference_dict(TINY_WAVLM)), seed=5)}, wavlm_src)
    (root / "mc.toml").write_text(MC_TOML.format(root=root, wavlm_src=wavlm_src, finetune=""))
    proc = subprocess.run([sys.executable, "-c", _RUN_MC_RECIPES, str(root)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return root, wavlm_src, json.loads(proc.stdout.splitlines()[-1])


def test_mc_run_trains_and_validates(recipes):
    root, _, out = recipes
    metrics = load_metrics(root / "exp/mc")
    assert [m["epoch"] for m in metrics] == [0] and len(out["steps"]) == 2  # 10 chunks of 2 s
    assert all(np.isfinite(s["loss"]) and not s["skipped"] and s["attention_layers"] == 2
               for s in out["steps"])
    # the channels of each step: the recipe's sampler, seeded by [meta] seed
    draws = np.random.default_rng(7)
    drawn = [int(draws.integers(1, 3)) for _ in range(2)]
    assert [s["num_channels"] for s in out["steps"]] == drawn
    ckpt = root / "exp/mc/checkpoints/epoch_0000/pytorch_model.bin"
    assert "channel_fusions.1.linearQ.weight" in torch.load(ckpt)
    # -M validate resumes the trained checkpoint: the epoch's validation again
    for k in ("loss", "der"):
        assert np.isfinite(out["validated"][k])
        np.testing.assert_allclose(out["validated"][k], metrics[0][k], rtol=1e-5)


def test_mc_infer_writes_rttm_and_der(recipes):
    root, _, out = recipes
    der = json.loads((root / "out/der.json").read_text())
    assert set(der["files"]) == {"rec1"} and np.isfinite(der["der"])
    lines = (root / "out/rec1.rttm").read_text().splitlines()
    assert lines and all(line.startswith("SPEAKER rec1 1 ") for line in lines)
    assert len(out["speakers"]["rec1"]) >= 1


def test_mc_finetune_keeps_fusions_of_a_single_channel_checkpoint(recipes, tmp_path):
    root, wavlm_src, _ = recipes
    # a single-channel checkpoint of the same trunk and head
    config = load_toml(root / "mc.toml")
    args = dict(config["model"]["args"])
    for key in ("fusion_kind", "num_fusion_layers", "fusion_hidden", "fusion_heads"):
        args.pop(key)
    _, single = build.wavlm_conformer(**args, seed=11)
    save_checkpoint(tmp_path / "single", 0, single.state_dict())
    ckpt = tmp_path / "single/epoch_0000"
    text = MC_TOML.format(root=tmp_path, wavlm_src=wavlm_src, finetune=FINETUNE.format(ckpt=ckpt))
    text = text.replace(f"{tmp_path}/data", f"{root}/data")
    (tmp_path / "ft.toml").write_text(text)
    got = mc_run.main(["-C", str(tmp_path / "ft.toml"), "-M", "validate"], device="cpu")

    # what it validated: the single-channel weights, the fusions as built
    cfg, model = build.wavlm_conformer_mc(**config["model"]["args"], seed=7)
    fusions = {k: v for k, v in model.state_dict().items() if k.startswith("channel_fusions.")}
    model.load_state_dict({**fusions, **average_checkpoints([ckpt])}, strict=True)
    trainer = Trainer(model, TrainerConfig(exp_dir=str(tmp_path / "check"),
                                           compute_dtype="float32"), None, device="cpu")
    want = trainer.validate(DataLoader(
        build_dataset(config["validate_dataset"], cfg, num_channels=2,
                      channel_mode="multichannel"), batch_size=4, shuffle=False))
    assert got == want
