"""The port's training and pruning recipe CLIs, end to end on a tiny model,
run in a subprocess with the JAX package blocked: `recipes.diar_ssl.run`
trains one epoch and validates, `get_wavlm_from_finetuned` takes the WavLM
trunk out of that experiment, `run_distill_prune` distill-prunes a
reference-format teacher file for two epochs and `apply_pruning` collapses
the gates of its two checkpoints. Then the JAX package reads what the port
wrote (`params.npz` with its `load_pytree`, `config.json` with
`WavLMConfig(**json)`): its forward equals the port's, and `report.json`
equals what the JAX package's surgery gives on the same averaged
checkpoint. The pruning TOMLs resolve to the port with jax blocked."""

import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diarizen_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from diarizen_tpu.models.wavlm import count_macs as jax_count_macs
from diarizen_tpu.models.wavlm import wavlm_extract_features
from diarizen_tpu.prune import apply_pruning as jax_apply_pruning
from diarizen_tpu.prune import count_params_pytree as jax_count_params
from diarizen_tpu.train.checkpoint import load_pytree as jax_load_pytree
from diarizen_tpu_torch.core.audio import write_wav
from diarizen_tpu_torch.models.convert import (
    _flatten,
    load_pytree,
    wavlm_params_to_jax,
    wavlm_state_dict_from_jax,
)
from diarizen_tpu_torch.models.wavlm import WavLM, WavLMConfig
from diarizen_tpu_torch.models.convert import random_state_dict
from diarizen_tpu_torch.prune.distill import split_distill_state_dict
from diarizen_tpu_torch.prune.gates import map_gates
from diarizen_tpu_torch.train.checkpoint import average_checkpoints, load_metrics

from test_torch_pretrained import TINY_WAVLM

ROOT = Path(__file__).resolve().parents[1]


def _jax_recipe_function(path: str, name: str):
    spec = importlib.util.spec_from_file_location(f"jax_recipe_{Path(path).stem}", ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, name)


jax_select_post_peak = _jax_recipe_function("recipes/diar_ssl_pruning/apply_pruning.py",
                                            "select_post_peak")

_BLOCK_JAX = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["diarizen_tpu"] = None
sys.modules["optax"] = None
"""

_RUN_RECIPES = _BLOCK_JAX + """
import json
from diarizen_tpu_torch.recipes.diar_ssl import run
from diarizen_tpu_torch.recipes.diar_ssl_pruning import (
    apply_pruning, get_wavlm_from_finetuned, run_distill_prune)
root, teacher = sys.argv[1], sys.argv[2]
steps = []
trained = run.main(["-C", f"{root}/finetune.toml", "-M", "train"], device="cpu",
                   step_hook=steps.append)
validated = run.main(["-C", f"{root}/finetune.toml", "-M", "validate"], device="cpu")
get_wavlm_from_finetuned.main(["--exp_dir", f"{root}/exp/finetune", "--wavlm_src", teacher,
                               "--out_dir", f"{root}/trunk", "--avg_ckpt_num", "1"])
distill = []
run_distill_prune.main(["-C", f"{root}/prune.toml"], device="cpu", step_hook=distill.append)
report = apply_pruning.main(["-C", f"{root}/prune.toml", "--out_dir", f"{root}/pruned",
                             "--avg_ckpt_num", "2"])
print(json.dumps({"trained": trained, "validated": validated, "steps": steps,
                  "distill": distill, "report": report}))
"""

FINETUNE_TOML = """\
[meta]
save_dir = "{root}/exp"
seed = 7

[trainer]
path = "diarizen_tpu.train.trainer.Trainer"
[trainer.args]
max_epochs = 1
gradient_percentile = 90
max_num_checkpoints = 5

[optimizer_small]
path = "optax.adamw"
[optimizer_small.args]
lr = 2e-5

[optimizer_big]
path = "optax.adamw"
[optimizer_big.args]
lr = 1e-3

[model]
path = "diarizen_tpu.models.build.wavlm_conformer"
[model.args]
wavlm_src = "{teacher}"
wavlm_layer_num = 4
wavlm_feat_dim = 64
attention_in = 32
ffn_hidden = 64
num_head = 4
num_layer = 1
chunk_size = 2

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

# s80_base.toml's layout, cut to the tiny teacher, two epochs, warm-up in one
PRUNE_TOML = """\
[meta]
save_dir = "{root}/exp"
seed = 3407

[trainer]
path = "diarizen_tpu.prune.distill"
[trainer.args]
max_epochs = 2
target_sparsity = 0.8
sparsity_warmup_epochs = 1
pre_train_epochs = 0
distill_layers = [0, 1, 2, 3]
l2_weight = 0.0
l1_weight = 1.0
cos_weight = 1.0
distill_lr = 2e-4
reg_lr = 2e-2
max_num_checkpoints = 100

[model]
path = "diarizen_tpu.models.build.wavlm_conformer"
[model.args]
wavlm_src = "{teacher}"
prune_attention_heads = true
prune_attention_layer = true
prune_feed_forward_intermediate = true
prune_feed_forward_layer = true
prune_conv_channels = true

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
"""


def write_kaldi_dir(path: Path) -> None:
    """Two 12 s recordings of two and three overlapping tones."""
    path.mkdir()
    scp, rttm, uem = [], [], []
    t = np.arange(12 * 16000) / 16000
    for rec, freq in (("rec1", 220), ("rec2", 330)):
        wave = np.zeros_like(t, dtype=np.float32)
        turns = [("A", 1.0, 5.0), ("B", 4.5, 9.0)] + ([("C", 8.0, 10.0)] if rec == "rec2" else [])
        for i, (spk, s, e) in enumerate(turns):
            m = (t >= s) & (t < e)
            wave[m] += 0.2 * np.sin(2 * np.pi * freq * (1 + 0.5 * i) * t[m]).astype(np.float32)
            rttm.append(f"SPEAKER {rec} 1 {s:.2f} {e - s:.2f} <NA> <NA> {spk} <NA> <NA>")
        write_wav(path / f"{rec}.wav", wave[None], 16000)
        scp.append(f"{rec} {path / rec}.wav")
        uem.append(f"{rec} 1 0.0 12.0")
    for name, lines in (("wav.scp", scp), ("rttm", rttm), ("all.uem", uem)):
        (path / name).write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def recipes(tmp_path_factory):
    root = tmp_path_factory.mktemp("prune_recipes")
    write_kaldi_dir(root / "data")
    teacher = root / "wavlm_tiny.pt"
    torch.save({"config": TINY_WAVLM, "state_dict": random_state_dict(
        WavLM(WavLMConfig.from_reference_dict(TINY_WAVLM)), seed=5)}, teacher)
    for name, text in (("finetune", FINETUNE_TOML), ("prune", PRUNE_TOML)):
        (root / f"{name}.toml").write_text(text.format(root=root, teacher=teacher))
    proc = subprocess.run([sys.executable, "-c", _RUN_RECIPES, str(root), str(teacher)],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return root, teacher, json.loads(proc.stdout.splitlines()[-1])


def port_wavlm(params: dict, cfg: WavLMConfig) -> WavLM:
    model = WavLM(cfg)
    model.load_state_dict(wavlm_state_dict_from_jax(params, cfg), strict=True)
    return model


def assert_forward_matches_jax(params_path: Path, config_path: Path) -> None:
    """The JAX package's forward of what the port wrote equals the port's
    forward of the same files, within 1e-4."""
    params = jax_load_pytree(params_path)
    jax_cfg = JaxWavLMConfig(**json.loads(config_path.read_text()))
    cfg = WavLMConfig.from_dict(json.loads(config_path.read_text()))
    wave = (0.1 * np.random.default_rng(0).standard_normal((2, 4000))).astype(np.float32)
    want = wavlm_extract_features(params, jax_cfg, jnp.asarray(wave))
    with torch.no_grad():
        got = port_wavlm(load_pytree(params_path), cfg).hidden_states(torch.from_numpy(wave))
    assert len(got) == len(want) == cfg.num_layers + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_finetune_run_trains_and_validates(recipes):
    root, _, out = recipes
    metrics = load_metrics(root / "exp/finetune")
    assert [m["epoch"] for m in metrics] == [0] and len(out["steps"]) == 2  # 10 chunks of 2 s
    assert all(np.isfinite(s["loss"]) and not s["skipped"] for s in out["steps"])
    assert (root / "exp/finetune/checkpoints/epoch_0000/pytorch_model.bin").exists()
    # -M validate resumes the trained checkpoint: the epoch's validation again
    for k in ("loss", "der"):
        assert np.isfinite(out["validated"][k])
        np.testing.assert_allclose(out["validated"][k], metrics[0][k], rtol=1e-5)


def test_trunk_from_finetuned_reads_in_jax(recipes):
    root, teacher, _ = recipes
    ckpt = average_checkpoints([root / "exp/finetune/checkpoints/epoch_0000"])
    trunk = {k[len("wavlm_model."):]: v for k, v in ckpt.items() if k.startswith("wavlm_model.")}
    cfg = WavLMConfig.from_reference_dict(TINY_WAVLM)
    written = _flatten(jax_load_pytree(root / "trunk/params.npz"))
    carried = _flatten(wavlm_params_to_jax(trunk, cfg))
    assert written.keys() == carried.keys()
    assert all(np.array_equal(written[k], carried[k]) for k in carried)
    assert JaxWavLMConfig(**json.loads((root / "trunk/config.json").read_text())).num_layers == 3
    assert_forward_matches_jax(root / "trunk/params.npz", root / "trunk/config.json")


def test_distill_prune_run(recipes):
    root, _, out = recipes
    metrics = load_metrics(root / "exp/prune")
    assert [m["epoch"] for m in metrics] == [0, 1] and len(out["distill"]) == 4
    assert all(np.isfinite(m["loss"]) and not m["skipped"] for m in out["distill"])
    # warmed over one epoch of two steps
    np.testing.assert_allclose([m["sparsity_target"] for m in out["distill"]],
                               [0.0, 0.4, 0.8, 0.8], rtol=1e-6)
    assert out["distill"][-1]["lambda1"] != 0.0 and out["distill"][0]["loss_distill"] < -0.5
    ckpt = torch.load(root / "exp/prune/checkpoints/epoch_0001/pytorch_model.bin")
    assert {"lambdas", "log_alphas.conv.0", "log_alphas.layers.0.heads",
            "student.encoder.feature_projection.projection.weight"} <= set(ckpt)


def test_pruned_model_reads_in_jax_and_report_matches(recipes):
    root, _, out = recipes
    report = json.loads((root / "pruned/report.json").read_text())
    ckpt_root = root / "exp/prune/checkpoints"
    selected = jax_select_post_peak(load_metrics(root / "exp/prune"), ckpt_root, num=2)
    assert report == out["report"] and report["checkpoints"] == [c.name for c in selected]
    assert_forward_matches_jax(root / "pruned/params.npz", root / "pruned/config.json")

    # the JAX package's surgery on the same averaged checkpoint, carried across
    cfg = WavLMConfig.from_reference_dict(TINY_WAVLM)
    avg = average_checkpoints(selected)
    student, log_alphas, _ = split_distill_state_dict(avg, cfg.num_layers)
    params = wavlm_params_to_jax(student, cfg)
    jax_cfg = JaxWavLMConfig(**dataclasses.asdict(cfg))
    pruned, pruned_cfg = jax_apply_pruning(params, jax_cfg,
                                           map_gates(lambda la: la.numpy(), log_alphas))
    before, after = jax_count_params(params), jax_count_params(pruned)
    assert report == {
        "original_params_M": before / 1e6, "pruned_params_M": after / 1e6,
        "sparsity": 1 - after / before,
        "original_macs_G_per_s": jax_count_macs(jax_cfg) / 1e9,
        "pruned_macs_G_per_s": jax_count_macs(pruned_cfg) / 1e9,
        "checkpoints": report["checkpoints"],
    }
    written = json.loads((root / "pruned/config.json").read_text())
    assert written == json.loads(json.dumps(dataclasses.asdict(pruned_cfg)))
    carried = _flatten(jax_load_pytree(root / "pruned/params.npz"))
    want = _flatten(pruned)
    assert carried.keys() == want.keys()
    assert all(np.array_equal(carried[k], want[k]) for k in want)


_RESOLVE_PRUNING = _BLOCK_JAX + """
import types
from diarizen_tpu_torch import config
for conf in sys.argv[1:]:
    c = config.load_toml(conf)
    for section in ("trainer", "model"):
        target = config.resolve(c[section]["path"])
        name = target.__name__ if isinstance(target, types.ModuleType) else target.__module__
        assert name.startswith("diarizen_tpu_torch."), (conf, section, name)
        print(conf, section, name)
for path in ("diarizen.models.pruning.model_distill_prune.Model",
             "diarizen.models.pruning.utils.DistillLoss"):
    print(path, config.resolve(path).__module__)
"""


def test_pruning_tomls_resolve_to_the_port_without_jax():
    confs = sorted(str(p) for p in (ROOT / "recipes/diar_ssl_pruning/conf").glob("s80_*.toml"))
    assert len(confs) == 2
    proc = subprocess.run([sys.executable, "-c", _RESOLVE_PRUNING, *confs], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = [line.split()[-1] for line in proc.stdout.splitlines()]
    assert lines == ["diarizen_tpu_torch.prune.distill", "diarizen_tpu_torch.models.build"] * 2 + [
        "diarizen_tpu_torch.models.build", "diarizen_tpu_torch.prune.distill"]
