"""The Fbank + Conformer and SincNet-BiLSTM families through the port's entry
points on the CPU. The repository's `fbank_conformer.toml` and
`pyannote_baseline.toml` (data paths, epochs, batch sizes and chunk size
overridden; the Conformer cut to 1 x 32) train one epoch with
`recipes.diar_ssl.run`, validate with `-M validate` (which must read the
epoch's validation again), and `recipes.diar_ssl.infer` averages the
checkpoint, diarizes and scores, in a subprocess with the JAX package
blocked. Then a snapshot directory of each family whose `params.npz` the
JAX package wrote: the port's `from_pretrained` gives the JAX package's
float32 RTTM exactly, on 201- and 115-frame windows."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diarizen_tpu import config as jax_config
from diarizen_tpu.core import audio as jax_audio
from diarizen_tpu.infer import SlidingInference as JaxSlidingInference
from diarizen_tpu.pipelines import from_pretrained as jax_from_pretrained
from diarizen_tpu.train.checkpoint import save_pytree as jax_save_pytree
from diarizen_tpu_torch import config, pipelines
from diarizen_tpu_torch.core.audio import write_wav
from diarizen_tpu_torch.models.fbank_eend import FbankEendModel
from diarizen_tpu_torch.models.sincnet_eend import SincNetEendModel
from diarizen_tpu_torch.train.checkpoint import load_metrics

from test_torch_pretrained import SR, make_wave

ROOT = Path(__file__).resolve().parents[1]
CONF = ROOT / "recipes/diar_ssl/conf"
FAMILIES = {  # TOML stem: (model class, overrides of its [model.args])
    "fbank_conformer": (FbankEendModel, {"attention_in": 32, "ffn_hidden": 64, "num_head": 4,
                                         "num_layer": 1, "chunk_size": 2}),
    "pyannote_baseline": (SincNetEendModel, {"chunk_size": 2}),
}


def write_kaldi_dir(path: Path) -> None:
    """Two 12 s recordings of two overlapping tones each, mono, and a 4 s
    copy of the first one's start for inference."""
    path.mkdir()
    scp, rttm, uem = [], [], []
    t = np.arange(12 * SR) / SR
    rng = np.random.default_rng(3)
    for rec, freq in (("rec1", 220), ("rec2", 330)):
        wave = 0.01 * rng.standard_normal(t.size)
        for i, (spk, s, e) in enumerate([("A", 1.0, 5.0), ("B", 4.5, 9.0)]):
            m = (t >= s) & (t < e)
            wave[m] += 0.2 * np.sin(2 * np.pi * freq * (1 + 0.5 * i) * t[m])
            rttm.append(f"SPEAKER {rec} 1 {s:.2f} {e - s:.2f} <NA> <NA> {spk} <NA> <NA>")
        write_wav(path / f"{rec}.wav", wave[None].astype(np.float32), SR)
        scp.append(f"{rec} {path / rec}.wav")
        uem.append(f"{rec} 1 0.0 12.0")
        if rec == "rec1":
            write_wav(path.parent / "rec1_short.wav", wave[None, : 4 * SR].astype(np.float32), SR)
    for name, lines in (("wav.scp", scp), ("rttm", rttm), ("all.uem", uem)):
        (path / name).write_text("\n".join(lines) + "\n")
    (path.parent / "infer.scp").write_text(f"rec1 {path.parent / 'rec1_short.wav'}\n")


# an import of jax, optax or the JAX package raises ImportError (a finder,
# not a None entry in sys.modules, which scipy's array-API probe would read)
_RUN_RECIPES = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "optax", "diarizen_tpu"):
            raise ImportError(name + " is blocked")
sys.meta_path.insert(0, Block())
import json
from diarizen_tpu_torch.recipes.diar_ssl import infer, run
root = sys.argv[1]
out = {}
for stem in sys.argv[2:]:
    conf = f"{root}/{stem}.toml"
    steps = []
    trained = run.main(["-C", conf, "-M", "train"], device="cpu", step_hook=steps.append)
    validated = run.main(["-C", conf, "-M", "validate"], device="cpu")
    hyps = infer.main(["-C", conf, "--exp_dir", f"{root}/exp/{stem}", "--wav_scp",
                       f"{root}/infer.scp", "--ref_rttm", f"{root}/data/rttm", "--out_dir",
                       f"{root}/out_{stem}", "--avg_ckpt_num", "1"], device="cpu")
    out[stem] = {"trained": trained, "validated": validated, "steps": steps,
                 "speakers": {uri: ann.labels() for uri, ann in hyps.items()}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def recipes(tmp_path_factory):
    root = tmp_path_factory.mktemp("family_recipes")
    write_kaldi_dir(root / "data")
    data = {f"{section}.args.{key}": str(root / "data" / name)
            for section in ("train_dataset", "validate_dataset")
            for key, name in (("scp_file", "wav.scp"), ("rttm_file", "rttm"),
                              ("uem_file", "all.uem"))}
    for stem, (_, model_args) in FAMILIES.items():
        overrides = {
            "meta.save_dir": str(root / "exp"), "trainer.args.max_epochs": 1,
            "trainer.args.compute_dtype": "float32", "inference.args.seg_duration": 2,
            "inference.args.batch_size": 8, "clustering.args.min_cluster_size": 2,
            **{f"{s}.args.chunk_size": 2 for s in ("train_dataset", "validate_dataset")},
            **{f"{s}.args.chunk_shift": 2 for s in ("train_dataset", "validate_dataset")},
            **{f"{s}.dataloader.batch_size": 4 for s in ("train_dataset", "validate_dataset")},
            **{f"model.args.{k}": v for k, v in model_args.items()}, **data}
        config.dump_toml(config.apply_overrides(config.load_toml(CONF / f"{stem}.toml"),
                                                overrides), root / f"{stem}.toml")
    proc = subprocess.run([sys.executable, "-c", _RUN_RECIPES, str(root), *FAMILIES], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return root, json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("stem", list(FAMILIES))
def test_recipe_trains_and_validates(recipes, stem):
    root, out = recipes
    run = out[stem]
    metrics = load_metrics(root / "exp" / stem)
    # 10 chunks of 2 s in batches of 4, the last one dropped (`drop_last`)
    assert [m["epoch"] for m in metrics] == [0] and len(run["steps"]) == 2
    assert all(np.isfinite(s["loss"]) and not s["skipped"] and s["attention_layers"] == 0
               for s in run["steps"])
    model_class = FAMILIES[stem][0]
    cfg, model = config.instantiate_section(config.load_toml(root / f"{stem}.toml"), "model")
    assert isinstance(model, model_class)
    ckpt = torch.load(root / "exp" / stem / "checkpoints/epoch_0000/pytorch_model.bin")
    model.load_state_dict(ckpt, strict=True)
    # the LSTMs' second bias stays zero: the JAX layer has one bias
    assert all(not v.any() for k, v in ckpt.items() if ".bias_hh_l0" in k)
    # -M validate resumes the trained checkpoint: the epoch's validation again
    for k in ("loss", "der"):
        assert np.isfinite(run["validated"][k])
        np.testing.assert_allclose(run["validated"][k], metrics[0][k], rtol=1e-5)


@pytest.mark.parametrize("stem", list(FAMILIES))
def test_recipe_infer_writes_rttm_and_der(recipes, stem):
    root, out = recipes
    der = json.loads((root / f"out_{stem}" / "der.json").read_text())
    assert set(der["files"]) == {"rec1"} and np.isfinite(der["der"])
    lines = (root / f"out_{stem}" / "rec1.rttm").read_text().splitlines()
    assert all(line.startswith("SPEAKER rec1 1 ") for line in lines)
    assert lines and len(out[stem]["speakers"]["rec1"]) >= 1


# the hub snapshot's schema with the reference's own class paths
SNAPSHOT_TOML = """\
[model]
path = "{path}"
[model.args]
{args}

[inference]
[inference.args]
seg_duration = 2
segmentation_step = 0.2
batch_size = 5
apply_median_filtering = true

[clustering]
[clustering.args]
method = "AgglomerativeClustering"
min_speakers = 1
max_speakers = 5
min_cluster_size = 4
ahc_threshold = 0.62
"""
SNAPSHOTS = {
    "fbank_conformer": ("diarizen.models.eend.model_fbank_conformer.Model",
                        FAMILIES["fbank_conformer"][1]),
    "pyannote_baseline": ("diarizen.models.eend.model_pyannote.Model", {"chunk_size": 2}),
}


@pytest.fixture(scope="module")
def npz_snapshots(tmp_path_factory):
    """{family: snapshot directory with config.toml and a params.npz that the
    JAX package wrote}, a ResNet34 checkpoint and a wav file."""
    from diarizen_tpu_torch.models.convert import random_state_dict
    from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig

    root = tmp_path_factory.mktemp("family_snapshots")
    resnet_ckpt = root / "resnet34.bin"
    torch.save({"state_dict": random_state_dict(ResNet(ResNetConfig()), seed=1)}, resnet_ckpt)
    dirs = {}
    for stem, (path, args) in SNAPSHOTS.items():
        snap = root / stem
        snap.mkdir()
        (snap / "config.toml").write_text(SNAPSHOT_TOML.format(
            path=path, args="\n".join(f"{k} = {v}" for k, v in args.items())))
        _, params, _ = jax_config.instantiate(path, {**args, "seed": 7})
        params = jax.tree_util.tree_map(np.asarray, params)
        params["classifier"]["w"] = params["classifier"]["w"] * 100.0  # decisions far from ties
        jax_save_pytree(snap / "params.npz", params)
        dirs[stem] = snap
    wav = root / "meeting.wav"
    write_wav(wav, make_wave(), SR)
    return dirs, resnet_ckpt, wav


@pytest.mark.parametrize("stem", list(SNAPSHOTS))
def test_params_npz_rttm_identical_to_jax(npz_snapshots, stem):
    dirs, resnet_ckpt, wav = npz_snapshots
    pipe = pipelines.from_pretrained(dirs[stem], embedding_ckpt=resnet_ckpt, device="cpu")
    pipe.seg_inference.compute_dtype = torch.float32
    model = pipe.seg_inference.model
    assert isinstance(model, FAMILIES[stem][0])
    assert pipe.seg_inference._frames_per_chunk == {"fbank_conformer": 201,
                                                    "pyannote_baseline": 115}[stem]

    ref = jax_from_pretrained(dirs[stem], embedding_ckpt=resnet_ckpt)
    old = ref.seg_inference
    ref.seg_inference = JaxSlidingInference(
        old._params, old._state, old.cfg, duration=old.duration, step=old.step,
        batch_size=old.batch_size, compute_dtype=jnp.float32)
    ref.fused_stitch = False
    # the port's weights are the snapshot's
    np.testing.assert_array_equal(model.classifier.weight.detach().numpy(),
                                  np.asarray(old._params["classifier"]["w"]).T)
    wave, sr = jax_audio.read_audio(wav)
    expected = ref(wave, sr, uri="meeting").to_rttm()
    assert len(expected.splitlines()) > 1
    assert pipelines.diarize_file(pipe, wav).to_rttm() == expected
