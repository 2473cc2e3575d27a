"""The port's recipe entry point and what it reads: the repository's recipe
TOMLs build the port's model with the JAX package blocked, and
`python -m diarizen_tpu_torch.recipes.diar_ssl.infer` averages an
experiment's checkpoints, diarizes a wav.scp of a WAV and a FLAC file, and
writes the RTTMs of the port's pipeline on the averaged weights and a
`der.json` equal to the JAX package's `der_report` on those RTTMs."""

import json
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from diarizen_tpu.core.io_rttm import load_rttm as jax_load_rttm
from diarizen_tpu.core.segments import Annotation as JaxAnnotation
from diarizen_tpu.core.segments import Segment as JaxSegment
from diarizen_tpu.ops.der import DERReport as JaxDERReport
from diarizen_tpu.ops.der import der_report as jax_der_report
from diarizen_tpu_torch import config, pipelines
from diarizen_tpu_torch.cluster import AgglomerativeClustering
from diarizen_tpu_torch.core.audio import read_audio
from diarizen_tpu_torch.infer import DiarizationPipeline, EmbeddingInference, SlidingInference
from diarizen_tpu_torch.models import build
from diarizen_tpu_torch.models.convert import random_state_dict
from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig
from diarizen_tpu_torch.models.wavlm import WavLM, WavLMConfig
from diarizen_tpu_torch.recipes.diar_ssl import infer
from diarizen_tpu_torch.train.checkpoint import append_metrics, save_checkpoint

from flac_ref_encoder import encode_flac
from test_torch_pretrained import TINY_WAVLM, make_wave

ROOT = Path(__file__).resolve().parents[1]

_BUILD_RECIPES = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["diarizen_tpu"] = None
sys.modules["optax"] = None
from diarizen_tpu_torch import config
for conf in sys.argv[1:]:
    c = config.load_toml(conf)
    paths = [sec["path"] for sec in c.values() if isinstance(sec, dict) and "path" in sec]
    targets = [config.resolve(p) for p in paths]
    assert all(t.__module__.startswith("diarizen_tpu_torch.") for t in targets), targets
    cfg, model = config.instantiate_section(c, "model")
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(conf.rsplit("/", 1)[-1], len(paths), type(model).__name__, trainable)
"""

# each shipped TOML's model class and trainable parameters: WavLM-Base +
# Conformer above 90 M; the Fbank + Conformer and SincNet-BiLSTM baselines
# as many as the JAX package's builders make (6,115,851 and 1,469,765)
SHIPPED_MODELS = {
    "fbank_conformer.toml": ("FbankEendModel", 6_115_851),
    "pyannote_baseline.toml": ("SincNetEendModel", 1_469_765),
    "wavlm_frozen_conformer.toml": ("EendModel", None),
    "wavlm_updated_conformer.toml": ("EendModel", None),
}


def test_recipe_tomls_build_the_port_model_without_jax():
    confs = sorted(str(p) for p in (ROOT / "recipes/diar_ssl/conf").glob("*.toml"))
    assert [Path(c).name for c in confs] == sorted(SHIPPED_MODELS)
    proc = subprocess.run([sys.executable, "-c", _BUILD_RECIPES, *confs], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [line.split() for line in proc.stdout.splitlines()]
    assert [line[0] for line in lines] == sorted(SHIPPED_MODELS)
    for name, paths, model, trainable in lines:
        want_model, want_params = SHIPPED_MODELS[name]
        assert model == want_model and int(paths) >= 5, name
        if want_params is None:
            assert int(trainable) > 90_000_000, name
        else:
            assert int(trainable) == want_params, name


RECIPE_TOML = """\
[model]
path = "diarizen_tpu.models.build.wavlm_conformer"
[model.args]
wavlm_src = "{wavlm_src}"
wavlm_layer_num = 4
wavlm_feat_dim = 64
attention_in = 32
ffn_hidden = 64
num_head = 4
num_layer = 1
chunk_size = 2
max_speakers_per_chunk = 4

[inference]
[inference.args]
seg_duration = 2
batch_size = 5
apply_median_filtering = true

[clustering]
[clustering.args]
method = "AgglomerativeClustering"
ahc_threshold = 0.62
min_cluster_size = 4
min_speakers = 1
max_speakers = 5
"""


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """An experiment directory with two checkpoints and their metrics, the
    recipe TOML, a ResNet34 checkpoint, and a wav.scp of one WAV and one
    FLAC file of 3 s."""
    root = tmp_path_factory.mktemp("recipe")
    wavlm_src = root / "wavlm_tiny.pt"
    wavlm = WavLM(WavLMConfig.from_reference_dict(TINY_WAVLM))
    torch.save({"config": TINY_WAVLM, "state_dict": random_state_dict(wavlm, seed=5)}, wavlm_src)
    (root / "conf.toml").write_text(RECIPE_TOML.format(wavlm_src=wavlm_src))
    _, model = build.wavlm_conformer(
        wavlm_src=str(wavlm_src), wavlm_layer_num=4, wavlm_feat_dim=64, attention_in=32,
        ffn_hidden=64, num_head=4, num_layer=1, chunk_size=2)
    exp = root / "exp"
    exp.mkdir()
    for epoch, loss in ((0, 0.9), (1, 0.7), (2, 0.8)):
        sd = random_state_dict(model, seed=20 + epoch)
        sd["classifier.weight"] = sd["classifier.weight"] * 100.0  # decisions far from ties
        save_checkpoint(exp / "checkpoints", epoch, sd)
        append_metrics(exp, {"epoch": epoch, "loss": loss})
    resnet_ckpt = root / "resnet34.bin"
    torch.save({"state_dict": random_state_dict(ResNet(ResNetConfig()), seed=1)}, resnet_ckpt)

    samples = np.rint(make_wave(3.0) * 32768.0).astype(np.int64)
    with wave.open(str(root / "a.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(samples[0].astype("<i2").tobytes())
    (root / "b.flac").write_bytes(encode_flac(-samples, 16000))
    (root / "wav.scp").write_text(f"a {root / 'a.wav'}\nb {root / 'b.flac'}\n")
    return root


def _run(root, out, *extra):
    """The recipe CLI on the experiment, averaging the two best epochs."""
    return infer.main(["-C", str(root / "conf.toml"), "--exp_dir", str(root / "exp"),
                       "--wav_scp", str(root / "wav.scp"), "--out_dir", str(out),
                       "--avg_ckpt_num", "2", "--embedding_ckpt", str(root / "resnet34.bin"),
                       *extra], device="cpu")


def test_infer_cli_averages_and_scores_like_jax(experiment, tmp_path, capsys):
    root = experiment
    # the port's pipeline on the averaged weights of the two best epochs
    model_section = config.load_toml(root / "conf.toml")["model"]
    cfg, model = config.instantiate_model_for_inference(model_section["path"],
                                                        model_section["args"])
    sds = [torch.load(root / f"exp/checkpoints/epoch_000{e}/pytorch_model.bin") for e in (1, 2)]
    model.load_state_dict({k: ((sds[0][k].double() + sds[1][k].double()) / 2).float()
                           if sds[0][k].is_floating_point() else sds[0][k] for k in sds[0]})
    seg = SlidingInference(model, duration=2.0, step=0.2, batch_size=5, device="cpu")
    pipe = DiarizationPipeline(
        seg, EmbeddingInference(pipelines.load_resnet(root / "resnet34.bin"), seg.window_size,
                                num_speakers=4, batch_size=5, device="cpu"),
        AgglomerativeClustering(threshold=0.62, min_cluster_size=4), cfg, max_speakers=5)
    texts = {uri: pipe(read_audio(root / name)[0], 16000, uri=uri).to_rttm()
             for uri, name in (("a", "a.wav"), ("b", "b.flac"))}
    assert all(text.count("SPEAKER") > 0 for text in texts.values())

    # the reference: those RTTMs relabelled, every other turn left out
    ref_text = "".join(texts.values()).replace("SPEAKER_00", "ref0").replace("SPEAKER_01", "ref1")
    (tmp_path / "ref.rttm").write_text("\n".join(ref_text.splitlines()[::2]) + "\n")
    out = tmp_path / "out"
    hyps = _run(root, out, "--ref_rttm", str(tmp_path / "ref.rttm"))
    assert "averaged 2 checkpoints: ['epoch_0001', 'epoch_0002']" in capsys.readouterr().out
    assert (out / "infer.log").exists()
    for uri in ("a", "b"):
        assert (out / f"{uri}.rttm").read_text() == texts[uri] == hyps[uri].to_rttm()

    # der.json holds the JAX package's numbers on the same annotations
    got = json.loads((out / "der.json").read_text())
    refs, total = jax_load_rttm(tmp_path / "ref.rttm"), JaxDERReport(0.0, 0.0, 0.0, 0.0)
    assert set(got["files"]) == set(refs) == {"a", "b"}
    for uri in ("a", "b"):
        hyp = JaxAnnotation(uri=uri)  # the hypothesis as scored: before RTTM's rounding
        for segment, track, label in hyps[uri].itertracks():
            hyp[JaxSegment(segment.start, segment.end), track] = label
        r = jax_der_report(refs[uri], hyp)
        assert got["files"][uri] == {"der": r.der, "fa": r.false_alarm,
                                     "miss": r.missed_detection, "conf": r.confusion,
                                     "total": r.total}
        total = total + r
    assert got["der"] == total.der > 0
    assert set(got) == {"der", "false_alarm", "missed_detection", "confusion", "files"}
    assert got["false_alarm"] == total.false_alarm / total.total


def test_infer_cli_refuses_without_checkpoints(experiment, tmp_path):
    argv = ["-C", str(experiment / "conf.toml"), "--exp_dir", str(tmp_path),
            "--wav_scp", str(experiment / "wav.scp"), "--out_dir", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="no checkpoints selected"):
        infer.main(argv, device="cpu")
