"""The port stands alone: it imports neither jax nor diarizen_tpu (every
model family's module included), nor transformers or safetensors (the
HuggingFace WavLM import reads their files itself), the multi-channel recipe TOML builds the
port's model with both blocked, its entry points refuse to run on the CPU
unless asked, and chip_smoke.py fails without a CUDA device or without the
package beside it."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from diarizen_tpu_torch import config
from diarizen_tpu_torch.infer import EmbeddingInference, McSlidingInference, SlidingInference
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.mc import FusionConfig, McEendConfig, McEendModel
from diarizen_tpu_torch.recipes.diar_ssl_mc import infer as mc_infer
from diarizen_tpu_torch.recipes.diar_ssl_mc import run as mc_run
from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig
from diarizen_tpu_torch.models.wavlm import WavLMConfig

ROOT = Path(__file__).resolve().parents[1]
MC_TOML = ROOT / "recipes/diar_ssl_mc/conf/wavlm_mc_chatt.toml"

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["diarizen_tpu"] = None
sys.modules["transformers"] = None
sys.modules["safetensors"] = None
import diarizen_tpu_torch
names = [m.name for m in pkgutil.walk_packages(diarizen_tpu_torch.__path__, "diarizen_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(" ".join(names))
"""

# the modules of the snapshot-to-RTTM slice must be among those walked
SNAPSHOT_SLICE = ("config", "pipelines", "cluster.vbx", "core.audio", "models.build",
                  "models.convert", "ops.conv_chain", "utils")
# and those of the scoring and frame-level slice
EVALUATION_SLICE = ("ops.der", "cluster.oracle", "core.flac", "infer.vad", "infer.multilabel",
                    "infer.resegmentation", "logger", "recipes.diar_ssl.infer")
# and those of the fine-tune, distill-prune and collapse slice
PRUNING_SLICE = ("prune", "prune.hardconcrete", "prune.gates", "prune.distill", "prune.surgery",
                 "recipes.diar_ssl.run", "recipes.diar_ssl_pruning.run_distill_prune",
                 "recipes.diar_ssl_pruning.apply_pruning",
                 "recipes.diar_ssl_pruning.get_wavlm_from_finetuned")
# and those of the multi-channel slice
MC_SLICE = ("models.mc", "models.forward", "infer.mc_pipeline", "recipes.diar_ssl_mc",
            "recipes.diar_ssl_mc.run", "recipes.diar_ssl_mc.infer")
# and those of the remaining model families
FAMILIES_SLICE = ("models.fbank_eend", "models.sincnet_eend", "models.sserious",
                  "models.xvector")
# and those of the schedules, the HuggingFace import and data parallelism
PARALLEL_SLICE = ("train.optim", "parallel", "parallel.distributed",
                  "recipes.diar_ssl_pruning.convert_wavlm_from_hf")


def test_every_port_module_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 76
    assert all(f"diarizen_tpu_torch.{m}" in names for m in
               SNAPSHOT_SLICE + EVALUATION_SLICE + PRUNING_SLICE + MC_SLICE + FAMILIES_SLICE
               + PARALLEL_SLICE)
    for path in [*(ROOT / "diarizen_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                module = words[1].split(".")[0]
                assert module not in ("jax", "diarizen_tpu", "transformers", "safetensors"), \
                    f"{path}: {line}"


_BUILD_MC_TOML = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["diarizen_tpu"] = None
sys.modules["optax"] = None
from diarizen_tpu_torch import config
from diarizen_tpu_torch.models.mc import McEendModel
c = config.load_toml(sys.argv[1])
paths = [sec["path"] for sec in c.values() if isinstance(sec, dict) and "path" in sec]
targets = [config.resolve(p) for p in paths]
assert all(t.__module__.startswith("diarizen_tpu_torch.") for t in targets), targets
cfg, model = config.instantiate_section(c, "model")
assert isinstance(model, McEendModel)
print(len(paths), cfg.num_channels, cfg.fusion, cfg.wavlm.embed_dim, len(model.channel_fusions),
      sum(p.numel() for p in model.parameters()))
"""


def test_mc_recipe_toml_builds_the_port_model_without_jax():
    proc = subprocess.run([sys.executable, "-c", _BUILD_MC_TOML, str(MC_TOML)], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    words = proc.stdout.split()
    assert words[:2] == ["6", "8"] and "hidden=256," in words and "num_heads=8," in words
    assert words[-3:-1] == ["768", "4"] and int(words[-1]) > 25_000_000  # the pruned trunk


def _tiny_models():
    wavlm = WavLMConfig(conv_layers=((8, 10, 5), (8, 3, 2)), embed_dim=32, num_layers=1,
                        use_attention=(True,), use_feed_forward=(True,),
                        total_num_heads=(2,), remaining_heads=((0,),),
                        ff_interm_features=(16,), num_buckets=8, max_distance=16)
    cfg = EendConfig(wavlm=wavlm, conformer=ConformerConfig(dim=16, ffn_hidden=16, num_heads=2,
                                                            num_layers=1),
                     wavlm_layer_num=2, wavlm_feat_dim=32, attention_in=16)
    mc_cfg = McEendConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__},
                          fusion=FusionConfig(hidden=16, num_heads=2, num_fusion_layers=1),
                          num_channels=2)
    return (EendModel(cfg), McEendModel(mc_cfg),
            ResNet(ResNetConfig(m_channels=4, num_blocks=(1, 1, 1, 1))))


def test_entry_points_default_to_cuda(tmp_path):
    model, mc_model, resnet = _tiny_models()
    if torch.cuda.is_available():
        assert SlidingInference(model).device.type == "cuda"
        assert McSlidingInference(mc_model, num_channels=2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlidingInference(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EmbeddingInference(resnet, 32000, num_speakers=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        McSlidingInference(mc_model, num_channels=2)
    assert SlidingInference(model, device="cpu").device.type == "cpu"
    assert McSlidingInference(mc_model, num_channels=2, device="cpu").device.type == "cpu"
    # the multi-channel recipe CLIs, on the repository's TOML
    conf = tmp_path / MC_TOML.name
    config.dump_toml(config.apply_overrides(config.load_toml(MC_TOML),
                                            {"meta.save_dir": str(tmp_path / "exp")}), conf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mc_run.main(["-C", str(conf), "-M", "validate"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mc_infer.main(["-C", str(conf), "--exp_dir", str(tmp_path), "--wav_scp",
                       str(tmp_path / "wav.scp"), "--out_dir", str(tmp_path / "out")])


def test_chip_smoke_fails_without_cuda_or_alone(tmp_path):
    runs = [("alone", tmp_path)]
    if not torch.cuda.is_available():
        runs.append(("no cuda", ROOT))
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for what, cwd in runs:
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0, what
        assert '"ok"' not in proc.stdout, what
