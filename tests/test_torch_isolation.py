"""The port stands alone: it imports neither jax nor diarizen_tpu, its entry
points refuse to run on the CPU unless asked, and chip_smoke.py fails
without a CUDA device or without the package beside it."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from diarizen_tpu_torch.infer import EmbeddingInference, SlidingInference
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig
from diarizen_tpu_torch.models.wavlm import WavLMConfig

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["diarizen_tpu"] = None
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


def test_every_port_module_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 63
    assert all(f"diarizen_tpu_torch.{m}" in names
               for m in SNAPSHOT_SLICE + EVALUATION_SLICE + PRUNING_SLICE)
    for path in [*(ROOT / "diarizen_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                module = words[1].split(".")[0]
                assert module not in ("jax", "diarizen_tpu"), f"{path}: {line}"


def _tiny_models():
    wavlm = WavLMConfig(conv_layers=((8, 10, 5), (8, 3, 2)), embed_dim=32, num_layers=1,
                        use_attention=(True,), use_feed_forward=(True,),
                        total_num_heads=(2,), remaining_heads=((0,),),
                        ff_interm_features=(16,), num_buckets=8, max_distance=16)
    cfg = EendConfig(wavlm=wavlm, conformer=ConformerConfig(dim=16, ffn_hidden=16, num_heads=2,
                                                            num_layers=1),
                     wavlm_layer_num=2, wavlm_feat_dim=32, attention_in=16)
    return EendModel(cfg), ResNet(ResNetConfig(m_channels=4, num_blocks=(1, 1, 1, 1)))


def test_entry_points_default_to_cuda():
    model, resnet = _tiny_models()
    if torch.cuda.is_available():
        assert SlidingInference(model).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlidingInference(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EmbeddingInference(resnet, 32000, num_speakers=4)
    assert SlidingInference(model, device="cpu").device.type == "cpu"


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
