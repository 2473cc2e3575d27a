"""Serving throughput of the port's pipeline, to compare trees on one card.

    python3 serving_ab.py TREE [TREE ...]

Each tree (a checkout of this repository, e.g. the parent commit unpacked
with `git archive`) runs in a process of its own, in the order given: give
parent, change, change, parent to compare two commits in turns. A process
builds the tree's kernels, sets up chip_smoke.py's serving configuration
(Base-s80-md EEND + ResNet34 with seeded random weights, AHC, segmentation
batch 32 in bf16) and its 120 s synthetic file, warms up with one call,
times 7 calls (wall clock to torch.cuda.synchronize) and prints the median
audio-s/s with every call's value. Needs one CUDA card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

CALLS = 7


def run_tree(root: str) -> None:
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from diarizen_tpu_torch.ops import flash_attention

    if not torch.cuda.is_available():
        raise SystemExit("serving_ab: no CUDA device available")
    flash_attention.build()
    cfg = cs.EendConfig(wavlm=cs.WavLMConfig.base_s80_md(), conformer=cs.ConformerConfig())
    model = cs.EendModel(cfg)
    model.load_state_dict(cs.random_state_dict(model, seed=0))
    resnet = cs.ResNet(cs.ResNetConfig())
    resnet.load_state_dict(cs.random_state_dict(resnet, seed=1))
    seg = cs.SlidingInference(model, batch_size=cs.BATCH)
    emb = cs.EmbeddingInference(resnet, seg.window_size,
                                num_speakers=cfg.max_speakers_per_chunk)
    pipeline = cs.DiarizationPipeline(
        seg, emb, cs.AgglomerativeClustering(threshold=0.7, min_cluster_size=30), cfg,
        max_speakers=8)
    wave = cs.make_wave(cs.AUDIO_SECONDS)
    pipeline(wave, 16000, uri="warmup")
    torch.cuda.synchronize()
    rates = []
    for _ in range(CALLS):
        t0 = time.perf_counter()
        pipeline(wave, 16000, uri="ab")
        torch.cuda.synchronize()
        rates.append(cs.AUDIO_SECONDS / (time.perf_counter() - t0))
    print(f"{root}: median {np.median(rates):.2f} audio-s/s over {CALLS} calls: "
          + " ".join(f"{r:.2f}" for r in rates), flush=True)


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--tree":
        run_tree(argv[2])
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv[1:]:
        root = str(Path(tree).resolve())
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree", root],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
