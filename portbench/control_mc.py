"""The control of the multi-channel serving cell: the plain reference
(`reference/mc.py`) put in the program's place, one step below the
precisions the configuration states, judged by the cell's comparison
(`reference/mc_judge.py`). It has to come out not correct.

    python3 portbench/control_mc.py --workload <cell> --seeds <n> [<n> ...]

Segmentation and fusion products in float8 e4m3 (bf16 stated), embedding
products in bfloat16 (float32 with TF32 allowed), VBx in float32 (float64);
for each seed the cell's pool, weights and PLDA as a run makes them, and the
files a run's comparison would read from one pass over the pool. One JSON
line a seed with the worst of each number beside its limit. It reads no
measured window.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import core  # noqa: E402
from portbench.control import PRECISIONS  # noqa: E402
from portbench.reference.judge import Layout  # noqa: E402
from portbench.reference.mc_judge import NUMBERS, judge_file, reference_outputs  # noqa: E402


def readings(workload: dict, seed: int, device, tmp_root: Path) -> dict:
    """{number: worst value} of the control over the files a run would read."""
    from portbench.traffic.files import sample, write_setup_dir
    from portbench.traffic.mc_files import make_pool, make_weights

    cfg = core.load_config(workload["config"])
    layout = Layout(cfg)
    root = Path(tempfile.mkdtemp(prefix="portbench-control-", dir=tmp_root))
    try:
        plda = str(write_setup_dir(root / "model", workload["config"],
                                   cfg["weights"].get("seed", seed)) / "plda")
        weights = make_weights(cfg, seed, device)
        done = [{"item": item} for item in make_pool(workload["traffic"], seed, device)]
        worst = dict.fromkeys(NUMBERS, 0.0)
        for j in sample(done, workload["check_files"], seed):
            wave = done[j]["item"]["wave"]
            outputs = reference_outputs(layout, cfg, weights, wave, plda, device,
                                        PRECISIONS["segmentation"], PRECISIONS["embedding"],
                                        PRECISIONS["clustering"])
            numbers = judge_file(layout, cfg, weights, wave, outputs, plda, device)
            worst = {k: max(worst[k], numbers[k]) for k in NUMBERS}
        return worst
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    workload = core.load_workload(args.workload)
    tmp_root = Path(tempfile.gettempdir())
    for seed in args.seeds:
        worst = readings(workload, seed, args.device, tmp_root)
        limits = workload["limits"]
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": "control",
                          "correct": all(worst[k] <= limits[k] for k in worst),
                          "numbers": {k: {"value": worst[k], "limit": limits[k]}
                                      for k in worst}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
