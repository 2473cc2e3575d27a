"""One run of one cell of the benchmark of `diarizen_tpu_torch`.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything the cell needs is found by the name in BENCHMARK.json:
`portbench/workloads/<cell>.json` (configuration, traffic, limits),
`portbench/configs/<config>.toml`, `portbench/traffic/<kind>.py` (the loop
that drives the program), `portbench/metrics/<metric>.py` (one reader a
per-layer metric) and `portbench/kernels/<kernel>.json`. The last line of
standard output is the result as one JSON object; the numbers compared for
`correct` are the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# caches at fixed paths inside the checkout, so that only a checkout's first
# run builds; the program's own kernels build into build/diarizen_tpu_torch/
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"  # one host thread: the serving loop is one Python thread
sys.path.insert(0, str(ROOT))
# the Trainer's optional TensorBoard writer imports TensorFlow, which loads JAX
# where it is installed: a run keeps it out (the Trainer then writes no events)
sys.modules.setdefault("torch.utils.tensorboard", None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import core

    manifest = core.manifest()
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        core.fail(f"no cell {args.workload!r} in BENCHMARK.json", 2)
    chips = cells[args.workload]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        core.fail(f"the cell needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
    torch.set_num_threads(1)

    import diarizen_tpu_torch  # noqa: F401  (the system under test; fails without it)

    workload = core.load_workload(args.workload)
    tmp_root = Path(os.environ.get("TMPDIR") or ROOT / "build" / "portbench" / "tmp")
    tmp_root.mkdir(parents=True, exist_ok=True)
    result = run_cell(manifest, args.workload, workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", chips, tmp_root)
    found = core.forbidden_modules()
    if found:
        core.fail(f"modules of JAX or the JAX package were loaded: {found}")
    core.emit(*result)
    return 0


def run_cell(manifest: dict, name: str, workload: dict, seed: int, seconds: float, trace: bool,
             device, chips: int, tmp_root: Path) -> tuple:
    """(result line without checks, checks) of one run; `device` "cpu" only
    in the CPU tests, which drive everything but the look for a chip."""
    from portbench import core

    cfg = core.load_config(workload["config"])
    driver = core.traffic_driver(workload["kind"])
    measured, checks, extra = driver.run(name, workload, cfg, seed, seconds, trace, device,
                                         STARTED, tmp_root)
    metrics = {}
    if trace:
        e2e = {m["name"] for m in manifest["end_to_end"] if name in m.get("workloads", [name])}
        for m in manifest["per_layer"]:
            if name in m.get("workloads", [name]) and m["moves"] in e2e:
                value = core.metric_reader(m["name"])(extra["context"])
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in manifest["end_to_end"]:
            if name in m.get("workloads", [name]):
                metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    if device == "cpu":
        dev = {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    else:
        import torch

        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
               "memory_peak_bytes": extra["memory_peak_bytes"]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": extra["attempted"], "failed": extra["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        trace_ = extra["context"]["trace"]
        dev["busy_s"], dev["window_s"] = trace_.busy_s(), trace_.window_s
        result["breakdown"] = trace_.breakdown()
    return result, checks


if __name__ == "__main__":
    sys.exit(main())
