"""What every cell of the benchmark shares: the manifest and the files it
names, the table of peaks, the result line, the guard against the JAX
package, and the reading of a profiler trace into kernel intervals and host
spans. Imports nothing of the program.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
import tomllib
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "diarizen_tpu")  # whole top-level module names


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_workload(name: str) -> dict:
    """The cell's own file, `workloads/<name>.json`."""
    return json.loads((BENCH / "workloads" / f"{name}.json").read_text())


def load_config(name: str) -> dict:
    """The configuration's file, `configs/<name>.toml`."""
    with open(BENCH / "configs" / f"{name}.toml", "rb") as fh:
        return tomllib.load(fh)


def peaks() -> dict:
    return json.loads((BENCH / "peaks.json").read_text())


def kernel_spec(name: str) -> dict:
    """A kernel's name patterns and the name of its bound function."""
    return json.loads((BENCH / "kernels" / f"{name}.json").read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str) -> Callable:
    """`read(context)` of `metrics/<name>.py`: the metric's value, or None
    where it finds nothing to read."""
    module = load_module(BENCH / "metrics" / f"{name}.py", "portbench_metric_" + re.sub(
        r"\W", "_", name))
    return module.read


def traffic_driver(kind: str):
    """`traffic/<kind>.py`, whose `run` drives one run of a cell."""
    return importlib.import_module(f"portbench.traffic.{kind}")


def forbidden_modules() -> list:
    """Top-level names in `sys.modules` that belong to JAX or the JAX package,
    compared whole (the port's name starts with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def percentile(values: list, q: float) -> float:
    """Linear-interpolated percentile (numpy's default) of a non-empty list."""
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


# -- the profiler's trace -------------------------------------------------

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "portbench_slice"


def trace_events(prof, tmp_root: Path) -> list:
    """The events of a finished `torch.profiler.profile` as its Chrome trace
    has them: the only export that keeps a kernel's launch grid."""
    path = Path(tmp_root) / "portbench-trace.json"
    prof.export_chrome_trace(str(path))
    try:
        return json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink(missing_ok=True)


class Trace:
    """Device intervals and host spans of the profiled slice (the benchmark's
    `portbench_slice` span), in seconds on the profiler's clock: `kernels`
    (name, start, end, grid) of every device operation (kernels, copies,
    sets), cut to the slice; `whole` those that lie wholly inside; `spans`
    (name, start, end) of the benchmark's own host spans."""

    def __init__(self, events: list, span_names: tuple):
        marks = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == SLICE]
        if not marks:
            raise RuntimeError("the profiler recorded no slice")
        begin = marks[0]["ts"] / 1e6
        end = begin + marks[0]["dur"] / 1e6
        self.begin, self.end = begin, end
        self.kernels, self.whole, self.spans = [], [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            start = e["ts"] / 1e6
            stop = start + e.get("dur", 0) / 1e6
            if e.get("cat") in DEVICE_CATEGORIES:
                if stop <= begin or start >= end:
                    continue
                grid = e.get("args", {}).get("grid")
                grid = tuple(grid) if grid else None
                self.kernels.append((e["name"], max(start, begin), min(stop, end), grid))
                if begin <= start and stop <= end:
                    self.whole.append((e["name"], start, stop, grid))
            elif e.get("cat") == "user_annotation" and e["name"] in span_names:
                self.spans.append((e["name"], start, stop))
        self.kernels.sort(key=lambda k: k[1])
        self.whole.sort(key=lambda k: k[1])

    @property
    def window_s(self) -> float:
        return self.end - self.begin

    def busy(self) -> list:
        """The union of the device intervals, as sorted (start, end)."""
        merged = []
        for _, a, b, _ in self.kernels:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def gaps(self) -> list:
        """(start, end) of every stretch of the slice with no device work."""
        out, t = [], self.begin
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return out

    def host_at(self, t: float) -> str:
        """The innermost benchmark span open at host time t, or "other"."""
        open_spans = [s for s in self.spans if s[1] <= t <= s[2]]
        return min(open_spans, key=lambda s: s[2] - s[1])[0] if open_spans else "other"

    def matching(self, patterns: list) -> list:
        """The launches wholly inside the slice whose name holds a pattern."""
        return [k for k in self.whole if any(p in k[0] for p in patterns)]

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for name, a, b, _ in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(((self.host_at(0.5 * (a + b)), b - a) for a, b in self.gaps()),
                      key=lambda g: -g[1])[:top]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def emit(result: dict, checks: dict) -> None:
    """The result's last line on standard output, the checks' numbers beside
    their limits as the last lines on standard error."""
    result = {**result, "checks": checks}
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def spanned(name: str, fn):
    """`fn` inside a profiler span named `name` (a host span of the trace)."""
    import torch

    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def fail(message: str, code: int = 1) -> None:
    print(message, file=sys.stderr, flush=True)
    raise SystemExit(code)
