"""Nothing the benchmark loads is JAX or the JAX package, by whole
top-level names; the plain reference imports nothing of the port either."""

import ast
import subprocess
import sys

from portbench import core

SCRIPT = """
import sys
sys.path.insert(0, {root!r})
import portbench.run, portbench.control, portbench.traffic.files, portbench.weights
from portbench import core
from diarizen_tpu_torch import pipelines  # what a run drives
for m in core.manifest()["per_layer"]:
    core.metric_reader(m["name"])
print("loaded:" + ",".join(core.forbidden_modules()))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(core.ROOT))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded:"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "diarizen_tpu_torch_lookalike", sys)
    assert "diarizen_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in core.forbidden_modules()


def imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_sources():
    for path in core.BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not imported(path) & set(core.FORBIDDEN), path
    for path in (core.BENCH / "reference").glob("*.py"):
        assert "diarizen_tpu_torch" not in imported(path), path
