"""BENCHMARK.json against the contract, and every file it names."""

import json
import math
import re

import pytest

from portbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    return core.manifest()


def test_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((core.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in manifest[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in manifest["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"]) and LINE.match(w["why"])
    for c in manifest["configs"]:
        assert LINE.match(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_config_has_a_cell_and_a_file(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    for c in manifest["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and (core.ROOT / c["file"]).is_file()
        cfg = core.load_config(c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_four_chip_cells_are_few(manifest):
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert all(w["chips"] in (1, 4) for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)


def test_metrics_agree_with_cells(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and LINE.match(m["layer"])
        listed = set(m.get("workloads", cells))
        assert listed <= cells
        assert listed <= set(e2e[m["moves"]].get("workloads", cells))
        assert (core.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        reported = [m for m in manifest["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in manifest["per_layer"])


def test_cells_find_their_files(manifest):
    for w in manifest["workloads"]:
        spec = core.load_workload(w["name"])
        assert spec["config"] == w["config"] and spec["why"] == w["why"]
        assert (core.BENCH / "traffic" / f"{spec['kind']}.py").is_file()
        assert spec["limits"] and all(v >= 0 for v in spec["limits"].values())


def test_command_and_paths(manifest):
    assert manifest["command"] == ["python3", "portbench/run.py"]
    assert manifest["paths"] == ["portbench"]
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43200 s
    cells = 24
    total = (2 + 14 * cells) * (manifest["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_kernel_specs_name_a_bound():
    from portbench import flops

    for path in (core.BENCH / "kernels").glob("*.json"):
        spec = json.loads(path.read_text())
        assert callable(getattr(flops, spec["bound"])) and spec["patterns"]
