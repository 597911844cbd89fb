"""BENCHMARK.json against the benchmark's contract, every file it names
found by name, and no JAX anywhere in the benchmark."""

import ast
import json
import re
from pathlib import Path

import pytest

from portbench.lib import card, spec

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_are_files_under_paths():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        for key in c["reduced"]:
            assert key in cfg and not key.endswith(("_dim", "_rank"))
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_is_found_by_name(cell):
    c = spec.Cell(cell, bench=BENCH)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    assert hasattr(c.job(), "Job")
    e2e = {m["name"] for m in c.metrics(False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = c.metrics(True)
    assert per_layer
    for m in c.metrics(False) + per_layer:
        assert callable(spec.Cell.reader(m["name"]).read)
    assert c.limits and all(v >= 0 for v in c.limits.values())


def test_metrics_follow_the_contract():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert set(m.get("workloads", cells)) <= cells
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"])
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        layers.add(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf


@pytest.mark.parametrize("names,found", [
    (["pointreggpt_tpu_torch", "pointreggpt_tpu_torch.ops.conv",
      "jaxtyping", "flaxen.x"], []),
    (["jax", "jax.numpy", "torch"], ["jax", "jax.numpy"]),
    (["pointreggpt_tpu.config", "jaxlib.xla_client", "flax"],
     ["flax", "jaxlib.xla_client", "pointreggpt_tpu.config"]),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert card.forbidden_modules({n: None for n in names}) == found


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    for name in _imports(path):
        assert name.split(".")[0] not in card.FORBIDDEN, (path, name)
    if "reference" in path.parts:
        for name in _imports(path):
            assert name.split(".")[0] != "pointreggpt_tpu_torch", (path, name)
