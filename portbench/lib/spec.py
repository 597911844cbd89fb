"""What a cell is, found by name: ``BENCHMARK.json`` at the checkout's
root (each cell's configuration, traffic mix and chips),
``workloads/<cell>.json`` (the limits of its comparison),
``configs/<config>.json`` (the sizes, as
run), ``traffic/<mix>.json`` (the mix's parameters and the job that reads
them), ``jobs/<job>.py`` and ``metrics/<metric>.py`` (one reader each).

A later cell, mix, configuration or metric is a file beside these and an
entry in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent.parent  # portbench/
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload: its files, its metrics and their readers."""

    def __init__(self, name: str, *, bench: dict = None,
                 overrides: dict = None):
        self.name = _name("workload", name)
        self.bench = benchmark() if bench is None else bench
        entry = next((w for w in self.bench["workloads"]
                      if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"{name} is not a workload of BENCHMARK.json")
        self.config_name = _name("config", entry["config"])
        self.traffic_name = _name("traffic", entry["traffic"])
        self.chips = int(entry["chips"])
        self.config = _json(HERE / "configs" / f"{self.config_name}.json")
        self.traffic = _json(HERE / "traffic" / f"{self.traffic_name}.json")
        overrides = overrides or {}
        self.config.update(overrides.get("config", {}))
        self.traffic.update(overrides.get("traffic", {}))
        self.limits: Dict[str, float] = dict(
            _json(HERE / "workloads" / f"{name}.json")["limits"])

    def job(self) -> ModuleType:
        job = _name("job", self.traffic["job"])
        return load_module(HERE / "jobs" / f"{job}.py", f"portbench_job_{job}")

    def metrics(self, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (``trace`` false) or per-layer
        ones: those that list it, or that list no cell and move an
        end-to-end metric it reports."""
        e2e = [m for m in self.bench["end_to_end"]
               if self.name in m.get("workloads", [self.name])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", ()) or
                ("workloads" not in m and m["moves"] in names)]

    @staticmethod
    def reader(metric: str) -> ModuleType:
        return load_module(HERE / "metrics" / f"{_name('metric', metric)}.py",
                           f"portbench_metric_{metric.replace('.', '_')}")
