"""Registers, shared memory and spills of each hand-written kernel, as
``ptxas -v`` reports them.

    python -m pointreggpt_tpu_torch.tools.kernel_resources [name ...]

Compiles each ``ops/csrc/<name>.cu`` (default: every source) with the
build's own flags plus ``-Xptxas -v`` into a temporary directory and prints
one JSON line per kernel function: its mangled name, registers, spill
stores and loads (bytes), static shared memory and stack frame. Needs
``nvcc``; the dynamic shared memory a launch asks for is not in it.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from pointreggpt_tpu_torch.ops import _build

_FUNC = re.compile(r"Compiling entry function '([^']+)'")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_STACK = re.compile(r"(\d+) bytes stack frame")


def parse(text: str) -> list:
    """Per-kernel resources from ``ptxas -v`` output."""
    rows, cur = [], None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = dict(kernel=m.group(1))
            rows.append(cur)
            continue
        if cur is None:
            continue
        for key, rx in (("registers", _REGS), ("static_smem", _SMEM),
                        ("stack_frame", _STACK)):
            m = rx.search(line)
            if m:
                cur[key] = int(m.group(1))
        m = _SPILL.search(line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
    return rows


def report(name: str) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build.nvcc_path(), *_build.FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "lib.so"), str(_build.CSRC / f"{name}.cu")],
            capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    return [dict(source=name, **r) for r in parse(proc.stderr + proc.stdout)]


def main(names=None) -> list:
    rows = [r for n in (names or _build.SOURCES) for r in report(n)]
    for r in rows:
        print(json.dumps(r))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
