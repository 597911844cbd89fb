"""The numbers that decide ``correct``, and how they are reported.

Each number is a gap between what the timed path produced and the plain
reference, and is held to the cell's limit (``workloads/<cell>.json``). A
run is correct when every number is finite and at most its limit.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Iterable, List, Optional

import torch


def rel_max_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def max_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max())


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keys: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Per leaf: the gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf."""
    keys = list(want if keys is None else keys)
    gn = {k: float(torch.linalg.vector_norm(got[k].double())) for k in keys}
    wn = {k: float(torch.linalg.vector_norm(want[k].double())) for k in keys}
    med = sorted(wn.values())[len(wn) // 2]
    return {k: abs(gn[k] - wn[k]) / max(wn[k], med, 1e-30) for k in keys}


def worst(gaps: Dict[str, float]) -> str:
    k = max(gaps, key=gaps.get)
    return f"{k} {gaps[k]!r}"


def moving_leaves(grad_ref: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves the reference moves: those whose first gradient's norm is
    at least a thousandth of the median leaf's (a key's bias under a
    softmax has a gradient of rounding alone)."""
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in grad_ref.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return [k for k, n in norms.items() if n >= 1e-3 * med]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no reading of {sorted(missing)}")
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)


def report(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {value, limit}} of the compared numbers (those the cell has a
    limit for); the same, one per line, as the last lines of standard
    error, after the readings that are not compared."""
    for k in sorted(set(numbers) - set(limits)):
        print(f"reading {k} {numbers[k]!r} (not compared)", file=sys.stderr,
              flush=True)
    out = {k: {"value": numbers[k], "limit": limits[k]}
           for k in sorted(limits)}
    for k, v in out.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    return out
