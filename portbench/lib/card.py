"""The card a run stands on, and what must not be in its process."""

from __future__ import annotations

import subprocess
import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "pointreggpt_tpu")


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is,
    whole, one of ``FORBIDDEN``: ``pointreggpt_tpu_torch`` is not
    ``pointreggpt_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def require_cards(chips: int) -> None:
    """Raise unless CUDA sees at least ``chips`` cards."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device is visible")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} are visible")


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out[0] if out else "nvidia-smi printed nothing"


def device(chips: int, peak_bytes: int) -> dict:
    import torch

    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(chips), "memory_peak_bytes": int(peak_bytes)}
