"""Minimal binary little-endian PLY writer and reader (host numpy).

Port of the write path of ``pointreggpt_tpu/core/plyio.py`` plus a reader
for the files it writes.
"""

from __future__ import annotations

import os
from typing import Union

import numpy as np


def write_ply(path: Union[str, os.PathLike], points: np.ndarray,
              *, dtype: str = "float") -> None:
    """Write an (n, 3) point array as binary little-endian PLY; NaN/inf
    rows are dropped. ``dtype`` is "float" (float32) or "double"."""
    points = np.asarray(points, dtype=np.float64)
    points = points[np.all(np.isfinite(points), axis=-1)]
    np_dtype = {"float": "<f4", "double": "<f8"}[dtype]
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {points.shape[0]}\n"
        f"property {dtype} x\n"
        f"property {dtype} y\n"
        f"property {dtype} z\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(points.astype(np_dtype)).tobytes())


def read_ply(path: Union[str, os.PathLike]) -> np.ndarray:
    """Read an x/y/z-only binary little-endian PLY (as written by
    :func:`write_ply`) to (n, 3) float64."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    if "format binary_little_endian 1.0" not in header:
        raise ValueError(f"{path}: not a binary little-endian PLY")
    n = next(int(line.split()[2]) for line in header
             if line.startswith("element vertex"))
    props = [line.split()[1] for line in header
             if line.startswith("property")]
    if len(props) != 3 or len(set(props)) != 1:
        raise ValueError(f"{path}: expected three x/y/z properties")
    np_dtype = {"float": "<f4", "double": "<f8"}[props[0]]
    return np.frombuffer(data[end:], dtype=np_dtype,
                         count=3 * n).reshape(n, 3).astype(np.float64)
