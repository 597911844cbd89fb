"""Minimal PLY point-cloud writer and reader (host numpy).

Port of ``pointreggpt_tpu/core/plyio.py``: writes binary little-endian
float PLY; reads ascii and binary_little_endian files with any scalar
vertex properties, as the JAX reader does.
"""

from __future__ import annotations

import os
from typing import Union

import numpy as np

_DTYPES = {
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
    "uchar": np.uint8, "uint8": np.uint8,
    "char": np.int8, "int8": np.int8,
    "short": np.int16, "int16": np.int16,
    "ushort": np.uint16, "uint16": np.uint16,
    "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32,
}


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
    """Read vertex x/y/z from an ascii or binary_little_endian PLY to
    (n, 3) float64.

    Extra vertex properties (normals, colours) are parsed past; trailing
    elements (a mesh's faces) are ignored; CRLF headers are accepted. The
    vertex element must come first: a preceding element would shift the
    body, so that layout raises, as a missing ``end_header``, a truncated
    header, a list property in the vertex element or a missing axis do.
    """
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    body_start = data.find(b"\n", end)
    if body_start < 0:
        raise ValueError(f"{path}: truncated PLY header")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[body_start + 1:]

    fmt = None
    n_vertex = 0
    props = []  # (name, dtype) of the vertex element, in order
    elements = []
    in_vertex = False
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append(tok[1])
            in_vertex = tok[1] == "vertex"
            if in_vertex:
                n_vertex = int(tok[2])
        elif tok[0] == "property" and in_vertex:
            if tok[1] == "list":
                raise ValueError(f"{path}: list property in vertex element")
            props.append((tok[2], _DTYPES[tok[1]]))

    if "vertex" not in elements:
        raise ValueError(f"{path}: no vertex element")
    if elements[0] != "vertex":
        raise ValueError(
            f"{path}: vertex is not the first element ({elements}); "
            "unsupported layout")
    names = [name for name, _ in props]
    if not all(axis in names for axis in ("x", "y", "z")):
        raise ValueError(f"{path}: vertex element missing x/y/z")

    if fmt == "ascii":
        # the vertex values only: trailing elements share the body
        rows = body.decode("ascii").split()[:n_vertex * len(props)]
        arr = np.array(rows, dtype=np.float64).reshape(n_vertex, len(props))
        return np.stack([arr[:, names.index(a)] for a in ("x", "y", "z")],
                        axis=-1)
    if fmt == "binary_little_endian":
        rec = np.dtype([(name, np.dtype(dt).newbyteorder("<"))
                        for name, dt in props])
        arr = np.frombuffer(body, dtype=rec, count=n_vertex)
        return np.stack([arr["x"], arr["y"], arr["z"]],
                        axis=-1).astype(np.float64)
    raise ValueError(f"{path}: unsupported PLY format {fmt!r}")
