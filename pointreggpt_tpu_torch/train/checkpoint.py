"""Checkpoints in the reference ``.pt`` layout, written atomically.

The diffusion trainer saves ``{step, model, opt, ema, version}`` to
``model-{milestone}.pt``: the U-Net under ``model.``, the torch Adam
``state_dict`` under ``opt``, and the EMA's state dict, whose U-Net sits
under ``ema_model.model.`` (the reference's EMA wraps its
GaussianDiffusion, whose ``model`` is the U-Net). ``Generator.load`` reads
the same files. The MaskTrainer saves ``{epoch, model, opt, loss_hist,
best_metrics}``, its MaskUNet under ``model`` with no prefix, which
``Generator`` reads from ``model-best.pt``.

A write goes to a temporary file, is flushed and fsynced, and replaces the
target with ``os.replace``; the directory is fsynced after, so a crash
leaves the old checkpoint or the new one, never a torn or empty file.

:func:`load_jax_checkpoint` reads a ``.ckpt`` that the JAX package wrote
(flax's ``msgpack_serialize`` of ``{state, meta}``) with a small decoder
in pure Python, as flax's ``load_checkpoint(path)`` with no target
returns it. Every loader of a milestone resolves it with
:func:`milestone_path` (the ``.pt`` first, else the JAX ``.ckpt``) and
reads it with :func:`load_diffusion_checkpoint` or
:func:`load_mask_checkpoint`, which turn a ``.ckpt`` into the ``.pt``
layout as the importer CLI writes it.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from pointreggpt_tpu_torch.utils.jax_params import load_reference_checkpoint

PathLike = Union[str, os.PathLike]


def save_checkpoint(path: PathLike, payload: Dict[str, Any]) -> None:
    """``torch.save`` ``payload`` to ``path`` atomically and durably."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:  # a file system without directory fsync
        pass


def load_checkpoint(path: PathLike) -> Dict[str, Any]:
    """Read a checkpoint onto the CPU (weights-only unpickling)."""
    return load_reference_checkpoint(path)


def latest_milestone(results_folder: PathLike,
                     prefix: str = "model-") -> Optional[str]:
    """The milestone name of the newest ``{prefix}*.pt`` in a folder."""
    folder = Path(results_folder)
    if not folder.exists():
        return None
    paths = sorted(folder.glob(f"{prefix}*.pt"),
                   key=lambda p: p.stat().st_mtime)
    return paths[-1].stem[len(prefix):] if paths else None


# ---------------------------------------------------------------------------
# flax msgpack checkpoints of the JAX package

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
# fixed-width msgpack heads: tag -> (struct format, kind)
_FIXED = {
    0xca: (">f", "num"), 0xcb: (">d", "num"),
    0xcc: (">B", "num"), 0xcd: (">H", "num"), 0xce: (">I", "num"),
    0xcf: (">Q", "num"), 0xd0: (">b", "num"), 0xd1: (">h", "num"),
    0xd2: (">i", "num"), 0xd3: (">q", "num"),
    0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
    0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
    0xdc: (">H", "array"), 0xdd: (">I", "array"),
    0xde: (">H", "map"), 0xdf: (">I", "map"),
    0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext"),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Msgpack:
    """Decoder of the msgpack subset flax writes: maps, arrays, str / bin,
    ints, floats, bool, nil and its ext types (1 ndarray, 2 complex, 3
    numpy scalar)."""

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self):
        tag = self._take(1)[0]
        if tag <= 0x7f:
            return tag
        if tag >= 0xe0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8f:
            return self._map(tag & 0x0f)
        if 0x90 <= tag <= 0x9f:
            return [self.value() for _ in range(tag & 0x0f)]
        if 0xa0 <= tag <= 0xbf:
            return str(self._take(tag & 0x1f), "utf-8")
        if tag in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[tag]
        if tag in _FIXEXT:
            code = self._unpack(">b")
            return self._ext(code, self._take(_FIXEXT[tag]))
        if tag not in _FIXED:
            raise ValueError(f"msgpack: unknown type byte {tag:#x}")
        fmt, kind = _FIXED[tag]
        n = self._unpack(fmt)
        if kind == "num":
            return n
        if kind == "bin":
            return bytes(self._take(n))
        if kind == "str":
            return str(self._take(n), "utf-8")
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            return self._map(n)
        code = self._unpack(">b")
        return self._ext(code, self._take(n))

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    @staticmethod
    def _ext(code: int, data: memoryview):
        if code == _EXT_COMPLEX:
            real, imag = _Msgpack(bytes(data)).value()
            return complex(real, imag)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, name, raw = _Msgpack(bytes(data)).value()
            if isinstance(name, bytes):
                name = name.decode()
            if name == "bfloat16":  # numpy has no bfloat16
                arr = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16)
                return arr.reshape(shape) if code == _EXT_NDARRAY \
                    else arr.reshape(())
            arr = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)
            return arr.copy() if code == _EXT_NDARRAY else arr[()]
        raise ValueError(f"msgpack: unknown ext type {code}")


def _unchunk(node):
    """Arrays over 2^30 bytes, which flax writes as chunked dicts, put
    back together."""
    if not isinstance(node, dict):
        return node
    if node.get(_CHUNKED) is True:
        shape = [node["shape"][str(i)] for i in range(len(node["shape"]))]
        chunks = [node["chunks"][str(i)]
                  for i in range(len(node["chunks"]))]
        if any(isinstance(c, torch.Tensor) for c in chunks):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def load_jax_checkpoint(path: PathLike) -> Tuple[Dict[str, Any],
                                                  Dict[str, Any]]:
    """``(state, meta)`` of a JAX package ``.ckpt``, as its
    ``load_checkpoint(path)`` returns them with no target: nested dicts
    (an optax tuple as ``{'0': ..., '1': ...}``, a NamedTuple as a dict of
    its fields) with numpy leaves; a bfloat16 leaf is a torch tensor."""
    with open(path, "rb") as f:
        reader = _Msgpack(f.read())
    payload = reader.value()
    if reader.pos != len(reader.buf) or not isinstance(payload, dict) \
            or "state" not in payload:
        raise ValueError(f"{path}: not a JAX package checkpoint")
    return _unchunk(payload["state"]), _unchunk(payload.get("meta", {}))


# ---------------------------------------------------------------------------
# a milestone from the port's .pt or, failing that, a JAX package .ckpt

ADAM_BETAS, ADAM_EPS = (0.9, 0.99), 1e-8


def milestone_path(results_folder: PathLike, milestone) -> Path:
    """``model-<milestone>.pt`` when it exists, else the JAX package's
    ``model-<milestone>.ckpt``; ``FileNotFoundError`` naming both when
    neither does."""
    folder = Path(results_folder)
    pt = folder / f"model-{milestone}.pt"
    jax_ckpt = folder / f"model-{milestone}.ckpt"
    for path in (pt, jax_ckpt):
        if path.exists():
            return path
    raise FileNotFoundError(f"no checkpoint for milestone {milestone!r}: "
                            f"neither {pt} nor {jax_ckpt} exists")


def ema_state(model_sd: Dict[str, torch.Tensor],
              ema_sd: Dict[str, torch.Tensor], step: int,
              initted: bool) -> Dict[str, torch.Tensor]:
    """The state dict of ``train/ema.py``'s EMA around a U-Net nested
    under ``model`` (online weights ``model_sd``, averaged ``ema_sd``)."""
    out = {"initted": torch.tensor(bool(initted)),
           "step": torch.tensor(int(step))}
    out.update({f"online_model.model.{k}": v for k, v in model_sd.items()})
    out.update({f"ema_model.model.{k}": v for k, v in ema_sd.items()})
    return out


def diffusion_payload_from_jax(path: PathLike, model: torch.nn.Module, *,
                               lr: float, betas=ADAM_BETAS,
                               eps: float = ADAM_EPS) -> Dict[str, Any]:
    """A JAX Trainer ``.ckpt`` as the port's Trainer saves a milestone
    (``{step, model, opt, ema, version}``), its weights checked against
    ``model``'s and its optax Adam carried into a torch Adam of ``lr``,
    ``betas`` and ``eps``."""
    from pointreggpt_tpu_torch.utils.jax_params import (
        diffusion_parts_from_jax)

    state, _ = load_jax_checkpoint(path)
    parts = diffusion_parts_from_jax(state, model, lr=lr, betas=betas,
                                     eps=eps)
    return {"step": parts["step"],
            "model": {f"model.{k}": v for k, v in parts["model"].items()},
            "opt": parts["opt"],
            "ema": ema_state(parts["model"], parts["ema_model"],
                             parts["ema_step"], parts["ema_initted"]),
            "version": f"ported:{Path(path).name}"}


def mask_payload_from_jax(path: PathLike, model: torch.nn.Module, *,
                          lr: float, betas=ADAM_BETAS,
                          eps: float = ADAM_EPS) -> Dict[str, Any]:
    """A JAX MaskTrainer ``.ckpt`` as the port's MaskTrainer saves a
    milestone (``{epoch, model, opt, loss_hist, best_metrics, version}``);
    the Adam step is optax's count, the learning-rate schedule's clock."""
    from pointreggpt_tpu_torch.utils.jax_params import mask_parts_from_jax

    state, meta = load_jax_checkpoint(path)
    parts = mask_parts_from_jax(state, meta, model, lr=lr, betas=betas,
                                eps=eps)
    return {"epoch": parts["epoch"], "model": parts["model"],
            "opt": parts["opt"], "loss_hist": parts["loss_hist"],
            "best_metrics": parts["best_metrics"],
            "version": f"ported:{Path(path).name}"}


def load_diffusion_checkpoint(path: PathLike, model: torch.nn.Module, *,
                              lr: float = 8e-5, betas=ADAM_BETAS,
                              eps: float = ADAM_EPS) -> Dict[str, Any]:
    """A diffusion milestone in the port's layout: a ``.pt`` as written,
    a JAX ``.ckpt`` through :func:`diffusion_payload_from_jax`. Prints
    the path it reads."""
    print(f"loading {path}")
    if Path(path).suffix == ".ckpt":
        return diffusion_payload_from_jax(path, model, lr=lr, betas=betas,
                                          eps=eps)
    return load_checkpoint(path)


def load_mask_checkpoint(path: PathLike, model: torch.nn.Module, *,
                         lr: float = 4e-5, betas=ADAM_BETAS,
                         eps: float = ADAM_EPS) -> Dict[str, Any]:
    """:func:`load_diffusion_checkpoint` for a depth-correction
    milestone."""
    print(f"loading {path}")
    if Path(path).suffix == ".ckpt":
        return mask_payload_from_jax(path, model, lr=lr, betas=betas,
                                     eps=eps)
    return load_checkpoint(path)
