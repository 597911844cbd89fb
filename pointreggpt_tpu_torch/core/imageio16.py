"""Host-side 16-bit depth PNG I/O and model-space preprocessing.

Port of ``pointreggpt_tpu/core/imageio16.py``: uint16 mm PNGs, scale 1e-4
(1.0 == 10 m), values > 1 clipped to 0, NEAREST resize of the short side,
center crop. With ``use_native`` (the default) the 16-bit grayscale
frames decode, and are preprocessed, in the native C++ library
(``native.py``), bit for bit as the PIL path; other PNGs, or a host where
the library does not build, go through PIL.
"""

from __future__ import annotations

import io
import os
from typing import Union

import numpy as np
from PIL import Image

PathLike = Union[str, os.PathLike]


def _native():
    """The native module when its library is built and loaded, else None."""
    from pointreggpt_tpu_torch import native

    return native if native.is_available() else None


def read_depth_png(path: PathLike, use_native: bool = True) -> np.ndarray:
    """Read a 16-bit depth PNG to (h, w) raw values."""
    native = _native() if use_native else None
    if native is not None:
        with open(path, "rb") as f:
            data = f.read()
        out = native.png16_decode(data)
        # another format: PIL decodes the bytes already read
        return out if out is not None else np.asarray(
            Image.open(io.BytesIO(data)))
    return np.asarray(Image.open(path))


def write_depth_png(path: PathLike, depth01: np.ndarray) -> None:
    """Write model-space [0, 1] depth as a uint16 millimeter PNG
    (``image * 1e4 -> uint16``)."""
    depth_mm = (np.asarray(depth01, np.float64) * 1e4).astype(np.uint16)
    Image.fromarray(depth_mm).save(os.fspath(path))


def to_uint8_image(img01: np.ndarray) -> np.ndarray:
    """[0, 1] float image -> uint8, rounding half up
    (torchvision ``save_image``'s ``mul(255).add_(0.5).clamp_(0, 255)``)."""
    return np.clip(np.asarray(img01, np.float32) * 255.0 + 0.5,
                   0.0, 255.0).astype(np.uint8)


def resize_nearest_short_side(img: np.ndarray, size: int) -> np.ndarray:
    """NEAREST resize so the short side == size; the long side is
    ``int(size * long / short)`` (truncated, like torchvision)."""
    h, w = img.shape[:2]
    if h <= w:
        new_h, new_w = size, int(size * w / h)
    else:
        new_w, new_h = size, int(size * h / w)
    pil = Image.fromarray(img).resize((new_w, new_h), resample=Image.NEAREST)
    return np.asarray(pil)


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Center-crop to (size, size) with torchvision's rounding."""
    h, w = img.shape[:2]
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return img[top:top + size, left:left + size]


def load_depth_model_space(path: PathLike, image_size: int, *,
                           flip: bool = False,
                           use_native: bool = True) -> np.ndarray:
    """Load a 3DMatch depth PNG into model space: (h, w) float32 in [0, 1].

    Resize short side -> image_size (NEAREST), optional horizontal flip
    (before the crop, as the reference transform order), center crop,
    scale by 1e-4, zero values above 1. ``use_native``: decode and
    preprocess in one native call where the format allows.
    """
    native = _native() if use_native else None
    if native is not None:
        with open(path, "rb") as f:
            data = f.read()
        out = native.png16_depth_preprocess(data, image_size, flip=flip)
        if out is not None:
            return out
        raw = np.asarray(Image.open(io.BytesIO(data)))
    else:
        raw = read_depth_png(path, use_native=False)
    raw = resize_nearest_short_side(raw, image_size)
    if flip:
        raw = raw[:, ::-1]
    raw = center_crop(raw, image_size)
    depth = raw.astype(np.float32) * 1e-4
    depth = np.where(depth > 1.0, 0.0, depth)
    return np.ascontiguousarray(depth, dtype=np.float32)
