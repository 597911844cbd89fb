"""ctypes bindings for the native C++ host runtime (``csrc/*.cpp``).

The library is built on first use with ``g++ -O3`` into
``pointreggpt_tpu_torch/_build/native-<hash>.so``, named by a hash of the
source, so an edited source rebuilds; it is written to a temporary name
and moved into place with ``os.replace``, so concurrent builds never leave
a torn file. It exposes:

- :func:`depth_preprocess`: uint16 mm frame -> model-space float32 [0, 1]
  (NEAREST short-side resize, center crop, scale and clip, optional flip);
- :func:`png16_decode` and :func:`png16_depth_preprocess`: a 16-bit
  grayscale PNG decoder (zlib inflate + unfilter), alone and fused with the
  preprocessing: the dataloaders' host path
  (``core/imageio16.py``'s ``use_native``);
- :func:`voxel_downsample_host`, :func:`radius_hits_host`: host versions
  of the point ops;
- :func:`ply_pack`: binary PLY bytes.

The PNG functions need zlib's headers: without them the build is retried
without zlib (``native-<hash>-nozlib.so``), the PNG functions then report
every file as unsupported and callers decode it with PIL, while the other
functions stay native (:func:`has_zlib`). A PNG that is not 16-bit
grayscale and non-interlaced goes to PIL as well. With no toolchain at all
:func:`is_available` is False and callers keep their PIL / numpy paths.
Either way the output is bit for bit the PIL path's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "pointreggpt_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
ZLIB_FLAGS = ["-DPRGPT_HAVE_ZLIB", "-lz"]

# png16_* return codes 1-5: not the supported format (not a PNG, too large,
# another bit depth, colour type or interlace; the fused call also when
# the image is too small to crop): the caller decodes it with PIL
_UNSUPPORTED = (1, 2, 3, 4, 5)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_zlib = False
_failed = False

_u8 = ctypes.POINTER(ctypes.c_uint8)
_u16 = ctypes.POINTER(ctypes.c_uint16)
_f32 = ctypes.POINTER(ctypes.c_float)
_i32 = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "depth_preprocess": (ctypes.c_int, [_u16, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int, _f32]),
    "voxel_downsample": (ctypes.c_int, [_f32, ctypes.c_int64,
                                        ctypes.c_float, _f32]),
    "radius_hits": (None, [_f32, ctypes.c_int64, _f32, ctypes.c_int64,
                           ctypes.c_float, _u8]),
    "ply_pack": (ctypes.c_int64, [_f32, ctypes.c_int64, ctypes.c_char_p,
                                  ctypes.c_int64]),
    "png16_dims": (ctypes.c_int, [_u8, ctypes.c_int64, _i32, _i32]),
    "png16_decode": (ctypes.c_int, [_u8, ctypes.c_int64, _u16,
                                    ctypes.c_int64]),
    "png16_depth_preprocess": (ctypes.c_int, [_u8, ctypes.c_int64,
                                              ctypes.c_int, ctypes.c_int,
                                              _f32]),
}


def library_path(zlib: bool = True) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"native-{digest}{'' if zlib else '-nozlib'}.so"


def _build(final: Path, zlib: bool) -> bool:
    """g++ the source into ``final``; False when the compiler fails or
    the build directory is not writable."""
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".native-", suffix=".so",
                                   dir=BUILD_DIR)
    except OSError:
        return False
    os.close(fd)
    cmd = ["g++", *FLAGS, "-o", tmp, str(SOURCE),
           *(ZLIB_FLAGS if zlib else [])]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, final)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on the first call (None when it cannot be)."""
    global _lib, _zlib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        for zlib in (True, False):
            path = library_path(zlib)
            if path.exists() or _build(path, zlib):
                break
        else:
            _failed = True
            return None
        if not zlib:
            warnings.warn("pointreggpt_tpu_torch.native: built without "
                          "zlib; PNGs are decoded by PIL", RuntimeWarning)
        lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib, _zlib = lib, zlib
        return _lib


def is_available() -> bool:
    """True when the native library built and loaded."""
    return _load() is not None


def has_zlib() -> bool:
    """True when the loaded library decodes PNGs (built with zlib)."""
    return _load() is not None and _zlib


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++?)")
    return lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def depth_preprocess(raw: np.ndarray, out_size: int,
                     flip: bool = False) -> np.ndarray:
    """uint16 (h, w) mm depth -> (out_size, out_size) float32 [0, 1]."""
    lib = _lib_or_raise()
    raw = np.ascontiguousarray(raw, dtype=np.uint16)
    out = np.empty((out_size, out_size), np.float32)
    rc = lib.depth_preprocess(_ptr(raw, _u16), raw.shape[0], raw.shape[1],
                              out_size, int(flip), _ptr(out, _f32))
    if rc != 0:
        raise ValueError(f"depth_preprocess failed (rc={rc}, shape="
                         f"{raw.shape}, out_size={out_size})")
    return out


def png16_decode(png_bytes: bytes) -> Optional[np.ndarray]:
    """Decode a 16-bit grayscale PNG to (h, w) uint16; None when the bytes
    are not that format (the caller decodes them with PIL). Raises only
    when a supported PNG is corrupt."""
    lib = _lib_or_raise()
    buf = np.frombuffer(png_bytes, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.png16_dims(_ptr(buf, _u8), buf.size, ctypes.byref(h),
                        ctypes.byref(w))
    if rc in _UNSUPPORTED:
        return None
    if rc != 0:
        raise ValueError(f"png16_dims failed (rc={rc})")
    out = np.empty((h.value, w.value), np.uint16)
    rc = lib.png16_decode(_ptr(buf, _u8), buf.size, _ptr(out, _u16),
                          out.size)
    if rc != 0:
        raise ValueError(f"png16_decode failed (rc={rc})")
    return out


def png16_depth_preprocess(png_bytes: bytes, out_size: int,
                           flip: bool = False) -> Optional[np.ndarray]:
    """PNG bytes -> (out_size, out_size) float32 [0, 1] in one call
    (decode + :func:`depth_preprocess`); None when the PNG is not 16-bit
    grayscale non-interlaced (the caller decodes it with PIL)."""
    lib = _lib_or_raise()
    buf = np.frombuffer(png_bytes, np.uint8)
    out = np.empty((out_size, out_size), np.float32)
    rc = lib.png16_depth_preprocess(_ptr(buf, _u8), buf.size, out_size,
                                    int(flip), _ptr(out, _f32))
    if rc in _UNSUPPORTED:
        return None
    if rc != 0:
        raise ValueError(f"png16_depth_preprocess failed (rc={rc})")
    return out


def voxel_downsample_host(points: np.ndarray, voxel: float) -> np.ndarray:
    """(n, 3) -> (m, 3) voxel centroids (Open3D semantics), first
    occurrence order."""
    lib = _lib_or_raise()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    out = np.empty_like(pts)
    m = lib.voxel_downsample(_ptr(pts, _f32), pts.shape[0], voxel,
                             _ptr(out, _f32))
    return out[:m].copy()


def radius_hits_host(src: np.ndarray, tgt: np.ndarray,
                     radius: float) -> np.ndarray:
    """(n,) bool: does any tgt point lie within ``radius`` of each src
    point."""
    lib = _lib_or_raise()
    s = np.ascontiguousarray(src, dtype=np.float32)
    t = np.ascontiguousarray(tgt, dtype=np.float32)
    hits = np.empty((s.shape[0],), np.uint8)
    lib.radius_hits(_ptr(s, _f32), s.shape[0], _ptr(t, _f32), t.shape[0],
                    radius, _ptr(hits, _u8))
    return hits.astype(bool)


def ply_pack(points: np.ndarray) -> bytes:
    """(n, 3) points as binary little-endian PLY bytes."""
    lib = _lib_or_raise()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    buf_size = 256 + pts.shape[0] * 12
    buf = ctypes.create_string_buffer(buf_size)
    n = lib.ply_pack(_ptr(pts, _f32), pts.shape[0], buf, buf_size)
    if n < 0:
        raise ValueError("ply_pack buffer too small")
    return buf.raw[:n]
