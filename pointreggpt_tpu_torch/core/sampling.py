"""Random camera-intrinsic and SE(3) pose sampling on an explicit
``torch.Generator``.

Port of ``pointreggpt_tpu/core/sampling.py``. The two packages draw
different numbers from the same seed; tests hand both the same draws.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

# The six real 3DMatch intrinsic matrices with their empirical sampling
# probabilities (own copy of the JAX package's tables).
INTRINSIC_CANDIDATES = np.array(
    [
        [[585.0, 0.0, 320.0], [0.0, 585.0, 240.0], [0.0, 0.0, 1.0]],
        [[572.0, 0.0, 320.0], [0.0, 572.0, 240.0], [0.0, 0.0, 1.0]],
        [[583.0, 0.0, 320.0], [0.0, 583.0, 240.0], [0.0, 0.0, 1.0]],
        [[540.021232, 0.0, 320.0], [0.0, 540.021232, 240.0], [0.0, 0.0, 1.0]],
        [[570.342205, 0.0, 320.0], [0.0, 570.342205, 240.0], [0.0, 0.0, 1.0]],
        [[533.069214, 0.0, 320.0], [0.0, 533.069214, 240.0], [0.0, 0.0, 1.0]],
    ],
    dtype=np.float32,
)
INTRINSIC_PROBS = np.array([7, 8, 18, 5, 47, 5], dtype=np.float32)
INTRINSIC_PROBS = INTRINSIC_PROBS / INTRINSIC_PROBS.sum()


def random_sample_intrinsic(generator: Optional[torch.Generator],
                            batch_size: int, *, device=None) -> torch.Tensor:
    """(b, 3, 3) intrinsics drawn with replacement from the empirical
    3DMatch distribution."""
    if device is None:
        device = generator.device if generator is not None else "cpu"
    probs = torch.as_tensor(INTRINSIC_PROBS, device=device)
    idx = torch.multinomial(probs, batch_size, replacement=True,
                            generator=generator)
    return torch.as_tensor(INTRINSIC_CANDIDATES, device=device)[idx]


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as fp32 multiply-adds (no TF32 path)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def euler_xyz_intrinsic_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """Intrinsic-XYZ Euler angles (..., 3) -> (..., 3, 3):
    R = Rx(a) @ Ry(b) @ Rz(c), as scipy's ``from_euler("XYZ", ...)``."""
    a, b, c = angles[..., 0], angles[..., 1], angles[..., 2]
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    zeros = torch.zeros_like(a)
    ones = torch.ones_like(a)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    rx = mat([[ones, zeros, zeros], [zeros, ca, -sa], [zeros, sa, ca]])
    ry = mat([[cb, zeros, sb], [zeros, ones, zeros], [-sb, zeros, cb]])
    rz = mat([[cc, -sc, zeros], [sc, cc, zeros], [zeros, zeros, ones]])
    return _matmul3(_matmul3(rx, ry), rz)


def _se3(rotation: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """(b, 4, 4) SE(3) matrices from (b, 3, 3) + (b, 3)."""
    b = rotation.shape[0]
    out = torch.eye(4, dtype=rotation.dtype,
                    device=rotation.device).repeat(b, 1, 1)
    out[:, :3, :3] = rotation
    out[:, :3, 3] = translation
    return out


def transform_uniforms(generator: Optional[torch.Generator],
                       batch_size: int, *, device=None) -> torch.Tensor:
    """The (3, b) uniform draws of :func:`random_sample_transform`."""
    if device is None:
        device = generator.device if generator is not None else "cpu"
    return torch.rand((3, batch_size), generator=generator, device=device,
                      dtype=torch.float32)


def transform_from_uniforms(u: torch.Tensor, intrinsic: torch.Tensor,
                            image_size: int = 256) -> torch.Tensor:
    """FoV-bounded rotation from (3, b) uniforms in [0, 1): pitch and yaw
    bounded so the principal ray stays in the frustum (the atan of the
    principal-point offsets over the focal lengths), full-range roll, no
    translation. Returns (b, 4, 4)."""
    h = w = image_size
    fx, fy = intrinsic[:, 0, 0], intrinsic[:, 1, 1]
    cx, cy = intrinsic[:, 0, 2], intrinsic[:, 1, 2]
    theta_min, theta_max = -torch.atan((h - cy) / fy), torch.atan(cy / fy)
    phi_min, phi_max = -torch.atan(cx / fx), torch.atan((w - cx) / fx)
    theta = u[0] * (theta_max - theta_min) + theta_min
    phi = u[1] * (phi_max - phi_min) + phi_min
    psi = u[2] * 2 * math.pi - math.pi
    rot = euler_xyz_intrinsic_to_matrix(torch.stack([theta, phi, psi], -1))
    return _se3(rot, torch.zeros_like(rot[:, :, 0]))


def random_sample_transform(generator: Optional[torch.Generator],
                            intrinsic: torch.Tensor,
                            image_size: int = 256) -> torch.Tensor:
    """(b, 4, 4) FoV-bounded random rotations for the (b, 3, 3)
    ``intrinsic`` (the Tester's view augmentation)."""
    u = transform_uniforms(generator, intrinsic.shape[0],
                           device=intrinsic.device)
    return transform_from_uniforms(u, intrinsic.float(), image_size)


def random_sample_pose(generator: Optional[torch.Generator],
                       batch_size: int,
                       center: Sequence[float] = (0.0, 0.0, 3.0),
                       *,
                       device=None) -> torch.Tensor:
    """Generation-time camera motion about a pivot in front of the camera.

    Pitch in +-pi/24, yaw in +-pi/12, no roll; the rotation pivots about
    ``center`` (t = c - R c) plus a Gaussian in-plane translation / 3 with
    z zeroed. Returns (b, 4, 4) float32.
    """
    if device is None:
        device = generator.device if generator is not None else "cpu"
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    u = torch.rand((2, batch_size), **kw)
    theta = (u[0] * 2.0 - 1.0) * (math.pi / 24)
    phi = (u[1] * 2.0 - 1.0) * (math.pi / 12)
    psi = torch.zeros_like(theta)
    rot = euler_xyz_intrinsic_to_matrix(torch.stack([theta, phi, psi], -1))

    c = torch.tensor(center, dtype=torch.float32, device=device)
    random_trans = torch.randn((batch_size, 3), **kw) / 3.0
    random_trans[:, -1] = 0.0
    rc = (rot * c[None, None, :]).sum(dim=-1)
    return _se3(rot, c[None] - rc + random_trans)


def haar_uniform_rotation(batch_size: int = 1, *,
                          generator: Optional[torch.Generator] = None,
                          z: Optional[torch.Tensor] = None,
                          device=None) -> torch.Tensor:
    """(b, 3, 3) Haar-uniform rotations on SO(3): the QR decomposition of
    Gaussian matrices, Q's columns signed by R's diagonal, then divided by
    det(Q) to turn reflections into rotations.

    ``z`` injects the (b, 3, 3) Gaussian draw (tests); otherwise it is
    drawn from ``generator``.
    """
    if z is None:
        if device is None:
            device = generator.device if generator is not None else "cpu"
        z = torch.randn((batch_size, 3, 3), generator=generator,
                        device=device, dtype=torch.float32)
    q, r = torch.linalg.qr(z)
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    q = q * (d / d.abs())[:, None, :]
    return q / torch.linalg.det(q)[:, None, None]
