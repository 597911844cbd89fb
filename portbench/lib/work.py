"""The yardstick's arithmetic of work: the H100's peaks, and frozen copies
of the port's per-call bytes and operations of its hand-written kernels
(``ops/linear_attention.py::work`` / ``work_bwd`` / ``work_core``,
``ops/attention.py::work``, ``ops/conv.py::work_conv``), so that a change
to the port cannot move the yardstick.
"""

from __future__ import annotations

PEAK_BF16 = 989e12     # dense bf16 tensor-core FLOP/s, H100 SXM
PEAK_TF32 = 494.7e12   # dense TF32 tensor-core FLOP/s: the card's fastest
                       # rate on fp32 operands
HBM_BYTES_S = 3.35e12  # HBM3 bytes/s

HEADS, DIM_HEAD = 4, 32
HIDDEN = HEADS * DIM_HEAD


def peak(dtype: str) -> float:
    """The FLOP/s peak of a part computed in ``dtype`` (bf16 or fp32)."""
    return {"bf16": PEAK_BF16, "fp32": PEAK_TF32}[dtype]


def bound_s(w: dict, dtype: str) -> float:
    """The least time of a call: the larger of bytes at HBM speed and
    operations at the peak of its dtype."""
    return max(w["bytes"] / HBM_BYTES_S, w["flops"] / peak(dtype))


def linear_attention(b: int, n: int, c: int, itemsize: int) -> dict:
    """One fused LinearAttention block forward (K1): x, the weights and the
    output moved once; per row the q, k, v and out projections (4 x 128 x c
    products) and the two context products on the four 32x32 head
    blocks."""
    weights = 4 * HIDDEN * c * itemsize + 2 * c * 4
    return {"bytes": 2 * b * n * c * itemsize + weights,
            "flops": 2 * b * n * (4 * HIDDEN * c
                                  + 2 * HEADS * DIM_HEAD * DIM_HEAD)}


def linear_attention_bwd(b: int, n: int, c: int, itemsize: int) -> dict:
    """One LinearAttention block backward (K3): x and dy read once, the two
    parts of dx written once, the weights read once and their fp32
    gradients written once; per row 1536 c products (the projections, their
    transposes and the weight gradients) and six context products on the
    head blocks."""
    weights = 4 * HIDDEN * c * itemsize + 2 * c * 4
    grads = 4 * HIDDEN * c * 4 + 2 * c * 4
    return {"bytes": 4 * b * n * c * itemsize + weights + grads,
            "flops": 2 * b * n * (12 * HIDDEN * c
                                  + 6 * HEADS * DIM_HEAD * DIM_HEAD)}


def linear_attention_core(b: int, n: int, itemsize: int) -> dict:
    """The linear-attention core alone on packed qkv (K4)."""
    return {"bytes": b * n * (3 * HIDDEN + HIDDEN) * itemsize,
            "flops": 2 * b * n * 2 * HEADS * DIM_HEAD * DIM_HEAD}


def attention(b: int, n: int, h: int, d: int, itemsize: int) -> dict:
    """One full-attention core (K2): q, k, v read and the output written
    once; q k^T and p v."""
    return {"bytes": 4 * b * n * h * d * itemsize,
            "flops": 2 * 2 * b * h * n * n * d}


def conv3x3(b: int, h: int, w: int, cin: int, cout: int,
            itemsize: int) -> dict:
    """One 3x3 conv (K5, K6)."""
    return {"bytes": (b * h * w * (cin + cout) + 9 * cin * cout) * itemsize,
            "flops": 2 * b * h * w * cin * cout * 9}
