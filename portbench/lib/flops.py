"""Model operations of the two U-Nets from a configuration's shapes: every
product (convs, linears, attention and linear-attention matmuls) as
``torch.utils.flop_counter`` counts the plain reference, 2 per
multiply-add, nothing for norms and elementwise work.

:func:`forward_flops` splits them by the dtype they are computed in
(``bf16`` or ``fp32``): in a net served in bf16 only the 1x1 ``final_conv``
stays fp32.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.lib.work import DIM_HEAD, HEADS, HIDDEN


def _conv(b, h, w, cin, cout, k):
    return 2 * b * h * w * cin * cout * k * k


def attention_shapes(config: dict, image: int) -> Tuple[List[tuple], tuple]:
    """((n, c) of each LinearAttention block in forward order, (n, c) of
    the bottleneck Attention)."""
    dim, mults = config["dim"], config["dim_mults"]
    dims = [dim] + [dim * m for m in mults]
    in_out = list(zip(dims[:-1], dims[1:]))
    s, blocks = image, []
    for i, (d_in, _) in enumerate(in_out):
        blocks.append((s * s, d_in))
        if i < len(in_out) - 1:
            s //= 2
    mid = (s * s, dims[-1])
    for i, (d_in, d_out) in enumerate(reversed(in_out)):
        blocks.append((s * s, d_out))
        if i < len(in_out) - 1:
            s *= 2
    return blocks, mid


def forward_flops(config: dict, batch: int, image: int) -> Dict[str, int]:
    """Operations of one forward of the configuration's net at ``batch``
    images of ``image``^2, by compute dtype."""
    dim, mults = config["dim"], config["dim_mults"]
    conditioned = config["net"] == "DiffusionUNet"
    cond_dim = 8 * dim if conditioned else 0
    b = batch
    dims = [dim] + [dim * m for m in mults]
    in_out = list(zip(dims[:-1], dims[1:]))
    total = 0

    def resnet(h, cin, cout):
        f = _conv(b, h, h, cin, cout, 3) + _conv(b, h, h, cout, cout, 3)
        if cin != cout:
            f += _conv(b, h, h, cin, cout, 1)
        if conditioned:
            f += 2 * b * cond_dim * 2 * cout
        return f

    def lin_attn(h, c):
        n = h * h
        return 2 * b * n * (4 * HIDDEN * c + 2 * HEADS * DIM_HEAD * DIM_HEAD)

    in_ch = 1 if conditioned else 3
    total += _conv(b, image, image, in_ch, dim, 7)
    if conditioned:
        total += 2 * b * (dim * 4 * dim + 16 * dim * dim)   # time mlp
        total += 2 * b * (4 * 4 * dim + 16 * dim * dim)     # param mlp
    s = image
    for i, (d_in, d_out) in enumerate(in_out):
        total += 2 * resnet(s, d_in, d_in) + lin_attn(s, d_in)
        if i < len(in_out) - 1:
            total += _conv(b, s // 2, s // 2, d_in, d_out, 4)
            s //= 2
        else:
            total += _conv(b, s, s, d_in, d_out, 3)
    mid, n = dims[-1], s * s
    total += 2 * resnet(s, mid, mid)
    total += 2 * b * n * mid * 3 * HIDDEN + 2 * b * n * HIDDEN * mid
    total += 2 * 2 * b * HEADS * n * n * DIM_HEAD
    for i, (d_in, d_out) in enumerate(reversed(in_out)):
        total += resnet(s, d_out + d_in, d_out) * 2 + lin_attn(s, d_out)
        if i < len(in_out) - 1:
            total += _conv(b, 2 * s, 2 * s, d_out, d_in, 3)
            s *= 2
        else:
            total += _conv(b, s, s, d_out, d_in, 3)
    total += resnet(s, 2 * dim, dim)
    final = _conv(b, s, s, dim, 1, 1)
    if config["compute_dtype"] == "bf16":
        return {"bf16": total, "fp32": final}
    return {"bf16": 0, "fp32": total + final}
