"""Rounding of the operands of every product (conv, linear, matmul) in the
plain reference: ``fp32`` leaves them alone; the lower precisions are the
controls that a comparison has to fail. A product's operands go through
the rounding (``rnd(x)``) and its output through ``rnd.out``, which rounds
the gradient that comes back into the product (and, where the precision
stores its results lower, rounds the output), so a backward computes in
the same precision as its forward.

- ``tf32``: each fp32 operand rounded to TF32's 10-bit mantissa (round to
  nearest), products and sums in fp32: what the tensor cores do with fp32
  operands when TF32 is on. Emulated, so it reads the same on a CPU.
- ``fp8``: each operand and each product's output scaled by its own amax /
  448 and rounded to float8 e4m3 (as a bf16 model's products return bf16),
  each incoming gradient by its amax / 57344 to e5m2 (the usual fp8
  training recipe), products and sums in fp32.
"""

from __future__ import annotations

import torch


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _scaled(dtype, top: float):
    def round_(x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        scale = x.abs().amax().clamp_min(1e-30) / top
        return (x / scale).to(dtype).float() * scale
    return round_


class _GradRound(torch.autograd.Function):
    """The identity forward; the gradient rounded on its way back."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class Rounding:
    def __init__(self, operand=None, grad=None, output=None):
        self.operand, self.grad, self.output = operand, grad, output

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.operand is None:
            return x
        return x + (self.operand(x.detach()) - x.detach())

    def out(self, y: torch.Tensor) -> torch.Tensor:
        if self.output is not None:
            y = y + (self.output(y.detach()) - y.detach())
        if self.grad is None or not y.requires_grad:
            return y
        return _GradRound.apply(y, self.grad)


ROUNDINGS = {
    "fp32": Rounding(),
    "tf32": Rounding(_tf32, _tf32),
    "fp8": Rounding(_scaled(torch.float8_e4m3fn, 448.0),
                    _scaled(torch.float8_e5m2, 57344.0),
                    _scaled(torch.float8_e4m3fn, 448.0)),
}


def rounding(name: str) -> Rounding:
    """The operand rounding called ``name``."""
    if name not in ROUNDINGS:
        raise ValueError(f"unknown precision {name!r}; one of "
                         f"{sorted(ROUNDINGS)}")
    return ROUNDINGS[name]
