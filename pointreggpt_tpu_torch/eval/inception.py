"""The FID InceptionV3 feature extractor as a torch module.

Port of ``pointreggpt_tpu/eval/inception.py``: InceptionV3 up to its
2048-d pool3 activations (Szegedy et al. 2015 as released in torchvision),
with pytorch_fid's three FID changes, switched by ``fid_pools``:

- ``BasicConv2d`` = bias-free conv + BatchNorm (eps 1e-3, eval mode) +
  ReLU;
- the stem ``Conv2d_1a..4a`` and two 3x3 / 2 max-pools; ``Mixed_5b..5d``
  (InceptionA), ``Mixed_6a`` (B), ``Mixed_6b..6e`` (C), ``Mixed_7a`` (D),
  ``Mixed_7b..7c`` (E), a global average pool;
- ``fid_pools``: the 3x3 / 1 average pools of A, C and ``Mixed_7b``
  leave the zero padding out of the divisor (``count_include_pad=False``)
  and ``Mixed_7c``'s pool branch is a max-pool; without it every pool is
  torchvision's.

Module names are torchvision's (``Conv2d_1a_3x3.conv``, ``.bn``,
``Mixed_5b.branch1x1``, ...), so pytorch_fid's FID weights
(``pt_inception-2015-12-05``) and torchvision's ``inception_v3`` state dict
load with ``strict=True`` once their classifier heads (``fc``,
``AuxLogits``), which the features never reach, are left out
(:func:`load_weights`). The convs are cuDNN's ``F.conv2d`` (the JAX package
runs XLA convs; no Pallas kernel).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# name -> (c_in, c_out, (kh, kw)); stride and padding live in the blocks
_A = lambda p, cin, pool: {  # noqa: E731 - a block's conv table
    f"{p}.branch1x1": (cin, 64, (1, 1)),
    f"{p}.branch5x5_1": (cin, 48, (1, 1)),
    f"{p}.branch5x5_2": (48, 64, (5, 5)),
    f"{p}.branch3x3dbl_1": (cin, 64, (1, 1)),
    f"{p}.branch3x3dbl_2": (64, 96, (3, 3)),
    f"{p}.branch3x3dbl_3": (96, 96, (3, 3)),
    f"{p}.branch_pool": (cin, pool, (1, 1)),
}
_B = lambda p, cin: {  # noqa: E731
    f"{p}.branch3x3": (cin, 384, (3, 3)),
    f"{p}.branch3x3dbl_1": (cin, 64, (1, 1)),
    f"{p}.branch3x3dbl_2": (64, 96, (3, 3)),
    f"{p}.branch3x3dbl_3": (96, 96, (3, 3)),
}
_C = lambda p, cin, c7: {  # noqa: E731
    f"{p}.branch1x1": (cin, 192, (1, 1)),
    f"{p}.branch7x7_1": (cin, c7, (1, 1)),
    f"{p}.branch7x7_2": (c7, c7, (1, 7)),
    f"{p}.branch7x7_3": (c7, 192, (7, 1)),
    f"{p}.branch7x7dbl_1": (cin, c7, (1, 1)),
    f"{p}.branch7x7dbl_2": (c7, c7, (7, 1)),
    f"{p}.branch7x7dbl_3": (c7, c7, (1, 7)),
    f"{p}.branch7x7dbl_4": (c7, c7, (7, 1)),
    f"{p}.branch7x7dbl_5": (c7, 192, (1, 7)),
    f"{p}.branch_pool": (cin, 192, (1, 1)),
}
_D = lambda p, cin: {  # noqa: E731
    f"{p}.branch3x3_1": (cin, 192, (1, 1)),
    f"{p}.branch3x3_2": (192, 320, (3, 3)),
    f"{p}.branch7x7x3_1": (cin, 192, (1, 1)),
    f"{p}.branch7x7x3_2": (192, 192, (1, 7)),
    f"{p}.branch7x7x3_3": (192, 192, (7, 1)),
    f"{p}.branch7x7x3_4": (192, 192, (3, 3)),
}
_E = lambda p, cin: {  # noqa: E731
    f"{p}.branch1x1": (cin, 320, (1, 1)),
    f"{p}.branch3x3_1": (cin, 384, (1, 1)),
    f"{p}.branch3x3_2a": (384, 384, (1, 3)),
    f"{p}.branch3x3_2b": (384, 384, (3, 1)),
    f"{p}.branch3x3dbl_1": (cin, 448, (1, 1)),
    f"{p}.branch3x3dbl_2": (448, 384, (3, 3)),
    f"{p}.branch3x3dbl_3a": (384, 384, (1, 3)),
    f"{p}.branch3x3dbl_3b": (384, 384, (3, 1)),
    f"{p}.branch_pool": (cin, 192, (1, 1)),
}

CONV_SPECS: Dict[str, Tuple[int, int, Tuple[int, int]]] = {
    "Conv2d_1a_3x3": (3, 32, (3, 3)),
    "Conv2d_2a_3x3": (32, 32, (3, 3)),
    "Conv2d_2b_3x3": (32, 64, (3, 3)),
    "Conv2d_3b_1x1": (64, 80, (1, 1)),
    "Conv2d_4a_3x3": (80, 192, (3, 3)),
    **_A("Mixed_5b", 192, 32), **_A("Mixed_5c", 256, 64),
    **_A("Mixed_5d", 288, 64),
    **_B("Mixed_6a", 288),
    **_C("Mixed_6b", 768, 128), **_C("Mixed_6c", 768, 160),
    **_C("Mixed_6d", 768, 160), **_C("Mixed_6e", 768, 192),
    **_D("Mixed_7a", 768),
    **_E("Mixed_7b", 1280), **_E("Mixed_7c", 2048),
}

FEATURE_DIM = 2048
BN_EPS = 1e-3
RESIZE = 299


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, bias=False, **kw)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg3(x, fid_pools: bool):
    """3x3 / 1 / pad 1 average; ``fid_pools`` divides by the in-bounds
    taps only."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=not fid_pools)


def _branches(block: nn.Module, table: dict, padding: dict,
              stride: dict) -> None:
    """One ``BasicConv2d`` per entry of a ``CONV_SPECS`` block table (its
    keys ``<prefix>.<branch>``)."""
    for key, (ci, co, k) in table.items():
        attr = key.split(".", 1)[1]
        setattr(block, attr, BasicConv2d(
            ci, co, kernel_size=k, padding=padding.get(attr, 0),
            stride=stride.get(attr, 1)))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool: int):
        super().__init__()
        _branches(self, _A("x", cin, pool),
                  {"branch5x5_2": 2, "branch3x3dbl_2": 1,
                   "branch3x3dbl_3": 1}, {})

    def forward(self, x, fid_pools: bool):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg3(x, fid_pools))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        _branches(self, _B("x", cin), {"branch3x3dbl_2": 1},
                  {"branch3x3": 2, "branch3x3dbl_3": 2})

    def forward(self, x, fid_pools: bool):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        _branches(self, _C("x", cin, c7),
                  {"branch7x7_2": (0, 3), "branch7x7_3": (3, 0),
                   "branch7x7dbl_2": (3, 0), "branch7x7dbl_3": (0, 3),
                   "branch7x7dbl_4": (3, 0), "branch7x7dbl_5": (0, 3)}, {})

    def forward(self, x, fid_pools: bool):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg3(x, fid_pools))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        _branches(self, _D("x", cin),
                  {"branch7x7x3_2": (0, 3), "branch7x7x3_3": (3, 0)},
                  {"branch3x3_2": 2, "branch7x7x3_4": 2})

    def forward(self, x, fid_pools: bool):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``last``: ``Mixed_7c``, whose pool branch is a max-pool under
    ``fid_pools``."""

    def __init__(self, cin: int, last: bool):
        super().__init__()
        self.last = last
        _branches(self, _E("x", cin),
                  {"branch3x3_2a": (0, 1), "branch3x3_2b": (1, 0),
                   "branch3x3dbl_2": 1, "branch3x3dbl_3a": (0, 1),
                   "branch3x3dbl_3b": (1, 0)}, {})

    def forward(self, x, fid_pools: bool):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        if self.last and fid_pools:
            pooled = F.max_pool2d(x, 3, 1, 1)
        else:
            pooled = _avg3(x, fid_pools)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(pooled)], 1)


class InceptionV3(nn.Module):
    """(n, 3, 299, 299) images in [-1, 1] -> (n, 2048) pool3 activations.
    Use it in eval mode (BatchNorm from its running statistics)."""

    def __init__(self, fid_pools: bool = True):
        super().__init__()
        self.fid_pools = fid_pools
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, last=False)
        self.Mixed_7c = InceptionE(2048, last=True)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x, self.fid_pools)
        return x.mean(dim=(2, 3))


def load_weights(model: InceptionV3, state_dict: Mapping) -> InceptionV3:
    """Load a pytorch_fid / torchvision / port state dict strictly, its
    ``fc.*`` and ``AuxLogits.*`` entries left out; a missing or surplus
    key or a wrong shape raises. Returns ``model``."""
    sd = {k: v for k, v in state_dict.items()
          if not k.startswith(("fc.", "AuxLogits."))}
    model.load_state_dict(sd, strict=True)
    return model


def preprocess(images01: torch.Tensor, resize_to: int = RESIZE
               ) -> torch.Tensor:
    """(n, h, w, 1|3) images in [0, 1] -> (n, 3, resize_to, resize_to) in
    [-1, 1], as pytorch_fid and the JAX package prepare them: one channel
    repeated to three, a bilinear resize (half-pixel centres, no
    antialias), then ``x * 2 - 1``."""
    x = images01.float().permute(0, 3, 1, 2)
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    if tuple(x.shape[2:]) != (resize_to, resize_to):
        x = F.interpolate(x, size=(resize_to, resize_to), mode="bilinear",
                          align_corners=False, antialias=False)
    return x * 2.0 - 1.0


def features(model: InceptionV3, images01: torch.Tensor,
             resize_to: int = RESIZE) -> torch.Tensor:
    """(n, h, w, 1|3) images in [0, 1] -> (n, 2048) activations (the JAX
    package's ``features``); ``model`` must be in eval mode."""
    return model(preprocess(images01, resize_to))


def inception_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's Inception params (``{name: {kernel, scale, bias,
    mean, var}}``, HWIO kernels) -> the port's state dict (OIHW, BatchNorm
    weight / bias / running_mean / running_var)."""
    sd: Dict[str, torch.Tensor] = {}
    missing = sorted(set(CONV_SPECS) - set(params))
    if missing:
        raise ValueError(f"JAX inception params miss {missing}")
    for name in CONV_SPECS:
        p = params[name]

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32))

        sd[f"{name}.conv.weight"] = t(np.asarray(p["kernel"]
                                                 ).transpose(3, 2, 0, 1))
        sd[f"{name}.bn.weight"] = t(p["scale"])
        sd[f"{name}.bn.bias"] = t(p["bias"])
        sd[f"{name}.bn.running_mean"] = t(p["mean"])
        sd[f"{name}.bn.running_var"] = t(p["var"])
        sd[f"{name}.bn.num_batches_tracked"] = torch.tensor(0)
    return sd


def init_random_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random weights of the production shapes as the port's state dict:
    the numbers the JAX package's ``init_random_params(seed)`` draws, in
    its order, so both packages run one set of weights."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, (cin, cout, k) in CONV_SPECS.items():
        fan_in = cin * k[0] * k[1]
        params[name] = {
            "kernel": rng.normal(
                0, fan_in ** -0.5, (*k, cin, cout)).astype(np.float32),
            "scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
            "bias": rng.normal(0, 0.1, cout).astype(np.float32),
            "mean": rng.normal(0, 0.1, cout).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, cout).astype(np.float32),
        }
    return inception_from_jax(params)
