"""FID: Fréchet distance and InceptionV3 activation statistics.

Port of ``pointreggpt_tpu/eval/fid.py``. The Fréchet distance is numpy /
scipy, as in the JAX package; the features are the port's InceptionV3
(:mod:`pointreggpt_tpu_torch.eval.inception`) on the card, fp32 with TF32
off. FID is off by default in the training entry point
(``--calculate_fid``).

Weights come from the first source that works: ``weights_path`` or
``$PRGPT_INCEPTION_WEIGHTS`` (a ``.pth`` state dict, e.g. pytorch_fid's
``pt_inception-2015-12-05``), then the ``pytorch_fid`` package, then
``torchvision``; each package is imported inside a ``try``. A machine with
neither package reads only the first.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from pointreggpt_tpu_torch import resolve_device
from pointreggpt_tpu_torch.eval import inception


def calculate_frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                               mu2: np.ndarray, sigma2: np.ndarray,
                               eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians (Heusel et al. 2017), as
    pytorch_fid computes it: the trace of ``sqrtm(sigma1 sigma2)``, with
    ``eps`` added to both diagonals when that root is not finite; raises
    when the root keeps a large imaginary diagonal."""
    import warnings

    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    with warnings.catch_warnings():
        # singular products are expected; the eps fallback handles them
        warnings.simplefilter("ignore")
        covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        # a root that failed numerically can be finite with a large
        # imaginary diagonal: its real part is no valid FID
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m} in matrix sqrt — "
                             "FID is not numerically valid for these "
                             "activation statistics")
        covmean = covmean.real

    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) -
                 2 * np.trace(covmean))


def activation_statistics(
        features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(n, d) activations -> (mu, sigma)."""
    return np.mean(features, axis=0), np.cov(features, rowvar=False)


def _load_inception_state_dict(weights_path: Optional[str]
                               ) -> Tuple[Mapping, bool]:
    """``(state_dict, fid_pools)`` from the first source that works:
    ``weights_path`` or ``$PRGPT_INCEPTION_WEIGHTS`` (weights-only
    ``torch.load``), pytorch_fid's FID weights, torchvision's
    ``inception_v3``. The file and pytorch_fid hold the FID variant
    (``fid_pools`` True); torchvision's weights were trained with its
    plain pools and run that way."""
    path = weights_path or os.environ.get("PRGPT_INCEPTION_WEIGHTS")
    if path:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        return sd, True
    try:
        from pytorch_fid.inception import fid_inception_v3  # type: ignore

        return fid_inception_v3().state_dict(), True
    except ImportError:
        pass
    except Exception as e:
        # pytorch_fid is installed but cannot give its weights; torchvision
        # uses other pools, so its scores are on another scale
        import warnings

        warnings.warn(
            f"pytorch_fid present but unusable ({type(e).__name__}: {e}); "
            "falling back to torchvision inception weights — FID values "
            "are NOT comparable with pytorch_fid-based runs",
            RuntimeWarning)
    try:
        import torchvision  # type: ignore

        return torchvision.models.inception_v3(
            weights="DEFAULT", aux_logits=True).state_dict(), False
    except Exception as e:
        raise ImportError(
            "FID needs InceptionV3 weights: pass weights_path or set "
            "PRGPT_INCEPTION_WEIGHTS to a .pth state dict of the FID "
            "InceptionV3 (pytorch_fid's pt_inception-2015-12-05 file); "
            "neither pytorch_fid nor torchvision gave weights here. FID is "
            "optional (calculate_fid is off by default).") from e


class InceptionFeatures:
    """InceptionV3 pool3 (2048-d) activations of [0, 1] images, on the
    card.

    The module lives on ``device`` in fp32 and runs with TF32 off, in
    chunks of ``chunk`` images; the last chunk is not padded (the JAX
    package pads it only so XLA compiles one shape, and eval-mode
    BatchNorm couples no samples). ``state_dict`` skips the weight
    sources (e.g. ``inception.init_random_params(seed)``).
    """

    resize_to = inception.RESIZE

    def __init__(self, block_dim: int = inception.FEATURE_DIM,
                 weights_path: Optional[str] = None,
                 state_dict: Optional[Mapping] = None, chunk: int = 32,
                 fid_pools: Optional[bool] = None, device=None):
        if block_dim != inception.FEATURE_DIM:
            raise ValueError(
                f"only the {inception.FEATURE_DIM}-d pool3 block is "
                f"supported (got {block_dim})")
        self.block_dim = block_dim
        self.chunk = chunk
        self.device = resolve_device(device)
        if state_dict is None:
            state_dict, source_fid_pools = _load_inception_state_dict(
                weights_path)
            if fid_pools is None:
                fid_pools = source_fid_pools
        model = inception.InceptionV3(True if fid_pools is None
                                      else fid_pools)
        self.model = inception.load_weights(model, state_dict).eval().to(
            self.device)

    @property
    def fid_pools(self) -> bool:
        return self.model.fid_pools

    @torch.inference_mode()
    def __call__(self, images01: np.ndarray) -> np.ndarray:
        """(n, h, w, 1|3) [0, 1] images -> (n, 2048) activations."""
        x = np.asarray(images01, np.float32)
        if x.ndim != 4:
            raise ValueError(f"expected (n, h, w, c) images, got {x.shape}")
        out = np.empty((x.shape[0], self.block_dim), np.float32)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            for lo in range(0, x.shape[0], self.chunk):
                part = torch.from_numpy(x[lo:lo + self.chunk]).to(
                    self.device)
                out[lo:lo + len(part)] = inception.features(
                    self.model, part, self.resize_to).cpu().numpy()
        return out


def fid_score(real_images01: np.ndarray, fake_images01: np.ndarray,
              extractor: Optional[InceptionFeatures] = None) -> float:
    """FID between two [0, 1] image batches, over the first ``n`` of each,
    ``n`` the smaller batch size."""
    if extractor is None:
        extractor = InceptionFeatures()
    n = min(real_images01.shape[0], fake_images01.shape[0])
    m1, s1 = activation_statistics(extractor(real_images01[:n]))
    m2, s2 = activation_statistics(extractor(fake_images01[:n]))
    return calculate_frechet_distance(m1, s1, m2, s2)
