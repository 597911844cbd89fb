"""Dataclass configs with CLI overrides, and the builders of live objects.

Own copy of the generation, diffusion-training, mask-training and gt.log
configs of ``pointreggpt_tpu/config.py`` (same fields and defaults, so the
port's CLIs take the same flags), with builders that make the port's torch
modules.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, fields
from typing import Optional, Tuple, Type, TypeVar

import torch

T = TypeVar("T")


@dataclass(frozen=True)
class ModelConfig:
    """DiffusionUNet hyperparameters."""

    dim: int = 64
    param_cond_dim: int = 4
    dim_mults: Tuple[int, ...] = (1, 2, 4, 8)
    channels: int = 1
    resnet_block_groups: int = 8
    # dormant reference surface, off in every entry script; not ported yet
    learned_variance: bool = False
    learned_sinusoidal_cond: bool = False
    random_fourier_features: bool = False
    learned_sinusoidal_dim: int = 16
    bf16: bool = True  # compute dtype on the card
    remat: bool = False  # ResnetBlock recompute in training (memory)


@dataclass(frozen=True)
class MaskModelConfig:
    """MaskUNet hyperparameters."""

    dim: int = 64
    dim_mults: Tuple[int, ...] = (1, 2, 4, 8)
    resnet_block_groups: int = 8
    bf16: bool = False  # fp32 default: mask thresholding at 0.99 is tight


@dataclass(frozen=True)
class DiffusionConfig:
    """GaussianDiffusion hyperparameters."""

    image_size: int = 256
    timesteps: int = 1000
    sampling_timesteps: int = 250
    loss_type: str = "l1"
    objective: str = "pred_x0"
    beta_schedule: str = "sigmoid"
    ddim_sampling_eta: float = 0.0
    is_ddnm_sampling: bool = True
    ddnm_sampling_dropout: float = 0.0
    ddnm_dropout_schedule: str = "none"


@dataclass(frozen=True)
class TrainConfig:
    """Diffusion Trainer hyperparameters (train_successive_ddnm_diffusion)."""

    data: str = "/path/to/3DMatch-RGBD/train"
    gt_log: str = "./dataset/3DMatch/metadata/gt.log"
    train_batch_size: int = 32
    train_lr: float = 8e-5
    train_num_steps: int = 2_000_000
    gradient_accumulate_every: int = 2
    augment_horizontal_flip: bool = True
    ema_decay: float = 0.995
    ema_update_every: int = 10
    save_and_sample_every: int = 1000
    num_samples: int = 25
    results_folder: str = "./successive_ddnm_diffusion_results"
    samples_folder: str = "./successive_ddnm_diffusion_samples"
    calculate_fid: bool = False
    # 0 = auto (os.cpu_count())
    num_workers: int = 0
    seed: int = 0


@dataclass(frozen=True)
class MaskTrainConfig:
    """Depth-correction trainer hyperparameters (train_depth_correction)."""

    data: str = "./dataset/depth_correction"
    image_size: int = 256
    train_batch_size: int = 4
    train_lr: float = 4e-5
    lr_gamma: float = 0.95
    epochs: int = 100
    # validation batch; metrics are per item, so it does not change them
    val_batch_size: int = 8
    results_folder: str = "./depth_correction_results"
    samples_folder: str = "./depth_correction_samples"
    num_workers: int = 0  # 0 = auto (os.cpu_count())
    seed: int = 0


@dataclass(frozen=True)
class GenerateConfig:
    """Generator hyperparameters (generate_dataset.py)."""

    data: str = "/path/to/3DMatch-RGBD/train"
    dataset_name: str = "generated_dataset"
    batch_size: int = 8
    num_samples: int = 1
    memory_voxel_size: float = 0.002
    save_voxel_size: float = 0.025
    has_refine_step: bool = False
    memory_capacity: int = 1 << 18
    train_info_path: str = "./dataset/indoor/metadata/train_info.pkl"
    data_root: str = "./dataset/indoor/data"
    results_folder: str = "./successive_ddnm_diffusion_results"
    seed: int = 0


@dataclass(frozen=True)
class GtLogConfig:
    """gt.log overlap-metadata constants (generate_gt.py)."""

    dataset_name: str = "generated_dataset"
    num_samples: int = 2
    min_points: int = 1000
    min_overlap: float = 0.1
    voxel_size: float = 0.025
    overlap_factor: float = 1.5


def _parse_bool(s: str) -> bool:
    """Strict boolean flag vocabulary: a typo is an argparse error."""
    v = s.lower()
    if v in ("1", "true", "yes"):
        return True
    if v in ("0", "false", "no"):
        return False
    raise argparse.ArgumentTypeError(
        f"expected one of 1/0/true/false/yes/no, got {s!r}")


def add_dataclass_args(parser: argparse.ArgumentParser, cls: Type[T],
                       prefix: str = "",
                       defaults: Optional[T] = None) -> None:
    """Register every dataclass field as a ``--{prefix}{name}`` flag."""
    base = defaults if defaults is not None else cls()
    for f in fields(cls):
        name = f"--{prefix}{f.name}"
        default = getattr(base, f.name)
        if isinstance(default, bool):
            parser.add_argument(name, type=_parse_bool, default=default)
        elif isinstance(default, tuple):
            parser.add_argument(
                name, type=lambda s: tuple(int(x) for x in s.split(",")),
                default=default)
        else:
            parser.add_argument(name, type=type(default), default=default)


def from_args(args: argparse.Namespace, cls: Type[T],
              prefix: str = "") -> T:
    return cls(**{f.name: getattr(args, f"{prefix}{f.name}")
                  for f in fields(cls)})


def _dtype(bf16: bool) -> torch.dtype:
    return torch.bfloat16 if bf16 else torch.float32


def build_diffusion_unet(cfg: ModelConfig):
    from pointreggpt_tpu_torch.models import DiffusionUNet

    return DiffusionUNet(dim=cfg.dim, param_cond_dim=cfg.param_cond_dim,
                         dim_mults=cfg.dim_mults, channels=cfg.channels,
                         resnet_block_groups=cfg.resnet_block_groups,
                         dtype=_dtype(cfg.bf16), remat=cfg.remat,
                         learned_variance=cfg.learned_variance,
                         learned_sinusoidal_cond=cfg.learned_sinusoidal_cond,
                         random_fourier_features=cfg.random_fourier_features,
                         learned_sinusoidal_dim=cfg.learned_sinusoidal_dim)


def build_mask_unet(cfg: MaskModelConfig):
    from pointreggpt_tpu_torch.models import MaskUNet

    return MaskUNet(dim=cfg.dim, dim_mults=cfg.dim_mults,
                    resnet_block_groups=cfg.resnet_block_groups,
                    dtype=_dtype(cfg.bf16))


def build_diffusion(cfg: DiffusionConfig, model=None):
    """The GaussianDiffusion of ``cfg`` for ``model``, whose channels it
    takes (one channel with no model).

    Refuses what the JAX package's ``build_diffusion`` refuses, with its
    messages: a ``learned_variance`` net (its 2x head would broadcast
    against the 1-channel target) and the Fourier time embeddings.
    """
    from pointreggpt_tpu_torch.diffusion import GaussianDiffusion

    if getattr(model, "learned_variance", False):
        raise ValueError(
            "GaussianDiffusion requires model.channels == out channels; "
            "learned_variance=True doubles the output head (reference "
            "asserts this away at construction, sdd:1032-1033)")
    if getattr(model, "learned_sinusoidal_cond", False) or \
            getattr(model, "random_fourier_features", False):
        raise ValueError(
            "GaussianDiffusion does not support random/learned sinusoidal "
            "time embeddings (reference assert, sdd:1034)")
    return GaussianDiffusion(
        image_size=cfg.image_size,
        channels=1 if model is None else model.channels,
        timesteps=cfg.timesteps, sampling_timesteps=cfg.sampling_timesteps,
        loss_type=cfg.loss_type, objective=cfg.objective,
        beta_schedule=cfg.beta_schedule,
        ddim_sampling_eta=cfg.ddim_sampling_eta,
        is_ddnm_sampling=cfg.is_ddnm_sampling,
        ddnm_sampling_dropout=cfg.ddnm_sampling_dropout,
        ddnm_dropout_schedule=cfg.ddnm_dropout_schedule)
