"""The registration mixture loaders (Predator / CoFiNet / GeoTransformer)."""

from pointreggpt_tpu_torch.dataloaders.mixture import (
    MixtureDataset,
    MixturePairDataset,
    gaussian_sample_translation,
    generated_pair_paths,
    load_point_cloud,
    uniform_sample_rotation,
)

__all__ = [
    "MixtureDataset",
    "MixturePairDataset",
    "uniform_sample_rotation",
    "gaussian_sample_translation",
    "generated_pair_paths",
    "load_point_cloud",
]
