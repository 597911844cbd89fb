"""Diffusion training on one GPU: the Trainer, its EMA, checkpoints and
logging."""
