"""Training on one GPU: the diffusion Trainer with its EMA, the
depth-correction MaskTrainer and MaskTester, checkpoints and logging."""
