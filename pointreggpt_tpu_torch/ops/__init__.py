"""Hand-written Hopper kernels (K1, K2) and their plain PyTorch versions.

Kernels build on first use (``_build``); nothing CUDA-specific is imported
or compiled when these modules are imported.
"""
