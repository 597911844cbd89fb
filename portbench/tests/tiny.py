"""Sizes a CPU test run holds: each cell's configuration and traffic cut in
width, depth and batch (the cells themselves run at published widths on
the card only)."""

TINY_MASK = {"net": "MaskUNet", "dim": 8, "dim_mults": [1, 2],
             "resnet_block_groups": 4, "compute_dtype": "fp32",
             "ws_eps": 1e-5, "image_size": 32, "mask_out_bias": 6.0,
             "control": "tf32"}

OVERRIDES = {
    "gen.ddnm_unet64.b8": {
        "config": {"dim": 8, "dim_mults": [1, 2], "resnet_block_groups": 4,
                   "image_size": 32, "sampling_timesteps": 4,
                   "mask_net": TINY_MASK},
        "traffic": {"batch": 2, "scene_pool": 3, "frame_height": 48,
                    "frame_width": 64, "memory_capacity": 4096,
                    "reference_rows": 2}},
    "train.ddnm_unet64": {
        "config": {"dim": 8, "dim_mults": [1, 2], "resnet_block_groups": 4,
                   "image_size": 32},
        "traffic": {"microbatch": 2, "accumulate": 2, "frames": 8,
                    "distinct_frames": 3,
                    "frame_height": 48, "frame_width": 64,
                    "traced_steps": 2, "reference_rows": 1}},
    "mask_train.mask_unet64": {
        "config": {"dim": 8, "dim_mults": [1, 2], "resnet_block_groups": 4,
                   "image_size": 32},
        "traffic": {"batch": 2, "train_pairs": 6, "val_pairs": 2,
                    "traced_steps": 2}},
}

# what the port reads against the reference at these sizes on the CPU
# (bf16 at dim 8 is coarser than at the published widths; the cells'
# own limits are set from chip runs at full size)
TINY_LIMITS = {
    "gen.ddnm_unet64.b8": {"splat_gap": 1e-3, "unet_gap": 0.05, "chain_gap": 0.03,
                           "mask_gap": 1e-4, "cloud_gap": 1e-5,
                           "memory_gap": 1e-3, "ply_gap": 1e-3,
                           "frame_mismatch": 0},
    "train.ddnm_unet64": {"fwd_gap": 0.05, "loss_gap": 0.01,
                          "loss_own_gap": 1e-3,
                          "update_gap": 0.4, "ema_gap": 1e-3},
    "mask_train.mask_unet64": {"loss_gap": 1e-5, "grad_gap": 1e-4,
                               "update_gap": 1e-3},
}
