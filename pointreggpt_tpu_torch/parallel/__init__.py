"""Data parallelism over GPUs under torchrun (see :mod:`.mesh`)."""

from pointreggpt_tpu_torch.parallel.mesh import (
    Rows,
    all_reduce_mean_,
    all_reduce_sum_host,
    barrier,
    broadcast_module_,
    gather_to_main,
    in_process_group,
    is_main_process,
    local_device,
    local_rank,
    local_scene_range,
    maybe_initialize_distributed,
    process_count,
    process_group,
    process_index,
    rank_rows,
)

__all__ = [
    "Rows",
    "all_reduce_mean_",
    "all_reduce_sum_host",
    "barrier",
    "broadcast_module_",
    "gather_to_main",
    "in_process_group",
    "is_main_process",
    "local_device",
    "local_rank",
    "local_scene_range",
    "maybe_initialize_distributed",
    "process_count",
    "process_group",
    "process_index",
    "rank_rows",
]
