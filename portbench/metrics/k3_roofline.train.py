"""K3's share of its roofline in training: the least time of the traced
steps' LinearAttention block backwards (the frozen ``work_bwd`` per block
call at the configuration's shapes, at HBM speed or the bf16 peak) over the
device time of K3's kernels (its own, and K1's statistics kernels that
the backward's thread launches)."""

from portbench.lib import work
from portbench.lib.flops import attention_shapes
from portbench.lib.readers import roofline
from portbench.lib.trace import kind


def read(run):
    cfg, tr = run.cell.config, run.cell.traffic
    if cfg["compute_dtype"] != "bf16":
        return None
    blocks, _ = attention_shapes(cfg, cfg["image_size"])
    per_mb = sum(work.bound_s(work.linear_attention_bwd(
        tr["microbatch"], n, c, 2), "bf16") for n, c in blocks)
    calls = tr["traced_steps"] * tr["accumulate"]
    return roofline(run.trace,
                    lambda a: kind(a.name, a.main_thread) == "k3",
                    calls * per_mb)
