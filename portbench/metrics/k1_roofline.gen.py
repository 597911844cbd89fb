"""K1's share of its roofline in generation: the least time of the traced
call's bf16 LinearAttention block forwards (the frozen ``work`` of each
block at the configuration's shapes, per block call, at HBM speed or the
bf16 peak) over the device time of K1's bf16 kernels."""

from portbench.lib import work
from portbench.lib.flops import attention_shapes
from portbench.lib.readers import roofline
from portbench.lib.trace import kind


def read(run):
    cfg, tr = run.cell.config, run.cell.traffic
    if cfg["compute_dtype"] != "bf16":
        return None
    blocks, _ = attention_shapes(cfg, cfg["image_size"])
    per_fwd = sum(work.bound_s(work.linear_attention(tr["batch"], n, c, 2),
                               "bf16") for n, c in blocks)
    forwards = tr["num_samples"] * cfg["sampling_timesteps"]
    return roofline(run.trace, lambda a: kind(a.name, a.main_thread) == "k1"
                    and "_tc" in a.name, forwards * per_fwd)
