"""K2's share of its roofline in generation with the ADM: the least time of
the traced call's bf16 attention calls at d = 64 (``lib/adm_work.py``:
each block's call at the configuration's shapes, at HBM speed or the bf16
peak, 16 a forward at the published flags) over the device time of K2's
bf16 kernels. The traced call's ``attn_k2_d64`` count has to be the
calls counted here; a program without that counter, or a run in which K2
never launched (the CPU's plain path), reads nothing."""

from portbench.lib import work
from portbench.lib.adm_work import k2_call, k2_calls
from portbench.lib.readers import roofline
from portbench.lib.trace import kind


def read(run):
    cfg, tr = run.cell.config, run.cell.traffic
    routes = run.record.get("traced_routes")
    if run.trace is None or not routes or not routes["attn_k2_d64"]:
        return None
    calls = k2_calls(cfg, cfg["image_size"])
    forwards = tr["num_samples"] * (cfg["sampling_timesteps"] +
                                    (1 if tr["has_refine_step"] else 0))
    if routes["attn_k2_d64"] != forwards * len(calls):
        raise ValueError(f"k2_roofline.adm: {routes['attn_k2_d64']} K2 "
                         f"calls at d = 64 in the traced call, not "
                         f"{forwards} x {len(calls)}")
    bound = forwards * sum(work.bound_s(k2_call(tr["batch"], n, h, d), "bf16")
                           for n, h, d in calls)
    return roofline(run.trace, lambda a: kind(a.name, a.main_thread) == "k2"
                    and "flash_fwd_tc" in a.name, bound)
