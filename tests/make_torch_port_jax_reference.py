"""Write ``tests/data/torch_port_jax_reference.npz``: the JAX package's
outputs that the PyTorch port is held to, on the CPU and on the card.

    JAX_PLATFORMS=cpu python tests/make_torch_port_jax_reference.py

Runs the JAX package on the CPU at full production width, from the weights
and inputs that ``pointreggpt_tpu_torch/utils/jax_parity.py`` rebuilds from
its seed (the weights cross over through
``pointreggpt_tpu/utils/torch_port.py``): a baked bf16 DiffusionUNet
forward, an fp32 MaskUNet forward and one ``Generator.step`` body with the
pose and x_T injected (see that module). Then it runs the port on the CPU
and stores its gap to each output beside them (``cpu_gap_*``): the first
part of the card's gate in ``chip_smoke.py``'s ``jax_parity`` phase.
Inputs are not stored; both sides remake them from the seed. Takes a few
minutes on the CPU.
"""

import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from pointreggpt_tpu import config as JC  # noqa: E402
from pointreggpt_tpu.core import geometry as JG  # noqa: E402
from pointreggpt_tpu.core import pointops as JP  # noqa: E402
from pointreggpt_tpu.models import bake  # noqa: E402
from pointreggpt_tpu.utils import torch_port  # noqa: E402
from pointreggpt_tpu_torch.utils import jax_parity as J  # noqa: E402

OUT = REPO / "tests" / "data" / "torch_port_jax_reference.npz"


def _template(module, *inputs):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


def jax_nets(seed: int):
    """The JAX twins of ``jax_parity.nets``, with their params."""
    unet, mask, mask_step = J.nets(seed)
    jm = JC.build_diffusion_unet(JC.ModelConfig())
    jdc = JC.build_mask_unet(JC.MaskModelConfig())
    x1 = jnp.zeros((1, J.H, J.H, 1))
    params = torch_port.port_diffusion_unet(
        unet.state_dict(), _template(jm, x1, jnp.zeros((1,)),
                                     jnp.zeros((1, 4))), num_stages=4)
    dc_tmpl = _template(jdc, x1)
    dc = torch_port.port_mask_unet(mask.state_dict(), dc_tmpl, num_stages=4)
    dc_step = torch_port.port_mask_unet(mask_step.state_dict(), dc_tmpl,
                                        num_stages=4)
    return jm, bake.maybe_bake(params, jm.dtype), jdc, dc, dc_step


def jax_step(jm, params, jdc, dc_params, x):
    """The JAX Generator's step body (``generate/generator.py``,
    ``_build_step_fn``) with the pose and x_T injected."""
    diffusion = JC.build_diffusion(JC.DiffusionConfig(
        sampling_timesteps=J.STEP_SAMPLING_TIMESTEPS, ddim_sampling_eta=0.0),
        jm)

    @jax.jit
    def step(params, dc_params, mem, valid, intr, pc, pose, x_init):
        pts = JG.transform_points(mem, pose)
        depth_rpj, mask_rpj = JG.points_to_depth(pts, valid, intr,
                                                 image_size=(J.H, J.H))
        images_rpj = depth_rpj * 0.1
        keep = jdc.apply(dc_params, images_rpj[..., None])[..., 0] > 0.99
        images_rpj = jnp.where(keep, images_rpj, 0.0)
        mask_rpj = mask_rpj & keep
        img_cond = JG.normalize_to_neg_one_to_one(
            jnp.stack([images_rpj, mask_rpj.astype(jnp.float32)], axis=-1))
        images = diffusion.sample(params, jax.random.PRNGKey(0),
                                  param_cond=pc, img_cond=img_cond,
                                  x_init=x_init)
        images = jnp.where(jdc.apply(dc_params, images) > 0.99, images, 0.0)
        new_pts, new_valid = JG.depth_to_points(images[..., 0] * 10.0, intr,
                                                clip=(0.5, 10.0))
        world = jnp.einsum("bji,bnj->bni", pose[:, :3, :3],
                           new_pts - pose[:, :3, 3][:, None, :],
                           precision=jax.lax.Precision.HIGHEST)
        mem_new, valid_new, overflow = JP.memory_voxel_update(
            mem, valid, world, new_valid, J.MEMORY_VOXEL, J.MEMORY_CAPACITY)
        return images, mask_rpj, mem_new, valid_new, overflow

    out = step(params, dc_params, x["mem"], x["mem_valid"], x["intrinsic"],
               x["step_param_cond"], x["pose"], x["x_init"])
    return J.summarize_step(*(np.asarray(o) for o in out))


def main() -> None:
    seed = J.SEED
    x = J.inputs(seed)
    t0 = time.time()
    jm, params, jdc, dc, dc_step = jax_nets(seed)
    ref = {}
    ref["forward"] = np.asarray(jax.jit(jm.apply)(
        params, x["x"], x["t"], x["param_cond"]), np.float32)
    print(f"forward {time.time() - t0:.1f} s", flush=True)
    ref["mask"] = np.asarray(jax.jit(jdc.apply)(dc, x["mask_x"]),
                             np.float32)
    print(f"mask {time.time() - t0:.1f} s", flush=True)
    ref.update(jax_step(jm, params, jdc, dc_step, x))
    print(f"step {time.time() - t0:.1f} s", flush=True)

    import torch

    torch.set_num_threads(os.cpu_count() or 1)
    port = J.run_port("cpu", seed)
    gap = J.gaps(port, ref)
    print("port on the CPU vs JAX:", gap, flush=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, seed=np.int64(seed), **ref,
                        **{f"cpu_gap_{k}": np.float64(v)
                           for k, v in gap.items()})
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
