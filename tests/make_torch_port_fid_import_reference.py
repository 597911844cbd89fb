"""Write the JAX package's side of the port's FID and checkpoint-import
checks to ``tests/data/``:

    JAX_PLATFORMS=cpu python tests/make_torch_port_fid_import_reference.py

- ``torch_port_jax_diffusion.ckpt`` and ``torch_port_jax_mask.ckpt``: a
  small-width DiffusionUNet and MaskUNet Trainer checkpoint (dim 8,
  (1, 1), fp32), written by the JAX package's own ``save_checkpoint``.
  Their weights are ``utils/seeded_weights.py``'s, taken across by
  ``pointreggpt_tpu/utils/torch_port.py``, after three optax steps on
  seeded gradient trees (so the Adam moments and count are not zero); the
  diffusion EMA holds the weights before those steps.
- ``torch_port_fid_import_reference.npz``: the JAX InceptionV3 features
  (299^2, FID pools, ``inception.init_random_params(0)``) of
  ``jax_parity.fid_images()``, the JAX forwards of the two checkpoints'
  weights on ``jax_parity.small_inputs()``, and the port's CPU gap to
  each (``cpu_gap_*``: the port's importer CLI and InceptionFeatures on the
  CPU), the first part of ``chip_smoke.py``'s gates.

Inputs are not stored; both sides remake them from the seed. About a
minute on the CPU.
"""

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from pointreggpt_tpu import config as JC  # noqa: E402
from pointreggpt_tpu.eval import inception as JI  # noqa: E402
from pointreggpt_tpu.train import checkpoint as jckpt  # noqa: E402
from pointreggpt_tpu.train.ema import EMAState  # noqa: E402
from pointreggpt_tpu.utils import torch_port  # noqa: E402
from pointreggpt_tpu_torch import config as C  # noqa: E402
from pointreggpt_tpu_torch.utils import jax_parity as J  # noqa: E402
from pointreggpt_tpu_torch.utils.seeded_weights import fill_seeded  # noqa

DATA = REPO / "tests" / "data"
OUT = DATA / "torch_port_fid_import_reference.npz"
DIFFUSION_CKPT = DATA / "torch_port_jax_diffusion.ckpt"
MASK_CKPT = DATA / "torch_port_jax_mask.ckpt"
STEPS = 3
GRAD_NORMS = (3.0, 0.5, 1.0)  # clipped, not clipped, at the edge
MASK_STEPS_PER_EPOCH = 2  # the schedule falls once within the 3 steps


def _template(module, *inputs):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


def _steps(tx, params, seed):
    """``STEPS`` optax updates of ``params`` on seeded gradient trees of
    the ``GRAD_NORMS`` global norms."""
    rng = np.random.default_rng(seed)
    state = tx.init(params)
    for norm in GRAD_NORMS:
        g = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            params)
        total = np.sqrt(sum(float(np.sum(a ** 2))
                            for a in jax.tree_util.tree_leaves(g)))
        g = jax.tree_util.tree_map(lambda a: a * np.float32(norm / total), g)
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, state))


def write_checkpoints(seed: int):
    """Both ``.ckpt`` files; returns the JAX (model, params) of each."""
    x1 = jnp.zeros((1, J.SMALL_H, J.SMALL_H, 1))
    jm = JC.build_diffusion_unet(JC.ModelConfig(
        dim=8, dim_mults=(1, 1), bf16=False))
    unet = fill_seeded(C.build_diffusion_unet(J.SMALL_MODEL), seed)
    params0 = torch_port.port_diffusion_unet(
        unet.state_dict(), _template(jm, x1, jnp.zeros((1,)),
                                     jnp.zeros((1, 4))), num_stages=2)
    tcfg = JC.TrainConfig()
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adam(tcfg.train_lr, b1=0.9, b2=0.99))
    params, opt_state = _steps(tx, params0, seed + 10)
    jckpt.save_checkpoint(
        DIFFUSION_CKPT,
        {"step": STEPS, "params": params, "opt_state": opt_state,
         "ema": EMAState(params=params0, step=np.asarray(STEPS, np.int32),
                         initted=np.asarray(False))},
        meta={"milestone": "7", "version": "pointreggpt-tpu"})

    jdc = JC.build_mask_unet(JC.MaskModelConfig(dim=8, dim_mults=(1, 1)))
    mask = fill_seeded(C.build_mask_unet(J.SMALL_MASK), seed + 1,
                       mask_out_bias=None)
    dc0 = torch_port.port_mask_unet(mask.state_dict(), _template(jdc, x1),
                                    num_stages=2)
    mcfg = JC.MaskTrainConfig()
    schedule = optax.exponential_decay(
        mcfg.train_lr, transition_steps=MASK_STEPS_PER_EPOCH,
        decay_rate=mcfg.lr_gamma, staircase=True)
    mtx = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adam(schedule, b1=0.9, b2=0.99))
    dc, dc_opt = _steps(mtx, dc0, seed + 11)
    jckpt.save_checkpoint(
        MASK_CKPT, {"epoch": 1, "params": dc, "opt_state": dc_opt},
        meta={"loss_hist": [0.75, 0.5], "best_metrics": {"SAE": 0.25}})
    return (jm, params), (jdc, dc)


def main() -> None:
    seed = J.SEED
    t0 = time.time()
    DATA.mkdir(parents=True, exist_ok=True)
    (jm, params), (jdc, dc) = write_checkpoints(seed)
    x = J.small_inputs(seed)
    ref = {
        "diffusion_forward": np.asarray(jax.jit(jm.apply)(
            params, x["x"], x["t"], x["param_cond"]), np.float32),
        "mask_forward": np.asarray(jax.jit(jdc.apply)(dc, x["mask_x"]),
                                   np.float32)}
    print(f"checkpoints and forwards {time.time() - t0:.1f} s", flush=True)
    ref["fid_features"] = np.asarray(jax.jit(
        lambda p, im: JI.features(p, im, fid_pools=True))(
            JI.init_random_params(J.INCEPTION_SEED), J.fid_images(seed)),
        np.float32)
    print(f"features {time.time() - t0:.1f} s", flush=True)

    # the port on the CPU, through its importer CLI and InceptionFeatures
    import torch

    from pointreggpt_tpu_torch.eval import inception
    from pointreggpt_tpu_torch.eval.fid import InceptionFeatures

    torch.set_num_threads(os.cpu_count() or 1)
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PRGPT_PLATFORM="cpu", PYTHONPATH=str(REPO))
        subprocess.run(
            [sys.executable, "-m",
             "pointreggpt_tpu_torch.cli.import_torch_checkpoint",
             "--diffusion", str(DIFFUSION_CKPT), "--depth_correction",
             str(MASK_CKPT), "--milestone", "7", "--diffusion_out", tmp,
             "--dc_out", tmp + "/dc", *J.SMALL_FLAGS], check=True, env=env)
        port = J.import_forwards(f"{tmp}/model-7.pt", f"{tmp}/dc/model-7.pt",
                                 "cpu")
    port["fid_features"] = InceptionFeatures(
        state_dict=inception.init_random_params(J.INCEPTION_SEED),
        device="cpu")(J.fid_images(seed))
    gap = {k: float(np.abs(port[k] - ref[k]).max()) for k in ref}
    print("port on the CPU vs JAX:", gap, flush=True)
    np.savez_compressed(OUT, seed=np.int64(seed), **ref,
                        **{f"cpu_gap_{k}": np.float64(v)
                           for k, v in gap.items()})
    for p in (OUT, DIFFUSION_CKPT, MASK_CKPT):
        print(f"wrote {p} ({p.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
