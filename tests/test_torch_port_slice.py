"""PyTorch port, the slice as a whole: one ``Generator.generate`` run on a
synthetic tree writes exactly the file set the JAX Generator writes on the
same tree, with the same weights (CPU)."""

import numpy as np
from PIL import Image

from pointreggpt_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from pointreggpt_tpu.generate import Generator as JGenerator
from pointreggpt_tpu.train import checkpoint as ckpt
from pointreggpt_tpu_torch.diffusion import GaussianDiffusion
from pointreggpt_tpu_torch.generate import Generator
from test_torch_port_generator import (CAP, DIFF_KW, H, files,  # noqa: F401
                                       make_nets, save_port_checkpoints,
                                       single_torch_thread, write_tree)


def test_generate_writes_the_jax_file_set(tmp_path, monkeypatch):
    # one U-Net stage: the file set does not depend on depth, and the JAX
    # step's compile time does
    jm, params, jdc, dc_params, tm, tdc = make_nets(seed=1, dim_mults=(1,))
    monkeypatch.chdir(tmp_path)
    folder, data_root, info = write_tree(tmp_path)

    save_port_checkpoints(tmp_path, tm, tdc)
    gen = Generator(
        tm, GaussianDiffusion(ddim_sampling_eta=1.0, **DIFF_KW), folder,
        batch_size=2, results_folder=str(tmp_path / "results"),
        samples_folder=str(tmp_path / "port/data"),
        depth_correction_model=tdc,
        depth_correction_results=str(tmp_path / "dc_results"),
        data_root=data_root, memory_capacity=CAP, device="cpu")
    gen.load(1)
    gen.generate(0, 2, num_samples=2, has_refine_step=False,
                 info_train=info, verbose=False)

    ckpt.save_checkpoint(tmp_path / "jres/model-1.ckpt",
                         {"params": params,
                          "ema": {"params": params, "step": 0,
                                  "initted": True}})
    ckpt.save_checkpoint(tmp_path / "jdc/model-best.ckpt",
                         {"epoch": 0, "params": dc_params})
    jgen = JGenerator(
        jm, JGaussianDiffusion(
            apply_fn=lambda p, x, t, pc: jm.apply(p, x, t, pc),
            ddim_sampling_eta=1.0, **DIFF_KW), folder,
        batch_size=2, results_folder=str(tmp_path / "jres"),
        samples_folder=str(tmp_path / "jax/data"),
        depth_correction_model=jdc,
        depth_correction_results=str(tmp_path / "jdc"),
        data_root=data_root, memory_capacity=CAP)
    jgen.load(1)
    jgen.generate(0, 2, num_samples=2, has_refine_step=False,
                  info_train=info, verbose=False)

    port_files = files(tmp_path / "port/data")
    assert port_files == files(tmp_path / "jax/data")
    assert "scene-000001/sample-000002.depth.png" in port_files
    # the seed frame and its intrinsics are the same host computation
    for f in ("scene-000000/camera-intrinsics.txt",
              "scene-000000/sample-000000.image.png"):
        assert (tmp_path / "port/data" / f).read_bytes() == \
            (tmp_path / "jax/data" / f).read_bytes()
    depth = np.asarray(Image.open(
        tmp_path / "port/data/scene-000000/sample-000002.depth.png"))
    assert depth.shape == (H, H) and depth.dtype == np.uint16
    assert depth.max() > 0
