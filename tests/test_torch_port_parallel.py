"""PyTorch port, data parallelism on the CPU: two processes over gloo
(``tools/dryrun_multiprocess.launch``, each launch under its own time
limit) against one process on the same global batch, at dim 8 and 32^2;
the mesh helpers against the JAX package's.

The functions the processes run live at this module's top level and
import no JAX: each process imports this module afresh.
"""

import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from pointreggpt_tpu_torch import resolve_device
from pointreggpt_tpu_torch.parallel import mesh as M
from pointreggpt_tpu_torch.tools import dryrun_multiprocess as DR

LAUNCH_S = 120  # wall-clock limit of each two-process launch
H = 32
# fp32 on both sides: N processes sum the same terms as one in another
# order (the batch mean, the all-reduce), a few 1e-7 relative
GRAD_RTOL = 1e-5
METRIC_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread here, as in every launched process: the suite
    runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _launch(fn, *args):
    return DR.launch(fn, 2, args=args, platform="cpu", backend="gloo",
                     timeout_s=LAUNCH_S)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _written(folder: Path):
    return sorted(p.name for p in Path(folder).glob("model-*.pt"))


# ---------------------------------------------------------------------------
# the helpers, in one process

@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_local_scene_range_matches_jax(monkeypatch, rank, world):
    import jax

    from pointreggpt_tpu.parallel import mesh as JM

    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(M, "process_index", lambda: rank)
    monkeypatch.setattr(M, "process_count", lambda: world)
    for start, stop in ((0, 10), (3, 8), (5, 6), (4, 4)):
        assert list(M.local_scene_range(start, stop)) == \
            list(JM.local_scene_range(start, stop))


@pytest.mark.parametrize("total,world", [(8, 2), (4, 3), (1, 2), (0, 2),
                                         (5, 1)])
def test_rank_rows_split_as_array_split(total, world):
    want = np.array_split(np.arange(total), world)
    for rank in range(world):
        rows = M.rank_rows(total, rank, world)
        assert rows.total == total
        np.testing.assert_array_equal(np.arange(total)[rows.start:rows.stop],
                                      want[rank])


def _clear_torchrun_env(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("only", ["RANK", "WORLD_SIZE"])
def test_initialize_needs_rank_and_world_size_together(monkeypatch, only):
    _clear_torchrun_env(monkeypatch)
    monkeypatch.setenv(only, "1")
    with pytest.raises(ValueError, match="together"):
        M.maybe_initialize_distributed()


def test_initialize_is_a_no_op_outside_torchrun(monkeypatch):
    _clear_torchrun_env(monkeypatch)
    assert M.maybe_initialize_distributed() is False
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert M.maybe_initialize_distributed() is False  # no MASTER_ADDR
    assert not M.in_process_group()
    assert (M.process_index(), M.process_count()) == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="maybe_initialize_distributed"):
        M.process_count()


def test_resolve_device_takes_the_local_rank(monkeypatch):
    monkeypatch.delenv("PRGPT_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert resolve_device() == torch.device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert resolve_device() == torch.device("cuda", 3)
    assert resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    assert resolve_device() == torch.device("cpu")


def test_trainer_refuses_a_batch_the_processes_do_not_divide(
        tmp_path, monkeypatch):
    folder, gt_log = DR.write_depth_tree(tmp_path, n_frames=4)
    monkeypatch.setattr(M, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="must divide over 2 processes"):
        DR.build_trainer(folder, gt_log, str(tmp_path / "r"),
                         full_width=False, global_batch=3)


def test_gather_and_reductions_outside_a_group():
    assert M.gather_to_main({"a": 1}) == [{"a": 1}]
    g = [torch.ones(3), torch.full((2, 2), 2.0)]
    M.all_reduce_mean_(g)
    assert g[0].tolist() == [1.0] * 3 and g[1].sum().item() == 8.0
    np.testing.assert_array_equal(M.all_reduce_sum_host([1.5, 2.0]),
                                  [1.5, 2.0])


# ---------------------------------------------------------------------------
# the diffusion Trainer: two processes against one

TRAIN_BATCH = 4  # global microbatch: 2 rows a process
TRAIN_STEPS = 2


def _trainer_run(root: str, results: str) -> dict:
    """TRAIN_STEPS Trainer steps at the global microbatch: the gradient
    each step hands the clip, the loss and the replica digest after each
    step, the checkpoints written."""
    from pointreggpt_tpu_torch.train import trainer as T

    grads, digests, losses = [], [], []
    clip = T.clip_by_global_norm_

    def spy(gs, max_norm):
        grads.append(torch.cat([g.reshape(-1) for g in gs]).cpu().numpy())
        return clip(gs, max_norm)

    T.clip_by_global_norm_ = spy
    try:
        tr = DR.build_trainer(str(Path(root) / "rgbd"),
                              str(Path(root) / "gt.log"), results,
                              full_width=False, global_batch=TRAIN_BATCH,
                              steps=TRAIN_STEPS)
        step = tr.train_step

        def recorded(*a):
            loss = step(*a)
            losses.append(loss.item())
            digests.append(DR.digest(tr.ema))
            return loss

        tr.train_step = recorded
        tr.train(log_every=1)
        tr.save(0)
    finally:
        T.clip_by_global_norm_ = clip
    return dict(grads=grads, losses=losses, digests=digests,
                wrote=_written(Path(results)), rows=tuple(tr.rows))


def _trainer_rank(root: str) -> dict:
    return _trainer_run(root, str(Path(root) / f"results-{M.process_index()}"))


def test_two_process_trainer_step_matches_one_process(tmp_path,
                                                      monkeypatch):
    DR.write_depth_tree(tmp_path, n_frames=8)
    ranks = _launch(_trainer_rank, str(tmp_path))
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    one = _trainer_run(str(tmp_path), str(tmp_path / "results-one"))
    assert [r["rows"] for r in ranks] == [(0, 2, 4), (2, 4, 4)]
    assert one["rows"] == (0, 4, 4)
    # replicas: bit-identical after every step
    assert ranks[0]["digests"] == ranks[1]["digests"]
    assert len(ranks[0]["grads"]) == TRAIN_STEPS
    for g0, g1 in zip(ranks[0]["grads"], ranks[1]["grads"]):
        np.testing.assert_array_equal(g0, g1)
    # the averaged gradient of step 1 is the one process's on the batch
    rel = _rel(ranks[0]["grads"][0], one["grads"][0])
    assert rel <= GRAD_RTOL, rel
    # a planted fault misses it: no division by the process count
    assert _rel(2 * ranks[0]["grads"][0], one["grads"][0]) > 100 * GRAD_RTOL
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"],
                               rtol=GRAD_RTOL)
    # rank 0 alone writes the checkpoint
    assert [r["wrote"] for r in ranks] == [["model-0.pt"], []]


# ---------------------------------------------------------------------------
# the Trainer's milestone FID: its real set is the whole global batch

FID_RESIZE = 75  # InceptionFeatures' input size, for CPU time
FID_ACCUM = 2  # microbatches a step: the gathered rows keep their order
FID_SAMPLES = 9  # the EMA grid: at least the global batch's 8 images
# the fake images: EMA weights that the two runs sum in another order
# (GRAD_RTOL), through 4 DDIM steps and the Inception net; the score
# measured 1.1e-7 apart, and rank 0's own rows as the real set 5e-3
FID_RTOL = 1e-4


def _fid_stand_in(m1, s1, m2, s2) -> float:
    """The distance without its 2048-d matrix square root (seconds a call
    on the CPU; ``test_torch_port_fid.py`` holds the real one to JAX)."""
    return float(np.sum((m1 - m2) ** 2) + np.trace(s1) + np.trace(s2))


def _fid_run(root: str, results: str, weights: str) -> dict:
    """One Trainer step of FID_ACCUM microbatches of TRAIN_BATCH and a
    milestone with ``calculate_fid``: the statistics handed to the
    distance, the ``fid_score`` lines logged and the last batch."""
    from pointreggpt_tpu_torch.eval import fid

    os.environ["PRGPT_INCEPTION_WEIGHTS"] = weights
    stats, logged = [], []
    resize, distance = (fid.InceptionFeatures.resize_to,
                        fid.calculate_frechet_distance)

    def spy(*args):
        stats.append(args)
        return _fid_stand_in(*args)

    fid.InceptionFeatures.resize_to, fid.calculate_frechet_distance = \
        FID_RESIZE, spy
    try:
        tr = DR.build_trainer(str(Path(root) / "rgbd"),
                              str(Path(root) / "gt.log"), results,
                              full_width=False, global_batch=TRAIN_BATCH,
                              gradient_accumulate_every=FID_ACCUM,
                              save_and_sample_every=1,
                              num_samples=FID_SAMPLES, num_workers=1,
                              calculate_fid=True)
        info = tr.logger.info

        def record(message):
            if tr.logger.logger is not None:  # what the log receives
                logged.append(message)
            info(message)

        tr.logger.info = record
        tr.train(log_every=100)
    finally:
        fid.InceptionFeatures.resize_to, fid.calculate_frechet_distance = \
            resize, distance
    return dict(stats=stats, real=tr._last_batch["img"],
                scores=[float(m.split(": ")[1]) for m in logged
                        if m.startswith("fid_score: ")])


def _fid_rank(root: str, weights: str) -> dict:
    return _fid_run(root, str(Path(root) / f"fid-{M.process_index()}"),
                    weights)


def test_two_process_trainer_fid_uses_the_global_batch(tmp_path,
                                                       monkeypatch):
    from pointreggpt_tpu_torch.eval import fid
    from pointreggpt_tpu_torch.eval import inception as I

    DR.write_depth_tree(tmp_path, n_frames=TRAIN_BATCH * FID_ACCUM)
    sd = I.init_random_params(0)
    weights = str(tmp_path / "inception.pth")
    torch.save(sd, weights)
    ranks = _launch(_fid_rank, str(tmp_path), weights)
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    one = _fid_run(str(tmp_path), str(tmp_path / "fid-one"), weights)
    assert one["real"].shape == (TRAIN_BATCH * FID_ACCUM, H, H, 1)
    # rank 0 alone logs one FID line, within FID_RTOL of one process's
    assert [len(r["scores"]) for r in ranks] == [1, 0]
    assert len(one["scores"]) == 1
    np.testing.assert_allclose(ranks[0]["scores"], one["scores"],
                               rtol=FID_RTOL)
    # the real set is the whole global batch, in one process's order: its
    # statistics equal one process's bit for bit
    (m1, s1, m2, s2), = ranks[0]["stats"]
    (w1, v1, w2, v2), = one["stats"]
    np.testing.assert_array_equal(m1, w1)
    np.testing.assert_array_equal(s1, v1)
    np.testing.assert_allclose(m2, w2, rtol=FID_RTOL, atol=1e-6)
    # a planted fault misses the score's gate: rank 0's own rows as the
    # real set
    monkeypatch.setattr(fid.InceptionFeatures, "resize_to", FID_RESIZE)
    ext = fid.InceptionFeatures(state_dict=sd, device="cpu")
    own = np.concatenate([one["real"][i * TRAIN_BATCH:][:TRAIN_BATCH // 2]
                          for i in range(FID_ACCUM)])
    np.testing.assert_array_equal(own, ranks[0]["real"])
    bad = _fid_stand_in(*fid.activation_statistics(ext(own)), m2, s2)
    assert abs(bad - one["scores"][0]) > 10 * FID_RTOL * one["scores"][0]


# ---------------------------------------------------------------------------
# the MaskTrainer

MASK_RANK_BATCH = 2


def _mask_run(folder: str, results: str, rank_batch: int) -> dict:
    from pointreggpt_tpu_torch.models import MaskUNet
    from pointreggpt_tpu_torch.train import mask_trainer as MT

    grads = []
    clip = MT.clip_by_global_norm_

    def spy(gs, max_norm):
        grads.append(torch.cat([g.reshape(-1) for g in gs]).numpy().copy())
        return clip(gs, max_norm)

    MT.clip_by_global_norm_ = spy
    try:
        torch.manual_seed(0)
        tr = MT.MaskTrainer(
            MaskUNet(dim=8, dim_mults=(1, 2), resnet_block_groups=4),
            folder, image_size=H, train_batch_size=rank_batch,
            train_lr=1e-3, epochs=1, results_folder=results,
            samples_folder=results, num_workers=1, val_batch_size=3)
        tr.eval_one_epoch()  # the initial weights: one set on every rank
        before = {k: float(v) for k, v in tr.metrics["current"].items()}
        counts = {k: v.count for k, v in tr.metrics["current"].items()}
        tr.train_and_eval()
    finally:
        MT.clip_by_global_norm_ = clip
    return dict(batch=tr.batch_size, steps=tr.steps_per_epoch, grads=grads,
                metrics=before, counts=counts, loss_hist=tr.loss_hist,
                wrote=_written(Path(results)),
                log=(Path(results) / "train.log").is_file())


def _mask_rank(folder: str, root: str) -> dict:
    return _mask_run(folder, str(Path(root) / f"mask-{M.process_index()}"),
                     MASK_RANK_BATCH)


def test_two_process_mask_trainer_matches_one_process(tmp_path,
                                                      monkeypatch):
    from test_torch_port_mask import write_pairs

    folder = write_pairs(tmp_path / "dc", n_train=8, n_val=5)
    ranks = _launch(_mask_rank, folder, str(tmp_path))
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    one = _mask_run(folder, str(tmp_path / "mask-one"), 2 * MASK_RANK_BATCH)
    # the batch scales with the process count; the schedule's epoch too
    assert [r["batch"] for r in ranks] == [4, 4] and one["batch"] == 4
    assert [r["steps"] for r in ranks] == [2, 2] and one["steps"] == 2
    for g0, g1, want in zip(ranks[0]["grads"], ranks[1]["grads"],
                            one["grads"]):
        np.testing.assert_array_equal(g0, g1)
        assert _rel(g0, want) <= GRAD_RTOL, _rel(g0, want)
    np.testing.assert_allclose(ranks[0]["loss_hist"], one["loss_hist"],
                               rtol=GRAD_RTOL)
    # validation: 3 + 2 of the 5 pairs, the sums added over the ranks
    for r in ranks:
        assert r["counts"] == one["counts"] == {k: 5 for k in one["counts"]}
        for k, want in one["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], want,
                                       rtol=METRIC_RTOL, err_msg=k)
    assert [r["wrote"] for r in ranks] == [["model-best.pt",
                                            "model-latest.pt"], []]
    assert [r["log"] for r in ranks] == [True, False]


# ---------------------------------------------------------------------------
# generate_dataset: the scene range by stride

def write_generation_tree(root: Path, n_scenes: int = 4) -> list:
    """Depth frames, info files and ``info.pkl`` for ``n_scenes`` scenes,
    and a seeded dim-8 diffusion checkpoint; returns the generation entry
    point's flags and a seeded mask net that keeps every pixel."""
    from pointreggpt_tpu_torch.models import DiffusionUNet, MaskUNet

    rng = np.random.default_rng(0)
    info = {"src": [], "tgt": []}
    for s in range(n_scenes):
        seq = root / "rgbd" / f"scene-{s}" / "seq-01"
        seq.mkdir(parents=True)
        np.savetxt(seq.parent / "camera-intrinsics.txt",
                   [[585.0, 0, 320.0], [0, 585.0, 240.0], [0, 0, 1]])
        depth = 2000 + rng.integers(0, 800, (480, 640))
        Image.fromarray(depth.astype(np.uint16)).save(
            seq / "frame-000000.depth.png")
        (root / "indoor" / f"scene-{s}").mkdir(parents=True)
        for role in ("src", "tgt"):
            (root / "indoor" / f"scene-{s}" / f"{role}.info.txt").write_text(
                f"scene-{s} seq-01 0 0\n")
            info[role].append(f"scene-{s}/{role}.pth")
    with open(root / "info.pkl", "wb") as f:
        pickle.dump(info, f)
    torch.manual_seed(0)
    unet = DiffusionUNet(dim=8, dim_mults=(1, 2))
    mask = MaskUNet(dim=8, dim_mults=(1, 2))
    with torch.no_grad():
        mask.final_conv[0].bias.fill_(12.0)
    sd = {f"model.{k}": v for k, v in unet.state_dict().items()}
    (root / "results").mkdir()
    torch.save({"step": 0, "model": sd,
                "ema": {f"ema_model.{k}": v for k, v in sd.items()}},
               root / "results" / "model-1.pt")
    return ["--resume", "1", "--data", str(root / "rgbd"),
            "--train_info_path", str(root / "info.pkl"),
            "--data_root", str(root / "indoor"),
            "--results_folder", str(root / "results"),
            "--batch_size", "2", "--num_samples", "2",
            "--image_size", str(H), "--dim", "8", "--dim_mults", "1,2",
            "--dc_dim", "8", "--dc_dim_mults", "1,2", "--timesteps", "16",
            "--sampling_timesteps", "4", "--memory_capacity", "4096",
            "--dataset_name", "gen"], mask


def _save_mask(root: Path, mask) -> None:
    (root / "depth_correction_results").mkdir(parents=True)
    torch.save({"epoch": 0, "model": mask.state_dict()},
               root / "depth_correction_results" / "model-best.pt")


def _generate_rank(root: str, argv: list) -> list:
    """The entry point in a process of the group; returns the chunks of
    scenes this process set up."""
    from pointreggpt_tpu_torch.cli import generate_dataset
    from pointreggpt_tpu_torch.generate import generator as G

    chunks = []
    setup = G.Generator._setup_chunk

    def spy(self, chunk, *a):
        chunks.append(list(chunk))
        return setup(self, chunk, *a)

    G.Generator._setup_chunk = spy
    os.chdir(root)
    generate_dataset.main(argv)
    return chunks


def _tree_bytes(folder: Path) -> dict:
    return {str(p.relative_to(folder)): p.read_bytes()
            for p in sorted(folder.rglob("*")) if p.is_file()}


def test_two_process_generation_shards_scenes_by_stride(tmp_path,
                                                        monkeypatch):
    from pointreggpt_tpu_torch.cli import generate_dataset

    flags, mask = write_generation_tree(tmp_path)
    argv = flags + ["-start", "0", "-stop", "4"]
    for d in ("dist", "one"):
        _save_mask(tmp_path / d, mask)
    chunks = _launch(_generate_rank, str(tmp_path / "dist"), argv)
    assert chunks == [[[0, 2]], [[1, 3]]]
    out = tmp_path / "dist" / "gen" / "data"
    assert sorted(p.name for p in out.iterdir()) == \
        [f"scene-{s:06d}" for s in range(4)]

    # rank 0's scenes, bit for bit, are one process's given [0, 2]
    monkeypatch.chdir(tmp_path / "one")
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen, cfg = generate_dataset.build_generator(
        generate_dataset.build_parser().parse_args(argv))
    gen.load(1)
    gen.generate(0, 4, cfg.num_samples, memory_voxel_size=cfg.
                 memory_voxel_size, save_voxel_size=cfg.save_voxel_size,
                 has_refine_step=cfg.has_refine_step, scene_indices=[0, 2],
                 verbose=False)
    ref = tmp_path / "one" / "gen" / "data"
    for s in (0, 2):
        name = f"scene-{s:06d}"
        got, want = _tree_bytes(out / name), _tree_bytes(ref / name)
        assert got.keys() == want.keys()
        assert all(got[k] == want[k] for k in want), name
    # rank 1 draws its own poses
    poses = [np.loadtxt(out / f"scene-{s:06d}" / "sample-000001.pose.txt")
             for s in (0, 1)]
    assert not np.allclose(*poses)


# ---------------------------------------------------------------------------
# the Tester's split of a scene batch

TESTER_SCENES = 4
# one process and two see the same draws; the conv and matmul sums of a
# batch of 4 and of 2 run in another order on the CPU (measured 0: the
# plain path's rows do not mix), so the images agree to fp32 rounding,
# here amplified by the chain's 4 steps
TESTER_ATOL = 1e-5


def _tester_run(argv: list) -> dict:
    """The Tester's entry point; returns each triptych's new image by file
    name and the overview PNGs this process wrote."""
    from pointreggpt_tpu_torch.cli import test_successive_ddnm_diffusion
    from pointreggpt_tpu_torch.generate import tester as TS

    images, overviews = {}, []
    triptych, imsave = TS.save_triptych, TS._imsave

    def spy_triptych(path, prev, rpj, new, cmap="gray"):
        images[Path(path).name] = np.array(new)
        return triptych(path, prev, rpj, new, cmap)

    def spy_imsave(path, vis, cmap):
        if Path(path).name == "overview.png":
            overviews.append(vis.shape)
        return imsave(path, vis, cmap)

    TS.save_triptych, TS._imsave = spy_triptych, spy_imsave
    try:
        test_successive_ddnm_diffusion.main(argv)
    finally:
        TS.save_triptych, TS._imsave = triptych, imsave
    return dict(images=images, overviews=overviews)


def test_two_process_tester_splits_the_scene_batch(tmp_path, monkeypatch):
    flags, _ = write_generation_tree(tmp_path, n_scenes=1)
    common = ["--resume", "1", "--results_folder", str(tmp_path / "results"),
              "--num_scenes", str(TESTER_SCENES), "--num_samples", "2",
              "--dim", "8", "--dim_mults", "1,2", "--image_size", str(H),
              "--timesteps", "16", "--sampling_timesteps", "4"]
    ranks = _launch(_tester_run, common + [
        "--batch_size", "2", "--samples_folder", str(tmp_path / "dist")])
    monkeypatch.setenv("PRGPT_PLATFORM", "cpu")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    one = _tester_run(common + ["--batch_size", "4", "--samples_folder",
                                str(tmp_path / "one")])
    # each process wrote its block's scenes, rank 0 the one overview
    names = [sorted(r["images"]) for r in ranks]
    assert names == [sorted(f"scene-{s}-sample-{k}.png" for s in block
                            for k in range(2)) for block in ((0, 1), (2, 3))]
    assert [len(r["overviews"]) for r in ranks] == [1, 0]
    assert ranks[0]["overviews"] == one["overviews"]
    assert sorted(p.name for p in (tmp_path / "dist").iterdir()) == \
        sorted(p.name for p in (tmp_path / "one").iterdir())
    got = {**ranks[0]["images"], **ranks[1]["images"]}
    err = max(np.abs(got[k] - one["images"][k]).max() for k in got)
    assert err <= TESTER_ATOL, err
    # a planted fault misses it: rank 1 given rank 0's rows
    swapped = max(np.abs(got[f"scene-{s - 2}-sample-{k}.png"] -
                         one["images"][f"scene-{s}-sample-{k}.png"]).max()
                  for s in (2, 3) for k in range(2))
    assert swapped > 10 * TESTER_ATOL


# ---------------------------------------------------------------------------
# the dry run, end to end

def test_dryrun_multiprocess_end_to_end():
    out = DR.dryrun(2, platform="cpu", backend="gloo", timeout_s=LAUNCH_S)
    assert out["processes"] == 2 and out["devices"] == ["cpu", "cpu"]
    assert out["scenes"] == [[0, 2, 4, 6, 8], [1, 3, 5, 7, 9]]


def test_dryrun_main_needs_a_card_or_the_cpu_asked_for(monkeypatch):
    monkeypatch.delenv("PRGPT_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(DR, "dryrun", lambda *a, **k: pytest.fail(
        "the dry run started with no card and no PRGPT_PLATFORM=cpu"))
    with pytest.raises(RuntimeError, match="PRGPT_PLATFORM=cpu"):
        DR.main(["--nproc", "2"])


def _group_build(fail: bool):
    """The group's kernel build with ``build_all`` replaced: a no-op, or
    one that fails; returns the error each process raised, if any."""
    from pointreggpt_tpu_torch.ops import _build

    def build_all(sources):
        if fail:
            raise RuntimeError("nvcc: a planted failure")

    _build.build_all = build_all
    try:
        M._build_on_local_rank_0()
    except RuntimeError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("fail", [False, True], ids=["built", "failed"])
def test_kernel_build_failure_raises_on_every_process(fail):
    errors = DR.launch(_group_build, 2, args=(fail,),
                       platform="cpu", backend="gloo", timeout_s=LAUNCH_S)
    if not fail:
        assert errors == [None, None]
        return
    assert "planted failure" in errors[0]
    assert "failed on local rank 0 of 1 host" in errors[1]


def test_launch_reports_a_failing_process():
    with pytest.raises(RuntimeError, match="(?s)rank 1:.*ZeroDivision"):
        DR.launch(_fail_on_rank_1, 2, platform="cpu", backend="gloo",
                  timeout_s=LAUNCH_S)


def _fail_on_rank_1():
    return 1 / (M.process_index() - 1)
