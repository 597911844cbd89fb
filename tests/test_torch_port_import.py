"""PyTorch port, checkpoint import, against the JAX package on the CPU:
the pure-Python ``.ckpt`` reader against flax's ``msgpack_restore``, the
optax state in its tuple and dict forms, the importer CLI on the JAX
package's committed small-width ``.ckpt`` pair (weights, EMA, Adam state,
forwards against the JAX forwards in
``tests/data/torch_port_fid_import_reference.npz``, one Adam step against
optax's, and what every reader of the output needs) and on reference
``.pt`` files."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from pointreggpt_tpu.train import checkpoint as jckpt
from pointreggpt_tpu.train.ema import EMAState
from test_torch_port_generator import single_torch_thread  # noqa: F401
from test_torch_port_mask import write_pairs
from test_torch_port_train import write_depth_tree
from pointreggpt_tpu_torch import config as C
from pointreggpt_tpu_torch.cli import import_torch_checkpoint as cli
from pointreggpt_tpu_torch.diffusion import GaussianDiffusion
from pointreggpt_tpu_torch.generate import Generator
from pointreggpt_tpu_torch.train import checkpoint as ckpt
from pointreggpt_tpu_torch.train.mask_trainer import MaskTrainer
from pointreggpt_tpu_torch.train.trainer import (Trainer,
                                                 clip_by_global_norm_)
from pointreggpt_tpu_torch.utils import jax_params
from pointreggpt_tpu_torch.utils import jax_parity as J
from pointreggpt_tpu_torch.utils.seeded_weights import fill_seeded

DATA = Path(__file__).resolve().parent / "data"
DIFFUSION_CKPT = DATA / "torch_port_jax_diffusion.ckpt"
MASK_CKPT = DATA / "torch_port_jax_mask.ckpt"
REF = DATA / "torch_port_fid_import_reference.npz"
# port vs JAX forwards of the imported small nets on the CPU (fp32),
# measured 4.4e-6 (diffusion, |output| up to 5.4) and 1.1e-6 (mask);
# about 4x that
FORWARD_ATOL = {"diffusion_forward": 2e-5, "mask_forward": 5e-6}
PARAM_ATOL = 1e-6  # one Adam step, port vs optax (fp32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _assert_same_tree(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys(), set(g) ^ set(w)
    for k, a in w.items():
        b = g[k]
        if isinstance(b, torch.Tensor):  # bfloat16
            assert str(a.dtype) == "bfloat16", k
            np.testing.assert_array_equal(
                b.float().numpy(), np.asarray(a, np.float32), err_msg=k)
        elif isinstance(a, np.ndarray) or isinstance(a, np.generic):
            assert type(b) is type(a) and b.dtype == a.dtype, k
            np.testing.assert_array_equal(b, a, err_msg=str(k))
        else:
            assert type(b) is type(a) and b == a, k


def _odd_checkpoint(path):
    """A JAX ``save_checkpoint`` of bf16, numpy-scalar, nested-tuple,
    NamedTuple, optax and ragged leaves."""
    params = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
              "b": jnp.ones((4,), jnp.bfloat16)}
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    jckpt.save_checkpoint(path, {
        "step": 7, "params": params,
        "opt_state": tx.init({"w": params["w"]}),
        "ema": EMAState(params=params, step=np.asarray(3, np.int32),
                        initted=np.asarray(True)),
        "scalars": (np.float32(1.5), np.int64(-2), np.bool_(True),
                    (2.5, (np.arange(3, dtype=np.int16), None))),
        "big": np.linspace(0, 1, 100000).astype(np.float32),
        "empty": np.zeros((0, 3)), "c": 1.0 + 2.0j,
    }, meta={"loss_hist": [0.5, 0.25], "best_metrics": {"SAE": 1.0}})


@pytest.mark.parametrize("which", ["odd", "chunked", "diffusion", "mask"])
def test_reader_matches_flax_msgpack_restore(which, tmp_path, monkeypatch):
    if which in ("odd", "chunked"):
        path = tmp_path / "odd.ckpt"
        if which == "chunked":
            # flax writes arrays over MAX_CHUNK_SIZE bytes as chunked
            # dicts; a small limit makes some here
            monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
        _odd_checkpoint(path)
    else:
        path = {"diffusion": DIFFUSION_CKPT, "mask": MASK_CKPT}[which]
    with open(path, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    state, meta = ckpt.load_jax_checkpoint(path)
    _assert_same_tree(state, want["state"])
    _assert_same_tree(meta, want["meta"])
    if which == "chunked":
        raw = path.read_bytes()
        assert b"__msgpack_chunked_array__" in raw
        np.testing.assert_array_equal(
            state["big"], np.linspace(0, 1, 100000).astype(np.float32))


def test_reader_refuses_other_files(tmp_path):
    for name, raw, match in (
            ("list", b"\x92\x01\x02", "not a JAX package checkpoint"),
            ("short", b"\x93\x01\x02", "truncated"),
            ("tail", DIFFUSION_CKPT.read_bytes() + b"\x00",
             "not a JAX package checkpoint")):
        (tmp_path / f"{name}.ckpt").write_bytes(raw)
        with pytest.raises(ValueError, match=match):
            ckpt.load_jax_checkpoint(tmp_path / f"{name}.ckpt")
    (tmp_path / "y.ckpt").write_bytes(b"\x81\xa5state\xc1")
    with pytest.raises(ValueError, match="unknown type byte"):
        ckpt.load_jax_checkpoint(tmp_path / "y.ckpt")


def _mask_tx(steps_per_epoch=2):
    mcfg = C.MaskTrainConfig()
    schedule = optax.exponential_decay(
        mcfg.train_lr, transition_steps=steps_per_epoch,
        decay_rate=mcfg.lr_gamma, staircase=True)
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adam(schedule, b1=0.9, b2=0.99))


def _diffusion_tx():
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adam(C.TrainConfig().train_lr, b1=0.9, b2=0.99))


def _tuple_form(tx, dict_state, params):
    return serialization.from_state_dict(tx.init(params), dict_state)


@pytest.mark.parametrize("net", ["diffusion", "mask"])
def test_optax_state_in_tuple_and_dict_form(net):
    """flax restores an optax state with no target as dicts ('0', '1',
    ..., a NamedTuple as its fields); the Adam carry reads both forms."""
    if net == "diffusion":
        state, _ = ckpt.load_jax_checkpoint(DIFFUSION_CKPT)
        model, tx = C.build_diffusion_unet(J.SMALL_MODEL), _diffusion_tx()
        carry = jax_params.adam_state_from_jax
    else:
        state, _ = ckpt.load_jax_checkpoint(MASK_CKPT)
        model, tx = C.build_mask_unet(J.SMALL_MASK), _mask_tx()
        carry = jax_params.mask_adam_state_from_jax
    as_dict = state["opt_state"]
    assert set(as_dict) == {"0", "1"}
    as_tuple = _tuple_form(tx, as_dict, state["params"])
    assert isinstance(as_tuple, tuple)
    a, b = carry(as_dict, model), carry(as_tuple, model)
    assert a["param_groups"] == b["param_groups"]
    assert a["state"].keys() == b["state"].keys()
    for i, s in a["state"].items():
        assert float(s["step"]) == float(b["state"][i]["step"]) == 3.0
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(s[k], b["state"][i][k], rtol=0,
                                       atol=0)
    if net == "mask":  # the schedule's clock is checked in both forms
        bad = {"0": as_dict["0"],
               "1": {"0": as_dict["1"]["0"],
                     "1": {"count": np.asarray(2, np.int32)}}}
        with pytest.raises(ValueError, match="schedule's count"):
            carry(bad, model)


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """The importer CLI run on the committed JAX ``.ckpt`` pair."""
    out = tmp_path_factory.mktemp("imported")
    cli.main(["--diffusion", str(DIFFUSION_CKPT), "--depth_correction",
              str(MASK_CKPT), "--milestone", "7", "--diffusion_out",
              str(out / "results"), "--dc_out", str(out / "dc"),
              *J.SMALL_FLAGS])
    return out


def test_importer_on_jax_ckpt_keeps_weights_ema_and_adam(imported):
    state, meta = jckpt.load_checkpoint(DIFFUSION_CKPT)
    data = ckpt.load_checkpoint(imported / "results" / "model-7.pt")
    assert set(data) == {"step", "model", "opt", "ema", "version"}
    assert data["step"] == 3
    assert data["version"] == "ported:torch_port_jax_diffusion.ckpt"
    net = C.build_diffusion_unet(J.SMALL_MODEL)
    want = jax_params.diffusion_unet_from_jax(state["params"], net)
    want_ema = jax_params.diffusion_unet_from_jax(state["ema"]["params"], net)
    for k in net.state_dict():
        torch.testing.assert_close(data["model"][f"model.{k}"], want[k],
                                   rtol=0, atol=0)
        torch.testing.assert_close(data["ema"][f"ema_model.model.{k}"],
                                   want_ema[k], rtol=0, atol=0)
        torch.testing.assert_close(data["ema"][f"online_model.model.{k}"],
                                   want[k], rtol=0, atol=0)
    assert int(data["ema"]["step"]) == 3
    assert not bool(data["ema"]["initted"])
    mu = jax_params.diffusion_unet_from_jax(
        state["opt_state"]["1"]["0"]["mu"], net)
    names = [n for n, _ in net.named_parameters()]
    for i, s in data["opt"]["state"].items():
        assert float(s["step"]) == 3.0
        torch.testing.assert_close(s["exp_avg"], mu[names[i]], rtol=0,
                                   atol=0)
    assert data["opt"]["param_groups"][0]["lr"] == C.TrainConfig().train_lr

    dc_state, dc_meta = jckpt.load_checkpoint(MASK_CKPT)
    dc = ckpt.load_checkpoint(imported / "dc" / "model-7.pt")
    assert set(dc) == {"epoch", "model", "opt", "loss_hist", "best_metrics",
                       "version"}
    assert (dc["epoch"], dc["loss_hist"], dc["best_metrics"]) == (
        1, [0.75, 0.5], {"SAE": 0.25})
    mask = C.build_mask_unet(J.SMALL_MASK)
    want = jax_params.mask_unet_from_jax(dc_state["params"], mask)
    for k, v in dc["model"].items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    assert {float(s["step"]) for s in dc["opt"]["state"].values()} == {3.0}


def test_imported_forwards_match_jax(imported):
    ref = np.load(REF)
    got = J.import_forwards(imported / "results" / "model-7.pt",
                            imported / "dc" / "model-7.pt", "cpu")
    for k, tol in FORWARD_ATOL.items():
        gap = float(np.abs(got[k] - ref[k]).max())
        assert gap <= tol, (k, gap)
        assert float(ref[f"cpu_gap_{k}"]) <= tol
        assert ref[k].std() > 100 * tol  # the forward is not flat


def _grads(params, seed, norm):
    rng = np.random.default_rng(seed)
    g = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    total = np.sqrt(sum(float(np.sum(a ** 2))
                        for a in jax.tree_util.tree_leaves(g)))
    return jax.tree_util.tree_map(lambda a: a * np.float32(norm / total), g)


@pytest.mark.parametrize("net", ["diffusion", "mask"])
def test_one_adam_step_after_import_equals_optax(imported, net):
    if net == "diffusion":
        path, tx = DIFFUSION_CKPT, _diffusion_tx()
        model = C.build_diffusion_unet(J.SMALL_MODEL)
        data = ckpt.load_checkpoint(imported / "results" / "model-7.pt")
        sd = jax_params.strip_prefix(data["model"], "model.")
        convert = jax_params.diffusion_unet_from_jax
        lr = C.TrainConfig().train_lr
    else:
        path, tx = MASK_CKPT, _mask_tx()
        model = C.build_mask_unet(J.SMALL_MASK)
        data = ckpt.load_checkpoint(imported / "dc" / "model-7.pt")
        sd = data["model"]
        convert = jax_params.mask_unet_from_jax
        # the MaskTrainer sets the schedule's rate at Adam's count (3)
        mcfg = C.MaskTrainConfig()
        lr = mcfg.train_lr * mcfg.lr_gamma ** (3 // 2)
    state, _ = jckpt.load_checkpoint(path)
    params = state["params"]
    opt_state = _tuple_form(tx, state["opt_state"], params)
    g = _grads(params, 5, 2.0)  # clipped
    upd, _ = tx.update(g, opt_state, params)
    want = convert(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, upd)), model)

    model.load_state_dict(sd)
    opt = torch.optim.Adam(model.parameters())
    opt.load_state_dict(data["opt"])
    for group in opt.param_groups:
        group["lr"] = lr
    g_sd = convert(g, model)
    for n, p in model.named_parameters():
        p.grad = g_sd[n].clone()
    clip_by_global_norm_([p.grad for p in model.parameters()], 1.0)
    opt.step()
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=n)


def test_imported_checkpoints_load_in_every_reader(imported, tmp_path):
    results, dc = imported / "results", imported / "dc"
    folder, gt_log = write_depth_tree(tmp_path, n_scenes=1, n_frames=4)
    diffusion = GaussianDiffusion(image_size=16, timesteps=16,
                                  sampling_timesteps=4)
    tr = Trainer(C.build_diffusion_unet(J.SMALL_MODEL), diffusion, folder,
                 train_batch_size=2, results_folder=str(results),
                 samples_folder=str(tmp_path / "s"), gt_log=gt_log,
                 num_workers=1, device="cpu")
    tr.load(7)  # --resume: strict weights, EMA and Adam state
    assert (tr.step, tr.ema._step, tr.ema._initted) == (3, 3, False)
    gen = Generator(C.build_diffusion_unet(J.SMALL_MODEL), diffusion,
                    folder, results_folder=str(results),
                    samples_folder=str(tmp_path / "g"), device="cpu")
    gen.load(7)  # generate_dataset and the Tester read the EMA U-Net

    pairs = write_pairs(tmp_path / "pairs", size=16)
    mt = MaskTrainer(C.build_mask_unet(J.SMALL_MASK), pairs, image_size=16,
                     train_batch_size=2, results_folder=str(dc),
                     samples_folder=str(tmp_path / "ms"), num_workers=1,
                     device="cpu")
    mt.load("7")  # the JAX run's Adam count is the schedule's clock
    assert (mt.count, mt.epoch) == (3, 2)
    assert mt.loss_hist == [0.75, 0.5]
    assert mt.metrics["best"] == {"SAE": 0.25}


def _reference_pts(tmp_path):
    """Reference-layout ``.pt`` files of seeded small nets, with the
    reference's extra keys (``opt``, ``scaler``, the EMA's diffusion
    buffers, ``scheduler``, ``metrics``)."""
    net = fill_seeded(C.build_diffusion_unet(J.SMALL_MODEL), 3)
    ema = fill_seeded(C.build_diffusion_unet(J.SMALL_MODEL), 4)
    diffusion = {
        "step": 4321,
        "model": {**{f"model.{k}": v for k, v in net.state_dict().items()},
                  "betas": torch.zeros(10)},
        "opt": {"state": {0: {"step": torch.tensor(9.0)}},
                "param_groups": [{"lr": 1.0, "params": [0]}]},
        "ema": {"initted": torch.tensor(True), "step": torch.tensor(777),
                **{f"ema_model.model.{k}": v
                   for k, v in ema.state_dict().items()},
                "ema_model.betas": torch.zeros(10)},
        "scaler": {"scale": 65536.0}}
    mask = fill_seeded(C.build_mask_unet(J.SMALL_MASK), 5)
    dc = {"epoch": 41, "model": mask.state_dict(),
          "opt": {"state": {}, "param_groups": []},
          "scheduler": {"last_epoch": 41}, "scaler": None,
          "loss_hist": [torch.tensor(0.5), 0.25],
          "metrics": {"best": {"SAE": torch.tensor(0.125)},
                      "current": {}}}
    torch.save(diffusion, tmp_path / "model-official.pt")
    torch.save(dc, tmp_path / "model-best.pt")
    return net, ema, mask


def test_importer_on_reference_pt(tmp_path):
    net, ema, mask = _reference_pts(tmp_path)
    cli.main(["--diffusion", str(tmp_path / "model-official.pt"),
              "--depth_correction", str(tmp_path / "model-best.pt"),
              "--diffusion_out", str(tmp_path / "results"),
              "--dc_out", str(tmp_path / "dc"), *J.SMALL_FLAGS])
    data = ckpt.load_checkpoint(tmp_path / "results" / "model-official.pt")
    assert data["step"] == 4321
    assert data["version"] == "ported:model-official.pt"
    assert int(data["ema"]["step"]) == 777 and bool(data["ema"]["initted"])
    for k, v in net.state_dict().items():
        torch.testing.assert_close(data["model"][f"model.{k}"], v, rtol=0,
                                   atol=0)
        torch.testing.assert_close(data["ema"][f"ema_model.model.{k}"],
                                   ema.state_dict()[k], rtol=0, atol=0)
    # fresh Adam: the reference's optimizer and scaler are dropped
    assert data["opt"]["state"] == {}
    assert data["opt"]["param_groups"][0]["lr"] == C.TrainConfig().train_lr
    assert "scaler" not in data

    dc = ckpt.load_checkpoint(tmp_path / "dc" / "model-best.pt")
    assert (dc["epoch"], dc["loss_hist"], dc["best_metrics"]) == (
        41, [0.5, 0.25], {"SAE": 0.125})
    assert dc["opt"]["state"] == {} and "scheduler" not in dc
    for k, v in mask.state_dict().items():
        torch.testing.assert_close(dc["model"][k], v, rtol=0, atol=0)

    # the nets are built from the flags and loaded strictly before writing
    with pytest.raises(RuntimeError, match="size mismatch"):
        cli.main(["--diffusion", str(tmp_path / "model-official.pt"),
                  "--diffusion_out", str(tmp_path / "wide"),
                  "--dim", "16", "--dim_mults", "1,1", "--bf16", "false"])
    assert not (tmp_path / "wide").exists()
    with pytest.raises(SystemExit):
        cli.main([])
