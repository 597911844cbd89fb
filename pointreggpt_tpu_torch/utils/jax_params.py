"""Carry weights between the JAX package's params tree and the port.

``diffusion_unet_from_jax`` / ``mask_unet_from_jax`` take a JAX
DiffusionUNet / MaskUNet params tree with numpy leaves and return the
port's ``state_dict`` (reference key names). They invert the layouts of
``pointreggpt_tpu/utils/torch_port.py``: HWIO conv -> OIHW, Dense (i, o)
-> Linear (o, i) or 1x1 conv (o, i, 1, 1), LayerNorm ``g`` (c,) ->
(1, c, 1, 1). Every leaf of the tree must be consumed and, given a
``model``, every key and shape must match its ``state_dict``; anything else
raises.

``adam_state_from_jax`` carries an optax ``chain(clip_by_global_norm,
adam)`` state into a torch Adam ``state_dict``, so a JAX training state
continues in the port. Gradient trees map through
``diffusion_unet_from_jax`` like params.

``load_reference_checkpoint`` reads a reference ``.pt`` checkpoint.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


class _Tree:
    """Read-once view of a nested params dict; tracks what was used."""

    def __init__(self, tree: Mapping):
        self.tree = tree["params"] if "params" in tree else tree
        self.used = set()

    def get(self, *path: str) -> np.ndarray:
        node: Any = self.tree
        for p in path:
            if not isinstance(node, Mapping) or p not in node:
                raise ValueError(f"JAX params: missing {'/'.join(path)}")
            node = node[p]
        self.used.add(path)
        return np.asarray(node, dtype=np.float32)

    def has(self, *path: str) -> bool:
        node: Any = self.tree
        for p in path:
            if not isinstance(node, Mapping) or p not in node:
                return False
            node = node[p]
        return True

    def check_all_used(self) -> None:
        leaves = []

        def walk(node, path):
            if isinstance(node, Mapping):
                for k, v in node.items():
                    walk(v, path + (k,))
            else:
                leaves.append(path)

        walk(self.tree, ())
        unused = [p for p in leaves if p not in self.used]
        if unused:
            raise ValueError("JAX params: leaves with no port counterpart: "
                             + ", ".join("/".join(p) for p in unused))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _conv(sd, key, tree, *path):
    sd[f"{key}.weight"] = _t(tree.get(*path, "kernel").transpose(3, 2, 0, 1))
    sd[f"{key}.bias"] = _t(tree.get(*path, "bias"))


def _dense(sd, key, tree, *path, as_conv=False, bias=True):
    w = tree.get(*path, "kernel").T
    sd[f"{key}.weight"] = _t(w[:, :, None, None] if as_conv else w)
    if bias:
        sd[f"{key}.bias"] = _t(tree.get(*path, "bias"))


def _g(sd, key, tree, *path):
    sd[key] = _t(tree.get(*path, "g").reshape(1, -1, 1, 1))


def _resnet(sd, key, tree, name):
    if tree.has(name, "mlp"):
        _dense(sd, f"{key}.mlp.1", tree, name, "mlp")
    for blk in ("block1", "block2"):
        _conv(sd, f"{key}.{blk}.proj", tree, name, blk, "proj")
        sd[f"{key}.{blk}.norm.weight"] = _t(tree.get(name, blk, "norm",
                                                      "scale"))
        sd[f"{key}.{blk}.norm.bias"] = _t(tree.get(name, blk, "norm", "bias"))
    if tree.has(name, "res_conv"):
        _dense(sd, f"{key}.res_conv", tree, name, "res_conv", as_conv=True)


def _attn(sd, key, tree, name, linear):
    _g(sd, f"{key}.fn.norm.g", tree, name, "norm")
    inner = f"{name}_inner"
    _dense(sd, f"{key}.fn.fn.to_qkv", tree, inner, "to_qkv", as_conv=True,
           bias=False)
    if linear:
        _dense(sd, f"{key}.fn.fn.to_out.0", tree, inner, "to_out",
               as_conv=True)
        _g(sd, f"{key}.fn.fn.to_out.1.g", tree, inner, "out_norm")
    else:
        _dense(sd, f"{key}.fn.fn.to_out", tree, inner, "to_out",
               as_conv=True)


def _unet(tree: _Tree) -> Dict[str, torch.Tensor]:
    stages = sorted(int(m.group(1)) for k in tree.tree
                    if (m := re.fullmatch(r"down_(\d+)_block1", k)))
    if stages != list(range(len(stages))) or not stages:
        raise ValueError(f"JAX params: unexpected stage names {stages}")
    n = len(stages)
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "init_conv", tree, "init_conv")
    for side, key, resample in (("down", "downs", "downsample"),
                                ("up", "ups", "upsample")):
        for i in range(n):
            _resnet(sd, f"{key}.{i}.0", tree, f"{side}_{i}_block1")
            _resnet(sd, f"{key}.{i}.1", tree, f"{side}_{i}_block2")
            _attn(sd, f"{key}.{i}.2", tree, f"{side}_{i}_attn", True)
            name = f"{side}_{i}_{resample}"
            if i == n - 1:
                _conv(sd, f"{key}.{i}.3", tree, name)
            elif side == "down":
                _conv(sd, f"{key}.{i}.3", tree, name, "conv")
            else:
                _conv(sd, f"{key}.{i}.3.1", tree, name, "conv")
    _resnet(sd, "mid_block1", tree, "mid_block1")
    _attn(sd, "mid_attn", tree, "mid_attn", False)
    _resnet(sd, "mid_block2", tree, "mid_block2")
    _resnet(sd, "final_res_block", tree, "final_res_block")
    return sd


def _check_against(sd: Mapping[str, torch.Tensor],
                   model: Optional[torch.nn.Module]) -> None:
    if model is None:
        return
    ref = model.state_dict()
    if set(ref) != set(sd):
        raise ValueError(
            f"state dict keys differ: model-only {sorted(set(ref) - set(sd))}"
            f", carried-only {sorted(set(sd) - set(ref))}")
    for k, v in ref.items():
        if tuple(v.shape) != tuple(sd[k].shape):
            raise ValueError(f"shape mismatch at {k}: model "
                             f"{tuple(v.shape)}, carried {tuple(sd[k].shape)}")


def diffusion_unet_from_jax(params_np: Mapping,
                            model: Optional[torch.nn.Module] = None
                            ) -> Dict[str, torch.Tensor]:
    """JAX DiffusionUNet params (numpy leaves) -> port state dict."""
    tree = _Tree(params_np)
    sd = _unet(tree)
    _dense(sd, "time_mlp.1", tree, "time_mlp_1")
    _dense(sd, "time_mlp.3", tree, "time_mlp_2")
    _dense(sd, "param_mlp.0", tree, "param_mlp_1")
    _dense(sd, "param_mlp.2", tree, "param_mlp_2")
    _dense(sd, "final_conv", tree, "final_conv", as_conv=True)
    tree.check_all_used()
    _check_against(sd, model)
    return sd


def mask_unet_from_jax(params_np: Mapping,
                       model: Optional[torch.nn.Module] = None
                       ) -> Dict[str, torch.Tensor]:
    """JAX MaskUNet params (numpy leaves) -> port state dict."""
    tree = _Tree(params_np)
    sd = _unet(tree)
    _dense(sd, "final_conv.0", tree, "final_conv", as_conv=True)
    tree.check_all_used()
    _check_against(sd, model)
    return sd


def load_reference_checkpoint(path) -> Dict:
    """``torch.load`` a reference ``.pt`` checkpoint on the CPU. Its
    entries are tensors, numbers, strings and dicts of them, so the
    weights-only unpickler reads it and runs no code from the file."""
    return torch.load(path, map_location="cpu", weights_only=True)


def strip_prefix(state_dict: Mapping, prefix: str) -> Dict:
    """Keys under ``prefix`` (e.g. ``ema_model.``) with the prefix cut."""
    n = len(prefix)
    return {k[n:]: v for k, v in state_dict.items() if k.startswith(prefix)}


def _adam_moments(node: Any):
    """The ``(count, mu, nu)`` of the first Adam state (a
    ``ScaleByAdamState`` with numpy leaves) inside an optax state's nested
    tuples, or None."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        return node.count, node.mu, node.nu
    if isinstance(node, tuple):
        for child in node:
            found = _adam_moments(child)
            if found is not None:
                return found
    return None


def adam_state_from_jax(opt_state_np: Any, model: torch.nn.Module, *,
                        lr: float = 8e-5,
                        betas: Tuple[float, float] = (0.9, 0.99),
                        eps: float = 1e-8) -> Dict:
    """optax Adam state (numpy leaves) -> ``torch.optim.Adam`` state dict
    for ``model.parameters()`` (a DiffusionUNet), with these
    hyperparameters.

    optax's ``count`` is the Adam step; ``mu`` and ``nu`` are param-shaped
    trees, mapped through :func:`diffusion_unet_from_jax` onto the port's
    parameter names (``exp_avg`` and ``exp_avg_sq``). The update formulas
    agree: optax divides ``mu / (1 - b1^t)`` by ``sqrt(nu / (1 - b2^t)) +
    eps``, torch the same quantities in another arrangement.
    """
    found = _adam_moments(opt_state_np)
    if found is None:
        raise ValueError("adam_state_from_jax: no (count, mu, nu) Adam "
                         "state in the given optax state")
    count, mu, nu = found
    mu_sd = diffusion_unet_from_jax(mu, model)
    nu_sd = diffusion_unet_from_jax(nu, model)
    step = torch.tensor(float(np.asarray(count)))
    names = [n for n, _ in model.named_parameters()]
    template = torch.optim.Adam(model.parameters(), lr=lr, betas=betas,
                                eps=eps).state_dict()
    template["state"] = {
        i: {"step": step.clone(), "exp_avg": mu_sd[n].clone(),
            "exp_avg_sq": nu_sd[n].clone()}
        for i, n in enumerate(names)}
    return template
