"""What the training cells share: the capture of the port's first steps,
the plain reference's steps (clip by global norm, Adam, the EMA), and the
numbers that compare them.

The port's trainer is built once in set-up, resumed from a milestone that
the benchmark writes (through the trainer's own ``load``), and driven
through its first ``steps`` by the window's own loop and loader; those
steps are captured (each step's loss, inputs and net outputs, the first
gradient as Adam holds it after one step, the weights and the EMA after
the last; those before are the benchmark's own draws) and the window goes
on with the same trainer. The reference then takes the same steps from the same
weights, Adam count and inputs:

- ``fwd_gap``: the net's outputs in the first step (the weights still
  the same on both sides), max |d| / max |ref| over each microbatch;
- ``loss_own_gap``: the largest over the steps of |loss - own| / own,
  ``own`` the reference's loss of the side's own net outputs (the loss's
  reduction: rows, weights, the accumulation);
- ``loss_gap``: the mean over the steps of |loss - ref| / |ref|
  (``loss_gap_max`` the largest), ``ref`` the reference's own loss;
- ``grad_gap``: the worst leaf's gap of norms of the first gradient,
  over the larger of that leaf's and the median leaf's reference norm
  (``grad_gap_median`` the median leaf's);
- ``update_gap``: the same of the weights' change over the steps, over
  the leaves the reference moves (:func:`checks.moving_leaves`);
- ``ema_gap``: the same of the EMA's change over the steps, every leaf.

A cell's limits name the numbers it compares; the others are printed as
readings.
"""

from __future__ import annotations

import math
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench.lib import checks
from portbench.lib.flops import forward_flops

Tensor = torch.Tensor


class Capture:
    """The port's side of the first steps; ``model``'s outputs are kept
    from a forward hook until the last captured step."""

    def __init__(self, model: torch.nn.Module, params: Dict[str, Tensor],
                 ema: Optional[Dict[str, Tensor]] = None):
        self.params, self.ema = params, ema
        self.losses: List[Tensor] = []
        self.inputs: List[dict] = []
        self.outs: List[List[Tensor]] = []
        self.g1: Dict[str, Tensor] = {}
        self.p_end: Dict[str, Tensor] = {}
        self.ema_end: Optional[Dict[str, Tensor]] = None
        self._hook = model.register_forward_hook(self._on_forward)

    def _on_forward(self, module, args, output) -> None:
        self.outs[-1].append(output.detach().float().clone())

    def before_step(self) -> None:
        self.outs.append([])

    def after_step(self, step: int, loss: Tensor, opt, beta1: float,
                   last: bool) -> None:
        self.losses.append(loss.detach().reshape(()))
        if step == 0:
            # Adam's first moment after one step from zero moments is
            # (1 - beta1) g; a step that left no state got no gradient
            self.g1 = {k: opt.state[p]["exp_avg"].detach().clone() /
                       (1.0 - beta1) if "exp_avg" in opt.state[p] else
                       torch.zeros_like(p) for k, p in self.params.items()}
        if last:
            self._hook.remove()
            self.p_end = {k: p.detach().clone()
                          for k, p in self.params.items()}
            if self.ema is not None:
                self.ema_end = {k: p.detach().clone()
                                for k, p in self.ema.items()}


def zero_adam_state(opt: torch.optim.Optimizer, count: int,
                    shared: bool) -> dict:
    """``opt``'s state dict at Adam step ``count`` with zero moments, each
    laid out as its parameter is (channels-last, as a checkpoint that Adam
    wrote holds them). With ``shared`` every moment is a view of one zero
    buffer, so a checkpoint stores it once: loading onto a card copies
    each apart, loading onto the CPU would not, so a CPU run gets a buffer
    each."""
    sd = opt.state_dict()
    params = [p for g in opt.param_groups for p in g["params"]]
    big = torch.zeros(max(p.numel() for p in params)) if shared else None

    def zeros(p):
        if shared:
            return big[:p.numel()].as_strided(p.shape, p.stride())
        return torch.zeros_like(p, device="cpu")
    sd["state"] = {i: {"step": torch.tensor(float(count)),
                       "exp_avg": zeros(p), "exp_avg_sq": zeros(p)}
                   for i, p in enumerate(params)}
    return sd


def reference_steps(weights: Dict[str, Tensor], steps: int,
                    grads_of: Callable, lr_of: Callable[[int], float],
                    betas, eps: float, max_norm: float, *, count: int = 0,
                    ema0: Optional[Dict[str, Tensor]] = None,
                    ema_decay: Callable[[int], Optional[float]] = None
                    ) -> dict:
    """The plain reference's ``steps`` optimizer steps from ``weights``:
    ``grads_of(params, step)`` fills each param's ``.grad`` and returns the
    step's loss and the net's outputs; the gradient is clipped to
    ``max_norm`` by its global norm (when it reaches it), then Adam
    (bias-corrected, from zero moments at step ``count``) takes its step.
    With ``ema0`` the EMA follows each step: ``ema_decay(step)`` None
    leaves it, else it moves to ``ema * d + params * (1 - d)``."""
    b1, b2 = betas
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in weights.items()}
    ema = None if ema0 is None else {k: v.detach().clone().float()
                                     for k, v in ema0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, outs, g1 = [], [], {}
    for s in range(steps):
        for p in params.values():
            p.grad = None
        loss, out = grads_of(params, s)
        losses.append(float(loss))
        outs.append(out)
        with torch.no_grad():
            g = {k: p.grad.detach() for k, p in params.items()}
            norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values()))
            scale = float(max_norm / norm) if float(norm) >= max_norm else 1.0
            g = {k: x * scale for k, x in g.items()}
            if s == 0:
                g1 = {k: x.clone() for k, x in g.items()}
            t = count + s + 1
            lr = lr_of(s)
            for k, p in params.items():
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                mh = m[k] / (1 - b1 ** t)
                vh = v2[k] / (1 - b2 ** t)
                p.sub_(lr * mh / (vh.sqrt() + eps))
            d = None if ema is None else ema_decay(s)
            if d is not None:
                for k, e in ema.items():
                    e.mul_(d).add_(params[k], alpha=1.0 - d)
    return {"losses": losses, "outs": outs, "g1": g1,
            "p_end": {k: p.detach() for k, p in params.items()},
            "ema_end": ema}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def fwd_gap(got: List[Tensor], want: List[Tensor]) -> float:
    """The first step's outputs, max |d| / max |ref| of the worst
    microbatch; inf where a microbatch's output is missing or of another
    shape (rows the net never saw)."""
    if len(got) != len(want) or any(a.shape != b.shape
                                    for a, b in zip(got, want)):
        return math.inf
    return max(checks.rel_max_gap(a, b) for a, b in zip(got, want))


def numbers(side: dict, ref: dict, weights: Dict[str, Tensor],
            own_loss: Callable[[int, List[Tensor]], float],
            ema0: Optional[Dict[str, Tensor]] = None) -> Dict[str, float]:
    """One side's numbers against the reference. ``side`` holds its step
    losses, net outputs, first gradient, weights after the steps and EMA
    after them; ``own_loss(step, outputs)`` is the reference's loss of a
    step's outputs (nan where they are not whole)."""
    losses = [_rel(a, b) for a, b in zip(side["losses"], ref["losses"])]
    own = [_rel(a, own_loss(s, o)) for s, (a, o) in
           enumerate(zip(side["losses"], side["outs"]))]
    grads = checks.leaf_gaps(side["g1"], ref["g1"])
    ref_delta = {k: ref["p_end"][k] - weights[k].float() for k in weights}
    delta = {k: side["p_end"][k].float() - weights[k].float()
             for k in weights}
    moving = checks.moving_leaves(ref["g1"])
    updates = checks.leaf_gaps(delta, ref_delta, moving)
    out = {"fwd_gap": fwd_gap(side["outs"][0], ref["outs"][0]),
           "loss_own_gap": max(x if math.isfinite(x) else math.inf
                               for x in own),
           "loss_gap": sum(losses) / len(losses),
           "loss_gap_max": max(losses),
           "grad_gap": max(grads.values()),
           "grad_gap_median": statistics.median(grads.values()),
           "update_gap": max(updates.values()),
           "update_gap_median": statistics.median(updates.values())}
    worst = ""
    if ema0 is not None:
        emas = checks.leaf_gaps(
            {k: side["ema_end"][k].float() - ema0[k].float() for k in ema0},
            {k: ref["ema_end"][k] - ema0[k].float() for k in ema0})
        out["ema_gap"] = max(emas.values())
        worst = f"; EMA {checks.worst(emas)}"
    print(f"worst leaves: gradient {checks.worst(grads)}; change "
          f"{checks.worst(updates)}{worst}; {len(moving)} of {len(weights)} "
          f"leaves move; step loss gaps {losses!r}; own {own!r}",
          file=sys.stderr, flush=True)
    return out


class TrainingJob:
    """The loop both trainers' jobs share. A subclass sets ``trainer``,
    ``batches`` (an iterator of the trainer's loader's batches) and
    ``images_per_step`` in ``setup``, and gives ``_step(batch)`` (one
    optimizer step through the trainer, returning its loss),
    ``_keep(batch)`` (what the reference needs of a captured step),
    ``own_loss(step, outputs)`` and ``reference(precision, half_batch=)``;
    ``_ema()`` gives the EMA's parameters where the trainer keeps one."""

    ema0: Optional[Dict[str, Tensor]] = None  # the EMA resumed from

    def __init__(self, cell, seed, device, workdir, spans):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.root, self.spans = workdir, spans
        self.cfg, self.tr = cell.config, cell.traffic
        self.events = []
        self.loader_wait: List[float] = []
        self.window_losses: List[Tensor] = []

    def _first_steps(self) -> None:
        """The captured steps, through the window's own loop."""
        t, n = self.trainer, self.tr["captured_steps"]
        self.cap = Capture(t.model, dict(t.model.named_parameters()),
                           self._ema())
        for s in range(n):
            batch = self._next_batch()
            self.cap.inputs.append(self._keep(batch))
            self.cap.before_step()
            loss = self._step(batch)
            self.cap.after_step(s, loss, t.opt, self.tr["adam_betas"][0],
                                s == n - 1)

    def _ema(self) -> Optional[Dict[str, Tensor]]:
        return None

    def _next_batch(self):
        t0 = time.perf_counter()
        with self.spans.span("loader_wait"):
            batch = next(self.batches)
        self.loader_wait.append(time.perf_counter() - t0)
        return batch

    def window(self, seconds: float) -> dict:
        cuda = self.device.type == "cuda"
        self.loader_wait = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            batch = self._next_batch()
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            self.window_losses.append(self._step(batch))
            if cuda:
                e1.record()
                self.events.append((e0, e1))
        if cuda:
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        n = len(self.window_losses)
        losses = torch.stack(self.window_losses).float().cpu()
        fwd = forward_flops(self.cfg, self.images_per_step,
                            self.cfg["image_size"])
        return {"attempted": n,
                "failed": int((~torch.isfinite(losses)).sum()),
                "steps": n, "images": n * self.images_per_step,
                "wall_s": wall,
                "step_s": [a.elapsed_time(b) / 1e3 for a, b in self.events],
                "loader_wait_s": list(self.loader_wait),
                # the backward at twice the forward, no recompute
                "flops_per_step": {k: 3 * v for k, v in fwd.items()}}

    def traced_segment(self) -> None:
        for _ in range(self.tr["traced_steps"]):
            self._step(self._next_batch())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def counter_lines(self) -> List[str]:
        from pointreggpt_tpu_torch.ops import linear_attention as la
        from pointreggpt_tpu_torch.ops.attention import multihead_attention

        k1, k3 = la.fused_linear_attention, la.fused_linear_attention_bwd
        return [f"launches since start: K1 {k1.launches}, K3 {k3.launches},"
                f" K2 {multihead_attention.launches}; plain routes K1 "
                f"{k1.plain_routes}, K3 {k3.plain_routes}; steps timed "
                f"{len(self.window_losses)}"]

    def release(self) -> None:
        self.trainer = self.batches = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _numbers(self, side: dict, ref: dict) -> Dict[str, float]:
        return numbers(side, ref, self.sd, self.own_loss, self.ema0)

    def _port(self) -> dict:
        cap = self.cap
        return {"losses": [float(x) for x in torch.stack(cap.losses).cpu()],
                "outs": cap.outs, "g1": cap.g1, "p_end": cap.p_end,
                "ema_end": cap.ema_end}

    def check(self) -> Dict[str, float]:
        return self._numbers(self._port(), self.reference("fp32"))

    def controls(self) -> Dict[str, Dict[str, float]]:
        """The control (the reference at the configuration's control
        precision) and the planted half-batch fault, each in the port's
        place, and the port's own numbers. A state left unchanged, or a
        leaf moved double, reads ``update_gap`` (and an EMA left unchanged
        ``ema_gap``) 1 with no run."""
        ref = self.reference("fp32")
        return {
            "control": self._numbers(self.reference(self.cfg["control"]),
                                     ref),
            "half_batch": self._numbers(
                self.reference("fp32", half_batch=True), ref),
            "port": self._numbers(self._port(), ref)}
