"""Exponential moving average of a module's parameters.

Port of ``pointreggpt_tpu/train/ema.py``, with the semantics of the
lucidrains ``ema_pytorch.EMA`` the reference trains with (decay 0.995,
update every 10):

- an update runs on every ``update_every``-th call and is a no-op between;
- while the raw call count is at most ``update_after_step`` every update is
  a hard copy; the first update after that is one more hard copy;
- after that the decay ramps as ``1 - (1 + k / inv_gamma)^(-power)``,
  clamped to [min_value, beta], where k counts raw calls past the warmup.

The EMA is a copy of the module, updated under ``no_grad``. Its
``state_dict`` has the reference layout (``ema_model.*``,
``online_model.*``, ``initted``, ``step``). The call count and the initted
flag live on the host as well, so an update never reads the device.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn


class EMA(nn.Module):
    def __init__(self, model: nn.Module, *, beta: float = 0.995,
                 update_after_step: int = 100, update_every: int = 10,
                 inv_gamma: float = 1.0, power: float = 2.0 / 3.0,
                 min_value: float = 0.0):
        super().__init__()
        self.online_model = model
        self.ema_model = copy.deepcopy(model).requires_grad_(False)
        self.beta, self.update_after_step = beta, update_after_step
        self.update_every = update_every
        self.inv_gamma, self.power, self.min_value = inv_gamma, power, \
            min_value
        self.register_buffer("initted", torch.tensor(False))
        self.register_buffer("step", torch.tensor(0))
        self._step, self._initted = 0, False

    def current_decay(self, k: int) -> float:
        value = 1.0 - (1.0 + k / self.inv_gamma)**(-self.power)
        return min(max(value, self.min_value), self.beta)

    @torch.no_grad()
    def update(self) -> None:
        """One tick, called once per optimizer step."""
        step = self._step
        if step % self.update_every == 0:
            k = step - self.update_after_step
            ema = list(self.ema_model.parameters())
            online = list(self.online_model.parameters())
            if k <= 0 or not self._initted:
                torch._foreach_copy_(ema, online)
                self._initted = k > 0
            else:
                decay = self.current_decay(k)
                torch._foreach_mul_(ema, decay)
                torch._foreach_add_(ema, online, alpha=1.0 - decay)
            for e, o in zip(self.ema_model.buffers(),
                            self.online_model.buffers()):
                e.copy_(o)
        self._step = step + 1
        self.step.fill_(self._step)
        self.initted.fill_(self._initted)

    def load_state_dict(self, state_dict, strict: bool = True):
        out = super().load_state_dict(state_dict, strict)
        self._step, self._initted = int(self.step), bool(self.initted)
        return out
