"""The denoiser's forward as CUDA graphs: one graph a call signature,
replayed at every later call, so that the host queues one replay a chain
step where it queued each of the forward's kernels through Python, the
dispatcher and ctypes.

:class:`GraphedForward` wraps a baked denoiser (a DiffusionUNet or an
ADMUNet, ``place_for_inference``'s output; ``Generator.device_models()``
builds it) and keeps it as ``.net``. A call ``(x, time, param_cond)`` is
taken by the graph when x is a CUDA tensor, autograd records nothing
(grad mode off, as under ``Generator.step``'s ``torch.inference_mode``)
and no stream capture is under way; every other call runs ``.net``. Of the
calls the graph takes, by signature (the shape, strides, dtype and device
of each input, and the inference mode):

- the first runs ``.net`` eagerly: it warms up cuDNN's plans, the
  kernels' libraries and attributes, and the allocator;
- the second copies its inputs into buffers of the same layout, captures
  one forward on them into a ``torch.cuda.CUDAGraph``, then replays it;
- every later call copies its inputs into those buffers and replays.

Each returns a copy of the graph's output, so no caller holds a tensor a
later replay overwrites. A wrapper's graphs share one memory pool. The
graph is replayed on the caller's current stream, and its buffers are the
wrapper's own: one wrapper serves one stream at a time. A capture that
fails raises.

The counters of launched kernels (the routes of ``ops/conv.py``,
``ops/attention.py`` and ``ops/group_norm.py`` and the ops' ``launches``
and ``plain_routes``) count what ran: a capture launches nothing, so its
increments are taken back, and each replay adds them once. :data:`ROUTES`
counts the calls themselves, each once: ``graph_eager`` (run eagerly on
the card), ``graph_captures`` (captured, then replayed) and
``graph_replays`` (replayed a graph captured before); ``ops/routes.py``
chains it, so generation's ``dispatch`` span records it.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from pointreggpt_tpu_torch.ops import attention, conv, group_norm
from pointreggpt_tpu_torch.ops import linear_attention as la

Tensor = torch.Tensor

# Denoiser calls since import, each in one of the three
ROUTES = {"graph_captures": 0, "graph_replays": 0, "graph_eager": 0}


def _holders() -> tuple:
    """The dicts that hold the counters of launched kernels: the routes
    and the ops' attributes."""
    ops = (conv.conv3x3, conv.conv3_dw, conv.conv3_igemm,
           attention.multihead_attention, group_norm.group_norm_act,
           la.fused_linear_attention, la.fused_linear_attention_bwd,
           la.linear_attention_core)
    return (conv.ROUTES, attention.ROUTES, group_norm.ROUTES,
            *(vars(op) for op in ops))


def counts() -> List[dict]:
    """The counters of launched kernels now, one dict a holder."""
    return [{k: v for k, v in d.items() if type(v) is int}
            for d in _holders()]


def take_back(before: List[dict]) -> List[dict]:
    """Set the counters back to ``before`` (:func:`counts`); returns what
    they had gained since, for :func:`add`."""
    gained = []
    for d, old in zip(_holders(), before):
        gained.append({k: d[k] - v for k, v in old.items() if d[k] != v})
        d.update(old)
    return gained


def add(gained: List[dict]) -> None:
    """Add a forward's counter increments (:func:`take_back`'s) once."""
    for d, inc in zip(_holders(), gained):
        for k, v in inc.items():
            d[k] += v


def signature(args) -> tuple:
    """What a graph is captured for: each input's shape, strides, dtype and
    device (None for an input not given), and the inference mode. The
    stride of a dimension of size 1 addresses nothing and is left out:
    the chain's x, (b, 1, h, w), carries another there after each step."""
    return tuple(None if a is None else
                 (tuple(a.shape),
                  tuple(s if n > 1 else 0 for n, s in zip(a.shape,
                                                          a.stride())),
                  a.dtype, a.device)
                 for a in args) + (torch.is_inference_mode_enabled(),)


class _Graph(NamedTuple):
    static: Tuple[Optional[Tensor], ...]  # the inputs' buffers
    replay: Callable[[], None]
    out: Tensor  # the output's buffer
    gained: List[dict]  # the captured forward's counter increments


class GraphedForward:
    """A baked denoiser's forward, replayed from one CUDA graph a call
    signature where the call is on the card and autograd records nothing;
    ``.net`` is the baked module."""

    def __init__(self, net):
        self.net = net
        self._seen = set()  # signatures run once, eagerly
        self._graphs = {}  # signature -> _Graph
        self._pool = None

    def __call__(self, x: Tensor, time: Tensor,
                 param_cond: Optional[Tensor] = None) -> Tensor:
        args = (x, time, param_cond)
        if not self._engages(args):
            if x.device.type == "cuda" and \
                    not torch.cuda.is_current_stream_capturing():
                ROUTES["graph_eager"] += 1
            return self.net(*args)
        key = signature(args)
        g = self._graphs.get(key)
        if g is None and key not in self._seen:
            self._seen.add(key)
            ROUTES["graph_eager"] += 1
            return self.net(*args)
        if g is None:
            static = tuple(None if a is None else torch.empty_strided(
                a.shape, a.stride(), dtype=a.dtype, device=a.device)
                for a in args)
            _load(static, args)
            before = counts()
            try:
                replay, out = self._capture(static)
            finally:
                gained = take_back(before)
            g = self._graphs[key] = _Graph(static, replay, out, gained)
            ROUTES["graph_captures"] += 1
        else:
            _load(g.static, args)
            ROUTES["graph_replays"] += 1
        g.replay()
        add(g.gained)
        return g.out.clone()

    def _engages(self, args) -> bool:
        """Whether the graph takes the call: x on the card, autograd
        recording nothing, no capture under way."""
        return (args[0].device.type == "cuda"
                and not torch.is_grad_enabled()
                and not torch.cuda.is_current_stream_capturing())

    def _capture(self, static) -> Tuple[Callable[[], None], Tensor]:
        """One forward on the buffers ``static`` captured into a graph of
        the wrapper's pool; returns (replay, the output's buffer)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            out = self.net(*static)
        return graph.replay, out


def _load(static, args) -> None:
    for s, a in zip(static, args):
        if s is not None:
            s.copy_(a)
