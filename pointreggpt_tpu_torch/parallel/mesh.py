"""Data parallelism over GPUs: one process per GPU, under ``torchrun``.

Port of ``pointreggpt_tpu/parallel/mesh.py``. The JAX package drives the
local chips of a host through one ``jax.sharding.Mesh`` and joins hosts
with ``jax.distributed``; here every GPU has its own process, as the
reference's Accelerate launch has (reference README.md:120-130)::

    torchrun --nproc_per_node 8 -m pointreggpt_tpu_torch.cli.<entry point>

Rank, world size and local rank come from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).

- Parameters are replicated: rank 0's are broadcast at start-up
  (:func:`broadcast_module_`), and every rank applies the same update.
- The gradient is averaged by one all-reduce of a flat fp32 buffer per
  optimizer step (:func:`all_reduce_mean_`), where the JAX step's psum
  sits: before the clip, so the clip sees the global gradient. There is no
  ``DistributedDataParallel`` wrapper, so state-dict names and checkpoints
  are those of one process.
- Batches are drawn globally and sliced locally: every rank draws the same
  global batch order, timesteps and noise, and keeps its contiguous block
  of rows (:func:`rank_rows` and ``Rows.take``, the counterpart of
  ``shard_batch``), where ``NamedSharding(P("data"))`` puts them. N ranks compute what one process computes on the global batch,
  apart from summation order.
- The Generator shards a scene range by stride (:func:`local_scene_range`).
- Host objects (the Tester's overview rows, Inception features) reach rank
  0 through :func:`gather_to_main`, over gloo.

The JAX ``create_mesh``'s multi-axis grid has no counterpart: nothing in
the port shards over a second axis.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
from typing import Any, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from pointreggpt_tpu_torch import resolve_device

# a collective waits this long for its peers before it fails (rank 0
# samples and checkpoints at a milestone while the others wait)
DEFAULT_TIMEOUT_S = 1800.0
# the kernel libraries the model paths load (ops/_build.py's sources)
MODEL_SOURCES = ("linear_attention", "linear_attention_bwd", "attention",
                 "conv3x3", "conv3_dw", "group_norm")


def in_process_group() -> bool:
    """True when this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def maybe_initialize_distributed(backend: Optional[str] = None,
                                 timeout_s: float = DEFAULT_TIMEOUT_S
                                 ) -> bool:
    """Join torchrun's process group, if the environment names one.

    A no-op (returning False) when ``WORLD_SIZE`` is unset, or is 1 with no
    ``MASTER_ADDR``. ``RANK`` and ``WORLD_SIZE`` are set together or not
    at all. The default backend is ``"cuda:nccl,cpu:gloo"`` on the card
    (gradients over NCCL, host gathers over gloo) and ``gloo`` on the CPU.
    On the card the process takes its GPU (``cuda:<LOCAL_RANK>``) first,
    and local rank 0 builds the model paths' kernels while the other local
    ranks wait. Call it before any other device use; the CLIs do.
    Returns True when the process is in a group.
    """
    if in_process_group():
        return True
    rank, world = os.environ.get("RANK"), os.environ.get("WORLD_SIZE")
    if bool(rank) != bool(world):
        raise ValueError(
            "RANK and WORLD_SIZE must be set together (got RANK="
            f"{rank!r}, WORLD_SIZE={world!r}); torchrun sets both")
    if not world or (int(world) == 1 and not os.environ.get("MASTER_ADDR")):
        return False
    device = resolve_device()
    if backend is None:
        backend = "cuda:nccl,cpu:gloo" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method="env://", rank=int(rank),
        world_size=int(world),
        timeout=datetime.timedelta(seconds=timeout_s))
    if device.type == "cuda":
        _build_on_local_rank_0()
    return True


def _build_on_local_rank_0() -> None:
    """One nvcc per kernel source on each host, not one per rank: local
    rank 0 builds, the others wait for it in an all-reduce of the failed
    builds and then load the libraries it wrote. A failed build raises on
    every rank."""
    from pointreggpt_tpu_torch.ops import _build

    error = None
    if local_rank() == 0:
        try:
            _build.build_all(MODEL_SOURCES)
        except Exception as exc:  # noqa: BLE001
            error = exc  # raised below, once the peers have heard of it
    failed = int(all_reduce_sum_host([0.0 if error is None else 1.0])[0])
    if error is not None:
        raise error
    if failed:
        raise RuntimeError(
            f"the kernel build failed on local rank 0 of {failed} host(s); "
            "its traceback is in that process's output")


@contextlib.contextmanager
def process_group(backend: Optional[str] = None,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> Iterator[None]:
    """:func:`maybe_initialize_distributed` for the block: an entry
    point's body. A group it joined is left at the end; one joined before
    stays."""
    joined = not in_process_group() and maybe_initialize_distributed(
        backend, timeout_s)
    try:
        yield
    finally:
        if joined:
            dist.destroy_process_group()


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if in_process_group() else 0


def process_count() -> int:
    """The number of processes (1 outside a process group).

    Raises when ``WORLD_SIZE`` says there are more but this process never
    joined their group: it would otherwise train or write as if alone.
    """
    if in_process_group():
        return dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE") or 1)
    if world > 1:
        raise RuntimeError(
            f"WORLD_SIZE is {world} but this process has not joined a "
            "process group: call pointreggpt_tpu_torch.parallel."
            "maybe_initialize_distributed() first (the CLIs do)")
    return 1


def local_rank() -> int:
    """The process's rank on its host (torchrun's ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK") or 0)


def local_device() -> torch.device:
    """The device of this process (``cuda:<LOCAL_RANK>`` under torchrun)."""
    return resolve_device()


def is_main_process() -> bool:
    """Rank-0 gating of logs, checkpoints and images."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every process (nothing outside a process group)."""
    if in_process_group():
        dist.barrier()


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average ``tensors`` (one dtype, one device) over the processes in
    place, with one all-reduce of a flat buffer. Outside a process group
    nothing happens; in a group of one, the sum and the division by 1 are
    exact."""
    if not in_process_group():
        return
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    torch._foreach_copy_(tensors, [
        part.view_as(t) for part, t in zip(
            flat.split([t.numel() for t in tensors]), tensors)])


def broadcast_module_(module: nn.Module, src: int = 0) -> None:
    """Overwrite every parameter and buffer with process ``src``'s."""
    if not in_process_group():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)


def gather_to_main(obj: Any) -> Optional[List[Any]]:
    """Every process's ``obj`` on rank 0, in rank order; None elsewhere.

    The objects travel pickled in CPU tensors (gloo), whatever the device
    backend. Only this program's own processes write what is unpickled.
    """
    if not in_process_group():
        return [obj]
    payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                               dtype=torch.uint8)
    world = dist.get_world_size()
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(sizes, torch.tensor([payload.numel()]))
    longest = max(int(s) for s in sizes)
    padded = torch.zeros(longest, dtype=torch.uint8)
    padded[:payload.numel()] = payload
    parts = [torch.empty(longest, dtype=torch.uint8) for _ in range(world)]
    dist.all_gather(parts, padded)
    if dist.get_rank() != 0:
        return None
    return [pickle.loads(p[:int(n)].numpy().tobytes())
            for p, n in zip(parts, sizes)]


def all_reduce_sum_host(values: np.ndarray) -> np.ndarray:
    """The sum over the processes of a float64 host array (gloo)."""
    t = torch.from_numpy(np.array(values, np.float64))
    if in_process_group():
        dist.all_reduce(t)
    return t.numpy()


class Rows(NamedTuple):
    """This process's block ``[start, stop)`` of a global batch of
    ``total`` rows."""

    start: int
    stop: int
    total: int

    @property
    def size(self) -> int:
        return self.stop - self.start

    def take(self, x):
        """The block's rows of a global array or tensor."""
        return x[self.start:self.stop]


def rank_rows(total: int, rank: Optional[int] = None,
              world: Optional[int] = None) -> Rows:
    """Process ``rank``'s contiguous block of ``total`` rows, split as
    ``np.array_split`` splits them: the first ``total % world`` ranks take
    one row more, and a rank may take none."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    base, extra = divmod(total, world)
    start = rank * base + min(rank, extra)
    return Rows(start, start + base + (1 if rank < extra else 0), total)


def local_scene_range(start: int, stop: int) -> range:
    """This process's scenes of ``[start, stop)``: every
    ``process_count()``-th from ``start + process_index()``."""
    return range(start + process_index(), stop, process_count())
