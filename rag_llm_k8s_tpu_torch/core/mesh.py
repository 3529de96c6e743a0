"""The device mesh on ``torch.distributed``, counterpart of
``rag_llm_k8s_tpu/core/mesh.py``.

The JAX package is single-controller: one process, and XLA emits every
collective from the sharding annotations. PyTorch's idiom is one process per
rank with explicit collectives, so here:

- rank ``r`` sits at the mesh coordinate of ``np.arange(world).reshape(dp,
  sp, tp)`` (``tp`` varies fastest, as ``make_mesh`` lays out devices);
- each rank holds a process group per axis line through it (``tp``, ``sp``,
  ``dp``; none for an axis of size 1) and a gloo control group over every
  rank for host objects (the command stream, ``parallel/commands.py``);
- the collectives XLA inserted are methods: ``all_reduce`` over tp (the
  row-parallel outputs, the vocab-parallel embedding; ``op="max"`` for the
  int8 scales of row-parallel weights), ``all_gather`` over tp (the
  vocab-sharded logits) and over sp (the ring's output), ``ring_shift`` over
  sp (``ppermute``, through ``dist.batch_isend_irecv``), and
  ``broadcast_object`` / ``gather_object`` on the control group.

Backend: ``nccl`` when each rank has a card of its own, ``gloo`` otherwise
(the CPU tests, several ranks sharing one card). gloo's collectives are
staged through pinned host memory for CUDA tensors: the choice is made by
backend and device when the mesh is built (``staged``), logged, and each
staged collective is counted (``staged_calls``); it is never made after an
exception. Every group carries the timeout it was built with (at most
``MAX_TIMEOUT_S``), so a mismatched collective fails instead of hanging.
"""

from __future__ import annotations

import datetime
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from rag_llm_k8s_tpu_torch.core.config import MeshConfig
from rag_llm_k8s_tpu_torch.core.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

MAX_TIMEOUT_S = 120.0
AXES = ("dp", "sp", "tp")


class MeshContext:
    """This rank's view of the ``(dp, sp, tp)`` mesh: its coordinate, its
    device, its groups and the collectives over them. An axis of size 1
    has no group, and its collectives return their input."""

    def __init__(
        self, dp: int = 1, sp: int = 1, tp: int = 1, rank: int = 0,
        device: Optional[torch.device] = None, backend: Optional[str] = None,
        groups: Optional[Dict[str, object]] = None, group_ranks: Optional[Dict[str, List[int]]] = None,
        staged: bool = False,
    ):
        self.shape = {"dp": dp, "sp": sp, "tp": tp}
        self.rank = rank
        self.device = device if device is not None else torch.device("cpu")
        self.backend = backend
        self.groups = dict(groups or {})
        self.group_ranks = dict(group_ranks or {})
        self.staged = staged
        # collectives staged through pinned host memory (gloo over CUDA tensors)
        self.staged_calls = 0
        self.coords = tuple(int(c) for c in np.unravel_index(rank, (dp, sp, tp)))

    # -- axis sizes ------------------------------------------------------------
    def axis_size(self, name: str) -> int:
        return self.shape[name]

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along ``name``."""
        return self.coords[AXES.index(name)]

    @property
    def tp(self) -> int:
        return self.axis_size("tp")

    @property
    def dp(self) -> int:
        return self.axis_size("dp")

    @property
    def sp(self) -> int:
        return self.axis_size("sp")

    @property
    def n_devices(self) -> int:
        return int(np.prod(list(self.shape.values())))

    world = n_devices

    @property
    def leader(self) -> bool:
        """Rank 0: the rank that serves HTTP and sends the command stream."""
        return self.rank == 0

    def __repr__(self) -> str:
        return (f"MeshContext(dp={self.dp}, sp={self.sp}, tp={self.tp}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend}, staged={self.staged})")

    # -- collectives -------------------------------------------------------
    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """A pinned host copy of ``t`` for a staged collective."""
        self.staged_calls += 1
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    def all_reduce(self, x: torch.Tensor, axis: str = "tp", op: str = "sum") -> torch.Tensor:
        """``x`` reduced over ``axis`` in place (``op`` ``"sum"`` or
        ``"max"``), in ``x``'s dtype; returns ``x``."""
        if self.axis_size(axis) == 1:
            return x
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        group = self.groups[axis]
        if self.staged:
            h = self._host(x)
            dist.all_reduce(h, op=red, group=group)
            x.copy_(h)
            return x
        dist.all_reduce(x, op=red, group=group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int, axis: str = "tp") -> torch.Tensor:
        """Every rank's ``x`` along ``axis``, concatenated along ``dim`` in
        axis order."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        src = x.contiguous()
        if self.staged:
            src = self._host(src)
        outs = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(outs, src, group=self.groups[axis])
        return torch.cat(outs, dim=dim).to(x.device)

    def ring_shift(self, tensors: Sequence[torch.Tensor], axis: str = "sp") -> Tuple[torch.Tensor, ...]:
        """One hop around ``axis``'s ring (JAX ``ppermute`` with ``j -> j +
        1``): each tensor goes to the next rank and the previous rank's
        arrives. Bool tensors travel as uint8."""
        n = self.axis_size(axis)
        if n == 1:
            return tuple(tensors)
        ranks, i = self.group_ranks[axis], self.axis_index(axis)
        nxt, prv = ranks[(i + 1) % n], ranks[(i - 1) % n]
        group = self.groups[axis]
        ops, recv = [], []
        for t in tensors:
            src = t.contiguous()
            if src.dtype == torch.bool:
                src = src.to(torch.uint8)
            if self.staged:
                src = self._host(src)
            r = torch.empty_like(src)
            ops += [dist.P2POp(dist.isend, src, nxt, group), dist.P2POp(dist.irecv, r, prv, group)]
            recv.append(r)
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return tuple(r.to(device=t.device, dtype=t.dtype) for r, t in zip(recv, tensors))

    def broadcast_object(self, obj=None):
        """Rank 0's ``obj`` on every rank (the control group)."""
        if self.world == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.groups["control"])
        return box[0]

    def gather_object(self, obj) -> Optional[List]:
        """Every rank's ``obj`` on rank 0, in rank order (None elsewhere)."""
        if self.world == 1:
            return [obj]
        out = [None] * self.world if self.leader else None
        dist.gather_object(obj, out, dst=0, group=self.groups["control"])
        return out

    def barrier(self, timeout_s: float) -> None:
        """Every rank here within ``timeout_s`` (gloo's monitored barrier on
        the control group: it names a rank that did not arrive)."""
        if self.world > 1:
            dist.monitored_barrier(group=self.groups["control"], timeout=datetime.timedelta(seconds=timeout_s))


def axis_lines(dp: int, sp: int, tp: int) -> Dict[str, List[List[int]]]:
    """The rank lists of every group of each axis, in the order every rank
    builds them: ``np.arange(world).reshape(dp, sp, tp)`` sliced along it."""
    arr = np.arange(dp * sp * tp).reshape(dp, sp, tp)
    return {
        "tp": [arr[d, s, :].tolist() for d in range(dp) for s in range(sp)],
        "sp": [arr[d, :, t].tolist() for d in range(dp) for t in range(tp)],
        "dp": [arr[:, s, t].tolist() for s in range(sp) for t in range(tp)],
    }


def rank_device(rank: int, device: DeviceLike = None) -> torch.device:
    """Rank ``r``'s device: ``cuda:(r % device_count)`` by default (raises
    without a card), else ``device`` as given (``"cpu"`` in the tests)."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(
    config: Optional[MeshConfig] = None, device: DeviceLike = None, timeout_s: float = MAX_TIMEOUT_S,
) -> MeshContext:
    """This rank's ``(dp, sp, tp)`` mesh over the initialized default
    process group (``parallel/launch.py`` initializes it); without one, the
    single-device mesh. Every rank must call it, in the same order as any
    other ``make_mesh``: it builds every group of the mesh."""
    config = config or MeshConfig()
    if not dist.is_initialized():
        dp, sp, tp = config.resolved(1)
        return single_device_mesh(device)
    if timeout_s > MAX_TIMEOUT_S:
        raise ValueError(f"timeout_s={timeout_s}: a mesh's collectives time out within {MAX_TIMEOUT_S} s")
    world, rank = dist.get_world_size(), dist.get_rank()
    dp, sp, tp = config.resolved(world)
    dev = rank_device(rank, device)
    backend = dist.get_backend()
    timeout = datetime.timedelta(seconds=timeout_s)
    groups, group_ranks = {}, {}
    for axis, lines in axis_lines(dp, sp, tp).items():
        for ranks in lines:
            if len(ranks) == 1:
                continue
            g = dist.new_group(ranks, backend=backend, timeout=timeout)
            if rank in ranks:
                groups[axis], group_ranks[axis] = g, ranks
    groups["control"] = dist.new_group(list(range(world)), backend="gloo", timeout=timeout)
    staged = backend == "gloo" and dev.type == "cuda"
    ctx = MeshContext(dp, sp, tp, rank, dev, backend, groups, group_ranks, staged)
    if staged:
        logger.info("mesh %s: gloo over CUDA tensors, every collective staged through pinned host memory", ctx)
    return ctx


def single_device_mesh(device: DeviceLike = None) -> MeshContext:
    """1x1x1 mesh: every mesh-aware path runs unchanged on one device."""
    return MeshContext(1, 1, 1, 0, resolve_device(device))
