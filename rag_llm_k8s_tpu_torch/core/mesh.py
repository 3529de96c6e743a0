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
  ``broadcast_object`` / ``gather_object`` on the control group;
- the rules autograd follows through them, the transposes XLA derives from
  JAX's shardings (training, ``engine/training.py``): ``region_in`` marks
  the input of a column-parallel region (identity forward, gradient summed
  over the axis: each rank's output shard gives only its part of the
  input's gradient), ``reduce_out`` a row-parallel output (sum forward,
  identity backward), ``gather_out`` a gathered output every rank reads
  whole (backward takes this rank's slice: every rank computes the same
  loss, so the gradient is not summed), ``split_in`` this rank's slice of a
  replicated tensor (backward all-gathers the slices' gradients: the sum
  over the axis of each rank's gradient, zero outside its slice), and
  ``ring_shift`` one hop whose backward is one hop the other way. Without
  a gradient to carry (serving) each is the plain collective, in place
  where ``all_reduce`` is, and counts its staged calls as before.

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
        arrives. Bool tensors travel as uint8 and take no gradient; the
        gradient of a float tensor travels one hop back."""
        if self.axis_size(axis) == 1:
            return tuple(tensors)
        if _needs_grad(*tensors):
            return _RingShift.apply(self, axis, *tensors)
        return self._shift(tensors, axis, 1)

    def _shift(self, tensors: Sequence[torch.Tensor], axis: str, step: int) -> Tuple[torch.Tensor, ...]:
        """Each tensor sent ``step`` ranks along ``axis``'s ring (+1 or -1)."""
        n = self.axis_size(axis)
        ranks, i = self.group_ranks[axis], self.axis_index(axis)
        dst, src = ranks[(i + step) % n], ranks[(i - step) % n]
        group = self.groups[axis]
        ops, recv = [], []
        for t in tensors:
            buf = t.detach().contiguous()
            if buf.dtype == torch.bool:
                buf = buf.to(torch.uint8)
            if self.staged:
                buf = self._host(buf)
            r = torch.empty_like(buf)
            ops += [dist.P2POp(dist.isend, buf, dst, group), dist.P2POp(dist.irecv, r, src, group)]
            recv.append(r)
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return tuple(r.to(device=t.device, dtype=t.dtype) for r, t in zip(recv, tensors))

    # -- the collectives autograd passes through (training) -----------------
    def region_in(self, x: torch.Tensor, axis: str = "tp") -> torch.Tensor:
        """The input of a column-parallel region: ``x`` forward, its
        gradient all-reduced (sum) over ``axis`` backward."""
        if self.axis_size(axis) == 1 or not _needs_grad(x):
            return x
        return _RegionIn.apply(x, self, axis)

    def reduce_out(self, x: torch.Tensor, axis: str = "tp") -> torch.Tensor:
        """A row-parallel output: ``x`` summed over ``axis`` (in place
        without a gradient to carry, as ``all_reduce``); the gradient passes
        unchanged."""
        if self.axis_size(axis) == 1:
            return x
        if not _needs_grad(x):
            return self.all_reduce(x, axis)
        return _ReduceOut.apply(x, self, axis)

    def gather_out(self, x: torch.Tensor, dim: int, axis: str = "tp") -> torch.Tensor:
        """``all_gather`` of ``x`` along ``dim``; backward takes this rank's
        slice of the gradient."""
        if self.axis_size(axis) == 1:
            return x
        if not _needs_grad(x):
            return self.all_gather(x, dim, axis)
        return _GatherOut.apply(x, self, dim, axis)

    def split_in(self, tensors: Sequence[torch.Tensor], dim: int, axis: str = "sp") -> Tuple[torch.Tensor, ...]:
        """This rank's equal slice along ``dim`` of each replicated tensor;
        backward all-gathers the slices' gradients over ``axis``, so every
        rank holds the whole gradient."""
        n = self.axis_size(axis)
        if n == 1:
            return tuple(tensors)
        if _needs_grad(*tensors):
            return _SplitIn.apply(self, dim, axis, *tensors)
        return tuple(_own_slice(t, dim, n, self.axis_index(axis)) for t in tensors)

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


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _own_slice(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


class _RegionIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.axis), None, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.clone(memory_format=torch.contiguous_format), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.dim, ctx.n, ctx.i = dim, mesh.axis_size(axis), mesh.axis_index(axis)
        return mesh.all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.dim, ctx.n, ctx.i), None, None, None


class _SplitIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, dim, axis, *tensors):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        n, i = mesh.axis_size(axis), mesh.axis_index(axis)
        return tuple(_own_slice(t, dim, n, i).contiguous() for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        # every gradient, in argument order, on every rank: the collectives match
        return (None, None, None) + tuple(ctx.mesh.all_gather(g.contiguous(), ctx.dim, ctx.axis) for g in grads)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *tensors):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.floats = [t.is_floating_point() for t in tensors]
        out = mesh._shift(tensors, axis, 1)
        ctx.mark_non_differentiable(*[o for o, f in zip(out, ctx.floats) if not f])
        return out

    @staticmethod
    def backward(ctx, *grads):
        # JAX's transpose of ppermute: the cotangents go one hop back
        back = iter(ctx.mesh._shift([g for g, f in zip(grads, ctx.floats) if f], ctx.axis, -1))
        return (None, None) + tuple(next(back) if f else None for f in ctx.floats)


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
