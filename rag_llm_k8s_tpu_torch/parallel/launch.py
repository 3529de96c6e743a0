"""A world of N ranks, one process each: the launcher ``server/main.py``,
the tests and ``chip_smoke.py`` share.

``spawn_world(fn, mesh_config, ...)`` starts every rank in a ``spawn``
child, initializes the default process group over
``tcp://127.0.0.1:<free port>``, builds each rank's ``MeshContext``
(``core.mesh.make_mesh``) and calls ``fn(ctx, *args)``; it returns the
ranks' results in rank order. It never waits past ``join_timeout_s``: a
rank that raises, exits or does not return in time fails the whole world
(every other rank is killed) with the rank's traceback, so a deadlock fails
instead of hanging. ``start_ranks`` starts some ranks only (``server.main``
runs rank 0 in its own process and starts the followers), and
``init_rank`` joins the calling process to a world.

Backend: ``nccl`` when each rank has a card of its own, else ``gloo``
(``pick_backend``).
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from rag_llm_k8s_tpu_torch.core.config import MeshConfig
from rag_llm_k8s_tpu_torch.core.mesh import MAX_TIMEOUT_S, make_mesh, rank_device


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pick_backend(world: int, device: Optional[str] = None) -> str:
    """``nccl`` when every rank gets a card of its own, else ``gloo``."""
    if device is None and torch.cuda.is_available() and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_rank(rank: int, world: int, port: int, backend: str, timeout_s: float = MAX_TIMEOUT_S) -> None:
    """Join this process to the world as ``rank``."""
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def join_mesh(rank: int, world: int, port: int, backend: str, mesh_config: MeshConfig,
              device: Optional[str] = None, timeout_s: float = MAX_TIMEOUT_S):
    """``init_rank`` then this rank's ``MeshContext`` on its device."""
    dev = rank_device(rank, device)
    if dev.type == "cpu":
        # many ranks share the host's cores
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    init_rank(rank, world, port, backend, timeout_s)
    return make_mesh(mesh_config, device=dev, timeout_s=timeout_s)


def _rank_main(rank, world, port, backend, mesh_config, device, timeout_s, fn, args, results):
    try:
        ctx = join_mesh(rank, world, port, backend, mesh_config, device, timeout_s)
        out = fn(ctx, *args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the launcher, then the rank exits non-zero
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()  # the traceback reaches the launcher before the exit
        os._exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def start_ranks(
    fn: Callable, ranks: Sequence[int], world: int, port: int, backend: str, mesh_config: MeshConfig,
    device: Optional[str] = None, timeout_s: float = MAX_TIMEOUT_S, args: tuple = (), results=None,
) -> List:
    """Start ``ranks`` of a world of ``world`` as ``spawn`` children, each
    running ``fn(ctx, *args)``; each puts ``(rank, ok, result or
    traceback)`` on ``results`` (a queue of the spawn context; a fresh one
    when None, kept on each process as ``.results``)."""
    mpc = mp.get_context("spawn")
    results = mpc.Queue() if results is None else results
    procs = []
    for r in ranks:
        p = mpc.Process(target=_rank_main, name=f"rank{r}",
                        args=(r, world, port, backend, mesh_config, device, timeout_s, fn, args, results))
        p.start()
        p.results = results
        procs.append(p)
    return procs


def stop_ranks(procs: Sequence, grace_s: float = 5.0) -> None:
    """Terminate the processes still running, killing any that outlast
    ``grace_s``."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    t_end = time.monotonic() + grace_s
    for p in procs:
        p.join(max(0.0, t_end - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join(1.0)


def spawn_world(
    fn: Callable, mesh_config: MeshConfig, backend: Optional[str] = None, timeout_s: float = MAX_TIMEOUT_S,
    device: Optional[str] = None, args: tuple = (), world: Optional[int] = None,
    join_timeout_s: float = 600.0,
) -> List:
    """Run ``fn(ctx, *args)`` on every rank of the mesh ``mesh_config``
    (``world`` ranks; ``tp = -1`` fills it) and return the results in rank
    order. ``device="cpu"`` runs every rank on the CPU; by default rank
    ``r`` takes ``cuda:(r % device_count)``. Raises ``RuntimeError`` with
    the rank's traceback when a rank fails or exits, ``TimeoutError`` when
    the world has not returned within ``join_timeout_s``; every rank is
    stopped either way."""
    if world is None:
        if mesh_config.tp == -1:
            raise ValueError("spawn_world: tp=-1 needs world=")
        world = mesh_config.dp * mesh_config.sp * mesh_config.tp
    backend = backend or pick_backend(world, device)
    procs = start_ranks(fn, range(world), world, free_port(), backend, mesh_config, device, timeout_s, args)
    results = procs[0].results
    out, t_end = {}, time.monotonic() + join_timeout_s
    try:
        while len(out) < world:
            left = t_end - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn_world: {world - len(out)} rank(s) did not return within "
                                   f"{join_timeout_s} s")
            try:
                rank, ok, res = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p.name for i, p in enumerate(procs) if i not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn_world: {dead} exited without a result")
                continue
            if not ok:
                raise RuntimeError(f"spawn_world: rank {rank} failed:\n{res}")
            out[rank] = res
        for p in procs:
            p.join(timeout=max(1.0, t_end - time.monotonic()))
    finally:
        stop_ranks(procs)
    return [out[r] for r in range(world)]
