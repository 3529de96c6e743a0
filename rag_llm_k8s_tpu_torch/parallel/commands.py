"""The SPMD command stream: how rank 0 drives the followers.

Rank 0 runs the HTTP service, the tokenizers, the encoder and the kNN;
every rank holds its shard of the Llama weights and runs the same engine
calls in the same order. Before rank 0 runs an engine call that reaches a
collective, it broadcasts the call on the mesh's gloo control group as a
command, ``(name, payload)``, the payload numpy arrays and plain Python
(the assembled prompt, the sampler's generator state, the token budget,
whether to speculate). A follower loops: receive a command, run it
(``serve_commands``). Every host decision that could differ between ranks
(a fault armed, a deadline, the speculation switch, a shadow audit) is made
on rank 0 and reaches the followers inside a command, so no rank enters a
collective on its own clock.

``CommandStream.lock`` serializes sending a command with running it on
rank 0: two threads (a request and the shadow auditor) can never interleave
their collectives. A heartbeat thread sends ``heartbeat`` at a fixed
interval, between two commands when the stream is busy, so the followers'
waiting broadcast never reaches the group's timeout while it is idle, and
gathers every rank's device memory (``peer_stats``, read by
``obs/devices.py``). A collective that fails marks the stream broken:
``ready()`` turns false and every later call raises.

One stream serves every engine of a mesh (``stream_for``), with one kind
of engine command, ``call``. A method marked ``@mesh_command`` on an
object registered as a target (``register_target``, in the same order on
every rank, so the names agree) is sent as ``call`` with its arguments and
run on every rank: every rank runs the same host allocator, tables and
slots on the same inputs, each on its own shard, and no command carries an
activation. A tensor argument (a prompt's token ids) travels as a host
tensor and lands on each follower's device; a ``torch.Generator`` travels
as its state. A call nested in a running command runs where it is. A
``call`` also carries:

- rank 0's clock (``now()`` reads it inside a command on every rank), so a
  hotness decay or a tier sweep decides the same on every rank;
- the armed fault sites (``resilience.faults.scoped``): a site fires at
  the same place on every rank, and rank 0's table is charged once;
- the objects it names by reference (``MeshRef``): a result that marks
  itself ``_mesh_shared`` (a ``CachedPrefix``, a migration packet's
  planes) is kept by each rank under one id, and rank 0's copy being
  collected frees the followers' with the next command.

A call that raises on rank 0 asks every follower how its own run ended
(``outcome``): the same exception everywhere (an injected fault, a full
pool) leaves the stream healthy; anything else breaks it with
``MeshDivergence``. A follower whose call raised while rank 0's did not
sees another command than ``outcome`` next, and leaves its loop with
``MeshDivergence``: its process exits, and rank 0 follows it out.
``gather_digests`` is the cheap cross-rank check of host state (tables,
frontiers, slots): a difference breaks the stream and raises, so a
divergence fails instead of hanging. Every heartbeat, idle or serving,
makes the same check: each rank's ``device_stats`` carries the ``state_digest()``
of each live target that has one (a continuous engine's slots, tables and
pool; a prefix cache's entries and tiers), and a target whose digest
differs between ranks ends the world as ``MeshDivergence`` does: rank 0
sends ``diverged``, each follower leaves its loop with ``MeshDivergence``
(its process exits, and rank 0 follows it out), and rank 0's stream is
broken.
"""

from __future__ import annotations

import functools
import logging
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional

import torch

from rag_llm_k8s_tpu_torch.resilience import faults

logger = logging.getLogger(__name__)

# the command this thread is running: rank 0's clock for it, and whether a
# nested mesh call runs in place
_local = threading.local()


class MeshDivergence(RuntimeError):
    """The ranks of a mesh no longer hold the same host state."""


class MeshRef:
    """An object every rank keeps under one id (``_mesh_shared``)."""

    __slots__ = ("id",)

    def __init__(self, id: int):
        self.id = id


def now() -> float:
    """The command clock: inside a command, rank 0's ``time.monotonic()``
    when it sent it (the same on every rank); else this process's."""
    c = getattr(_local, "clock", None)
    return time.monotonic() if c is None else c


def in_command() -> bool:
    return getattr(_local, "clock", None) is not None


class _Scope:
    """Run a command's body at ``clock`` with the fault table ``table``;
    ``left`` is what the table holds afterwards."""

    def __init__(self, clock: float, table: Dict[str, int]):
        self.clock, self.table, self.left = clock, table, dict(table)

    def run(self, fn, *args, **kwargs):
        prev = getattr(_local, "clock", None)
        _local.clock = self.clock
        try:
            with faults.scoped(self.table) as self.left:
                return fn(*args, **kwargs)
        finally:
            _local.clock = prev


def _targets(ctx) -> "weakref.WeakValueDictionary":
    t = ctx.__dict__.get("_targets")
    if t is None:
        t = ctx.__dict__["_targets"] = weakref.WeakValueDictionary()
        ctx.__dict__["_target_seq"] = 0
        ctx.__dict__["_refs"] = {}
        ctx.__dict__["_ref_seq"] = 0
    return t


def register_target(ctx, obj, kind: str) -> Optional[str]:
    """Name ``obj`` on ``ctx`` (None off a mesh): ``f"{kind}{n}"``, in
    construction order, which is the same on every rank."""
    if ctx is None or ctx.world <= 1:
        return None
    targets = _targets(ctx)
    ctx._target_seq += 1
    name = f"{kind}{ctx._target_seq}"
    targets[name] = obj
    return name


def stream_for(ctx) -> Optional["CommandStream"]:
    """Rank 0's one command stream over ``ctx`` (a fresh one once the last
    has stopped); None off a mesh and on the followers."""
    if ctx is None or ctx.world <= 1 or not ctx.leader:
        return None
    s = ctx.__dict__.get("_stream")
    if s is None or (s.stopped and s.broken is None):
        s = ctx.__dict__["_stream"] = CommandStream(ctx)
    return s


def mesh_command(fn):
    """Mark a method of a mesh target (``self._commands``: rank 0's stream
    or None; ``self._mesh_name``): on rank 0 it runs as a ``call`` command
    on every rank; elsewhere, and nested in a command, it runs in place."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        stream = self._commands
        if stream is None or in_command():
            return fn(self, *args, **kwargs)
        return stream.invoke(self._mesh_name, fn, self, args, kwargs)

    return wrapper


def _walk(x, fn, depth: int = 0):
    """``x`` with ``fn`` applied to each leaf, through tuples, lists and
    dicts three levels deep (an item's tuple in a list, a packet's fields)."""
    if depth < 3:
        if isinstance(x, dict):
            return {k: _walk(v, fn, depth + 1) for k, v in x.items()}
        if type(x) in (tuple, list):
            return type(x)(_walk(v, fn, depth + 1) for v in x)
    return fn(x)


def _each_shared(x, depth: int = 0):
    """The ``_mesh_shared`` objects in a result, in a fixed order."""
    if getattr(x, "_mesh_shared", False):
        yield x
    elif depth < 3:
        if isinstance(x, dict):
            for v in x.values():
                yield from _each_shared(v, depth + 1)
        elif type(x) in (tuple, list):
            for v in x:
                yield from _each_shared(v, depth + 1)


def _bind(ctx, out, keep: bool) -> List:
    """Give each shared object in ``out`` without an id the next of
    ``ctx``'s and return them; a follower keeps each (``keep``) until rank
    0 frees its id."""
    _targets(ctx)
    new = []
    for obj in _each_shared(out):
        if getattr(obj, "_mesh_ref", None) is not None:
            continue
        ctx._ref_seq += 1
        obj._mesh_ref = ctx._ref_seq
        new.append(obj)
        if keep:
            ctx._refs[ctx._ref_seq] = obj
    return new


class _HostTensor:
    """A tensor argument on the wire: its host copy, placed on the
    follower's device on arrival."""

    __slots__ = ("t",)

    def __init__(self, t: torch.Tensor):
        self.t = t


class _GenState:
    """A ``torch.Generator`` argument on the wire: its state."""

    __slots__ = ("state",)

    def __init__(self, state: torch.Tensor):
        self.state = state


def _to_wire(x):
    def leaf(v):
        if getattr(v, "_mesh_shared", False):
            if getattr(v, "_mesh_ref", None) is None:
                raise ValueError(f"{type(v).__name__} was not made by a mesh command: no rank can name it")
            return MeshRef(v._mesh_ref)
        if isinstance(v, torch.Tensor):
            return _HostTensor(v.detach().cpu())
        if isinstance(v, torch.Generator):
            return _GenState(v.get_state())
        return v

    return _walk(x, leaf)


def _from_wire(ctx, x):
    def leaf(v):
        if isinstance(v, MeshRef):
            return ctx._refs[v.id]
        if isinstance(v, _HostTensor):
            return v.t.to(ctx.device)
        if isinstance(v, _GenState):
            gen = torch.Generator(device=ctx.device)
            gen.set_state(v.state)
            return gen
        return v

    return _walk(x, leaf)


def _outcome(exc: Optional[BaseException]) -> Optional[str]:
    return None if exc is None else type(exc).__name__


def device_stats(ctx) -> Dict:
    """This rank's card memory: its index, the caching allocator's live
    bytes and the card's total (zeros on the CPU), and each live target's
    ``mesh_stats()`` (its arena's or its cache's bytes on this rank)."""
    dev = ctx.device
    if dev.type != "cuda":
        st = {"rank": ctx.rank, "device": 0, "allocated": 0, "total": 0}
    else:
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        st = {"rank": ctx.rank, "device": idx, "allocated": int(torch.cuda.memory_allocated(idx)),
              "total": int(torch.cuda.get_device_properties(idx).total_memory)}
    live = list(_targets(ctx).items())
    st["targets"] = {name: obj.mesh_stats() for name, obj in live if hasattr(obj, "mesh_stats")}
    st["digests"] = {name: obj.state_digest() for name, obj in live if hasattr(obj, "state_digest")}
    return st


def digest_mismatch(stats: List[Dict]) -> Optional[str]:
    """The targets whose state digests differ between the ranks'
    ``device_stats`` (a target not yet collected on every rank is left
    out: its liveness may differ, its state may not), or None."""
    names = set.intersection(*(set(s.get("digests", {})) for s in stats)) if stats else set()
    bad = {n: {s["rank"]: s["digests"][n] for s in stats} for n in sorted(names)
           if len({s["digests"][n] for s in stats}) > 1}
    return f"the ranks' state digests differ: {bad}" if bad else None


class CommandStream:
    """Rank 0's side of the command stream over ``ctx``'s control group."""

    def __init__(self, ctx):
        if not ctx.leader:
            raise ValueError("only rank 0 sends commands")
        self.ctx = ctx
        self.lock = threading.RLock()
        self.sent = 0
        self.broken: Optional[str] = None
        self.stopped = False
        self.peer_stats: Dict[int, Dict] = {}
        # shared-object ids rank 0 has dropped: freed on the followers with
        # the next command
        self._frees: List[int] = []
        self._frees_lock = threading.Lock()
        # when the last heartbeat ran, and the beat's interval once started:
        # the next beat is due ``beat_s`` later, idle or serving
        self._beat_at = time.monotonic()
        self.beat_s: Optional[float] = None
        self._stop_beat = threading.Event()
        self._beat: Optional[threading.Thread] = None

    def send(self, name: str, **payload) -> None:
        """Broadcast one command; the caller holds ``lock`` until it has
        run the call itself."""
        if self.broken is not None or self.stopped:
            raise RuntimeError(f"the command stream is {'broken: ' + self.broken if self.broken else 'stopped'}")
        try:
            self.ctx.broadcast_object((name, payload))
        except Exception as e:
            self.broken = f"{name}: {e!r}"
            logger.error("command %s failed to reach the followers: %r", name, e)
            raise
        self.sent += 1

    def _note_free(self, ref: int) -> None:
        with self._frees_lock:
            self._frees.append(ref)

    def _take_frees(self) -> List[int]:
        with self._frees_lock:
            out, self._frees = self._frees, []
        return out

    def invoke(self, target: str, fn: Callable, obj, args: tuple, kwargs: dict):
        """Run the mesh method ``fn`` of the target ``obj`` (named
        ``target``) as a ``call`` command: sent, then run here at the
        command's clock and fault table, under the lock."""
        ctx = self.ctx
        with self.lock:
            if self.beat_s is not None and time.monotonic() - self._beat_at >= self.beat_s:
                # a busy stream beats between two calls, so its digests are
                # compared however little the beat thread gets the lock
                self.heartbeat()
            clock, table = time.monotonic(), faults.armed()
            self.send("call", target=target, method=fn.__name__, args=_to_wire(args), kwargs=_to_wire(kwargs),
                      clock=clock, faults=table, free=self._take_frees())
            scope = _Scope(clock, table)
            try:
                out = scope.run(fn, obj, *args, **kwargs)
            except Exception as e:
                faults.charge(table, scope.left)
                self._check_outcome(fn.__name__, e)
                raise
            faults.charge(table, scope.left)
            for shared in _bind(ctx, out, keep=False):
                weakref.finalize(shared, self._note_free, shared._mesh_ref)
            return out

    def _check_outcome(self, name: str, exc: BaseException) -> None:
        """After ``name`` raised here: did every follower's run raise the
        same? If not (or the gather fails), the stream is broken."""
        try:
            self.send("outcome")
            got = self.ctx.gather_object(_outcome(exc))
        except Exception as e:  # noqa: BLE001 — reported as the divergence below
            got = [repr(e)]
        if any(g != _outcome(exc) for g in got):
            self.broken = f"{name}: rank 0 raised {exc!r}, the ranks ended {got}"
            raise MeshDivergence(self.broken) from exc

    def gather_digests(self, digest_fn: Callable[[], str], what: str) -> List[str]:
        """Every rank's ``digest_fn()`` (run inside a mesh command); raises
        ``MeshDivergence`` and breaks the stream when they differ."""
        got = self.ctx.gather_object(digest_fn())
        if len(set(got)) > 1:
            self.broken = f"{what}: the ranks' state digests differ: {got}"
            raise MeshDivergence(self.broken)
        return got

    def heartbeat(self) -> Dict[int, Dict]:
        """One ``heartbeat`` command: every rank's ``device_stats`` (the
        last ones once the stream has stopped). Targets whose state digests
        differ end the world: ``diverged`` goes to the followers, the
        stream breaks and ``MeshDivergence`` raises."""
        with self.lock:
            if self.stopped:
                return self.peer_stats
            self.send("heartbeat")
            self._beat_at = time.monotonic()
            try:
                got = self.ctx.gather_object(device_stats(self.ctx))
            except Exception as e:
                self.broken = f"heartbeat: {e!r}"
                raise
            bad = digest_mismatch(got)
            if bad is not None:
                try:
                    self.send("diverged", reason=bad)
                finally:
                    self.broken = f"heartbeat: {bad}"
                logger.error("mesh divergence at a heartbeat: %s", bad)
                raise MeshDivergence(self.broken)
        self.peer_stats = {s["rank"]: s for s in got}
        return self.peer_stats

    def start_heartbeat(self, interval_s: float) -> None:
        """Beat every ``interval_s``, idle or serving: the beat thread keeps
        an idle stream well inside the groups' timeout, and a call due a
        beat runs it first (``invoke``), so a busy stream has its digests
        compared as often."""
        self.beat_s = interval_s
        self.heartbeat()

        def loop():
            while not self._stop_beat.wait(interval_s / 4):
                if self.broken is not None or self.stopped:
                    return
                if time.monotonic() - self._beat_at < interval_s:
                    continue
                try:
                    self.heartbeat()
                except Exception:  # noqa: BLE001 — broken is set; ready() reports it
                    logger.exception("heartbeat failed: a follower is gone")
                    return

        self._beat = threading.Thread(target=loop, daemon=True, name="mesh-heartbeat")
        self._beat.start()

    def ready(self) -> bool:
        """Whether every follower is following: no failed collective, not
        stopped, and the heartbeat (once started) still beating."""
        if self.broken is not None or self.stopped:
            return False
        return self._beat is None or self._beat.is_alive()

    def stop(self) -> None:
        """Send ``stop``: the followers leave their loops."""
        self._stop_beat.set()
        with self.lock:
            if not self.stopped and self.broken is None:
                self.send("stop")
            self.stopped = True
        if self._beat is not None and self._beat is not threading.current_thread():
            self._beat.join(timeout=5.0)


def _run_call(ctx, payload) -> Optional[str]:
    """A follower's side of one ``call``: the freed ids dropped, then the
    named target's method at rank 0's clock and fault table; returns how it
    ended (None, or the exception's type name)."""
    targets = _targets(ctx)
    for ref in payload["free"]:
        ctx._refs.pop(ref, None)
    obj = targets.get(payload["target"])
    if obj is None:
        raise RuntimeError(f"rank {ctx.rank}: no mesh target {payload['target']!r} (built out of order?)")
    # a follower has no stream: the method runs in place
    fn = getattr(obj, payload["method"])
    scope = _Scope(payload["clock"], payload["faults"])
    try:
        out = scope.run(fn, *_from_wire(ctx, payload["args"]), **_from_wire(ctx, payload["kwargs"]))
    except Exception as e:  # noqa: BLE001 — rank 0 compares the outcome when its own run raised
        logger.info("rank %d: %s.%s raised %r", ctx.rank, payload["target"], payload["method"], e)
        return _outcome(e)
    _bind(ctx, out, keep=True)
    return None


def serve_commands(ctx) -> int:
    """A follower's loop: run each command rank 0 sends until ``stop``
    (``call`` on the named target); returns the commands run. An exception
    outside a ``call`` leaves the loop, and so does a ``call`` that raised
    here while rank 0's did not (the next command is not ``outcome``):
    ``MeshDivergence``. The caller exits non-zero."""
    n, last = 0, None
    while True:
        name, payload = ctx.broadcast_object(None)
        if last is not None and name != "outcome":
            raise MeshDivergence(f"rank {ctx.rank}: a call raised {last} here and not on rank 0 "
                                 f"(the next command is {name!r})")
        if name == "stop":
            return n
        if name == "heartbeat":
            ctx.gather_object(device_stats(ctx))
            continue
        if name == "diverged":
            raise MeshDivergence(f"rank {ctx.rank}: rank 0's heartbeat found {payload['reason']}")
        if name == "outcome":
            ctx.gather_object(last)
            last = None
            continue
        if name != "call":
            raise ValueError(f"rank {ctx.rank}: unknown command {name!r}")
        last = _run_call(ctx, payload)
        n += 1
