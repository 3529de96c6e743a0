"""Prefix-affinity front tier over engine replicas, the port's copy of
``rag_llm_k8s_tpu/server/router.py``.

- :class:`Replica`: an in-process ``ContinuousScheduler`` and its engine,
  with the replica's own breaker and admission gate when it runs inside a
  service. Its role is its engine's ``pool_role``: a ``"prefill"`` engine
  admits and exports each request as a migration packet, a ``"decode"``
  engine imports packets and decodes, a ``"unified"`` one serves either
  side and is the fallback when a tier is empty.
- :meth:`Router.select` scores candidates ``affinity_weight *
  chunk_affinity + load_weight * free_capacity``. Chunk affinity is the
  share of the request's retrieved-chunk keys already hot on the replica,
  from a bounded per-replica LRU the router keeps from its own decisions,
  so a repeated chunk composition goes where its chunks were prefilled.
  A session sticks to its replica for ``session_ttl_s``.
- Health: a replica whose breaker is open, whose gate is draining or whose
  scheduler has stopped takes no new work (the signal ``/healthz`` serves).
- An optional admission gate fronts the whole tier.

Every decision is journaled as one ``route_decision`` flight event. As in
the JAX package this is an in-process API: the HTTP service does not build
a ``Router``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from rag_llm_k8s_tpu_torch.core.config import RouterConfig
from rag_llm_k8s_tpu_torch.obs import flight

__all__ = ["NoReplicaAvailable", "Replica", "Router"]

# hard cap on tracked sessions; TTL expiry is the normal bound, the cap
# matters only under a flood of one-shot session ids
_MAX_SESSIONS = 4096


class NoReplicaAvailable(RuntimeError):
    """Every candidate replica is unhealthy (breaker open, draining or
    stopped)."""

    def __init__(self, role: str):
        super().__init__(f"no healthy replica for role {role!r}")
        self.role = role


class Replica:
    """One engine behind the router: ``scheduler`` (a
    ``ContinuousScheduler``), and the replica's own ``breaker`` and
    ``admission`` gate when it runs inside a service."""

    def __init__(self, name: str, scheduler, breaker=None, admission=None):
        self.name = name
        self.scheduler = scheduler
        self.breaker = breaker
        self.admission = admission

    @property
    def engine(self):
        return self.scheduler.engine

    @property
    def role(self) -> str:
        return getattr(self.engine, "pool_role", "unified")

    def healthy(self) -> bool:
        """The readiness ``/healthz`` serves: breaker closed, gate not
        draining, scheduler running."""
        if self.breaker is not None and self.breaker.open:
            return False
        if self.admission is not None and self.admission.draining:
            return False
        stop = getattr(self.scheduler, "_stop", None)
        return not (stop is not None and stop.is_set())

    def load(self) -> float:
        """Free capacity in [0, 1]: the mean of the free rows' and the free
        pool blocks' shares, read from the scheduler thread's host mirrors
        without a lock (gauge-grade, like every scrape)."""
        eng = self.engine
        rows = len(eng.free_slots()) / max(1, eng.B)
        pool = getattr(eng, "kv_pool", None)
        if pool is None:
            return rows
        usable = max(1, pool.usable_blocks())
        blocks = (pool.usable_blocks() - pool.blocks_in_use()) / usable
        return 0.5 * (rows + max(0.0, blocks))


class Router:
    """Front tier over replica handles: score, route, hand off. Thread-safe:
    the affinity and session registries change under one lock, and each
    replica's scheduler serializes its engine. In-process replicas share
    one flight journal and one request-id counter, so a migrated request
    reads as one timeline across both engines."""

    def __init__(self, replicas: Sequence[Replica], config: RouterConfig = RouterConfig(), admission=None):
        if not replicas:
            raise ValueError("Router needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        config.validate()
        self.config = config
        self.replicas: List[Replica] = list(replicas)
        # the tier-wide gate; None keeps the router standalone
        self.admission = admission
        self._lock = threading.Lock()
        # per replica: chunk key -> None, newest last, at most hot_chunks;
        # fed by routing decisions, not by asking the replicas
        self._hot: Dict[str, "OrderedDict"] = {r.name: OrderedDict() for r in self.replicas}
        # session -> (replica name, last-routed stamp)
        self._sessions: "OrderedDict[str, Tuple[str, float]]" = OrderedDict()

    # -- scoring -----------------------------------------------------------
    def _healthy(self, roles: Tuple[str, ...]) -> List[Replica]:
        return [r for r in self.replicas if r.role in roles and r.healthy()]

    def _affinity_locked(self, name: str, chunk_keys: Sequence) -> float:
        if not chunk_keys:
            return 0.0
        hot = self._hot[name]
        return sum(1 for k in chunk_keys if k in hot) / len(chunk_keys)

    def _note_locked(self, name: str, chunk_keys: Sequence) -> None:
        hot = self._hot[name]
        for k in chunk_keys:
            if k in hot:
                hot.move_to_end(k)
            else:
                hot[k] = None
        while len(hot) > self.config.hot_chunks:
            hot.popitem(last=False)

    def select(self, role: str = "prefill", chunk_keys: Sequence = (),
               session: Optional[str] = None) -> Tuple[Replica, float, float]:
        """The replica to run ``role`` work for a request touching
        ``chunk_keys``: ``(replica, score, affinity)``. The decision is
        recorded (hot-chunk LRU, session map), so the next request with the
        same composition scores the winner higher. A live session inside
        its TTL takes its replica without scoring. Raises
        :class:`NoReplicaAvailable` when no candidate is healthy (unified
        replicas fill in for an empty prefill tier; an empty decode tier
        tells the caller not to disaggregate)."""
        if role == "prefill":
            cands = self._healthy(("prefill", "unified"))
        elif role == "decode":
            cands = self._healthy(("decode",))
        else:
            cands = self._healthy(("unified",))
        if not cands:
            raise NoReplicaAvailable(role)
        now = time.monotonic()
        cfg = self.config
        with self._lock:
            if session is not None:
                entry = self._sessions.get(session)
                if entry is not None:
                    name, stamp = entry
                    if now - stamp <= cfg.session_ttl_s:
                        for r in cands:
                            if r.name == name:
                                aff = self._affinity_locked(name, chunk_keys)
                                self._note_locked(name, chunk_keys)
                                self._sessions[session] = (name, now)
                                return r, cfg.affinity_weight * 1.0, aff
                    self._sessions.pop(session, None)
            best, best_score, best_aff = None, float("-inf"), 0.0
            for r in cands:
                aff = self._affinity_locked(r.name, chunk_keys)
                score = cfg.affinity_weight * aff + cfg.load_weight * r.load()
                if score > best_score:
                    best, best_score, best_aff = r, score, aff
            self._note_locked(best.name, chunk_keys)
            if session is not None:
                self._sessions[session] = (best.name, now)
                while len(self._sessions) > _MAX_SESSIONS:
                    self._sessions.popitem(last=False)
        return best, best_score, best_aff

    # -- serving -----------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: Optional[int] = None, seed: Optional[int] = None,
               timeout: Optional[float] = None, deadline=None, info: Optional[Dict] = None,
               tenant: Optional[str] = None, chunk_keys: Sequence = (), session: Optional[str] = None,
               sampling=None) -> List[int]:
        """Route one request through the tier and block until its stream
        completes. Disaggregated: the chosen prefill-role replica admits it
        and returns a packet, the chosen decode-role replica imports it and
        finishes the stream, the one a unified engine gives. With no healthy
        decode tier it runs on a unified replica. ``chunk_keys`` are the
        request's retrieved-chunk keys (the affinity unit), ``session`` pins
        a conversation, ``sampling`` overrides the engines' sampling for
        this request (the port's scheduler takes it per request). The
        tier's gate, when set, sheds before any replica is touched."""
        args = (prompt, max_new_tokens, seed, timeout, deadline, info, tenant, chunk_keys, session, sampling)
        if self.admission is not None:
            with self.admission.admit(deadline=deadline, tenant=tenant):
                return self._submit_routed(*args)
        return self._submit_routed(*args)

    def _submit_routed(self, prompt, max_new_tokens, seed, timeout, deadline, info, tenant, chunk_keys, session,
                       sampling):
        # the decode tier first: a prefill-role engine with none behind it
        # would export packets nobody lands, so the request goes unified
        try:
            dec, _, _ = self.select("decode")
        except NoReplicaAvailable:
            dec = None
        pre, score, aff = self.select("prefill" if dec is not None else "unified", chunk_keys, session)
        pinfo = info if info is not None else {}
        toks = pre.scheduler.submit(prompt, max_new_tokens=max_new_tokens, seed=seed, sampling=sampling,
                                    timeout=timeout, deadline=deadline, info=pinfo, tenant=tenant)
        packet = pinfo.pop("migrate_packet", None)
        flight.emit(
            "route_decision", pinfo.get("request_id"),
            prefill=pre.name, decode=dec.name if (dec is not None and packet is not None) else "",
            mode="disagg" if packet is not None else "unified",
            affinity=round(aff, 4), affinity_hit=bool(aff > 0.0),
            candidates=len(self.replicas), score=round(score, 4),
        )
        if packet is None:
            # a unified replica, a request finished at its first token, or
            # an export that fell back to local decode: the stream is whole
            return toks
        return dec.scheduler.submit_migrated(packet, timeout=timeout, deadline=deadline, info=pinfo, tenant=tenant)

    # -- introspection -----------------------------------------------------
    def stats(self) -> Dict:
        """Per-replica role, health, load and hot-chunk count, and the
        session count (gauge-grade)."""
        with self._lock:
            hot = {n: len(d) for n, d in self._hot.items()}
            sessions = len(self._sessions)
        return {
            "replicas": [
                {"name": r.name, "role": r.role, "healthy": r.healthy(), "load": round(r.load(), 4),
                 "hot_chunks": hot.get(r.name, 0)}
                for r in self.replicas
            ],
            "sessions": sessions,
        }
