"""Bounded admission control + load shedding for the serving path.

The port's copy of ``rag_llm_k8s_tpu/resilience/admission.py`` (standard library
only, like the original).

The seed admitted every request unconditionally: concurrent ``/generate``
calls piled threads onto an unbounded ``queue.Queue`` behind the scheduler,
so a burst beyond the device's throughput grew the queue (and every queued
request's latency) without bound — the classic metastable overload shape.
The gate in front of the pipeline makes overload a *fast, explicit* signal
instead:

- up to ``max_concurrency`` requests run concurrently;
- up to ``max_queue`` more wait (bounded, deadline-aware);
- everything beyond that is REJECTED immediately with a machine-readable
  reason and a ``Retry-After`` hint — a 429 the client's retry loop can
  honor costs microseconds; a queued request that times out after 120 s
  costs a thread, a socket, and a user.

The gate also fronts the circuit breaker: while the breaker is open the pod
is draining, so new work is shed with 503 + ``Retry-After`` equal to the
breaker's estimated close time.

``rag_admission_rejected_total{reason, tenant}`` counts every shed
request; the live ``waiting`` count folds into
``rag_admission_queue_depth``.

Tenant-aware fair share: when the queue is FULL, an arriving
tenant under its fair share of the gate (capacity / tenants present) may
displace the newest queued waiter of a tenant OVER its share — that
waiter sheds with reason="fair_share" and the newcomer takes its place.
One tenant's burst can no longer monopolize the whole queue; tenants
below their share still get queued even at saturation. Tenant values
arrive pre-interned through the edge's TenantTracker (tracked or
``__other__``), so every per-tenant structure here is cardinality-bounded
by construction. Requests with no tenant never displace and are never
displaced — tenancy off keeps the exact pre-fair-share behavior.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional

from rag_llm_k8s_tpu_torch.obs import flight
from rag_llm_k8s_tpu_torch.resilience.breaker import CircuitBreaker
from rag_llm_k8s_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded

__all__ = ["AdmissionController", "AdmissionRejected"]


class AdmissionRejected(RuntimeError):
    """Load shed at the gate. ``status`` is the HTTP code the edge maps it
    to (429 = over capacity, retry; 503 = draining/breaker, go elsewhere)."""

    def __init__(self, reason: str, status: int, retry_after_s: float):
        super().__init__(f"admission rejected: {reason}")
        self.reason = reason
        self.status = status
        self.retry_after_s = retry_after_s


class AdmissionController:
    def __init__(
        self,
        max_concurrency: int = 16,
        max_queue: int = 64,
        retry_after_s: float = 1.0,
        breaker: Optional[CircuitBreaker] = None,
    ):
        if max_concurrency < 1:
            raise ValueError(f"max_concurrency={max_concurrency}: expected >= 1")
        if max_queue < 0:
            raise ValueError(f"max_queue={max_queue}: expected >= 0")
        self.max_concurrency = max_concurrency
        self.max_queue = max_queue
        self.retry_after_s = retry_after_s
        self.breaker = breaker
        self._cv = threading.Condition()
        self.active = 0
        self.waiting = 0
        # lifecycle drain (resilience/lifecycle.py): once set, EVERY new
        # or queued request is shed with 503 reason="draining" while the
        # already-admitted ones run to completion — the gate is how a
        # rolling replica stops taking work without dropping work
        self._draining = False
        self._drain_retry_after_s = retry_after_s
        # fair-share state (all under _cv): in-gate count per tenant
        # (active + waiting) and one record per queued waiter, queue
        # order — the displacement victim search walks it newest-first.
        # Bounded: tenants arrive interned (top-K + "__other__"), waiters
        # by max_queue.
        self._tenant_gate: Dict[str, int] = {}
        self._waiters: List[dict] = []
        # set by the service (obs wiring): labeled-counter families for
        # rag_admission_rejected_total / rag_deadline_exceeded_total —
        # None keeps the gate standalone
        self.reject_counter = None
        self.deadline_counter = None
        # set by the service (tenant attribution): the labeled-counter
        # family for rag_tenant_sheds_total — per-tenant shed counts, the
        # data a fair-share gate (ROADMAP item 1) acts on. Label values
        # arrive pre-interned through the edge's TenantTracker, so the
        # family stays cardinality-bounded by construction.
        self.tenant_shed_counter = None
        # set by the service when the engine serves from a paged KV pool
        # (engine/kv_pool.py): a callable returning True while the pool has
        # ZERO free blocks. While saturated, a request that would have to
        # WAIT is shed immediately with 429 reason="pool_exhausted" —
        # queueing behind a pool that cannot grow only converts the
        # client's retry budget into server-side latency. Requests under
        # the concurrency cap still run: decode frees blocks every window,
        # and the scheduler's own backpressure orders them correctly.
        self.saturation_hint = None
        # hotness-aware refinement of the saturation shed (KV tiering): a
        # callable returning the RECLAIMABLE block count — registered
        # prefix blocks in a non-hot tier, which the scheduler's next
        # admission sweep returns to the pool without touching a live row.
        # While that is positive, a saturated pool is cache warmth, not
        # true pressure: the request QUEUES (bounded, deadline-aware)
        # instead of shedding. Tier occupancy, not raw headroom, decides.
        self.reclaimable_hint = None
        # set by the service (obs/flight.py): called with an incident
        # trigger name when a shed is post-mortem-worthy — today only
        # pool-exhaustion sheds, which mean HBM pressure, not tuning
        self.incident_hook = None

    # -- internals -------------------------------------------------------
    def _reject(self, reason: str, status: int, retry_after_s: float,
                tenant: Optional[str] = None):
        fam = self.reject_counter
        if fam is not None:
            # tenant label values are pre-interned at the edge (tracked
            # or "__other__"), so the series count stays bounded at
            # reasons x (top-K + 1) even under adversarial tenant ids
            fam.labels(reason=reason, tenant=tenant or "__other__").inc()
        if tenant is not None:
            tfam = self.tenant_shed_counter
            if tfam is not None:
                tfam.labels(tenant=tenant).inc()
        flight.emit("shed", reason=reason, status=status,
                    **({"tenant": tenant} if tenant else {}))
        if reason == "pool_exhausted" and self.incident_hook is not None:
            try:
                self.incident_hook("pool_exhausted_shed")
            except Exception:  # noqa: BLE001 — capture must not break the shed
                pass
        raise AdmissionRejected(reason, status, retry_after_s)

    def _acquire(self, deadline: Optional[Deadline],
                 tenant: Optional[str] = None) -> None:
        if self._draining:
            self._reject("draining", 503, self._drain_retry_after_s,
                         tenant=tenant)
        breaker = self.breaker
        if breaker is not None and breaker.open:
            # draining: shed EVERYTHING, even below the concurrency cap —
            # the whole point is to stop feeding a sick device
            self._reject(
                "breaker_open", 503,
                max(breaker.retry_after_s(), self.retry_after_s),
                tenant=tenant,
            )
        with self._cv:
            if tenant is not None:
                self._tenant_gate[tenant] = (
                    self._tenant_gate.get(tenant, 0) + 1
                )
            try:
                self._acquire_locked(deadline, tenant)
            except BaseException:
                # every rejection path gives the in-gate count back; a
                # SUCCESSFUL acquire keeps it until _release(tenant)
                self._gate_dec_locked(tenant)
                raise

    def _gate_dec_locked(self, tenant: Optional[str]) -> None:
        if tenant is None:
            return
        c = self._tenant_gate.get(tenant, 0) - 1
        if c <= 0:
            self._tenant_gate.pop(tenant, None)
        else:
            self._tenant_gate[tenant] = c

    def _fair_share_victim(self, tenant: Optional[str]) -> Optional[dict]:
        """With the queue full: may this arrival displace a queued waiter?
        Only when the arriving tenant sits UNDER its fair share of the
        whole gate (capacity / tenants present, the classic max-min
        bound) while some waiter's tenant sits OVER its own — then the
        most-over-share tenant's NEWEST waiter is the victim (newest
        first mirrors the engine's preemption discipline: the least
        sunk-cost work yields). Returns the victim's record, or None
        (the arrival sheds as plain queue_full). Caller holds _cv."""
        if tenant is None or not self._waiters:
            return None
        present = set(self._tenant_gate)
        present.add(tenant)
        share = (self.max_concurrency + self.max_queue) / len(present)
        if self._tenant_gate.get(tenant, 0) > share:
            # the arrival itself is over-share (its own count includes
            # this very request): no displacement — it sheds
            return None
        victim, victim_count = None, share
        for rec in reversed(self._waiters):
            t = rec["tenant"]
            if t is None or t == tenant or rec["shed"]:
                continue
            c = self._tenant_gate.get(t, 0)
            if c > victim_count:
                victim, victim_count = rec, c
        return victim

    def _acquire_locked(self, deadline: Optional[Deadline],
                        tenant: Optional[str]) -> None:
        if self.active < self.max_concurrency and self.waiting == 0:
            self.active += 1
            return
        if self.waiting >= self.max_queue:
            victim = self._fair_share_victim(tenant)
            if victim is None:
                self._reject("queue_full", 429, self.retry_after_s,
                             tenant=tenant)
            # displace: the victim wakes, sees its shed mark and rejects
            # itself with reason="fair_share"; this arrival queues in its
            # place (waiting transiently overshoots max_queue by one
            # until the victim unwinds — bounded, never cumulative)
            victim["shed"] = True
            self._cv.notify_all()
        hint = self.saturation_hint
        if hint is not None and hint():
            rec = self.reclaimable_hint
            if rec is None or not rec():
                self._reject("pool_exhausted", 429, self.retry_after_s,
                             tenant=tenant)
            # else: the pool is full of demotable cache warmth — the
            # scheduler reclaims it on its next sweep, so this request
            # waits its bounded turn instead of bouncing a 429
        wrec = {"tenant": tenant, "shed": False}
        self._waiters.append(wrec)
        self.waiting += 1
        try:
            while self.active >= self.max_concurrency:
                if wrec["shed"]:
                    # displaced by an under-share tenant's arrival (the
                    # fair-share branch above): this waiter sheds so the
                    # queue slot changes hands
                    self._reject("fair_share", 429, self.retry_after_s,
                                 tenant=tenant)
                if self._draining:
                    # a drain beginning while we queued: shed NOW —
                    # queued work is exactly what a drain refuses to
                    # start (_reject's raise unwinds through finally)
                    self._reject("draining", 503,
                                 self._drain_retry_after_s, tenant=tenant)
                if deadline is not None:
                    if deadline.expired():
                        fam = self.deadline_counter
                        if fam is not None:
                            fam.labels(stage="queue").inc()
                        raise DeadlineExceeded("queue", deadline.budget_ms)
                    self._cv.wait(timeout=deadline.wait_timeout())
                else:
                    self._cv.wait()
            self.active += 1
        finally:
            self.waiting -= 1
            self._waiters.remove(wrec)

    def _release(self, tenant: Optional[str] = None) -> None:
        with self._cv:
            self._gate_dec_locked(tenant)
            self.active -= 1
            self._cv.notify()

    # -- public ----------------------------------------------------------
    @contextmanager
    def admit(self, deadline: Optional[Deadline] = None,
              tenant: Optional[str] = None):
        """Hold one admission slot for the duration of the request.

        Raises :class:`AdmissionRejected` (shed) or
        :class:`DeadlineExceeded` (stage ``queue``) instead of waiting
        unboundedly. ``tenant`` (edge-interned) attributes any shed to the
        tenant that suffered it — per-tenant shed counts are the signal a
        fair-share admission policy will act on.
        """
        self._acquire(deadline, tenant=tenant)
        try:
            yield
        finally:
            self._release(tenant)

    def queue_depth(self) -> int:
        """Requests currently waiting at the gate (for the depth gauge)."""
        return self.waiting

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self, retry_after_s: Optional[float] = None) -> None:
        """Flip the gate to draining: every queued waiter wakes and sheds
        503 reason="draining"; every later arrival sheds at the door.
        Idempotent; there is deliberately NO undrain — a draining process
        exits (tests rebuild the gate instead)."""
        with self._cv:
            if retry_after_s is not None:
                self._drain_retry_after_s = float(retry_after_s)
            self._draining = True
            self._cv.notify_all()
