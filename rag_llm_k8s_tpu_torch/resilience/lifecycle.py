"""Graceful-shutdown lifecycle: the drain coordinator.

The port's copy of ``rag_llm_k8s_tpu/resilience/lifecycle.py`` (standard library
only, like the original).

Everything in resilience/ so far survives failures *inside* the process —
resets, deadlines, pool exhaustion. Process death was still a cliff: a
SIGTERM (every k8s roll, reschedule, and node drain sends one) killed
in-flight decodes mid-stream and turned each into a client-visible error.
This module is the state machine that turns SIGTERM into a *protocol*:

    serving ──begin_drain()──▶ draining ──in-flight == 0──▶ drained
                                  │                            │
                                  └──deadline overrun──────────┤
                                     (shed + drain_timeout     │
                                      incident)                ▼
                                                       persist + exit

- **serving → draining** — triggered by SIGTERM (server/main.py) or
  ``POST /drain`` (the deployment's preStop hook). The admission gate
  flips to shed every *queued* and *new* request with 503
  ``reason="draining"`` + Retry-After (resilience/admission.py), and
  ``/healthz`` readiness goes 503 ``status="draining"`` so the k8s
  endpoint controller stops routing here — the same flip mechanics the
  breaker uses, for a planned reason instead of a sick one.
- **draining → drained** — a watcher polls the in-flight count. Work
  already past the gate runs to completion; nothing new starts. When the
  count hits zero (or the drain deadline overruns — then the stragglers
  are abandoned where they stand and a ``drain_timeout`` incident bundle
  captures who), the coordinator runs its persist step (WAL sync + the
  prefix cache's warmth manifest — the state a warm restart resumes from)
  and calls ``exit_fn``.

The coordinator never undrains: a draining process exits. Every
collaborator is injected (``active_fn``, ``persist_fn``, ``exit_fn``,
``incident_hook``, ``clock``/``sleep``) so the whole machine is provable
in-process without signals, sleeps, or a real exit.

The service passes ``persist_fn=RagService._persist_for_restart``: it
fsyncs the flight WAL's tail and writes the prefix cache's warmth manifest
beside it (``server/app.py``), what ``restore_from_wal`` reads on the next
boot.

Knobs: ``TPU_RAG_DRAIN_DEADLINE_S`` / ``TPU_RAG_DRAIN_RETRY_AFTER_S``
(core/config.py::ResilienceConfig) — the deadline must fit inside the
pod's ``terminationGracePeriodSeconds`` with margin for the persist step.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from rag_llm_k8s_tpu_torch.obs import flight
from rag_llm_k8s_tpu_torch.resilience.admission import AdmissionController

__all__ = ["LifecycleCoordinator", "SERVING", "DRAINING", "DRAINED"]

logger = logging.getLogger(__name__)

SERVING = "serving"
DRAINING = "draining"
DRAINED = "drained"


class LifecycleCoordinator:
    """Coordinates one irreversible serving → draining → drained pass.

    Thread-safe; ``begin_drain`` is idempotent (the first trigger wins —
    a SIGTERM racing the preStop hook's ``POST /drain`` must not run two
    drains). The watcher runs on a daemon thread so a wedged in-flight
    request can never block process teardown past the deadline.
    """

    def __init__(
        self,
        admission: Optional[AdmissionController] = None,
        deadline_s: float = 25.0,
        retry_after_s: float = 2.0,
        poll_interval_s: float = 0.05,
        active_fn: Optional[Callable[[], int]] = None,
        persist_fn: Optional[Callable[[], None]] = None,
        exit_fn: Optional[Callable[[], None]] = None,
        incident_hook: Optional[Callable[[str], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s={deadline_s}: expected > 0")
        self.admission = admission
        self.deadline_s = float(deadline_s)
        self.retry_after_s = float(retry_after_s)
        self.poll_interval_s = float(poll_interval_s)
        # in-flight source: defaults to the gate's active count — work
        # past the gate is exactly the work a drain waits for
        self._active_fn = active_fn or (
            (lambda: admission.active) if admission is not None else (lambda: 0)
        )
        self.persist_fn = persist_fn
        self.exit_fn = exit_fn
        self.incident_hook = incident_hook
        self.clock = clock
        self.sleep = sleep
        self._lock = threading.Lock()
        self._state = SERVING
        self._reason: Optional[str] = None
        self._watcher: Optional[threading.Thread] = None
        self._drained = threading.Event()
        self.timed_out = False
        self.stragglers = 0  # in-flight abandoned at the deadline

    # -- read ------------------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    @property
    def draining(self) -> bool:
        """True from the first begin_drain on — the readiness probe's
        signal (``/healthz`` reports 503 ``status="draining"``)."""
        return self._state != SERVING

    @property
    def reason(self) -> Optional[str]:
        return self._reason

    # -- write -----------------------------------------------------------
    def begin_drain(self, reason: str = "sigterm") -> bool:
        """Start the one drain pass. Returns True when THIS call started
        it, False when a drain was already running (idempotent)."""
        with self._lock:
            if self._state != SERVING:
                return False
            self._state = DRAINING
            self._reason = reason
        in_flight = self._safe_active()
        flight.emit("drain", phase="begin", reason=reason,
                    in_flight=in_flight)
        logger.info("drain began (reason=%s, in_flight=%d, deadline=%.1fs)",
                    reason, in_flight, self.deadline_s)
        if self.admission is not None:
            self.admission.drain(self.retry_after_s)
        watcher = threading.Thread(
            target=self._watch, name="lifecycle-drain", daemon=True
        )
        with self._lock:
            self._watcher = watcher
        watcher.start()
        return True

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Block until the pass (including persist) finished — the preStop
        hook and tests wait on this, never on a sleep."""
        return self._drained.wait(timeout)

    # -- internals -------------------------------------------------------
    def _safe_active(self) -> int:
        try:
            return int(self._active_fn())
        except Exception:  # noqa: BLE001 — a broken probe must not stall exit
            logger.exception("drain active_fn failed; treating as 0")
            return 0

    def _watch(self) -> None:
        deadline = self.clock() + self.deadline_s
        while self._safe_active() > 0 and self.clock() < deadline:
            self.sleep(self.poll_interval_s)
        stragglers = self._safe_active()
        if stragglers > 0:
            # deadline overrun: the pod is being killed anyway — journal
            # WHO was abandoned (the WAL's restore pass picks them up) and
            # spool the post-mortem before the persist step
            self.timed_out = True
            self.stragglers = stragglers
            flight.emit("drain", phase="timeout", in_flight=stragglers,
                        deadline_s=self.deadline_s)
            logger.warning("drain deadline (%.1fs) overran with %d in flight",
                           self.deadline_s, stragglers)
            hook = self.incident_hook
            if hook is not None:
                try:
                    hook("drain_timeout")
                except Exception:  # noqa: BLE001 — capture must not stall exit
                    logger.exception("drain_timeout incident capture failed")
        if self.persist_fn is not None:
            try:
                self.persist_fn()
            except Exception:  # noqa: BLE001 — persist is best-effort
                logger.exception("drain persist step failed")
        flight.emit("drain", phase="complete",
                    in_flight=stragglers, timed_out=self.timed_out)
        with self._lock:
            self._state = DRAINED
        self._drained.set()
        if self.exit_fn is not None:
            self.exit_fn()
