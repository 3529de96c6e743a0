"""Circuit breaker over engine resets.

The port's copy of ``rag_llm_k8s_tpu/resilience/breaker.py`` (standard library
only, like the original).

One ``EngineStateLost`` is transient — the scheduler resubmits the in-flight
prompts and the client never notices. A *storm* of resets (a genuinely sick
device, an OOM loop, a broken executable after a software update) is
different: every reset re-runs full prefills for every in-flight request,
so a pod in a reset loop burns accelerator time making zero progress while
``/healthz`` keeps reporting ready and Kubernetes keeps routing traffic in.

The breaker is a sliding-window event counter: ``record_reset()`` per
engine reset; :attr:`open` when ``threshold`` resets land inside
``window_s``. The server's readiness probe returns 503 while open, so
Kubernetes drains the pod (liveness stays green — a restart would just
replay warmup into the same sick device). The breaker self-heals: once
enough resets age out of the window it closes again, with no half-open
bookkeeping to get wrong — admission control already rate-limits the
traffic that could re-trip it.

``clock`` is injectable for tests.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List

from rag_llm_k8s_tpu_torch.obs import flight

__all__ = ["CircuitBreaker"]


class CircuitBreaker:
    def __init__(
        self,
        threshold: int = 3,
        window_s: float = 300.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if threshold < 1:
            raise ValueError(f"threshold={threshold}: expected >= 1")
        if window_s <= 0:
            raise ValueError(f"window_s={window_s}: expected > 0")
        self.threshold = threshold
        self.window_s = window_s
        self.clock = clock
        self._lock = threading.Lock()
        self._events: List[float] = []  # reset timestamps inside the window
        # observability hooks (set by the service; both optional):
        # on_reset() fires after EVERY recorded reset, on_open() on the
        # closed→open transition only — the incident spooler's reset-storm
        # and breaker-flip bundle triggers (obs/flight.py). Invoked OUTSIDE
        # the breaker's lock: a hook that writes a bundle to disk must not
        # serialize readiness probes.
        self.on_reset = None
        self.on_open = None

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._events and self._events[0] <= cutoff:
            self._events.pop(0)

    def record_reset(self) -> None:
        now = self.clock()
        with self._lock:
            self._prune(now)
            was_open = len(self._events) >= self.threshold
            self._events.append(now)
            flipped = not was_open and len(self._events) >= self.threshold
            n = len(self._events)
        if flipped:
            flight.emit("breaker_open", resets=n)
        hooks = ([self.on_open] if flipped else []) + [self.on_reset]
        for hook in hooks:
            if hook is None:
                continue
            try:
                hook()
            except Exception:  # noqa: BLE001 — a hook must not break recording
                pass

    @property
    def open(self) -> bool:
        with self._lock:
            self._prune(self.clock())
            return len(self._events) >= self.threshold

    def recent_resets(self) -> int:
        with self._lock:
            self._prune(self.clock())
            return len(self._events)

    def retry_after_s(self) -> float:
        """Seconds until the breaker could close (the tripping reset ages
        out) — the ``Retry-After`` a shed client is told. 0 when closed."""
        with self._lock:
            now = self.clock()
            self._prune(now)
            if len(self._events) < self.threshold:
                return 0.0
            # closes when the event holding the count at threshold expires
            t_close = self._events[len(self._events) - self.threshold] + self.window_s
            return max(0.0, t_close - now)
