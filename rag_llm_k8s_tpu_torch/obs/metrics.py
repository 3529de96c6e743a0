"""Metrics, the port's part of ``rag_llm_k8s_tpu/obs/metrics.py``: for now
only :class:`TenantTracker`, which the HTTP edge interns every tenant id
through before the admission gate's fair-share rule counts it. The registry
and its families are ``ROADMAP.md`` Queue 1 item 9b.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

__all__ = ["TenantTracker"]


class TenantTracker:
    """Cardinality-bounded tenant interner: top-K + ``__other__``.

    ``intern(tenant)`` counts the tenant in a bounded *space-saving*
    frequency table (``capacity`` entries; a newcomer evicts the global
    minimum and inherits its count as an overestimate bound) and returns the
    tenant's own name only while it is in the current top-K by request
    count; everything else maps to :data:`TenantTracker.OTHER`, so no
    per-tenant structure holds more than K + 1 entries. (The JAX tracker
    also prunes the metric families bound to it, which arrive with the
    registry, ``ROADMAP.md`` Queue 1 item 9b.)

    Thread-safe: the table and the tracked set live under one lock.
    """

    OTHER = "__other__"

    def __init__(self, top_k: int = 8, capacity: Optional[int] = None):
        if top_k < 1:
            raise ValueError("TenantTracker needs top_k >= 1")
        self.top_k = int(top_k)
        self.capacity = int(capacity) if capacity else max(8 * self.top_k, 128)
        if self.capacity < self.top_k:
            raise ValueError("TenantTracker capacity must cover top_k")
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._tracked: set = set()

    def intern(self, tenant: str) -> str:
        """Count one request for ``tenant``; return its own name iff it is
        tracked, else ``__other__`` (a client claiming ``__other__`` lands in
        the overflow bucket and can never impersonate a tracked tenant)."""
        name = str(tenant)
        with self._lock:
            if name == self.OTHER:
                return self.OTHER
            c = self._counts.get(name)
            if c is not None:
                self._counts[name] = c + 1
            elif len(self._counts) < self.capacity:
                self._counts[name] = 1
            else:
                victim, floor = min(self._counts.items(), key=lambda kv: (kv[1], kv[0]))
                del self._counts[victim]
                self._counts[name] = floor + 1
                self._tracked.discard(victim)
            if name not in self._tracked:
                if len(self._tracked) < self.top_k:
                    self._tracked.add(name)
                else:
                    low, low_c = min(
                        ((t, self._counts.get(t, 0)) for t in self._tracked),
                        key=lambda kv: (kv[1], kv[0]),
                    )
                    # strictly greater: ties keep the incumbent, so two
                    # equal-rate tenants do not flap
                    if self._counts[name] > low_c:
                        self._tracked.discard(low)
                        self._tracked.add(name)
            return name if name in self._tracked else self.OTHER

    def tracked(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._tracked))
