"""Per-request end-to-end deadlines.

The port's copy of ``rag_llm_k8s_tpu/resilience/deadline.py`` (standard library
only, like the original).

The seed had exactly one timeout in the whole serving path — a hardcoded
``th.join(timeout=120)`` on the ids-fetch thread — so a request could queue,
retrieve, and decode indefinitely while its client had long since hung up.
A :class:`Deadline` is carried from the HTTP edge (body ``deadline_ms`` /
``x-request-deadline-ms`` header, default from ``ResilienceConfig``) through
every stage boundary; each boundary calls :meth:`Deadline.check` and an
expired request fails with :class:`DeadlineExceeded` naming the stage it
died in (the ``rag_deadline_exceeded_total{stage}`` family counts them).

The continuous scheduler additionally EVICTS the expired request's decode
slot (see ``ContinuousScheduler``) — without that, a timed-out request keeps
decoding into a slot nobody will ever read, which under sustained overload
converges to a batch full of zombies.

``clock`` is injectable so tests expire deadlines without sleeping.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from rag_llm_k8s_tpu_torch.obs import flight

__all__ = ["Deadline", "DeadlineExceeded"]

# stage labels used across the serving path:
#   queue    — expired waiting for admission or in a scheduler queue
#   retrieve — expired during/after embed+kNN
#   assemble — expired during prompt assembly
#   generate — the blocking submit timed out (coalesce mode: the whole
#              prefill+decode is one device call, not separable)
#   decode   — evicted mid-decode by the continuous scheduler
STAGES = ("queue", "retrieve", "assemble", "generate", "decode")


class DeadlineExceeded(TimeoutError):
    """The request's end-to-end deadline expired at ``stage``."""

    def __init__(self, stage: str, budget_ms: Optional[float] = None):
        msg = f"request deadline exceeded at stage {stage!r}"
        if budget_ms is not None:
            msg += f" (budget {budget_ms:.0f} ms)"
        super().__init__(msg)
        self.stage = stage
        self.budget_ms = budget_ms
        # constructing this exception IS the decision point — every raise
        # site (HTTP edge, stage boundaries, scheduler eviction sweep)
        # journals through this one line
        flight.emit("deadline", stage=stage)


class Deadline:
    """An absolute point in time a request must not outlive."""

    __slots__ = ("t_deadline", "budget_ms", "clock")

    def __init__(self, budget_ms: float, clock: Callable[[], float] = time.monotonic):
        if budget_ms <= 0:
            raise ValueError(f"budget_ms={budget_ms}: expected > 0")
        self.clock = clock
        self.budget_ms = float(budget_ms)
        self.t_deadline = clock() + budget_ms / 1e3

    def remaining(self) -> float:
        """Seconds left (negative when expired)."""
        return self.t_deadline - self.clock()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, stage: str) -> None:
        """Raise :class:`DeadlineExceeded` if the budget is spent."""
        if self.expired():
            raise DeadlineExceeded(stage, self.budget_ms)

    def wait_timeout(self, floor_s: float = 1e-3) -> float:
        """The remaining budget as a blocking-wait timeout (floored at a
        tiny positive value so an already-expired deadline still makes one
        fast-failing wait instead of an invalid negative timeout)."""
        return max(self.remaining(), floor_s)
