"""Resilience layer, the port's copy of ``rag_llm_k8s_tpu/resilience/``: the
serving path's behaviour under stress.

- :mod:`admission` — a bounded admission gate in front of both engine
  modes: over-cap requests get an immediate 429/503 with ``Retry-After``
  instead of an unbounded queue wait;
- :mod:`deadline` — end-to-end per-request deadlines checked at every stage
  boundary, with mid-decode eviction in the continuous scheduler;
- :mod:`breaker` — a sliding-window circuit breaker over engine resets that
  turns ``/healthz`` readiness off;
- :mod:`lifecycle` — the graceful drain on SIGTERM or ``POST /drain``;
- :mod:`faults` — deterministic fault injection at named sites, armed by
  ``TPU_RAG_FAULTS`` or ``POST /debug/faults``.

Standard library only: the fault sites sit in modules (store, encoder)
that must import without a card.
"""

from rag_llm_k8s_tpu_torch.resilience.admission import AdmissionController, AdmissionRejected
from rag_llm_k8s_tpu_torch.resilience.breaker import CircuitBreaker
from rag_llm_k8s_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded

__all__ = [
    "AdmissionController",
    "AdmissionRejected",
    "CircuitBreaker",
    "Deadline",
    "DeadlineExceeded",
]
