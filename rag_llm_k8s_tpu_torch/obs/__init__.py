"""Observability, the port's part of the JAX package's ``obs/``:

- ``obs.metrics`` — Counter/Gauge/Histogram in a ``MetricsRegistry``,
  rendered as Prometheus text exposition and as a flat JSON snapshot; the
  tenant interner;
- ``obs.tracing`` — contextvar-propagated per-request span trees in a ring
  buffer (``/debug/traces``), each span a ``torch.profiler`` range;
- ``obs.logging`` — W3C ``traceparent`` parsing and trace-correlated JSON
  logs;
- ``obs.flight`` — the flight recorder's event catalog and ring.

The SLO engine, goodput ledger, shadow auditor, tenant reports and incident
bundles are ``ROADMAP.md`` Queue 1 item 9c.
"""

from rag_llm_k8s_tpu_torch.obs.metrics import MetricsRegistry, default_registry  # noqa: F401
from rag_llm_k8s_tpu_torch.obs.tracing import TraceBuffer, span, start_trace  # noqa: F401
