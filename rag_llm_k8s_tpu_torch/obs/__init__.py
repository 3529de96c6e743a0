"""Observability, the port's part of the JAX package's ``obs/``:

- ``obs.metrics`` — Counter/Gauge/Histogram in a ``MetricsRegistry``,
  rendered as Prometheus text exposition and as a flat JSON snapshot; the
  tenant interner;
- ``obs.tracing`` — contextvar-propagated per-request span trees in a ring
  buffer (``/debug/traces``), each span a ``torch.profiler`` range;
- ``obs.logging`` — W3C ``traceparent`` parsing and trace-correlated JSON
  logs;
- ``obs.flight`` — the flight recorder's event catalog and ring, the
  durable WAL and the incident spool;
- ``obs.goodput`` — the goodput ledger: per-window chip-time attribution
  and the roofline at the H100's peaks;
- ``obs.slo`` — SLO specs and multi-window burn rates over the registry;
- ``obs.tenants`` — the per-tenant report over a journal;
- ``obs.devices`` — per-device allocator and prefix-cache gauges;
- ``obs.regression`` — the direction-aware bench comparator;
- ``obs.shadow`` — the shadow quality auditor: sampled exact-path audits
  of delivered streams (``GET /debug/quality``, ``rag_quality_*``).
"""

from rag_llm_k8s_tpu_torch.obs.metrics import MetricsRegistry, default_registry  # noqa: F401
from rag_llm_k8s_tpu_torch.obs.tracing import TraceBuffer, span, start_trace  # noqa: F401
