"""Metrics: the port's copy of ``rag_llm_k8s_tpu/obs/metrics.py``.

The one registry everything on the serving path reports into:

- **Counter / Gauge / Histogram**, each optionally *labeled*
  (``family.labels(stage="prefill")`` returns a per-label child), with
  fixed log-spaced histogram buckets, so p50/p95 can be read off any scrape;
- **lock-cheap hot path**: one uncontended per-child lock per observation,
  the registry lock only to register;
- **callback metrics**: a Counter/Gauge built with ``fn=`` reads its value at
  collect time (engine stats, pool occupancy, index size); a probe that
  raises reads 0.0, so a broken probe never fails a scrape;
- **two renderings** of one state: Prometheus text exposition 0.0.4
  (``render_prometheus``) and a flat JSON snapshot (``snapshot``).

Names beginning with ``rag_`` render verbatim; any other name (the legacy
counter names like ``query_decode_tokens``) renders with the ``tpu_rag_``
prefix, so the scrape surface is the JAX service's. Rendering is the JAX
module's byte for byte.

:class:`TenantTracker` interns every tenant id at the HTTP edge before any
per-tenant structure sees it, and bounds the ``rag_tenant_*`` families bound
to it at top-K + ``__other__`` children.
"""

from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TenantTracker",
    "default_registry",
    "log_buckets",
    "LATENCY_BUCKETS",
    "REQUEST_BUCKETS",
    "TOKEN_LATENCY_BUCKETS",
]


def log_buckets(lo: float, hi: float, factor: float) -> Tuple[float, ...]:
    """Log-spaced histogram upper bounds from ``lo`` until ``hi`` is covered.

    Bounds are rounded to 4 significant figures so the exposition stays
    readable; ``factor`` > 1 keeps them strictly increasing after rounding.
    """
    if lo <= 0 or factor <= 1:
        raise ValueError("log_buckets needs lo > 0 and factor > 1")
    out: List[float] = []
    b = lo
    while True:
        out.append(float(f"{b:.4g}"))
        if b >= hi:
            break
        b *= factor
    return tuple(out)


# coarse general-purpose latency ladder: 0.5 ms .. ~65 s, x2 per bucket
LATENCY_BUCKETS = log_buckets(0.0005, 64.0, 2.0)
# fine end-to-end request ladder (the p50/p95 dashboards
# read off the histogram): ~12% relative resolution, 5 ms .. ~90 s
REQUEST_BUCKETS = log_buckets(0.005, 90.0, 1.12)
# per-token ladder (TTFT / inter-token): 0.2 ms .. ~2.2 s
TOKEN_LATENCY_BUCKETS = log_buckets(0.0002, 2.0, 1.5)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _escape_label(v: str) -> str:
    """Exposition label-value escaping: backslash, quote, and newline each
    become a two-character escape (a regex prefixing '\\' would leave the
    literal newline in place and split the sample across lines)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """``# HELP`` escaping per the text-format spec: ONLY backslash and
    newline (quotes stay literal in help text — escaping them like label
    values would render ``\\"`` into every docstring that quotes a knob).
    A literal newline would otherwise split the comment and leave a line
    the scraper rejects as an invalid sample."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _canonical(name: str) -> str:
    """Exposition name: ``rag_*`` verbatim, everything else ``tpu_rag_*``
    (the JAX service's legacy prefix — the scrape surface is its own)."""
    safe = _NAME_RE.sub("_", name)
    return safe if safe.startswith("rag_") else f"tpu_rag_{safe}"


def _fmt_labels(labels: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


class _Child:
    """One (metric, label-set) time series. Base for the typed children."""

    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = threading.Lock()


class Counter(_Child):
    """Monotonic counter. ``fn`` makes it a *callback* counter whose value
    is read at collect time (``inc`` is then a programming error)."""

    __slots__ = ("_value", "_fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        super().__init__()
        self._value = 0.0
        self._fn = fn

    def inc(self, value: float = 1.0) -> None:
        if self._fn is not None:
            raise RuntimeError("callback counter cannot be inc()'d")
        if value < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += value

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — a broken probe must not 500 /metrics
                return 0.0
        with self._lock:
            return self._value


class Gauge(_Child):
    """Level-valued sample; ``fn`` reads the live value at collect time."""

    __slots__ = ("_value", "_fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        super().__init__()
        self._value = 0.0
        self._fn = fn

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, value: float = 1.0) -> None:
        with self._lock:
            self._value += value

    def dec(self, value: float = 1.0) -> None:
        with self._lock:
            self._value -= value

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — a broken probe must not 500 /metrics
                return 0.0
        with self._lock:
            return self._value


class Histogram(_Child):
    """Fixed-bucket histogram (log-spaced by default).

    Per-bucket counts are stored non-cumulative and rendered cumulative
    (Prometheus ``le`` semantics, ``+Inf`` implicit last). ``quantile``
    interpolates linearly inside the landing bucket — with log-spaced
    buckets that bounds the relative error by the bucket ratio, which is
    why the request-duration ladder is fine-grained (REQUEST_BUCKETS).
    """

    __slots__ = ("bounds", "_counts", "_sum", "_count")

    def __init__(self, buckets: Sequence[float] = LATENCY_BUCKETS):
        super().__init__()
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError("histogram buckets must be strictly increasing")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # final slot = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        i = bisect_left(self.bounds, value)  # first bound >= value (le)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> Tuple[Tuple[int, ...], float, int]:
        """Consistent ``(per_bucket_counts, sum, count)`` — subtractable, so
        a caller can diff two snapshots and take quantiles of the window
        in between (a benchmark pass's own p50/p95)."""
        with self._lock:
            return tuple(self._counts), self._sum, self._count

    def quantile(
        self,
        q: float,
        snapshot: Optional[Tuple[Tuple[int, ...], float, int]] = None,
    ) -> Optional[float]:
        """Estimated ``q``-quantile (0..1) with linear interpolation inside
        the landing bucket; None when empty. ``snapshot`` lets callers take
        quantiles of a diffed window instead of the lifetime state."""
        counts, _, total = snapshot if snapshot is not None else self.snapshot()
        if total <= 0:
            return None
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = self.bounds[i] if i < len(self.bounds) else lo
                frac = (rank - cum) / c
                return lo + (hi - lo) * max(0.0, min(1.0, frac))
            cum += c
        return self.bounds[-1]

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One registered metric name: kind + help + label children.

    Unlabeled metrics hold exactly one child under the empty label tuple.
    """

    def __init__(self, name: str, kind: str, help: str, **child_kw):
        self.name = name
        self.kind = kind
        self.help = help
        self._child_kw = child_kw
        self._lock = threading.Lock()
        self._children: "Dict[Tuple[Tuple[str, str], ...], _Child]" = {}

    def labels(self, **labelvalues: str):
        key = tuple(sorted((k, str(v)) for k, v in labelvalues.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _KINDS[self.kind](**self._child_kw)
                self._children[key] = child
        return child

    def labels_callback(self, fn: Callable[[], float], **labelvalues: str):
        """A per-label-set CALLBACK child: unlike the family-wide ``fn=``
        (shared via child_kw), each label set reads its own probe at collect
        time — how per-device gauges and the SLO burn gauges fold live state
        into one labeled family. Idempotent: re-registering swaps the probe."""
        if self.kind == "histogram":
            raise ValueError("histograms cannot be callback-valued")
        child = self.labels(**labelvalues)
        child._fn = fn
        return child

    def items(self):
        with self._lock:
            return list(self._children.items())

    def prune_label(self, label: str, keep: Sequence[str]) -> int:
        """Drop every child whose ``label`` value is NOT in ``keep``.

        The cardinality-bound enforcement point: when :class:`TenantTracker`
        demotes a tenant out of the tracked set, its children leave the
        exposition so the family can never accumulate more series than the
        tracked set allows. Children without the label at all (the empty
        label set, or differently-labeled series) are untouched. Returns
        the number of children removed."""
        keep_set = {str(k) for k in keep}
        with self._lock:
            doomed = [
                key for key in self._children
                if any(n == label and v not in keep_set for n, v in key)
            ]
            for key in doomed:
                del self._children[key]
        return len(doomed)


class MetricsRegistry:
    """Get-or-create registry of metric families + the legacy facade.

    The legacy facade (``inc``/``observe``/``snapshot``) preserves the
    JAX service's ``inc``/``observe`` API so every legacy consumer
    (``query_single_fetch`` reads, the JSON ``/metrics`` view)
    keeps working; ``observe(name, v)`` maintains the old ``{name}_sum`` /
    ``{name}_count`` counter pair.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # -- registration (get-or-create, idempotent) -----------------------
    def _family(self, name: str, kind: str, help: str, **child_kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help, **child_kw)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, not {kind}"
                )
            return fam

    def counter(self, name: str, help: str = "",
                fn: Optional[Callable[[], float]] = None):
        return self._family(name, "counter", help, fn=fn).labels()

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None):
        return self._family(name, "gauge", help, fn=fn).labels()

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS):
        return self._family(name, "histogram", help, buckets=buckets).labels()

    def labeled_histogram(self, name: str, help: str = "",
                          buckets: Sequence[float] = LATENCY_BUCKETS) -> _Family:
        return self._family(name, "histogram", help, buckets=buckets)

    def labeled_counter(self, name: str, help: str = "") -> _Family:
        return self._family(name, "counter", help)

    def labeled_gauge(self, name: str, help: str = "") -> _Family:
        return self._family(name, "gauge", help)

    def get_family(self, name: str) -> Optional[_Family]:
        """The registered family (or None) — read-side consumers (the SLO
        engine windows over the request histograms) find their sources here
        without creating empty families as a side effect."""
        with self._lock:
            return self._families.get(name)

    # -- legacy facade (the inc/observe API) ----------------------------
    def observe(self, name: str, value: float) -> None:
        self.counter(f"{name}_sum").inc(value)
        self.counter(f"{name}_count").inc(1)

    def inc(self, name: str, value: float = 1) -> None:
        self.counter(name).inc(value)

    # -- renderings ------------------------------------------------------
    def _families_sorted(self) -> List[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def snapshot(self) -> Dict[str, float]:
        """Flat JSON view: counters/gauges by name, histograms as
        ``name_sum``/``name_count`` (labeled children are summed — the JSON
        view is the coarse one; the exposition carries the label detail)."""
        out: Dict[str, float] = {}
        for fam in self._families_sorted():
            items = fam.items()
            if not items:
                # a labeled family with no children yet has no samples in
                # the exposition either — the two views must carry the
                # same names (bounded tenant families sit empty until
                # their first tracked tenant)
                continue
            if fam.kind == "histogram":
                s = c = 0.0
                for _, child in items:
                    s += child.sum
                    c += child.count
                out[f"{fam.name}_sum"] = s
                out[f"{fam.name}_count"] = c
            else:
                total = 0.0
                for _, child in items:
                    total += child.value
                out[fam.name] = total
        return out

    def render_prometheus(self) -> str:
        """Text exposition format 0.0.4 — the thing a scraper consumes."""
        lines: List[str] = []
        for fam in self._families_sorted():
            name = _canonical(fam.name)
            if fam.help:
                lines.append(f"# HELP {name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for labels, child in sorted(fam.items()):
                if fam.kind == "histogram":
                    counts, hsum, count = child.snapshot()
                    cum = 0
                    for bound, c in zip(child.bounds, counts):
                        cum += c
                        le = _fmt_labels(labels, f'le="{_fmt_value(bound)}"')
                        lines.append(f"{name}_bucket{le} {cum}")
                    le = _fmt_labels(labels, 'le="+Inf"')
                    lines.append(f"{name}_bucket{le} {count}")
                    lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_value(hsum)}")
                    lines.append(f"{name}_count{_fmt_labels(labels)} {count}")
                else:
                    lines.append(
                        f"{name}{_fmt_labels(labels)} {_fmt_value(child.value)}"
                    )
        return "\n".join(lines) + "\n"


class TenantTracker:
    """Cardinality-bounded tenant label interner: top-K + ``__other__``.

    The registry's labeled families create a child per distinct label
    value — fed raw tenant ids they would grow without bound. This tracker
    is the one gate tenant ids pass through before they become label
    values:

    - ``intern(tenant)`` counts the tenant with a bounded *space-saving*
      frequency table (capacity entries; a newcomer evicts the global
      minimum and inherits its count as an overestimate bound) and returns
      the tenant's own name only while it sits in the current top-K by
      request count — everything else maps to :data:`TenantTracker.OTHER`.
      A cold tenant that turns hot re-promotes the moment its count passes
      the tracked minimum (its pre-promotion history stays in
      ``__other__`` — attribution is forward-looking by design).
    - Families registered via ``bind(family, label="tenant")`` are pruned
      on every demotion AND on every ``prune()`` (the scrape path calls
      it), so no request pattern can hold more than K+1 tenant children
      per family: K tracked names plus the overflow bucket.

    Thread-safe: the count table and tracked set live under one lock;
    family pruning happens outside it (family locks are per-family).
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
        self._families: List[Tuple[_Family, str]] = []

    def bind(self, family: _Family, label: str = "tenant") -> _Family:
        """Register a family whose ``label`` children this tracker bounds."""
        with self._lock:
            self._families.append((family, label))
        return family

    def intern(self, tenant: str) -> str:
        """Count one request for ``tenant``; return the label value the
        caller may use: the tenant's own name iff currently tracked, else
        ``__other__`` (a client claiming ``__other__`` itself lands in the
        overflow bucket — it can never impersonate a tracked series)."""
        name = str(tenant)
        demoted = False
        with self._lock:
            if name == self.OTHER:
                return self.OTHER
            c = self._counts.get(name)
            if c is not None:
                self._counts[name] = c + 1
            elif len(self._counts) < self.capacity:
                self._counts[name] = 1
            else:
                victim, floor = min(
                    self._counts.items(), key=lambda kv: (kv[1], kv[0])
                )
                del self._counts[victim]
                self._counts[name] = floor + 1
                if victim in self._tracked:
                    self._tracked.discard(victim)
                    demoted = True
            if name not in self._tracked:
                if len(self._tracked) < self.top_k:
                    self._tracked.add(name)
                else:
                    low, low_c = min(
                        ((t, self._counts.get(t, 0)) for t in self._tracked),
                        key=lambda kv: (kv[1], kv[0]),
                    )
                    # strictly greater: ties keep the incumbent, so two
                    # equal-rate tenants don't flap the exposition
                    if self._counts[name] > low_c:
                        self._tracked.discard(low)
                        self._tracked.add(name)
                        demoted = True
            out = name if name in self._tracked else self.OTHER
            keep = tuple(self._tracked) + (self.OTHER,)
            fams = list(self._families) if demoted else ()
        for fam, label in fams:
            fam.prune_label(label, keep)
        return out

    def tracked(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._tracked))

    def prune(self) -> None:
        """Re-assert the bound over every bound family — the scrape path
        calls this so a demotion racing an in-flight ``labels()`` call is
        healed by the next collection at the latest."""
        with self._lock:
            keep = tuple(self._tracked) + (self.OTHER,)
            fams = list(self._families)
        for fam, label in fams:
            fam.prune_label(label, keep)

    def snapshot(self) -> Dict[str, object]:
        """Diagnostics for ``/debug/tenants``: who is tracked and with what
        (overestimate-bounded) request counts."""
        with self._lock:
            tracked = sorted(self._tracked)
            counts = {t: self._counts.get(t, 0) for t in tracked}
            table = len(self._counts)
        return {
            "top_k": self.top_k,
            "capacity": self.capacity,
            "tracked": tracked,
            "counts": counts,
            "table_size": table,
        }


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """Process-wide fallback registry: engines constructed standalone report
    here; ``RagService`` rebinds its engines to its own registry, so two
    services never count into one scrape."""
    return _DEFAULT
