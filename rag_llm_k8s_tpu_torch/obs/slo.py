"""SLO engine, the port's copy of ``rag_llm_k8s_tpu/obs/slo.py``: error
budgets and multi-window burn-rate alerting, after the multiwindow,
multi-burn-rate recipe of the Google SRE workbook.

- an :class:`SloSpec` declares one objective over an SLI stream —
  ``latency`` (good event = request faster than ``threshold_s``, read off a
  registry histogram's fixed buckets) or ``availability`` (good event =
  non-5xx request, read off the ``rag_http_requests_total{route,code}``
  family the server maintains);
- the engine samples the CUMULATIVE (good, total) pair per SLI into a
  time-indexed ring and evaluates windowed SLI values by differencing the
  ring;
- **burn rate** per window = (bad fraction) / (1 - objective): burn 1.0
  spends exactly the error budget by the end of the SLO period, 14.4 spends
  a 30-day budget in 2 days. The alert signal pairs a long window with a
  short one and fires only when BOTH burn (long = real spend, short = still
  happening now): fast pair 5m/1h at 14.4 → page; slow pair 30m/6h at 6 →
  ticket;
- everything is re-exported as ``rag_slo_*`` callback gauges, so the SAME
  numbers land in the Prometheus scrape, and ``GET /slo`` returns the full
  report as JSON.

Windows are wall-clock and the sampler is *pull-lazy*: every evaluation
records a fresh ring sample first, so a scrape cadence of 10-60 s gives the
windows their resolution with no background thread. ``clock`` is
injectable, so a test replays hours of traffic in microseconds.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from rag_llm_k8s_tpu_torch.core.config import SloConfig
from rag_llm_k8s_tpu_torch.obs import metrics as obs_metrics

__all__ = ["SloSpec", "SloEngine", "BurnPolicy", "default_specs"]


# (short_s, long_s, threshold): fire when BOTH windows burn >= threshold.
# The canonical SRE-workbook pairs for a 30-day budget: 14.4 = 2% of budget
# in 1h (page), 6 = 10% of budget in 6h (ticket).
@dataclass(frozen=True)
class BurnPolicy:
    fast_short_s: float = 300.0
    fast_long_s: float = 3600.0
    fast_threshold: float = 14.4
    slow_short_s: float = 1800.0
    slow_long_s: float = 21600.0
    slow_threshold: float = 6.0

    def windows(self) -> Tuple[float, ...]:
        return tuple(sorted({self.fast_short_s, self.fast_long_s,
                             self.slow_short_s, self.slow_long_s}))


@dataclass(frozen=True)
class SloSpec:
    """One declarative objective over a served SLI stream.

    ``kind='latency'``: good = observation <= ``threshold_s``, counted from
    the named histogram's cumulative buckets (the threshold is snapped to
    the nearest bucket bound at evaluation — log-spaced ladders keep that
    snap within ~12% on the request ladder, and the snapped value is
    reported so dashboards show the real boundary).

    ``kind='availability'``: good = sample with a non-5xx ``code`` label,
    counted from the named labeled-counter family.

    ``labels`` (optional) restricts the SLI stream to family children whose
    label set CONTAINS every (name, value) pair — the mechanism per-tenant
    objectives use: the same family, one tenant's slice of it.
    """

    name: str
    kind: str  # 'latency' | 'availability'
    metric: str  # histogram family (latency) / counter family (availability)
    objective: float  # fraction of good events, e.g. 0.95
    threshold_s: Optional[float] = None  # latency only
    policy: BurnPolicy = field(default_factory=BurnPolicy)
    labels: Optional[Tuple[Tuple[str, str], ...]] = None  # child filter

    def __post_init__(self):
        if self.kind not in ("latency", "availability"):
            raise ValueError(f"SloSpec.kind={self.kind!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if self.kind == "latency" and not self.threshold_s:
            raise ValueError("latency SLO needs threshold_s")


def default_specs(cfg: Optional[SloConfig] = None) -> List[SloSpec]:
    """The served defaults (knobs on ``core/config.py::SloConfig`` — env
    ``TPU_RAG_SLO_*``, parsed there with safe fallbacks so a malformed
    value retunes to the default instead of raising at scrape time):

    - availability 99.9% of requests non-5xx;
    - request p95 < 2 s (the north-star budget applied at p95 —
      ``TPU_RAG_SLO_REQUEST_P95_S`` / ``_OBJECTIVE`` to retune);
    - TTFT p95 < 1 s (meaningful under continuous serving, where TTFT is
      measured exactly; vacuously compliant when the histogram is empty);
    - quality p99 logit err ≤ 0.15: of the shadow auditor's audited
      requests (each audit observes its exact-vs-delivered logit error
      into ``rag_quality_logit_err``), 99% must stay under the pinned
      approximation tolerance; the ``threshold_s`` field carries the logit
      bound. The port has no auditor yet (ROADMAP.md Queue 1 item 9c-ii):
      the family does not exist, reads (0, 0), and the spec is vacuously
      compliant, as in the JAX service with its auditor off.
    """
    if cfg is None:
        cfg = SloConfig.from_env()
    return [
        SloSpec("availability", "availability", "rag_http_requests_total",
                objective=cfg.availability_objective),
        SloSpec("request_p95", "latency", "rag_request_duration_seconds",
                objective=cfg.request_p95_objective,
                threshold_s=cfg.request_p95_s),
        SloSpec("ttft_p95", "latency", "rag_time_to_first_token_seconds",
                objective=cfg.ttft_p95_objective,
                threshold_s=cfg.ttft_p95_s),
        SloSpec("quality_p99_logit_err", "latency", "rag_quality_logit_err",
                objective=cfg.quality_objective,
                threshold_s=cfg.quality_logit_err),
    ]


class SloEngine:
    """Windows the registry's cumulative state into burn rates.

    ``evaluate()`` is the one entry point: it appends a fresh ring sample
    (pruning past the longest window) and returns the per-SLO report. The
    gauges and ``GET /slo`` both go through a short evaluation cache
    (``min_eval_interval_s``) so a scrape reading five ``rag_slo_*``
    families computes the report once, not five times.
    """

    def __init__(
        self,
        registry: obs_metrics.MetricsRegistry,
        specs: Optional[List[SloSpec]] = None,
        clock: Callable[[], float] = time.monotonic,
        min_eval_interval_s: float = 1.0,
        register_gauges: bool = True,
    ):
        self.registry = registry
        self.specs = list(specs) if specs is not None else default_specs()
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.clock = clock
        self.min_eval_interval_s = min_eval_interval_s
        self._lock = threading.Lock()
        # ring: per spec, [(t, good_cum, total_cum)]
        self._ring: Dict[str, List[Tuple[float, float, float]]] = {
            s.name: [] for s in self.specs
        }
        # per-tracked-tenant objectives: tenant -> derived specs.
        # Reconciled by set_tenants() against the edge's TenantTracker, so
        # the set is bounded by the tracker's top_k by construction. These
        # feed the report's "tenants" section only — no per-tenant gauges,
        # and no vote in the global page/ticket signal (one tenant's burn
        # is an attribution fact, not a fleet page).
        self._tenant_specs: Dict[str, List[SloSpec]] = {}
        self._horizon = max(
            max(s.policy.windows()) for s in self.specs
        ) if self.specs else 0.0
        self._cached: Optional[Dict] = None
        self._cached_at: float = -float("inf")
        if register_gauges:
            self._register_gauges()

    # -- cumulative SLI reads -------------------------------------------
    @staticmethod
    def _match(spec: SloSpec, labels) -> bool:
        """Does a family child belong to this spec's SLI stream?"""
        if spec.labels is None:
            return True
        have = dict(labels)
        return all(have.get(k) == v for k, v in spec.labels)

    def _cumulative(self, spec: SloSpec) -> Tuple[float, float]:
        """(good, total) lifetime counts for one spec, straight off the
        registry. Missing families read as (0, 0) — no traffic yet."""
        fam = self.registry.get_family(spec.metric)
        if fam is None:
            return 0.0, 0.0
        if spec.kind == "availability":
            good = total = 0.0
            for labels, child in fam.items():
                if not self._match(spec, labels):
                    continue
                v = child.value
                total += v
                code = dict(labels).get("code", "")
                if not code.startswith("5"):
                    good += v
            return good, total
        # latency: cumulative count at the bucket bound covering threshold
        good = total = 0.0
        for labels, child in fam.items():
            if not self._match(spec, labels):
                continue
            counts, _, count = child.snapshot()
            total += count
            # observe() uses bisect_left(bounds, v): every observation
            # <= bounds[i] lands in counts[:i+1] — mirror that here so
            # "good" counts exactly the observations a cold observe at
            # the threshold value would join. CLAMPED below the +Inf
            # overflow slot: a threshold above the ladder's top bound must
            # evaluate at the top bound (snapped_threshold reports it), not
            # count the overflow as "good" and go vacuously compliant.
            i = min(bisect_left(child.bounds, spec.threshold_s),
                    len(child.bounds) - 1)
            good += sum(counts[: i + 1])
        return good, total

    def snapped_threshold(self, spec: SloSpec) -> Optional[float]:
        """The bucket bound the threshold actually evaluates at."""
        if spec.kind != "latency":
            return None
        fam = self.registry.get_family(spec.metric)
        if fam is None:
            return spec.threshold_s
        for _, child in fam.items():
            i = bisect_left(child.bounds, spec.threshold_s)
            return float(child.bounds[min(i, len(child.bounds) - 1)])
        return spec.threshold_s

    # -- sampling ring ---------------------------------------------------
    def sample(self, now: Optional[float] = None) -> None:
        """Record one cumulative sample per spec (and prune the ring)."""
        t = self.clock() if now is None else now
        with self._lock:
            specs = list(self.specs)
            for tenant_specs in self._tenant_specs.values():
                specs.extend(tenant_specs)
            for spec in specs:
                good, total = self._cumulative(spec)
                ring = self._ring.setdefault(spec.name, [])
                if ring and ring[-1][0] >= t:
                    # monotonic guard: a same-instant re-sample replaces
                    ring.pop()
                ring.append((t, good, total))
                cutoff = t - self._horizon - 1.0
                while len(ring) > 2 and ring[1][0] <= cutoff:
                    ring.pop(0)

    def _window_rate(self, name: str, window_s: float, now: float
                     ) -> Tuple[float, float, float]:
        """(bad_fraction, good, total) over the trailing window.

        The baseline sample is the newest one at or before ``now - window``;
        when monitoring began INSIDE the window (no sample that old yet),
        the baseline is zero — the window counts everything since counter
        start, the standard cold-start behavior, so burn is computable from
        the first minute of traffic. Zero in-window traffic reads as
        (0.0, 0, 0): no events, no burn.
        """
        ring = self._ring.get(name)
        if not ring:
            return 0.0, 0.0, 0.0
        t0 = now - window_s
        base: Optional[Tuple[float, float, float]] = None
        for s in ring:
            if s[0] <= t0:
                base = s
            else:
                break
        if base is None:
            base = (t0, 0.0, 0.0)
        head = ring[-1]
        good = head[1] - base[1]
        total = head[2] - base[2]
        if total <= 0:
            return 0.0, 0.0, 0.0
        bad_frac = max(0.0, min(1.0, 1.0 - good / total))
        return bad_frac, good, total

    # -- evaluation ------------------------------------------------------
    def evaluate(self, force: bool = False) -> Dict:
        """Sample + compute the full report (cached ``min_eval_interval_s``).

        Report shape (per SLO): windowed burn rates keyed "5m"/"1h"/...,
        ``fast_burn``/``slow_burn`` booleans (both-windows rule),
        ``error_budget_remaining`` over the slow long window (1.0 = budget
        untouched, 0.0 = fully spent, floored at 0), and ``compliant`` =
        the long-window SLI meets the objective.
        """
        now = self.clock()
        with self._lock:
            if (not force and self._cached is not None
                    and now - self._cached_at < self.min_eval_interval_s):
                return self._cached
            tenant_specs = {
                t: list(ss) for t, ss in sorted(self._tenant_specs.items())
            }
        self.sample(now)
        slos = []
        any_page = any_ticket = False
        for spec in self.specs:
            entry = self._spec_entry(spec, now)
            slos.append(entry)
            any_page = any_page or entry["fast_burn"]
            any_ticket = any_ticket or entry["slow_burn"]
        # per-tenant burn (attribution, not paging: a single tenant's burn
        # names WHO is spending the budget — the fleet page stays with the
        # aggregate specs above)
        tenants = {
            t: [self._spec_entry(s, now) for s in ss]
            for t, ss in tenant_specs.items()
        }
        report = {
            "slos": slos, "page": any_page, "ticket": any_ticket,
            "tenants": tenants,
        }
        with self._lock:
            self._cached = report
            self._cached_at = now
        return report

    def _spec_entry(self, spec: SloSpec, now: float) -> Dict:
        """The per-SLO report entry — shared by the aggregate and the
        per-tenant loops so the two sections can never disagree on math."""
        pol = spec.policy
        budget = 1.0 - spec.objective
        burn: Dict[str, float] = {}
        frac_by_w: Dict[float, float] = {}
        totals: Dict[float, float] = {}
        with self._lock:  # consistent ring view vs a concurrent sample()
            for w in pol.windows():
                bad_frac, _, total = self._window_rate(spec.name, w, now)
                frac_by_w[w] = bad_frac
                totals[w] = total
                burn[_fmt_window(w)] = round(bad_frac / budget, 3)
        fast = (frac_by_w[pol.fast_short_s] / budget >= pol.fast_threshold
                and frac_by_w[pol.fast_long_s] / budget >= pol.fast_threshold)
        slow = (frac_by_w[pol.slow_short_s] / budget >= pol.slow_threshold
                and frac_by_w[pol.slow_long_s] / budget >= pol.slow_threshold)
        long_frac = frac_by_w[pol.slow_long_s]
        remaining = max(0.0, 1.0 - long_frac / budget)
        entry = {
            "name": spec.name,
            "kind": spec.kind,
            "metric": spec.metric,
            "objective": spec.objective,
            "burn_rate": burn,
            "fast_burn": fast,
            "slow_burn": slow,
            "error_budget_remaining": round(remaining, 4),
            "compliant": long_frac <= budget,
            "window_events": {
                _fmt_window(w): int(t) for w, t in totals.items()
            },
        }
        if spec.kind == "latency":
            entry["threshold_s"] = spec.threshold_s
            entry["threshold_bucket_s"] = self.snapped_threshold(spec)
        return entry

    # -- per-tenant objectives --------------------------------
    def _make_tenant_specs(self, tenant: str) -> List[SloSpec]:
        """Derive one availability + one latency objective for a tenant
        from the aggregate specs, re-pointed at the ``rag_tenant_*``
        families and filtered to that tenant's children — objectives and
        policies stay single-sourced from SloConfig."""
        base = {s.name: s for s in self.specs}
        out: List[SloSpec] = []
        avail = base.get("availability")
        if avail is not None:
            out.append(SloSpec(
                f"tenant:{tenant}:availability", "availability",
                "rag_tenant_http_requests_total",
                objective=avail.objective, policy=avail.policy,
                labels=(("tenant", tenant),),
            ))
        lat = base.get("request_p95")
        if lat is not None:
            out.append(SloSpec(
                f"tenant:{tenant}:request_p95", "latency",
                "rag_tenant_request_seconds",
                objective=lat.objective, threshold_s=lat.threshold_s,
                policy=lat.policy, labels=(("tenant", tenant),),
            ))
        return out

    def set_tenants(self, tenants) -> None:
        """Reconcile the per-tenant spec set against the tracker's tracked
        tenants (called from the scrape/evaluate path). A departed tenant's
        ring is dropped; a newly tracked tenant starts cold — windowed burn
        becomes meaningful from its first minute of samples, the same
        cold-start rule the aggregate specs follow."""
        want = sorted({str(t) for t in tenants if t})
        with self._lock:
            if want == sorted(self._tenant_specs):
                return
            for t in list(self._tenant_specs):
                if t not in want:
                    for s in self._tenant_specs.pop(t):
                        self._ring.pop(s.name, None)
            for t in want:
                if t not in self._tenant_specs:
                    self._tenant_specs[t] = self._make_tenant_specs(t)
            self._cached = None  # the report's tenant section changed shape

    # -- gauge export ----------------------------------------------------
    def _register_gauges(self) -> None:
        """`rag_slo_*` families: the report's numbers as callback gauges, so
        the alerting math ships in the same scrape the SLIs do (a Prometheus
        can alert on our burn rates OR recompute its own from the buckets —
        both read one registry)."""
        reg = self.registry
        burn_fam = reg.labeled_gauge(
            "rag_slo_burn_rate",
            "windowed error-budget burn rate (1.0 spends the budget exactly "
            "over the SLO period); slo + window labels",
        )
        budget_fam = reg.labeled_gauge(
            "rag_slo_error_budget_remaining",
            "fraction of error budget left over the slow long window",
        )
        compliant_fam = reg.labeled_gauge(
            "rag_slo_compliant", "1 when the long-window SLI meets the objective"
        )
        fast_fam = reg.labeled_gauge(
            "rag_slo_fast_burn_active",
            "1 when both fast windows burn over threshold (page)",
        )
        slow_fam = reg.labeled_gauge(
            "rag_slo_slow_burn_active",
            "1 when both slow windows burn over threshold (ticket)",
        )

        def _entry(name: str) -> Dict:
            for e in self.evaluate()["slos"]:
                if e["name"] == name:
                    return e
            return {}

        for spec in self.specs:
            nm = spec.name
            for w in spec.policy.windows():
                wl = _fmt_window(w)
                burn_fam.labels_callback(
                    lambda nm=nm, wl=wl: _entry(nm).get("burn_rate", {}).get(wl, 0.0),
                    slo=nm, window=wl,
                )
            budget_fam.labels_callback(
                lambda nm=nm: _entry(nm).get("error_budget_remaining", 1.0), slo=nm
            )
            compliant_fam.labels_callback(
                lambda nm=nm: float(_entry(nm).get("compliant", True)), slo=nm
            )
            fast_fam.labels_callback(
                lambda nm=nm: float(_entry(nm).get("fast_burn", False)), slo=nm
            )
            slow_fam.labels_callback(
                lambda nm=nm: float(_entry(nm).get("slow_burn", False)), slo=nm
            )


def _fmt_window(seconds: float) -> str:
    s = int(seconds)
    if s % 3600 == 0:
        return f"{s // 3600}h"
    if s % 60 == 0:
        return f"{s // 60}m"
    return f"{s}s"
