"""The port's observability surface against the JAX package's, on the CPU.

- **primitives**: the cases of ``tests/test_obs.py``'s ``TestPrimitives``
  and ``TestTracingUnit`` on both packages' classes, and one sequence of
  registry calls rendering byte-identical Prometheus text and equal JSON
  snapshots;
- **exposition parity**: both services (the same tiny fp32 weights through
  ``models/convert.py``, ``tests/test_torch_resilience.py``'s pair) under
  ``batching="coalesce"`` and ``"continuous"`` get the same scripted
  requests (a traced one, a 400, a 429, a 504, a planted fault, a malformed
  ``traceparent``, a host-path question); the port serves JAX's families
  less the ``WAITING`` table, with equal ``# TYPE``/``# HELP`` lines, label
  sets and bucket bounds, and equal counts wherever a count does not
  measure time;
- **the JAX tests as written**: ``tests/test_obs.py``'s exposition,
  healthz, profile, traced-generate and engine-instrumentation tests run
  unchanged on a port service built as their ``served`` fixture builds the
  JAX one (``SERVED_AS_WRITTEN``);
- **traces, debug routes, /profile, JSON logs**: the same span trees and
  ``traceparent`` parses, the same ``/healthz``, ``/debug/traces`` and
  ``/debug/timeline`` keys and status codes with and without
  ``TPU_RAG_DEBUG``, a ``torch.profiler`` Chrome trace with the stage ranges,
  the formatter's keys; the trace reader ``tools/trace_summary.py`` on a
  hand-made trace.
"""

import dataclasses
import fnmatch
import json
import logging
import os
import re
import time

import pytest
import test_obs as jtests  # the JAX observability tests, run as written on the port below
import test_torch_resilience as pairs_mod  # the JAX/port service pair on shared weights
import torch

from rag_llm_k8s_tpu.obs import flight as jflight
from rag_llm_k8s_tpu.obs import logging as jlogging
from rag_llm_k8s_tpu.obs import metrics as jmetrics
from rag_llm_k8s_tpu.obs import tracing as jtracing
from rag_llm_k8s_tpu.resilience import faults as jfaults
from rag_llm_k8s_tpu_torch.core.config import AppConfig, EncoderConfig, EngineConfig, LlamaConfig, SamplingConfig
from rag_llm_k8s_tpu_torch.engine.encoder import EncoderRunner
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.index.store import VectorStore
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.bge_m3 import build_encoder
from rag_llm_k8s_tpu_torch.models.llama import build_llama
from rag_llm_k8s_tpu_torch.obs import flight as tflight
from rag_llm_k8s_tpu_torch.obs import logging as tlogging
from rag_llm_k8s_tpu_torch.obs import metrics as tmetrics
from rag_llm_k8s_tpu_torch.obs import tracing as ttracing
from rag_llm_k8s_tpu_torch.ops import _build
from rag_llm_k8s_tpu_torch.resilience import faults as tfaults
from rag_llm_k8s_tpu_torch.server import app as tapp
from rag_llm_k8s_tpu_torch.tools import trace_summary

SIDES = {"jax": (jmetrics, jtracing), "port": (tmetrics, ttracing)}

# the JAX service's families whose sources the port does not have yet, by
# the ROADMAP.md Queue 1 item that brings them (exposition names)
WAITING = {
    "8": ("rag_lookahead_*",),
    "9c": ("rag_incident_bundles_total", "rag_quality_*", "rag_goodput_*", "rag_cost_*", "rag_tenant_*",
           "rag_slo_*", "rag_device_hbm_bytes_*", "rag_prefix_cache_device_bytes"),
}
# counters whose values differ by design: the JAX engines count XLA
# executables compiled, the port its kernel-library builds and loads; the
# port journals a subset of the JAX flight catalog
UNEQUAL_BY_DESIGN = ("rag_compile_events_total", "rag_flight_events_total")
VALID_TP = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
LONG_QUESTION = "which of the documents says the most about " + "alpha beta gamma delta " * 5 + "?"


def waiting(name):
    return next((item for item, pats in WAITING.items() if any(fnmatch.fnmatch(name, p) for p in pats)), None)


@pytest.fixture(autouse=True)
def _clean():
    for f in (jfaults, tfaults):
        f.clear()
    yield
    for f in (jfaults, tfaults):
        f.clear()
    jflight.recorder().clear()
    tflight.recorder().clear()


@pytest.fixture(params=sorted(SIDES))
def m(request):
    return SIDES[request.param]


# ---------------------------------------------------------------------------
# primitives (tests/test_obs.py TestPrimitives and TestTracingUnit)
# ---------------------------------------------------------------------------


class TestPrimitives:
    def test_counter_monotonic(self, m):
        c = m[0].MetricsRegistry().counter("rag_test_total")
        c.inc()
        c.inc(2.5)
        assert c.value == 3.5
        with pytest.raises(ValueError):
            c.inc(-1)

    def test_callback_counter_rejects_inc(self, m):
        c = m[0].MetricsRegistry().counter("rag_cb_total", fn=lambda: 7)
        assert c.value == 7.0
        with pytest.raises(RuntimeError):
            c.inc()

    def test_gauge_and_broken_probe(self, m):
        reg = m[0].MetricsRegistry()
        g = reg.gauge("rag_level")
        g.set(4)
        g.dec()
        assert g.value == 3.0
        assert reg.gauge("rag_boom", fn=lambda: 1 / 0).value == 0.0  # a broken probe reads 0.0

    def test_kind_conflict_rejected(self, m):
        reg = m[0].MetricsRegistry()
        reg.counter("rag_x_total")
        with pytest.raises(ValueError):
            reg.gauge("rag_x_total")

    def test_log_buckets_strictly_increasing(self, m):
        for b in (m[0].LATENCY_BUCKETS, m[0].REQUEST_BUCKETS, m[0].TOKEN_LATENCY_BUCKETS,
                  m[0].log_buckets(0.001, 10, 1.07)):
            assert all(b2 > b1 for b1, b2 in zip(b, b[1:]))

    def test_histogram_buckets_and_quantile(self, m):
        reg = m[0].MetricsRegistry()
        h = reg.histogram("rag_h_seconds", buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 0.5, 5.0):
            h.observe(v)
        counts, hsum, count = h.snapshot()
        assert counts == (1, 2, 1, 0) and count == 4
        assert hsum == pytest.approx(6.05)
        assert 0.1 <= h.quantile(0.5) <= 1.0
        assert 1.0 <= h.quantile(0.99) <= 10.0
        assert reg.histogram("rag_empty_seconds").quantile(0.5) is None

    def test_histogram_snapshot_diff_quantile(self, m):
        h = m[0].MetricsRegistry().histogram("rag_win_seconds", buckets=(1.0, 2.0, 4.0))
        h.observe(0.5)
        before = h.snapshot()
        h.observe(3.0)
        h.observe(3.0)
        after = h.snapshot()
        diff = (tuple(a - b for a, b in zip(after[0], before[0])), after[1] - before[1], after[2] - before[2])
        assert 2.0 <= h.quantile(0.5, diff) <= 4.0

    def test_labels_are_distinct_series(self, m):
        fam = m[0].MetricsRegistry().labeled_histogram("rag_lab_seconds", buckets=(1.0,))
        fam.labels(stage="a").observe(0.5)
        fam.labels(stage="b").observe(0.5)
        fam.labels(stage="a").observe(0.5)
        assert fam.labels(stage="a").count == 2 and fam.labels(stage="b").count == 1

    def test_label_value_escaping_keeps_one_line(self, m):
        reg = m[0].MetricsRegistry()
        reg.labeled_counter("rag_esc_total").labels(k='a"b\\c\nd').inc()
        (line,) = [ln for ln in reg.render_prometheus().splitlines() if ln.startswith("rag_esc_total{")]
        assert line == 'rag_esc_total{k="a\\"b\\\\c\\nd"} 1.0'


def _drive(mod):
    """One sequence of registry calls, every kind and rendering path."""
    reg = mod.MetricsRegistry()
    reg.counter("rag_requests_total", "requests\nserved \\ counted").inc(3)
    reg.counter("rag_cb_total", "a callback", fn=lambda: 7)
    g = reg.gauge("rag_depth", 'a "quoted" gauge')
    g.set(4)
    g.inc(2.5)
    g.dec()
    reg.gauge("rag_boom", fn=lambda: 1 / 0)
    h = reg.histogram("rag_request_duration_seconds", "end to end", buckets=mod.REQUEST_BUCKETS)
    for v in (0.004, 0.2, 1.7, 95.0):
        h.observe(v)
    fam = reg.labeled_histogram("rag_stage_duration_seconds", "by stage")
    for stage, v in (("retrieve", 0.03), ("generate", 2.5), ("retrieve", 0.0005)):
        fam.labels(stage=stage).observe(v)
    fam.labels(stage="assemble")  # a child with no observations
    lab = reg.labeled_counter("rag_http_requests_total", "by route and code")
    lab.labels(route="/query", code="200").inc()
    lab.labels(route='/we"ird\n', code="500").inc(2)
    lab.labels_callback(lambda: 11, route="/cb", code="200")
    reg.labeled_gauge("rag_empty_family", "no children")
    itl = reg.labeled_histogram("rag_decode_inter_token_seconds", "itl", buckets=mod.TOKEN_LATENCY_BUCKETS)
    itl.labels(mode="oneshot_est").observe(0.03)
    reg.inc("query_single_fetch")
    reg.observe("query_seconds", 1.25)
    reg.observe("query_seconds", 0.75)
    reg.inc("engine_decode_tokens", 17)
    reg.labeled_counter("rag_pruned_total").labels(tenant="a").inc()
    reg.get_family("rag_pruned_total").prune_label("tenant", ["b"])
    return reg


def test_the_same_calls_render_byte_identical_text_and_equal_snapshots():
    j, t = _drive(jmetrics), _drive(tmetrics)
    assert t.render_prometheus() == j.render_prometheus()
    assert t.snapshot() == j.snapshot()
    assert (tmetrics.LATENCY_BUCKETS, tmetrics.REQUEST_BUCKETS, tmetrics.TOKEN_LATENCY_BUCKETS) == (
        jmetrics.LATENCY_BUCKETS, jmetrics.REQUEST_BUCKETS, jmetrics.TOKEN_LATENCY_BUCKETS)


class TestTracingUnit:
    def test_span_nesting_and_finish(self, m):
        tr = m[1].start_trace("t1")
        with m[1].span("outer"):
            with m[1].span("inner"):
                time.sleep(0.002)
        buf = m[1].TraceBuffer(capacity=2)
        tree = m[1].finish_trace(tr, buf)
        assert m[1].current_trace() is None and tree["trace_id"] == "t1" and len(buf) == 1
        (outer,) = tree["spans"]
        (inner,) = outer["spans"]
        assert (outer["name"], inner["name"]) == ("outer", "inner")
        assert inner["duration_ms"] <= outer["duration_ms"]

    def test_ring_buffer_capacity(self, m):
        buf = m[1].TraceBuffer(capacity=3)
        for i in range(5):
            buf.add({"trace_id": str(i)})
        assert [t["trace_id"] for t in buf.list()] == ["2", "3", "4"]
        assert [t["trace_id"] for t in buf.list(limit=1)] == ["4"]
        assert len(buf.list(limit=0)) == 3 and len(buf.list(limit=-1)) == 3

    def test_span_without_trace_is_noop(self, m):
        with m[1].span("orphan") as sp:
            assert sp is None


def test_a_span_is_a_profiler_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with ttracing.span("retrieve"):
            torch.ones(4).sum()
    assert "retrieve" in {e.name for e in prof.events()}


def test_the_trees_of_the_same_calls_match():
    trees = {}
    for side, (_, tracing) in SIDES.items():
        tr = tracing.start_trace("ab" * 16, parent_span_id="cd" * 8)
        tr.attrs.update(prompt="q", tenant="anon")
        with tracing.span("retrieve") as sp:
            pass
        tr.add_span("tokenize", sp.start_s, 0.001, parent=0, n=3)
        with tracing.span("generate", tokens=4):
            pass
        trees[side] = tracing.finish_trace(tr)

    def shape(node):
        return [(s["name"], sorted(s.get("attrs", {})), shape(s)) for s in node.get("spans", [])]

    assert shape(trees["port"]) == shape(trees["jax"])
    assert sorted(trees["port"]) == sorted(trees["jax"])
    assert trees["port"]["attrs"] == trees["jax"]["attrs"]


# ---------------------------------------------------------------------------
# traceparent and JSON logs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("header", [
    VALID_TP, VALID_TP[:-2] + "00", VALID_TP.replace("00-", "01-", 1) + "-extra", None, "", "garbage",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-" + "0" * 32 + "-00f067aa0ba902b7-01", "00-4bf92f3577b34da6a3ce929d0e0e4736-" + "0" * 16 + "-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00f067aa0ba902b7-01", "00-4bf92f3577b34da6-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01-xx",
    "zz-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01", "00-zzz-yyy-01",
])
def test_traceparent_parses_as_jax_parses(header):
    got, want = tlogging.parse_traceparent(header), jlogging.parse_traceparent(header)
    assert (tuple(got) if got else None) == (tuple(want) if want else None)
    if want is not None:
        assert tlogging.format_traceparent(*got) == jlogging.format_traceparent(*want)
    assert tlogging.parse_traceparent(tlogging.new_traceparent()).sampled


def test_the_json_formatter_gives_the_jax_keys():
    lines = {}
    for side, fmt_mod, tracing in (("jax", jlogging, jtracing), ("port", tlogging, ttracing)):
        tr = tracing.start_trace("ab" * 16)
        try:
            rec = logging.LogRecord("x.access", logging.INFO, __file__, 1, "request %s", ("served",), None)
            rec.route, rec.status, rec.duration_ms = "/query", 200, 1.5
            lines[side] = json.loads(fmt_mod.JsonLogFormatter().format(rec))
        finally:
            tracing.finish_trace(tr)
    assert sorted(lines["port"]) == sorted(lines["jax"])
    for key in ("message", "trace_id", "route", "status", "duration_ms", "level", "logger"):
        assert lines["port"][key] == lines["jax"][key], key
    assert lines["port"]["span_id"] != lines["jax"]["span_id"]  # each side's own server span


# ---------------------------------------------------------------------------
# the two services under the same scripted requests
# ---------------------------------------------------------------------------


_post = pairs_mod._post  # werkzeug's post on the JAX side, the port's on the other


class _Dispatched:
    """A coalescer's wait histogram that counts the items it dispatched."""

    def __init__(self, inner):
        self.inner, self.n = inner, 0

    def observe(self, value):
        self.n += 1
        self.inner.observe(value)


def _script(pair, mode):
    """The same requests to both services, in order; ``{name: {side:
    response}}``."""
    out = {}

    def both(name, body, headers=None, path="/generate"):
        out[name] = {side: _post(side, client, path, body, headers) for side, (_, client) in pair.items()}

    both("traced", {"prompt": "alpha", "trace": True}, {"traceparent": VALID_TP}, path="/query")
    both("plain", {"prompt": "delta"})
    both("long", {"prompt": LONG_QUESTION, "trace": True})
    both("bad_deadline", {"prompt": "a", "deadline_ms": "soon"})
    gates = [svc.admission for svc, _ in pair.values()]
    holds = []
    for g in gates:
        g.max_concurrency, g.max_queue = 1, 0
        holds.append(g.admit())
        holds[-1].__enter__()
    try:
        both("shed", {"prompt": "alpha"})
    finally:
        for g, h in zip(gates, holds):
            h.__exit__(None, None, None)
            g.max_concurrency, g.max_queue = 16, 64
    # the expired request leaves its query in the retrieve coalescer; were
    # it still waiting there when the next request came, the two would be
    # retrieved as one batch of 2 (the host path) on one side and apart on
    # the other, depending on the load. So wait until each side has
    # dispatched it: the next request then retrieves alone on both.
    counters = []
    for svc, _ in pair.values():
        co = svc.retrieve_coalescer
        counters.append((co, co.wait_histogram, _Dispatched(co.wait_histogram)))
        co.wait_histogram = counters[-1][2]
    both("expired", {"prompt": "alpha", "deadline_ms": 0.001})
    t_end = time.monotonic() + 60
    while any(c.n < 1 for _, _, c in counters) and time.monotonic() < t_end:
        time.sleep(0.005)
    for co, hist, c in counters:
        co.wait_histogram = hist
        assert c.n == 1, "the expired request's query was not dispatched"
    # continuous: a decode_step fault (reset, resubmit: a 200); coalesce
    # serves no decode window, so its planted fault is a store lookup: a 500
    site = "decode_step" if mode == "continuous" else "store_lookup"
    jfaults.arm(site)
    tfaults.arm(site)
    both("fault", {"prompt": "delta", "timeline": True})
    both("malformed_tp", {"prompt": "alpha"}, {"traceparent": "00-zzz-yyy-01"}, path="/query")
    for svc, _ in pair.values():
        svc.breaker._events.clear()
    return out


@pytest.fixture(scope="module")
def scripted():
    made = {}

    def get(mode):
        if mode not in made:
            pair = pairs_mod._make_pair(mode)
            made[mode] = (pair, _script(pair, mode))
        return made[mode]

    yield get
    for pair, _ in made.values():
        for svc, _ in pair.values():
            svc.shutdown()


EXPECTED_CODES = {"traced": 200, "plain": 200, "long": 200, "bad_deadline": 400, "shed": 429, "expired": 504,
                  "malformed_tp": 200}


def _exposition(text):
    """``({name: (type line, help line)}, {(name, labels): value})`` of a
    scrape; ``le`` stays in the label string."""
    fams, samples = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            name = line.split()[2]
            fams.setdefault(name, [None, None])[0] = line
        elif line.startswith("# HELP "):
            name = line.split()[2]
            fams.setdefault(name, [None, None])[1] = line
        elif line:
            head, val = line.rsplit(" ", 1)
            name, brace, labels = head.partition("{")
            samples[(name, brace + labels)] = float(val)
    return fams, samples


def _scrapes(pair):
    return {side: _exposition(client.get("/metrics").get_data(as_text=True)) for side, (_, client) in pair.items()}


def _family_of(sample_name, fams):
    for suffix in ("_bucket", "_sum", "_count", ""):
        base = sample_name[: len(sample_name) - len(suffix)] if suffix else sample_name
        if sample_name.endswith(suffix) and base in fams:
            return base
    return None


@pytest.mark.parametrize("mode", ["coalesce", "continuous"])
def test_the_scripted_requests_get_the_jax_status_codes_and_trace_headers(scripted, mode):
    _, got = scripted(mode)
    for name, by_side in got.items():
        codes = {side: r.status_code for side, r in by_side.items()}
        want = EXPECTED_CODES.get(name, 200 if mode == "continuous" else 500)
        assert codes == {"jax": want, "port": want}, (name, codes)
        r = by_side["port"]
        tid = r.headers.get("x-trace-id")
        ctx = tlogging.parse_traceparent(r.headers.get("traceparent"))
        assert re.fullmatch(r"[0-9a-f]{32}", tid) and ctx is not None and ctx.trace_id == tid, name
    assert got["traced"]["port"].headers["x-trace-id"] == VALID_TP.split("-")[1]
    assert got["malformed_tp"]["port"].headers["x-trace-id"] != VALID_TP.split("-")[1]


@pytest.mark.parametrize("mode", ["coalesce", "continuous"])
def test_the_port_serves_the_jax_families_less_the_waiting_table(scripted, mode):
    pair, _ = scripted(mode)
    sc = _scrapes(pair)
    jnames, tnames = set(sc["jax"][0]), set(sc["port"][0])
    assert tnames == {n for n in jnames if waiting(n) is None}
    assert {waiting(n) for n in jnames - tnames} <= set(WAITING)
    assert {"rag_request_duration_seconds", "rag_http_requests_total", "tpu_rag_engine_generate_calls",
            "rag_compile_seconds_total"} <= tnames
    if mode == "continuous":
        assert {"rag_kv_pool_blocks_in_use", "rag_continuous_step_seconds"} <= tnames


def test_the_paged_verify_s_counts_match_jax():
    """Both services with ``spec_paged`` on (``TPU_RAG_SPEC_PAGED=1``,
    K = 4): the same requests give the same draft-token outcomes
    (``rag_spec_tokens_total``), verify windows and emitted tokens, and the
    per-row-bucket acceptance gauge is served on both."""
    pair = pairs_mod._make_pair("continuous", continuous=dict(spec_paged=True, spec_paged_tokens=4))
    try:
        for q in ("alpha beta gamma alpha beta", "zeta zeta zeta zeta", "gamma"):  # the second drafts
            texts = {side: _post(side, client, "/generate", {"prompt": q}).get_json()["generated_text"]
                     for side, (_, client) in pair.items()}
            assert texts["port"] == texts["jax"], q
        sc = _scrapes(pair)
        (jf, js), (tf, ts) = sc["jax"], sc["port"]
        names = ("rag_spec_tokens_total", "tpu_rag_engine_spec_verify_steps", "tpu_rag_engine_spec_emitted_tokens")
        got = {k: v for k, v in ts.items() if k[0] in names}
        assert got == {k: v for k, v in js.items() if k[0] in names}
        assert got[("tpu_rag_engine_spec_verify_steps", "")] > 0
        assert sum(v for k, v in got.items() if k[0] == "rag_spec_tokens_total") > 0, "nothing was drafted"
        assert tf["rag_spec_acceptance_rate"] == jf["rag_spec_acceptance_rate"]
        assert {k for k in ts if k[0] == "rag_spec_acceptance_rate"} == {
            k for k in js if k[0] == "rag_spec_acceptance_rate"}
    finally:
        for svc, _ in pair.values():
            svc.shutdown()


@pytest.mark.parametrize("mode", ["coalesce", "continuous"])
def test_type_help_labels_and_buckets_match(scripted, mode):
    pair, _ = scripted(mode)
    sc = _scrapes(pair)
    (jf, js), (tf, ts) = sc["jax"], sc["port"]
    for name in tf:
        assert tf[name] == jf[name], name  # the # TYPE and # HELP lines
    jkeys = {k for k in js if _family_of(k[0], tf) is not None}
    assert set(ts) == jkeys  # every series, every label set and bucket bound


@pytest.mark.parametrize("mode", ["coalesce", "continuous"])
def test_counts_that_do_not_measure_time_match(scripted, mode):
    pair, _ = scripted(mode)
    sc = _scrapes(pair)
    (jf, js), (tf, ts) = sc["jax"], sc["port"]
    checked = 0
    for (name, labels), v in ts.items():
        fam = _family_of(name, tf)
        kind = tf[fam][0].split()[3]
        time_valued = name.endswith(("_seconds_total", "_seconds_sum")) or (kind == "histogram"
                                                                            and not name.endswith("_count"))
        if kind == "gauge" or time_valued or fam in UNEQUAL_BY_DESIGN:
            continue
        assert v == js[(name, labels)], (name, labels)
        checked += 1
    assert checked >= 30
    # and the port's flight counter is its own journal's count
    assert ts[("rag_flight_events_total", "")] == tflight.recorder().events_emitted


def _shape(tree):
    return [(s["name"], sorted(s.get("attrs", {})), _shape(s)) for s in tree.get("spans", [])]


@pytest.mark.parametrize("mode", ["coalesce", "continuous"])
def test_the_span_trees_match(scripted, mode):
    """Fused (coalesce ``traced``), host (``long``) and continuous paths."""
    _, got = scripted(mode)
    for name in ("traced", "long"):
        trees = {side: r.get_json()["trace"] for side, r in got[name].items()}
        assert _shape(trees["port"]) == _shape(trees["jax"]), name
        assert sorted(trees["port"]) == sorted(trees["jax"])
        assert sorted(trees["port"]["attrs"]) == sorted(trees["jax"]["attrs"])
        stage_sum = sum(s["duration_ms"] for s in trees["port"]["spans"])
        total = got[name]["port"].get_json()["timings"]["total_ms"]
        assert stage_sum == pytest.approx(total, rel=0.05, abs=1.0)
    fused = [s["name"] for s in got["traced"]["port"].get_json()["trace"]["spans"]]
    assert fused == (["retrieve", "generate", "detokenize"] if mode == "coalesce"
                     else ["retrieve", "assemble", "generate", "detokenize"])
    assert got["traced"]["port"].get_json()["trace"]["parent_span_id"] == VALID_TP.split("-")[2]


def test_a_timeline_rides_home_on_continuous_serving(scripted):
    _, got = scripted("continuous")
    bodies = {side: r.get_json() for side, r in got["fault"].items()}
    chains = {side: [e["type"] for e in b["timeline"]["events"]] for side, b in bodies.items()}
    assert chains["port"][0] == "arrival" and chains["port"][-1] == "complete" and "resubmit" in chains["port"]
    assert sorted(bodies["port"]["timeline"]) == sorted(bodies["jax"]["timeline"])
    _, coalesced = scripted("coalesce")
    assert "timeline" not in coalesced["plain"]["port"].get_json()


def test_healthz_debug_traces_and_timeline_keys_and_codes(scripted, monkeypatch):
    pair, _ = scripted("continuous")
    monkeypatch.delenv("TPU_RAG_FAULTS", raising=False)
    # a request of this test's own (each test starts with empty journals)
    rid = {side: _post(side, client, "/generate", {"prompt": "alpha"}).get_json()["request_id"]
           for side, (_, client) in pair.items()}

    def both(path):
        return {side: client.get(path.format(rid=rid[side])) for side, (_, client) in pair.items()}

    health = both("/healthz")
    assert [r.status_code for r in health.values()] == [200, 200]
    assert list(health["port"].get_json()) == list(health["jax"].get_json())
    assert health["port"].get_json()["version"] and health["port"].get_json()["uptime_s"] >= 0
    for path in ("/debug/traces", "/debug/timeline/{rid}"):
        assert {s: r.status_code for s, r in both(path).items()} == {"jax": 403, "port": 403}
    old = {}
    for side, (svc, _) in pair.items():
        old[side] = svc.config
        svc.config = dataclasses.replace(svc.config, flight=dataclasses.replace(svc.config.flight,
                                                                                 debug_endpoints=True))
    try:
        traces = both("/debug/traces?limit=2")
        assert {s: r.status_code for s, r in traces.items()} == {"jax": 200, "port": 200}
        lists = {s: r.get_json()["traces"] for s, r in traces.items()}
        assert [len(v) for v in lists.values()] == [2, 2]
        assert sorted(lists["port"][-1]) == sorted(lists["jax"][-1])
        tl = both("/debug/timeline/{rid}")
        assert {s: r.status_code for s, r in tl.items()} == {"jax": 200, "port": 200}
        assert sorted(tl["port"].get_json()) == sorted(tl["jax"].get_json())
        for path in ("/debug/timeline/987654321", "/debug/timeline/abc"):
            assert {s: r.status_code for s, r in both(path).items()} == {"jax": 404, "port": 404}
        assert both("/debug/traces?limit=x")["port"].get_json()["traces"]
    finally:
        for side, (svc, _) in pair.items():
            svc.config = old[side]


# ---------------------------------------------------------------------------
# tests/test_obs.py as written, on a port service built as its fixture
# ---------------------------------------------------------------------------


class _Client:
    """The port's test client with werkzeug's ``post(path, json=...)``."""

    def __init__(self, client):
        self.client = client

    def get(self, path, headers=None):
        return self.client.get(path, headers=headers)

    def post(self, path, json=None, headers=None):  # noqa: A002 — werkzeug's name
        return self.client.post(path, json_body=json, headers=headers)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``tests/test_obs.py``'s ``served`` fixture on the port: a tiny fp32
    service with no scheduler, one document, one answered query. The store
    persists to a temporary path and the service warms up as the boot does,
    which loads the index codec library: the port's compile counters count
    library builds and loads (the JAX fixture's first query compiles)."""
    vocab = 300
    lc, ec = LlamaConfig.tiny(vocab_size=vocab), EncoderConfig.tiny(vocab_size=vocab)
    fp32 = pairs_mod.FP32
    g = torch.Generator().manual_seed(0)
    model = convert.init_random_(build_llama(lc, fp32, "cpu"), g)
    enc = convert.init_random_(build_encoder(ec, fp32, "cpu"), g)
    engine = InferenceEngine(lc, model, SamplingConfig(do_sample=False, max_new_tokens=6),
                             EngineConfig(prompt_buckets=(128, 512), max_batch_size=2, max_seq_len=640), fp32, "cpu")
    encoder = EncoderRunner(ec, enc, device="cpu", length_buckets=(32,), max_batch=4)
    store = VectorStore(dim=ec.hidden_size, device="cpu",
                        path=str(tmp_path_factory.mktemp("obs_index") / "index"))
    tok = jtests.ByteTokenizer()
    svc = tapp.RagService(AppConfig(model=lc, encoder=ec), engine, tok, encoder, tok, store)
    store.add([encoder.encode([tok.encode("tiny doc text")])[0]],
              [{"filename": "f", "chunk_id": 0, "text": "kernels tile queries"}])
    svc.warmup()
    client = _Client(tapp.create_app(svc).test_client())
    assert client.post("/query", json={"prompt": "what?"}).status_code == 200
    yield svc, client
    svc.shutdown()


# (class, test) of tests/test_obs.py that run unchanged on the port; its
# TestTracedGenerate.test_span_tree_matches_timings also pins the goodput
# ledger's timings keys (chip_ms, goodput_frac: ROADMAP.md Queue 1 item 9c),
# so the span-tree half of it is test_the_span_trees_match above
SERVED_AS_WRITTEN = [
    ("TestExposition", "test_strict_line_format_and_required_families"),
    ("TestExposition", "test_histogram_bucket_monotonicity"),
    ("TestExposition", "test_json_snapshot_equivalent_to_exposition"),
    ("TestExposition", "test_legacy_prometheus_names_preserved"),
    ("TestTracedGenerate", "test_untraced_response_has_no_trace_key"),
    ("TestTracedGenerate", "test_debug_traces_ring"),
    ("TestHealthz", "test_fleet_segmentation_fields"),
    ("TestProfileRoute", "test_seconds_validation"),
    ("TestOneShotEngineInstrumentation", "test_generate_feeds_histograms"),
]


@pytest.mark.parametrize("cls,name", SERVED_AS_WRITTEN)
def test_the_jax_observability_test_passes_on_the_port(served, monkeypatch, cls, name):
    fn = getattr(getattr(jtests, cls)(), name)
    if "monkeypatch" in fn.__code__.co_varnames[: fn.__code__.co_argcount]:
        fn(served, monkeypatch)
    else:
        fn(served)


def test_the_coalescer_wait_histogram_hook_as_written():
    """``tests/test_obs.py``'s coalescer test, on the port's ``Coalescer``
    and registry."""
    from rag_llm_k8s_tpu_torch.engine.batching import Coalescer

    hist = tmetrics.MetricsRegistry().histogram("rag_coalesce_wait_seconds")
    co = Coalescer(lambda xs: [x * 2 for x in xs], max_batch=4, max_wait_ms=1.0)
    co.wait_histogram = hist
    try:
        assert co.submit(21) == 42
        assert hist.count >= 1 and hist.sum >= 0.0
    finally:
        co.shutdown()


# ---------------------------------------------------------------------------
# POST /profile on the CPU
# ---------------------------------------------------------------------------


def test_profile_blocking_writes_a_chrome_trace_with_the_stage_ranges(served, tmp_path):
    _, client = served
    r = client.post("/profile", json={"prompt": "what do kernels do?", "dir": str(tmp_path)})
    assert r.status_code == 200, r.get_json()
    path = r.get_json()["trace_file"]
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        trace = json.load(f)
    names = {e["name"] for e in trace_summary.events(trace, "user_annotation")}
    # the request's stages, and the decode loop's forwards on the engine
    assert {"retrieve", "assemble", "generate", "detokenize"} <= names
    assert names & {"decode_forward", "verify_forward"}
    assert os.path.getsize(path) < 20e6


def test_profile_seconds_validation_and_one_capture_at_a_time(served, tmp_path):
    _, client = served
    for bad in (0, 301, -1):
        assert client.post("/profile", json={"seconds": bad, "dir": str(tmp_path)}).status_code == 400
    r = client.post("/profile", json={"seconds": 0.5, "dir": str(tmp_path)})
    assert r.status_code == 200, r.get_json()
    second = client.post("/profile", json={"seconds": 1, "dir": str(tmp_path)})
    blocking = client.post("/profile", json={"prompt": "x", "dir": str(tmp_path)})
    assert second.status_code == blocking.status_code == 409
    assert second.get_json()["until"] > time.time() - 1
    assert client.post("/query", json={"prompt": "inside the window"}).status_code == 200
    path, t0 = r.get_json()["trace_file"], time.monotonic()
    while not os.path.exists(path) and time.monotonic() - t0 < 30:
        time.sleep(0.05)
    assert os.path.exists(path)  # written when the window closed
    # the capture is free again once its window is written: a new one starts
    t0 = time.monotonic()
    while (r := client.post("/profile", json={"seconds": 0.05, "dir": str(tmp_path)})).status_code == 409:
        assert time.monotonic() - t0 < 30
        time.sleep(0.05)
    assert r.status_code == 200
    while not os.path.exists(r.get_json()["trace_file"]) and time.monotonic() - t0 < 30:
        time.sleep(0.05)
    while _capture_running(client):
        time.sleep(0.01)


def _capture_running(client) -> bool:
    """Whether a profile capture still holds the app's capture slot."""
    return client.client.app._profile_until is not None


def test_a_profiler_that_fails_to_start_answers_500(served, tmp_path, monkeypatch):
    _, client = served

    def broken(device):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(tapp, "_profiler", broken)
    for body in ({"seconds": 1, "dir": str(tmp_path)}, {"prompt": "x", "dir": str(tmp_path)}):
        r = client.post("/profile", json=body)
        assert (r.status_code, r.get_json()) == (500, {"error": "profiler unavailable"})


# ---------------------------------------------------------------------------
# the trace reader (tools/trace_summary.py)
# ---------------------------------------------------------------------------

KNN_SCAN = ("void (anonymous namespace)::knn_scan_part<1, false>(float const*, float4 const*, float const*, "
            "float*, int*, int, int, int, int, int)")
KNN_MERGE = "(anonymous namespace)::knn_merge_parts(float const*, int const*, float*, int*, int, int)"


def test_kernel_names_map_to_their_wrappers():
    assert trace_summary.wrapper_of(KNN_MERGE) == "knn_topk"
    assert trace_summary.wrapper_of(KNN_SCAN) is None
    cases = {
        "void attn_sm90::chunk_kernel<128, 2, 2, (anonymous namespace)::StridedKV>(attn_sm90::Params, "
        "(anonymous namespace)::StridedKV)": "flash_attention",
        "void attn_sm90::ws_kernel<128, 2, (anonymous namespace)::DenseKV>(...)": "chunk_prefill_attention",
        "void attn_sm90::decode_kernel<128, (anonymous namespace)::DenseKV>(...)": "decode_attention",
        "void attn_sm90::decode_kernel<128, (anonymous namespace)::PagedKV>(...)": "paged_decode_attention",
        "void attn_sm90::chunk_kernel<128, 1, 3, (anonymous namespace)::PagedKV>(...)": "paged_chunk_attention",
        "void attn_sm90::decode_q8_kernel<128, (anonymous namespace)::PagedQ8>(...)": "paged_decode_attention_q8",
        "void attn_sm90::chunk_q8_kernel<128, 1, 3, 2, (anonymous namespace)::DenseQ8>(...)":
            "chunk_prefill_attention_q8",
        "void attn_sm90::merge_kernel<128, (anonymous namespace)::DenseKV>(...)": None,
        "void at::native::reduce_kernel<512, 1>(...)": None,
    }
    for name, want in cases.items():
        assert trace_summary.wrapper_of(name) == want, name


def test_every_launch_counter_names_a_kernel_of_csrc():
    """The map from wrapper to kernel sits beside the launch counters; each
    kernel template and KV type it names is defined in ``ops/csrc``, so a
    renamed kernel fails here and not first on the card."""
    assert set(_build.KERNEL_NAMES) == set(_build.LAUNCHES)
    src = "".join(
        open(os.path.join(_build.CSRC, f)).read() for f in sorted(os.listdir(_build.CSRC))
        if f.endswith((".cu", ".cuh"))
    )
    for wrapper, (names, kv) in _build.KERNEL_NAMES.items():
        for name in names:
            assert re.search(r"__global__[^;{]*\b%s\s*\(" % name, src), (wrapper, name)
        assert not kv or re.search(r"\bstruct %s\b" % kv, src), (wrapper, kv)


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_the_summary_of_a_hand_made_trace():
    trace = {"traceEvents": [
        _ev("user_annotation", "retrieve", 0, 20),
        _ev("user_annotation", "decode_forward", 30, 10),
        _ev("cpu_op", "aten::mm", 31, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 32, 1, correlation=7),
        _ev("cuda_runtime", "cudaLaunchKernel", 35, 1, correlation=8),
        _ev("cuda_runtime", "cudaLaunchKernel", 45, 1, correlation=9),  # after the range
        _ev("kernel", KNN_MERGE, 5, 5, tid=7, correlation=3),
        _ev("kernel", KNN_SCAN, 8, 4, tid=7, correlation=2),  # overlaps the merge
        _ev("kernel", "void attn_sm90::decode_kernel<128, (anonymous namespace)::DenseKV>(x)", 36, 4, tid=7,
            correlation=7),
        _ev("kernel", "gemm", 42, 8, tid=7, correlation=8),
        _ev("kernel", "gemm", 60, 10, tid=7, correlation=9),
        {"ph": "i", "name": "marker", "ts": 1},
    ]}
    s = trace_summary.summarize(trace, lo=0, hi=80, n_gaps=3)
    assert s["busy_us"] == 7 + 4 + 8 + 10 and s["busy_share"] == pytest.approx(29 / 80)
    assert s["wrapper_launches"]["knn_topk"] == 1 and s["wrapper_launches"]["decode_attention"] == 1
    assert sum(s["wrapper_launches"].values()) == 2
    assert s["top_ops"][0] == {"name": "gemm", "calls": 2, "us": 18}
    # gaps: [0, 5), [12, 36), [40, 42), [50, 60), [70, 80): longest first
    assert [(g["at_us"], g["us"]) for g in s["gaps"]] == [(12, 24), (50, 10), (70, 10)]
    assert s["gaps"][0]["inside"] is None  # nothing on the host spans all of [12, 36)
    fwd = trace_summary.forward(trace, "decode_forward")
    assert fwd == {"host_issue_us": 10, "kernels": 2, "window_us": 20, "busy_us": 12,
                   "busy_share": pytest.approx(12 / 20)}
    assert trace_summary.enclosing(trace_summary.events(trace, "cpu_op")
                                   + trace_summary.events(trace, "user_annotation"), 31.5, 1) == "aten::mm (cpu_op)"
    assert trace_summary.forward(trace, "verify_forward") is None
