"""The port's SLO engine, regression comparator and device gauges against
the JAX package's, on the CPU.

- **as written**: ``tests/test_slo.py``'s burn-rate math
  (``TestBurnRateMath``), its regression-gate cases
  (``TestRegressionGate``), its ``default_specs`` cases and its ``/slo``
  endpoint cases (``TestSloEndpoint``) run unchanged, once on the JAX
  modules and once with the port's ``obs/slo.py``, ``obs/metrics.py``,
  ``obs/regression.py`` and ``AppConfig`` in their place (the endpoint
  cases on a port service);
- **config**: ``SloConfig.from_env`` falls back to the default on a
  malformed or out-of-range value, as the JAX parse does;
- **equal outputs**: the same registry calls and clock give the JAX
  engine's report, the comparator classifies and compares the same; the
  JAX/port service pair (``tests/test_torch_resilience.py``'s) answers
  ``/slo?force=1`` with equal reports under one injected clock, and
  ``/metrics`` carries the ``rag_slo_*`` gauges;
- **device gauges**: on the CPU each family has one ``device="0"`` child
  reading 0, and the prefix-cache bytes flow through per device.
"""

import re

import pytest
import test_slo as jtests  # the JAX SLO tests, run as written on the port below
import test_torch_resilience as pairs_mod  # the JAX/port service pair on shared weights
from test_torch_obs import _Client  # the port's test client with werkzeug's post(path, json=...)

from rag_llm_k8s_tpu.core.config import SloConfig as JSloConfig
from rag_llm_k8s_tpu.obs import metrics as jmetrics
from rag_llm_k8s_tpu.obs import regression as jregression
from rag_llm_k8s_tpu.obs import slo as jslo
from rag_llm_k8s_tpu_torch.core.config import AppConfig, PrefixCacheConfig, SloConfig
from rag_llm_k8s_tpu_torch.engine.prefix_cache import PrefixCache
from rag_llm_k8s_tpu_torch.obs import devices as tdevices
from rag_llm_k8s_tpu_torch.obs import metrics as tmetrics
from rag_llm_k8s_tpu_torch.obs import regression as tregression
from rag_llm_k8s_tpu_torch.obs import slo as tslo
from rag_llm_k8s_tpu_torch.server import app as tapp

PORT_MODULES = {"obs_slo": tslo, "obs_metrics": tmetrics, "regression": tregression, "AppConfig": AppConfig}


@pytest.fixture(params=["jax", "port"])
def side(request, monkeypatch):
    """Which package the as-written tests run on: the port's modules take
    the JAX modules' names in ``tests/test_slo.py`` for the test."""
    if request.param == "port":
        for name, mod in PORT_MODULES.items():
            monkeypatch.setattr(jtests, name, mod)
    return request.param


def _cases(cls):
    return [n for n in vars(cls) if n.startswith("test_")]


@pytest.mark.parametrize("name", _cases(jtests.TestBurnRateMath))
def test_burn_rate_math_as_written(side, name):
    getattr(jtests.TestBurnRateMath(), name)()


@pytest.mark.parametrize("name", _cases(jtests.TestRegressionGate))
def test_regression_gate_as_written(side, name, tmp_path):
    fn = getattr(jtests.TestRegressionGate(), name)
    fn(tmp_path) if "tmp_path" in fn.__code__.co_varnames[: fn.__code__.co_argcount] else fn()


@pytest.mark.parametrize("name", ["test_default_specs_construct_from_hostile_env", "test_app_config_threads_slo"])
def test_default_specs_as_written(side, name, monkeypatch):
    fn = getattr(jtests.TestSloConfig(), name)
    fn(monkeypatch) if "monkeypatch" in fn.__code__.co_varnames[: fn.__code__.co_argcount] else fn()


@pytest.mark.parametrize("env", [
    {},
    {"TPU_RAG_SLO_REQUEST_P95_S": "3.5", "TPU_RAG_SLO_TTFT_P95_OBJECTIVE": "0.9"},
    {"TPU_RAG_SLO_REQUEST_P95_S": "two seconds", "TPU_RAG_SLO_AVAILABILITY_OBJECTIVE": ""},
    {"TPU_RAG_SLO_REQUEST_P95_OBJECTIVE": "1.5", "TPU_RAG_SLO_TTFT_P95_S": "0", "TPU_RAG_SLO_REQUEST_P95_S": "-1"},
    {"TPU_RAG_SLO_QUALITY_OBJECTIVE": "0.98", "TPU_RAG_SLO_QUALITY_LOGIT_ERR": "0.2"},
    {"TPU_RAG_SLO_QUALITY_OBJECTIVE": "yes", "TPU_RAG_SLO_QUALITY_LOGIT_ERR": "-0.2"},
])
def test_slo_config_parses_as_jax_does(env):
    assert vars(SloConfig.from_env(env)) == vars(JSloConfig.from_env(env))
    assert AppConfig.from_env(env).slo == SloConfig.from_env(env)


def _engine_report(slo, metrics):
    """One scripted registry and clock through an SloEngine: hours of good
    and bad availability and latency samples; the report and the scrape's
    ``rag_slo_*`` lines."""
    reg = metrics.MetricsRegistry()
    fam = reg.labeled_counter("rag_http_requests_total", "test")
    h = reg.histogram("rag_request_duration_seconds", buckets=metrics.REQUEST_BUCKETS)
    t = reg.labeled_histogram("rag_tenant_request_seconds", "test", buckets=metrics.REQUEST_BUCKETS)
    tf = reg.labeled_counter("rag_tenant_http_requests_total", "test")
    clock = jtests.FakeClock()
    eng = slo.SloEngine(reg, specs=slo.default_specs(slo.SloConfig()), clock=clock, min_eval_interval_s=0.0)
    eng.set_tenants(["a", "b"])
    for i in range(14):
        fam.labels(route="/generate", code="200").inc(100)
        fam.labels(route="/generate", code="500").inc(i % 3)
        tf.labels(tenant="a", code="200").inc(10)
        tf.labels(tenant="b", code="503").inc(i % 2)
        for v in (0.3, 1.5, 2.5, 9.0):
            h.observe(v)
            t.labels(tenant="a").observe(v / 3)
        eng.sample()
        clock.advance(1800)
    clock.advance(1)
    report = eng.evaluate(force=True)
    lines = sorted(line for line in reg.render_prometheus().splitlines() if line.startswith("rag_slo_"))
    return report, lines


def test_the_same_samples_give_the_jax_report_and_gauges():
    tr, tl = _engine_report(tslo, tmetrics)
    jr, jl = _engine_report(jslo, jmetrics)
    assert tr == jr and tl == jl
    assert {s["name"] for s in tr["slos"]} == {"availability", "request_p95", "ttft_p95", "quality_p99_logit_err"}
    assert sorted(tr["tenants"]) == ["a", "b"]
    # the quality spec reads a family the port does not have yet: no events, compliant
    q = next(s for s in tr["slos"] if s["name"] == "quality_p99_logit_err")
    assert q["compliant"] and q["window_events"]["6h"] == 0
    assert any(s["fast_burn"] or s["slow_burn"] or not s["compliant"] for s in tr["slos"])


def test_the_comparator_classifies_as_jax_does():
    keys = ["value", "query_p50_ms", "coalesce_tok_per_s", "decode_mfu", "bubble_frac", "overhead_frac",
            "replay_fidelity.steps_per_s_ratio", "chunk_reuse.logit_tol_ok", "tunnel_fetch_ms", "snapshot_bytes",
            "prefill_skip_frac", "goodput_frac", "n", "spec_verify_steps", "tokens_per_usd"]
    assert [tregression.classify(k) for k in keys] == [jregression.classify(k) for k in keys]
    cur = dict(jtests.BASE_BENCH, query_p50_ms=1300.0, coalesce_tok_per_s=900.0, extra_ms=1.0)
    got = {mod.__name__.split(".")[0]: mod.compare(cur, jtests.BASE_BENCH) for mod in (tregression, jregression)}
    as_tuples = {k: {b: [(f.key, f.direction) for f in v[b]] for b in v} for k, v in got.items()}
    assert as_tuples["rag_llm_k8s_tpu_torch"] == as_tuples["rag_llm_k8s_tpu"]
    assert tregression.flatten({"a": {"b": 1}}) == jregression.flatten({"a": {"b": 1}})


# ---------------------------------------------------------------------------
# /slo on services
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    p = pairs_mod._make_pair("continuous")
    yield p
    for svc, _ in p.values():
        svc.shutdown()


@pytest.fixture
def served(pair, side):
    """``tests/test_slo.py``'s ``served`` on the side the test runs on."""
    svc, client = pair[side]
    return svc, (client if side == "jax" else _Client(client))


@pytest.mark.parametrize("name", _cases(jtests.TestSloEndpoint))
def test_slo_endpoint_as_written(served, name):
    getattr(jtests.TestSloEndpoint(), name)(served)


def _counted(entries):
    """What a report's entries count, not what they time: names, specs,
    thresholds and the events in each window."""
    if isinstance(entries, dict):
        return {t: _counted(v) for t, v in entries.items()}
    keep = ("name", "kind", "metric", "objective", "threshold_s", "threshold_bucket_s", "window_events")
    return [{k: e.get(k) for k in keep} | {"windows": sorted(e["burn_rate"])} for e in entries]


def test_slo_answers_equal_reports_under_one_clock():
    pair = pairs_mod._make_pair("continuous")  # counters of this test's own
    clock = jtests.FakeClock(5000.0)
    for svc, _ in pair.values():
        svc.slo.clock = clock
    try:
        for q in ("alpha", "delta", "alpha beta gamma"):
            for side, (_, client) in pair.items():
                assert pairs_mod._post(side, client, "/generate", {"prompt": q, "tenant_id": "t1"}).status_code == 200
        clock.advance(30.0)
        got = {side: client.get("/slo?force=1") for side, (_, client) in pair.items()}
        assert [r.status_code for r in got.values()] == [200, 200]
        body = {side: r.get_json() for side, r in got.items()}
        # counts agree; burn on a latency spec measures each side's own
        # clock (the JAX service compiles on its first requests)
        assert sorted(body["port"]) == sorted(body["jax"])
        for key in ("slos", "tenants"):
            assert _counted(body["port"][key]) == _counted(body["jax"][key])
        avail = [next(e for e in b["slos"] if e["name"] == "availability") for b in body.values()]
        assert avail[0] == avail[1]
        assert "t1" in body["port"]["tenants"]
        req = next(s for s in body["port"]["slos"] if s["name"] == "request_p95")
        assert req["window_events"]["5m"] >= 3
        # the rag_slo_* gauges ride the scrape on both sides
        for _, client in pair.values():
            text = client.get("/metrics").get_data(as_text=True)
            assert 'rag_slo_burn_rate{slo="availability",window="5m"}' in text
            assert 'rag_slo_compliant{slo="quality_p99_logit_err"}' in text
    finally:
        for svc, _ in pair.values():
            svc.shutdown()


# ---------------------------------------------------------------------------
# device gauges (tests/test_slo.py TestDeviceTelemetry on the port)
# ---------------------------------------------------------------------------


def test_cpu_device_gauges_read_zero():
    reg = tmetrics.MetricsRegistry()
    assert tdevices.register_device_gauges(reg, lambda: {0: 4096}) == 1
    text = reg.render_prometheus()
    assert re.search(r'rag_device_hbm_bytes_in_use\{device="0"\} 0\.0', text)
    assert re.search(r'rag_device_hbm_bytes_limit\{device="0"\} 0\.0', text)
    assert re.search(r'rag_prefix_cache_device_bytes\{device="0"\} 4096\.0', text)
    # a CPU device asks nothing of torch.cuda
    assert tdevices.local_devices(tapp.torch.device("cpu")) == [0]


def test_prefix_cache_bytes_by_device_empty():
    assert PrefixCache(PrefixCacheConfig(enabled=True), engine=None).bytes_by_device() == {}
