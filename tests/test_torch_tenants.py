"""The port's tenant attribution against the JAX package's, on the CPU.

- **as written**: ``tests/test_tenants.py``'s help escaping, tracker,
  report, config and churn-storm cases run unchanged, once on the JAX
  modules and once with the port's ``obs/metrics.py``, ``obs/tenants.py``
  and ``AppConfig`` in their place; its service cases
  (``TestTenantService``) run unchanged on a port service;
- **equal outputs**: one sequence of interns through both trackers (bound
  families, pruning, snapshots) and one journal through both
  ``obs/tenants.py`` renderers give equal results;
- **the scheduler**: three tenants' ledger rollups through the port's paged
  scheduler sum to ``busy_seconds()`` within 5%, two requests each;
- **the service pair** (``tests/test_torch_resilience.py``'s, shared tiny
  weights): the same requests under the same tenants give ``/debug/tenants``
  equal counts per tenant, equal tracker tables and the same per-tenant SLO
  entries, and the live report is the one a saved journal renders.
"""

import dataclasses
import json
import threading
import types

import jax
import pytest
import test_tenants as jtests  # the JAX tenant tests, run as written on the port below
import test_torch_resilience as pairs_mod  # the JAX/port service pair on shared weights
from test_torch_obs import _Client  # the port's test client with werkzeug's post(path, json=...)

from rag_llm_k8s_tpu.models.llama import init_llama_params
from rag_llm_k8s_tpu.obs import metrics as jmetrics
from rag_llm_k8s_tpu.obs import tenants as jtenants
from rag_llm_k8s_tpu_torch.core.config import AppConfig, EngineConfig, LlamaConfig, SamplingConfig
from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine, ContinuousScheduler
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.llama import build_llama
from rag_llm_k8s_tpu_torch.obs import flight as tflight
from rag_llm_k8s_tpu_torch.obs import metrics as tmetrics
from rag_llm_k8s_tpu_torch.obs import tenants as ttenants
from rag_llm_k8s_tpu_torch.server import app as tapp


def _port_create_app(svc):
    return types.SimpleNamespace(test_client=lambda: _Client(tapp.create_app(svc).test_client()))


PORT_MODULES = {"obs_metrics": tmetrics, "obs_tenants": ttenants, "AppConfig": AppConfig,
                "create_app": _port_create_app}


@pytest.fixture(params=["jax", "port"])
def side(request, monkeypatch):
    """Which package the as-written tests run on: the port's modules take
    the JAX modules' names in ``tests/test_tenants.py`` for the test."""
    if request.param == "port":
        for name, mod in PORT_MODULES.items():
            monkeypatch.setattr(jtests, name, mod)
    return request.param


def _cases(cls):
    return [n for n in vars(cls) if n.startswith("test_")]


@pytest.mark.parametrize("cls,name", [(c, n) for c in ("TestHelpEscaping", "TestTenantTracker", "TestTenantsReport")
                                      for n in _cases(getattr(jtests, c))])
def test_the_module_cases_as_written(side, cls, name):
    getattr(getattr(jtests, cls)(), name)()


def test_the_churn_storm_as_written(side):
    jtests.TestTenantsSmoke().test_churn_storm_keeps_k_plus_other()


@pytest.mark.parametrize("env", [{"TPU_RAG_TENANT_TOP_K": "0"}, {"TPU_RAG_TENANT_TOP_K": "nope"},
                                 {"TPU_RAG_TENANTS": "maybe"}])
def test_the_config_cases_as_written(side, env):
    cases = jtests.TestTenantConfig()
    cases.test_defaults_on()
    cases.test_env_round_trip()
    cases.test_invalid_values_raise(env)


def _tracker_run(metrics):
    reg = metrics.MetricsRegistry()
    fam = reg.labeled_counter("rag_tenant_http_requests_total", "x")
    trk = metrics.TenantTracker(top_k=3)
    trk.bind(fam)
    out = []
    for i in range(400):
        name = f"t{(i * 7) % 11}" if i % 5 else f"hot{i % 2}"
        label = trk.intern(name)
        fam.labels(tenant=label, code="200").inc()
        out.append(label)
        if i % 50 == 0:
            trk.prune()
    trk.prune()
    return out, trk.tracked(), trk.snapshot(), sorted(labels for labels, _ in fam.items()), reg.render_prometheus()


def test_one_intern_sequence_gives_the_jax_labels_bound_and_scrape():
    assert _tracker_run(tmetrics) == _tracker_run(jmetrics)


def test_one_journal_gives_the_jax_report():
    evs = []
    for i in range(30):
        tn = ("a", "b", "c", None)[i % 4]
        arr = {"seq": 4 * i, "t": float(i), "type": "arrival", "rid": i}
        if tn:
            arr["tenant"] = tn
        evs += [arr, {"seq": 4 * i + 1, "t": i + 0.1, "type": "admit", "rid": i},
                {"seq": 4 * i + 2, "t": i + 0.5, "type": "complete", "rid": i, "n_tokens": i % 7,
                 "chip_ms": 10.0 * i, **({"cost_usd": 0.001 * i} if i % 3 else {})},
                {"seq": 4 * i + 3, "t": i + 0.6, "type": "shed", "tenant": tn or "anon", "reason": "queue_full"}]
    evs.append({"seq": 999, "t": 40.0, "type": "shadow_audit", "rid": 2, "outcome": "diverged"})
    for price in (0.0, 3.6):
        got = ttenants.render_report(ttenants.state_from_events(evs), chip_hour_usd=price)
        assert got == jtenants.render_report(jtenants.state_from_events(evs), chip_hour_usd=price)
    assert (ttenants.SCHEMA_VERSION, ttenants.OTHER, ttenants.DEFAULT_TENANT) == \
        (jtenants.SCHEMA_VERSION, jtenants.OTHER, jtenants.DEFAULT_TENANT)


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


def test_three_tenants_conserve_chip_time_through_the_paged_scheduler():
    params = init_llama_params(jax.random.PRNGKey(0), pairs_mod.JLlamaConfig.tiny(), pairs_mod.JFP32)
    model = convert.load_llama(build_llama(LlamaConfig.tiny(), pairs_mod.FP32, "cpu"), convert.flatten_tree(params))
    ec = EngineConfig(prompt_buckets=(16, 32), max_batch_size=4, max_seq_len=128, kv_paged=True, kv_block_size=16,
                      decode_sync_steps=4)
    eng = ContinuousEngine(LlamaConfig.tiny(), model, SamplingConfig(do_sample=False, max_new_tokens=8), ec,
                           pairs_mod.FP32, "cpu")
    sched = ContinuousScheduler(eng)
    prompts = [[3, 17, 42, 7], [5, 5, 8], [11] * 12, [2, 9], [4] * 20, [7, 8, 9, 10, 11, 12]]
    tenants = ["a", "b", "c", "a", "b", "c"]
    try:
        outs = [None] * len(prompts)

        def run(i):
            outs[i] = sched.submit(prompts[i], timeout=120, tenant=tenants[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(o is not None for o in outs)
        rolls = eng.ledger.tenant_state()
        assert set(rolls) == {"a", "b", "c"}
        for r in rolls.values():
            assert r["requests"] == 2 and r["chip_s"] > 0 and 0.0 < r["goodput_frac"] <= 1.0
        total, busy = sum(r["chip_s"] for r in rolls.values()), sched.busy_seconds()
        assert busy > 0 and abs(total - busy) / busy < 0.05, (total, busy)
    finally:
        sched.shutdown()


# ---------------------------------------------------------------------------
# services
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    p = pairs_mod._make_pair("continuous")
    yield p
    for svc, _ in p.values():
        svc.shutdown()


def test_debug_tenants_counts_match_jax(pair, monkeypatch):
    monkeypatch.setenv("TPU_RAG_FAULTS", "1")
    for svc, _ in pair.values():
        svc.flight.clear()
    for tn, q in (("pair-x", "alpha"), ("pair-y", "delta"), ("pair-x", "alpha beta")):
        for side, (_, client) in pair.items():
            r = pairs_mod._post(side, client, "/generate", {"prompt": q, "tenant_id": tn})
            assert r.status_code == 200
    got = {side: client.get("/debug/tenants") for side, (_, client) in pair.items()}
    assert [r.status_code for r in got.values()] == [200, 200]
    body = {side: r.get_json() for side, r in got.items()}
    assert sorted(body["port"]) == sorted(body["jax"])

    def counts(b):
        return {r["tenant"]: {k: r[k] for k in ("arrivals", "admitted", "completed", "sheds", "tokens")}
                for r in b["report"]["tenants"]}

    # the port's flight journal is its own: the JAX recorder is another ring
    assert counts(body["port"]) == counts(body["jax"])
    assert counts(body["port"])["pair-x"]["completed"] == 2

    def mine(d):  # this test's tenants (the service cases share the port service)
        return {t: v for t, v in d.items() if t.startswith("pair-")}

    assert mine(body["port"]["tracker"]["counts"]) == mine(body["jax"]["tracker"]["counts"])
    assert body["port"]["tracker"]["top_k"] == body["jax"]["tracker"]["top_k"]
    assert {t: r["requests"] for t, r in mine(body["port"]["ledger"]).items()} == \
        {t: r["requests"] for t, r in mine(body["jax"]["ledger"]).items()} == {"pair-x": 2.0, "pair-y": 1.0}
    assert {t: [e["name"] for e in v] for t, v in mine(body["port"]["slo"]).items()} == \
        {t: [e["name"] for e in v] for t, v in mine(body["jax"]["slo"]).items()}
    # the tenants' chip seconds in the scrape are their requests' attribution
    port = pair["port"][0]
    chip = sum(c.value for _, c in port.metrics.get_family("rag_tenant_chip_seconds_total").items())
    assert chip == pytest.approx(sum(r["chip_s"] for r in port._tenant_ledger_rollups().values()), rel=1e-6)


@pytest.fixture
def tenant_service(pair):
    """``tests/test_tenants.py``'s ``tenant_service`` on the port: a
    continuous service with tenants on (top 8), spooling into a temporary
    directory."""
    return pair["port"][0]


@pytest.mark.parametrize("name", _cases(jtests.TestTenantService))
def test_the_service_cases_as_written_on_the_port(tenant_service, monkeypatch, name):
    monkeypatch.setattr(jtests, "create_app", _port_create_app)
    getattr(jtests.TestTenantService(), name)(tenant_service, monkeypatch)


def test_a_saved_journal_renders_the_live_report(pair, monkeypatch, tmp_path):
    monkeypatch.setenv("TPU_RAG_FAULTS", "1")
    svc, client = pair["port"]
    for tn in ("smoke-a", "smoke-b", "smoke-a"):
        assert client.post("/generate", json_body={"prompt": "alpha", "tenant_id": tn}).status_code == 200
    live = client.get("/debug/tenants").get_json()["report"]
    path = str(tmp_path / "journal.json")
    tflight.export_journal(path, events=svc.flight.snapshot())
    saved = ttenants.render_report(ttenants.state_from_events(tflight.load_journal(path)),
                                   chip_hour_usd=svc._goodput_price())
    assert json.dumps(saved, sort_keys=True) == json.dumps(live, sort_keys=True)


def test_a_service_with_tenants_off_interns_nothing(pair, monkeypatch):
    svc, client = pair["port"]
    monkeypatch.setattr(svc, "config", dataclasses.replace(svc.config, tenants=dataclasses.replace(
        svc.config.tenants, enabled=False)))
    monkeypatch.setattr(svc, "tenants_enabled", False)
    before = svc.tenant_tracker.snapshot()["table_size"]
    r = client.post("/generate", json_body={"prompt": "alpha", "tenant_id": "nobody"})
    assert r.status_code == 200
    assert svc.tenant_tracker.snapshot()["table_size"] == before
