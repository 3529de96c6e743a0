"""The port's incident spool against the JAX package's, on the CPU.

- **as written**: ``tests/test_flight.py``'s ``TestIncidentSpooler`` cases
  run unchanged, once on the JAX ``obs/flight.py`` and once with the port's
  ``obs/flight.py`` and ``AppConfig`` in their place; the trigger catalog
  is the JAX one;
- **the service pair** (``tests/test_torch_resilience.py``'s, shared tiny
  weights, each side spooling into a temporary directory): the debug routes
  of this slice (``/debug/incidents`` with and without ``?id=``,
  ``/debug/goodput``, ``/debug/tenants``) answer the JAX status codes
  unarmed, armed by ``TPU_RAG_FAULTS`` and armed read-only by
  ``TPU_RAG_DEBUG``; a 504 spools a ``deadline_exceeded`` bundle on both
  sides, a second one inside the cooldown is suppressed, and the bundle
  loads through ``?id=`` with the JAX keys; a reset storm spools
  ``reset_storm`` and ``breaker_open`` bundles whose journal holds the
  resets; a pool-exhaustion shed spools ``pool_exhausted_shed``; the drain
  coordinator's incident hook is the service's.
"""

import dataclasses

import pytest
import test_flight as jtests  # the JAX flight tests, run as written on the port below
import test_torch_resilience as pairs_mod  # the JAX/port service pair on shared weights

from rag_llm_k8s_tpu.obs import flight as jflight
from rag_llm_k8s_tpu.resilience import faults as jfaults
from rag_llm_k8s_tpu_torch.core.config import AppConfig
from rag_llm_k8s_tpu_torch.obs import flight as tflight
from rag_llm_k8s_tpu_torch.resilience import faults as tfaults
from rag_llm_k8s_tpu_torch.resilience.admission import AdmissionRejected

FAULTS = {"jax": jfaults, "port": tfaults}
BUNDLE_KEYS = {"schema_version", "trigger", "ts", "id", "journal", "metrics", "config_fingerprint", "traces", "meta"}


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in FAULTS.values():
        f.clear()
    yield
    for f in FAULTS.values():
        f.clear()


@pytest.fixture(params=["jax", "port"])
def side(request, monkeypatch):
    """Which package the as-written tests run on: the port's modules take
    the JAX modules' names in ``tests/test_flight.py`` for the test."""
    if request.param == "port":
        monkeypatch.setattr(jtests, "flight", tflight)
        monkeypatch.setattr(jtests, "AppConfig", AppConfig)
    return request.param


@pytest.mark.parametrize("name", [n for n in vars(jtests.TestIncidentSpooler) if n.startswith("test_")])
def test_the_spooler_cases_as_written(side, name, tmp_path):
    fn = getattr(jtests.TestIncidentSpooler(), name)
    fn(tmp_path) if "tmp_path" in fn.__code__.co_varnames[: fn.__code__.co_argcount] else fn()


def test_the_trigger_catalog_is_the_jax_one():
    assert tflight.TRIGGERS == jflight.TRIGGERS


@pytest.fixture(scope="module")
def pair():
    p = pairs_mod._make_pair("continuous", resilience={"breaker_reset_threshold": 2})
    yield p
    for svc, _ in p.values():
        svc.shutdown()


def _codes(pair, path):
    return {side: client.get(path).status_code for side, (_, client) in pair.items()}


def _set_debug(pair, monkeypatch, on: bool):
    for svc, _ in pair.values():
        flight = dataclasses.replace(svc.config.flight, debug_endpoints=on)
        monkeypatch.setattr(svc, "config", dataclasses.replace(svc.config, flight=flight))


ROUTES = ("/debug/incidents", "/debug/incidents?id=nope", "/debug/goodput", "/debug/tenants")


def test_the_debug_routes_answer_the_jax_codes(pair, monkeypatch):
    monkeypatch.delenv("TPU_RAG_FAULTS", raising=False)
    for path in ROUTES:
        assert _codes(pair, path) == {"jax": 403, "port": 403}, path
    assert _codes(pair, "/slo") == {"jax": 200, "port": 200}
    # TPU_RAG_DEBUG=1 arms the read-only routes, never fault arming
    _set_debug(pair, monkeypatch, True)
    for path, code in zip(ROUTES, (200, 404, 200, 200)):
        assert _codes(pair, path) == {"jax": code, "port": code}, path
    assert _codes(pair, "/debug/faults") == {"jax": 403, "port": 403}
    _set_debug(pair, monkeypatch, False)
    monkeypatch.setenv("TPU_RAG_FAULTS", "1")
    for path, code in zip(ROUTES, (200, 404, 200, 200)):
        assert _codes(pair, path) == {"jax": code, "port": code}, path


def _triggers(svc):
    return sorted(b["trigger"] for b in svc.incidents.list())


def test_a_504_spools_one_deadline_bundle_per_cooldown(pair, monkeypatch):
    monkeypatch.setenv("TPU_RAG_FAULTS", "1")
    for _ in range(2):  # the second inside the 30 s cooldown is suppressed
        for side, (_, client) in pair.items():
            r = pairs_mod._post(side, client, "/generate", {"prompt": "alpha", "deadline_ms": 0.001})
            assert r.status_code == 504
    listed = {}
    for side, (svc, client) in pair.items():
        assert _triggers(svc).count("deadline_exceeded") == 1
        listed[side] = client.get("/debug/incidents").get_json()["incidents"]
        assert svc.metrics.get_family("rag_incident_bundles_total").labels(trigger="deadline_exceeded").value == 1
    assert sorted(listed["port"][0]) == sorted(listed["jax"][0])
    bundles = {}
    for side, (_, client) in pair.items():
        bid = next(b["id"] for b in listed[side] if b["trigger"] == "deadline_exceeded")
        r = client.get(f"/debug/incidents?id={bid}")
        assert r.status_code == 200
        bundles[side] = r.get_json()
    assert set(bundles["port"]) == set(bundles["jax"]) == BUNDLE_KEYS
    b = bundles["port"]
    assert b["schema_version"] == tflight.SCHEMA_VERSION and b["trigger"] == "deadline_exceeded"
    assert b["config_fingerprint"]["sha256"] and b["meta"]["engine_mode"] == "continuous"
    assert "rag_deadline_exceeded_total" in str(sorted(b["metrics"]))
    assert isinstance(b["journal"], list) and isinstance(b["traces"], list)


def test_a_reset_storm_spools_its_bundles(pair, monkeypatch):
    monkeypatch.setenv("TPU_RAG_FAULTS", "1")
    for side, (svc, _) in pair.items():
        for prompt in ([3, 17, 42], [5, 5, 8]):
            FAULTS[side].arm("decode_step", times=1)
            assert svc.scheduler.submit(prompt, timeout=120)  # the resubmission serves it
        assert svc.breaker.open  # two resets inside the window
        assert {"reset_storm", "breaker_open"} <= set(_triggers(svc)), side
    for side, (svc, client) in pair.items():
        bid = next(b["id"] for b in svc.incidents.list() if b["trigger"] == "reset_storm")
        bundle = client.get(f"/debug/incidents?id={bid}").get_json()
        assert set(bundle) == BUNDLE_KEYS
        assert bundle["metrics"]["rag_engine_resets_total"] >= 1
        assert any(e["type"] == "reset" for e in bundle["journal"])
    for svc, _ in pair.values():
        svc.breaker._events.clear()  # heal, for the tests after this one


def test_a_pool_exhausted_shed_spools_a_bundle(pair):
    svc, _ = pair["port"]
    gate = svc.admission
    old = (gate.max_concurrency, gate.max_queue, gate.saturation_hint, gate.reclaimable_hint)
    gate.max_concurrency, gate.max_queue = 1, 4
    gate.saturation_hint, gate.reclaimable_hint = (lambda: True), None
    try:
        with gate.admit():
            with pytest.raises(AdmissionRejected) as ei:
                with gate.admit():
                    pass
        assert ei.value.reason == "pool_exhausted"
        assert "pool_exhausted_shed" in _triggers(svc)
    finally:
        gate.max_concurrency, gate.max_queue, gate.saturation_hint, gate.reclaimable_hint = old


def test_the_drain_s_incident_hook_is_the_service_s(pair):
    for svc, _ in pair.values():
        assert svc.lifecycle.incident_hook == svc.record_incident
        assert svc.breaker.on_reset == svc._maybe_reset_storm
        assert svc.admission.incident_hook == svc.record_incident
