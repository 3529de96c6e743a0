"""The port's graceful drain against the JAX package's, on the CPU: the
cases of ``tests/test_lifecycle.py`` that cover the drain (the admission
gate shedding ``draining``, the ``LifecycleCoordinator`` state machine with
an injected clock, sleep and in-flight count, the drain knobs of
``AppConfig.from_env``) on both packages' classes, and the HTTP drain
contract (``POST /drain``, ``/healthz`` and ``?live=1``, the 503 for new
work, the request in flight answered) of the port's app against the JAX
test client. The WAL and the warm restart are held in
``tests/test_torch_wal.py``; the incident spool is not ported
(``ROADMAP.md`` Queue 1 item 9c)."""

import threading
import time
import types

import pytest

from rag_llm_k8s_tpu.core.config import AppConfig as JAppConfig
from rag_llm_k8s_tpu.obs import flight as jflight
from rag_llm_k8s_tpu.resilience import admission as jadmission
from rag_llm_k8s_tpu.resilience import lifecycle as jlifecycle
from rag_llm_k8s_tpu_torch.core.config import AppConfig
from rag_llm_k8s_tpu_torch.obs import flight as tflight
from rag_llm_k8s_tpu_torch.resilience import admission as tadmission
from rag_llm_k8s_tpu_torch.resilience import lifecycle as tlifecycle
from test_torch_main import staged  # noqa: F401 — the tiny staged directory (a fixture)
from test_torch_resilience import FakeClock, _make_pair, _post, _seen, _settle

JAX = types.SimpleNamespace(admission=jadmission, lifecycle=jlifecycle, flight=jflight)
PORT = types.SimpleNamespace(admission=tadmission, lifecycle=tlifecycle, flight=tflight)


@pytest.fixture(autouse=True)
def _empty_recorders():
    yield
    # both recorders are process-wide: leave them empty for the next file
    jflight.recorder().clear()
    tflight.recorder().clear()


@pytest.fixture(params=["jax", "port"])
def m(request):
    return {"jax": JAX, "port": PORT}[request.param]


def test_the_states_are_the_jax_ones():
    assert (tlifecycle.SERVING, tlifecycle.DRAINING, tlifecycle.DRAINED) == (
        jlifecycle.SERVING, jlifecycle.DRAINING, jlifecycle.DRAINED)


# ---------------------------------------------------------------------------
# admission draining
# ---------------------------------------------------------------------------


class TestAdmissionDraining:
    def test_new_requests_shed_503_with_drain_retry_after(self, m):
        gate = m.admission.AdmissionController(max_concurrency=2, max_queue=2)
        gate.drain(retry_after_s=4.5)
        assert gate.draining
        with pytest.raises(m.admission.AdmissionRejected) as ei:
            with gate.admit():
                pass
        assert (ei.value.reason, ei.value.status) == ("draining", 503)
        assert ei.value.retry_after_s == pytest.approx(4.5)

    def test_queued_waiter_is_woken_and_shed(self, m):
        gate = m.admission.AdmissionController(max_concurrency=1, max_queue=4)
        outcome = {}

        def queued():
            try:
                with gate.admit():
                    outcome["admitted"] = True
            except m.admission.AdmissionRejected as e:
                outcome["reason"] = e.reason

        with gate.admit():  # the one slot is taken
            t = threading.Thread(target=queued)
            t.start()
            assert _settle(lambda: gate.waiting == 1)
            gate.drain()  # default retry_after: the gate's own
            t.join(5)
        assert not t.is_alive()
        assert outcome == {"reason": "draining"}
        # draining sheds queued work, never the work already past the gate
        assert gate.active == 0


# ---------------------------------------------------------------------------
# LifecycleCoordinator state machine (injected clock, sleep, in-flight count)
# ---------------------------------------------------------------------------


class TestLifecycleCoordinator:
    def test_clean_drain_runs_persist_then_exit(self, m):
        active = [3]
        calls = []
        lc = m.lifecycle.LifecycleCoordinator(
            deadline_s=10.0, active_fn=lambda: active[0],
            persist_fn=lambda: calls.append("persist"), exit_fn=lambda: calls.append("exit"),
            incident_hook=lambda t: calls.append(("incident", t)),
            clock=FakeClock(), sleep=lambda _dt: active.__setitem__(0, max(0, active[0] - 1)),
        )
        assert lc.state == m.lifecycle.SERVING and not lc.draining
        assert lc.begin_drain("sigterm")
        assert lc.wait_drained(5)
        assert lc.state == m.lifecycle.DRAINED and lc.reason == "sigterm"
        assert not lc.timed_out and lc.stragglers == 0
        assert calls == ["persist", "exit"]  # no incident on a clean pass

    def test_deadline_overrun_abandons_the_stragglers(self, m):
        clk = FakeClock()
        calls = []
        lc = m.lifecycle.LifecycleCoordinator(
            deadline_s=1.0, active_fn=lambda: 2,  # wedged forever
            persist_fn=lambda: calls.append("persist"), exit_fn=lambda: calls.append("exit"),
            incident_hook=lambda t: calls.append(("incident", t)),
            clock=clk, sleep=lambda _dt: clk.advance(0.5),
        )
        assert lc.begin_drain("http")
        assert lc.wait_drained(5)
        assert lc.timed_out and lc.stragglers == 2
        assert calls == [("incident", "drain_timeout"), "persist", "exit"]

    def test_begin_drain_is_idempotent_first_reason_wins(self, m):
        lc = m.lifecycle.LifecycleCoordinator(deadline_s=5.0, active_fn=lambda: 0, clock=FakeClock(),
                                              sleep=lambda _dt: None)
        assert lc.begin_drain("sigterm")
        assert not lc.begin_drain("http")  # the preStop hook racing SIGTERM
        assert lc.reason == "sigterm"
        assert lc.wait_drained(5)

    def test_drain_flips_the_admission_gate(self, m):
        gate = m.admission.AdmissionController(max_concurrency=2, max_queue=2)
        lc = m.lifecycle.LifecycleCoordinator(admission=gate, deadline_s=5.0, retry_after_s=2.5,
                                              clock=FakeClock(), sleep=lambda _dt: None)
        assert lc.begin_drain()
        assert gate.draining
        with pytest.raises(m.admission.AdmissionRejected) as ei:
            with gate.admit():
                pass
        assert ei.value.retry_after_s == pytest.approx(2.5)
        assert lc.wait_drained(5)

    def test_the_gate_is_the_default_in_flight_count(self, m):
        gate = m.admission.AdmissionController(max_concurrency=2, max_queue=2)
        lc = m.lifecycle.LifecycleCoordinator(admission=gate, deadline_s=30.0, poll_interval_s=0.01)
        with gate.admit():
            assert lc.begin_drain()
            assert not lc.wait_drained(0.2)  # the request in flight holds it
            assert lc.state == m.lifecycle.DRAINING
        assert lc.wait_drained(5) and not lc.timed_out

    def test_broken_active_fn_cannot_stall_exit(self, m):
        def boom():
            raise RuntimeError("probe died")

        lc = m.lifecycle.LifecycleCoordinator(deadline_s=5.0, active_fn=boom, clock=FakeClock(),
                                              sleep=lambda _dt: None)
        assert lc.begin_drain()
        assert lc.wait_drained(5)  # treated as 0 in flight

    def test_events_journaled(self, m):
        m.flight.configure(enabled=True)
        m.flight.recorder().clear()
        lc = m.lifecycle.LifecycleCoordinator(deadline_s=5.0, active_fn=lambda: 0, clock=FakeClock(),
                                              sleep=lambda _dt: None)
        lc.begin_drain("sigterm")
        lc.wait_drained(5)
        evs = m.flight.recorder().snapshot(etype="drain")
        assert [(e["phase"], e.get("reason")) for e in evs] == [("begin", "sigterm"), ("complete", None)]


def test_drain_knobs_round_trip_like_jax():
    env = {"TPU_RAG_DRAIN_DEADLINE_S": "12.5", "TPU_RAG_DRAIN_RETRY_AFTER_S": "0.5"}
    for C in (AppConfig, JAppConfig):
        res = C.from_env(env).resilience
        assert (res.drain_deadline_s, res.drain_retry_after_s) == (12.5, 0.5)
    msgs = []
    for C in (AppConfig, JAppConfig):
        with pytest.raises(ValueError, match="DRAIN_DEADLINE_S") as ei:
            C.from_env({"TPU_RAG_DRAIN_DEADLINE_S": "0"})
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the HTTP drain contract, against the JAX test client
# ---------------------------------------------------------------------------


def test_drain_sheds_new_work_while_the_request_in_flight_completes():
    pair = _make_pair(None, resilience=dict(drain_deadline_s=30.0, drain_retry_after_s=3.0))
    release = threading.Event()
    results, threads, exits = {}, [], {}
    try:
        for side, (svc, client) in pair.items():
            exits[side] = []
            svc.lifecycle.exit_fn = lambda side=side: exits[side].append("exit")
            orig = svc.answer

            def slow_answer(*a, orig=orig, **k):
                body = orig(*a, **k)
                release.wait(30)
                return body

            svc.answer = slow_answer
            t = threading.Thread(target=lambda side=side, client=client: results.__setitem__(
                side, _seen(_post(side, client, "/generate", {"prompt": "alpha"}))))
            t.start()
            threads.append(t)
            assert _settle(lambda svc=svc: svc.admission.active == 1)

        def both(fn):
            got = {side: fn(side, client) for side, (_, client) in pair.items()}
            assert got["port"] == got["jax"], got
            return got["port"]

        drain = both(lambda side, c: _seen(_post(side, c, "/drain")))
        assert drain == (202, {"state": "draining", "started": True, "active": 1, "deadline_s": 30.0}, None)
        again = both(lambda side, c: _seen(_post(side, c, "/drain")))
        assert again[0] == 200 and again[1]["started"] is False

        def health(path):
            def get(side, c):
                r = c.get(path)
                body = r.get_json()
                return r.status_code, {k: body[k] for k in ("status", "ready", "draining", "breaker_open")}
            return get

        assert both(health("/healthz")) == (
            503, {"status": "draining", "ready": False, "draining": True, "breaker_open": False})
        assert both(health("/healthz?live=1"))[:2] == (
            200, {"status": "alive", "ready": False, "draining": True, "breaker_open": False})
        assert both(lambda side, c: _seen(_post(side, c, "/generate", {"prompt": "alpha"}))) == (
            503, {"error": "server draining", "reason": "draining", "retry_after_s": 3.0}, "3")

        release.set()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert results["port"] == results["jax"] and results["port"][0] == 200
        for side, (svc, _) in pair.items():
            assert svc.lifecycle.wait_drained(10)
            assert svc.lifecycle.state == "drained" and not svc.lifecycle.timed_out
            assert exits[side] == ["exit"]
    finally:
        release.set()
        for svc, _ in pair.values():
            svc.shutdown()


def test_a_drain_that_overruns_its_deadline_abandons_the_straggler():
    pair = _make_pair(None, resilience=dict(drain_deadline_s=0.3))
    try:
        for svc, _ in pair.values():
            t0 = time.monotonic()
            with svc.admission.admit():  # wedged in-flight work
                assert svc.lifecycle.begin_drain("http")
                assert svc.lifecycle.wait_drained(10)
            assert svc.lifecycle.timed_out and svc.lifecycle.stragglers == 1
            assert time.monotonic() - t0 < 5.0
    finally:
        for svc, _ in pair.values():
            svc.shutdown()


# ---------------------------------------------------------------------------
# SIGTERM on the entry point
# ---------------------------------------------------------------------------

# ``server.main.main()`` in a subprocess on the CPU over the tiny staged
# directory; its one fused generate is held for a second, so a request is in
# flight when the signal lands
MAIN = """
import dataclasses, os, time
from rag_llm_k8s_tpu_torch.core.config import AppConfig, DTypePolicy, EncoderConfig, RetrievalConfig
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.server import main as m

cfg = dataclasses.replace(AppConfig.from_env(), dtypes=DTypePolicy.fp32(), encoder=EncoderConfig.tiny(512),
                          retrieval=RetrievalConfig(embed_dim=32))
real_rag = InferenceEngine.generate_rag

def held(self, *a, **k):
    time.sleep(1.0)
    return real_rag(self, *a, **k)

InferenceEngine.generate_rag = held
build = m.build_service
m.build_service = lambda: build(cfg, device="cpu")
m.main()
"""


def test_sigterm_drains_server_main_with_a_request_in_flight(staged, tmp_path):
    import json
    import os
    import signal
    import socket
    import subprocess
    import sys
    import urllib.request

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "MODEL_PATH": staged, "TPU_RAG_PDF_DIR": os.path.join(staged, "pdfs"),
           "TPU_RAG_PORT": str(port), "TPU_RAG_LOG_LEVEL": "INFO", "TPU_RAG_INDEX_PATH": str(tmp_path / "index"),
           "TPU_RAG_MAX_NEW_TOKENS": "8", "TPU_RAG_DO_SAMPLE": "0"}
    log_path = tmp_path / "main.log"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def http(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())

    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", MAIN], env=env, cwd=repo, stdout=log,
                                stderr=subprocess.STDOUT)
    try:
        def ready():
            try:
                return http("/healthz")[1].get("status") == "ok"
            except OSError:
                return proc.poll() is not None

        assert _settle(ready, timeout=120) and proc.poll() is None, log_path.read_text()
        result = []
        th = threading.Thread(target=lambda: result.append(http("/generate", {"prompt": "what do kernels tile?"})))
        th.start()
        time.sleep(0.3)  # admitted, and held in its generate
        proc.send_signal(signal.SIGTERM)
        th.join(60)
        rc = proc.wait(timeout=40)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    logged = log_path.read_text()
    assert rc == 0, logged
    assert result and result[0][0] == 200 and "Document '" in result[0][1]["context"], (result, logged)
    assert "drain began (reason=sigterm, in_flight=1" in logged and "drained: exiting" in logged, logged
    assert "resilience: admission 16 concurrent + 64 queued" in logged
