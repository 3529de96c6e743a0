"""The port's resilience layer against the JAX package's, on the CPU.

- **unit parity**: the cases of ``tests/test_resilience.py`` for the fault
  harness, deadlines, the breaker, the admission gate with its fair-share
  rule, and the tenant interner, each run on the JAX class and on the port's
  with the same inputs and an injected clock;
- **scheduler parity**: the same tiny fp32 weights (``models/convert.py``)
  behind JAX's ``ContinuousScheduler`` and the port's, one burst each, with
  a planted ``decode_step`` fault, an ``insert`` fault, a second fault that
  uses up the retries, and a deadline that runs out mid-decode: greedy
  streams identical on both sides and to the unfaulted run, the same chain
  of flight events per request (``complete.stream_fnv`` included), and no
  block left in use;
- **HTTP parity**: status codes, JSON bodies (timings and request ids left
  out) and ``Retry-After`` of the port's WSGI app against the JAX test
  client for the same request sequences, under ``batching="coalesce"`` and
  ``"continuous"``.
"""

import collections
import dataclasses
import tempfile
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.core.config import AppConfig as JAppConfig
from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
from rag_llm_k8s_tpu.core.config import EncoderConfig as JEncoderConfig
from rag_llm_k8s_tpu.core.config import EngineConfig as JEngineConfig
from rag_llm_k8s_tpu.core.config import FlightConfig as JFlightConfig
from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
from rag_llm_k8s_tpu.core.config import ResilienceConfig as JResilienceConfig
from rag_llm_k8s_tpu.core.config import SamplingConfig as JSampling
from rag_llm_k8s_tpu.core.config import ShadowConfig as JShadowConfig
from rag_llm_k8s_tpu.engine import continuous as jcontinuous
from rag_llm_k8s_tpu.engine.batching import BatchScheduler as JBatchScheduler
from rag_llm_k8s_tpu.engine.encoder import EncoderRunner as JEncoderRunner
from rag_llm_k8s_tpu.engine.engine import InferenceEngine as JEngine
from rag_llm_k8s_tpu.index.store import VectorStore as JStore
from rag_llm_k8s_tpu.models.bge_m3 import init_encoder_params
from rag_llm_k8s_tpu.models.llama import init_llama_params
from rag_llm_k8s_tpu.obs import flight as jflight
from rag_llm_k8s_tpu.obs import metrics as jmetrics
from rag_llm_k8s_tpu.resilience import admission as jadmission
from rag_llm_k8s_tpu.resilience import breaker as jbreaker
from rag_llm_k8s_tpu.resilience import deadline as jdeadline
from rag_llm_k8s_tpu.resilience import faults as jfaults
from rag_llm_k8s_tpu.server.app import RagService as JRagService
from rag_llm_k8s_tpu.server.app import create_app as jcreate_app
from rag_llm_k8s_tpu_torch.core.config import (
    AppConfig,
    DTypePolicy,
    EncoderConfig,
    EngineConfig,
    FlightConfig,
    LlamaConfig,
    ResilienceConfig,
    SamplingConfig,
    ShadowConfig,
)
from rag_llm_k8s_tpu_torch.engine import continuous as tcontinuous
from rag_llm_k8s_tpu_torch.engine.batching import BatchScheduler
from rag_llm_k8s_tpu_torch.engine.encoder import EncoderRunner
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.index.store import VectorStore
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.bge_m3 import build_encoder
from rag_llm_k8s_tpu_torch.models.llama import build_llama
from rag_llm_k8s_tpu_torch.obs import flight as tflight
from rag_llm_k8s_tpu_torch.obs import metrics as tmetrics
from rag_llm_k8s_tpu_torch.resilience import admission as tadmission
from rag_llm_k8s_tpu_torch.resilience import breaker as tbreaker
from rag_llm_k8s_tpu_torch.resilience import deadline as tdeadline
from rag_llm_k8s_tpu_torch.resilience import faults as tfaults
from rag_llm_k8s_tpu_torch.server import app as tapp

CPU = torch.device("cpu")
FP32 = DTypePolicy.fp32()
JFP32 = JDTypes.fp32()

JAX = types.SimpleNamespace(
    name="jax", faults=jfaults, Deadline=jdeadline.Deadline, DeadlineExceeded=jdeadline.DeadlineExceeded,
    CircuitBreaker=jbreaker.CircuitBreaker, AdmissionController=jadmission.AdmissionController,
    AdmissionRejected=jadmission.AdmissionRejected, TenantTracker=jmetrics.TenantTracker, flight=jflight,
    continuous=jcontinuous,
)
PORT = types.SimpleNamespace(
    name="port", faults=tfaults, Deadline=tdeadline.Deadline, DeadlineExceeded=tdeadline.DeadlineExceeded,
    CircuitBreaker=tbreaker.CircuitBreaker, AdmissionController=tadmission.AdmissionController,
    AdmissionRejected=tadmission.AdmissionRejected, TenantTracker=tmetrics.TenantTracker, flight=tflight,
    continuous=tcontinuous,
)
SIDES = {"jax": JAX, "port": PORT}


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()
    # both recorders are process-wide: leave them empty for the next file
    jflight.recorder().clear()
    tflight.recorder().clear()


@pytest.fixture(params=sorted(SIDES))
def m(request):
    return SIDES[request.param]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Family:
    """A stand-in for a labeled counter family: counts ``labels(...).inc()``."""

    def __init__(self):
        self.n = collections.Counter()

    def labels(self, **kw):
        fam, key = self, tuple(sorted(kw.items()))
        return types.SimpleNamespace(inc=lambda v=1: fam.n.update({key: v}))


def _settle(cond, timeout=10.0):
    end = time.monotonic() + timeout
    while not cond() and time.monotonic() < end:
        time.sleep(0.005)
    return cond()


# ---------------------------------------------------------------------------
# unit parity: the cases of tests/test_resilience.py on both packages' classes
# ---------------------------------------------------------------------------


def test_the_catalogs_are_the_jax_ones():
    assert tfaults.SITES == jfaults.SITES
    assert tflight.EVENTS == jflight.EVENTS and tflight.SCHEMA_VERSION == jflight.SCHEMA_VERSION
    assert tdeadline.STAGES == jdeadline.STAGES
    for toks in ([], [1], [3, 17, 42, 128009], list(range(300))):
        assert tflight.stream_hash(toks) == jflight.stream_hash(toks)


class TestFaults:
    def test_count_based_arming_fires_exactly_n_times(self, m):
        m.faults.arm("embed", times=2)
        for _ in range(2):
            with pytest.raises(m.faults.InjectedFault) as ei:
                m.faults.maybe_fail("embed")
            assert ei.value.site == "embed"
            assert str(ei.value) == "injected fault at site 'embed'"
        m.faults.maybe_fail("embed")  # disarmed: no-op
        assert m.faults.armed() == {}

    def test_unknown_site_is_loud(self, m):
        with pytest.raises(ValueError, match="unknown fault site"):
            # the bad name is the point here  # ragcheck: disable=FAULT-SITE-REGISTRY
            m.faults.arm("definitely_not_a_site")
        with pytest.raises(ValueError, match="expected >= 1"):
            m.faults.arm("embed", times=0)

    def test_arm_from_env(self, m):
        assert m.faults.arm_from_env({"TPU_RAG_FAULTS": "decode_step:2, embed"}) == {"decode_step": 2, "embed": 1}
        m.faults.clear()
        assert m.faults.arm_from_env({"TPU_RAG_FAULTS": "1"}) == {}
        assert m.faults.arm_from_env({}) == {}
        with pytest.raises(ValueError, match="unknown fault site"):
            m.faults.arm_from_env({"TPU_RAG_FAULTS": "tpyo:1"})
        with pytest.raises(ValueError, match="bad count"):
            m.faults.arm_from_env({"TPU_RAG_FAULTS": "embed:x"})

    def test_endpoint_enabled_tracks_env_presence(self, m):
        assert m.faults.endpoint_enabled({"TPU_RAG_FAULTS": ""})
        assert not m.faults.endpoint_enabled({})


class TestDeadline:
    def test_expiry_and_check(self, m):
        clk = FakeClock()
        dl = m.Deadline(100.0, clock=clk)
        assert not dl.expired()
        assert dl.remaining() == pytest.approx(0.1)
        dl.check("retrieve")
        clk.advance(0.2)
        assert dl.expired()
        with pytest.raises(m.DeadlineExceeded) as ei:
            dl.check("assemble")
        assert ei.value.stage == "assemble" and ei.value.budget_ms == 100.0
        assert str(ei.value) == "request deadline exceeded at stage 'assemble' (budget 100 ms)"
        assert isinstance(ei.value, TimeoutError)
        assert dl.wait_timeout() > 0  # floored, never a negative wait

    def test_invalid_budget(self, m):
        for bad in (0, -1.0):
            with pytest.raises(ValueError):
                m.Deadline(bad)


class TestBreaker:
    def test_opens_at_threshold_and_self_heals(self, m):
        clk = FakeClock()
        b = m.CircuitBreaker(threshold=3, window_s=100.0, clock=clk)
        opened = []
        b.on_open = lambda: opened.append(clk())
        b.record_reset()  # t=0
        clk.advance(10.0)
        b.record_reset()  # t=10
        assert not b.open and b.retry_after_s() == 0.0
        clk.advance(10.0)
        b.record_reset()  # t=20: the third inside the window
        assert b.open and b.recent_resets() == 3 and opened == [20.0]
        assert b.retry_after_s() == pytest.approx(80.0)
        clk.advance(60.0)
        assert b.retry_after_s() == pytest.approx(20.0)
        clk.advance(21.0)  # t=101: the t=0 reset left the window
        assert not b.open and b.recent_resets() == 2

    def test_validation(self, m):
        with pytest.raises(ValueError):
            m.CircuitBreaker(threshold=0)
        with pytest.raises(ValueError):
            m.CircuitBreaker(window_s=0)


class TestAdmission:
    def test_queue_cap_rejection_under_concurrent_submits(self, m):
        gate = m.AdmissionController(max_concurrency=2, max_queue=3)
        gate.reject_counter = Family()
        hold = threading.Event()
        outcomes = []
        lock = threading.Lock()

        def run():
            try:
                with gate.admit():
                    hold.wait(timeout=30)
                with lock:
                    outcomes.append("served")
            except m.AdmissionRejected as e:
                with lock:
                    outcomes.append(e.reason)

        threads = [threading.Thread(target=run) for _ in range(10)]
        for t in threads:
            t.start()
        assert _settle(lambda: gate.active == 2 and gate.waiting == 3 and outcomes.count("queue_full") == 5)
        assert gate.queue_depth() == 3
        hold.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert sorted(outcomes) == ["queue_full"] * 5 + ["served"] * 5
        assert gate.reject_counter.n == {(("reason", "queue_full"), ("tenant", "__other__")): 5}
        assert gate.active == 0 and gate.waiting == 0

    def test_fair_share_displaces_the_hog_tenants_newest_waiter(self, m):
        gate = m.AdmissionController(max_concurrency=2, max_queue=2)
        gate.reject_counter = Family()
        hold = threading.Event()
        outcomes = []
        lock = threading.Lock()

        def run(tenant):
            try:
                with gate.admit(tenant=tenant):
                    hold.wait(timeout=30)
                with lock:
                    outcomes.append((tenant, "served"))
            except m.AdmissionRejected as e:
                with lock:
                    outcomes.append((tenant, e.reason))

        hogs = [threading.Thread(target=run, args=("hog",)) for _ in range(4)]
        for t in hogs:
            t.start()
        assert _settle(lambda: gate.active == 2 and gate.waiting == 2)
        small = threading.Thread(target=run, args=("small",))
        small.start()
        assert _settle(lambda: ("hog", "fair_share") in outcomes)
        hold.set()
        for t in hogs + [small]:
            t.join(timeout=30)
        assert ("small", "served") in outcomes
        assert outcomes.count(("hog", "fair_share")) == 1 and outcomes.count(("hog", "served")) == 3
        assert gate.reject_counter.n == {(("reason", "fair_share"), ("tenant", "hog")): 1}
        assert gate.active == 0 and gate.waiting == 0

    def test_over_share_arrival_cannot_displace(self, m):
        gate = m.AdmissionController(max_concurrency=2, max_queue=2)
        hold = threading.Event()
        errs = []

        def run():
            try:
                with gate.admit(tenant="hog"):
                    hold.wait(timeout=30)
            except m.AdmissionRejected as e:
                errs.append(e.reason)

        hogs = [threading.Thread(target=run) for _ in range(4)]
        for t in hogs:
            t.start()
        assert _settle(lambda: gate.active == 2 and gate.waiting == 2)
        with pytest.raises(m.AdmissionRejected) as ei:
            with gate.admit(tenant="hog"):
                pass
        assert ei.value.reason == "queue_full"
        hold.set()
        for t in hogs:
            t.join(timeout=30)
        assert errs == []

    def test_rejection_contract(self, m):
        gate = m.AdmissionController(max_concurrency=1, max_queue=0, retry_after_s=2.5)
        with gate.admit():
            with pytest.raises(m.AdmissionRejected) as ei:
                with gate.admit():
                    pass
        assert (ei.value.status, ei.value.reason, ei.value.retry_after_s) == (429, "queue_full", 2.5)
        assert str(ei.value) == "admission rejected: queue_full"
        with gate.admit():  # the slot was released
            pass

    def test_breaker_open_sheds_everything_with_503(self, m):
        clk = FakeClock()
        b = m.CircuitBreaker(threshold=1, window_s=50.0, clock=clk)
        gate = m.AdmissionController(max_concurrency=8, max_queue=8, breaker=b)
        b.record_reset()
        with pytest.raises(m.AdmissionRejected) as ei:
            with gate.admit():
                pass
        assert (ei.value.status, ei.value.reason, ei.value.retry_after_s) == (503, "breaker_open", 50.0)
        clk.advance(51.0)  # the breaker heals, the gate admits again
        with gate.admit():
            pass

    def test_pool_saturation_sheds_would_be_waiters(self, m):
        gate = m.AdmissionController(max_concurrency=1, max_queue=4)
        gate.saturation_hint = lambda: True
        with gate.admit():  # under the cap: runs even with a dry pool
            with pytest.raises(m.AdmissionRejected) as ei:
                with gate.admit():
                    pass
        assert (ei.value.status, ei.value.reason) == (429, "pool_exhausted")

    def test_deadline_expiry_while_queued(self, m):
        gate = m.AdmissionController(max_concurrency=1, max_queue=4)
        clk = FakeClock()
        dl = m.Deadline(50.0, clock=clk)
        clk.advance(1.0)
        with gate.admit():
            with pytest.raises(m.DeadlineExceeded) as ei:
                with gate.admit(deadline=dl):
                    pass
        assert ei.value.stage == "queue"
        assert gate.waiting == 0


def test_tenant_tracker_interns_like_jax():
    rng = np.random.default_rng(7)
    names = [f"t{int(i)}" for i in rng.zipf(1.5, size=400) % 40] + ["__other__", "t1"]
    outs = []
    for side in (JAX, PORT):
        tr = side.TenantTracker(top_k=3, capacity=8)
        outs.append(([tr.intern(n) for n in names], tr.tracked()))
    assert outs[0] == outs[1]
    assert all(o in (n, "__other__") for n, o in zip(names, outs[1][0]))
    assert len(outs[1][1]) == 3 and "__other__" in outs[1][0]
    with pytest.raises(ValueError):
        PORT.TenantTracker(top_k=0)


# ---------------------------------------------------------------------------
# scheduler parity: planted faults and deadlines, JAX's scheduler and the port's
# ---------------------------------------------------------------------------

GREEDY = dict(do_sample=False, max_new_tokens=10)
PAGED = dict(prompt_buckets=(16, 32), max_batch_size=4, max_seq_len=64, kv_paged=True, kv_block_size=16)
INTER = dict(PAGED, interleave_prefill=True, prefill_chunk_tokens=8)
MODES = {"phase-separated": PAGED, "interleaved": INTER}
PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [12, 13, 14], [3] * 20, [9] * 25]
CHAIN = ("arrival", "admit", "evict", "resubmit", "complete")


@pytest.fixture(scope="module")
def weights():
    params = init_llama_params(jax.random.PRNGKey(0), JLlamaConfig.tiny(), JFP32)
    model = convert.load_llama(build_llama(LlamaConfig.tiny(), FP32, CPU), convert.flatten_tree(params))
    return params, model


def _engine(side, weights, ec):
    params, model = weights
    if side is JAX:
        return jcontinuous.ContinuousEngine(JLlamaConfig.tiny(), params, sampling=JSampling(**GREEDY),
                                            engine_config=JEngineConfig(**ec, attn_impl="xla"), dtypes=JFP32)
    return tcontinuous.ContinuousEngine(LlamaConfig.tiny(), model, SamplingConfig(**GREEDY), EngineConfig(**ec),
                                        FP32, "cpu")


def _chain(side, rid):
    keep = ("outcome", "n_emitted", "n_tokens", "stream_fnv", "prompt_len", "tok0", "max_new")
    return [(e["type"],) + tuple(e.get(k) for k in keep)
            for e in side.flight.recorder().timeline(rid)["events"] if e["type"] in CHAIN]


def run_burst(side, weights, ec, prompts=PROMPTS, *, site=None, times=1, at_window=None, retries=1,
              backoff=0.0, deadlines=None, expire_at_window=None, max_new=10):
    """Submit ``prompts`` to a fresh scheduler as one queue (the dispatcher
    holds its first admission until all are queued, in order). ``site`` is
    armed ``times`` times before the first admission (``at_window`` None)
    or just before window ``at_window`` starts; the deadline clock advances
    by an hour before window ``expire_at_window``. Returns per request
    ``(tokens or (error type, str, stage), flight chain)``, the resets and
    the blocks left in use."""
    side.flight.recorder().clear()
    eng = _engine(side, weights, ec)
    sched = side.continuous.ContinuousScheduler(eng, retries=retries, retry_backoff_s=backoff)
    clock = FakeClock()
    gate, entered = threading.Event(), threading.Event()
    real_state, real_step = eng.admission_state, eng.step
    windows = [0]

    def gated(n):
        entered.set()
        gate.wait(60)
        return real_state(n)

    def counted():
        windows[0] += 1
        if at_window is not None and windows[0] == at_window:
            side.faults.arm(site, times)
        if expire_at_window is not None and windows[0] == expire_at_window:
            clock.advance(3600.0)
        return real_step()

    eng.admission_state, eng.step = gated, counted
    if site is not None and at_window is None:
        side.faults.arm(site, times)
    out, infos = [None] * len(prompts), [{} for _ in prompts]

    def run(i):
        dl = side.Deadline(deadlines[i], clock=clock) if deadlines and deadlines[i] else None
        try:
            out[i] = sched.submit(prompts[i], max_new_tokens=max_new, timeout=120, deadline=dl, info=infos[i])
        except Exception as e:  # noqa: BLE001 — compared below
            out[i] = (type(e).__name__, str(e), getattr(e, "stage", None))

    threads = []
    try:
        for i in range(len(prompts)):
            threads.append(threading.Thread(target=run, args=(i,)))
            threads[-1].start()
            assert _settle(lambda: entered.is_set() and sched._queue.qsize() >= i), "submit did not queue"
        gate.set()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        # the eviction path returns blocks on the dispatcher thread after
        # delivering the error: let it finish the iteration
        assert _settle(lambda: eng.kv_pool.blocks_in_use() == 0 or eng.has_active())
        resets = len(side.flight.recorder().snapshot(etype="reset"))
        return [(o, _chain(side, inf["request_id"])) for o, inf in zip(out, infos)], resets, eng
    finally:
        gate.set()
        sched.shutdown()


def _both(weights, ec, **kw):
    got = {name: run_burst(side, weights, ec, **kw) for name, side in SIDES.items()}
    (jres, jresets, jeng), (tres, tresets, teng) = got["jax"], got["port"]
    assert tres == jres, (tres, jres)
    assert tresets == jresets
    for eng in (jeng, teng):
        assert eng.kv_pool.blocks_in_use() == 0 and not eng.has_active()
    for out, chain in tres:
        if isinstance(out, list):
            assert chain[-1][0] == "complete" and chain[-1][4] == tflight.stream_hash(out)
    return tres, tresets


@pytest.fixture(scope="module")
def unfaulted(weights):
    return {mode: [o for o, _ in run_burst(PORT, weights, ec)[0]] for mode, ec in MODES.items()}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("at_window", [1, 4])
def test_a_decode_fault_resubmits_and_keeps_every_greedy_stream(weights, unfaulted, mode, at_window):
    res, resets = _both(weights, MODES[mode], site="decode_step", at_window=at_window)
    assert resets == 1
    assert [o for o, _ in res] == unfaulted[mode]
    resubmits = [c for _, chain in res for c in chain if c[0] == "resubmit"]
    assert resubmits and all(c[1] == "resubmitted" for c in resubmits)
    if mode == "phase-separated" and at_window == 4:
        # every row had emitted its first token and three more
        assert sorted(c[2] for c in resubmits) == [4, 4, 4, 4]


def test_an_insert_fault_resets_and_restarts_every_request_from_its_prompt(weights, unfaulted):
    res, resets = _both(weights, PAGED, site="insert")
    assert resets == 1
    assert [o for o, _ in res] == unfaulted["phase-separated"]
    for _, chain in res:
        assert [c[0] for c in chain] == ["arrival", "resubmit", "admit", "complete"]
        assert chain[1][1:3] == ("resubmitted", 0)


@pytest.mark.parametrize("site", ["decode_step", "insert"])
def test_a_second_fault_uses_up_the_retries(weights, site):
    res, resets = _both(weights, PAGED, prompts=PROMPTS[:1], site=site, times=2, at_window=None)
    assert resets == 2
    (out, chain), = res
    assert out == ("InjectedFault", f"injected fault at site {site!r}", None) if site == "decode_step" else (
        "EngineStateLost", "insert failed; engine state reset", None)
    assert [c[1] for c in chain if c[0] == "resubmit"] == ["resubmitted", "gave_up"]


def test_no_retries_fails_on_the_first_fault(weights):
    res, resets = _both(weights, PAGED, prompts=PROMPTS[:2], site="decode_step", at_window=2, retries=0)
    assert resets == 1
    assert all(o == ("InjectedFault", "injected fault at site 'decode_step'", None) for o, _ in res)


@pytest.mark.parametrize("mode", MODES)
def test_a_deadline_spent_mid_decode_evicts_the_row(weights, unfaulted, mode):
    res, _ = _both(weights, MODES[mode], deadlines=[1000.0, None, 1000.0, None], expire_at_window=3)
    for i in (0, 2):
        out, chain = res[i]
        assert out == ("DeadlineExceeded", "request deadline exceeded at stage 'decode' (budget 1000 ms)", "decode")
        assert chain[-1][0] == "evict"
    assert [res[i][0] for i in (1, 3)] == [unfaulted[mode][i] for i in (1, 3)]


def test_a_deadline_spent_in_the_queue_never_reaches_the_device(weights):
    for side in (JAX, PORT):
        side.flight.recorder().clear()
        eng = _engine(side, weights, PAGED)
        sched = side.continuous.ContinuousScheduler(eng, retry_backoff_s=0.0)
        clk = FakeClock()
        dl = side.Deadline(10.0, clock=clk)
        clk.advance(1.0)
        try:
            with pytest.raises(side.DeadlineExceeded) as ei:
                sched.submit(PROMPTS[0], timeout=30, deadline=dl)
        finally:
            sched.shutdown()
        assert ei.value.stage == "queue"
        assert not side.flight.recorder().snapshot(etype="admit")
        assert [e["stage"] for e in side.flight.recorder().snapshot(etype="deadline")] == ["queue"]


def test_a_reset_storm_opens_the_breaker(weights):
    for side in (JAX, PORT):
        eng = _engine(side, weights, PAGED)
        sched = side.continuous.ContinuousScheduler(eng, retry_backoff_s=0.0)
        sched.breaker = side.CircuitBreaker(threshold=2, window_s=600.0)
        try:
            for _ in range(2):
                side.faults.arm("decode_step", times=1)
                assert sched.submit(PROMPTS[1], timeout=120)  # recovered each time
        finally:
            sched.shutdown()
        assert sched.breaker.open and sched.breaker.recent_resets() == 2
        assert eng.kv_pool.blocks_in_use() == 0


def test_the_resubmission_waits_a_jittered_backoff(weights, monkeypatch):
    for side in (JAX, PORT):
        slept = []
        clock = types.SimpleNamespace(sleep=slept.append, perf_counter=time.perf_counter, monotonic=time.monotonic)
        monkeypatch.setattr(side.continuous, "time", clock)
        res, resets, _ = run_burst(side, weights, PAGED, prompts=PROMPTS[:1], site="decode_step", at_window=2,
                                   backoff=0.2)
        monkeypatch.undo()
        assert resets == 1 and isinstance(res[0][0], list)
        assert len(slept) == 1 and 0.1 <= slept[0] <= 0.2


# ---------------------------------------------------------------------------
# HTTP parity: the port's app against the JAX test client
# ---------------------------------------------------------------------------

VOCAB = 300
HTTP_ENGINE = dict(prompt_buckets=(128, 256), max_batch_size=2, max_seq_len=384)
SYSTEM = "Answer from the context."
TEXTS = ["alpha beta gamma", "delta epsilon zeta"]


class ByteTokenizer:
    def encode(self, text):
        return [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids, skip_special_tokens=True):
        return bytes((i - 3) % 256 for i in ids if i >= 3).decode("utf-8", "replace")


def _make_pair(mode, resilience=None, continuous=None, shadow=None):
    """The JAX service and the port's on the same weights, one document
    store each, ``batching=mode`` (None: no scheduler); returns ``{"jax":
    (svc, client), "port": ...}``. ``resilience``: ResilienceConfig fields;
    ``continuous``: EngineConfig fields of both continuous engines;
    ``shadow``: ShadowConfig fields of both auditors (default: present, with
    a sample rate of 0, so no random draw audits a request on either side)."""
    sh = dict(sample_rate=0.0) if shadow is None else shadow
    cont = dict(kv_paged=True, **(continuous or {}))
    jl, je = JLlamaConfig.tiny(VOCAB), JEncoderConfig.tiny(VOCAB)
    lc, ec = LlamaConfig.tiny(VOCAB), EncoderConfig.tiny(VOCAB)
    lparams = init_llama_params(jax.random.PRNGKey(0), jl, JFP32)
    eparams = init_encoder_params(jax.random.PRNGKey(1), je, JFP32)
    greedy = dict(do_sample=False, max_new_tokens=8)
    res = dict(retry_backoff_ms=0.0, **(resilience or {}))
    # JAX
    # the JAX service's incident bundles go to a directory of the run's own
    jcfg = JAppConfig(model=jl, encoder=je, system_message=SYSTEM, resilience=JResilienceConfig(**res),
                      flight=JFlightConfig(spool_dir=tempfile.mkdtemp(prefix="jax_incidents_")),
                      shadow=JShadowConfig(**sh))
    jeng = JEngine(jl, lparams, sampling=JSampling(**greedy), engine_config=JEngineConfig(**HTTP_ENGINE),
                   dtypes=JFP32)
    if mode == "continuous":
        jsched = jcontinuous.ContinuousScheduler(
            jcontinuous.ContinuousEngine(jl, lparams, sampling=JSampling(**greedy), dtypes=JFP32,
                                         engine_config=JEngineConfig(**HTTP_ENGINE, **cont,
                                                                     attn_impl="xla")),
            retry_backoff_s=0.0)
    elif mode == "coalesce":
        jsched = JBatchScheduler(jeng, max_wait_ms=30.0)
    else:
        jsched = None
    jenc = JEncoderRunner(je, eparams, dtypes=JFP32, length_buckets=(32, 64), max_batch=4)
    jstore = JStore(dim=je.hidden_size)
    jsvc = JRagService(jcfg, jeng, ByteTokenizer(), jenc, ByteTokenizer(), jstore, scheduler=jsched)
    # the port
    model = convert.load_llama(build_llama(lc, FP32, CPU), convert.flatten_tree(lparams))
    enc = convert.load_encoder(build_encoder(ec, FP32, CPU), convert.flatten_tree(eparams))
    teng = InferenceEngine(lc, model, SamplingConfig(**greedy), EngineConfig(**HTTP_ENGINE), FP32, "cpu")
    tcfg = AppConfig(model=lc, encoder=ec, engine=teng.engine_config, system_message=SYSTEM,
                     resilience=ResilienceConfig(**res),
                     flight=FlightConfig(spool_dir=tempfile.mkdtemp(prefix="port_incidents_")),
                     shadow=ShadowConfig(**sh))
    if mode == "continuous":
        tsched = tapp.build_scheduler(
            teng, dataclasses.replace(teng.engine_config, batching="continuous", **cont), tcfg.resilience)
    elif mode == "coalesce":
        tsched = BatchScheduler(teng, max_wait_ms=30.0)
    else:
        tsched = None
    tenc = EncoderRunner(ec, enc, device="cpu", length_buckets=(32, 64), max_batch=4)
    tstore = VectorStore(dim=ec.hidden_size, device="cpu")
    tsvc = tapp.RagService(tcfg, teng, ByteTokenizer(), tenc, ByteTokenizer(), tstore, scheduler=tsched)
    meta = [{"filename": "f", "chunk_id": i, "text": t} for i, t in enumerate(TEXTS)]
    jstore.add(list(jenc.encode([ByteTokenizer().encode(t) for t in TEXTS])), meta)
    tstore.add(list(tenc.encode([ByteTokenizer().encode(t) for t in TEXTS])), [dict(x) for x in meta])
    for svc in (jsvc, tsvc):
        svc.ready = True
    return {"jax": (jsvc, jcreate_app(jsvc).test_client()), "port": (tsvc, tapp.create_app(tsvc).test_client())}


@pytest.fixture(scope="module")
def pairs():
    made = {}

    def get(mode):
        if mode not in made:
            made[mode] = _make_pair(mode)
        return made[mode]

    yield get
    for pair in made.values():
        for svc, _ in pair.values():
            svc.shutdown()


def _post(side, client, path, body=None, headers=None):
    if side == "jax":
        return client.post(path, json=body or {}, headers=headers or {})
    return client.post(path, json_body=body, headers=headers)


def _seen(r):
    """What a client sees of a response: status, JSON body without timings
    and request ids, and the Retry-After header."""
    body = r.get_json()
    if isinstance(body, dict):
        body = {k: v for k, v in body.items() if k not in ("timings", "request_id")}
    return r.status_code, body, r.headers.get("Retry-After")


def _both_post(pair, path, body=None, headers=None):
    got = {side: _seen(_post(side, client, path, body, headers)) for side, (_, client) in pair.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


HEALTH_KEYS = ("status", "engine_mode", "ready", "breaker_open", "breaker_recent_resets", "draining")


def _both_health(pair, path="/healthz"):
    got = {}
    for side, (_, client) in pair.items():
        r = client.get(path)
        got[side] = (r.status_code, {k: r.get_json()[k] for k in HEALTH_KEYS})
    assert got["port"] == got["jax"], got
    return got["port"]


@pytest.mark.parametrize("mode", ["coalesce", "continuous"])
@pytest.mark.parametrize("sampling", [{"do_sample": False}, {"do_sample": "no"}, {"temperature": True},
                                      {"seed": 3}, [1]])
def test_a_sampling_field_gets_the_jax_status(pairs, mode, sampling):
    code, body, _ = _both_post(pairs(mode), "/generate", {"prompt": "alpha", "sampling": sampling})
    assert code == 200 and "Document 'f'" in body["context"]


@pytest.mark.parametrize("mode", ["coalesce", "continuous"])
def test_the_429_shape_and_retry_after(pairs, mode):
    pair = pairs(mode)
    gates = [svc.admission for svc, _ in pair.values()]
    old = [(g.max_concurrency, g.max_queue) for g in gates]
    holds = []
    try:
        for g in gates:
            g.max_concurrency, g.max_queue = 1, 0
            holds.append(g.admit())
            holds[-1].__enter__()
        code, body, retry_after = _both_post(pair, "/generate", {"prompt": "alpha"})
    finally:
        for h in holds:
            h.__exit__(None, None, None)
        for g, (c, q) in zip(gates, old):
            g.max_concurrency, g.max_queue = c, q
    assert (code, body, retry_after) == (
        429, {"error": "server overloaded", "reason": "queue_full", "retry_after_s": 1.0}, "1")


def test_an_open_breaker_turns_readiness_off_and_sheds_503(pairs):
    pair = pairs("continuous")
    clocks = []
    for svc, _ in pair.values():
        clocks.append(FakeClock(1000.0))
        svc.breaker.clock = clocks[-1]
    assert _both_health(pair)[0] == 200
    try:
        for svc, _ in pair.values():
            for _ in range(svc.breaker.threshold):
                svc.breaker.record_reset()
        code, health = _both_health(pair)
        assert code == 503 and health["breaker_open"] is True and health["status"] == "draining"
        assert _both_health(pair, "/healthz?live=1") == (200, dict(health, status="alive"))
        assert _both_post(pair, "/generate", {"prompt": "alpha"}) == (
            503, {"error": "server draining", "reason": "breaker_open", "retry_after_s": 300.0}, "300")
        for c in clocks:
            c.advance(301.0)  # the resets age out: the breaker closes
        assert _both_health(pair)[0] == 200
        assert _both_post(pair, "/generate", {"prompt": "alpha"})[0] == 200
    finally:
        for svc, _ in pair.values():
            svc.breaker.clock = time.monotonic
            svc.breaker._events.clear()


@pytest.mark.parametrize("bad", ["soon", -5, 0, "inf", "nan", "-inf", "x", [1]])
def test_a_malformed_deadline_is_a_400(pairs, bad):
    code, body, _ = _both_post(pairs("coalesce"), "/generate", {"prompt": "a", "deadline_ms": bad})
    assert code == 400 and "deadline_ms=" in body["error"]


@pytest.mark.parametrize("where", ["body", "header"])
def test_a_deadline_spent_before_retrieval_ends_is_a_504_at_retrieve(pairs, where):
    body = {"prompt": "alpha", "deadline_ms": 0.001} if where == "body" else {"prompt": "alpha"}
    headers = {"x-request-deadline-ms": "0.001"} if where == "header" else None
    assert _both_post(pairs("coalesce"), "/generate", body, headers) == (
        504, {"error": "request deadline exceeded at stage 'retrieve' (budget 0 ms)", "stage": "retrieve"}, None)


def test_a_deadline_spent_mid_decode_is_a_504_at_decode_and_frees_the_row(pairs):
    """Each continuous window is slowed to 0.1 s, so a 1.5 s budget runs out
    mid-decode on both sides; the row is evicted and its blocks return."""
    pair = pairs("continuous")
    for side in pair:  # warm both paths first
        assert _seen(_post(side, pair[side][1], "/generate", {"prompt": "alpha"}))[0] == 200
    slowed = []
    for svc, _ in pair.values():
        eng = svc.scheduler.engine
        real = eng.step

        def slow(real=real):
            time.sleep(0.1)
            return real()

        eng.step = slow
        slowed.append((eng, real))
        svc.scheduler.engine.sampling = dataclasses.replace(eng.sampling, max_new_tokens=60)
    try:
        got = _both_post(pair, "/generate", {"prompt": "alpha", "deadline_ms": 1500})
    finally:
        for eng, real in slowed:
            eng.step = real
            eng.sampling = dataclasses.replace(eng.sampling, max_new_tokens=8)
    assert got == (504, {"error": "request deadline exceeded at stage 'decode' (budget 1500 ms)",
                         "stage": "decode"}, None)
    for eng, _ in slowed:
        assert _settle(lambda eng=eng: eng.kv_pool.blocks_in_use() == 0)


def test_a_decode_fault_over_http_is_invisible(pairs):
    pair = pairs("continuous")
    want = _both_post(pair, "/generate", {"prompt": "delta"})
    jfaults.arm("decode_step", times=1)
    tfaults.arm("decode_step", times=1)
    assert _both_post(pair, "/generate", {"prompt": "delta"}) == want
    assert jfaults.armed() == {} and tfaults.armed() == {}
    for svc, _ in pair.values():
        assert svc.scheduler.engine.kv_pool.blocks_in_use() == 0
        svc.breaker._events.clear()


def test_the_faults_endpoint_is_gated_on_the_env(pairs, monkeypatch):
    pair = pairs("coalesce")

    def both(method, body=None):
        got = {}
        for side, (_, client) in pair.items():
            if method == "GET":
                r = client.get("/debug/faults")
            else:
                r = _post(side, client, "/debug/faults", body)
            got[side] = (r.status_code, r.get_json())
        assert got["port"] == got["jax"], got
        return got["port"]

    monkeypatch.delenv("TPU_RAG_FAULTS", raising=False)
    assert both("GET") == (403, {"error": "fault injection disabled (set TPU_RAG_FAULTS)"})
    assert both("POST", {"site": "embed"})[0] == 403
    monkeypatch.setenv("TPU_RAG_FAULTS", "1")
    assert both("GET") == (200, {"enabled": True, "armed": {}, "sites": list(tfaults.SITES)})
    assert both("POST", {"site": "embed", "times": 3})[1]["armed"] == {"embed": 3}
    assert both("POST", {"site": "nope"})[0] == 400
    assert both("POST", {"bogus": 1})[0] == 400
    assert both("POST", {"clear": True})[1]["armed"] == {}


@pytest.mark.parametrize("mode", ["coalesce", "continuous"])
def test_a_store_fault_is_a_500_not_a_hang(pairs, mode):
    pair = pairs(mode)
    jfaults.arm("store_lookup", times=1)
    tfaults.arm("store_lookup", times=1)
    assert _both_post(pair, "/generate", {"prompt": "alpha"}) == (
        500, {"error": "injected fault at site 'store_lookup'"}, None)
    assert _both_post(pair, "/generate", {"prompt": "alpha"})[0] == 200  # disarmed: serves


def test_the_tenant_rides_to_the_journal(pairs):
    pair = pairs("continuous")
    for side, (svc, client) in pair.items():
        flight = jflight if side == "jax" else tflight
        flight.recorder().clear()
        r = _post(side, client, "/generate", {"prompt": "alpha", "tenant_id": "acme"})
        assert r.status_code == 200
        rid = r.get_json()["request_id"]
        kinds = {e["type"]: e for e in flight.recorder().snapshot(request_id=rid)}
        assert kinds["arrival"]["tenant"] == "acme" and kinds["complete"]["tenant"] == "acme"
    assert pair["port"][0].tenant_tracker.tracked() == pair["jax"][0].tenant_tracker.tracked()
