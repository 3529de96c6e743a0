"""The port's retrieval lookahead (``rag/lookahead.py`` and its service
wiring) against the JAX package's.

- **the executor**: each scripted case of ``tests/test_lookahead.py``
  ``TestExecutor`` (launch, dedupe, the inflight bound, the headroom skip,
  supersede, TTL expiry, the last waiter's abandon, a stale index,
  ``JoinTimeout``, the fault fallback, shutdown) runs on the JAX executor
  and the port's over the same stub callbacks: the same observations, the
  same ``stats()`` and the same ``rag_lookahead_*`` counts; the eight
  families carry JAX's types, HELP text, labels and buckets. Each case has
  a time limit of its own;
- **the service**: JAX's service and the port's with lookahead off and on
  (coalescing scheduler) give byte-identical greedy streams, sequential and
  in a concurrent burst, that equal each other; a pre-launched future makes
  the next request a ``lookahead_hit``; a ``session_id`` speculates; a
  queue-stage 504 abandons the launched future; a planted
  ``lookahead_retrieve`` fault falls back to inline retrieval;
- **the paged pool leg**: on a paged continuous service with the prefix
  cache on, a session's speculation registers pool blocks
  (``rag_kv_tier_pool_blocks`` reads them), a superseding speculation
  releases what nothing consumed and the pool returns to its baseline; the
  service's handle threads the registration's generation from the prestage
  task to the release task.
"""

import dataclasses
import functools
import threading
import time

import jax
import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.core.config import AppConfig as JAppConfig
from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
from rag_llm_k8s_tpu.core.config import EncoderConfig as JEncoderConfig
from rag_llm_k8s_tpu.core.config import EngineConfig as JEngineConfig
from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
from rag_llm_k8s_tpu.core.config import LookaheadConfig as JLookaheadConfig
from rag_llm_k8s_tpu.core.config import SamplingConfig as JSampling
from rag_llm_k8s_tpu.engine.batching import BatchScheduler as JBatchScheduler
from rag_llm_k8s_tpu.engine.encoder import EncoderRunner as JEncoderRunner
from rag_llm_k8s_tpu.engine.engine import InferenceEngine as JEngine
from rag_llm_k8s_tpu.index.store import VectorStore as JStore
from rag_llm_k8s_tpu.models.bge_m3 import init_encoder_params
from rag_llm_k8s_tpu.models.llama import init_llama_params
from rag_llm_k8s_tpu.obs import metrics as jmetrics
from rag_llm_k8s_tpu.rag import lookahead as jla
from rag_llm_k8s_tpu.resilience import faults as jfaults
from rag_llm_k8s_tpu.server.app import RagService as JRagService
from rag_llm_k8s_tpu.server.app import create_app as jcreate_app
from rag_llm_k8s_tpu_torch.core.config import (
    AppConfig,
    DTypePolicy,
    EncoderConfig,
    EngineConfig,
    LlamaConfig,
    LookaheadConfig,
    PrefixCacheConfig,
    SamplingConfig,
)
from rag_llm_k8s_tpu_torch.engine.batching import BatchScheduler
from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousScheduler
from rag_llm_k8s_tpu_torch.engine.encoder import EncoderRunner
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.index.store import VectorStore
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.bge_m3 import build_encoder
from rag_llm_k8s_tpu_torch.models.llama import build_llama
from rag_llm_k8s_tpu_torch.obs import metrics as tmetrics
from rag_llm_k8s_tpu_torch.rag import lookahead as tla
from rag_llm_k8s_tpu_torch.resilience import faults as tfaults
from rag_llm_k8s_tpu_torch.server import app as tapp

CPU = torch.device("cpu")
FP32, JFP32 = DTypePolicy.fp32(), JDTypes.fp32()
SIDES = {
    "jax": (jla, JLookaheadConfig, jmetrics, jfaults),
    "port": (tla, LookaheadConfig, tmetrics, tfaults),
}


@pytest.fixture(autouse=True)
def _clean():
    for f in (jfaults, tfaults):
        f.clear()
    yield
    for f in (jfaults, tfaults):
        f.clear()


def limited(seconds):
    """Run the test in a thread and fail it past ``seconds``: every case
    waits on executor threads, and a wedged one must not hang the run."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            box = {}

            def target():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    box["error"] = e

            th = threading.Thread(target=target, daemon=True)
            th.start()
            th.join(seconds)
            if th.is_alive():
                pytest.fail(f"{fn.__name__} ran past its {seconds} s limit")
            if "error" in box:
                raise box["error"]
        return run
    return deco


def _wait_for(pred, timeout=10.0, what="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------------
# the executor, over stub callbacks (tests/test_lookahead.py's harness)
# ---------------------------------------------------------------------------


class Harness:
    def __init__(self, delay=0.0):
        self.delay = delay
        self.calls, self.staged, self.released = [], [], []
        self.headroom = True
        self.gen = 1

    def retrieve(self, text):
        if self.delay:
            time.sleep(self.delay)
        self.calls.append(text)
        return ([f"result:{text}"], 0.5)

    def prestage(self, text, result):
        handle = {"text": text}
        self.staged.append(handle)
        return handle

    def release(self, handle):
        self.released.append(handle)

    def executor(self, side, retrieve=None, **cfg_kw):
        mod, cfg_cls, metrics, _ = SIDES[side]
        cfg = cfg_cls(**{**dict(enabled=True, max_workers=2, max_inflight=4, ttl_s=30.0), **cfg_kw})
        # a fresh registry per executor: the families are keyed by name
        self.registry = metrics.MetricsRegistry()
        return mod.LookaheadExecutor(
            cfg, retrieve_fn=retrieve or self.retrieve, prestage_fn=self.prestage, release_fn=self.release,
            headroom_fn=lambda: self.headroom, index_gen_fn=lambda: self.gen, registry=self.registry,
        )


def _counts(ex):
    """Every lookahead counter child and each histogram's count."""
    out = {}
    for name in ("_m_launched", "_m_joins", "_m_wasted", "_m_skipped"):
        out.update({f"{name}:{k}": c.value for k, c in getattr(ex, name).items()})
    out["prestaged"] = ex._m_prestaged.value
    out["prestage_released"] = ex._m_prestage_released.value
    out["join_count"] = ex._m_join_wait.snapshot()[2]
    return out


def case_launch_claim_join_hit(side, h):
    ex = h.executor(side)
    try:
        fut = ex.launch("q1")
        _wait_for(fut.resolved, what="future resolve")
        claimed = ex.claim("q1")
        out = {"same": claimed is fut, "r": ex.join(claimed), "again": ex.claim("q1")}
        # no future for this text: the serving tail retrieves inline
        out["unknown"] = ex.claim("never launched")
        ex.note_miss()
        return out, ex
    finally:
        ex.shutdown()


def case_join_on_running_future_is_late(side, h):
    h.delay = 0.2
    ex = h.executor(side)
    try:
        fut = ex.launch("slow")
        claimed = ex.claim("slow")
        running = claimed is fut and not fut.resolved()
        return {"running": running, "r": ex.join(claimed, timeout=5.0)}, ex
    finally:
        ex.shutdown()


def case_dedupe_and_the_inflight_bound(side, h):
    h.delay = 0.5
    ex = h.executor(side, max_workers=1, max_inflight=2)
    try:
        a, b = ex.launch("a"), ex.launch("a")
        c = ex.launch("b")
        d = ex.launch("c")  # over the bound: skipped, not queued
        return {"dedupe": a is b, "b": c is not None, "skipped": d is None}, ex
    finally:
        ex.shutdown()


def case_headroom_skips_only_speculation(side, h):
    h.headroom = False
    ex = h.executor(side)
    try:
        return {"spec": ex.speculate("s1", "next turn"), "real": ex.launch("real request") is not None}, ex
    finally:
        ex.shutdown()


def case_supersede_releases_the_old_speculation(side, h):
    ex = h.executor(side)
    try:
        f1 = ex.speculate("s1", "turn two?")
        _wait_for(lambda: f1.staging is not None, what="prestage")
        f2 = ex.speculate("s1", "different turn two?")
        _wait_for(lambda: len(h.released) == 1, what="stale release")
        # a speculation deduped onto another session's replaces this one's
        f3 = ex.speculate("s2", "shared next topic")
        _wait_for(lambda: f3.resolved(), what="resolve")
        f4 = ex.speculate("s1", "shared next topic")
        _wait_for(lambda: f2.superseded, what="dedupe supersede")
        return {"new": f2 is not f1, "released": [x["text"] for x in h.released[:1]], "dedupe": f4 is f3,
                "slot": ex._session_spec["s1"] is f3}, ex
    finally:
        ex.shutdown()


def case_ttl_expiry_counts_once(side, h):
    ex = h.executor(side, ttl_s=0.2)
    try:
        f1 = ex.speculate("s1", "turn two?")
        _wait_for(lambda: f1.staging is not None, what="prestage")
        time.sleep(0.3)
        swept = ex.sweep()
        f2 = ex.speculate("s1", "a different turn two?")
        _wait_for(lambda: len(h.released) == 1, what="expired release")
        return {"swept": swept, "new": f2 is not None and f2 is not f1, "released": len(h.released)}, ex
    finally:
        ex.shutdown()


def case_the_sweeper_expires_without_traffic(side, h):
    ex = h.executor(side, ttl_s=0.6)  # sweeps every 0.3 s
    try:
        f = ex.launch("quiet service")
        _wait_for(lambda: f.staging is not None, what="prestage")
        _wait_for(lambda: ex._m_wasted["expired"].value >= 1, timeout=5.0, what="background expiry")
        _wait_for(lambda: len(h.released) == 1, what="staging release")
        return {"released": len(h.released)}, ex
    finally:
        ex.shutdown()


def case_the_last_waiter_abandons(side, h):
    h.delay = 0.2
    ex = h.executor(side)
    try:
        a, created_a = ex.launch_tracked("shared")
        b, created_b = ex.launch_tracked("shared")
        waiters = a.waiters
        ex.abandon(a)  # one waiter remains
        alive = not a.superseded
        claimed = ex.claim("shared")
        r = ex.join(claimed, timeout=5.0)
        c, _ = ex.launch_tracked("both shed")
        ex.launch_tracked("both shed")
        ex.abandon(c)
        ex.abandon(c)
        f = ex.launch("shed with staging")
        _wait_for(lambda: f.staging is not None, what="prestage")
        ex.abandon(f)
        _wait_for(lambda: len(h.released) == 1, what="abandon release")
        return {"created": (created_a, created_b), "waiters": waiters, "alive": alive, "r": r,
                "dead": c.superseded, "released": len(h.released)}, ex
    finally:
        ex.shutdown()


def case_a_stale_index_is_never_served(side, h):
    ex = h.executor(side)
    try:
        f = ex.launch("pre-ingest query")
        _wait_for(f.resolved, what="resolve")
        h.gen = 2
        return {"claim": ex.claim("pre-ingest query")}, ex
    finally:
        ex.shutdown()


def case_join_timeouts(side, h):
    mod = SIDES[side][0]
    h.delay = 0.5
    ex = h.executor(side, max_workers=1)
    try:
        ex.launch("slow")
        with pytest.raises(mod.JoinTimeout):
            ex.join(ex.claim("slow"), timeout=0.01)
    finally:
        ex.shutdown()

    def wedged(text):
        raise TimeoutError("coalescer submit timed out")

    ex2 = h.executor(side, retrieve=wedged)
    try:
        ex2.launch("wedged")
        with pytest.raises(TimeoutError) as ei:
            ex2.join(ex2.claim("wedged"), timeout=5.0)
        return {"plain": not isinstance(ei.value, mod.JoinTimeout)}, ex2
    finally:
        ex2.shutdown()


def case_a_planted_fault_surfaces_at_join(side, h):
    faults = SIDES[side][3]
    ex = h.executor(side)
    try:
        faults.arm("lookahead_retrieve", 1)
        ex.launch("faulted")
        with pytest.raises(faults.InjectedFault):
            ex.join(ex.claim("faulted"), timeout=5.0)
        ex.launch("after fault")
        return {"r": ex.join(ex.claim("after fault"), timeout=5.0)}, ex
    finally:
        faults.clear()
        ex.shutdown()


def case_shutdown_fails_and_releases(side, h):
    h.delay = 0.3
    ex = h.executor(side, max_workers=1)
    ex.launch("busy")
    b = ex.launch("queued behind")
    claimed = ex.claim("queued behind")
    queued = claimed is b and not b.resolved()
    ex.shutdown()
    with pytest.raises(RuntimeError):
        ex.join(claimed, timeout=1.0)
    h2 = Harness()
    ex2 = h2.executor(side)
    f = ex2.launch("unconsumed")
    _wait_for(lambda: f.staging is not None, what="prestage")
    ex2.shutdown()
    return {"queued": queued, "first": (ex.stats(), _counts(ex)), "released": len(h2.released),
            "after": ex2.launch("post-shutdown")}, ex2


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
@limited(30)
def test_the_executor_case_gives_the_jax_observations_and_stats(case):
    seen = {}
    for side in ("jax", "port"):
        obs, ex = CASES[case](side, Harness())
        seen[side] = (obs, ex.stats(), _counts(ex))
    assert seen["port"] == seen["jax"]


def test_the_cases_cover_what_the_executor_does():
    """The scripted cases together move every counter child the executor
    has (so no path of the executor goes unchecked)."""
    moved = {}
    for fn in CASES.values():
        _, ex = fn("port", Harness())
        for k, v in _counts(ex).items():
            moved[k] = moved.get(k, 0) + v
    assert all(v > 0 for v in moved.values()), moved


def _family_lines(registry):
    """``# HELP`` and ``# TYPE`` lines and each sample's name and labels
    (values dropped) of the lookahead families."""
    out = []
    for line in registry.render_prometheus().splitlines():
        if "rag_lookahead_" not in line:
            continue
        out.append(line if line.startswith("#") else line.rsplit(" ", 1)[0])
    return out


@limited(30)
def test_the_families_are_the_jax_ones():
    lines = {}
    for side in ("jax", "port"):
        h = Harness()
        ex = h.executor(side)
        try:
            lines[side] = _family_lines(h.registry)
        finally:
            ex.shutdown()
    assert lines["port"] == lines["jax"]
    assert len([x for x in lines["port"] if x.startswith("# TYPE")]) == 8


# ---------------------------------------------------------------------------
# the service pair
# ---------------------------------------------------------------------------

VOCAB = 300
SYSTEM = "sys"
GREEDY = dict(do_sample=False, max_new_tokens=8)
ENGINE = dict(prompt_buckets=(128, 512), max_batch_size=2, speculative="off")
TEXTS = ["TPU retrieval systems use interchip links for collectives",
         "decode throughput is high with paged caches"]
QUERIES = ["what links do TPUs use?", "how fast is decode?", "what about paged caches?",
           "tell me about collectives"]


class ByteTokenizer:
    eos_id = None

    def encode(self, text):
        return [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids, skip_special_tokens=True):
        return bytes((i - 3) % 256 for i in ids if i >= 3).decode("utf-8", "replace")


@pytest.fixture(scope="module")
def shared_weights():
    jl, je = JLlamaConfig.tiny(VOCAB), JEncoderConfig.tiny(VOCAB)
    return (init_llama_params(jax.random.PRNGKey(0), jl, JFP32), init_encoder_params(jax.random.PRNGKey(1), je, JFP32))


def _jax_service(weights, lookahead):
    lparams, eparams = weights
    jl, je = JLlamaConfig.tiny(VOCAB), JEncoderConfig.tiny(VOCAB)
    cfg = JAppConfig(model=jl, encoder=je, system_message=SYSTEM,
                     lookahead=JLookaheadConfig(enabled=lookahead))
    eng = JEngine(jl, lparams, sampling=JSampling(**GREEDY), engine_config=JEngineConfig(**ENGINE), dtypes=JFP32)
    enc = JEncoderRunner(je, eparams, dtypes=JFP32, length_buckets=(32, 64), max_batch=4)
    store = JStore(dim=je.hidden_size)
    svc = JRagService(cfg, eng, ByteTokenizer(), enc, ByteTokenizer(), store,
                      scheduler=JBatchScheduler(eng, max_wait_ms=30.0))
    meta = [{"filename": "f", "chunk_id": i, "text": t} for i, t in enumerate(TEXTS)]
    store.add(list(enc.encode([ByteTokenizer().encode(t) for t in TEXTS])), meta)
    svc.ready = True
    return svc, jcreate_app(svc).test_client()


def _port_service(weights, lookahead, prefix_cache=None, continuous=None, ttl_s=30.0):
    lparams, eparams = weights
    lc, ec = LlamaConfig.tiny(VOCAB), EncoderConfig.tiny(VOCAB)
    model = convert.load_llama(build_llama(lc, FP32, CPU), convert.flatten_tree(lparams))
    enc_model = convert.load_encoder(build_encoder(ec, FP32, CPU), convert.flatten_tree(eparams))
    ekw = dict(ENGINE)
    if prefix_cache is not None:
        ekw["prefix_cache"] = prefix_cache
    eng = InferenceEngine(lc, model, SamplingConfig(**GREEDY), EngineConfig(**ekw), FP32, "cpu")
    cfg = AppConfig(model=lc, encoder=ec, engine=eng.engine_config, system_message=SYSTEM,
                    lookahead=LookaheadConfig(enabled=lookahead, ttl_s=ttl_s))
    if continuous is not None:
        sched = tapp.build_scheduler(eng, dataclasses.replace(eng.engine_config, batching="continuous",
                                                              **continuous))
    else:
        sched = BatchScheduler(eng, max_wait_ms=30.0)
    enc = EncoderRunner(ec, enc_model, device="cpu", length_buckets=(32, 64), max_batch=4)
    store = VectorStore(dim=ec.hidden_size, device="cpu")
    svc = tapp.RagService(cfg, eng, ByteTokenizer(), enc, ByteTokenizer(), store, scheduler=sched)
    meta = [{"filename": "f", "chunk_id": i, "text": t} for i, t in enumerate(TEXTS)]
    store.add(list(enc.encode([ByteTokenizer().encode(t) for t in TEXTS])), meta)
    svc.ready = True
    return svc, tapp.create_app(svc).test_client()


def _post(side, client, body):
    if side == "jax":
        return client.post("/generate", json=body)
    return client.post("/generate", json_body=body)


def _json(r):
    return r.get_json()


@pytest.fixture(scope="module")
def services(shared_weights):
    made = {("jax", False): _jax_service(shared_weights, False), ("jax", True): _jax_service(shared_weights, True),
            ("port", False): _port_service(shared_weights, False), ("port", True): _port_service(shared_weights, True)}
    yield made
    for svc, _ in made.values():
        svc.shutdown()


def test_lookahead_off_builds_no_executor(services):
    assert services[("port", False)][0].lookahead is None
    assert isinstance(services[("port", True)][0].lookahead, tla.LookaheadExecutor)
    assert services[("port", True)][0].lookahead.config.enabled


def test_sequential_greedy_streams_are_byte_identical_on_and_off_and_jax_s(services):
    for q in QUERIES:
        texts = {}
        for key, (_, client) in services.items():
            body = {"prompt": q, "session_id": "s0"} if key[1] else {"prompt": q}
            r = _post(key[0], client, body)
            assert r.status_code == 200, (key, r.get_data())
            texts[key] = _json(r)["generated_text"]
            if key[1]:
                assert "lookahead_hit" in _json(r)["timings"], key
        assert len(set(texts.values())) == 1, texts
    for side in ("jax", "port"):
        assert services[(side, True)][0].lookahead._m_launched["session"].value >= 1


def test_a_concurrent_burst_is_byte_identical_and_overlapped(services):
    def burst(side, svc):
        out, lock = {}, threading.Lock()

        def worker(q):
            client = (jcreate_app(svc) if side == "jax" else tapp.create_app(svc)).test_client()
            r = _json(_post(side, client, {"prompt": q}))
            with lock:
                out[q] = r["generated_text"]

        ths = [threading.Thread(target=worker, args=(q,)) for q in QUERIES]
        for t in ths:
            t.start()
        for t in ths:
            t.join(60)
        return out

    got = {key: burst(key[0], svc) for key, (svc, _) in services.items()}
    assert all(g == got[("jax", False)] for g in got.values())
    st = services[("port", True)][0].lookahead.stats()
    assert st["joins"] >= len(QUERIES) and st["overlap_rate"] > 0


def test_a_prelaunched_future_makes_the_join_a_hit(services):
    for side in ("jax", "port"):
        svc, client = services[(side, True)]
        fut = svc.lookahead.launch(QUERIES[0])
        _wait_for(fut.resolved, what="lookahead resolve")
        timings = _json(_post(side, client, {"prompt": QUERIES[0]}))["timings"]
        assert timings["lookahead_hit"] == 1.0, side


def test_a_queue_stage_504_abandons_the_future(services):
    for side in ("jax", "port"):
        svc, client = services[(side, True)]
        before = svc.lookahead._m_wasted["abandoned"].value
        conc, depth = svc.admission.max_concurrency, svc.admission.max_queue
        svc.admission.max_concurrency, svc.admission.max_queue = 1, 1
        try:
            with svc.admission.admit():
                r = _post(side, client, {"prompt": "will expire in the queue", "deadline_ms": 60})
        finally:
            svc.admission.max_concurrency, svc.admission.max_queue = conc, depth
        assert r.status_code == 504 and _json(r)["stage"] == "queue", side
        _wait_for(lambda: svc.lookahead._m_wasted["abandoned"].value > before, what=f"{side} abandon")


def test_a_lookahead_fault_falls_back_to_inline_retrieval(services):
    texts = {}
    for side, faults in (("jax", jfaults), ("port", tfaults)):
        svc, client = services[(side, True)]
        failed = svc.lookahead._m_wasted["failed"].value
        faults.arm("lookahead_retrieve", 1)
        try:
            texts[side] = _json(_post(side, client, {"prompt": QUERIES[1]}))["generated_text"]
        finally:
            faults.clear()
        assert svc.lookahead._m_wasted["failed"].value > failed, side
    assert texts["port"] == texts["jax"]


def test_the_service_serves_the_jax_lookahead_families(services):
    got = {side: [x for x in _family_lines(services[(side, True)][0].metrics)] for side in ("jax", "port")}
    heads = {side: [x for x in lines if x.startswith("#")] for side, lines in got.items()}
    assert heads["port"] == heads["jax"] and len(heads["port"]) == 16


def test_shutdown_stops_the_executor_before_the_coalescer(shared_weights):
    svc, _ = _port_service(shared_weights, True)
    order = []
    la_stop, co_stop = svc.lookahead.shutdown, svc.retrieve_coalescer.shutdown
    svc.lookahead.shutdown = lambda: (order.append("lookahead"), la_stop())
    svc.retrieve_coalescer.shutdown = lambda *a, **k: (order.append("coalescer"), co_stop(*a, **k))
    svc.shutdown()
    assert order == ["lookahead", "coalescer"]


# ---------------------------------------------------------------------------
# the paged pool leg
# ---------------------------------------------------------------------------

SERVICE_PC = PrefixCacheConfig(enabled=True, max_prefix_tokens=512, segment_buckets=(64, 128, 256),
                               suffix_buckets=(128,), hbm_budget_mb=64)
PAGED = dict(kv_paged=True, kv_block_size=16, max_seq_len=640)


@pytest.fixture()
def paged_service(shared_weights):
    svc, client = _port_service(shared_weights, True, prefix_cache=SERVICE_PC, continuous=PAGED)
    assert isinstance(svc.scheduler, ContinuousScheduler)
    yield svc, client
    svc.shutdown()


def _pool_gauge(svc, tier):
    return svc.metrics.get_family("rag_kv_tier_pool_blocks").labels(tier=tier).value


def _settled(svc):
    """Run an engine task and wait for it: every task queued before it ran."""
    done = threading.Event()
    svc.scheduler.run_on_engine(lambda e: done.set())
    assert done.wait(10)


@limited(120)
def test_a_superseded_session_speculation_releases_its_pool_blocks(paged_service):
    svc, client = paged_service
    pool = svc.scheduler.engine.kv_pool
    base = pool.blocks_in_use()
    ex = svc.lookahead
    f1 = ex.speculate("lonely", QUERIES[0])
    _wait_for(lambda: ex.stats()["prestaged"] >= 1, timeout=30, what="prestage")
    _settled(svc)
    staged = pool.blocks_in_use() - base
    assert staged > 0 and _pool_gauge(svc, "hot") == staged
    assert svc.engine.prefix_cache.counters()["prefix_cache_bytes"] > 0
    f2 = ex.speculate("lonely", "an entirely different topic")
    assert f2 is not None and f2 is not f1
    _wait_for(lambda: ex._m_prestage_released.value >= 1, timeout=30, what="stale release")
    _wait_for(lambda: ex.stats()["prestaged"] >= 2, timeout=30, what="second prestage")
    ex.shutdown()  # releases the second speculation too
    _settled(svc)
    assert pool.blocks_in_use() == base and _pool_gauge(svc, "hot") == 0


@limited(120)
def test_a_session_turn_consumes_its_speculation(paged_service):
    svc, client = paged_service
    cache = svc.engine.prefix_cache
    r1 = _post("port", client, {"prompt": QUERIES[0], "session_id": "sess"})
    assert r1.status_code == 200
    _wait_for(lambda: svc.lookahead.stats()["prestaged"] >= 1, timeout=30, what="speculative prestage")
    hits = cache.counters()["prefix_cache_hits"]
    r2 = _post("port", client, {"prompt": QUERIES[0] + " and collectives?", "session_id": "sess"})
    assert r2.status_code == 200
    assert cache.counters()["prefix_cache_hits"] > hits
    assert svc.lookahead._m_launched["session"].value >= 2


@limited(120)
def test_the_release_handle_threads_the_registration_generation(paged_service):
    svc, _ = paged_service
    cont = svc.scheduler.engine
    q = QUERIES[0]
    res = svc._retrieve(q)
    h1 = svc._lookahead_prestage(q, res)
    _settled(svc)
    assert h1 is not None and isinstance(h1["pool"], int)
    ck = h1["chain_key"]
    # pressure evicts the staged registration; a later prestage re-creates
    # one at the same key with a fresh generation
    svc.scheduler.run_on_engine(lambda e: e.release_prestaged(ck))
    h2 = svc._lookahead_prestage(q, res)
    _settled(svc)
    assert isinstance(h2["pool"], int) and h2["pool"] != h1["pool"]
    svc._lookahead_release(h1)  # stale: keeps the re-created registration
    _settled(svc)
    assert cont.prestage_gen(ck) == h2["pool"]
    svc._lookahead_release(h2)
    _settled(svc)
    assert cont.prestage_gen(ck) is None and cont.kv_pool.blocks_in_use() == 0
    assert svc.admission.reclaimable_hint() is False
