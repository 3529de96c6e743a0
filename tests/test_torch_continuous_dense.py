"""The port's dense continuous engine (``kv_paged=False``) and the
scheduler's engine tasks against the JAX package's, on the same tiny fp32
weights (bridged by ``models/convert.py``).

- the row-frontier write (``models.llama.write_row_frontier``) against the
  JAX ``row_frontier`` model: fed the K/V the JAX model wrote, the port's
  write leaves every cache plane bit-identical to JAX's, fp32 and int8
  (payloads and scales); the forward's logits within fp32 round-off;
- greedy streams token for token against JAX's dense ``ContinuousEngine``
  (``attn_impl="xla"``) and the port's own paged engine: mixed prompt
  lengths and buckets, mid-flight admission, ``decode_sync_steps`` 1 and 3,
  a budget cut, EOS inside a window, int8 KV, an evicted row whose row is
  re-admitted, and a planted ``insert`` fault;
- a seeded dense stream equals the paged engine's seeded stream;
- the dense branches of the pool surface (no blocks, no preemption, the
  gauges at 0), the JAX construction errors, and the dense service
  (``/healthz`` mode ``"continuous"``, the burst's answers equal the
  one-shot service's);
- ``ContinuousScheduler.run_on_engine``: tasks run in order with submits,
  ``False`` after shutdown, ``TypeError`` on a non-callable, a failing task
  does not stop the loop, and an ``EngineStateLost`` task resubmits the
  requests in flight, whose streams stay unchanged.
"""

import dataclasses
import logging
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
from rag_llm_k8s_tpu.core.config import EncoderConfig as JEncoderConfig
from rag_llm_k8s_tpu.core.config import EngineConfig as JEngineConfig
from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
from rag_llm_k8s_tpu.core.config import SamplingConfig as JSampling
from rag_llm_k8s_tpu.engine.continuous import ContinuousEngine as JContinuousEngine
from rag_llm_k8s_tpu.engine.continuous import ContinuousScheduler as JContinuousScheduler
from rag_llm_k8s_tpu.models import llama as jllama
from rag_llm_k8s_tpu.models.bge_m3 import init_encoder_params
from rag_llm_k8s_tpu.models.llama import init_llama_params
from rag_llm_k8s_tpu_torch.core.config import (
    AppConfig,
    DTypePolicy,
    EncoderConfig,
    EngineConfig,
    LlamaConfig,
    SamplingConfig,
)
from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine, ContinuousScheduler, EngineStateLost
from rag_llm_k8s_tpu_torch.engine.encoder import EncoderRunner
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.index.store import VectorStore
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models import llama as tllama
from rag_llm_k8s_tpu_torch.models.bge_m3 import build_encoder
from rag_llm_k8s_tpu_torch.obs import metrics
from rag_llm_k8s_tpu_torch.resilience import faults
from rag_llm_k8s_tpu_torch.server import app as tapp

import test_torch_continuous as C  # the continuous service's pieces (tokenizer, PDFs, questions)

CPU = torch.device("cpu")
FP32 = DTypePolicy.fp32()
JFP32 = JDTypes.fp32()
GREEDY = dict(do_sample=False, max_new_tokens=10)
SAMPLED = dict(do_sample=True, temperature=0.7, top_p=0.9)
# the JAX package's dense continuous configuration (tests/test_continuous.py)
DENSE = dict(prompt_buckets=(16, 32), max_batch_size=4, max_seq_len=64)
PAGED = dict(DENSE, kv_paged=True, kv_block_size=16)
# lengths 7, 3, 20 and 25: buckets 16 and 32, left padding 9 to 13
PROMPTS = [
    [5, 6, 7, 8, 9, 10, 11],
    [12, 13, 14],
    [3] * 20,
    [9] * 25,
]


@pytest.fixture(scope="module")
def weights():
    params = init_llama_params(jax.random.PRNGKey(0), JLlamaConfig.tiny(), JFP32)
    model = convert.load_llama(tllama.build_llama(LlamaConfig.tiny(), FP32, CPU), convert.flatten_tree(params))
    return params, model


def jax_engine(params, ec, cfg=None, **samp):
    return JContinuousEngine(
        cfg or JLlamaConfig.tiny(), params, sampling=JSampling(**{**GREEDY, **samp}),
        engine_config=JEngineConfig(**ec, attn_impl="xla"), dtypes=JFP32,
    )


def port_engine(model, ec, cfg=None, **samp):
    return ContinuousEngine(
        cfg or LlamaConfig.tiny(), model, SamplingConfig(**{**GREEDY, **samp}), EngineConfig(**ec), FP32, "cpu",
    )


def drain(eng, reqs, seeds=None, late=(), late_after=3, evict=None):
    """Admit ``reqs`` as one group, step ``late_after`` windows, evict
    ``evict`` (request ids) and admit ``late`` mid-flight, then step to
    completion: ``{rid: tokens}``."""
    results = {}

    def admit(batch):
        items = [(rid, p, mn, None if seeds is None else seeds[rid]) for rid, p, mn in batch]
        for (rid, _, _), res in zip(batch, eng.admit_many(items)):
            if isinstance(res, BaseException):
                raise res
            if res[1] is not None:
                results[rid] = res[1]

    admit(reqs)
    for i in range(400):
        if i == late_after:
            if evict:
                eng.evict_requests(evict)
            if late:
                admit(late)
        for rid, toks in eng.step():
            results[rid] = toks
        if i >= late_after and not eng.has_active():
            break
    if eng.kv_pool is not None:
        assert eng.kv_pool.blocks_in_use() == 0
    return results


# ---------------------------------------------------------------------------
# the row-frontier write and forward against the JAX row_frontier model
# ---------------------------------------------------------------------------


def _planes(cache):
    return [c for c in (cache.k, cache.v, cache.k_scale, cache.v_scale) if c is not None]


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_row_frontier_write_is_bit_identical_to_jax(weights, quant):
    """One row-frontier decode step of B = 4 rows at different frontiers
    over a cache of random content; row 3 is inactive and parks at slot 0,
    as the JAX engine parks it. The JAX model's fp32 cache gives the fresh
    K/V it wrote (one vector per row and layer; one layer under int8); the port's
    ``write_row_frontier`` of those K/V into the same starting cache must
    leave every plane bit-identical to the JAX model's cache after its step
    (int8: the payloads and the scales), and the port's forward gives
    JAX's logits within fp32 round-off."""
    params, model = weights
    jcfg, cfg = JLlamaConfig.tiny(), LlamaConfig.tiny()
    if quant == "int8":
        # past layer 0 the fresh K/V depend on the attention over the cache,
        # which an int8 cache changes: one layer, so that the fp32 run's
        # fresh K/V are the ones the int8 run quantizes
        jcfg, cfg = dataclasses.replace(jcfg, num_layers=1), dataclasses.replace(cfg, num_layers=1)
        params = init_llama_params(jax.random.PRNGKey(2), jcfg, JFP32)
        model = convert.load_llama(tllama.build_llama(cfg, FP32, CPU), convert.flatten_tree(params))
    rng = np.random.default_rng(5)
    B, T, L, K, hd = 4, 48, cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    kv_start = np.array([9, 13, 0, 7], np.int32)
    wi = np.array([21, 40, 16, 0], np.int32)  # row 3: inactive, slot 0
    tokens = rng.integers(3, cfg.vocab_size, size=(B, 1))
    positions = np.maximum(wi - kv_start, 0)[:, None]
    shape = (L, B, K, T, hd)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))

    def jax_step(q):
        c = jllama.make_kv_cache(jcfg, B, T, jnp.float32, quant=q)
        if q == "int8":
            c = jllama.KVCache(
                k=jnp.asarray(rng.integers(-127, 128, shape), jnp.int8),
                v=jnp.asarray(rng.integers(-127, 128, shape), jnp.int8),
                k_scale=jnp.asarray(rng.random(shape[:-1]), jnp.float32),
                v_scale=jnp.asarray(rng.random(shape[:-1]), jnp.float32),
            )
        else:
            c = jllama.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0))
        before = [np.array(x) for x in _planes(c)]
        jm = jllama.LlamaModel(jcfg, JFP32, attn_impl="xla", row_frontier=True, kv_quant=q)
        logits, after = jm.apply(
            {"params": params}, jnp.asarray(tokens, jnp.int32), jnp.asarray(positions, jnp.int32), c,
            jnp.asarray(kv_start), jnp.asarray(wi + 1), jnp.asarray(wi),
        )
        return before, [np.asarray(x) for x in _planes(after)], np.asarray(logits)

    # the fresh K/V the JAX model wrote, from its fp32 cache
    _, (jk, jv), _ = jax_step("bf16")
    rows = np.arange(B)
    # (numpy puts the broadcast row index first: [B, L, K, hd] -> [L, B, K, hd])
    fresh_k = torch.from_numpy(np.moveaxis(jk[:, rows, :, wi], 0, 1))
    fresh_v = torch.from_numpy(np.moveaxis(jv[:, rows, :, wi], 0, 1))
    before, want, jlogits = jax_step(quant) if quant == "int8" else ([k0, v0], [jk, jv], None)
    cache = tllama.KVCache(*[torch.from_numpy(x.copy()) for x in before])
    for layer in range(L):
        tllama.write_row_frontier(cache, layer, fresh_k[layer][:, None], fresh_v[layer][:, None],
                                  torch.from_numpy(wi))
    for got, w in zip(_planes(cache), want):
        assert str(got.dtype).endswith(str(w.dtype))
        assert np.array_equal(got.numpy(), w), "row-frontier write differs from JAX's"
    # only each row's frontier slot changed
    changed = [np.argwhere((a != b).reshape(L, B, K, T, -1).any(axis=(0, 2, 4))) for a, b in zip(want, before)]
    assert all({tuple(x) for x in c} <= {(b, int(wi[b])) for b in range(B)} for c in changed)

    # the port's forward: the same logits and the same cache
    tcache = tllama.KVCache(*[torch.from_numpy(x.copy()) for x in before])
    jl = jlogits if jlogits is not None else jax_step("bf16")[2]
    with torch.no_grad():
        tl = model(torch.from_numpy(tokens), torch.from_numpy(positions), tcache, torch.from_numpy(kv_start),
                   torch.from_numpy(wi + 1), torch.from_numpy(wi), row_frontier=True)
    np.testing.assert_allclose(tl.numpy(), jl, atol=5e-4 if quant == "int8" else 1e-4, rtol=0)
    if quant == "bf16":
        for got, w in zip(_planes(tcache), want):
            np.testing.assert_allclose(got.numpy(), w, atol=1e-5, rtol=0)


def test_row_frontier_refuses_what_it_does_not_serve(weights):
    _, model = weights
    cfg = LlamaConfig.tiny()
    cache = tllama.make_kv_cache(cfg, 2, 32, torch.float32, CPU)
    z = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="one-token decode"):
        model(torch.zeros((2, 2), dtype=torch.int64), torch.zeros((2, 2), dtype=torch.int64), cache, z, z + 2, z,
              row_frontier=True)


# ---------------------------------------------------------------------------
# greedy streams against JAX's dense engine and the port's paged engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sync", [1, 3])
def test_dense_streams_match_jax_and_the_paged_engine(weights, sync):
    params, model = weights
    ec = dict(DENSE, decode_sync_steps=sync)
    first = [(1, PROMPTS[3], 12), (2, PROMPTS[1], 12)]
    late = [(3, PROMPTS[2], 8), (4, PROMPTS[0], 8)]
    want = drain(jax_engine(params, ec), first, late=late)
    eng = port_engine(model, ec)
    assert eng.cache is not None and eng.arena is None and eng.kv_pool is None
    got = drain(eng, first, late=late)
    assert got == want and sorted(want) == [1, 2, 3, 4]
    assert drain(port_engine(model, dict(PAGED, decode_sync_steps=sync)), first, late=late) == got
    assert eng.stats.prefill_calls == 4 and eng.stats.windows > 0  # one per bucket per group


def test_dense_group_admission_and_a_budget_cut_match_jax(weights):
    params, model = weights
    reqs = [(1, PROMPTS[0], 10), (2, PROMPTS[1], 1), (3, PROMPTS[2], 2), (4, PROMPTS[3], 10)]
    want = drain(jax_engine(params, DENSE), reqs)
    got = drain(port_engine(model, DENSE), reqs)
    assert got == want
    assert [len(got[i]) for i in (2, 3)] == [1, 2]


@pytest.mark.parametrize("sync", [1, 3])
def test_dense_eos_inside_a_window_matches_jax(weights, sync):
    """An EOS the model emits mid-stream (inside a 3-step window too): the
    stream ends before it, as in JAX, and the finished row keeps writing
    only into its own row while the others decode on."""
    params, model = weights
    ref = drain(port_engine(model, DENSE), [(1, PROMPTS[0], 10)])[1]
    eos = next(t for i, t in enumerate(ref) if i >= 2 and t not in ref[:i])
    jcfg = dataclasses.replace(JLlamaConfig.tiny(), eos_token_ids=(eos,))
    cfg = dataclasses.replace(LlamaConfig.tiny(), eos_token_ids=(eos,))
    ec = dict(DENSE, decode_sync_steps=sync)
    reqs = [(i + 1, p, 10) for i, p in enumerate(PROMPTS)]
    want = drain(jax_engine(params, ec, jcfg), reqs)
    assert 0 < len(want[1]) < 10, "the EOS never fired mid-stream"
    assert drain(port_engine(model, ec, cfg), reqs) == want


def test_dense_int8_kv_streams_match_jax(weights):
    params, model = weights
    ec = dict(DENSE, kv_quant="int8")
    reqs = [(i + 1, p, 10) for i, p in enumerate(PROMPTS)]
    want = drain(jax_engine(params, ec), reqs)
    eng = port_engine(model, ec)
    assert eng.cache.k.dtype == torch.int8 and eng.cache.k_scale is not None
    assert drain(eng, reqs) == want and len(want) == len(PROMPTS)


def test_dense_evicted_row_is_readmitted_as_in_jax(weights):
    """Request 1 is evicted after 3 windows and request 5 takes its row:
    the copy overwrites the row's slots, and every stream equals JAX's."""
    params, model = weights
    reqs = [(1, PROMPTS[3], 20), (2, PROMPTS[0], 20), (3, PROMPTS[1], 20), (4, PROMPTS[2], 20)]
    late = [(5, PROMPTS[0][:5], 6)]
    want = drain(jax_engine(params, DENSE), reqs, late=late, evict=[1])
    eng = port_engine(model, DENSE)
    got = drain(eng, reqs, late=late, evict=[1])
    assert got == want and 1 not in got and sorted(got) == [2, 3, 4, 5]


def test_a_planted_insert_fault_resets_the_dense_engine(weights):
    """The ``insert`` site sits between the prefill and the rows' update:
    a fault there resets the engine and raises ``EngineStateLost``; the
    scheduler resubmits, and the stream is the fault-free one."""
    params, model = weights
    eng = port_engine(model, DENSE)
    eng.admit_many([(1, PROMPTS[0], 10, None)])
    assert eng.has_active()
    faults.arm("insert", times=1)
    try:
        with pytest.raises(EngineStateLost):
            eng.admit_many([(2, PROMPTS[1], 10, None)])
    finally:
        faults.clear()
    assert not eng.has_active() and eng.free_slots() == list(range(eng.B))
    want = drain(jax_engine(params, DENSE), [(1, PROMPTS[2], 10)])[1]
    sched = ContinuousScheduler(port_engine(model, DENSE), retry_backoff_s=0.0)
    faults.arm("insert", times=1)
    try:
        assert sched.submit(PROMPTS[2], 10, timeout=120) == want
        assert sched._m_resets.value == 1
    finally:
        faults.clear()
        sched.shutdown()


def test_a_seeded_dense_stream_equals_the_paged_seeded_stream(weights):
    _, model = weights
    reqs = [(i + 1, p, 10) for i, p in enumerate(PROMPTS)]
    seeds = {1: 11, 2: 12, 3: 13, 4: 14}
    dense = drain(port_engine(model, DENSE, **SAMPLED), reqs, seeds)
    assert dense == drain(port_engine(model, PAGED, **SAMPLED), reqs, seeds)
    assert dense != drain(port_engine(model, DENSE), reqs)  # the draws are not argmax


# ---------------------------------------------------------------------------
# the dense branches, construction errors, and the dense service
# ---------------------------------------------------------------------------


def test_the_dense_engine_has_no_pool(weights):
    params, model = weights
    eng = port_engine(model, DENSE)
    jeng = jax_engine(params, DENSE)
    eng.admit_many([(1, PROMPTS[3], 10, None)])
    jeng.admit_many([(1, PROMPTS[3], 10, None)])
    for e in (eng, jeng):
        assert e.blocks_needed(4000) == 0 and e.admission_state(4000) == "ok"
        assert e.pool_used_tokens() == 0 and e.drain_preempted() == []
    reg = metrics.MetricsRegistry()
    eng.bind_metrics(reg)
    snap = reg.snapshot()
    for name in ("rag_kv_pool_blocks_total", "rag_kv_pool_blocks_in_use", "rag_kv_pool_fragmentation",
                 "rag_kv_pool_device_bytes"):
        assert snap[name] == 0.0, name
    assert eng.stats.preemptions == 0


@pytest.mark.parametrize("extra,match", [
    (dict(interleave_prefill=True), "interleave_prefill=True requires kv_paged=True"),
    (dict(spec_paged=True), "spec_paged=True requires kv_paged=True"),
])
def test_dense_construction_errors_are_jax_s(weights, extra, match):
    params, model = weights
    with pytest.raises(ValueError, match=match) as want:
        jax_engine(params, dict(DENSE, **extra))
    with pytest.raises(ValueError) as got:
        port_engine(model, dict(DENSE, **extra))
    assert str(got.value) == str(want.value)


def test_the_dense_service_answers_a_burst_as_the_one_shot_service():
    """``build_scheduler`` over ``kv_paged=False`` serves the dense engine:
    ``/healthz`` reports ``"continuous"``, and concurrent ``/generate``
    requests answer what the one-shot service answers."""
    one_shot, dense = _dense_service_pair()
    c1, c2 = tapp.create_app(one_shot).test_client(), tapp.create_app(dense).test_client()
    eng = dense.scheduler.engine
    try:
        assert eng.cache is not None and eng.kv_pool is None and eng.model is one_shot.engine.model
        assert c2.get("/healthz").get_json()["engine_mode"] == "continuous"
        got = [None] * len(C.QUESTIONS)

        def ask(i):
            got[i] = c2.post("/generate", json_body={"prompt": C.QUESTIONS[i]})

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(C.QUESTIONS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for q, r in zip(C.QUESTIONS, got):
            assert r is not None and r.status_code == 200
            assert r.get_json()["generated_text"] == c1.post("/generate", json_body={"prompt": q}).get_json()[
                "generated_text"]
        assert eng.stats.prefill_calls > 0 and not eng.has_active()
    finally:
        dense.shutdown()


def _dense_service_pair():
    """A one-shot service and a dense continuous one over one engine, one
    store and one copy of the weights (``tests/test_torch_continuous.py``'s
    ``services`` fixture with ``kv_paged=False``), three documents in."""
    lc, ec = LlamaConfig.tiny(C.VOCAB), EncoderConfig.tiny(C.VOCAB)
    lparams = init_llama_params(jax.random.PRNGKey(0), JLlamaConfig.tiny(C.VOCAB), JFP32)
    eparams = init_encoder_params(jax.random.PRNGKey(1), JEncoderConfig.tiny(C.VOCAB), JFP32)
    model = convert.load_llama(tllama.build_llama(lc, FP32, CPU), convert.flatten_tree(lparams))
    enc = convert.load_encoder(build_encoder(ec, FP32, CPU), convert.flatten_tree(eparams))
    engine = InferenceEngine(lc, model, sampling=SamplingConfig(**GREEDY),
                             engine_config=EngineConfig(**C.SERVICE_ENGINE), dtypes=FP32, device="cpu")
    encoder = EncoderRunner(ec, enc, device="cpu", length_buckets=(32, 64), max_batch=4)
    store = VectorStore(dim=ec.hidden_size, device="cpu")
    cfg = AppConfig(model=lc, encoder=ec, engine=engine.engine_config)
    one_shot = tapp.RagService(cfg, engine, C.ByteTokenizer(), encoder, C.ByteTokenizer(), store)
    dense_ec = dataclasses.replace(engine.engine_config, batching="continuous")
    dense = tapp.RagService(dataclasses.replace(cfg, engine=dense_ec), engine, C.ByteTokenizer(), encoder,
                            C.ByteTokenizer(), store, scheduler=tapp.build_scheduler(engine, dense_ec))
    for svc in (one_shot, dense):
        svc.ready = True
    client = tapp.create_app(one_shot).test_client()
    for i, text in enumerate(["flash attention kernels tile queries and keys in shared memory",
                              "retrieval ranks chunk embeddings by squared distance",
                              "the server assembles the prompt on the device from chunk tokens"]):
        assert client.post("/upload_pdf", files={"file": (f"d{i}.pdf", C._pdf(text))}).status_code == 200
    return one_shot, dense


# ---------------------------------------------------------------------------
# engine tasks (ContinuousScheduler.run_on_engine)
# ---------------------------------------------------------------------------


def _task_script(sched, eng, prompt):
    """While a task holds the dispatcher, a submit, a task, a failing task
    and a task queue behind it in that order; returns what the tasks saw
    (the active rows, each time) and the submit's tokens."""
    seen = []
    gate = threading.Event()
    assert sched.run_on_engine(lambda e: gate.wait(30))  # holds the dispatcher
    out = {}
    t = threading.Thread(target=lambda: out.update(tokens=sched.submit(prompt, 10, timeout=120)))
    t.start()
    while sched._queue.qsize() < 1:
        time.sleep(0.001)
    assert sched.run_on_engine(lambda e: seen.append(("first", e is eng, [s.active for s in e.slots])))
    assert sched.run_on_engine(lambda e: 1 / 0)
    assert sched.run_on_engine(lambda e: seen.append(("after the failure", e is eng, [s.active for s in e.slots])))
    gate.set()
    t.join(timeout=120)
    return seen, out["tokens"]


@pytest.mark.parametrize("ec", [DENSE, PAGED], ids=["dense", "paged"])
def test_engine_tasks_run_in_order_with_submits_as_in_jax(weights, ec, caplog):
    """The same script on the JAX and the port scheduler: the tasks run in
    arrival order on the dispatcher thread, between admissions and windows
    (the submit queued before them joins its admission group after they
    ran, as in JAX), a failing task is logged and the loop serves on; after
    shutdown a task is refused, and a non-callable raises ``TypeError``."""
    params, model = weights
    jeng = jax_engine(params, DENSE)
    jsched = JContinuousScheduler(jeng)
    try:
        want_seen, want = _task_script(jsched, jeng, PROMPTS[0])
    finally:
        jsched.shutdown()
    eng = port_engine(model, ec)
    sched = ContinuousScheduler(eng)
    names = []
    try:
        assert sched.run_on_engine(lambda e: names.append(threading.current_thread().name))
        with caplog.at_level(logging.ERROR, logger="rag_llm_k8s_tpu_torch.engine.continuous"):
            seen, got = _task_script(sched, eng, PROMPTS[0])
        assert got == want and seen == want_seen
        assert [x[0] for x in seen] == ["first", "after the failure"] and all(x[1] for x in seen)
        assert names == ["continuous-scheduler"]
        assert "engine task failed (engine state intact)" in caplog.text
        assert sched.submit(PROMPTS[0], 10, timeout=120) == want
    finally:
        sched.shutdown()
    assert sched.run_on_engine(lambda e: None) is False
    assert jsched.run_on_engine(lambda e: None) is False
    for s in (sched, jsched):
        with pytest.raises(TypeError, match="callable"):
            s.run_on_engine("not a task")


@pytest.mark.parametrize("ec", [DENSE, PAGED], ids=["dense", "paged"])
def test_an_engine_task_that_loses_the_state_resubmits_the_requests_in_flight(weights, ec):
    """A task that resets the engine and raises ``EngineStateLost`` mid-burst
    recovers as a failed window does: every request in flight restarts from
    its prompt and delivers the stream it would have without the fault."""
    params, model = weights
    reqs = [(i + 1, p, 12) for i, p in enumerate(PROMPTS)]
    want = drain(jax_engine(params, DENSE), reqs)
    eng = port_engine(model, ec)
    sched = ContinuousScheduler(eng, retry_backoff_s=0.0)
    fired = threading.Event()

    def lose(e):
        if e.has_active():
            fired.set()
            e.reset()
            raise EngineStateLost("task lost the engine state")
        assert sched.run_on_engine(lose)  # again, until a row is in flight

    outs = [None] * len(PROMPTS)
    try:
        threads = [threading.Thread(target=lambda i=i: outs.__setitem__(i, sched.submit(PROMPTS[i], 12, timeout=120)))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        assert sched.run_on_engine(lose)
        for t in threads:
            t.join(timeout=300)
        assert fired.is_set()
        assert outs == [want[i + 1] for i in range(len(PROMPTS))]
        assert sched._m_resets.value == 1
    finally:
        sched.shutdown()
    if eng.kv_pool is not None:
        assert eng.kv_pool.blocks_in_use() == 0
