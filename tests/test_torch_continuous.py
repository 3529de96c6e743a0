"""The port's paged continuous engine, scheduler and service against the JAX
package's, on the same tiny fp32 weights (bridged by ``models/convert.py``).

- the scheduler's decision core (``sim/policy.py``) and the block pool
  against the JAX package's on the same inputs;
- greedy streams token for token against JAX's ``ContinuousEngine``
  (``attn_impl="xla"``) with phase-separated and interleaved admission:
  group admission, mid-flight admission, and a pool tight enough to
  preempt; no block leaks after a drain;
- port-only properties: a seeded request samples the same stream with
  interleaving on and off, and alone or beside others;
- a tiny continuous service: concurrent ``/generate`` requests from
  threads answer what the same questions answer alone.
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
from rag_llm_k8s_tpu.core.config import EncoderConfig as JEncoderConfig
from rag_llm_k8s_tpu.core.config import EngineConfig as JEngineConfig
from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
from rag_llm_k8s_tpu.core.config import SamplingConfig as JSampling
from rag_llm_k8s_tpu.engine import kv_pool as jkv_pool
from rag_llm_k8s_tpu.engine.continuous import ContinuousEngine as JContinuousEngine
from rag_llm_k8s_tpu.engine.continuous import ContinuousScheduler as JContinuousScheduler
from rag_llm_k8s_tpu.models.bge_m3 import init_encoder_params
from rag_llm_k8s_tpu.models.llama import init_llama_params
from rag_llm_k8s_tpu.sim import policy as jpolicy
from rag_llm_k8s_tpu_torch.core.config import (
    AppConfig,
    DTypePolicy,
    EncoderConfig,
    EngineConfig,
    LlamaConfig,
    SamplingConfig,
)
from rag_llm_k8s_tpu_torch.engine import kv_pool
from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine, ContinuousScheduler
from rag_llm_k8s_tpu_torch.engine.encoder import EncoderRunner
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.index.store import VectorStore
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.bge_m3 import build_encoder
from rag_llm_k8s_tpu_torch.models.llama import build_llama
from rag_llm_k8s_tpu_torch.server import app as tapp
from rag_llm_k8s_tpu_torch.sim import policy

CPU = torch.device("cpu")
FP32 = DTypePolicy.fp32()
JFP32 = JDTypes.fp32()
GREEDY = dict(do_sample=False, max_new_tokens=10)
# the JAX package's own paged configurations and prompts
# (tests/test_chunked_prefill.py)
PAGED = dict(prompt_buckets=(16, 32), max_batch_size=4, max_seq_len=64, kv_paged=True, kv_block_size=16)
INTER = dict(PAGED, interleave_prefill=True, prefill_chunk_tokens=8)
PROMPTS = [
    [5, 6, 7, 8, 9, 10, 11],
    [12, 13, 14],
    [3] * 20,
    [9] * 25,
]
MODES = {"phase-separated": PAGED, "interleaved": INTER}


@pytest.fixture(scope="module")
def weights():
    params = init_llama_params(jax.random.PRNGKey(0), JLlamaConfig.tiny(), JFP32)
    model = convert.load_llama(build_llama(LlamaConfig.tiny(), FP32, CPU), convert.flatten_tree(params))
    return params, model


def jax_engine(params, ec, **samp):
    return JContinuousEngine(
        JLlamaConfig.tiny(), params, sampling=JSampling(**{**GREEDY, **samp}),
        engine_config=JEngineConfig(**ec, attn_impl="xla"), dtypes=JFP32,
    )


def port_engine(model, ec, **samp):
    return ContinuousEngine(
        LlamaConfig.tiny(), model, SamplingConfig(**{**GREEDY, **samp}), EngineConfig(**ec), FP32, "cpu",
    )


def drain(eng, reqs, seeds=None, late=(), late_after=3):
    """Admit ``reqs`` as one group, step ``late_after`` windows, admit
    ``late`` mid-flight, then step to completion: ``{rid: tokens}``. No
    block may be left in use."""
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
        if i == late_after and late:
            admit(late)
        for rid, toks in eng.step():
            results[rid] = toks
        if i >= late_after and not eng.has_active():
            break
    assert eng.kv_pool.blocks_in_use() == 0
    return results


# ---------------------------------------------------------------------------
# decision core and block pool
# ---------------------------------------------------------------------------


class TestPolicyMatchesJax:
    @pytest.mark.parametrize("tokens,bs", [(0, 16), (1, 16), (16, 16), (17, 16), (4351, 16), (65, 32)])
    def test_block_arithmetic(self, tokens, bs):
        assert policy.blocks_for(tokens, bs) == jpolicy.blocks_for(tokens, bs)
        assert policy.admission_blocks(tokens, bs) == jpolicy.admission_blocks(tokens, bs)
        for horizon, mb in ((1, 4), (4, 272), (64, 3)):
            assert policy.window_blocks(tokens, horizon, bs, mb) == jpolicy.window_blocks(tokens, horizon, bs, mb)

    @pytest.mark.parametrize("need,usable,inter", [(3, 10, False), (3, 10, True), (11, 10, False), (8, 8, False)])
    def test_admission_verdict(self, need, usable, inter):
        assert policy.admission_verdict(need, usable, inter, 8) == jpolicy.admission_verdict(need, usable, inter, 8)

    def test_buckets_budgets_and_groups(self):
        for n in (1, 16, 17, 32, 33, 99):
            assert policy.bucket_len(n, (16, 32)) == jpolicy.bucket_len(n, (16, 32))
        for args in ((10, 32, 128), (200, 32, 128), (0, 16, 64)):
            assert policy.clamp_max_new(*args) == jpolicy.clamp_max_new(*args)
        bucketed = [(0, 16), (1, 32), (2, 16), (3, 16), (4, 32), (5, 16), (6, 16)]
        for mb in (1, 2, 4, 8):
            assert policy.admission_chunks(bucketed, mb) == jpolicy.admission_chunks(bucketed, mb)

    def test_growth_preemption_and_mixed_windows(self):
        rows = [(3, 0, 15, 1), (1, 1, 31, 2), (2, 2, 40, 3), (4, 3, 0, 0)]
        for horizon in (None, {1: 4}, {}):
            for k in (1, 4):
                assert policy.grow_shortfall(rows, k, horizon, 16, 8) == jpolicy.grow_shortfall(
                    rows, k, horizon, 16, 8)
        active = [(5, 2), (9, 0), (7, 3)]
        assert policy.preempt_victim(active) == jpolicy.preempt_victim(active)
        adm = [(11, 25, 0), (12, 7, 0), (13, 20, 8)]
        for budget, n_dec in ((12, 4), (12, 0), (4, 4), (72, 8)):
            assert policy.plan_mixed_window(adm, budget, n_dec, 8) == jpolicy.plan_mixed_window(adm, budget, n_dec, 8)
        for args in ((10, 3, 32), (30, 3, 32), (10, 0, 32)):
            assert policy.resume_fits(*args) == jpolicy.resume_fits(*args)


def test_block_pool_matches_jax_through_alloc_ref_free_reset():
    ours, theirs = kv_pool.KVBlockPool(9, 16), jkv_pool.KVBlockPool(9, 16)
    assert kv_pool.NULL_BLOCK == jkv_pool.NULL_BLOCK == 0

    def same():
        assert ours.available() == theirs.available()
        assert ours.blocks_in_use() == theirs.blocks_in_use()
        for k, v in ours.stats().items():
            assert theirs.stats()[k] == v, k

    a, ja = ours.alloc(3), theirs.alloc(3)
    assert a == ja and 0 not in a
    same()
    ours.ref(a[:1])
    theirs.ref(ja[:1])
    assert ours.free(a) == theirs.free(ja) == 2
    assert ours.refcount(a[0]) == theirs.refcount(ja[0]) == 1
    same()
    with pytest.raises(kv_pool.PoolExhausted):
        ours.alloc(8)
    with pytest.raises(jkv_pool.PoolExhausted):
        theirs.alloc(8)
    same()
    assert ours.alloc(7) == theirs.alloc(7)
    ours.reset()
    theirs.reset()
    same()
    with pytest.raises(ValueError):
        ours.free([a[1]])  # already back in the pool
    assert ours.blocks_in_use() == 0 and ours.usable_blocks() == 8


def test_interleave_needs_the_paged_arena_like_jax():
    for kw in (dict(interleave_prefill=True), dict(INTER, prefill_chunk_tokens=0),
               dict(INTER, window_token_budget=4)):
        with pytest.raises(ValueError):
            JEngineConfig(**kw).validate_interleave()
        with pytest.raises(ValueError):
            EngineConfig(**kw).validate_interleave()
    EngineConfig(**INTER).validate_interleave()


# ---------------------------------------------------------------------------
# greedy streams against JAX's ContinuousEngine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_group_admission_streams_match_jax(weights, mode):
    params, model = weights
    reqs = [(i + 1, p, 10) for i, p in enumerate(PROMPTS)]
    want = drain(jax_engine(params, MODES[mode]), reqs)
    eng = port_engine(model, MODES[mode])
    assert drain(eng, reqs) == want
    assert len(want) == len(PROMPTS)
    if mode == "interleaved":
        assert eng.stats.mixed_windows > 0 and eng.stats.prefill_calls == 0
    else:
        assert eng.stats.prefill_calls > 0 and eng.stats.mixed_windows == 0


@pytest.mark.parametrize("mode", MODES)
def test_mid_flight_admission_streams_match_jax(weights, mode):
    params, model = weights
    first = [(1, PROMPTS[3], 12), (2, PROMPTS[1], 12)]
    late = [(3, PROMPTS[2], 8), (4, PROMPTS[0], 8)]
    want = drain(jax_engine(params, MODES[mode]), first, late=late)
    assert drain(port_engine(model, MODES[mode]), first, late=late) == want
    assert sorted(want) == [1, 2, 3, 4]


def _submit_all(sched, prompts, max_new):
    outs, errs = [None] * len(prompts), [None] * len(prompts)

    def run(i):
        try:
            outs[i] = sched.submit(prompts[i], max_new_tokens=max_new, timeout=120)
        except BaseException as e:  # noqa: BLE001 — reported below
            errs[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert errs == [None] * len(prompts), errs
    return outs


@pytest.mark.parametrize("mode", MODES)
def test_pool_preemption_keeps_streams_and_leaks_nothing(weights, mode):
    """A pool of 8 blocks (one row's worth) for four rows growing to 40 new
    tokens: rows are preempted and resubmitted as prompt + emitted tokens,
    and every stream still equals JAX's on an unconstrained pool and, with
    interleaving, JAX's scheduler on the same tight pool. (On this pool the
    JAX package's phase-separated scheduler retries a group admission that
    outgrew the pool without running a window in between, and never
    finishes; the port runs a window before each retry.)"""
    params, model = weights
    tight = dict(MODES[mode], kv_pool_blocks=8)
    want = drain(jax_engine(params, PAGED), [(i + 1, p, 40) for i, p in enumerate(PROMPTS)])
    want = [want[i + 1] for i in range(len(PROMPTS))]
    eng = port_engine(model, tight)
    sched = ContinuousScheduler(eng)
    try:
        got = _submit_all(sched, PROMPTS, 40)
    finally:
        sched.shutdown()
    assert got == want
    assert eng.stats.preemptions > 0
    assert eng.kv_pool.blocks_in_use() == 0
    if mode == "interleaved":
        jsched = JContinuousScheduler(jax_engine(params, tight))
        try:
            assert _submit_all(jsched, PROMPTS, 40) == got
        finally:
            jsched.shutdown()


def test_evict_and_reset_return_every_block(weights):
    _, model = weights
    eng = port_engine(model, INTER)
    eng.admit_many([(1, PROMPTS[3], 20, None), (2, PROMPTS[0], 20, None)])
    eng.step()
    assert eng.kv_pool.blocks_in_use() > 0
    assert sorted(eng.evict_requests([1])) == [0]
    eng.step()
    eng.reset()
    assert eng.kv_pool.blocks_in_use() == 0 and not eng.has_active()
    assert eng.free_slots() == list(range(eng.B))


# ---------------------------------------------------------------------------
# seeded sampling: keyed by (seed, position) only
# ---------------------------------------------------------------------------

SAMPLED = dict(do_sample=True, temperature=0.7, top_p=0.9)


def test_seeded_streams_equal_with_interleave_on_and_off(weights):
    _, model = weights
    reqs = [(i + 1, p, 10) for i, p in enumerate(PROMPTS)]
    seeds = {1: 11, 2: 12, 3: 13, 4: 14}
    off = drain(port_engine(model, PAGED, **SAMPLED), reqs, seeds)
    on = drain(port_engine(model, INTER, **SAMPLED), reqs, seeds)
    assert on == off
    greedy = drain(port_engine(model, PAGED), reqs)
    assert off != greedy  # the draws are not argmax


def test_seeded_stream_is_the_same_alone_and_batched(weights):
    _, model = weights
    seeds = {1: 21, 2: 22, 3: 23, 4: 24}
    batched = drain(port_engine(model, INTER, **SAMPLED), [(i + 1, p, 10) for i, p in enumerate(PROMPTS)], seeds)
    for i, p in enumerate(PROMPTS):
        alone = drain(port_engine(model, PAGED, **SAMPLED), [(i + 1, p, 10)], seeds)
        assert alone[i + 1] == batched[i + 1]
    other = drain(port_engine(model, PAGED, **SAMPLED), [(1, PROMPTS[0], 10)], {1: 99})
    assert other[1] != batched[1]  # the seed matters


def test_scheduler_request_sampling_overrides_the_engine(weights):
    _, model = weights
    sched = ContinuousScheduler(port_engine(model, INTER, **SAMPLED))
    try:
        greedy = sched.submit(PROMPTS[0], 10, sampling=SamplingConfig(do_sample=False))
        sampled = sched.submit(PROMPTS[0], 10, seed=5)
    finally:
        sched.shutdown()
    assert greedy == drain(port_engine(model, PAGED), [(1, PROMPTS[0], 10)])[1]
    assert sampled == drain(port_engine(model, PAGED, **SAMPLED), [(1, PROMPTS[0], 10)], {1: 5})[1]
    with pytest.raises(RuntimeError, match="shut down"):
        sched.submit(PROMPTS[0], 4)


def test_a_failed_window_fails_its_requests_and_the_scheduler_serves_on(weights, monkeypatch):
    """With no retries (``inflight_retries=0``, the JAX scheduler's
    fail-on-first-fault setting) a failed window fails its requests; the
    default of one retry is held in ``tests/test_torch_resilience.py``."""
    _, model = weights
    eng = port_engine(model, PAGED)
    sched = ContinuousScheduler(eng, retries=0)
    real = eng.step
    calls = []

    def broken():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("window failed")
        return real()

    monkeypatch.setattr(eng, "step", broken)
    try:
        with pytest.raises(RuntimeError, match="window failed"):
            sched.submit(PROMPTS[0], 10, timeout=60)
        assert eng.kv_pool.blocks_in_use() == 0
        assert sched.submit(PROMPTS[0], 10, timeout=60) == drain(port_engine(model, PAGED), [(1, PROMPTS[0], 10)])[1]
    finally:
        sched.shutdown()


# ---------------------------------------------------------------------------
# the continuous service
# ---------------------------------------------------------------------------

VOCAB = 300
SERVICE_ENGINE = dict(prompt_buckets=(128, 512), max_batch_size=4, max_seq_len=640)
QUESTIONS = ["what do kernels tile?", "how are chunks ranked?", "where is the prompt built?",
             "what does the server assemble?"]


class ByteTokenizer:
    def encode(self, text):
        return [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids, skip_special_tokens=True):
        return bytes((i - 3) % 256 for i in ids if i >= 3).decode("utf-8", "replace")


def _pdf(text):
    content = f"BT /F1 12 Tf ({text}) Tj ET".encode()
    return b"".join([
        b"%PDF-1.4\n",
        b"1 0 obj << /Type /Catalog /Pages 2 0 R >> endobj\n",
        b"2 0 obj << /Type /Pages /Kids [3 0 R] /Count 1 >> endobj\n",
        b"3 0 obj << /Type /Page /Parent 2 0 R /Contents 4 0 R "
        b"/Resources << /Font << /F1 5 0 R >> >> >> endobj\n",
        b"4 0 obj << /Length %d >> stream\n%s\nendstream endobj\n" % (len(content), content),
        b"5 0 obj << /Type /Font /Subtype /Type1 /BaseFont /Helvetica >> endobj\n",
        b"%%EOF",
    ])


@pytest.fixture(scope="module")
def services():
    """One-shot and continuous services over one engine, one store and one
    copy of the weights; three documents ingested."""
    lc, ec = LlamaConfig.tiny(VOCAB), EncoderConfig.tiny(VOCAB)
    lparams = init_llama_params(jax.random.PRNGKey(0), JLlamaConfig.tiny(VOCAB), JFP32)
    eparams = init_encoder_params(jax.random.PRNGKey(1), JEncoderConfig.tiny(VOCAB), JFP32)
    model = convert.load_llama(build_llama(lc, FP32, CPU), convert.flatten_tree(lparams))
    enc = convert.load_encoder(build_encoder(ec, FP32, CPU), convert.flatten_tree(eparams))
    engine = InferenceEngine(lc, model, sampling=SamplingConfig(**GREEDY),
                             engine_config=EngineConfig(**SERVICE_ENGINE), dtypes=FP32, device="cpu")
    encoder = EncoderRunner(ec, enc, device="cpu", length_buckets=(32, 64), max_batch=4)
    store = VectorStore(dim=ec.hidden_size, device="cpu")
    cfg = AppConfig(model=lc, encoder=ec, engine=engine.engine_config)
    one_shot = tapp.RagService(cfg, engine, ByteTokenizer(), encoder, ByteTokenizer(), store)
    cont_ec = dataclasses.replace(engine.engine_config, batching="continuous", kv_paged=True,
                                  interleave_prefill=True, prefill_chunk_tokens=64)
    sched = tapp.build_scheduler(engine, cont_ec)
    cont = tapp.RagService(dataclasses.replace(cfg, engine=cont_ec), engine, ByteTokenizer(), encoder,
                           ByteTokenizer(), store, scheduler=sched)
    for svc in (one_shot, cont):
        svc.ready = True
    c1, c2 = tapp.create_app(one_shot).test_client(), tapp.create_app(cont).test_client()
    for i, text in enumerate(["flash attention kernels tile queries and keys in shared memory",
                              "retrieval ranks chunk embeddings by squared distance",
                              "the server assembles the prompt on the device from chunk tokens"]):
        assert c1.post("/upload_pdf", files={"file": (f"d{i}.pdf", _pdf(text))}).status_code == 200
    try:
        yield c1, c2, cont
    finally:
        cont.shutdown()


def test_build_scheduler_shares_the_weights_and_reports_the_mode(services):
    c1, c2, cont = services
    assert cont.scheduler.engine.model is cont.engine.model
    assert c1.get("/healthz").get_json()["engine_mode"] == "one-shot"
    assert c2.get("/healthz").get_json()["engine_mode"] == "continuous-interleaved"
    assert tapp.build_scheduler(cont.engine, cont.engine.engine_config) is None  # batching="coalesce"
    assert tapp.engine_mode(None) == "one-shot"


def test_concurrent_generate_answers_what_each_question_answers_alone(services):
    c1, c2, cont = services
    got = [None] * len(QUESTIONS)

    def ask(i):
        got[i] = c2.post("/generate", json_body={"prompt": QUESTIONS[i]})

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(QUESTIONS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(r is not None and r.status_code == 200 for r in got)
    for q, r in zip(QUESTIONS, got):
        alone = c2.post("/generate", json_body={"prompt": q}).get_json()
        one_shot = c1.post("/generate", json_body={"prompt": q}).get_json()
        body = r.get_json()
        assert body["generated_text"] == alone["generated_text"] == one_shot["generated_text"]
        assert body["context"] == one_shot["context"] and "Document '" in body["context"]
    assert cont.scheduler.engine.kv_pool.blocks_in_use() == 0
    assert cont.scheduler.engine.stats.mixed_windows > 0


def test_per_request_sampling_is_validated(services):
    """``/generate`` does not read a ``sampling`` field, as the JAX handler
    does not: every body below gets the JAX service's 200 under both
    batching modes (``tests/test_torch_resilience.py`` holds the codes
    against the JAX test client). Per-request sampling is the Python API,
    and only the continuous scheduler takes it."""
    c1, c2, cont = services
    bodies = [{"do_sample": False}, {"do_sample": "no"}, {"temperature": True}, {"seed": 3}, [1]]
    for client in (c2, c1):
        for sampling in bodies:
            r = client.post("/generate", json_body={"prompt": QUESTIONS[0], "sampling": sampling})
            assert r.status_code == 200, (sampling, r.get_json())
    greedy = cont.answer(QUESTIONS[0], sampling=SamplingConfig(do_sample=False, max_new_tokens=10))
    assert greedy["generated_text"] == c2.post("/generate", json_body={"prompt": QUESTIONS[0]}).get_json()[
        "generated_text"]  # the service's own sampling is greedy
    one_shot = c1.app.service
    with pytest.raises(ValueError, match="per-request sampling needs batching='continuous'"):
        one_shot.answer(QUESTIONS[0], sampling=SamplingConfig(do_sample=False))


def test_the_service_never_asks_the_knn_for_more_rows_than_it_holds(services, monkeypatch):
    """The store holds 3 vectors and ``retrieval.k`` is 5: the kernel is
    asked for 3, so its fill entries past the real rows are never read."""
    _, c2, cont = services
    assert cont.store.ntotal < cont.config.retrieval.k
    asked = []
    real = tapp.knn_topk
    monkeypatch.setattr(tapp, "knn_topk", lambda *a, **kw: asked.append(kw["k"]) or real(*a, **kw))
    r = c2.post("/query", json_body={"prompt": QUESTIONS[1]})
    assert r.status_code == 200
    assert asked == [cont.store.ntotal]
    assert r.get_json()["context"].count("Document '") <= cont.store.ntotal
