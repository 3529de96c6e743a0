"""The port's paged speculative verify (``spec_paged``) against the JAX
package's, on the same tiny fp32 weights (bridged by ``models/convert.py``).

- the host half (``engine/speculative.py``) and the acceptance
  (``sampling.accept_drafts``) equal the JAX functions on the cases of
  ``tests/test_spec_paged.py`` and on a hypothesis sweep of random
  histories and drafts; ``sample_targets_per_row`` is the plain window's
  draw plane by plane;
- greedy streams with speculation on equal the JAX engine's with
  speculation on and off and the port's own with it off: mixed-length
  groups, EOS inside a verify window, the budget clamp, the row ladder's
  top, preemption of speculating rows, ``decode_sync_steps`` 3, int8 KV and
  interleaved admission; a seeded verify stream equals the port's plain
  seeded stream (JAX's threefry draws differ from the port's keyed hash by
  design, so seeded streams are held within the port);
- the routing (``_verify_worthwhile``), the per-row acceptance EMA and the
  verify counters equal JAX's window by window; the construction errors and
  the ``TPU_RAG_SPEC_PAGED*`` keys are JAX's.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rag_llm_k8s_tpu.core.config import AppConfig as JAppConfig
from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
from rag_llm_k8s_tpu.core.config import EngineConfig as JEngineConfig
from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
from rag_llm_k8s_tpu.core.config import SamplingConfig as JSampling
from rag_llm_k8s_tpu.engine import sampling as jsampling
from rag_llm_k8s_tpu.engine import speculative as jspec
from rag_llm_k8s_tpu.engine.continuous import ContinuousEngine as JContinuousEngine
from rag_llm_k8s_tpu.models.llama import init_llama_params
from rag_llm_k8s_tpu_torch.core.config import AppConfig, DTypePolicy, EngineConfig, LlamaConfig, SamplingConfig
from rag_llm_k8s_tpu_torch.engine import sampling, speculative
from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine, ContinuousScheduler
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.llama import build_llama
from rag_llm_k8s_tpu_torch.obs import flight

CPU = torch.device("cpu")
FP32 = DTypePolicy.fp32()
JFP32 = JDTypes.fp32()
GREEDY = dict(do_sample=False, max_new_tokens=10)
# the JAX package's configurations and prompts (tests/test_spec_paged.py)
PAGED = dict(prompt_buckets=(16, 32), max_batch_size=4, max_seq_len=64, kv_paged=True, kv_block_size=16)
SPEC = dict(PAGED, spec_paged=True, spec_paged_tokens=4)
# repeat-heavy prompts so that prompt lookup fires (answers quote their
# context), in two buckets
PROMPTS = [
    [3, 17, 42, 3, 17, 42, 3, 17],
    [5, 5, 8],
    [11] * 12,
    [2, 9, 2, 9, 2, 9, 2],
]


@pytest.fixture(scope="module")
def weights():
    params = init_llama_params(jax.random.PRNGKey(0), JLlamaConfig.tiny(), JFP32)
    model = convert.load_llama(build_llama(LlamaConfig.tiny(), FP32, CPU), convert.flatten_tree(params))
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


def drain(eng, reqs, seeds=None, late=(), late_after=1):
    """Admit ``reqs`` as one group, step ``late_after`` windows, admit
    ``late`` mid-flight, then step to completion: ``{rid: tokens}``; no
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


def spec_pair(weights, reqs, ec_plain=PAGED, ec_spec=SPEC, cfg=(None, None), **drain_kw):
    """Greedy streams of the JAX and the port engine with speculation off
    and on; all four must be equal. Returns the port's spec engine."""
    params, model = weights
    jcfg, tcfg = cfg
    want = drain(jax_engine(params, ec_plain, jcfg), reqs, **drain_kw)
    jspec_eng = jax_engine(params, ec_spec, jcfg)
    assert drain(jspec_eng, reqs, **drain_kw) == want
    assert drain(port_engine(model, ec_plain, tcfg), reqs, **drain_kw) == want
    eng = port_engine(model, ec_spec, tcfg)
    assert drain(eng, reqs, **drain_kw) == want
    for name in ("spec_verify_steps", "spec_drafted_tokens", "spec_accepted_tokens", "spec_emitted_tokens"):
        assert getattr(eng.stats, name) == getattr(jspec_eng.stats, name), name
    return eng, want


# ---------------------------------------------------------------------------
# host half and acceptance, against the JAX functions
# ---------------------------------------------------------------------------

LOOKUP_CASES = [
    ([7, 8, 9, 1, 7, 8, 3, 7, 8], 2, 2, [3, 7]),
    ([7, 8, 9, 1, 7, 8, 3, 7, 8], 2, 1, [3]),
    ([1, 2, 3, 1, 2], 2, 4, [3, 1, 2]),
    ([4, 5, 6], 2, 4, []),
    ([], 2, 4, []),
    ([1, 2], 2, 4, []),
    ([1, 2, 3], 2, 0, []),
    ([1, 2, 3], 0, 4, []),
]


@pytest.mark.parametrize("history,ngram,k,want", LOOKUP_CASES)
def test_prompt_lookup_draft_matches_jax(history, ngram, k, want):
    assert speculative.prompt_lookup_draft(history, ngram, k) == jspec.prompt_lookup_draft(history, ngram, k) == want


@pytest.mark.parametrize("ema,want", [(None, 8), (0.1, 1), (1.0, 8), (0.5, 4), (0.3, 2)])
def test_adaptive_draft_len_matches_jax(ema, want):
    assert speculative.adaptive_draft_len(ema, 8, 0.3) == jspec.adaptive_draft_len(ema, 8, 0.3) == want


@pytest.mark.parametrize("ema,offered,accepted", [(None, 0, 0), (None, 4, 2), (1.0, 4, 0), (0.5, 0, 0)])
def test_fold_acceptance_matches_jax(ema, offered, accepted):
    assert speculative.fold_acceptance(ema, offered, accepted) == jspec.fold_acceptance(ema, offered, accepted)
    assert speculative.SPEC_EMA_DECAY == jspec.SPEC_EMA_DECAY


def _accept_both(drafts, targets, nd):
    jm, je = jsampling.accept_drafts(jnp.asarray(drafts, jnp.int32), jnp.asarray(targets, jnp.int32),
                                     jnp.asarray(nd, jnp.int32))
    tm, te = sampling.accept_drafts(torch.as_tensor(np.asarray(drafts), dtype=torch.int64),
                                    torch.as_tensor(np.asarray(targets), dtype=torch.int64),
                                    torch.as_tensor(np.asarray(nd), dtype=torch.int64))
    return (np.asarray(jm), np.asarray(je)), (tm.numpy(), te.numpy())


def test_accept_drafts_matches_jax():
    """Row 0 accepts all three and takes the bonus, row 1 is corrected at
    plane 1, row 2 offered only two."""
    (jm, je), (tm, te) = _accept_both([[7, 8, 9]] * 3, [[7, 8, 9, 4], [7, 5, 9, 4], [7, 8, 9, 4]], [3, 3, 2])
    assert list(tm) == list(jm) == [3, 1, 2]
    for b, m in enumerate(tm):
        assert list(te[b, :m + 1]) == list(je[b, :m + 1])
    assert list(te[0]) == [7, 8, 9, 4] and list(te[1, :2]) == [7, 5] and list(te[2, :3]) == [7, 8, 9]


@settings(max_examples=200, deadline=None)
@given(history=st.lists(st.integers(0, 4), max_size=40), ngram=st.integers(0, 3), k=st.integers(0, 8))
def test_prompt_lookup_draft_sweep(history, ngram, k):
    assert speculative.prompt_lookup_draft(history, ngram, k) == jspec.prompt_lookup_draft(history, ngram, k)


@settings(max_examples=200, deadline=None)
@given(data=st.data(), B=st.integers(1, 5), K=st.integers(1, 7))
def test_accept_drafts_and_the_controller_sweep(data, B, K):
    """Random drafts over a 3-token vocabulary (so that prefixes match) and
    random per-row draft counts: the same accepted lengths and the same
    emitted planes ``0..m``; the EMA controller on random windows."""
    tok = st.integers(0, 2)
    drafts = data.draw(st.lists(st.lists(tok, min_size=K, max_size=K), min_size=B, max_size=B))
    targets = data.draw(st.lists(st.lists(tok, min_size=K + 1, max_size=K + 1), min_size=B, max_size=B))
    nd = data.draw(st.lists(st.integers(0, K), min_size=B, max_size=B))
    (jm, je), (tm, te) = _accept_both(drafts, targets, nd)
    assert list(tm) == list(jm)
    for b, m in enumerate(tm):
        assert list(te[b, :m + 1]) == list(je[b, :m + 1])
    ema = data.draw(st.one_of(st.none(), st.floats(0, 1)))
    offered = data.draw(st.integers(0, K))
    acc = data.draw(st.integers(0, offered))
    floor = data.draw(st.floats(0, 1))
    assert speculative.fold_acceptance(ema, offered, acc) == jspec.fold_acceptance(ema, offered, acc)
    assert speculative.adaptive_draft_len(ema, K, floor) == jspec.adaptive_draft_len(ema, K, floor)


def test_targets_are_the_plain_window_s_draws_plane_by_plane():
    """``sample_targets_per_row`` at plane j is ``sample_token_per_row`` at
    the plane's position: the same keyed draw a plain window makes."""
    g = torch.Generator().manual_seed(0)
    B, S, V = 3, 5, 64
    logits = torch.randn(B, S, V, generator=g)
    greedy = torch.tensor([False, True, False])
    temp, top_p = torch.tensor([0.7, 1.0, 1.3]), torch.tensor([0.9, 1.0, 0.5])
    seeds = torch.tensor([11, 12, 13])
    pos = torch.tensor([[4], [9], [30]]) + torch.arange(S)[None]
    got = sampling.sample_targets_per_row(logits, greedy, temp, top_p, seeds, pos)
    for j in range(S):
        assert torch.equal(got[:, j], sampling.sample_token_per_row(logits[:, j], greedy, temp, top_p, seeds,
                                                                    pos[:, j]))
    assert torch.equal(got[1], logits[1].argmax(-1))


# ---------------------------------------------------------------------------
# greedy streams: port spec == JAX spec == JAX plain == port plain
# ---------------------------------------------------------------------------


def test_greedy_mixed_batch_streams_match_jax(weights):
    reqs = [(i + 1, p, 10) for i, p in enumerate(PROMPTS)]
    eng, want = spec_pair(weights, reqs)
    assert len(want) == len(PROMPTS)
    st_ = eng.stats
    assert st_.spec_verify_steps > 0 and st_.spec_drafted_tokens > 0, "no verify window ran"
    assert st_.spec_accepted_tokens > 0, "nothing accepted: the identity is vacuous"
    assert st_.spec_emitted_tokens <= st_.decode_tokens + st_.spec_verify_steps * eng.B


def test_mid_flight_admission_streams_match_jax(weights):
    spec_pair(weights, [(1, PROMPTS[0], 10), (2, PROMPTS[1], 10)],
              late=[(3, PROMPTS[2], 10), (4, PROMPTS[3], 10)], late_after=2)


def test_eos_inside_a_verify_window_matches_jax(weights):
    """An EOS the model emits mid-stream ends it at the same token with
    speculation on, also when the EOS is itself an accepted draft."""
    params, model = weights
    ref = drain(port_engine(model, PAGED), [(1, PROMPTS[2], 10)])[1]
    idx = next((i for i in range(1, len(ref)) if ref[i] not in ref[:i]), len(ref) - 1)
    jcfg = dataclasses.replace(JLlamaConfig.tiny(), eos_token_ids=(ref[idx],))
    tcfg = dataclasses.replace(LlamaConfig.tiny(), eos_token_ids=(ref[idx],))
    _, want = spec_pair(weights, [(1, PROMPTS[2], 10), (2, PROMPTS[0], 10)], cfg=(jcfg, tcfg))
    assert 0 < len(want[1]) < 10, "EOS never fired mid-stream"


def test_budget_clamp_matches_jax(weights):
    """``max_new`` below the draft width: the drafter clamps to the budget
    and the stream cuts at exactly ``max_new``."""
    _, want = spec_pair(weights, [(1, PROMPTS[2], 3), (2, PROMPTS[0], 2)])
    assert [len(want[1]), len(want[2])] == [3, 2]


def test_the_row_ladder_top_matches_jax(weights):
    """Rows decoding to the top of their row: drafts clamp so the accepted
    frontier cannot overrun ``T``, and junk lanes past the table land in
    the null block, not in the row's last block."""
    tight = dict(PAGED, prompt_buckets=(16,), max_seq_len=32, max_batch_size=2)
    spec_pair(weights, [(1, [11] * 12, 40), (2, [2, 9, 2, 9, 2, 9, 2], 40)], ec_plain=tight,
              ec_spec=dict(tight, spec_paged=True, spec_paged_tokens=4))


def test_sync_steps_3_matches_jax(weights):
    reqs = [(i + 1, p, 12) for i, p in enumerate(PROMPTS)]
    spec_pair(weights, reqs, ec_plain=dict(PAGED, decode_sync_steps=3),
              ec_spec=dict(SPEC, decode_sync_steps=3))


def test_int8_kv_verify_matches_jax(weights):
    """The verify forward over the int8 arena (kernel 10's plain version)."""
    reqs = [(i + 1, p, 10) for i, p in enumerate(PROMPTS)]
    q8 = dict(PAGED, prompt_buckets=(32,), kv_quant="int8", kv_block_size=32)
    eng, _ = spec_pair(weights, reqs, ec_plain=q8, ec_spec=dict(q8, spec_paged=True, spec_paged_tokens=4))
    assert eng.arena.k.dtype == torch.int8 and eng.stats.spec_accepted_tokens > 0


def test_interleaved_admission_then_verify_matches_jax(weights):
    """Mixed windows first while admissions prefill, verify windows after."""
    inter = dict(PAGED, interleave_prefill=True, prefill_chunk_tokens=8)
    reqs = [(i + 1, p, 10) for i, p in enumerate(PROMPTS)]
    eng, _ = spec_pair(weights, reqs, ec_plain=inter, ec_spec=dict(inter, spec_paged=True, spec_paged_tokens=4))
    assert eng.stats.mixed_windows > 0 and eng.stats.spec_verify_steps > 0


def test_preemption_of_speculating_rows_keeps_the_streams(weights):
    """A pool of 8 blocks for four rows growing to 40 tokens preempts rows
    while they speculate; resubmission (prompt + emitted) gives JAX's
    spec-off streams on an unconstrained pool, and no block leaks."""
    params, model = weights
    want = drain(jax_engine(params, PAGED), [(i + 1, p, 40) for i, p in enumerate(PROMPTS)])
    eng = port_engine(model, dict(SPEC, kv_pool_blocks=8))
    sched = ContinuousScheduler(eng)
    outs, errs = [None] * len(PROMPTS), [None] * len(PROMPTS)

    def run(i):
        try:
            outs[i] = sched.submit(PROMPTS[i], max_new_tokens=40, timeout=300)
        except BaseException as e:  # noqa: BLE001 — reported below
            errs[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(PROMPTS))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sched.shutdown()
    assert errs == [None] * len(PROMPTS), errs
    assert outs == [want[i + 1] for i in range(len(PROMPTS))]
    assert eng.stats.preemptions > 0 and eng.stats.spec_verify_steps > 0
    assert eng.kv_pool.blocks_in_use() == 0
    assert not eng._spec_rids  # popped at delivery


# ---------------------------------------------------------------------------
# seeded streams: port spec == port plain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temp", [0.7, 0.01])
def test_seeded_verify_stream_equals_the_plain_stream(weights, temp):
    """The targets continue each row's (seed, position) draws, so a seeded
    stream with speculation on is the plain stream. At 0.7 the random tiny
    model's stream rarely repeats (the plain fallback under sampling); at
    0.01 it cycles, and drafts are accepted."""
    _, model = weights
    samp = dict(do_sample=True, temperature=temp, top_p=0.9)
    reqs, late = [(1, PROMPTS[0], 10)], [(2, PROMPTS[2], 10)]
    seeds = {1: 123, 2: 7}
    base = drain(port_engine(model, PAGED, **samp), reqs, seeds, late=late)
    eng = port_engine(model, SPEC, **samp)
    assert drain(eng, reqs, seeds, late=late) == base
    if temp == 0.01:
        assert eng.stats.spec_drafted_tokens > 0 and eng.stats.spec_accepted_tokens > 0, "vacuous"


# ---------------------------------------------------------------------------
# routing, the controller, errors and the environment
# ---------------------------------------------------------------------------


def test_verify_routing_is_gated_as_in_jax(weights):
    """At ``decode_sync_steps = 4`` a lone drafting row does not take the
    window from its batchmates; two do; low EMAs discount the drafts; at
    ``k = 1`` any draft verifies. Both engines answer the same."""
    params, model = weights
    sync4 = dict(SPEC, decode_sync_steps=4)
    engines = [jax_engine(params, sync4), port_engine(model, sync4)]
    for e in engines:
        e.admit_many([(1, PROMPTS[0], 10, None), (2, PROMPTS[1], 10, None)])
    cases = [({0: [1, 2, 3, 4], 1: []}, None, False), ({0: [1, 2, 3, 4], 1: [5, 6, 7, 8]}, None, True),
             ({0: [1, 2, 3, 4], 1: [5, 6, 7, 8]}, 0.1, False)]
    for drafts, ema, want in cases:
        for e in engines:
            for s in e.slots[:2]:
                s.spec_ema = ema
            assert e._verify_worthwhile(drafts) is want
    for e in engines:
        while e.has_active():
            e.step()
        assert e.kv_pool.blocks_in_use() == 0
    one = [jax_engine(params, SPEC), port_engine(model, SPEC)]
    for e in one:
        e.admit_many([(1, PROMPTS[0], 10, None)])
        assert e._verify_worthwhile({0: [1]}) is True


def test_the_controller_and_the_counters_follow_jax_window_by_window(weights):
    """Both engines step in lockstep: before each window they draft the
    same tokens, after it each live row holds the same acceptance EMA,
    tokens and history, and the verify counters agree."""
    params, model = weights
    ec = dict(SPEC, spec_paged_tokens=3)
    j, t = jax_engine(params, ec), port_engine(model, ec)
    reqs = [(i + 1, p, 16, None) for i, p in enumerate(PROMPTS)]
    for e in (j, t):
        e.admit_many(reqs)
    flight.configure(capacity=4096)
    before = len(flight.recorder().snapshot(etype="spec_verify"))
    emas = []
    for _ in range(40):
        if not t.has_active():
            break
        assert t._draft_for_slots() == j._draft_for_slots()
        j.step(), t.step()
        # (a JAX slot keeps its state once retired; the port's is cleared)
        live = [(s.request_id, s.spec_ema, s.tokens, s.history) for s in t.slots if s.active]
        assert live == [(s.request_id, s.spec_ema, s.tokens, s.history) for s in j.slots if s.active]
        emas += [s.spec_ema for s in t.slots if s.active and s.spec_ema is not None]
    assert not j.has_active()
    for name in ("spec_verify_steps", "spec_drafted_rows", "spec_drafted_tokens", "spec_accepted_tokens",
                 "spec_emitted_tokens", "decode_tokens"):
        assert getattr(t.stats, name) == getattr(j.stats, name), name
    assert any(e < 1.0 for e in emas) and t.stats.spec_verify_steps > 0
    assert len(flight.recorder().snapshot(etype="spec_verify")) - before == t.stats.spec_verify_steps
    assert {rid for rid, *_ in reqs} >= t._spec_rids and t._spec_rids == j._spec_rids
    rid = next(iter(t._spec_rids))
    assert t.pop_spec_seen(rid) and not t.pop_spec_seen(rid)


@pytest.mark.parametrize("extra,match", [
    (dict(spec_paged_tokens=0), "spec_paged_tokens"),
    (dict(spec_paged_min_accept=1.5), "spec_paged_min_accept"),
    (dict(kv_paged=False), "requires kv_paged"),
])
def test_construction_errors_are_jax_s(weights, extra, match):
    params, model = weights
    ec = dict(SPEC, **extra)
    if not ec["kv_paged"]:
        ec.pop("kv_block_size")
    with pytest.raises(ValueError, match=match) as want:
        jax_engine(params, ec)
    with pytest.raises(ValueError) as got:
        port_engine(model, ec)
    assert str(got.value) == str(want.value)


def test_the_environment_round_trips_as_in_jax():
    env = {"TPU_RAG_SPEC_PAGED": "1", "TPU_RAG_SPEC_PAGED_TOKENS": "5", "TPU_RAG_SPEC_PAGED_MIN_ACCEPT": "0.4",
           "TPU_RAG_BATCHING": "continuous", "TPU_RAG_KV_PAGED": "1"}
    got, want = AppConfig.from_env(env).engine, JAppConfig.from_env(env).engine
    assert (got.spec_paged, got.spec_paged_tokens, got.spec_paged_min_accept) == (True, 5, pytest.approx(0.4))
    assert (got.spec_paged, got.spec_paged_tokens, got.spec_paged_min_accept) == (
        want.spec_paged, want.spec_paged_tokens, want.spec_paged_min_accept)
    defaults = EngineConfig(), JEngineConfig()
    assert [(d.spec_paged, d.spec_paged_tokens, d.spec_paged_min_accept) for d in defaults] == [(False, 7, 0.3)] * 2
    for bad in ({"TPU_RAG_SPEC_PAGED": "2"}, {"TPU_RAG_SPEC_PAGED_MIN_ACCEPT": "1.5"},
                {"TPU_RAG_SPEC_PAGED_TOKENS": "0"}):
        with pytest.raises(ValueError) as w:
            JAppConfig.from_env(bad)
        with pytest.raises(ValueError) as g:
            AppConfig.from_env(bad)
        assert str(g.value) == str(w.value)
