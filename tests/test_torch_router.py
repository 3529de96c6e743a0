"""Pool roles, migration between engines and the prefix-affinity router, the
port's against the JAX package's, on the CPU (tiny fp32 weights bridged by
``models/convert.py``, JAX's engines with ``attn_impl="xla"``).

- **the hand-off** (``tests/test_router.py`` ``TestSmoke``): a request
  admitted on a prefill-role engine, exported as a packet and imported by a
  decode-role engine gives the stream a unified engine gives: greedy, equal
  to JAX's unified streams and the port's; seeded, equal to the port's
  unified streams (the port draws from its own keyed generator, so its
  sampled streams are not JAX's); int8 KV (payload and scale planes);
  neither engine keeps a block. The imported blocks equal the exported ones
  byte for byte. The journal holds one ``route_decision`` and a matching
  ``migrate_begin`` / ``migrate_done`` per request.
- **the edges**: an export of a row still prefilling in chunks (or unknown,
  or finished) returns None; ``PoolExhausted`` on import writes nothing and
  the scheduler retries after a window; the ``migrate`` fault resets the
  decode engine, which re-prefills and completes the stream JAX completes;
  a verify-enabled decode engine drafts from the packet's history.
- **the router's policy** (``TestRouterPolicy``) on stub replicas, each case
  on JAX's ``Router`` and on the port's.
- **the services** under ``pool_role="prefill"`` and ``"decode"`` answer
  ``/generate`` as the JAX services with the same setting do.

``test_pool_split_sizes_both_tiers`` and
``test_pool_plan_answers_from_a_simulated_trace`` wait for the port of
``sim/`` (``ROADMAP.md`` Queue 1 item 9c), ``TestDisaggTP2`` for the mesh
(item 10). Journal checks select events by ``seq`` from the recorder's
``events_emitted`` taken before the request.
"""

import dataclasses
import threading
import types

import jax
import pytest
import test_torch_resilience as R  # the JAX/port service pair's pieces
import torch

from rag_llm_k8s_tpu.core.config import RouterConfig as JRouterConfig
from rag_llm_k8s_tpu.obs import flight as jflight
from rag_llm_k8s_tpu.resilience import faults as jfaults
from rag_llm_k8s_tpu.server import router as jrouter
from rag_llm_k8s_tpu_torch.core.config import RouterConfig
from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine, ContinuousScheduler
from rag_llm_k8s_tpu_torch.engine.kv_pool import PoolExhausted
from rag_llm_k8s_tpu_torch.obs import flight as tflight
from rag_llm_k8s_tpu_torch.resilience import admission as tadmission
from rag_llm_k8s_tpu_torch.resilience import faults as tfaults
from rag_llm_k8s_tpu_torch.server import router as trouter

CPU = torch.device("cpu")
GREEDY = dict(do_sample=False, max_new_tokens=8)
SEEDED = dict(do_sample=True, temperature=0.8, top_p=0.9, max_new_tokens=8)
# the JAX package's own disaggregated configuration and prompts (tests/test_router.py)
PAGED = dict(prompt_buckets=(16, 32), max_batch_size=4, max_seq_len=64, kv_paged=True, kv_block_size=16)
PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [12, 13, 14], [3] * 20, [9] * 25]
SEEDS = [100 + i for i in range(len(PROMPTS))]
# int8 KV: blocks of 32 (the q8 kernels' tile), so buckets of 32
INT8 = dict(kv_quant="int8", kv_block_size=32, prompt_buckets=(32,))
JAX = types.SimpleNamespace(router=jrouter, RouterConfig=JRouterConfig)
PORT = types.SimpleNamespace(router=trouter, RouterConfig=RouterConfig)


@pytest.fixture(autouse=True)
def _clean_faults():
    tfaults.clear()
    jfaults.clear()
    yield
    tfaults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def weights():
    from rag_llm_k8s_tpu.models.llama import init_llama_params
    from rag_llm_k8s_tpu_torch.models import convert
    from rag_llm_k8s_tpu_torch.models.llama import build_llama

    params = init_llama_params(jax.random.PRNGKey(0), R.JLlamaConfig.tiny(), R.JFP32)
    return params, convert.load_llama(build_llama(R.LlamaConfig.tiny(), R.FP32, CPU), convert.flatten_tree(params))


def port_engine(model, samp=GREEDY, **ec):
    return ContinuousEngine(R.LlamaConfig.tiny(), model, R.SamplingConfig(**samp), R.EngineConfig(**{**PAGED, **ec}),
                            R.FP32, "cpu")


def port_sched(model, samp=GREEDY, **ec):
    return ContinuousScheduler(port_engine(model, samp, **ec), retry_backoff_s=0.0)


def jax_sched(params, samp=GREEDY, **ec):
    return R.jcontinuous.ContinuousScheduler(
        R.jcontinuous.ContinuousEngine(R.JLlamaConfig.tiny(), params, sampling=R.JSampling(**samp), dtypes=R.JFP32,
                                       engine_config=R.JEngineConfig(**{**PAGED, **ec}, attn_impl="xla")),
        retry_backoff_s=0.0)


def port_pair(model, samp=GREEDY, pre=None, dec=None, **ec):
    """A prefill-role and a decode-role scheduler (``pre`` / ``dec``: extra
    EngineConfig fields of one side) behind a port ``Router``."""
    p = port_sched(model, samp, pool_role="prefill", **{**ec, **(pre or {})})
    d = port_sched(model, samp, pool_role="decode", **{**ec, **(dec or {})})
    return p, d, trouter.Router([trouter.Replica("prefill-0", p), trouter.Replica("decode-0", d)])


def unified_streams(sched, seeds=None):
    try:
        return [sched.submit(p, seed=None if seeds is None else s) for p, s in zip(PROMPTS, seeds or PROMPTS)]
    finally:
        sched.shutdown()


def assert_no_leaks(*scheds):
    for sc in scheds:
        assert sc.engine.kv_pool.blocks_in_use() == 0, f"leaked blocks on the {sc.engine.pool_role} engine"


@pytest.fixture(scope="module")
def baselines(weights):
    """Unified streams: JAX's and the port's greedy (equal), the port's
    seeded and its int8-KV greedy."""
    params, model = weights
    jg = unified_streams(jax_sched(params))
    pg = unified_streams(port_sched(model))
    assert pg == jg
    return {"greedy": pg, "seeded": unified_streams(port_sched(model, SEEDED), SEEDS),
            "int8": unified_streams(port_sched(model, **INT8))}


# ---------------------------------------------------------------------------
# the hand-off
# ---------------------------------------------------------------------------


class TestSmoke:
    @pytest.mark.parametrize("mode", ["greedy", "seeded", "int8"])
    def test_disagg_stream_is_byte_identical(self, weights, baselines, mode):
        samp = SEEDED if mode == "seeded" else GREEDY
        ec = INT8 if mode == "int8" else {}
        pre, dec, router = port_pair(weights[1], samp, **ec)
        n0 = tflight.recorder().events_emitted
        try:
            got = [router.submit(p, seed=s if mode == "seeded" else None) for p, s in zip(PROMPTS, SEEDS)]
        finally:
            pre.shutdown()
            dec.shutdown()
        assert got == baselines[mode]
        assert_no_leaks(pre, dec)
        modes = [e["mode"] for e in tflight.recorder().snapshot(etype="route_decision") if e["seq"] >= n0]
        assert modes == ["disagg"] * len(PROMPTS)

    def test_migration_events_journal_the_handoff(self, weights):
        pre, dec, router = port_pair(weights[1])
        rec = tflight.recorder()
        n0 = rec.events_emitted
        info = {}
        try:
            router.submit([4, 5, 6, 7], chunk_keys=[("doc", 1)], info=info)
        finally:
            pre.shutdown()
            dec.shutdown()
        evs = [e for e in rec.snapshot(request_id=info["request_id"]) if e["seq"] >= n0]
        assert [e["type"] for e in evs] == ["arrival", "admit", "migrate_begin", "route_decision", "migrate_done",
                                            "eos", "complete"]
        rd, beg, done = evs[3], evs[2], evs[4]
        assert (rd["mode"], rd["prefill"], rd["decode"], rd["candidates"]) == ("disagg", "prefill-0", "decode-0", 2)
        assert beg["blocks"] == done["blocks"] == 1 and beg["kv_len"] == done["kv_len"] == 4

    def test_the_imported_blocks_equal_the_exported_ones(self, weights):
        for ec in ({}, INT8):
            src = port_engine(weights[1], pool_role="prefill", **ec)
            dst = port_engine(weights[1], pool_role="decode", **ec)
            row, fin = src.admit_many([(7, PROMPTS[3], 8, None)])[0]
            assert fin is None
            ids = list(src._slot_blocks[row])
            before = [p.clone() for p in src._gather_planes(ids)]
            packet = src.export_request(7)
            assert src.kv_pool.blocks_in_use() == 0 and not src.has_active()
            # 25 tokens: two blocks of 16, or one of 32
            assert len(packet["planes"]) == (4 if ec else 2) and packet["n_blocks"] == len(ids) == (1 if ec else 2)
            r2 = dst.import_request(packet)
            after = dst._gather_planes(dst._slot_blocks[r2])
            assert all(torch.equal(a, b) for a, b in zip(after, before))
            assert dst.slots[r2].tokens == packet["tokens"] and int(dst._kv_len[r2]) == len(PROMPTS[3])

    def test_unified_fallback_when_no_decode_tier(self, weights, baselines):
        uni = port_sched(weights[1])
        router = trouter.Router([trouter.Replica("uni-0", uni)])
        n0 = tflight.recorder().events_emitted
        try:
            assert router.submit(PROMPTS[0]) == baselines["greedy"][0]
            assert_no_leaks(uni)
        finally:
            uni.shutdown()
        rd = [e for e in tflight.recorder().snapshot(etype="route_decision") if e["seq"] >= n0]
        assert [(e["mode"], e["decode"]) for e in rd] == [("unified", "")]

    def test_the_tier_gate_sheds_before_any_replica(self, weights):
        pre, dec, _ = port_pair(weights[1])
        gate = tadmission.AdmissionController(max_concurrency=2, max_queue=2)
        router = trouter.Router([trouter.Replica("p", pre), trouter.Replica("d", dec)], admission=gate)
        gate.drain()
        try:
            with pytest.raises(tadmission.AdmissionRejected):
                router.submit(PROMPTS[0])
            assert pre.engine.stats.generate_calls == 0
        finally:
            pre.shutdown()
            dec.shutdown()


# ---------------------------------------------------------------------------
# the edges
# ---------------------------------------------------------------------------


def test_export_returns_none_for_a_row_it_cannot_hand_off(weights):
    inter = port_engine(weights[1], pool_role="prefill", interleave_prefill=True, prefill_chunk_tokens=8)
    res = inter.admit_many([(1, PROMPTS[2], 8, None)])
    assert res[0][1] is None and 1 in inter._chunk_admissions
    assert inter.export_request(1) is None  # still prefilling in chunks
    assert inter.export_request(99) is None  # unknown
    eng = port_engine(weights[1], pool_role="prefill")
    row, fin = eng.admit_many([(2, PROMPTS[0], 1, None)])[0]
    assert fin is not None and eng.export_request(2) is None  # finished at its first token
    dense = ContinuousEngine(R.LlamaConfig.tiny(), weights[1], R.SamplingConfig(**GREEDY),
                             R.EngineConfig(**{**PAGED, "kv_paged": False}), R.FP32, "cpu")
    dense.admit_many([(3, PROMPTS[0], 8, None)])
    assert dense.export_request(3) is None  # no pool to hand off
    with pytest.raises(ValueError, match="pool_role='prefill' requires kv_paged=True"):
        port_engine(weights[1], pool_role="prefill", kv_paged=False)


def test_pool_exhausted_on_import_writes_nothing_and_the_scheduler_retries(weights, baselines):
    src = port_engine(weights[1], pool_role="prefill")
    dst = port_engine(weights[1], pool_role="decode")
    src.admit_many([(11, PROMPTS[3], 8, None)])
    packet = src.export_request(11)
    held = dst.kv_pool.alloc(dst.kv_pool.available())
    with pytest.raises(PoolExhausted):
        dst.import_request(packet)
    assert not dst.has_active() and dst.kv_pool.blocks_in_use() == len(held)
    dst.kv_pool.free(held)
    # the packet is still whole: it lands, and decodes the unified stream
    row = dst.import_request(packet)
    out = {}
    while dst.has_active():
        out.update(dict(dst.step()))
    assert out[11] == baselines["greedy"][3]

    # the scheduler: a busy decode engine refuses once, a window runs, it lands
    pre, dec, router = port_pair(weights[1])
    real_import, calls = dec.engine.import_request, []

    def refuse_once(pkt):
        calls.append(dec.engine.has_active())
        if len(calls) == 1:
            raise PoolExhausted(pkt["n_blocks"], 0)
        return real_import(pkt)

    dec.engine.import_request = refuse_once
    busy = threading.Thread(target=lambda: out.update(busy=dec.submit(PROMPTS[1], max_new_tokens=40)))
    try:
        busy.start()
        t = threading.Event()
        while not dec.engine.has_active() and not t.wait(0.005):
            pass
        got = router.submit(PROMPTS[0])
        busy.join(60)
    finally:
        pre.shutdown()
        dec.shutdown()
    assert got == baselines["greedy"][0] and len(calls) >= 2
    assert_no_leaks(pre, dec)


def test_the_migrate_fault_reprefills_on_the_decode_engine_as_jax(weights, baselines):
    """A fault while the packet lands resets the decode engine; the request
    re-prefills there (prompt plus the packet's tokens) and completes with
    the stream JAX completes under the same fault."""
    params, model = weights
    got = {}
    for side in ("jax", "port"):
        if side == "jax":
            pre = jax_sched(params, pool_role="prefill")
            dec = jax_sched(params, pool_role="decode")
            router = jrouter.Router([jrouter.Replica("p", pre), jrouter.Replica("d", dec)])
            faults, rec = jfaults, jflight.recorder()
        else:
            pre, dec, router = port_pair(model)
            faults, rec = tfaults, tflight.recorder()
        n0 = rec.events_emitted
        try:
            faults.arm("migrate", times=1)
            info = {}
            got[side] = router.submit(PROMPTS[2], info=info)
            assert faults.armed() == {}, "the migrate fault never fired"
        finally:
            pre.shutdown()
            dec.shutdown()
        chain = [(e["type"], e.get("outcome")) for e in rec.snapshot() if e["seq"] >= n0
                 and e["type"] in ("migrate_begin", "reset", "resubmit", "migrate_done", "admit", "complete")]
        assert chain == [("admit", None), ("migrate_begin", None), ("reset", None), ("resubmit", "resubmitted"),
                         ("admit", None), ("complete", None)], side
        assert_no_leaks(pre, dec)
    assert got["port"] == got["jax"] == baselines["greedy"][2]


def test_a_verify_enabled_decode_engine_drafts_from_the_packet_history(weights, baselines):
    pre, dec, router = port_pair(weights[1], dec=dict(spec_paged=True, spec_paged_tokens=3))
    real_import, histories = dec.engine.import_request, []

    def record(pkt):
        row = real_import(pkt)
        histories.append((list(pkt["prompt"]), list(pkt["tokens"]), list(dec.engine.slots[row].history)))
        return row

    dec.engine.import_request = record
    try:
        got = [router.submit(p) for p in PROMPTS]
    finally:
        pre.shutdown()
        dec.shutdown()
    assert got == baselines["greedy"]
    assert [h for _, _, h in histories] == [p + t for p, t, _ in histories]
    assert dec.engine.stats.spec_verify_steps > 0  # the greedy tiny model repeats itself: drafts
    assert_no_leaks(pre, dec)


# ---------------------------------------------------------------------------
# router policy on stub replicas (no engines), JAX's Router and the port's
# ---------------------------------------------------------------------------


class _StubEngine:
    def __init__(self, role, free=4):
        self.pool_role = role
        self.B = 4
        self.kv_pool = None
        self._free = free

    def free_slots(self):
        return list(range(self._free))


class _StubScheduler:
    def __init__(self, role, free=4):
        self.engine = _StubEngine(role, free)
        self._stop = threading.Event()


class _StubBreaker:
    def __init__(self):
        self.open = False


@pytest.fixture(params=["jax", "port"])
def rt(request):
    return {"jax": JAX, "port": PORT}[request.param]


def _stub(rt, name, role="prefill", free=4, breaker=None):
    return rt.router.Replica(name, _StubScheduler(role, free), breaker=breaker)


class TestRouterPolicy:
    def test_affinity_routing_is_non_vacuous(self, rt):
        a, b = _stub(rt, "p-a"), _stub(rt, "p-b")
        router = rt.router.Router([a, b], rt.RouterConfig(load_weight=0.0))
        keys = [("doc", 7), ("doc", 8)]
        first, _, aff0 = router.select("prefill", chunk_keys=keys)
        assert aff0 == 0.0
        hits = 0
        for _ in range(6):
            r, _, aff = router.select("prefill", chunk_keys=keys)
            assert r.name == first.name
            hits += aff > 0.0
        assert hits == 6
        assert router.select("prefill", chunk_keys=[("doc", 99)])[2] == 0.0

    def test_unhealthy_replicas_take_no_traffic(self, rt):
        brk = _StubBreaker()
        sick, well = _stub(rt, "sick", breaker=brk), _stub(rt, "well")
        router = rt.router.Router([sick, well])
        brk.open = True
        for _ in range(4):
            assert router.select("prefill")[0].name == "well"
        brk.open = False
        assert sick.healthy()

    def test_all_unhealthy_raises_no_replica(self, rt):
        brk = _StubBreaker()
        brk.open = True
        router = rt.router.Router([_stub(rt, "only", breaker=brk)])
        with pytest.raises(rt.router.NoReplicaAvailable):
            router.select("prefill")

    def test_stopped_scheduler_is_unhealthy(self, rt):
        rep = _stub(rt, "r0")
        assert rep.healthy()
        rep.scheduler._stop.set()
        assert not rep.healthy()

    def test_load_prefers_the_emptier_replica(self, rt):
        full, empty = _stub(rt, "full", free=0), _stub(rt, "empty", free=4)
        router = rt.router.Router([full, empty], rt.RouterConfig(affinity_weight=0.0, load_weight=1.0))
        assert router.select("prefill")[0].name == "empty"

    def test_session_sticks_within_ttl_and_expires_after(self, rt):
        router = rt.router.Router([_stub(rt, "a"), _stub(rt, "b")], rt.RouterConfig(session_ttl_s=0.2))
        r0, _, _ = router.select("prefill", session="conv-1")
        for _ in range(4):
            assert router.select("prefill", session="conv-1")[0].name == r0.name
        name, stamp = router._sessions["conv-1"]
        router._sessions["conv-1"] = (name, stamp - 1.0)  # expired, without sleeping
        router.select("prefill", session="conv-1")
        assert router._sessions["conv-1"][1] > stamp - 1.0

    def test_hot_chunk_registry_is_bounded(self, rt):
        router = rt.router.Router([_stub(rt, "solo")], rt.RouterConfig(hot_chunks=8))
        for i in range(50):
            router.select("prefill", chunk_keys=[("doc", i)])
        assert len(router._hot["solo"]) <= 8

    def test_duplicate_names_and_no_replicas_rejected(self, rt):
        with pytest.raises(ValueError):
            rt.router.Router([_stub(rt, "x"), _stub(rt, "x")])
        with pytest.raises(ValueError):
            rt.router.Router([])

    def test_stats_snapshot_shape(self, rt):
        router = rt.router.Router([_stub(rt, "p0"), _stub(rt, "d0", role="decode")])
        router.select("prefill", chunk_keys=[("doc", 0)], session="s")
        st = router.stats()
        assert {r["name"] for r in st["replicas"]} == {"p0", "d0"}
        assert st["sessions"] == 1 and all(0.0 <= r["load"] <= 1.0 for r in st["replicas"])


def test_the_same_decisions_as_jax_over_a_sequence():
    """One sequence of selections with compositions, sessions and a sick
    replica: the port's router picks what JAX's picks, with the same scores."""
    picks = {}
    for side, rt in (("jax", JAX), ("port", PORT)):
        brk = _StubBreaker()
        reps = [_stub(rt, "a", free=1), _stub(rt, "b", free=3, breaker=brk), _stub(rt, "c", free=2),
                _stub(rt, "d", role="decode")]
        router = rt.router.Router(reps, rt.RouterConfig(affinity_weight=1.0, load_weight=0.5, hot_chunks=4))
        out = []
        for i in range(24):
            brk.open = i % 7 == 3
            keys = [("doc", (i * 3 + j) % 6) for j in range(i % 3)]
            r, score, aff = router.select("prefill" if i % 5 else "decode", keys, session=f"s{i % 4}" if i % 2 else None)
            out.append((r.name, round(score, 9), round(aff, 9)))
        picks[side] = (out, router.stats())
    assert picks["port"] == picks["jax"]


# ---------------------------------------------------------------------------
# the services with a pool role
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_a_role_service_answers_generate_as_jax(role):
    """The HTTP service builds the role's engine; a prefill-role engine hands
    every admitted request off as a packet nobody lands, so both services
    answer with the first token, and a decode-role one answers whole."""
    pair = R._make_pair("continuous", continuous={"pool_role": role})
    try:
        for side, (svc, _) in pair.items():
            assert svc.scheduler.engine.pool_role == role, side
        for q in ("alpha", "what is delta?"):
            bodies = {side: R._post(side, client, "/generate", {"prompt": q}) for side, (_, client) in pair.items()}
            assert {s: b.status_code for s, b in bodies.items()} == {"jax": 200, "port": 200}
            j, t = bodies["jax"].get_json(), bodies["port"].get_json()
            assert t["generated_text"] == j["generated_text"] and t["context"] == j["context"]
        assert_no_leaks(pair["port"][0].scheduler)
    finally:
        for svc, _ in pair.values():
            svc.shutdown()
