"""The continuous engine on a tp mesh (one process per rank, gloo on the
CPU): the head-sharded dense cache and paged arena, migration, chunk reuse,
mixed windows, the paged verify and int8 KV, against the port's tp = 1
engines and the JAX package's ``ContinuousEngine`` on its ``dp=4, tp=2``
mesh, on the same tiny fp32 weights.

One tp = 2 world is spawned for the module (``parallel.launch.spawn_world``,
with a join timeout) and runs every case; two more worlds plant a
divergence on rank 1 (a pool block; a call that raises there alone) and
must fail within their timeout; two ``server.main``
boots under the prefill-tier and decode-tier keys of
``deploy/llm/deploy.yaml`` (``tp=2``) run beside them. The test functions
assert the cases one by one. Tolerance: greedy tokens equal; KV planes
within 1e-5 relative (RMS) in fp32. The cross-rank digest
(``ContinuousEngine.check_mesh``) is taken after every window and must
agree; no pool leaks a block.

Mirrors ``tests/test_kv_pool_tp.py``, ``tests/test_continuous.py``
``TestContinuousOnMesh``, ``tests/test_router.py`` ``TestDisaggTP2``,
``tests/test_chunk_reuse.py`` ``TestChunkReuseTP2`` and
``tests/test_chunked_prefill.py`` ``TestChunkedPrefillTP``. The rank
functions import nothing of JAX: the spawned ranks import this module.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu_torch.core.config import (
    AppConfig,
    DTypePolicy,
    EngineConfig,
    LlamaConfig,
    MeshConfig,
    PrefixCacheConfig,
    SamplingConfig,
)
from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine, ContinuousScheduler
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.llama import build_llama
from rag_llm_k8s_tpu_torch.obs import metrics as obs_metrics
from rag_llm_k8s_tpu_torch.parallel.commands import MeshDivergence, serve_commands, stream_for
from rag_llm_k8s_tpu_torch.parallel.launch import spawn_world
from rag_llm_k8s_tpu_torch.parallel.sharding import shard_llama_params
from rag_llm_k8s_tpu_torch.resilience import faults
from rag_llm_k8s_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded

FP32 = DTypePolicy.fp32()
VOCAB = 128
REL = 1e-5
# 8 query heads over 4 kv heads; the EOS id is out of range, so every
# stream runs to its budget
CFG = dataclasses.replace(LlamaConfig.tiny(VOCAB), num_heads=8, num_kv_heads=4, head_dim=8, eos_token_ids=(VOCAB,))
GREEDY = SamplingConfig(do_sample=False, max_new_tokens=8)
ENG = dict(prompt_buckets=(16, 32), max_batch_size=4, max_seq_len=64, speculative="off")
PAGED = dict(ENG, kv_paged=True, kv_block_size=16)
INT8 = dict(PAGED, kv_quant="int8", kv_block_size=32, prompt_buckets=(32,))
PROMPTS = [[3, 17, 42, 7, 99], [5, 5, 8], [11] * 12, [2, 9]]
LONG = [int(x) for x in np.random.default_rng(5).integers(3, VOCAB, 30)]  # two chunks of 16
MIXED = [PROMPTS[0], LONG, PROMPTS[1]]
# one-step windows: any draft makes a verify window
VERIFY = dict(PAGED, spec_paged=True, decode_sync_steps=1)
VERIFY_PROMPTS = [PROMPTS[0], PROMPTS[2]]
# tests/test_chunk_reuse.py's chunk-reuse configuration
CHUNK_PC = dict(enabled=True, max_prefix_tokens=64, segment_buckets=(16,), suffix_buckets=(16,), hbm_budget_mb=64,
                reuse="chunk", boundary_tokens=4, chunk_hot_min=0.0)
CHUNK_EC = dict(prompt_buckets=(64, 128), max_batch_size=2, speculative="off", max_seq_len=256, kv_paged=True,
                kv_block_size=16)
JOIN_S = 420.0


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


def _cont(model, mesh=None, samp=GREEDY, **ec):
    return ContinuousEngine(CFG, model, samp, EngineConfig(**ec), FP32, "cpu", mesh=mesh)


def _corpus(seed):
    r = np.random.default_rng(seed)
    head = [1] + [int(x) for x in r.integers(3, VOCAB, 15)]
    a, b = ([int(x) for x in r.integers(3, VOCAB, 16)] for _ in range(2))
    return head, a, b, [int(x) for x in r.integers(3, VOCAB, 6)]


# ---------------------------------------------------------------------------
# the helpers: the same calls on tp = 1 and on rank 0 of the world
# ---------------------------------------------------------------------------


def _check(eng, digests):
    """The cross-rank digest after a window (a no-op tally off the mesh)."""
    digests.append(len(set(eng.check_mesh())))


def drain(eng, reqs, digests=None):
    """admit_many + step to completion -> {rid: tokens}."""
    digests = [] if digests is None else digests
    results = {}
    for (rid, _, _), res in zip(reqs, eng.admit_many([(rid, p, mn, None) for rid, p, mn in reqs])):
        if isinstance(res, BaseException):
            raise res
        if res[1] is not None:
            results[rid] = res[1]
    _check(eng, digests)
    for _ in range(300):
        for rid, toks in eng.step():
            results[rid] = toks
        _check(eng, digests)
        if not eng.has_active():
            break
    return results


def _drafter(eng, known):
    """Random weights never repeat themselves, so prompt lookup drafts
    nothing: each row drafts the plain greedy stream of its prompt
    (``known``) while it follows it. On a mesh the drafts are rank 0's and
    travel in the verify window's command."""

    def drafts():
        out = {}
        for r, sl in enumerate(eng.slots):
            if not sl.active:
                continue
            n = len(sl.tokens)
            want = known.get(tuple(sl.history[:len(sl.history) - n]), [])
            k = min(eng.spec_K, sl.remaining - 1, eng.T - 2 - sl.kv_ub)
            out[r] = list(want[n:n + k]) if k >= 1 and want[:n] == sl.tokens else []
        return out

    eng._draft_for_slots = drafts
    return eng


def _reqs(prompts=PROMPTS):
    return [(i, p, GREEDY.max_new_tokens) for i, p in enumerate(prompts)]


def _multistep(eng, digests):
    eng.admit_many([(1, PROMPTS[0], 8, None)])
    results = {rid: t for rid, t in eng.step()}
    _check(eng, digests)
    eng.admit_many([(2, PROMPTS[2], 8, None)])  # joins mid-flight
    while eng.has_active():
        results.update(eng.step())
        _check(eng, digests)
    return results


def _chunk_reuse(one, cont, digests):
    """The first chain scatters (and registers its chunks), the permuted
    chain assembles from them: re-rotation and boundary windows."""
    head, a, b, suffix = _corpus(21)
    cp = one.prefix_cache.prefix_for([("head", head), ("A", a), ("B", b)])
    out = {"first": drain_one(cont, 1, cont.admit_prefixed(1, suffix, cp, max_new=6), digests)}
    out["regs"] = sorted(cont._chunk_regs)
    cp2 = one.prefix_cache.prefix_for([("head", head), ("B", b), ("A", a)])
    out["second"] = drain_one(cont, 2, cont.admit_prefixed(2, suffix, cp2, max_new=6), digests)
    out["oneshot"] = one.generate_prefixed(suffix, cp2)
    out["counters"] = one.prefix_cache.chunk_reuse_counters()
    # tier moves decided here: every chain registration to warm, then cold
    out["warm"] = cont.retier_registrations(lambda key: "warm")
    _check(cont, digests)
    out["tiers"] = dict(cont.tier_occupancy())
    out["cold"] = cont.retier_registrations(lambda key: "cold")
    _check(cont, digests)
    out["tiers_end"] = dict(cont.tier_occupancy())
    return out


def drain_one(eng, rid, admitted, digests):
    _, fin = admitted
    outs = {}
    _check(eng, digests)
    while eng.has_active():
        outs.update(eng.step())
        _check(eng, digests)
    return fin if fin is not None else outs[rid]


def _router_streams(pre, dec, prompts=PROMPTS):
    from rag_llm_k8s_tpu_torch.server.router import Replica, Router

    router = Router([Replica("tp-p0", pre), Replica("tp-d0", dec)])
    try:
        return [router.submit(p) for p in prompts]
    finally:
        pre.shutdown()
        dec.shutdown()


def _preempt_streams(sched):
    """Four requests at once into a pool that holds two rows' growth:
    preemption resumes each stream."""
    out = [None] * len(PROMPTS)

    def run(i):
        out[i] = sched.submit(PROMPTS[i] + [4] * 10, max_new_tokens=24)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(PROMPTS))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sched.shutdown()
    return out


def _deadline_case(sched, digests):
    """One request's deadline expires mid-flight (rank 0's clock decides,
    ``ContinuousScheduler._evict_expired``); the other finishes."""
    eng = sched.engine
    clock = [0.0]
    dl = Deadline(1000.0, clock=lambda: clock[0])
    got = {}

    def run(key, **kw):
        try:
            got[key] = sched.submit(PROMPTS[0], max_new_tokens=40, **kw)
        except DeadlineExceeded as e:
            got[key] = e.stage

    threads = [threading.Thread(target=run, args=("late",), kwargs={"deadline": dl}),
               threading.Thread(target=run, args=("kept",))]
    try:
        for t in threads:
            t.start()
        t_end = time.monotonic() + 60
        while time.monotonic() < t_end and not any(len(s.tokens) >= 3 for s in eng.slots if s.active):
            time.sleep(0.002)
        clock[0] = 10.0  # expired: the next window boundary evicts it
        for t in threads:
            t.join(120)
    finally:
        sched.shutdown()
    _check(eng, digests)
    return got


# ---------------------------------------------------------------------------
# the tp = 2 world
# ---------------------------------------------------------------------------


def _sched(eng):
    return ContinuousScheduler(eng, retry_backoff_s=0.0)


def _case(ctx, build, lead, follow=None):
    """Every rank builds ``build()``; rank 0 runs ``lead(*objs)`` and stops
    the stream, the followers serve it and return ``follow(*objs)``."""
    objs = build()
    if ctx.leader:
        try:
            return lead(*objs)
        finally:
            stream_for(ctx).stop()
    serve_commands(ctx)
    return follow(*objs) if follow is not None else None


def _planes(eng):
    return [p.numpy().copy() for p in eng._cache_planes(eng.arena)]


def _tp_rank(ctx, flat):
    model = shard_llama_params(flat, ctx, CFG, FP32, "cpu")
    res, digests = {}, []

    def rank_view(eng):
        return dict(blocks=eng.kv_pool.blocks_in_use() if eng.paged else 0, digest=eng.state_digest(),
                    cache=[tuple(p.shape) for p in eng._cache_planes(eng.arena if eng.paged else None)],
                    arena_bytes=eng.arena_device_bytes)

    res["paged"] = _case(ctx, lambda: (_cont(model, ctx, **PAGED),),
                         lambda e: dict(streams=drain(e, _reqs(), digests), view=rank_view(e)),
                         lambda e: dict(view=rank_view(e)))
    # the arena after one request: each rank's heads of every block
    res["planes"] = _case(ctx, lambda: (_cont(model, ctx, **PAGED),),
                          lambda e: (drain(e, _reqs()[:1], digests), _planes(e))[1], _planes)
    res["dense"] = _case(ctx, lambda: (_cont(model, ctx, **ENG),),
                         lambda e: dict(streams=drain(e, _reqs(), digests), view=rank_view(e)),
                         lambda e: dict(view=rank_view(e)))
    res["multistep"] = _case(ctx, lambda: (_cont(model, ctx, **PAGED, decode_sync_steps=4),),
                             lambda e: _multistep(e, digests))
    res["int8"] = _case(ctx, lambda: (_cont(model, ctx, **INT8), _cont(model, ctx, **dict(ENG, kv_quant="int8",
                                                                                          prompt_buckets=(32,)))),
                        lambda p, d: dict(paged=drain(p, _reqs(), digests), dense=drain(d, _reqs(), digests),
                                          blocks=p.kv_pool.blocks_in_use()),
                        lambda p, d: dict(view=rank_view(p)))
    res["mixed"] = _case(ctx, lambda: (_cont(model, ctx, **dict(PAGED, interleave_prefill=True,
                                                                prefill_chunk_tokens=16)),),
                         lambda e: dict(streams=drain(e, _reqs(MIXED), digests),
                                        mixed=e.stats.mixed_windows, blocks=e.kv_pool.blocks_in_use()))
    # rank 0 drafts; its drafts reach the follower in the windows' commands
    known = {tuple(p): res["paged"]["streams"][i] for i, p in enumerate(PROMPTS)} if ctx.leader else {}
    res["verify"] = _case(ctx, lambda: (_cont(model, ctx, **VERIFY),),
                          lambda e: dict(streams=drain(_drafter(e, known), _reqs(VERIFY_PROMPTS), digests),
                                         verify=e.stats.spec_verify_steps, blocks=e.kv_pool.blocks_in_use()))
    # the schedulers (their dispatcher threads) run on rank 0 only
    res["preempt"] = _case(
        ctx, lambda: (_cont(model, ctx, **dict(PAGED, kv_pool_blocks=8)),),
        lambda e: dict(streams=_preempt_streams(_sched(e)), preemptions=e.stats.preemptions,
                       blocks=e.kv_pool.blocks_in_use(), digest=e.check_mesh()),
        lambda e: dict(view=rank_view(e)))
    res["disagg"] = _case(
        ctx, lambda: tuple(_cont(model, ctx, **dict(PAGED, pool_role=r)) for r in ("prefill", "decode")),
        lambda p, d: dict(streams=_router_streams(_sched(p), _sched(d)),
                          blocks=[e.kv_pool.blocks_in_use() for e in (p, d)], digests=[e.check_mesh() for e in (p, d)]),
        lambda p, d: dict(blocks=[e.kv_pool.blocks_in_use() for e in (p, d)],
                          refs=len(ctx.__dict__.get("_refs", {}))))
    res["chunk"] = _case(
        ctx, lambda: (InferenceEngine(CFG, model, GREEDY, EngineConfig(**dict(CHUNK_EC, kv_paged=False),
                                                                         prefix_cache=PrefixCacheConfig(**CHUNK_PC)),
                                      FP32, "cpu", mesh=ctx),
                      _cont(model, ctx, **dict(CHUNK_EC, prefix_cache=PrefixCacheConfig(**CHUNK_PC)))),
        lambda one, c: _chunk_reuse(one, c, digests),
        lambda one, c: dict(tiers=dict(c.tier_occupancy()), entries=one.prefix_cache.counters()["prefix_cache_entries"],
                            regs=sorted(c._chunk_regs)))

    def fault_lead(e):
        out = {"evicted": None}
        e.admit_many([(1, PROMPTS[0], 8, None), (2, PROMPTS[1], 8, None)])
        e.step()
        out["evicted"] = e.evict_requests([1])  # a deadline's eviction, decided here
        _check(e, digests)
        faults.arm("decode_step")  # armed on rank 0 only
        try:
            e.step()
        except faults.InjectedFault:
            out["fault"] = True
        e.reset()
        _check(e, digests)
        out["rest"] = drain(e, _reqs()[:2], digests)
        out["armed_after"] = faults.armed()  # charged once, on rank 0
        return out

    res["fault"] = _case(ctx, lambda: (_cont(model, ctx, **PAGED),), fault_lead, lambda e: dict(view=rank_view(e)))
    res["deadline"] = _case(ctx, lambda: (_cont(model, ctx, **PAGED),), lambda e: _deadline_case(_sched(e), digests),
                            lambda e: dict(view=rank_view(e)))

    def gauge_lead(e):
        reg = obs_metrics.MetricsRegistry()
        e.bind_metrics(reg)
        e._commands.heartbeat()
        text = reg.render_prometheus()
        return sorted(line for line in text.splitlines() if line.startswith("rag_kv_pool_device_bytes{"))

    res["gauge"] = _case(ctx, lambda: (_cont(model, ctx, **PAGED),), gauge_lead)
    res["digests"] = digests
    return res


def _diverge_rank(ctx, flat, plant):
    """A divergence planted on rank 1, which must fail the world, never hang
    it: its pool takes a block rank 0 did not (``"pool"``: the next digest
    differs), or refuses the free at a row's finish, so that call raises
    there alone (``"raise"``: the follower leaves at the next command)."""
    model = shard_llama_params(flat, ctx, CFG, FP32, "cpu")
    eng = _cont(model, ctx, **PAGED)
    if ctx.rank == 1 and plant == "pool":
        eng.kv_pool.alloc(1)
    if ctx.rank == 1 and plant == "raise":
        def refuse(ids):
            raise RuntimeError("planted: rank 1's pool refuses a free")

        eng.kv_pool.free = refuse
    if ctx.leader:
        try:
            drain(eng, _reqs()[:1], [])
        except MeshDivergence as e:
            raise RuntimeError(f"divergence detected: {e}") from e
        finally:
            stream_for(ctx).stop()
        return "not detected"
    serve_commands(ctx)
    return None


# ---------------------------------------------------------------------------
# server.main under the tier deployments' keys
# ---------------------------------------------------------------------------

TIER_KEYS = {
    # deploy/llm/deploy.yaml's llm-prefill (tp=8 -> tp=2) and llm-decode
    "prefill": {"TPU_RAG_BATCHING": "continuous", "TPU_RAG_KV_PAGED": "1", "TPU_RAG_KV_BLOCK_SIZE": "16",
                "TPU_RAG_KV_POOL_BLOCKS": "0", "TPU_RAG_POOL_ROLE": "prefill",
                "TPU_RAG_ROUTER_AFFINITY_WEIGHT": "1.0", "TPU_RAG_ROUTER_LOAD_WEIGHT": "0.5",
                "TPU_RAG_ROUTER_HOT_CHUNKS": "512", "TPU_RAG_ROUTER_SESSION_TTL_S": "600",
                "TPU_RAG_PREFIX_CACHE": "1", "TPU_RAG_PREFIX_REUSE": "chunk",
                # beside the tier's keys: the lookahead's prestage on the mesh
                "TPU_RAG_LOOKAHEAD": "1"},
    "decode": {"TPU_RAG_BATCHING": "continuous", "TPU_RAG_KV_PAGED": "1", "TPU_RAG_KV_BLOCK_SIZE": "16",
               "TPU_RAG_KV_POOL_BLOCKS": "0", "TPU_RAG_POOL_ROLE": "decode", "TPU_RAG_SPEC_PAGED": "1"},
}
QUESTION = "what do kernels tile?"
BASE_ENV = {"TPU_RAG_MAX_NEW_TOKENS": "8", "TPU_RAG_DO_SAMPLE": "0", "TPU_RAG_SHADOW": "0",
            "TPU_RAG_LOG_LEVEL": "INFO", "TPU_RAG_MAX_SEQ_LEN": "1024"}


def _boot_tier(root, tier):
    """``server.main`` under the tier's keys and ``TPU_RAG_MESH=tp=2``:
    ready, one /query, SIGTERM."""
    import test_torch_mesh as M

    from rag_llm_k8s_tpu_torch.parallel.launch import free_port

    M._staged(root)
    port = free_port()
    env = {**os.environ, **BASE_ENV, **TIER_KEYS[tier], "MODEL_PATH": root,
           "TPU_RAG_PDF_DIR": os.path.join(root, "pdfs"), "TPU_RAG_PORT": str(port), "TPU_RAG_MESH": "tp=2"}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    log_path = os.path.join(root, "main.log")
    out = {}

    def http(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())

    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", M.MAIN], env=env, cwd=repo, stdout=log,
                                stderr=subprocess.STDOUT)
    try:
        t_end = time.monotonic() + 180
        while time.monotonic() < t_end and proc.poll() is None:
            try:
                _, hz = http("/healthz")
                if hz.get("status") == "ok":
                    out["healthz"] = hz
                    break
            except OSError:
                pass
            time.sleep(0.5)
        if "healthz" in out:
            out["query"] = http("/query", {"prompt": QUESTION})
            proc.send_signal(signal.SIGTERM)
            out["rc"] = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log_path) as f:
        out["log"] = f.read()
    return out


def _meshless_answer(root, tier):
    """The same keys without a mesh, in this process (the boot's staged
    directory, ingested the same way)."""
    from rag_llm_k8s_tpu_torch.core.config import EncoderConfig, RetrievalConfig
    from rag_llm_k8s_tpu_torch.server.main import build_service

    env = {**BASE_ENV, **TIER_KEYS[tier], "MODEL_PATH": root, "TPU_RAG_PDF_DIR": os.path.join(root, "pdfs"),
           "TPU_RAG_INDEX_PATH": os.path.join(root, "meshless_index")}
    cfg = dataclasses.replace(AppConfig.from_env(env), dtypes=FP32, encoder=EncoderConfig.tiny(512),
                              retrieval=RetrievalConfig(embed_dim=32))
    svc = build_service(cfg, device="cpu")
    try:
        svc.ingest_directory()
        svc.warmup()
        return svc.answer(QUESTION)
    finally:
        svc.shutdown()


# ---------------------------------------------------------------------------
# the reference side (this process)
# ---------------------------------------------------------------------------


def _jcfg(cfg):
    from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig

    return JLlamaConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def ref():
    import jax

    from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
    from rag_llm_k8s_tpu.models.llama import init_llama_params

    params = init_llama_params(jax.random.PRNGKey(0), _jcfg(CFG), JDTypes.fp32())
    flat = convert.flatten_tree(params)
    return dict(params=params, flat=flat)


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    """The tp = 2 world, the planted divergence and the two tier boots, side
    by side; each entry ``("ok", result)`` or ``("error", exc, seconds)``."""
    from concurrent.futures import ThreadPoolExecutor

    def run(fn, join, *args):
        t = time.monotonic()
        try:
            return ("ok", spawn_world(fn, MeshConfig(tp=2), device="cpu", timeout_s=60, args=(ref["flat"], *args),
                                      join_timeout_s=join))
        except Exception as e:  # noqa: BLE001 — the divergence case returns its failure
            return ("error", e, time.monotonic() - t)

    # made here, not in the pool's threads: the factory's first directory
    # is not made thread-safely
    roots = {tier: str(tmp_path_factory.mktemp(f"tier_{tier}")) for tier in TIER_KEYS}

    def boot(tier):
        root = roots[tier]
        try:
            return ("ok", _boot_tier(root, tier), root)
        except Exception as e:  # noqa: BLE001 — asserted by the test
            return ("error", e, root)

    with ThreadPoolExecutor(max_workers=5) as pool:
        futs = {"tp2": pool.submit(run, _tp_rank, JOIN_S), "diverge": pool.submit(run, _diverge_rank, 120.0, "pool"),
                "raise": pool.submit(run, _diverge_rank, 120.0, "raise"),
                "prefill": pool.submit(boot, "prefill"), "decode": pool.submit(boot, "decode")}
        return {k: f.result() for k, f in futs.items()}


def _tp2(world, rank=0):
    """Rank ``rank``'s results of the tp = 2 world."""
    kind, res = world["tp2"][:2]
    assert kind == "ok", res
    return res[rank]


@pytest.fixture(scope="module")
def tp1(ref):
    """The port's meshless engines on the same weights, through the same
    helpers."""
    model = convert.load_llama(build_llama(CFG, FP32, torch.device("cpu")), ref["flat"])
    out = {}
    e = _cont(model, **PAGED)
    out["paged"] = drain(e, _reqs())
    e = _cont(model, **PAGED)
    drain(e, _reqs()[:1])
    out["planes"] = _planes(e)
    out["arena_bytes"] = e.arena_device_bytes
    out["multistep"] = _multistep(_cont(model, **PAGED, decode_sync_steps=4), [])
    out["int8"] = drain(_cont(model, **INT8), _reqs())
    out["mixed"] = drain(_cont(model, **dict(PAGED, interleave_prefill=True, prefill_chunk_tokens=16)),
                         _reqs(MIXED))
    out["phased_long"] = drain(_cont(model, **PAGED), _reqs(MIXED))
    known = {tuple(p): out["paged"][i] for i, p in enumerate(PROMPTS)}
    out["verify"] = drain(_drafter(_cont(model, **VERIFY), known), _reqs(VERIFY_PROMPTS))
    out["preempt"] = _preempt_streams(_sched(_cont(model, **dict(PAGED, kv_pool_blocks=8))))
    sched = _sched(_cont(model, **PAGED))
    try:
        out["unified"] = [sched.submit(p) for p in PROMPTS]
    finally:
        sched.shutdown()
    one = InferenceEngine(CFG, model, GREEDY, EngineConfig(**dict(CHUNK_EC, kv_paged=False),
                                                           prefix_cache=PrefixCacheConfig(**CHUNK_PC)), FP32, "cpu")
    out["chunk"] = _chunk_reuse(one, _cont(model, **dict(CHUNK_EC, prefix_cache=PrefixCacheConfig(**CHUNK_PC))), [])
    e = _cont(model, **PAGED)
    e.admit_many([(1, PROMPTS[0], 8, None), (2, PROMPTS[1], 8, None)])
    e.step()
    e.evict_requests([1])
    e.reset()
    out["fault_rest"] = drain(e, _reqs()[:2])
    return out


@pytest.fixture(scope="module")
def jax_paged(ref, devices8):
    """The JAX ContinuousEngine's paged greedy streams on its dp=4 x tp=2
    mesh (tests/test_kv_pool_tp.py's setup)."""
    from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
    from rag_llm_k8s_tpu.core.config import EngineConfig as JEngineConfig
    from rag_llm_k8s_tpu.core.config import MeshConfig as JMeshConfig
    from rag_llm_k8s_tpu.core.config import SamplingConfig as JSampling
    from rag_llm_k8s_tpu.core.mesh import make_mesh
    from rag_llm_k8s_tpu.engine.continuous import ContinuousEngine as JContinuousEngine
    from rag_llm_k8s_tpu.parallel.sharding import shard_llama_params as jshard

    ctx = make_mesh(JMeshConfig(dp=4, sp=1, tp=2), devices=devices8)
    eng = JContinuousEngine(_jcfg(CFG), jshard(ref["params"], ctx), sampling=JSampling(do_sample=False,
                                                                                      max_new_tokens=8),
                            engine_config=JEngineConfig(**PAGED, attn_impl="xla"), dtypes=JDTypes.fp32(), mesh=ctx)
    results = {}
    for (rid, _, _), res in zip(_reqs(), eng.admit_many([(rid, p, mn, None) for rid, p, mn in _reqs()])):
        if res[1] is not None:
            results[rid] = res[1]
    while eng.has_active():
        results.update(eng.step())
    assert eng.kv_pool.blocks_in_use() == 0
    return results


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def test_paged_tp2_streams_match_paged_tp1_dense_tp2_and_jax_tp2(world, tp1, jax_paged):
    res = _tp2(world)
    paged, dense = res["paged"], res["dense"]
    assert paged["streams"] == tp1["paged"] == jax_paged
    assert dense["streams"] == tp1["paged"]
    for r in (paged, dense):
        assert r["view"]["blocks"] == 0
    # each rank holds K/tp = 2 kv heads of every block and of every row
    assert paged["view"]["cache"][0] == (CFG.num_layers, 4 * 8 + 1, 2, 16, CFG.head_dim)
    assert dense["view"]["cache"][0] == (CFG.num_layers, 4, 2, 128, CFG.head_dim)


def test_each_rank_holds_its_heads_of_the_tp1_arena(world, tp1):
    rank0, rank1 = _tp2(world)["planes"], _tp2(world, 1)["planes"]
    for got0, got1, want in zip(rank0, rank1, tp1["planes"]):
        assert _rel(np.concatenate([got0, got1], axis=2), want) < REL


def test_the_followers_end_in_rank0s_state(world):
    lead, follow = _tp2(world), _tp2(world, 1)
    for case in ("paged", "dense"):
        assert follow[case]["view"]["digest"] == lead[case]["view"]["digest"]
        assert follow[case]["view"]["cache"] == lead[case]["view"]["cache"]
    for case in ("preempt", "fault", "deadline"):
        assert follow[case]["view"]["blocks"] == 0


def test_multi_step_sync_with_admission_mid_flight(world, tp1):
    assert _tp2(world)["multistep"] == tp1["multistep"] == {1: tp1["paged"][0], 2: tp1["paged"][2]}


def test_int8_arena_matches_int8_dense_and_tp1(world, tp1):
    r = _tp2(world)["int8"]
    assert r["paged"] == r["dense"] == tp1["int8"]
    assert r["blocks"] == 0


def test_mixed_windows_match_tp1_and_phase_separated_tp2(world, tp1):
    r = _tp2(world)["mixed"]
    assert r["mixed"] > 0 and r["blocks"] == 0
    assert r["streams"] == tp1["mixed"] == tp1["phased_long"]
    assert r["streams"][0] == _tp2(world)["paged"]["streams"][0]


def test_paged_verify_matches_tp1(world, tp1):
    r = _tp2(world)["verify"]
    assert r["verify"] > 0 and r["blocks"] == 0
    assert r["streams"] == tp1["verify"]


def test_preemption_resumes_with_no_block_leaked(world, tp1):
    r = _tp2(world)["preempt"]
    assert r["preemptions"] > 0 and r["blocks"] == 0
    assert r["streams"] == tp1["preempt"]
    assert len(set(r["digest"])) == 1


def test_disagg_through_the_router_matches_unified_tp1(world, tp1):
    r = _tp2(world)["disagg"]
    assert r["streams"] == tp1["unified"]
    assert r["blocks"] == [0, 0] and _tp2(world, 1)["disagg"]["blocks"] == [0, 0]
    assert all(len(set(d)) == 1 for d in r["digests"])
    # the packets' head slices go on the follower once rank 0's packets do
    # (the last one's free rides a command that never came)
    assert _tp2(world, 1)["disagg"]["refs"] < len(PROMPTS)


def test_chunk_reuse_assembly_matches_tp1(world, tp1):
    r, want = _tp2(world)["chunk"], tp1["chunk"]
    for k in ("first", "second", "oneshot", "regs", "counters", "warm", "tiers", "cold", "tiers_end"):
        assert r[k] == want[k], k
    assert r["second"] == r["oneshot"][:6] and r["counters"]["rerotated"] > 0 and r["warm"] > 0
    # the tier moves rank 0 decided reached the follower, and its cache and
    # chunk registrations are rank 0's
    follow = _tp2(world, 1)["chunk"]
    assert follow["tiers"] == r["tiers_end"] and follow["regs"] == r["regs"] and follow["entries"] > 0


def test_a_fault_and_an_eviction_decided_on_rank0_reach_every_rank(world, tp1):
    r = _tp2(world)["fault"]
    assert r["evicted"] and r["fault"]
    assert r["rest"] == tp1["fault_rest"]
    assert r["armed_after"] == {}


def test_a_deadline_rank0_decides_mid_window_evicts_on_every_rank(world, tp1):
    r = _tp2(world)["deadline"]
    assert r["late"] == "decode"
    assert len(r["kept"]) == 40


def test_the_digest_agreed_after_every_window(world):
    digests = _tp2(world)["digests"]
    assert len(digests) > 50 and set(digests) == {1}


def test_kv_pool_device_bytes_has_a_child_per_rank_of_arena_total_over_tp(world, tp1):
    lines = _tp2(world)["gauge"]
    want = tp1["arena_bytes"] / 2
    assert [line.split("{")[1].split("}")[0] for line in lines] == ['device="0"', 'device="1"']
    assert [float(line.rsplit(" ", 1)[1]) for line in lines] == [want, want]


def test_a_planted_divergence_fails_the_world_instead_of_hanging(world):
    kind, err, seconds = world["diverge"]
    assert kind == "error" and "divergence detected" in str(err) and "state digests differ" in str(err)
    assert seconds < 120


def test_a_call_that_raises_on_one_follower_alone_fails_the_world(world):
    kind, err, seconds = world["raise"]
    assert kind == "error" and "rank 1 failed" in str(err) and "MeshDivergence" in str(err)
    assert "raised RuntimeError here and not on rank 0" in str(err)
    assert seconds < 120


def test_paged_partition_specs_are_jax_specs():
    from rag_llm_k8s_tpu.ops.attention import paged_partition_specs as jspecs

    from rag_llm_k8s_tpu_torch.ops.attention import kv_heads_per_rank, paged_partition_specs

    for mode in ("decode", "chunk"):
        for q8 in (False, True):
            jin, jout = jspecs(mode, q8)
            tin, tout = paged_partition_specs(mode, q8)
            assert [tuple(s) for s in jin] == list(tin) and tuple(jout) == tout
    with pytest.raises(ValueError):
        paged_partition_specs("prefill")
    assert kv_heads_per_rank(8, 8) == 1 and kv_heads_per_rank(8, 2) == 4 and kv_heads_per_rank(3, 1) == 3


@pytest.mark.parametrize("tier", ["prefill", "decode"])
def test_server_main_boots_each_tier_on_tp2_and_answers_as_meshless(world, tier):
    kind, out, root = world[tier]
    assert kind == "ok", out
    log = out["log"]
    assert out.get("healthz", {}).get("followers_ready") is True, log
    assert out["healthz"]["mesh"] == {"dp": 1, "sp": 1, "tp": 2}
    code, body = out["query"]
    assert code == 200, log
    want = _meshless_answer(root, tier)
    assert body["generated_text"] == want["generated_text"] and body["context"] == want["context"]
    assert out["rc"] == 0, log
    assert "rank 1: stopped after" in log and "drained: exiting" in log, log
