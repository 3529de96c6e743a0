"""The port's KV prefix cache against the JAX package's, on the CPU.

- **the cache alone**: one script of resolves, memo hits, tier sweeps,
  forced demotions, swap-ins and planted faults, driven through the JAX
  ``PrefixCache`` and the port's, each over a stub engine of its own kind
  (blocks made from the ids with numpy, wide enough that the 1 MiB budget
  evicts), under ``reuse="exact"``, ``"slot"`` and ``"chunk"``, tiering on
  and off, with the hotness clocks pinned: equal ``counters()``,
  ``chunk_reuse_counters()``, ``tier_stats()``, ``warmth_manifest()``,
  eviction order and resolved planes;
- **the engine** on shared tiny fp32 weights (``models/convert.py``):
  ``build_segment_kv`` within 1e-5 of JAX, ``generate_prefixed`` greedy
  tokens equal to JAX's and to the port's own cold ``generate`` (bf16 and
  int8 KV), chunk reuse's shuffled composition within
  ``tests/test_chunk_reuse.py``'s tolerance and a canonical re-hit bit for
  bit, ``splice_prefix`` writing where JAX's ``dynamic_update_slice``
  writes;
- **the service pair** (``tests/test_torch_resilience.py``'s, with the
  cache on) under ``exact`` and ``chunk`` reuse with tiering: the same
  status codes, texts, timings keys and ``/metrics`` counts, and the same
  fallback after a planted ``kv_swap_in`` or ``chunk_splice`` fault.
"""

import dataclasses
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_resilience as R  # the JAX/port service pair's pieces
import torch

from rag_llm_k8s_tpu.core.config import KVTieringConfig as JKVTiering
from rag_llm_k8s_tpu.core.config import PrefixCacheConfig as JPrefixCacheConfig
from rag_llm_k8s_tpu.engine.engine import InferenceEngine as JEngine
from rag_llm_k8s_tpu.engine.engine import _splice_prefix_planes
from rag_llm_k8s_tpu.engine.prefix_cache import PrefixCache as JPrefixCache
from rag_llm_k8s_tpu.models.llama import rerotate_prefix_planes as jrerotate_planes
from rag_llm_k8s_tpu.resilience import faults as jfaults
from rag_llm_k8s_tpu_torch.core.config import KVTieringConfig, PrefixCacheConfig
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.engine.prefix_cache import PrefixCache
from rag_llm_k8s_tpu_torch.models.llama import rerotate_prefix_planes
from rag_llm_k8s_tpu_torch.resilience import faults as tfaults
from test_torch_obs import _exposition, _family_of, UNEQUAL_BY_DESIGN

CPU = torch.device("cpu")
# tests/test_chunk_reuse.py's pinned tolerance for shifted splices on a
# random-init tiny model
LOGIT_TOL = 0.35


@pytest.fixture(autouse=True)
def _clean():
    for f in (jfaults, tfaults):
        f.clear()
    yield
    for f in (jfaults, tfaults):
        f.clear()


# ---------------------------------------------------------------------------
# the cache alone, over stub engines
# ---------------------------------------------------------------------------

KV_HEADS, HD = 8, 128  # Llama-3.1-8B's heads: 8 KiB of K and V a token (fp32, one layer)
STUB_P = 64
STUB_BUCKETS = (16, 32)
J_ROPE = R.JLlamaConfig()
T_ROPE = R.LlamaConfig()


def _stub_block(ids, off):
    """A segment block that depends on its ids and slot (the stub's
    'prefill'), padded to its bucket."""
    Sb = next(b for b in STUB_BUCKETS if b >= len(ids))
    seed = hash((tuple(int(i) for i in ids), int(off))) & 0xFFFFFFFF
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((1, 1, KV_HEADS, Sb, HD)).astype(np.float32)
    v = rng.standard_normal((1, 1, KV_HEADS, Sb, HD)).astype(np.float32)
    return k, v


class JStub:
    mesh = None

    def __init__(self, tiering):
        self.engine_config = types.SimpleNamespace(kv_tiering=tiering)
        self.built = []

    def prefix_buffer_zero(self):
        z = jnp.zeros((1, 1, KV_HEADS, STUB_P, HD), jnp.float32)
        return (z, z)

    def build_segment_kv(self, ids, buf, off):
        self.built.append((tuple(ids), off))
        return tuple(jnp.asarray(p) for p in _stub_block(ids, off))

    def splice_prefix(self, buf, block, off):
        return _splice_prefix_planes(buf, block, jnp.int32(off))

    def rerotate_segment_kv(self, planes, delta):
        return jrerotate_planes(J_ROPE, planes, delta)

    slice_prefix_block = staticmethod(JEngine.slice_prefix_block)


class TStub:
    device = CPU

    def __init__(self, tiering):
        self.engine_config = types.SimpleNamespace(kv_tiering=tiering)
        self.built = []

    def prefix_buffer_zero(self):
        z = torch.zeros((1, 1, KV_HEADS, STUB_P, HD))
        return (z, z)

    def build_segment_kv(self, ids, buf, off):
        self.built.append((tuple(ids), off))
        return tuple(torch.from_numpy(p) for p in _stub_block(ids, off))

    splice_prefix = staticmethod(InferenceEngine.splice_prefix)

    def rerotate_segment_kv(self, planes, delta):
        return rerotate_prefix_planes(T_ROPE, planes, delta)

    slice_prefix_block = staticmethod(InferenceEngine.slice_prefix_block)


class Clock:
    def __init__(self):
        self.t = 500.0

    def __call__(self):
        return self.t


def _segs(*names):
    rng = np.random.default_rng(42)
    lengths = {"H": 12, "A": 16, "B": 23, "C": 9, "D": 30}
    ids = {n: [int(x) for x in rng.integers(3, 250, n_)] for n, n_ in lengths.items()}
    return [(n, ids[n]) for n in names]


def _view(cache, cp):
    out = {
        "counters": cache.counters(), "chunks": cache.chunk_reuse_counters(), "tiers": cache.tier_stats(),
        "entries": [(k, e.tier, e.nbytes, e.pinned, e.uses, e.quantized) for k, e in cache._entries.items()],
        "assembled": list(cache._assembled), "manifest": cache.warmth_manifest(top_n=16),
        "spill": None if cache.spill is None else [(m["key"], m["nbytes"]) for m in cache.spill.manifest()],
    }
    if cp is not None:
        chunks = None if cp.chunks is None else [dataclasses.astuple(c) for c in cp.chunks]
        out["cp"] = (cp.length, cp.capacity, cp.reused_tokens, cp.computed_tokens, cp.chain_key, chunks, cp.approx)
    return out


def _planes_np(planes):
    return [p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p) for p in planes]


def _run_script(policy, tiered):
    """The same steps through both caches; ``[(step, jax view, port view,
    jax planes, port planes)]``."""
    kw = dict(enabled=True, hbm_budget_mb=1, max_prefix_tokens=STUB_P, segment_buckets=STUB_BUCKETS,
              suffix_buckets=(16,), reuse=policy, boundary_tokens=4, chunk_hot_min=1.5, assembled_cache_entries=2)
    tkw = dict(enabled=tiered, warm_below=1.5, cold_below=0.6, half_life_s=10.0, host_spill_mb=1,
               retier_interval_s=1e9)
    sides = {}
    for side, (pc_cls, tier_cls, stub_cls, cache_cls) in {
        "jax": (JPrefixCacheConfig, JKVTiering, JStub, JPrefixCache),
        "port": (PrefixCacheConfig, KVTieringConfig, TStub, PrefixCache),
    }.items():
        stub = stub_cls(tier_cls(**tkw))
        cache = cache_cls(pc_cls(**kw), stub)
        clock = Clock()
        for tr in {id(t): t for t in (cache.hotness, cache._chunk_hotness) if t is not None}.values():
            tr._clock = clock
        sides[side] = (cache, clock, stub)
    steps = [
        ("pin", "H"), ("resolve", "HAB"), ("resolve", "HAB"), ("resolve", "HBA"), ("tick", 3.0),
        ("resolve", "HAC"), ("resolve", "HCA"), ("tick", 12.0), ("retier", None), ("resolve", "HBD"),
        ("tick", 30.0), ("retier", None), ("resolve", "HCD"), ("fault", "kv_swap_in"), ("resolve", "HAB"),
        ("demote", "warm"), ("resolve", "HDA"), ("fault", "chunk_splice"), ("resolve", "HAD"),
        ("demote", "cold"), ("resolve", "HBC"), ("stage", "HCB"), ("release", None), ("resolve", "HD"),
    ]
    out = []
    staged = {}
    for step in steps:
        views = {}
        planes = {}
        for side, (cache, clock, stub) in sides.items():
            faults_mod = jfaults if side == "jax" else tfaults
            op, arg = step
            cp = None
            if op == "pin":
                cache.pin(arg)
            elif op == "resolve":
                cp = cache.prefix_for(_segs(*arg))
            elif op == "tick":
                clock.t += arg
            elif op == "retier":
                views["moved_" + side] = cache.retier(force=True)
            elif op == "fault":
                faults_mod.arm(arg)
            elif op == "demote":
                views["moved_" + side] = cache.force_demote(arg)
            elif op == "stage":
                cp, staged[side] = cache.stage(_segs(*arg))
            elif op == "release":
                views["released_" + side] = cache.release_staged(staged[side])
            views[side] = _view(cache, cp)
            views[side]["built"] = list(stub.built)
            planes[side] = _planes_np(cp.planes) if cp is not None else None
            if op != "fault":
                faults_mod.clear()  # an armed site fires in the next step or never
        out.append((step, views, planes))
    return out


@pytest.mark.parametrize("tiered", [False, True], ids=["untiered", "tiered"])
@pytest.mark.parametrize("policy", ["exact", "slot", "chunk"])
def test_one_script_of_resolves_gives_the_jax_cache_state(policy, tiered):
    for step, views, planes in _run_script(policy, tiered):
        for key in [k for k in views if k.startswith(("moved_", "released_"))]:
            side = key.split("_", 1)[1]
            assert views[key] == views[key.replace(side, "jax" if side == "port" else "port")], (step, key)
        assert views["port"] == views["jax"], step
        if planes["jax"] is not None:
            assert len(planes["port"]) == len(planes["jax"])
            for g, w in zip(planes["port"], planes["jax"]):
                np.testing.assert_array_equal(g, w, err_msg=str(step))


def test_the_script_exercises_what_it_claims():
    """The tiered chunk script evicts, demotes, spills, swaps in, falls back
    on both planted faults and re-rotates (so equality above is not
    vacuous)."""
    last = _run_script("chunk", True)[-1][1]["port"]
    tiers, chunks = last["tiers"], last["chunks"]
    assert tiers["demotes_warm"] > 0 and tiers["demotes_cold"] > 0 and tiers["swap_ins_demand"] > 0
    assert tiers["swap_in_fallbacks"] == 1 and chunks["splice_faults"] == 1
    assert chunks["rerotated"] > 0 and chunks["recompute"] > 0 and chunks["chain_exact"] > 0
    built = last["built"]
    assert len(built) > len(set(built))  # something was evicted and rebuilt


# ---------------------------------------------------------------------------
# the engine on shared tiny weights
# ---------------------------------------------------------------------------

NO_EOS = dict(eos_token_ids=(R.VOCAB,))
ENGINE_KW = dict(prompt_buckets=(64, 128), max_batch_size=2, speculative="off", max_seq_len=256)
PC_KW = dict(enabled=True, max_prefix_tokens=64, segment_buckets=(16, 32), suffix_buckets=(16,),
             boundary_tokens=4, chunk_hot_min=0.0)


@pytest.fixture(scope="module")
def params():
    cfg = dataclasses.replace(R.JLlamaConfig.tiny(R.VOCAB), **NO_EOS)
    return R.init_llama_params(jax.random.PRNGKey(0), cfg, R.JFP32)


def _engines(params, reuse="exact", kv_quant="bf16", max_new=8):
    jcfg = dataclasses.replace(R.JLlamaConfig.tiny(R.VOCAB), **NO_EOS)
    tcfg = dataclasses.replace(R.LlamaConfig.tiny(R.VOCAB), **NO_EOS)
    greedy = dict(do_sample=False, max_new_tokens=max_new)
    jeng = R.JEngine(jcfg, params, sampling=R.JSampling(**greedy), dtypes=R.JFP32,
                     engine_config=R.JEngineConfig(prefix_cache=JPrefixCacheConfig(reuse=reuse, **PC_KW),
                                                   kv_quant=kv_quant, **ENGINE_KW))
    model = R.convert.load_llama(R.build_llama(tcfg, R.FP32, CPU), R.convert.flatten_tree(params))
    teng = InferenceEngine(tcfg, model, R.SamplingConfig(**greedy),
                           R.EngineConfig(prefix_cache=PrefixCacheConfig(reuse=reuse, **PC_KW), kv_quant=kv_quant,
                                          **ENGINE_KW), R.FP32, "cpu")
    return jeng, teng


def _corpus(seed=3):
    r = np.random.default_rng(seed)
    head = [1] + [int(x) for x in r.integers(3, 250, 12)]
    a = [int(x) for x in r.integers(3, 250, 16)]
    b = [int(x) for x in r.integers(3, 250, 21)]
    suffix = [int(x) for x in r.integers(3, 250, 7)]
    return head, a, b, suffix


def _dense(planes):
    """fp32 values of a plane tuple (an int8 one dequantized)."""
    ps = _planes_np(planes)
    if len(ps) == 4:
        return [ps[0].astype(np.float32) * ps[2][..., None], ps[1].astype(np.float32) * ps[3][..., None]]
    return [p.astype(np.float32) for p in ps]


@pytest.mark.parametrize("kv_quant", ["bf16", "int8"])
@pytest.mark.parametrize("ctx", [0, 13])
def test_build_segment_kv_matches_jax(params, ctx, kv_quant):
    jeng, teng = _engines(params, kv_quant=kv_quant)
    head, a, _, _ = _corpus()
    jbuf, tbuf = jeng.prefix_buffer_zero(), teng.prefix_buffer_zero()
    if ctx:
        jbuf = jeng.splice_prefix(jbuf, jeng.build_segment_kv(head, jbuf, 0), 0)
        tbuf = teng.splice_prefix(tbuf, teng.build_segment_kv(head, tbuf, 0), 0)
    want = jeng.build_segment_kv(a, jbuf, ctx)
    got = teng.build_segment_kv(a, tbuf, ctx)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert [str(g.dtype).split(".")[-1] for g in got] == [str(w.dtype) for w in want]
    for g, w in zip(_dense(got), _dense(want)):
        # the real slots; the padding slots hold the pad token's K/V on both
        np.testing.assert_allclose(g, w, atol=1e-5 if kv_quant == "bf16" else 2e-2)
    assert teng.stats.prefill_tokens == jeng.stats.prefill_tokens


@pytest.mark.parametrize("kv_quant", ["bf16", "int8"])
def test_generate_prefixed_gives_the_jax_tokens_and_the_cold_paths(params, kv_quant):
    jeng, teng = _engines(params, kv_quant=kv_quant)
    head, a, b, suffix = _corpus()
    segs = [("head", head), ("A", a), ("B", b)]
    jcp, tcp = jeng.prefix_cache.prefix_for(segs), teng.prefix_cache.prefix_for(segs)
    for got, want in zip(_dense(tcp.planes), _dense(jcp.planes)):
        np.testing.assert_allclose(got[:, :, :, : tcp.length], want[:, :, :, : jcp.length],
                                   atol=1e-5 if kv_quant == "bf16" else 2e-2)
    want = jeng.generate_prefixed(suffix, jcp)
    got = teng.generate_prefixed(suffix, tcp)
    cold = teng.generate([head + a + b + suffix])[0]
    assert got == want == cold and len(got) == 8
    # a hit (the memo) serves the same stream and skips the whole prefix
    tcp2 = teng.prefix_cache.prefix_for(segs)
    assert tcp2.planes is tcp.planes and tcp2.reused_tokens == len(head + a + b)
    assert teng.generate_prefixed(suffix, tcp2) == got
    jeng.generate_prefixed(suffix, jeng.prefix_cache.prefix_for(segs))
    for name in ("prefill_tokens_skipped", "decode_tokens"):
        assert getattr(teng.stats, name) - (len(cold) if name == "decode_tokens" else 0) == getattr(jeng.stats, name)


@pytest.mark.parametrize("suffix,message", [([], "non-empty suffix"), (list(range(3, 20)), "exceeds the largest")])
def test_generate_prefixed_refuses_what_jax_refuses(params, suffix, message):
    jeng, teng = _engines(params)
    head, *_ = _corpus()
    cps = (jeng.prefix_cache.prefix_for([("head", head)]), teng.prefix_cache.prefix_for([("head", head)]))
    errs = []
    for eng, cp in zip((jeng, teng), cps):
        with pytest.raises(ValueError, match=message) as e:
            eng.generate_prefixed(suffix, cp)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def _last_logits_spliced(teng, cp, suffix):
    """Last-token logits of the suffix prefilled over the spliced prefix, as
    ``generate_prefixed`` does it."""
    cache = teng._new_cache(128)
    for c, b in zip(teng._prefix_planes(cache), cp.planes):
        c[:, :, :, : b.shape[3]] = b
    n = len(suffix)
    toks = torch.tensor([suffix + [0] * (16 - n)])
    with torch.inference_mode():
        return teng.model(toks, cp.length + torch.arange(16)[None], cache, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([cp.length + n]), cp.length, chunked=True,
                          logit_index=torch.tensor([n - 1]))[0, -1].numpy()


def _last_logits_cold(teng, full):
    cache = teng._new_cache(128)
    n = len(full)
    with torch.inference_mode():
        return teng.model(torch.tensor([full]), torch.arange(n)[None], cache, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([n]), 0, last_logit_only=True)[0, -1].numpy()


def test_chunk_reuse_shuffled_composition_meets_the_jax_tolerance(params):
    jeng, teng = _engines(params, reuse="chunk")
    head, a, b, suffix = _corpus()
    for eng in (jeng, teng):
        eng.prefix_cache.prefix_for([("head", head), ("A", a), ("B", b)])
    jcp = jeng.prefix_cache.prefix_for([("head", head), ("B", b), ("A", a)])
    tcp = teng.prefix_cache.prefix_for([("head", head), ("B", b), ("A", a)])
    counts = teng.prefix_cache.chunk_reuse_counters()
    assert counts == jeng.prefix_cache.chunk_reuse_counters()
    assert counts["rerotated"] == 2 and counts["chain_exact"] == 1
    assert (tcp.reused_tokens, tcp.computed_tokens, tcp.approx) == (jcp.reused_tokens, jcp.computed_tokens, jcp.approx)
    assert tcp.reused_tokens / (tcp.reused_tokens + tcp.computed_tokens) > 0.5
    ls = _last_logits_spliced(teng, tcp, suffix)
    lc = _last_logits_cold(teng, head + b + a + suffix)
    assert np.max(np.abs(ls - lc)) <= LOGIT_TOL
    for got, want in zip(_dense(tcp.planes), _dense(jcp.planes)):
        np.testing.assert_allclose(got[:, :, :, : tcp.length], want[:, :, :, : jcp.length], atol=1e-5)
    assert teng.generate_prefixed(suffix, tcp) == jeng.generate_prefixed(suffix, jcp)


def test_a_canonical_rehit_is_bit_identical(params):
    _, teng = _engines(params, reuse="chunk")
    cache = teng.prefix_cache
    head, a, b, _ = _corpus(seed=12)
    segs = [("head", head), ("A", a), ("B", b)]
    cp1 = cache.prefix_for(segs)
    with cache._lock:
        for k in list(cache._assembled):
            cache._pop_assembled(k)
    before = cache.chunk_reuse_counters()
    cp2 = cache.prefix_for(segs)
    after = cache.chunk_reuse_counters()
    assert after["chain_exact"] - before["chain_exact"] == 3 and after["rerotated"] == before["rerotated"]
    assert cp2.computed_tokens == 0 and cp2.planes is not cp1.planes
    for x, y in zip(cp1.planes, cp2.planes):
        assert torch.equal(x, y)
    # chunk mode builds a first-seen chain exactly as the exact policy does
    _, teng_x = _engines(params, reuse="exact")
    for x, y in zip(teng_x.prefix_cache.prefix_for(segs).planes, cp1.planes):
        assert torch.equal(x, y)


@pytest.mark.parametrize("offset", [0, 20, 40, 60])
def test_splice_writes_where_dynamic_update_slice_writes(offset):
    """A block that would run past the buffer lands ending at its end."""
    rng = np.random.default_rng(offset)
    buf = rng.standard_normal((2, 1, 2, 64, 4)).astype(np.float32)
    scale = rng.standard_normal((2, 1, 2, 64)).astype(np.float32)
    blk = rng.standard_normal((2, 1, 2, 16, 4)).astype(np.float32)
    bsc = rng.standard_normal((2, 1, 2, 16)).astype(np.float32)
    want = _splice_prefix_planes((jnp.asarray(buf), jnp.asarray(scale)), (jnp.asarray(blk), jnp.asarray(bsc)),
                                 jnp.int32(offset))
    src = (torch.from_numpy(buf), torch.from_numpy(scale))
    got = InferenceEngine.splice_prefix(src, (torch.from_numpy(blk), torch.from_numpy(bsc)), offset)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(src[0].numpy(), buf)  # the source buffer is left as it was


def test_the_zero_buffer_is_shared_and_sized_as_jax_sizes_it(params):
    for kv_quant in ("bf16", "int8"):
        jeng, teng = _engines(params, kv_quant=kv_quant)
        z = teng.prefix_buffer_zero()
        assert z is teng.prefix_buffer_zero()
        jz = jeng.prefix_buffer_zero()
        assert [tuple(p.shape) for p in z] == [tuple(p.shape) for p in jz]
        assert sum(p.nbytes for p in z) == sum(int(p.nbytes) for p in jz)
        assert all(not p.any() for p in z)


# ---------------------------------------------------------------------------
# the service pair with the cache on
# ---------------------------------------------------------------------------

SERVICE_PC = dict(enabled=True, max_prefix_tokens=192, segment_buckets=(16, 32, 64), suffix_buckets=(32, 64, 128),
                  hbm_budget_mb=64, boundary_tokens=4, chunk_hot_min=0.0)
SERVICE_TIERING = dict(enabled=True, retier_interval_s=1e9)
MODES = {"exact": (dict(reuse="exact"), None), "chunk_tiered": (dict(reuse="chunk"), SERVICE_TIERING)}


def _make_prefix_pair(mode, batching="coalesce"):
    """The JAX service and the port's on the same weights with the prefix
    cache on (``MODES[mode]``), warmed (the head pinned and resolved)."""
    pc, tier = MODES[mode]
    jl, je = R.JLlamaConfig.tiny(R.VOCAB), R.JEncoderConfig.tiny(R.VOCAB)
    lc, ec = R.LlamaConfig.tiny(R.VOCAB), R.EncoderConfig.tiny(R.VOCAB)
    lparams = R.init_llama_params(jax.random.PRNGKey(0), jl, R.JFP32)
    eparams = R.init_encoder_params(jax.random.PRNGKey(1), je, R.JFP32)
    greedy = dict(do_sample=False, max_new_tokens=8)
    jec = R.JEngineConfig(**R.HTTP_ENGINE, prefix_cache=JPrefixCacheConfig(**SERVICE_PC, **pc),
                          kv_tiering=JKVTiering(**(tier or {})))
    tec = R.EngineConfig(**R.HTTP_ENGINE, prefix_cache=PrefixCacheConfig(**SERVICE_PC, **pc),
                         kv_tiering=KVTieringConfig(**(tier or {})))
    jcfg = R.JAppConfig(model=jl, encoder=je, system_message=R.SYSTEM,
                        resilience=R.JResilienceConfig(retry_backoff_ms=0.0),
                        flight=R.JFlightConfig(spool_dir=tempfile.mkdtemp(prefix="jax_incidents_")))
    jeng = R.JEngine(jl, lparams, sampling=R.JSampling(**greedy), engine_config=jec, dtypes=R.JFP32)
    model = R.convert.load_llama(R.build_llama(lc, R.FP32, CPU), R.convert.flatten_tree(lparams))
    enc = R.convert.load_encoder(R.build_encoder(ec, R.FP32, CPU), R.convert.flatten_tree(eparams))
    teng = InferenceEngine(lc, model, R.SamplingConfig(**greedy), tec, R.FP32, "cpu")
    tcfg = R.AppConfig(model=lc, encoder=ec, engine=tec, system_message=R.SYSTEM,
                       resilience=R.ResilienceConfig(retry_backoff_ms=0.0))
    if batching == "continuous":
        jsched = R.jcontinuous.ContinuousScheduler(
            R.jcontinuous.ContinuousEngine(jl, lparams, sampling=R.JSampling(**greedy), dtypes=R.JFP32,
                                           engine_config=dataclasses.replace(jec, kv_paged=True, attn_impl="xla")),
            retry_backoff_s=0.0)
        tsched = R.tapp.build_scheduler(teng, dataclasses.replace(tec, batching="continuous", kv_paged=True),
                                        tcfg.resilience)
    else:
        jsched, tsched = R.JBatchScheduler(jeng, max_wait_ms=30.0), R.BatchScheduler(teng, max_wait_ms=30.0)
    jsvc = R.JRagService(jcfg, jeng, R.ByteTokenizer(), R.JEncoderRunner(je, eparams, dtypes=R.JFP32,
                                                                        length_buckets=(32, 64), max_batch=4),
                         R.ByteTokenizer(), R.JStore(dim=je.hidden_size), scheduler=jsched)
    tsvc = R.tapp.RagService(tcfg, teng, R.ByteTokenizer(), R.EncoderRunner(ec, enc, device="cpu",
                                                                            length_buckets=(32, 64), max_batch=4),
                             R.ByteTokenizer(), R.VectorStore(dim=ec.hidden_size, device="cpu"), scheduler=tsched)
    meta = [{"filename": "f", "chunk_id": i, "text": t} for i, t in enumerate(R.TEXTS)]
    for svc in (jsvc, tsvc):
        svc.store.add(list(svc.encoder.encode([R.ByteTokenizer().encode(t) for t in R.TEXTS])),
                      [dict(x) for x in meta])
        # warmup's prefix step: pin and build the head
        head_key = f"head:{len(svc._a_ids())}"
        svc.engine.prefix_cache.pin(head_key)
        svc.engine.prefix_cache.prefix_for([(head_key, svc._a_ids())])
        svc.ready = True
    return {"jax": (jsvc, R.jcreate_app(jsvc).test_client()), "port": (tsvc, R.tapp.create_app(tsvc).test_client())}


PROMPTS = ["alpha", "delta", "alpha", "zeta", "alpha beta gamma and delta epsilon zeta?"]


def _serve(pair, prompts=PROMPTS):
    out = []
    for p in prompts:
        out.append({side: R._post(side, client, "/generate", {"prompt": p}) for side, (_, client) in pair.items()})
    return out


@pytest.fixture(scope="module")
def served():
    made = {}

    def get(mode, batching="coalesce"):
        if (mode, batching) not in made:
            pair = _make_prefix_pair(mode, batching)
            made[(mode, batching)] = (pair, _serve(pair))
        return made[(mode, batching)]

    yield get
    for pair, _ in made.values():
        for svc, _ in pair.values():
            svc.shutdown()


def _body(r):
    return {k: v for k, v in r.get_json().items() if k != "timings"}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_the_prefixed_path_serves_the_jax_answers_and_timings_keys(served, mode):
    pair, got = served(mode)
    for by_side in got:
        assert by_side["port"].status_code == by_side["jax"].status_code == 200
        assert _body(by_side["port"]) == _body(by_side["jax"])
        tk, jk = (set(by_side[s].get_json()["timings"]) for s in ("port", "jax"))
        # the JAX service's goodput keys (chip_ms, goodput_frac, ...) are ROADMAP.md Queue 1 item 9c
        assert tk == {k for k in jk if k not in ("chip_ms", "goodput_frac", "cost_usd")}
        assert {"prefix_resolve_ms", "prefix_reuse_frac", "prefill_tokens_skipped",
                "prefill_tokens_skipped_frac"} <= tk
    port_t = [g["port"].get_json()["timings"] for g in got]
    jax_t = [g["jax"].get_json()["timings"] for g in got]
    for key in ("prefix_reuse_frac", "prefill_tokens_skipped", "prefill_tokens_skipped_frac"):
        assert [t[key] for t in port_t] == [t[key] for t in jax_t], key
    assert port_t[2]["prefix_reuse_frac"] > port_t[0]["prefix_reuse_frac"]  # the repeat hits the memo
    svc = pair["port"][0]
    assert svc.metrics.counter("query_prefix_cached").value == len(PROMPTS)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_the_scrape_counts_match(served, mode):
    pair, _ = served(mode)
    sc = {side: _exposition(client.get("/metrics").get_data(as_text=True)) for side, (_, client) in pair.items()}
    (jf, js), (tf, ts) = sc["jax"], sc["port"]
    checked = 0
    for (name, labels), v in ts.items():
        fam = _family_of(name, tf)
        kind = tf[fam][0].split()[3]
        time_valued = name.endswith(("_seconds_total", "_seconds_sum")) or (kind == "histogram"
                                                                            and not name.endswith("_count"))
        if time_valued or fam in UNEQUAL_BY_DESIGN:
            continue
        if kind == "gauge" and not fam.startswith(("tpu_rag_prefix_cache", "rag_kv_tier")):
            continue
        assert v == js[(name, labels)], (name, labels)
        checked += 1
    assert checked >= 40
    assert ts[("tpu_rag_query_prefix_cached", "")] == len(PROMPTS)
    assert ts[("tpu_rag_prefix_cache_hits", "")] > 0 and ts[("tpu_rag_prefill_tokens_skipped", "")] > 0
    if mode == "chunk_tiered":
        assert ts[("rag_prefix_chunk_reuse_total", '{outcome="rerotated"}')] > 0


@pytest.mark.parametrize("site", ["kv_swap_in", "chunk_splice"])
def test_a_planted_fault_falls_back_as_jax_does(site):
    pair = _make_prefix_pair("chunk_tiered")
    try:
        _serve(pair, ["alpha", "delta"])
        for svc, _ in pair.values():
            if site == "kv_swap_in":
                svc.engine.prefix_cache.force_demote("cold")
            # a new chain, so no memo hit hides the fallback
            svc.engine.prefix_cache._assembled.clear()
        jfaults.arm(site)
        tfaults.arm(site)
        got = _serve(pair, ["zeta"])[0]
        assert got["port"].status_code == got["jax"].status_code == 200
        assert _body(got["port"]) == _body(got["jax"])
        caches = {side: svc.engine.prefix_cache for side, (svc, _) in pair.items()}
        key = "swap_in_fallbacks" if site == "kv_swap_in" else "splice_faults"
        stats = {side: {**c.tier_stats(), **c.chunk_reuse_counters()} for side, c in caches.items()}
        assert stats["port"][key] == stats["jax"][key] == 1
        assert stats["port"] == stats["jax"]
        assert {s: c.counters() for s, c in caches.items()}["port"] == caches["jax"].counters()
        assert len(caches["port"].spill) == len(caches["jax"].spill)  # no host buffer leaked
        assert not tfaults.armed() and not jfaults.armed()
    finally:
        for svc, _ in pair.values():
            svc.shutdown()


def test_continuous_serving_takes_the_prefixed_path_for_a_solo_request(served):
    pair, got = served("exact", "continuous")
    for by_side in got:
        assert by_side["port"].status_code == by_side["jax"].status_code == 200
        assert _body(by_side["port"]) == _body(by_side["jax"])
        assert "prefix_resolve_ms" in by_side["port"].get_json()["timings"]
    sched = pair["port"][0].scheduler
    assert sched.engine.stats.decode_tokens == 0  # nothing reached the continuous engine


def test_a_failed_resolve_is_a_degraded_answer_on_both(monkeypatch):
    pair = _make_prefix_pair("exact")
    try:
        for svc, _ in pair.values():
            monkeypatch.setattr(svc.engine.prefix_cache, "prefix_for",
                                lambda segs: (_ for _ in ()).throw(RuntimeError("boom")))
        got = _serve(pair, ["alpha"])[0]
        assert got["port"].status_code == got["jax"].status_code == 200
        assert _body(got["port"]) == _body(got["jax"])
        assert got["port"].get_json()["degraded_reasons"] == ["prefix_cache"]
        assert "prefix_resolve_ms" not in got["port"].get_json()["timings"]
    finally:
        for svc, _ in pair.values():
            svc.shutdown()
