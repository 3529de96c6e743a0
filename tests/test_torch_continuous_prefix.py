"""The continuous engine's half of the KV prefix cache in the port against
the JAX package's, on shared tiny fp32 weights (``models/convert.py``):

- ``admit_prefixed``, paged and dense, bf16 and int8 KV: the first token
  and the greedy stream equal JAX's (and the port's own cold admission of
  the whole prompt), the row's K/V within 1e-5 of JAX's (2e-2 int8), the
  same ``prefill_tokens_skipped``, the same ``ValueError`` messages;
- one scripted sequence of pool-side steps on both engines (prestage, a
  sharing admission, ``release_prestaged`` with ``only_unused``, a stale
  generation, retier to cold, reclaim under pressure, the ``kv_swap_in``
  fault, ``reset()``): after every step the same ``KVBlockPool.stats()``,
  ``tier_occupancy()``, ``reclaimable_blocks()``, ref counts and
  fragmentation numerator, and no block leaks at the end;
- a prefix near the row's capacity: the suffix's pad lanes write where JAX
  writes them and no other block changes;
- chunk-granular splice (``reuse="chunk"``): the plan, the re-rotated and
  boundary-fixed arena blocks against JAX's, the stream against JAX's and
  the one-shot ``generate_prefixed``, the ``chunk_splice`` fault falling back
  to the scatter with zero leaked blocks;
- the reclaim branches of block growth and of the interleaved chunk
  allocator against JAX's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
from rag_llm_k8s_tpu.core.config import EngineConfig as JEngineConfig
from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
from rag_llm_k8s_tpu.core.config import PrefixCacheConfig as JPrefixCacheConfig
from rag_llm_k8s_tpu.core.config import SamplingConfig as JSampling
from rag_llm_k8s_tpu.engine.continuous import ContinuousEngine as JContinuousEngine
from rag_llm_k8s_tpu.engine.engine import InferenceEngine as JEngine
from rag_llm_k8s_tpu.models.llama import init_llama_params
from rag_llm_k8s_tpu.obs import flight as jflight
from rag_llm_k8s_tpu.resilience import faults as jfaults
from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, EngineConfig, LlamaConfig, PrefixCacheConfig, SamplingConfig
from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models import llama as tllama
from rag_llm_k8s_tpu_torch.obs import flight as tflight
from rag_llm_k8s_tpu_torch.resilience import faults as tfaults

CPU = torch.device("cpu")
FP32, JFP32 = DTypePolicy.fp32(), JDTypes.fp32()
VOCAB = 128
GREEDY = dict(do_sample=False, max_new_tokens=6)
# tests/test_lookahead.py's pool-prestage configuration with a 32-token
# segment bucket (bf16 KV), and an int8 one with blocks of 32
PC = dict(enabled=True, max_prefix_tokens=48, segment_buckets=(16, 32), suffix_buckets=(16,), hbm_budget_mb=64)
EC = dict(prompt_buckets=(64,), max_batch_size=2, speculative="off", max_seq_len=128)
KV = {
    "bf16": dict(pc=PC, bs=16),
    "int8": dict(pc=dict(PC, max_prefix_tokens=64), bs=32),
}
# tests/test_chunk_reuse.py's chunk-reuse configuration
CHUNK_PC = dict(enabled=True, max_prefix_tokens=64, segment_buckets=(16,), suffix_buckets=(16,), hbm_budget_mb=64,
                reuse="chunk", boundary_tokens=4, chunk_hot_min=0.0)
CHUNK_EC = dict(prompt_buckets=(64, 128), max_batch_size=2, speculative="off", max_seq_len=256)


@pytest.fixture(autouse=True)
def _clean():
    for f in (jfaults, tfaults):
        f.clear()
    yield
    for f in (jfaults, tfaults):
        f.clear()


@pytest.fixture(scope="module")
def weights():
    params = init_llama_params(jax.random.PRNGKey(0), JLlamaConfig.tiny(vocab_size=VOCAB), JFP32)
    model = convert.load_llama(tllama.build_llama(LlamaConfig.tiny(vocab_size=VOCAB), FP32, CPU),
                               convert.flatten_tree(params))
    return params, model


def _pair(weights, pc=PC, ec=EC, kv_quant="bf16", paged=True, bs=16, **cont):
    """``(jax one-shot, jax continuous, port one-shot, port continuous)``
    over the same weights and configs; the one-shot engines own the
    prefix caches whose descriptors the continuous engines admit."""
    params, model = weights
    jcfg, tcfg = JLlamaConfig.tiny(vocab_size=VOCAB), LlamaConfig.tiny(vocab_size=VOCAB)
    base = dict(ec, kv_quant=kv_quant)
    ckw = dict(cont, kv_paged=True, kv_block_size=bs) if paged else dict(cont)
    jeng = JEngine(jcfg, params, sampling=JSampling(**GREEDY), dtypes=JFP32,
                   engine_config=JEngineConfig(**base, prefix_cache=JPrefixCacheConfig(**pc), attn_impl="xla"))
    jc = JContinuousEngine(jcfg, params, sampling=JSampling(**GREEDY), dtypes=JFP32,
                           engine_config=JEngineConfig(**base, **ckw, prefix_cache=JPrefixCacheConfig(**pc),
                                                       attn_impl="xla"))
    teng = InferenceEngine(tcfg, model, SamplingConfig(**GREEDY),
                           EngineConfig(**base, prefix_cache=PrefixCacheConfig(**pc)), FP32, "cpu")
    tc = ContinuousEngine(tcfg, model, SamplingConfig(**GREEDY),
                          EngineConfig(**base, **ckw, prefix_cache=PrefixCacheConfig(**pc)), FP32, "cpu")
    return jeng, jc, teng, tc


def _corpus(seed, head_len=16, chunk_len=16, suffix_len=6):
    r = np.random.default_rng(seed)
    head = [1] + [int(x) for x in r.integers(3, 120, head_len - 1)]
    chunk = [int(x) for x in r.integers(3, 120, chunk_len)]
    suffix = [int(x) for x in r.integers(3, 120, suffix_len)]
    return head, chunk, suffix


def _drain(eng, rid, fin):
    outs = {}
    for _ in range(200):
        if not eng.has_active():
            break
        for r, toks in eng.step():
            outs[r] = toks
    return fin if fin is not None else outs[rid]


def _jplanes(jc):
    return [np.asarray(p) for p in jc._cache]


def _tplanes(tc):
    return [p.numpy() for p in tc._cache_planes(tc.arena if tc.paged else None)]


def _dense(planes):
    """fp32 K and V of a plane list (int8 dequantized by its scales)."""
    if len(planes) == 4:
        return [planes[0].astype(np.float32) * planes[2][..., None],
                planes[1].astype(np.float32) * planes[3][..., None]]
    return [p.astype(np.float32) for p in planes]


def _row_kv(planes, eng, row, n, paged):
    """The row's K/V at logical positions ``[0, n)``: ``[L, K, n, hd]``."""
    out = []
    for p in _dense(planes):
        if paged:
            ids = list(eng._slot_blocks[row])
            x = p[:, ids]  # [L, nb, K, bs, hd]
            x = x.transpose(0, 2, 1, 3, 4).reshape(p.shape[0], p.shape[2], -1, p.shape[4])
            out.append(x[:, :, :n])
        else:
            start = int(np.asarray(eng._kv_start)[row])
            out.append(p[:, row, :, start:start + n])
    return out


def _pool_view(eng):
    """Everything the pool exposes, for equality across the two engines."""
    pool = eng.kv_pool
    return {
        "stats": pool.stats(), "tiers": eng.tier_occupancy(), "reclaimable": eng.reclaimable_blocks(),
        "refs": {b: pool.refcount(b) for b in range(1, pool.num_blocks) if pool.refcount(b)},
        "used_tokens": eng.pool_used_tokens(),
        "regs": sorted((len(v[0]), v[2]) for v in eng._prefix_blocks.values()),
        "chunk_regs": sorted((k, len(v[0]), v[1], v[2], v[4]) for k, v in eng._chunk_regs.items()),
    }


def _same_pool(jc, tc, step):
    assert _pool_view(tc) == _pool_view(jc), step


# ---------------------------------------------------------------------------
# admit_prefixed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", ["bf16", "int8"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_admit_prefixed_gives_the_jax_tokens_and_row_kv(weights, paged, kv_quant):
    kq = KV[kv_quant]
    jeng, jc, teng, tc = _pair(weights, pc=kq["pc"], kv_quant=kv_quant, paged=paged, bs=kq["bs"])
    head, chunk, suffix = _corpus(11, head_len=23, chunk_len=16, suffix_len=6)
    segs = [("head", head), ("chunk", chunk)]
    jcp, tcp = jeng.prefix_cache.prefix_for(segs), teng.prefix_cache.prefix_for(segs)
    total = tcp.length + len(suffix)
    jrow, jfin = jc.admit_prefixed(1, suffix, jcp, max_new=6)
    trow, tfin = tc.admit_prefixed(1, suffix, tcp, max_new=6)
    assert (trow, tfin) == (jrow, jfin)
    assert tc.slots[trow].tokens == jc.slots[jrow].tokens  # tok0
    tol = 1e-5 if kv_quant == "bf16" else 2e-2
    for got, want in zip(_row_kv(_tplanes(tc), tc, trow, total, paged), _row_kv(_jplanes(jc), jc, jrow, total, paged)):
        np.testing.assert_allclose(got, want, atol=tol)
    assert int(tc._kv_len[trow]) == int(np.asarray(jc._kv_len)[jrow])
    want = _drain(jc, 1, jfin)
    got = _drain(tc, 1, tfin)
    assert got == want and len(got) == 6
    for name in ("prefill_tokens_skipped", "prefill_tokens", "generate_calls", "decode_tokens"):
        assert getattr(tc.stats, name) == getattr(jc.stats, name), name
    if paged:
        _same_pool(jc, tc, "after the drain")
    # the port's own cold admission of the whole prompt
    res = tc.admit_many([(2, head + chunk + suffix, 6, None)])[0]
    assert _drain(tc, 2, res[1]) == got


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("case", ["empty", "long_suffix", "capacity", "bucket"])
def test_admit_prefixed_refuses_what_jax_refuses(weights, paged, case):
    jeng, jc, teng, tc = _pair(weights, paged=paged)
    head, chunk, suffix = _corpus(5)
    segs = [("head", head), ("chunk", chunk)]
    jcp, tcp = jeng.prefix_cache.prefix_for(segs), teng.prefix_cache.prefix_for(segs)
    if case == "empty":
        suffix = []
    elif case == "long_suffix":
        suffix = list(range(3, 20))
    elif case == "capacity":
        jcp, tcp = dataclasses.replace(jcp, capacity=32), dataclasses.replace(tcp, capacity=32)
    else:  # a prompt past the largest bucket (64)
        jcp, tcp = dataclasses.replace(jcp, length=60), dataclasses.replace(tcp, length=60)
    errs = []
    for eng, cp in ((jc, jcp), (tc, tcp)):
        with pytest.raises(ValueError) as e:
            eng.admit_prefixed(1, suffix, cp, max_new=6)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    assert not tc.has_active() and (not paged or tc.kv_pool.blocks_in_use() == 0)


def test_an_eos_first_token_retires_the_row_as_jax_does(weights):
    jeng, jc, teng, tc = _pair(weights)
    head, chunk, suffix = _corpus(11)
    segs = [("head", head), ("chunk", chunk)]
    jcp, tcp = jeng.prefix_cache.prefix_for(segs), teng.prefix_cache.prefix_for(segs)
    got = tc.admit_prefixed(1, suffix, tcp, max_new=1)
    want = jc.admit_prefixed(1, suffix, jcp, max_new=1)
    assert got == want and got[1] is not None and len(got[1]) == 1
    assert not tc.has_active()
    _same_pool(jc, tc, "a budget of one")


# ---------------------------------------------------------------------------
# the ref-count sequence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", ["bf16", "int8"])
def test_the_ref_count_sequence_gives_the_jax_pool_state(weights, kv_quant):
    kq = KV[kv_quant]
    jeng, jc, teng, tc = _pair(weights, pc=kq["pc"], kv_quant=kv_quant, bs=kq["bs"], kv_pool_blocks=12)
    sides = ((jeng, jc), (teng, tc))
    head, chunk, suffix = _corpus(11)
    head2, chunk2, suffix2 = _corpus(17)
    head3, chunk3, _ = _corpus(23)
    segs = [("head", head), ("chunk", chunk)]
    segs2 = [("head2", head2), ("chunk2", chunk2)]
    segs3 = [("head3", head3), ("chunk3", chunk3)]
    cps = [(e.prefix_cache.prefix_for(segs), e.prefix_cache.prefix_for(segs2), e.prefix_cache.prefix_for(segs3))
           for e, _ in sides]

    def both(fn, step):
        outs = [fn(c, cp) for (_, c), cp in zip(sides, cps)]
        assert outs[1] == outs[0], step
        _same_pool(jc, tc, step)
        return outs[1]

    assert both(lambda c, cp: c.prestage_prefix(cp[0]), "prestage") == "registered"
    assert both(lambda c, cp: c.prestage_prefix(cp[0]), "prestage again") == "resident"
    shared = list(tc._prefix_blocks[cps[1][0].chain_key][0])
    row, fin = both(lambda c, cp: c.admit_prefixed(1, suffix, cp[0], max_new=6), "a sharing admission")
    assert fin is None and all(tc.kv_pool.refcount(b) == 2 for b in shared)  # copy-free: row + registration
    assert tc._slot_blocks[row][:len(shared)] == shared
    assert tc.stats.prefill_tokens_skipped == cps[1][0].length
    both(lambda c, cp: _drain(c, 1, fin), "drain")
    assert both(lambda c, cp: c.release_prestaged(cp[0].chain_key, only_unused=True), "only_unused") is False
    # a warm registration, then its stale generation
    assert both(lambda c, cp: c.prestage_prefix(cp[1], tier="warm"), "prestage warm") == "registered"
    gen = [c.prestage_gen(cp[1].chain_key) for (_, c), cp in zip(sides, cps)]
    assert both(lambda c, cp: c.release_prestaged(cp[1].chain_key), "evicted") is True
    assert both(lambda c, cp: c.prestage_prefix(cp[1], tier="cold"), "re-created as warm") == "registered"
    for (_, c), cp, g in zip(sides, cps, gen):
        assert c.release_prestaged(cp[1].chain_key, only_unused=True, gen=g) is False
    _same_pool(jc, tc, "a stale generation")
    # retier: the first chain to warm, the second to cold (dropped)
    tiers = {0: "warm", 1: "cold"}
    both(lambda c, cp: c.retier_registrations(
        lambda k: tiers[[x.chain_key for x in cp].index(k)]), "retier")
    assert tc.tier_occupancy()["warm"] > 0 and tc.reclaimable_blocks() > 0
    # reclaim under pressure while a row decodes: the warm chain goes
    both(lambda c, cp: c.admit_many([(2, head3 + chunk3 + suffix, 30, None)])[0], "a live row")
    filler = [c.kv_pool.alloc(c.kv_pool.available() - 1) for _, c in sides]
    _same_pool(jc, tc, "a filled pool")
    assert both(lambda c, cp: c.admission_state(30), "admission under pressure") == "ok"
    assert tc.reclaimable_blocks() == 0
    for (_, c), ids in zip(sides, filler):
        c.kv_pool.free(ids)
    both(lambda c, cp: c.evict_requests([2]), "evict")
    # the kv_swap_in fault site: the prestage declines, no block leaks
    for f in (jfaults, tfaults):
        f.arm("kv_swap_in", times=1)
    assert both(lambda c, cp: c.prestage_prefix(cp[2]), "kv_swap_in fault") is False
    assert both(lambda c, cp: c.prestage_prefix(cp[2], tier="warm"), "prestage after the fault") == "registered"
    both(lambda c, cp: c.reset(), "reset")
    assert tc.kv_pool.blocks_in_use() == 0 and tc.reclaimable_blocks() == 0
    assert tc.tier_occupancy() == {"hot": 0, "warm": 0, "cold": 0, "rows": 0}


def test_growth_reclaims_registrations_before_preempting_as_jax_does(weights):
    jeng, jc, teng, tc = _pair(weights, kv_pool_blocks=8)
    sides = ((jeng, jc), (teng, tc))
    head, chunk, suffix = _corpus(31)
    segs = [("head", head), ("chunk", chunk)]
    cps = [e.prefix_cache.prefix_for(segs) for e, _ in sides]
    prompt = [int(x) for x in np.random.default_rng(3).integers(3, 120, 60)]
    for (_, c), cp in zip(sides, cps):
        c.admit_many([(1, prompt, 40, None)])
        # no headroom for a prestage: register through an admission instead
        row, fin = c.admit_prefixed(2, suffix, cp, max_new=2)
        assert fin is None
    _same_pool(jc, tc, "a registration beside a growing row")
    outs = [{}, {}]
    for _ in range(40):
        for (_, c), o in zip(sides, outs):
            if c.has_active():
                o.update(dict(c.step()))
        _same_pool(jc, tc, "growth")
    assert outs[1] == outs[0] and set(outs[1]) == {1, 2}
    assert not tc._prefix_blocks  # the registration went before any row


def test_interleaved_chunks_reclaim_registrations_as_jax_does(weights):
    ec = dict(EC, max_batch_size=2)
    jeng, jc, teng, tc = _pair(weights, ec=ec, kv_pool_blocks=8, interleave_prefill=True,
                               prefill_chunk_tokens=16)
    sides = ((jeng, jc), (teng, tc))
    head, chunk, suffix = _corpus(37)
    cps = [e.prefix_cache.prefix_for([("head", head), ("chunk", chunk)]) for e, _ in sides]
    for (_, c), cp in zip(sides, cps):
        c.kv_pool.alloc(8 - 2 - 2)  # leave room for the registration's 2 blocks and 2 more
        assert c.prestage_prefix(cp, tier="warm") is False  # no headroom
        c._register_prefix(cp.chain_key, c.kv_pool.alloc(2), cp.length, tier="warm")
    _same_pool(jc, tc, "a warm registration in a tight pool")
    prompt = [int(x) for x in np.random.default_rng(4).integers(3, 120, 60)]
    for _, c in sides:
        c.admit_many([(1, prompt, 3, None)])
    for _ in range(3):
        for _, c in sides:
            c.step()
        _same_pool(jc, tc, "a mixed window")
    assert not tc._prefix_blocks and tc.stats.mixed_windows > 0


# ---------------------------------------------------------------------------
# the right-padded suffix near the row's capacity
# ---------------------------------------------------------------------------


def test_a_near_capacity_suffix_writes_where_jax_writes(weights):
    """plen 45 + 3 suffix tokens fill 3 blocks exactly; the 16-lane suffix
    writes 13 pad lanes past them, through null table entries."""
    jeng, jc, teng, tc = _pair(weights)
    head, chunk, suffix = _corpus(41, head_len=29, chunk_len=16, suffix_len=3)
    segs = [("head", head), ("chunk", chunk)]
    jcp, tcp = jeng.prefix_cache.prefix_for(segs), teng.prefix_cache.prefix_for(segs)
    # another request's blocks stay live beside the row
    for c in (jc, tc):
        c.admit_many([(9, [7] * 20, 6, None)])
    before = _tplanes(tc)
    row, _ = tc.admit_prefixed(1, suffix, tcp, max_new=6)
    jc.admit_prefixed(1, suffix, jcp, max_new=6)
    assert tc.kv_pool.blocks_for(tcp.length + len(suffix)) * 16 < tcp.length + 16  # pad lanes past the blocks
    after, want = _tplanes(tc), _jplanes(jc)
    own = set(tc._slot_blocks[row])
    for b, a, w in zip(before, after, want):
        for blk in range(1, b.shape[1]):  # the null block takes junk on both
            if blk not in own:
                assert np.array_equal(a[:, blk], b[:, blk]), blk
            np.testing.assert_allclose(a[:, blk], w[:, blk], atol=1e-5)


# ---------------------------------------------------------------------------
# chunk-granular splice (reuse="chunk")
# ---------------------------------------------------------------------------


def _chunk_corpus(seed):
    r = np.random.default_rng(seed)
    head = [1] + [int(x) for x in r.integers(3, 120, 15)]
    a, b = ([int(x) for x in r.integers(3, 120, 16)] for _ in range(2))
    suffix = [int(x) for x in r.integers(3, 120, 6)]
    return head, a, b, suffix


def _seq_events(fl, seq0, types):
    return [e["type"] for e in fl.recorder().snapshot() if e["seq"] >= seq0 and e["type"] in types]


@pytest.mark.parametrize("kv_quant", ["bf16", "int8"])
def test_the_chunk_splice_gives_the_jax_arena_and_stream(weights, kv_quant):
    bs = 16 if kv_quant == "bf16" else 32
    pc = CHUNK_PC if kv_quant == "bf16" else dict(CHUNK_PC, segment_buckets=(32,), max_prefix_tokens=128)
    jeng, jc, teng, tc = _pair(weights, pc=pc, ec=CHUNK_EC, kv_quant=kv_quant, bs=bs)
    n = 16 if kv_quant == "bf16" else 32
    r = np.random.default_rng(21)
    head = [1] + [int(x) for x in r.integers(3, 120, n - 1)]
    a, b = ([int(x) for x in r.integers(3, 120, n)] for _ in range(2))
    suffix = [int(x) for x in r.integers(3, 120, 6)]
    sides = ((jeng, jc), (teng, tc))
    first = [e.prefix_cache.prefix_for([("head", head), ("A", a), ("B", b)]) for e, _ in sides]
    for (_, c), cp in zip(sides, first):
        _drain(c, 1, c.admit_prefixed(1, suffix, cp, max_new=6)[1])
    assert set(tc._chunk_regs) == set(jc._chunk_regs) == {"head", "A", "B"}
    _same_pool(jc, tc, "the scatter admission's chunk registrations")
    second = [e.prefix_cache.prefix_for([("head", head), ("B", b), ("A", a)]) for e, _ in sides]
    plans = [c._chunk_splice_plan(cp) for (_, c), cp in zip(sides, second)]
    assert [[(s.key, s.off, s.length, reg[1]) for s, reg in p] for p in plans][0] == \
        [[(s.key, s.off, s.length, reg[1]) for s, reg in p] for p in plans][1]
    seqs = (jflight.recorder().events_emitted, tflight.recorder().events_emitted)
    rows = [c.admit_prefixed(2, suffix, cp, max_new=6)[0] for (_, c), cp in zip(sides, second)]
    kinds = ("chunk_splice", "rerotate", "boundary_fixup")
    tev = _seq_events(tflight, seqs[1], kinds)
    assert tev == _seq_events(jflight, seqs[0], kinds)
    assert {"chunk_splice", "rerotate", "boundary_fixup"} <= set(tev)
    total = second[1].length + len(suffix)
    tol = 1e-5 if kv_quant == "bf16" else 2e-2
    for got, want in zip(_row_kv(_tplanes(tc), tc, rows[1], total, True),
                         _row_kv(_jplanes(jc), jc, rows[0], total, True)):
        np.testing.assert_allclose(got, want, atol=tol)
    got = _drain(tc, 2, None)
    assert got == _drain(jc, 2, None)
    if kv_quant == "bf16":
        # the pool-side assembly serves what the splice buffer serves
        assert got == teng.generate_prefixed(suffix, second[1])
    _same_pool(jc, tc, "the spliced admission")
    for _, c in sides:
        for k in list(c._chunk_regs):
            c._drop_chunk_reg(k)
        for k in list(c._prefix_blocks):
            c._drop_registration(k)
    _same_pool(jc, tc, "every registration dropped")
    assert tc.kv_pool.blocks_in_use() == 0 and tc._chunk_reg_tokens == 0


def test_a_planted_chunk_splice_fault_falls_back_to_the_scatter(weights):
    jeng, jc, teng, tc = _pair(weights, pc=CHUNK_PC, ec=CHUNK_EC)
    head, a, b, suffix = _chunk_corpus(23)
    sides = ((jeng, jc), (teng, tc))
    for (e, c) in sides:
        _drain(c, 1, c.admit_prefixed(1, suffix, e.prefix_cache.prefix_for([("head", head), ("A", a), ("B", b)]),
                                      max_new=6)[1])
    second = [e.prefix_cache.prefix_for([("head", head), ("B", b), ("A", a)]) for e, _ in sides]
    for f in (jfaults, tfaults):
        f.arm("chunk_splice", times=1)
    seq0 = tflight.recorder().events_emitted
    outs = [_drain(c, 2, c.admit_prefixed(2, suffix, cp, max_new=6)[1]) for (_, c), cp in zip(sides, second)]
    assert outs[1] == outs[0] == teng.generate_prefixed(suffix, second[1])
    assert not _seq_events(tflight, seq0, ("chunk_splice",))  # the scatter served
    _same_pool(jc, tc, "after the fallback")
    for _, c in sides:
        for k in list(c._chunk_regs):
            c._drop_chunk_reg(k)
        for k in list(c._prefix_blocks):
            c._drop_registration(k)
    assert tc.kv_pool.blocks_in_use() == 0 == jc.kv_pool.blocks_in_use()


def test_a_rebuilt_entry_declines_the_plan_as_jax_does(weights):
    jeng, jc, teng, tc = _pair(weights, pc=CHUNK_PC, ec=CHUNK_EC)
    head, a, b, suffix = _chunk_corpus(22)
    sides = ((jeng, jc), (teng, tc))
    for (e, c) in sides:
        _drain(c, 3, c.admit_prefixed(3, suffix, e.prefix_cache.prefix_for([("head", head), ("A", a), ("B", b)]),
                                      max_new=6)[1])
        cache = e.prefix_cache
        with cache._lock:
            cache._entries.pop(("A",))
            cache.entry_bytes = sum(x.nbytes for x in cache._entries.values())
            for k in list(cache._assembled):
                cache._pop_assembled(k)
        assert c._chunk_splice_plan(cache.prefix_for([("head", head), ("B", b), ("A", a)])) is None
