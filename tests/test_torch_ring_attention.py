"""Ring attention over ``sp`` on ``torch.distributed`` (one process per rank,
gloo on the CPU) against the JAX package's ``ring_attention_sharded`` on its
8 virtual CPU devices and against dense attention; and the sequence-parallel
Llama prefill on an ``sp=2 x tp=2`` world against JAX's ``2 x 2 x 2`` mesh
and against the port at ``sp=1`` (mirrors ``tests/test_ring_attention.py``:
causal and bidirectional, kv validity, GQA, ``test_prefill_logits_match_sp1``).

One world of four ranks runs every case (an ``sp=4`` mesh and the
launcher's ``sp=2 x tp=2`` one over the same ranks); the test functions
assert them one by one. Tolerance: relative RMS error within 1e-5 (fp32),
and fully masked rows exactly zero.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, EngineConfig, LlamaConfig, MeshConfig, SamplingConfig
from rag_llm_k8s_tpu_torch.core.mesh import make_mesh
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.llama import build_llama, make_kv_cache
from rag_llm_k8s_tpu_torch.parallel import ring_attention as ring
from rag_llm_k8s_tpu_torch.parallel.commands import serve_commands
from rag_llm_k8s_tpu_torch.parallel.launch import spawn_world
from rag_llm_k8s_tpu_torch.parallel.sharding import shard_llama_params

FP32 = DTypePolicy.fp32()
REL = 1e-5
CFG = dataclasses.replace(LlamaConfig.tiny(), num_heads=4, num_kv_heads=2, head_dim=8, hidden_size=32,
                          eos_token_ids=(LlamaConfig.tiny().vocab_size,))
B, S = 2, 32
KV_START = [0, 5]
# (name, seed, H, K, causal, valid prefix or None)
RING_CASES = [
    ("causal", 0, 4, 2, True, None),
    ("bidirectional", 0, 4, 2, False, None),
    ("kv_validity", 1, 4, 2, False, 40),
    ("gqa", 2, 8, 2, True, None),
    ("masked_rows", 3, 4, 2, True, "late"),
]
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [5, 3, 5]]


def _problem(seed, H, K, Sp=64, hd=8):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal((B, Sp, h, hd)).astype(np.float32) for h in (H, K, K))


def _valid(spec, Sp=64):
    if spec is None:
        return None
    if spec == "late":
        # row 1's keys start at 40: its causal queries before 40 see nothing
        return np.stack([np.ones(Sp, bool), np.arange(Sp) >= 40])
    return np.broadcast_to(np.arange(Sp) < spec, (B, Sp)).copy()


def _tokens():
    return np.random.default_rng(1).integers(2, CFG.vocab_size, (B, S))


def _logits(model):
    toks = torch.from_numpy(_tokens())
    pos = torch.arange(S)[None].expand(B, S)
    cache = make_kv_cache(model.local, B, S, torch.float32, torch.device("cpu"))
    with torch.inference_mode():
        return model(toks, pos, cache, torch.tensor(KV_START), torch.full((B,), S), 0).numpy()


def _engine(model, mesh=None):
    return InferenceEngine(CFG, model, SamplingConfig(max_new_tokens=6, do_sample=False),
                           EngineConfig(prompt_buckets=(16, 32), max_batch_size=2), FP32, "cpu", mesh=mesh)


def _rank(ctx, flat):
    sp4 = make_mesh(MeshConfig(dp=1, sp=4, tp=1), device="cpu", timeout_s=60)
    out = {}
    for name, seed, H, K, causal, valid in RING_CASES:
        q, k, v = (torch.from_numpy(a) for a in _problem(seed, H, K))
        val = _valid(valid)
        out[name] = ring.ring_attention_sharded(sp4, q, k, v, causal=causal,
                                                kv_valid=None if val is None else torch.from_numpy(val)).numpy()
    model = shard_llama_params(flat, ctx, CFG, FP32, "cpu")
    calls = []
    real = ring.ring_attention_sharded
    import rag_llm_k8s_tpu_torch.models.llama as llama

    llama.ring_attention_sharded = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    out["logits"] = _logits(model)
    eng = _engine(model, ctx)
    if ctx.leader:
        out["tokens"] = eng.generate(PROMPTS)
        eng.commands.stop()
    else:
        serve_commands(ctx)
    out["ring_calls"] = len(calls)
    out["staged_calls"] = ctx.staged_calls
    return out


def _dense(q, k, v, causal, valid):
    """Full-materialization GQA attention (fp64 on the host)."""
    Bq, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(Bq, Sq, K, H // K, hd).astype(np.float64)
    s = np.einsum("bqkgd,bskd->bkgqs", qg, k.astype(np.float64)) * hd ** -0.5
    ok = np.ones((Bq, Sq, Sq), bool)
    if valid is not None:
        ok &= valid[:, None, :]
    if causal:
        ok &= np.tril(np.ones((Sq, Sq), bool))[None]
    s = np.where(ok[:, None, None], s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.where(ok[:, None, None], np.exp(s - np.where(np.isfinite(m), m, 0)), 0.0)
    den = p.sum(-1, keepdims=True)
    p = np.where(den > 0, p / np.where(den > 0, den, 1), 0.0)
    o = np.einsum("bkgqs,bskd->bqkgd", p, v.astype(np.float64))
    return o.reshape(Bq, Sq, H, hd)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


@pytest.fixture(scope="module")
def ref():
    import jax

    from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
    from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
    from rag_llm_k8s_tpu.models.llama import init_llama_params

    jcfg = JLlamaConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)})
    params = init_llama_params(jax.random.PRNGKey(0), jcfg, JDTypes.fp32())
    return dict(jcfg=jcfg, params=params, flat=convert.flatten_tree(params))


@pytest.fixture(scope="module")
def world(ref):
    """The world's per-rank results, computed beside the JAX fixtures."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(spawn_world, _rank, MeshConfig(dp=1, sp=2, tp=2), device="cpu", timeout_s=60,
                      args=(ref["flat"],), join_timeout_s=300)
    pool.shutdown(wait=False)

    class _Ranks:
        def __getitem__(self, r):
            return fut.result()[r]

        def __iter__(self):
            return iter(fut.result())

    return _Ranks()


@pytest.fixture(scope="module")
def jax_ring(devices8):
    import jax.numpy as jnp

    from rag_llm_k8s_tpu.core.config import MeshConfig as JMeshConfig
    from rag_llm_k8s_tpu.core.mesh import make_mesh as jmake_mesh
    from rag_llm_k8s_tpu.parallel.ring_attention import ring_attention_sharded

    mesh = jmake_mesh(JMeshConfig(dp=1, sp=8, tp=1), devices=devices8)
    out = {}
    for name, seed, H, K, causal, valid in RING_CASES:
        q, k, v = _problem(seed, H, K)
        val = _valid(valid)
        out[name] = np.asarray(ring_attention_sharded(mesh, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                      causal=causal,
                                                      kv_valid=None if val is None else jnp.asarray(val)))
    return out


@pytest.mark.parametrize("case", RING_CASES, ids=[c[0] for c in RING_CASES])
def test_ring_matches_jax_ring_and_dense(world, jax_ring, case):
    name, seed, H, K, causal, valid = case
    got = world[0][name]
    q, k, v = _problem(seed, H, K)
    want = _dense(q, k, v, causal, _valid(valid))
    assert _rel(got, want) < REL
    assert _rel(got, jax_ring[name]) < REL
    for r in range(1, 4):  # the all-gathered output is the same on every rank
        np.testing.assert_array_equal(world[r][name], got)


def test_fully_masked_rows_are_zero(world):
    got = world[0]["masked_rows"]
    assert np.all(got[1, :40] == 0) and np.all(np.abs(got[1, 40:]).sum(-1) > 0)


@pytest.fixture(scope="module")
def sp1(ref):
    model = convert.load_llama(build_llama(CFG, FP32, torch.device("cpu")), ref["flat"])
    return dict(logits=_logits(model), tokens=_engine(model).generate(PROMPTS))


@pytest.fixture(scope="module")
def jax_logits(ref, devices8):
    import jax
    import jax.numpy as jnp

    from conftest import set_mesh

    from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
    from rag_llm_k8s_tpu.core.config import MeshConfig as JMeshConfig
    from rag_llm_k8s_tpu.core.mesh import make_mesh as jmake_mesh
    from rag_llm_k8s_tpu.models.llama import LlamaModel as JLlamaModel
    from rag_llm_k8s_tpu.models.llama import make_kv_cache as jcache

    jfp32 = JDTypes.fp32()
    toks = jnp.asarray(_tokens(), jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    window = jnp.asarray(KV_START, jnp.int32), jnp.full((B,), S, jnp.int32)
    want, _ = JLlamaModel(ref["jcfg"], jfp32, attn_impl="xla").apply(
        {"params": ref["params"]}, toks, pos, jcache(ref["jcfg"], B, S, jnp.float32), *window, jnp.int32(0))
    mesh = jmake_mesh(JMeshConfig(dp=2, sp=2, tp=2), devices=devices8)
    ring_model = JLlamaModel(ref["jcfg"], jfp32, attn_impl="xla", mesh=mesh.mesh)
    with set_mesh(mesh.mesh):
        got, _ = jax.jit(lambda p, t: ring_model.apply(
            {"params": p}, t, pos, jcache(ref["jcfg"], B, S, jnp.float32), *window, jnp.int32(0)))(ref["params"], toks)
    return dict(sp1=np.asarray(want), mesh=np.asarray(got))


@pytest.mark.parametrize("against", ["port_sp1", "jax_sp1", "jax_2x2x2"])
def test_prefill_logits_match_sp1(world, sp1, jax_logits, against):
    """sp=2 x tp=2 prefill (the ring) against sp=1 and JAX's 2x2x2 mesh, on
    each row's valid query positions."""
    got = world[0]["logits"]
    want = {"port_sp1": sp1["logits"], "jax_sp1": jax_logits["sp1"], "jax_2x2x2": jax_logits["mesh"]}[against]
    for b, start in enumerate(KV_START):
        assert _rel(got[b, start:], want[b, start:]) < REL
    assert world[0]["ring_calls"] > 0  # the prefill attended through the ring


def test_generate_on_sp2_tp2_matches_sp1(world, sp1):
    assert world[0]["tokens"] == sp1["tokens"]
    # every layer of every prefill took the ring on every rank, and CPU
    # tensors are never staged
    assert all(w["ring_calls"] == world[0]["ring_calls"] for w in world)
    assert all(w["staged_calls"] == 0 for w in world)
