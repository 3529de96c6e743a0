"""The port's int8 serving path (``weight_quant="int8"``, ``kv_quant="int8"``)
against the JAX package's, on the same numpy inputs and tiny fp32 weights.

- quantization: ``quantize_kv`` and the per-output-channel weight
  quantization equal the JAX package's bit for bit (int8 equal, fp32 scales
  equal), and the weights bridge maps a JAX ``quantize_llama_params`` tree,
  fused or not, tied or not, onto the port's quantized layout;
- the four plain q8 attention versions (kernels 5, 6, 8 and 10) against the
  JAX oracles and the JAX Pallas kernels in interpret mode, with NaN in
  every scale outside a row's window and in every block no row owns;
  tolerance fp32 round-off, 1e-5 (the paged Pallas kernels, whose
  block-wise softmax sums in another order, 1e-4, as the JAX package's own
  tests hold them);
- the int8 decoder forward (dense and paged) against JAX's
  ``LlamaModel(quantized=True, kv_quant="int8")``. A K or V value that lies
  within fp32 round-off of a rounding boundary can quantize one step apart
  in the two packages (their products sum in other orders; seen: 1 value
  in 12,288), and one step moves a logit here by ~1e-4. So the caches must
  hold equal int8 payloads except for such +-1 steps (at most 1 in 1,000
  values) and scales within fp32 round-off (1e-6), and the logits agree
  within 5e-4 (a bf16-weight forward is held to 1e-4);
- greedy streams of both engines equal the JAX engines' under int8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
from rag_llm_k8s_tpu.core.config import EngineConfig as JEngineConfig
from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
from rag_llm_k8s_tpu.core.config import SamplingConfig as JSampling
from rag_llm_k8s_tpu.engine.continuous import ContinuousEngine as JContinuousEngine
from rag_llm_k8s_tpu.engine.engine import InferenceEngine as JEngine
from rag_llm_k8s_tpu.engine.engine import maybe_quantize_params
from rag_llm_k8s_tpu.models import llama as jllama
from rag_llm_k8s_tpu.ops import attention as jattn
from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, EngineConfig, LlamaConfig, SamplingConfig
from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models import llama as tllama
from rag_llm_k8s_tpu_torch.ops import _build
from rag_llm_k8s_tpu_torch.ops import attention as tattn
from rag_llm_k8s_tpu_torch.server import app as tapp

CPU = torch.device("cpu")
FP32 = DTypePolicy.fp32()
JFP32 = JDTypes.fp32()
INT8 = dict(weight_quant="int8", kv_quant="int8")
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _same_payload(got, want):
    """int8 payloads equal except for rare one-step rounding differences
    (see the module docstring)."""
    d = np.asarray(got).astype(np.int16) - np.asarray(want).astype(np.int16)
    assert np.abs(d).max() <= 1 and np.count_nonzero(d) <= d.size // 1000


LOGIT_TOL = 5e-4  # int8 KV forward: one rounding step apart moves a logit ~1e-4


def _cfgs(tied=False, vocab=256):
    return (dataclasses.replace(JLlamaConfig.tiny(vocab), tie_word_embeddings=tied),
            dataclasses.replace(LlamaConfig.tiny(vocab), tie_word_embeddings=tied))


# ---------------------------------------------------------------------------
# quantization, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_kv_equals_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0  # an all-zero vector: the 1e-8 floor
    x[1, 1, 1, :4] = [127.0, 63.5, -0.5, 1.5]  # ties round half to even
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    xt = _t(x).to(torch.bfloat16) if dtype == "bfloat16" else _t(x)
    jq, js = jax.jit(jattn.quantize_kv)(xj)  # compiled, as the JAX package runs it
    tq, ts = tattn.quantize_kv(xt)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _flat_params(tied, fused, seed=0, vocab=256):
    jcfg, _ = _cfgs(tied, vocab)
    params = jllama.init_llama_params(jax.random.PRNGKey(seed), jcfg, JFP32)
    return jllama.fuse_llama_params(params) if fused else params


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_bridge_of_a_quantized_tree_equals_quantize_llama(tied, fused):
    """A JAX ``quantize_llama_params`` tree through the weights bridge and
    the port's own ``quantize_llama`` of the bf16 bridge give the same
    int8 weights and the same fp32 scales, bit for bit; norms (and an
    untied embedding) are the source model's own tensors."""
    jcfg, cfg = _cfgs(tied)
    params = _flat_params(tied, fused)
    qflat = convert.flatten_tree(jllama.quantize_llama_params(params))
    bridged = convert.load_llama(tllama.build_llama(cfg, FP32, CPU, fused=fused, quantized=True), qflat)
    src = convert.load_llama(tllama.build_llama(cfg, FP32, CPU, fused=fused), convert.flatten_tree(params))
    mine = tllama.quantize_llama(src)
    got, want = dict(mine.named_parameters()), dict(bridged.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in want.items():
        assert got[name].dtype == p.dtype, name
        assert torch.equal(got[name], p), name
    assert mine.final_norm.weight is src.final_norm.weight
    assert mine.layers[1].input_norm.weight is src.layers[1].input_norm.weight
    assert (mine.embed.weight is src.embed.weight) == (not tied)
    assert mine.embed.weight.dtype == (torch.int8 if tied else torch.float32)
    assert tllama.quantize_llama(mine) is mine
    with pytest.raises(ValueError, match="quantization"):
        convert.load_llama(tllama.build_llama(cfg, FP32, CPU, fused=fused), qflat)


def test_quantize_then_fuse_equals_fuse_then_quantize():
    _, cfg = _cfgs()
    params = convert.flatten_tree(_flat_params(False, False))
    a = tllama.fuse_projections_(tllama.quantize_llama(convert.load_llama(tllama.build_llama(cfg, FP32, CPU), params)))
    b = tllama.quantize_llama(tllama.fuse_projections_(convert.load_llama(tllama.build_llama(cfg, FP32, CPU), params)))
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert sorted(pa) == sorted(pb) and "layers.0.attn.wqkv.scale" in pa
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name


def test_quant_modes_are_validated_like_jax():
    with pytest.raises(ValueError, match="weight_quant"):
        maybe_quantize_params({}, JEngineConfig(weight_quant="fp8"))
    for kw in (dict(weight_quant="fp8"), dict(kv_quant="fp8")):
        with pytest.raises(ValueError, match="expected 'bf16' or 'int8'"):
            EngineConfig(**kw).validate_quant()
    with pytest.raises(ValueError, match="kv_quant"):
        tllama.make_kv_cache(LlamaConfig.tiny(), 1, 16, torch.float32, CPU, quant="fp8")


# ---------------------------------------------------------------------------
# the plain q8 attention versions against the JAX oracles and Pallas kernels
# ---------------------------------------------------------------------------


def _q8_planes(rng, shape, bad):
    """int8 payload and fp32 scales of random K or V ``shape``, with NaN
    scales and random junk payload wherever ``bad`` (``shape[:-1]``) holds."""
    q8, s = jattn.quantize_kv(jnp.asarray(rng.standard_normal(shape).astype(np.float32)))
    q8, s = np.array(q8), np.array(s)
    s[bad] = np.nan
    q8[bad] = rng.integers(-127, 128, size=q8[bad].shape)
    return q8, s


# (H, K, hd): GQA G=4, G=2 and G=1
HEADS = [(4, 1, 16), (4, 2, 16), (8, 8, 32)]


class TestDenseQ8:
    def _case(self, rng, K, hd, kv_len=(128, 100, 6), L=2, T=128):
        """Full, windowed and one-key rows (or ``kv_len``), NaN scales
        outside each row's window."""
        kv_start = np.array([0, 37, 5], np.int32)
        kv_len = np.asarray(kv_len, np.int32)
        t = np.arange(T)
        out = (t[None, :] < kv_start[:, None]) | (t[None, :] >= kv_len[:, None])  # [B, T]
        bad = np.broadcast_to(out[None, :, None, :], (L, 3, K, T))
        k8, ks = _q8_planes(rng, (L, 3, K, T, hd), bad)
        v8, vs = _q8_planes(rng, (L, 3, K, T, hd), bad)
        return k8, v8, ks, vs, kv_start, kv_len

    @pytest.mark.parametrize("H,K,hd", HEADS)
    @pytest.mark.parametrize("layer", [0, 1])
    def test_decode_matches_oracle_and_pallas(self, H, K, hd, layer):
        rng = np.random.default_rng(H + K + hd + layer)
        k8, v8, ks, vs, kv_start, kv_len = self._case(rng, K, hd)
        q = rng.standard_normal((3, 1, H, hd)).astype(np.float32)
        got = tattn.decode_attention_xla_q8(*map(_t, (q, k8, v8, ks, vs, kv_start, kv_len)), layer)
        args = tuple(map(jnp.asarray, (q, k8, v8, ks, vs, kv_start, kv_len))) + (jnp.int32(layer),)
        assert np.isfinite(got.numpy()).all()
        _close(got, jattn.decode_attention_xla_q8(*args))
        _close(got, jattn.decode_attention_q8(*args, bk=64, interpret=True))

    @pytest.mark.parametrize("H,K,hd", HEADS)
    def test_chunk_matches_oracle_and_pallas(self, H, K, hd):
        rng = np.random.default_rng(2 * H + K + hd)
        S = 16
        q = rng.standard_normal((3, S, H, hd)).astype(np.float32)
        for wi in (0, 48, 128 - S):
            k8, v8, ks, vs, kv_start, kv_len = self._case(rng, K, hd, kv_len=[wi + S] * 3)
            got = tattn.chunk_attention_xla_q8(*map(_t, (q, k8, v8, ks, vs, kv_start, kv_len)), 1, wi)
            args = tuple(map(jnp.asarray, (q, k8, v8, ks, vs, kv_start, kv_len))) + (jnp.int32(1), jnp.int32(wi))
            assert np.isfinite(got.numpy()).all()
            _close(got, jattn.chunk_attention_xla_q8(*args))
            _close(got, jattn.chunk_prefill_attention_q8(*args, bq=8, bk=64, interpret=True))

    def test_wrappers_take_the_plain_versions_on_cpu_without_a_launch(self):
        rng = np.random.default_rng(9)
        k8, v8, ks, vs, kv_start, kv_len = self._case(rng, 2, 16, kv_len=(36, 36, 36))
        planes = tuple(map(_t, (k8, v8, ks, vs)))
        q1 = _t(rng.standard_normal((3, 1, 4, 16)).astype(np.float32))
        qs = _t(rng.standard_normal((3, 4, 4, 16)).astype(np.float32))
        win = (_t(kv_start), _t(kv_len))
        before = dict(_build.LAUNCHES)
        assert torch.equal(tattn.decode_attention_q8(q1, *planes, *win, 1),
                           tattn.decode_attention_xla_q8(q1, *planes, *win, 1))
        assert torch.equal(tattn.chunk_prefill_attention_q8(qs, *planes, *win, 0, 32),
                           tattn.chunk_attention_xla_q8(qs, *planes, *win, 0, 32))
        assert _build.LAUNCHES == before


def paged_q8_case(rng, kv_len, L, K, bs, hd, MB, spare=3):
    """int8 arenas and scale planes (block 0 the null block) with ``[B, MB]``
    tables onto a shuffled permutation of the pool; NaN scales and junk
    payload in every block no row owns and every frontier tail."""
    need = [-(-int(n) // bs) for n in kv_len]
    N = 1 + sum(need) + spare
    perm = rng.permutation(np.arange(1, N))
    tables = np.zeros((len(kv_len), MB), np.int32)
    at = 0
    for b, nb in enumerate(need):
        tables[b, :nb] = perm[at:at + nb]
        at += nb
    bad = np.ones((L, N, K, bs), bool)
    for b, n in enumerate(kv_len):
        for j in range(need[b]):
            bad[:, tables[b, j], :, : min(bs, int(n) - j * bs)] = False
    k8, ks = _q8_planes(rng, (L, N, K, bs, hd), bad)
    v8, vs = _q8_planes(rng, (L, N, K, bs, hd), bad)
    return k8, v8, ks, vs, tables


class TestPagedQ8:
    @pytest.mark.parametrize("H,K,hd", HEADS)
    @pytest.mark.parametrize("layer", [0, 1])
    def test_decode_matches_oracle_and_pallas(self, H, K, hd, layer):
        rng = np.random.default_rng(3 * H + K + hd + layer)
        bs, MB, L = 32, 3, 2
        # bystander, one key, a partial block, one full block, the full table
        kv_len = np.array([0, 1, 21, 32, 96], np.int32)
        k8, v8, ks, vs, tables = paged_q8_case(rng, kv_len, L, K, bs, hd, MB)
        q = rng.standard_normal((len(kv_len), 1, H, hd)).astype(np.float32)
        got = tattn.paged_decode_attention_xla_q8(*map(_t, (q, k8, v8, ks, vs, tables, kv_len)), layer)
        args = tuple(map(jnp.asarray, (q, k8, v8, ks, vs, tables, kv_len))) + (jnp.int32(layer),)
        assert np.isfinite(got.numpy()).all()
        _close(got, jattn.paged_decode_attention_xla_q8(*args))
        _close(got, jattn.paged_decode_attention_q8(*args, interpret=True), atol=1e-4)
        assert not got[0].abs().max()

    @pytest.mark.parametrize("H,K,hd", HEADS)
    def test_chunk_matches_oracle_and_pallas(self, H, K, hd):
        rng = np.random.default_rng(5 * H + K + hd)
        bs, MB, L, S = 32, 3, 2, 8
        # a decode row, chunks at offsets 0, 5 and 32 (a block edge), one
        # ending at the table's end, and a bystander
        write_index = np.array([70, 0, 5, 32, 88, 0], np.int32)
        n_real = np.array([1, 8, 8, 8, 8, 0], np.int32)
        kv_len = write_index + n_real
        k8, v8, ks, vs, tables = paged_q8_case(rng, kv_len, L, K, bs, hd, MB)
        q = rng.standard_normal((len(kv_len), S, H, hd)).astype(np.float32)
        got = tattn.paged_chunk_attention_xla_q8(*map(_t, (q, k8, v8, ks, vs, tables, kv_len)), 1, _t(write_index))
        args = tuple(map(jnp.asarray, (q, k8, v8, ks, vs, tables, kv_len))) + (
            jnp.int32(1), jnp.asarray(write_index))
        assert np.isfinite(got.numpy()).all()
        _close(got, jattn.paged_chunk_attention_xla_q8(*args))
        _close(got, jattn.paged_chunk_attention_q8(*args, bq=4, interpret=True), atol=1e-4)
        assert not got[-1].abs().max()

    def test_wrappers_take_the_plain_versions_on_cpu_without_a_launch(self):
        rng = np.random.default_rng(4)
        kv_len = np.array([5, 40, 0], np.int32)
        k8, v8, ks, vs, tables = paged_q8_case(rng, kv_len, 2, 2, 32, 16, 2)
        planes = tuple(map(_t, (k8, v8, ks, vs)))
        q1 = _t(rng.standard_normal((3, 1, 4, 16)).astype(np.float32))
        qs = _t(rng.standard_normal((3, 4, 4, 16)).astype(np.float32))
        wi = _t(np.maximum(kv_len - 4, 0).astype(np.int32))
        before = dict(_build.LAUNCHES)
        assert torch.equal(tattn.paged_decode_attention_q8(q1, *planes, _t(tables), _t(kv_len), 1),
                           tattn.paged_decode_attention_xla_q8(q1, *planes, _t(tables), _t(kv_len), 1))
        assert torch.equal(tattn.paged_chunk_attention_q8(qs, *planes, _t(tables), _t(kv_len), 0, wi),
                           tattn.paged_chunk_attention_xla_q8(qs, *planes, _t(tables), _t(kv_len), 0, wi))
        assert _build.LAUNCHES == before


# ---------------------------------------------------------------------------
# the int8 decoder forward
# ---------------------------------------------------------------------------


def _quant_models(tied, fused=False):
    jcfg, cfg = _cfgs(tied)
    qparams = jllama.quantize_llama_params(_flat_params(tied, fused))
    model = convert.load_llama(tllama.build_llama(cfg, FP32, CPU, fused=fused, quantized=True),
                               convert.flatten_tree(qparams))
    return jcfg, cfg, qparams, model


@pytest.mark.parametrize("tied", [False, True])
def test_int8_dense_forward_matches_jax(tied):
    """Prefill at slot 0 (over the fresh K/V), one decode step and a chunk
    of 8 at slot 17, all through the int8 cache: the same logits, and the
    same int8 payloads and scales in the cache."""
    jcfg, cfg, qparams, model = _quant_models(tied)
    jmodel = jllama.LlamaModel(jcfg, JFP32, attn_impl="xla", quantized=True, kv_quant="int8")
    jchunk = jmodel.copy(chunked=True)
    rng = np.random.default_rng(3)
    B, S, T = 2, 16, 48
    tokens = rng.integers(3, cfg.vocab_size, size=(B, S))
    pad = np.ones((B, S), np.int64)
    pad[1, :5] = 0
    tokens[1, :5] = 0
    ks, _ = tllama.mask_window(_t(pad))
    ks_np = ks.numpy().astype(np.int32)
    positions = np.clip(np.cumsum(pad, -1) - 1, 0, None)
    jcache = [jllama.make_kv_cache(jcfg, B, T, jnp.float32, quant="int8")]
    cache = tllama.make_kv_cache(cfg, B, T, torch.float32, CPU, quant="int8")

    def both(mdl_j, tok, pos, kv_len, wi, chunked):
        jl, jcache[0] = mdl_j.apply(
            {"params": qparams}, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32), jcache[0],
            jnp.asarray(ks_np), jnp.asarray(kv_len, jnp.int32), jnp.int32(wi),
        )
        with torch.no_grad():
            tl = model(_t(tok), _t(pos), cache, ks, _t(kv_len), wi, chunked=chunked)
        _close(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)

    both(jmodel, tokens, positions, np.full(B, S, np.int32), 0, False)
    real = pad.sum(-1)
    both(jmodel, rng.integers(3, cfg.vocab_size, size=(B, 1)), real[:, None], np.full(B, S + 1, np.int32), S, False)
    chunk = rng.integers(3, cfg.vocab_size, size=(B, 8))
    both(jchunk, chunk, real[:, None] + 1 + np.arange(8)[None], np.full(B, S + 9, np.int32), S + 1, True)
    assert cache.k.dtype == torch.int8 and cache.k_scale.dtype == torch.float32
    for got, want in ((cache.k, jcache[0].k), (cache.v, jcache[0].v)):
        _same_payload(got.numpy(), want)
    for got, want in ((cache.k_scale, jcache[0].k_scale), (cache.v_scale, jcache[0].v_scale)):
        _close(got.numpy(), want, atol=1e-6)


def test_int8_paged_forward_matches_jax():
    """A mixed chunked forward over the int8 arena (a row prefilling 8
    tokens at offset 0, one at offset 8, a bystander), then one decode
    step, through the JAX decoder in paged mode and the port's."""
    jcfg, cfg, qparams, model = _quant_models(False, fused=True)
    bs, MB, S = 32, 2, 8
    N = 1 + 3 * MB
    tables = np.zeros((3, MB), np.int32)
    tables[0, :1] = [5]
    tables[1, :1] = [2]
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, cfg.vocab_size, size=(3, 2 * S))
    kw = dict(attn_impl="xla", quantized=True, kv_quant="int8", fused_qkv=True, paged=True)
    jmodel = jllama.LlamaModel(jcfg, JFP32, chunked=True, **kw)
    jdec = jllama.LlamaModel(jcfg, JFP32, **kw)
    jarena = [jllama.make_kv_arena(jcfg, N, bs, jnp.float32, quant="int8")]
    tarena = tllama.make_kv_arena(cfg, N, bs, torch.float32, CPU, quant="int8")

    def both(mdl, toks, wi, n_eff, active, chunked):
        tb = np.where(active[:, None], tables, 0).astype(np.int32)
        pos = wi[:, None] + np.arange(toks.shape[1])[None, :]
        kv_len = (wi + n_eff).astype(np.int32)
        extra = dict(logit_index=np.maximum(n_eff - 1, 0)) if chunked else {}
        jl, jarena[0] = mdl.apply(
            {"params": qparams}, jnp.asarray(toks), jnp.asarray(pos), jarena[0], jnp.zeros(3, jnp.int32),
            jnp.asarray(kv_len), jnp.asarray(wi.astype(np.int32)), block_tables=jnp.asarray(tb),
            **{k: jnp.asarray(v) for k, v in extra.items()},
        )
        with torch.inference_mode():
            tl = model(_t(toks), _t(pos), tarena, torch.zeros(3, dtype=torch.int32), _t(kv_len), _t(wi),
                       chunked=chunked, block_tables=_t(tb), **{k: _t(v) for k, v in extra.items()})
        return np.asarray(jl), tl.numpy()

    first = np.stack([tokens[0, :S], tokens[1, :S], np.zeros(S, np.int64)])
    jl, tl = both(jmodel, first, np.array([0, 0, 0]), np.array([S, S, 0]), np.array([True, True, False]), True)
    _close(tl[:2], jl[:2], atol=LOGIT_TOL)
    second = np.stack([tokens[0, :S], tokens[1, S:], np.zeros(S, np.int64)])
    jl, tl = both(jmodel, second, np.array([0, S, 0]), np.array([0, S, 0]), np.array([False, True, False]), True)
    _close(tl[1], jl[1], atol=LOGIT_TOL)
    jl, tl = both(jdec, np.array([[5], [6], [0]]), np.array([S, 2 * S, 0]), np.array([1, 1, 0]),
                  np.array([True, True, False]), False)
    _close(tl[:2], jl[:2], atol=LOGIT_TOL)
    for b, n in ((0, S + 1), (1, 2 * S + 1)):
        blk = tables[b, 0]
        for got, want in ((tarena.k, jarena[0].k), (tarena.v, jarena[0].v)):
            _same_payload(got[:, blk, :, :n].numpy(), np.asarray(want)[:, blk, :, :n])
        for got, want in ((tarena.k_scale, jarena[0].k_scale), (tarena.v_scale, jarena[0].v_scale)):
            _close(got[:, blk, :, :n].numpy(), np.asarray(want)[:, blk, :, :n], atol=1e-6)


# ---------------------------------------------------------------------------
# greedy streams of the engines under int8
# ---------------------------------------------------------------------------

VOCAB = 300


@pytest.fixture(scope="module")
def params300():
    return jllama.init_llama_params(jax.random.PRNGKey(0), JLlamaConfig.tiny(VOCAB), JFP32)


def _repeating(n, seed=0):
    rng = np.random.default_rng(seed)
    base = list(rng.integers(3, VOCAB, size=7))
    return (base * (n // 7 + 1))[:n]


@pytest.mark.parametrize("speculative", ["off", "prompt_lookup"])
def test_one_shot_int8_streams_match_jax(params300, speculative):
    """Bucketed (vanilla or speculative) and chunked prompts: the same
    greedy tokens as the JAX engine under int8 weights and int8 KV; the
    port's engine serves a quantized copy and leaves the bf16 model as it
    is."""
    kw = dict(prompt_buckets=(16, 32), max_seq_len=64, speculative=speculative, **INT8)
    jeng = JEngine(JLlamaConfig.tiny(VOCAB), params300, sampling=JSampling(max_new_tokens=6, do_sample=False),
                   engine_config=JEngineConfig(**kw), dtypes=JFP32)
    src = convert.load_llama(tllama.build_llama(LlamaConfig.tiny(VOCAB), FP32, CPU), convert.flatten_tree(params300))
    teng = InferenceEngine(LlamaConfig.tiny(VOCAB), src, sampling=SamplingConfig(max_new_tokens=6, do_sample=False),
                           engine_config=EngineConfig(**kw), dtypes=FP32, device="cpu")
    assert teng.model.quantized and not src.quantized
    for prompt in (_repeating(12), _repeating(40, seed=1)):  # bucket 16; two chunks of 32
        assert teng.generate([prompt]) == jeng.generate([prompt])
    if speculative == "prompt_lookup":
        assert teng.stats.spec_verify_steps > 0


PAGED_Q8 = dict(prompt_buckets=(32, 64), max_batch_size=4, max_seq_len=128, kv_paged=True, kv_block_size=32, **INT8)
MODES = {"phase-separated": PAGED_Q8, "interleaved": dict(PAGED_Q8, interleave_prefill=True, prefill_chunk_tokens=8)}
PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [12, 13, 14], [3] * 20, [9] * 40]


def _drain(eng, reqs):
    results = {}
    for (rid, _, _), res in zip(reqs, eng.admit_many([(rid, p, n, None) for rid, p, n in reqs])):
        if isinstance(res, BaseException):
            raise res
        if res[1] is not None:
            results[rid] = res[1]
    for _ in range(400):
        for rid, toks in eng.step():
            results[rid] = toks
        if not eng.has_active():
            break
    assert eng.kv_pool.blocks_in_use() == 0
    return results


@pytest.mark.parametrize("mode", MODES)
def test_continuous_int8_streams_match_jax(params300, mode):
    reqs = [(i + 1, p, 10) for i, p in enumerate(PROMPTS)]
    greedy = dict(max_new_tokens=10, do_sample=False)
    jeng = JContinuousEngine(JLlamaConfig.tiny(VOCAB), params300, sampling=JSampling(**greedy),
                             engine_config=JEngineConfig(**MODES[mode], attn_impl="xla"), dtypes=JFP32)
    model = convert.load_llama(tllama.build_llama(LlamaConfig.tiny(VOCAB), FP32, CPU), convert.flatten_tree(params300))
    teng = ContinuousEngine(LlamaConfig.tiny(VOCAB), model, SamplingConfig(**greedy), EngineConfig(**MODES[mode]),
                            FP32, "cpu")
    assert teng.arena.k.dtype == torch.int8 and not teng.arena.k_scale.abs().max()
    want = _drain(jeng, reqs)
    assert _drain(teng, reqs) == want and len(want) == len(PROMPTS)
    teng.reset()
    assert teng.arena.k_scale is not None and teng.kv_pool.blocks_in_use() == 0


def test_int8_block_size_must_be_a_multiple_of_32_in_both_packages(params300):
    bad = dict(PAGED_Q8, kv_block_size=16)
    with pytest.raises(ValueError, match="kv_block_size"):
        JContinuousEngine(JLlamaConfig.tiny(VOCAB), params300, engine_config=JEngineConfig(**bad), dtypes=JFP32)
    model = convert.load_llama(tllama.build_llama(LlamaConfig.tiny(VOCAB), FP32, CPU), convert.flatten_tree(params300))
    with pytest.raises(ValueError, match="kv_block_size"):
        ContinuousEngine(LlamaConfig.tiny(VOCAB), model, engine_config=EngineConfig(**bad), dtypes=FP32, device="cpu")
    # bf16 KV keeps taking 16
    ContinuousEngine(LlamaConfig.tiny(VOCAB), model, engine_config=EngineConfig(**dict(bad, kv_quant="bf16")),
                     dtypes=FP32, device="cpu")


def test_build_scheduler_shares_the_quantized_weights(params300):
    model = convert.load_llama(tllama.build_llama(LlamaConfig.tiny(VOCAB), FP32, CPU), convert.flatten_tree(params300))
    engine = InferenceEngine(LlamaConfig.tiny(VOCAB), model, engine_config=EngineConfig(**PAGED_Q8),
                             dtypes=FP32, device="cpu")
    sched = tapp.build_scheduler(engine, dataclasses.replace(engine.engine_config, batching="continuous"))
    try:
        assert sched.engine.model is engine.model and engine.model.quantized
        assert sched.engine.arena.k.dtype == torch.int8
    finally:
        sched.shutdown()
