"""The port's paged attention and paged model forward against the JAX
package's, on the same numpy inputs: the plain versions (and the kernel
wrappers' CPU dispatch) against the Pallas paged kernels in interpret mode
and their XLA oracles, the paged decoder forward against the JAX decoder's,
and the head projection's fp32 accumulation.

fp32 throughout except where bf16 rounding is the point; the tolerance is
fp32 round-off, 1e-5. Tables come from a shuffled permutation of the pool,
rows sit at 0, 1, partial, full-block and full-table frontiers, and every
block no row owns and every frontier tail hold NaN.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
from rag_llm_k8s_tpu.models.llama import LlamaModel as JLlamaModel
from rag_llm_k8s_tpu.models.llama import init_llama_params
from rag_llm_k8s_tpu.models.llama import make_kv_arena as jmake_kv_arena
from rag_llm_k8s_tpu.models.llama import make_kv_cache as jmake_kv_cache
from rag_llm_k8s_tpu.ops import attention as jattn
from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, LlamaConfig
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models import llama as tllama
from rag_llm_k8s_tpu_torch.ops import _build
from rag_llm_k8s_tpu_torch.ops import attention as tattn

ATOL = 1e-5
CPU = torch.device("cpu")

# (H, K, hd): GQA G=4, G=2 and G=1
HEADS = [(4, 1, 16), (4, 2, 16), (8, 8, 32)]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def paged_case(rng, kv_len, L, K, bs, hd, MB, spare=3):
    """Arenas ``[L, N, K, bs, hd]`` (block 0 the null block) and ``[B, MB]``
    tables mapping each row's live logical blocks onto a shuffled
    permutation of the pool. NaN fills every block no row owns and every
    slot at or past a row's frontier inside its last block."""
    need = [-(-n // bs) for n in kv_len]
    N = 1 + sum(need) + spare
    perm = rng.permutation(np.arange(1, N))
    tables = np.zeros((len(kv_len), MB), np.int32)
    at = 0
    for b, nb in enumerate(need):
        tables[b, :nb] = perm[at:at + nb]
        at += nb
    arenas = []
    for _ in range(2):
        a = rng.standard_normal((L, N, K, bs, hd)).astype(np.float32)
        owned = np.zeros(N, bool)
        owned[tables[tables > 0]] = True
        a[:, ~owned] = np.nan
        for b, n in enumerate(kv_len):
            if n % bs:
                a[:, tables[b, n // bs], :, n % bs:] = np.nan
        arenas.append(a)
    return arenas[0], arenas[1], tables


class TestPagedDecode:
    @pytest.mark.parametrize("H,K,hd", HEADS)
    @pytest.mark.parametrize("layer", [0, 1])
    def test_plain_matches_pallas_and_oracle(self, H, K, hd, layer):
        rng = np.random.default_rng(H * 10 + K + hd + layer)
        bs, MB, L = 16, 4, 2
        # bystander, one key, partial block, one full block, partial second
        # block, the full table
        kv_len = np.array([0, 1, 7, 16, 23, 64], np.int32)
        ka, va, tables = paged_case(rng, kv_len, L, K, bs, hd, MB)
        q = rng.standard_normal((len(kv_len), 1, H, hd)).astype(np.float32)
        got = tattn.paged_decode_attention_xla(_t(q), _t(ka), _t(va), _t(tables), _t(kv_len), layer)
        args = (jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va), jnp.asarray(tables),
                jnp.asarray(kv_len), jnp.int32(layer))
        pallas = jattn.paged_decode_attention(*args, interpret=True)
        oracle = jattn.paged_decode_attention_xla(*args)
        assert np.isfinite(got.numpy()).all()
        _close(got, oracle)
        _close(got, pallas)
        # the bystander row writes zeros
        assert not got[0].abs().max()

    def test_wrapper_takes_the_plain_version_on_cpu_without_a_launch(self):
        rng = np.random.default_rng(3)
        kv_len = np.array([5, 33, 0], np.int32)
        ka, va, tables = paged_case(rng, kv_len, 2, 2, 16, 16, 4)
        q = _t(rng.standard_normal((3, 1, 4, 16)).astype(np.float32))
        before = dict(_build.LAUNCHES)
        got = tattn.paged_decode_attention(q, _t(ka), _t(va), _t(tables), _t(kv_len), 1)
        want = tattn.paged_decode_attention_xla(q, _t(ka), _t(va), _t(tables), _t(kv_len), 1)
        assert torch.equal(got, want)
        assert _build.LAUNCHES == before


class TestPagedChunk:
    @pytest.mark.parametrize("H,K,hd", HEADS)
    def test_plain_matches_pallas_and_oracle(self, H, K, hd):
        rng = np.random.default_rng(H + K * 7 + hd)
        bs, MB, L, S = 16, 4, 2, 8
        # a decode row (one real lane at its frontier), prompt chunks at
        # offsets 0, 5 (mid-block) and 16 (a block edge), a chunk ending at
        # the table's end, and a bystander
        write_index = np.array([40, 0, 5, 16, 56, 0], np.int32)
        n_real = np.array([1, 8, 8, 8, 8, 0], np.int32)
        kv_len = write_index + n_real
        ka, va, tables = paged_case(rng, kv_len, L, K, bs, hd, MB)
        q = rng.standard_normal((len(kv_len), S, H, hd)).astype(np.float32)
        got = tattn.paged_chunk_attention_xla(
            _t(q), _t(ka), _t(va), _t(tables), _t(kv_len), 1, _t(write_index)
        )
        args = (jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va), jnp.asarray(tables),
                jnp.asarray(kv_len), jnp.int32(1), jnp.asarray(write_index))
        pallas = jattn.paged_chunk_attention(*args, bq=4, interpret=True)
        oracle = jattn.paged_chunk_attention_xla(*args)
        assert np.isfinite(got.numpy()).all()
        _close(got, oracle)
        _close(got, pallas)
        assert not got[-1].abs().max()

    def test_offset_causality_is_per_row(self):
        # lane t of row b sees keys [0, write_index[b] + t] and nothing past
        rng = np.random.default_rng(8)
        write_index = np.array([3, 20], np.int32)
        kv_len = write_index + 4
        ka, va, tables = paged_case(rng, kv_len, 1, 1, 16, 16, 2)
        q = _t(rng.standard_normal((2, 4, 1, 16)).astype(np.float32))
        got = tattn.paged_chunk_attention(q, _t(ka), _t(va), _t(tables), _t(kv_len), 0, _t(write_index))
        for b in range(2):
            for t in range(4):
                n = int(write_index[b]) + t + 1
                one = tattn.paged_decode_attention_xla(
                    q[b:b + 1, t:t + 1], _t(ka), _t(va), _t(tables[b:b + 1]),
                    torch.tensor([n], dtype=torch.int32), 0,
                )
                _close(got[b, t], one[0, 0])


def test_write_paged_lands_through_the_table_and_parks_overflow_in_the_null_block():
    bs, MB = 16, 2
    cache = tllama.KVCache(k=torch.zeros(1, 6, 1, bs, 2), v=torch.zeros(1, 6, 1, bs, 2))
    tables = torch.tensor([[3, 5], [2, 0]], dtype=torch.int32)
    # row 0 writes positions 14..17 (across its block edge), row 1 writes
    # 30..33: 30, 31 past its mapped block 0 of logical block 1 -> null,
    # 32, 33 past the table -> null, never clipped into logical block 1
    k = torch.arange(1, 17, dtype=torch.float32).reshape(2, 4, 1, 2)
    tllama.write_paged(cache, 0, k, -k, tables, torch.tensor([14, 30]))
    assert torch.equal(cache.k[0, 3, 0, 14:], k[0, :2, 0])
    assert torch.equal(cache.k[0, 5, 0, :2], k[0, 2:, 0])
    assert torch.equal(cache.v[0, 5, 0, :2], -k[0, 2:, 0])
    assert not cache.k[0, 2].abs().max() and not cache.k[0, 1].abs().max()
    assert cache.k[0, 0].abs().max() > 0  # the junk went to the null block


@pytest.fixture(scope="module")
def tiny_models():
    jcfg, cfg = JLlamaConfig.tiny(), LlamaConfig.tiny()
    params = init_llama_params(jax.random.PRNGKey(0), jcfg, JDTypes.fp32())
    model = convert.load_llama(tllama.build_llama(cfg, DTypePolicy.fp32(), CPU), convert.flatten_tree(params))
    return jcfg, cfg, params, model


def test_paged_chunk_then_decode_forward_matches_jax(tiny_models):
    """A mixed chunked forward (one row prefilling 8 tokens at offset 0, one
    at offset 8 over its first chunk, one bystander) then one decode step,
    through the JAX decoder in paged mode and the port's: the same logits
    and the same arena slots."""
    jcfg, cfg, params, model = tiny_models
    bs, MB, S = 16, 4, 8
    N = 1 + 3 * MB
    rng = np.random.default_rng(0)
    tables = np.zeros((3, MB), np.int32)
    tables[0, :1] = [7]
    tables[1, :2] = [2, 11]
    tokens = rng.integers(3, cfg.vocab_size, size=(3, 2 * S))
    jmodel = JLlamaModel(jcfg, JDTypes.fp32(), attn_impl="xla", chunked=True, paged=True)
    jdec = JLlamaModel(jcfg, JDTypes.fp32(), attn_impl="xla", paged=True)
    jarena = jmake_kv_arena(jcfg, N, bs, jnp.float32)
    tarena = tllama.make_kv_arena(cfg, N, bs, torch.float32, CPU)

    def both_chunk(toks, wi, n_eff, active):
        tb = np.where(active[:, None], tables, 0).astype(np.int32)
        pos = wi[:, None] + np.arange(S)[None, :]
        kv_len = (wi + n_eff).astype(np.int32)
        jl, new = jmodel.apply(
            {"params": params}, jnp.asarray(toks), jnp.asarray(pos), jarena_ref[0],
            jnp.zeros(3, jnp.int32), jnp.asarray(kv_len), jnp.asarray(wi.astype(np.int32)),
            logit_index=jnp.asarray(np.maximum(n_eff - 1, 0)), block_tables=jnp.asarray(tb),
        )
        jarena_ref[0] = new
        with torch.inference_mode():
            tl = model(
                _t(toks), _t(pos), tarena, torch.zeros(3, dtype=torch.int32), _t(kv_len), _t(wi),
                chunked=True, block_tables=_t(tb), logit_index=_t(np.maximum(n_eff - 1, 0)),
            )
        return np.asarray(jl), tl.numpy()

    jarena_ref = [jarena]
    first = np.stack([tokens[0, :S], tokens[1, :S], np.zeros(S, np.int64)])
    jl, tl = both_chunk(first, np.array([0, 0, 0]), np.array([S, S, 0]), np.array([True, True, False]))
    _close(tl[:2], jl[:2])
    second = np.stack([tokens[0, :S], tokens[1, S:], np.zeros(S, np.int64)])
    jl, tl = both_chunk(second, np.array([0, S, 0]), np.array([0, S, 0]), np.array([False, True, False]))
    _close(tl[1], jl[1])
    # one decode step for both live rows at their frontiers (8 and 16)
    wi = np.array([S, 2 * S, 0], np.int32)
    active = np.array([True, True, False])
    tb = np.where(active[:, None], tables, 0).astype(np.int32)
    tok = np.array([[5], [6], [0]])
    jl, jnew = jdec.apply(
        {"params": params}, jnp.asarray(tok), jnp.asarray(wi[:, None]), jarena_ref[0],
        jnp.zeros(3, jnp.int32), jnp.asarray(wi + 1), jnp.asarray(wi), block_tables=jnp.asarray(tb),
    )
    with torch.inference_mode():
        tl = model(_t(tok), _t(wi[:, None].astype(np.int64)), tarena, torch.zeros(3, dtype=torch.int32),
                   _t(wi + 1), _t(wi), block_tables=_t(tb))
    _close(tl[:2].numpy(), np.asarray(jl)[:2])
    # every live slot of both rows holds the same K and V
    for b, n in ((0, S + 1), (1, 2 * S + 1)):
        for p in range(n):
            blk, off = tables[b, p // bs], p % bs
            _close(tarena.k[:, blk, :, off].numpy(), np.asarray(jnew.k)[:, blk, :, off])
            _close(tarena.v[:, blk, :, off].numpy(), np.asarray(jnew.v)[:, blk, :, off])


def test_bf16_head_logits_accumulate_in_fp32_like_jax():
    """The head projection of bf16 hidden states and a bf16 head weight is
    accumulated and returned in fp32, as the JAX decoder's einsum with
    ``preferred_element_type=float32`` does: the two agree to fp32
    summation error, far inside one bf16 ulp of the logits."""
    rng = np.random.default_rng(0)
    D, V = 256, 300
    h = torch.from_numpy(rng.standard_normal((2, 3, D)).astype(np.float32)).to(torch.bfloat16)
    head = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32) * 0.05).to(torch.bfloat16)
    got = tllama.head_logits(h, head, torch.float32)
    want = np.asarray(jnp.einsum(
        "bsd,dv->bsv", jnp.asarray(h.float().numpy(), jnp.bfloat16),
        jnp.asarray(head.float().numpy().T, jnp.bfloat16), preferred_element_type=jnp.float32,
    ))
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    _close(got.numpy(), want, atol=D * np.finfo(np.float32).eps * scale)
    # the bf16-rounded projection the port used to return misses by far more
    rounded = torch.nn.functional.linear(h, head).float().numpy()
    assert np.abs(rounded - want).max() > 10 * D * np.finfo(np.float32).eps * scale


def test_bf16_decoder_logits_match_jax_within_fp32_accumulation():
    """The tiny decoder with bf16 weights and compute: the port's logits
    equal the JAX decoder's within the spread bf16 rounding of the
    hidden states allows, and the head adds no bf16 rounding of its own
    (the logits are not all representable in bf16)."""
    jcfg, cfg = JLlamaConfig.tiny(), LlamaConfig.tiny()
    bf = DTypePolicy()
    jbf = JDTypes()
    params = init_llama_params(jax.random.PRNGKey(1), jcfg, jbf)
    # bf16 -> fp32 is exact; the port's loader casts back to bf16
    as_f32 = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)
    model = convert.load_llama(tllama.build_llama(cfg, bf, CPU), convert.flatten_tree(as_f32))
    rng = np.random.default_rng(1)
    B, S = 2, 16
    toks = rng.integers(3, cfg.vocab_size, size=(B, S))
    pos = np.broadcast_to(np.arange(S), (B, S))
    ks, kl = np.zeros(B, np.int32), np.full(B, S, np.int32)
    jl, _ = JLlamaModel(jcfg, jbf, attn_impl="xla").apply(
        {"params": params}, jnp.asarray(toks), jnp.asarray(pos),
        jmake_kv_cache(jcfg, B, S),
        jnp.asarray(ks), jnp.asarray(kl), jnp.int32(0),
    )
    with torch.inference_mode():
        tl = model(_t(toks), _t(pos.copy()), tllama.make_kv_cache(cfg, B, S, torch.bfloat16, CPU),
                   _t(ks), _t(kl), 0)
    jl = np.asarray(jl)
    assert tl.dtype == torch.float32 and jl.dtype == np.float32
    # not a bf16 cast: fp32 logits carry bits below bf16's 8-bit mantissa
    assert not torch.equal(tl, tl.to(torch.bfloat16).float())
    # both accumulate the head in fp32 from bf16 hidden states: the spread
    # is the bf16 rounding of the hidden states, a few bf16 ulps of the
    # logits, and the argmax agrees wherever it is clear
    np.testing.assert_allclose(tl.numpy(), jl, atol=4 * 2.0**-8 * np.abs(jl).max(), rtol=0)
    top2 = np.sort(jl, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 8 * 2.0**-8 * np.abs(jl).max()
    assert clear.any()
    np.testing.assert_array_equal(tl.numpy().argmax(-1)[clear], jl.argmax(-1)[clear])


def test_arena_layout_is_head_major():
    cfg = dataclasses.replace(LlamaConfig.tiny(), num_layers=2)
    a = tllama.make_kv_arena(cfg, 5, 16, torch.float32, CPU)
    assert tuple(a.k.shape) == (2, 5, cfg.num_kv_heads, 16, cfg.head_dim)
    assert tuple(a.v.shape) == tuple(a.k.shape)
