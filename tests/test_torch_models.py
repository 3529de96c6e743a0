"""The port's Llama and bge-m3 against the JAX package's, through the weights
bridge (``models/convert.py``), at tiny fp32 configs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
from rag_llm_k8s_tpu.core.config import EncoderConfig as JEncoderConfig
from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
from rag_llm_k8s_tpu.models import llama as jllama
from rag_llm_k8s_tpu.models.bge_m3 import BgeM3Encoder as JEncoder
from rag_llm_k8s_tpu.models.bge_m3 import init_encoder_params
from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, EncoderConfig, LlamaConfig
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.bge_m3 import build_encoder
from rag_llm_k8s_tpu_torch.models.llama import (
    KVCache,
    build_llama,
    make_kv_cache,
    mask_window,
    rope_frequencies,
)

CPU = torch.device("cpu")
FP32 = DTypePolicy.fp32()
JFP32 = JDTypes.fp32()


@pytest.fixture(scope="module")
def llama_params():
    return jllama.init_llama_params(jax.random.PRNGKey(0), JLlamaConfig.tiny(), JFP32)


@pytest.mark.parametrize("fused", [False, True])
def test_llama_logits_match_in_all_three_modes(llama_params, fused):
    jcfg, cfg = JLlamaConfig.tiny(), LlamaConfig.tiny()
    params = jllama.fuse_llama_params(llama_params) if fused else llama_params
    jmodel = jllama.LlamaModel(jcfg, JFP32, attn_impl="xla", fused_qkv=fused)
    jchunk = jmodel.copy(chunked=True)
    model = convert.load_llama(build_llama(cfg, FP32, CPU, fused=fused), convert.flatten_tree(params))

    rng = np.random.default_rng(3)
    B, S, T = 2, 16, 48
    tokens = rng.integers(3, cfg.vocab_size, size=(B, S))
    pad = np.ones((B, S), np.int64)
    pad[1, :5] = 0  # left-padded row
    tokens[1, :5] = 0
    ks, _ = mask_window(torch.from_numpy(pad))
    positions = np.clip(np.cumsum(pad, -1) - 1, 0, None)
    jcache = jllama.make_kv_cache(jcfg, B, T, jnp.float32)
    cache = make_kv_cache(cfg, B, T, torch.float32, CPU)
    ks_np = ks.numpy().astype(np.int32)

    def both(mdl_j, tok, pos, kv_len, wi, chunked):
        nonlocal jcache
        jl, jcache = mdl_j.apply(
            {"params": params}, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
            jcache, jnp.asarray(ks_np), jnp.asarray(kv_len, jnp.int32), jnp.int32(wi),
        )
        with torch.no_grad():
            tl = model(
                torch.from_numpy(tok), torch.from_numpy(pos), cache, ks,
                torch.from_numpy(kv_len), wi, chunked=chunked,
            )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)

    # prefill at slot 0, decode one token, then a chunk of 8 at slot 17
    both(jmodel, tokens, positions, np.full(B, S, np.int32), 0, False)
    real = pad.sum(-1)
    both(jmodel, rng.integers(3, cfg.vocab_size, size=(B, 1)), real[:, None], np.full(B, S + 1, np.int32), S, False)
    chunk = rng.integers(3, cfg.vocab_size, size=(B, 8))
    both(jchunk, chunk, real[:, None] + 1 + np.arange(8)[None], np.full(B, S + 9, np.int32), S + 1, True)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), atol=1e-5, rtol=0)


def test_rope_frequencies_with_llama31_scaling_match():
    want = np.asarray(jllama.rope_frequencies(JLlamaConfig.llama_3_1_8b()))
    got = rope_frequencies(LlamaConfig.llama_3_1_8b(), CPU).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_bge_m3_embeddings_match():
    jcfg, cfg = JEncoderConfig.tiny(), EncoderConfig.tiny()
    params = init_encoder_params(jax.random.PRNGKey(1), jcfg, JFP32)
    model = convert.load_encoder(build_encoder(cfg, FP32, CPU), convert.flatten_tree(params))
    rng = np.random.default_rng(4)
    B, S = 3, 24
    tokens = rng.integers(3, cfg.vocab_size, size=(B, S))
    mask = np.ones((B, S), np.int64)
    for row, n in enumerate((24, 10, 1)):  # right-padded rows
        tokens[row, n:] = cfg.pad_token_id
        mask[row, n:] = 0
    want = JEncoder(jcfg, JFP32, attn_impl="xla").apply(
        {"params": params}, jnp.asarray(tokens, jnp.int32), jnp.asarray(mask, jnp.int32)
    )
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_convert_rejects_a_layout_mismatch(llama_params):
    model = build_llama(LlamaConfig.tiny(), FP32, CPU, fused=True)
    with pytest.raises(ValueError, match="fused layout"):
        convert.load_llama(model, convert.flatten_tree(llama_params))


def test_seeded_init_is_reproducible():
    cfg = LlamaConfig.tiny()
    a = convert.init_random_(build_llama(cfg, FP32, CPU), torch.Generator().manual_seed(5))
    b = convert.init_random_(build_llama(cfg, FP32, CPU), torch.Generator().manual_seed(5))
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert torch.equal(a.final_norm.weight, torch.ones_like(a.final_norm.weight))


def test_cache_write_outside_the_cache_raises():
    cfg = LlamaConfig.tiny()
    model = convert.init_random_(build_llama(cfg, FP32, CPU), torch.Generator().manual_seed(0))
    cache: KVCache = make_kv_cache(cfg, 1, 8, torch.float32, CPU)
    tok = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="outside"):
        model(tok, tok, cache, torch.zeros(1, dtype=torch.int64), torch.full((1,), 10), 6, chunked=True)
