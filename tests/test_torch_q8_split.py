"""Split-KV for the two int8-cache chunk kernels (``chunk_prefill_attention_q8``
and ``paged_chunk_attention_q8``), on the CPU: the launch plans their kernels
follow at the main-path shapes, and the plain split-then-merge versions
(``chunk_attention_split_xla_q8``, ``paged_chunk_attention_split_xla_q8``:
each score column times its k-scale, the PV operand ``p * v_scale`` in q's
dtype, per split, merged) against the unsplit plain versions, the JAX
package's Pallas kernels (interpret mode) and its XLA oracles, on the same
numpy inputs.

Every scale outside a row's window is NaN (and its payload random int8), a
window edge falls inside a 64-key tile, some row sees no key, and the split
sizes give several splits per row. Tolerances: fp32 inputs are held to fp32
round-off, 1e-5 (1e-4 against the paged Pallas kernel, whose block-wise
softmax sums in another order, as ``tests/test_torch_quant.py`` holds it);
bf16 queries, where the port also rounds ``p * v_scale`` and the output to
bf16, to 2e-2 (one bf16 step of an output below 4, plus the rounding of
``p * v_scale``); the JAX functions take the same bf16 queries as fp32
values, since JAX's CPU backend has no bf16 x bf16 -> fp32 product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.ops import attention as jattn
from rag_llm_k8s_tpu_torch.ops import attention as tattn

H100_SMS = 132
TILE = tattn.CHUNK_TILE_KEYS
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
PAGED_PALLAS_ATOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=atol, rtol=0)


def _queries(rng, shape, dtype):
    """The same queries for both packages. bf16 queries reach the JAX
    functions as their fp32 values: JAX's CPU backend has no bf16 x bf16 ->
    fp32 product, so there the JAX side runs in fp32."""
    q = _t(rng.standard_normal(shape).astype(np.float32))
    if dtype == "bfloat16":
        q = q.to(torch.bfloat16)
    return q, jnp.asarray(q.float().numpy())


def _out(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _q8_planes(rng, shape, bad):
    """int8 payload and fp32 scales of random K or V ``shape`` (quantized by
    the JAX package), with NaN scales and random payload wherever ``bad``."""
    q8, s = jattn.quantize_kv(jnp.asarray(rng.standard_normal(shape).astype(np.float32)))
    q8, s = np.array(q8), np.array(s)
    s[bad] = np.nan
    q8[bad] = rng.integers(-127, 128, size=q8[bad].shape)
    return q8, s


# (H, K, hd): GQA G=4 and G=1, hd 64 and 128
HEADS = [(8, 2, 64), (4, 4, 128), (4, 1, 64)]
DTYPES = ["float32", "bfloat16"]

# the main-path plans of the q8 chunk kernels: (plan, expected, cache
# capacity T, windows [(lo, hi)] of the visible keys one row tile may need)
VERIFY = tattn.chunk_launch_plan(1, 16, 32, 8, 4352, H100_SMS)
MIXED = tattn.chunk_launch_plan(8, 64, 32, 8, 136 * 32, H100_SMS)
LONG = tattn.chunk_launch_plan(1, 4096, 32, 8, 8448, H100_SMS)
MAIN_PLANS = {
    "dense verify S=16 T=4352": (VERIFY, dict(block_rows=64, row_tiles=1, split_keys=128, n_splits=34, blocks=272),
                                 4352, [(100, 4116), (37, 4116), (2085, 4109), (4115, 4116)]),
    "paged mixed window B=8 S=64 bs=32": (MIXED, dict(block_rows=128, row_tiles=2, split_keys=1408, n_splits=4,
                                                      blocks=512),
                                          136 * 32, [(0, 4351), (0, 3001), (0, 1088), (0, 4096), (0, 1)]),
    "dense long chunk S=4096 T=8448": (LONG, dict(block_rows=128, row_tiles=128, n_splits=1, blocks=1024),
                                       8448, [(100, 8192), (0, 8448), (4096, 4097)]),
}


class TestMainPathPlans:
    @pytest.mark.parametrize("name", list(MAIN_PLANS))
    def test_plan_is_pinned(self, name):
        plan, want, _, _ = MAIN_PLANS[name]
        assert {k: plan[k] for k in want} == want

    @pytest.mark.parametrize("name", list(MAIN_PLANS))
    def test_split_bounds_cover_every_window_once(self, name):
        plan, _, T, windows = MAIN_PLANS[name]
        assert plan["n_splits"] * plan["split_keys"] >= T
        for lo, hi in windows:
            bounds = tattn.split_bounds(lo, hi, plan["split_keys"], TILE)
            assert 1 <= len(bounds) <= plan["n_splits"]
            assert bounds[0][0] == lo and bounds[-1][1] == hi
            assert all(b0 == a1 for (_, b0), (a1, _) in zip(bounds, bounds[1:]))
            assert all(a % TILE == 0 for a, _ in bounds[1:])

    def test_small_grids_fill_twice_the_sms_and_the_long_chunk_takes_one_split(self):
        assert VERIFY["blocks"] >= 2 * H100_SMS and MIXED["blocks"] >= 2 * H100_SMS
        assert LONG["split_keys"] >= 8448
        # the paged plan reads the capacity MB * bs only: any frontier gives the same grid
        assert MIXED == tattn.chunk_launch_plan(8, 64, 32, 8, 136 * 32, H100_SMS)


class TestDenseQ8Splits:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("H,K,hd", HEADS)
    @pytest.mark.parametrize("split_keys,block_rows", [(64, 64), (128, 128), (192, 64)])
    def test_split_then_merge_matches_plain_pallas_and_oracle(self, H, K, hd, split_keys, block_rows, dtype):
        rng = np.random.default_rng(61 + H + K + hd + split_keys + block_rows + len(dtype))
        L, B, T, S, wi, layer = 2, 3, 256, 32, 150, 1
        # row 0 starts mid-tile, row 1 at a tile edge with its frontier
        # mid-tile inside the chunk, row 2 past every key it may see
        kv_start = np.array([37, 64, 200], np.int32)
        kv_len = np.array([wi + S, wi + 9, wi + S], np.int32)
        t = np.arange(T)
        out_win = (t[None, :] < kv_start[:, None]) | (t[None, :] >= kv_len[:, None])
        bad = np.broadcast_to(out_win[None, :, None, :], (L, B, K, T))
        k8, ks = _q8_planes(rng, (L, B, K, T, hd), bad)
        v8, vs = _q8_planes(rng, (L, B, K, T, hd), bad)
        qt, qj = _queries(rng, (B, S, H, hd), dtype)
        planes = tuple(map(_t, (k8, v8, ks, vs, kv_start, kv_len)))
        got = tattn.chunk_attention_split_xla_q8(qt, *planes, layer, wi, split_keys, block_rows)
        assert got.dtype == qt.dtype and torch.isfinite(got).all()
        got = _out(got)
        _close(got, _out(tattn.chunk_attention_xla_q8(qt, *planes, layer, wi)), ATOL[dtype])
        args = (qj,) + tuple(map(jnp.asarray, (k8, v8, ks, vs, kv_start, kv_len))) + (jnp.int32(layer), jnp.int32(wi))
        _close(got, _out(jattn.chunk_prefill_attention_q8(*args, bq=16, bk=64, interpret=True)), ATOL[dtype])
        _close(got, _out(jattn.chunk_attention_xla_q8(*args)), ATOL[dtype])
        # row 2's queries sit before its window: every one writes zeros
        assert not np.abs(got[2]).max()

    def test_one_split_is_the_unsplit_plain_version(self):
        rng = np.random.default_rng(7)
        L, B, K, T, S, H, hd, wi = 1, 2, 2, 128, 8, 8, 64, 100
        kv_start, kv_len = np.array([0, 29], np.int32), np.array([wi + S, wi + 3], np.int32)
        bad = np.zeros((L, B, K, T), bool)
        k8, ks = _q8_planes(rng, (L, B, K, T, hd), bad)
        v8, vs = _q8_planes(rng, (L, B, K, T, hd), bad)
        q = _t(rng.standard_normal((B, S, H, hd)).astype(np.float32))
        planes = tuple(map(_t, (k8, v8, ks, vs, kv_start, kv_len)))
        _close(tattn.chunk_attention_split_xla_q8(q, *planes, 0, wi, T),
               tattn.chunk_attention_xla_q8(q, *planes, 0, wi), 1e-5)

    def test_v_scale_weighs_the_product_but_not_the_sum(self):
        """Doubling every v-scale doubles the output; doubling every k-scale
        changes the softmax, not a plain factor (the k-scale acts before the
        running max)."""
        rng = np.random.default_rng(8)
        L, B, K, T, S, H, hd, wi = 1, 1, 1, 128, 4, 2, 64, 90
        kv_start, kv_len = np.array([0], np.int32), np.array([wi + S], np.int32)
        bad = np.zeros((L, B, K, T), bool)
        k8, ks = _q8_planes(rng, (L, B, K, T, hd), bad)
        v8, vs = _q8_planes(rng, (L, B, K, T, hd), bad)
        q = _t(rng.standard_normal((B, S, H, hd)).astype(np.float32))
        win = (_t(kv_start), _t(kv_len))

        def run(ksc, vsc):
            return tattn.chunk_attention_split_xla_q8(q, _t(k8), _t(v8), _t(ksc), _t(vsc), *win, 0, wi, 64)

        base = run(ks, vs)
        _close(run(ks, 2 * vs), 2 * base, 1e-5)
        assert (run(2 * ks, vs) - base).abs().max() > 1e-2


def _paged_case(rng, kv_len, L, K, bs, hd, MB, spare=3):
    """int8 arenas and scale planes (block 0 the null block) with ``[B, MB]``
    tables onto a shuffled permutation of the pool; NaN scales and random
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


class TestPagedQ8Splits:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("H,K,hd", HEADS)
    @pytest.mark.parametrize("split_keys,block_rows", [(64, 64), (128, 128), (192, 128)])
    def test_split_then_merge_matches_plain_pallas_and_oracle(self, H, K, hd, split_keys, block_rows, dtype):
        rng = np.random.default_rng(83 + H + K + hd + split_keys + block_rows + len(dtype))
        bs, MB, L, S, layer = 32, 10, 2, 16, 1
        # the mixed window scaled down: decode rows (one real lane at the
        # frontier, the other lanes junk), prompt chunks at offsets 0, 64
        # and 252, a bystander; every frontier mid-tile but one
        write_index = np.array([299, 190, 16, 0, 64, 252, 0], np.int32)
        n_real = np.array([1, 1, 1, 16, 16, 16, 0], np.int32)
        kv_len = write_index + n_real
        k8, v8, ks, vs, tables = _paged_case(rng, kv_len, L, K, bs, hd, MB)
        qt, qj = _queries(rng, (len(kv_len), S, H, hd), dtype)
        args_t = tuple(map(_t, (k8, v8, ks, vs, tables, kv_len))) + (layer, _t(write_index))
        got = tattn.paged_chunk_attention_split_xla_q8(qt, *args_t, split_keys, block_rows)
        assert got.dtype == qt.dtype and torch.isfinite(got).all()
        got = _out(got)
        _close(got, _out(tattn.paged_chunk_attention_xla_q8(qt, *args_t)), ATOL[dtype])
        args = (qj,) + tuple(map(jnp.asarray, (k8, v8, ks, vs, tables, kv_len))) + (
            jnp.int32(layer), jnp.asarray(write_index))
        # every lane, junk lanes included: a lane past kv_len sees every key below it
        _close(got, _out(jattn.paged_chunk_attention_q8(*args, bq=8, interpret=True)), PAGED_PALLAS_ATOL[dtype])
        _close(got, _out(jattn.paged_chunk_attention_xla_q8(*args)), ATOL[dtype])
        assert not np.abs(got[-1]).max()  # the bystander sees no key
