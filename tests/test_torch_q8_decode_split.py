"""Split-KV for the two int8-cache decode kernels (``decode_attention_q8``
and ``paged_decode_attention_q8``), on the CPU: the launch plans their
kernels follow at the main-path shapes (``decode_launch_plan``, the paged one
from the capacity ``MB * bs``, splits of at most ``DECODE_SPLIT_TILES``
tiles), and the plain split-then-merge versions
(``decode_attention_split_xla_q8``, ``paged_decode_attention_split_xla_q8``:
K and V dequantized to q's dtype as the plain versions dequantize them,
the weights in q's dtype, per 16-key-tile-aligned split, merged) against the unsplit plain
versions, the JAX package's Pallas kernels (interpret mode) and its XLA
oracles, on the same numpy inputs.

Every scale outside a row's window is NaN (and its payload random int8), a
window starts and ends mid-tile and mid-split, a row sees no key, and the
split sizes give several splits per row; the paged rows' tables map onto a
shuffled permutation of the pool. Tolerances, as ``tests/test_torch_q8_split.py``
holds the q8 chunk kernels: fp32 queries to fp32 round-off, 1e-5 (1e-4
against the paged Pallas kernel, whose block-wise softmax sums in another
order); bf16 queries, where the port also rounds the weights, the
dequantized K and V and the output to bf16, to 2e-2 (one bf16 step of an
output below 4, plus the rounding of the weights); the JAX functions take the same bf16 queries
as fp32 values, since JAX's CPU backend has no bf16 x bf16 -> fp32 product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.ops import attention as jattn
from rag_llm_k8s_tpu_torch.ops import attention as tattn
# the q8 chunk kernels' split tests build their inputs the same way
from test_torch_q8_split import ATOL, H100_SMS, PAGED_PALLAS_ATOL, _close, _out, _paged_case, _q8_planes, _queries, _t

TILE = tattn.DECODE_TILE_KEYS

# (H, K, hd): G = 4 at hd = 32, G = 1, and G = 16 (a full mma tile of heads)
HEADS = [(8, 2, 32), (4, 4, 64), (16, 1, 32)]
DTYPES = ["float32", "bfloat16"]
SPLIT_KEYS = [16, 32, 48]

# the main-path plans of the q8 decode kernels: (plan, expected, cache
# capacity T, windows [(lo, hi)] of the visible keys a row may have)
DENSE = tattn.decode_launch_plan(1, 8, 4352, H100_SMS)
PAGED = tattn.decode_launch_plan(8, 8, 136 * 32, H100_SMS)
MAIN_PLANS = {
    "dense decode B=1 K=8 T=4352": (DENSE, dict(split_keys=128, n_splits=34, blocks=272),
                                    4352, [(100, 4200), (37, 3333), (0, 4352), (4351, 4352)]),
    "paged decode B=8 K=8 bs=32 MB=136": (PAGED, dict(split_keys=128, n_splits=34, blocks=2176),
                                          136 * 32, [(0, 4351), (0, 3100), (0, 1800), (0, 600), (0, 17),
                                                     (0, 16), (0, 1), (0, 4352)]),
}


class TestMainPathPlans:
    @pytest.mark.parametrize("name", list(MAIN_PLANS))
    def test_plan_is_pinned(self, name):
        plan, want, _, _ = MAIN_PLANS[name]
        assert plan == want

    @pytest.mark.parametrize("name", list(MAIN_PLANS))
    def test_splits_are_whole_tiles_that_cover_every_window_once(self, name):
        plan, _, T, windows = MAIN_PLANS[name]
        assert plan["split_keys"] % TILE == 0 and plan["n_splits"] * plan["split_keys"] >= T
        for lo, hi in windows:
            bounds = tattn.split_bounds(lo, hi, plan["split_keys"], TILE)
            assert 1 <= len(bounds) <= plan["n_splits"]
            assert bounds[0][0] == lo and bounds[-1][1] == hi
            assert all(b0 == a1 for (_, b0), (a1, _) in zip(bounds, bounds[1:]))
            assert all(a % TILE == 0 for a, _ in bounds[1:])

    def test_grids_fill_twice_the_sms(self):
        assert DENSE["blocks"] >= 2 * H100_SMS and PAGED["blocks"] >= 2 * H100_SMS

    @pytest.mark.parametrize("B", [1, 2, 8, 64])
    def test_no_warp_walks_more_than_the_split_cap(self, B):
        """A decode warp walks its tiles one after another: the capacity
        plan's 54-tile splits at B = 8 are cut to DECODE_SPLIT_TILES, and
        the cut splits still cover the cache."""
        assert tattn.attention_split_plan(8 * 8, 136 * 32, TILE, H100_SMS)[0] == 54 * TILE
        plan = tattn.decode_launch_plan(B, 8, 136 * 32, H100_SMS)
        assert plan["split_keys"] <= tattn.DECODE_SPLIT_TILES * TILE
        assert plan["n_splits"] * plan["split_keys"] >= 136 * 32
        assert plan["blocks"] == B * 8 * plan["n_splits"]

    def test_the_paged_plan_serves_every_frontier_of_the_capacity(self):
        """The paged kernel's plan reads only MB * bs (reading kv_len would
        sync with the host): any frontier up to the capacity is covered by
        its splits, and the split plain version at that plan matches the
        unsplit one for a frontier at the capacity."""
        T = 136 * 32
        for n in range(0, T + 1, 97):
            assert len(tattn.split_bounds(0, n, PAGED["split_keys"], TILE)) <= PAGED["n_splits"]
        rng = np.random.default_rng(5)
        bs, MB, K, hd = 32, 3, 1, 32
        kv_len = np.array([MB * bs, 40], np.int32)
        k8, v8, ks, vs, tables = _paged_case(rng, kv_len, 1, K, bs, hd, MB, spare=0)
        q = _t(rng.standard_normal((2, 1, 4, hd)).astype(np.float32))
        args = (q,) + tuple(map(_t, (k8, v8, ks, vs, tables, kv_len))) + (0,)
        plan = tattn.decode_launch_plan(2, K, MB * bs, H100_SMS)
        _close(tattn.paged_decode_attention_split_xla_q8(*args, plan["split_keys"]),
               tattn.paged_decode_attention_xla_q8(*args), 1e-5)


class TestDenseQ8DecodeSplits:
    # row 0 starts and ends mid-tile and mid-split, row 1's window is empty,
    # row 2 sees the whole cache, row 3 one key
    KV_START = np.array([21, 50, 0, 77], np.int32)
    KV_LEN = np.array([103, 50, 128, 78], np.int32)

    def _case(self, rng, L, K, T, hd):
        t = np.arange(T)
        out_win = (t[None, :] < self.KV_START[:, None]) | (t[None, :] >= self.KV_LEN[:, None])
        bad = np.broadcast_to(out_win[None, :, None, :], (L, len(self.KV_LEN), K, T))
        k8, ks = _q8_planes(rng, (L, len(self.KV_LEN), K, T, hd), bad)
        v8, vs = _q8_planes(rng, (L, len(self.KV_LEN), K, T, hd), bad)
        return k8, v8, ks, vs

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("H,K,hd", HEADS)
    @pytest.mark.parametrize("split_keys", SPLIT_KEYS)
    def test_split_then_merge_matches_plain_pallas_and_oracle(self, H, K, hd, split_keys, dtype):
        rng = np.random.default_rng(31 + H + K + hd + split_keys + len(dtype))
        L, T, layer = 2, 128, 1
        k8, v8, ks, vs = self._case(rng, L, K, T, hd)
        qt, qj = _queries(rng, (len(self.KV_LEN), 1, H, hd), dtype)
        planes = tuple(map(_t, (k8, v8, ks, vs, self.KV_START, self.KV_LEN)))
        got = tattn.decode_attention_split_xla_q8(qt, *planes, layer, split_keys)
        assert got.dtype == qt.dtype and torch.isfinite(got).all()
        got = _out(got)
        _close(got, _out(tattn.decode_attention_xla_q8(qt, *planes, layer)), ATOL[dtype])
        args = (qj,) + tuple(map(jnp.asarray, (k8, v8, ks, vs, self.KV_START, self.KV_LEN))) + (jnp.int32(layer),)
        _close(got, _out(jattn.decode_attention_q8(*args, bk=64, interpret=True)), ATOL[dtype])
        _close(got, _out(jattn.decode_attention_xla_q8(*args)), ATOL[dtype])
        assert not np.abs(got[1]).max()  # row 1 sees no key: zeros

    def test_one_split_is_the_unsplit_plain_version(self):
        rng = np.random.default_rng(7)
        L, K, T, H, hd = 1, 2, 128, 8, 32
        k8, v8, ks, vs = self._case(rng, L, K, T, hd)
        q = _t(rng.standard_normal((len(self.KV_LEN), 1, H, hd)).astype(np.float32))
        planes = tuple(map(_t, (k8, v8, ks, vs, self.KV_START, self.KV_LEN)))
        _close(tattn.decode_attention_split_xla_q8(q, *planes, 0, T),
               tattn.decode_attention_xla_q8(q, *planes, 0), 1e-5)

    def test_v_scale_weighs_the_product_but_not_the_sum(self):
        """Doubling every v-scale doubles the output; doubling every k-scale
        changes the softmax, not a plain factor (the k-scale acts before the
        running max)."""
        rng = np.random.default_rng(8)
        L, K, T, H, hd = 1, 1, 128, 4, 32
        k8, ks = _q8_planes(rng, (L, 1, K, T, hd), np.zeros((L, 1, K, T), bool))
        v8, vs = _q8_planes(rng, (L, 1, K, T, hd), np.zeros((L, 1, K, T), bool))
        q = _t(rng.standard_normal((1, 1, H, hd)).astype(np.float32))
        win = (_t(np.array([5], np.int32)), _t(np.array([121], np.int32)))

        def run(ksc, vsc):
            return tattn.decode_attention_split_xla_q8(q, _t(k8), _t(v8), _t(ksc), _t(vsc), *win, 0, 32)

        base = run(ks, vs)
        _close(run(ks, 2 * vs), 2 * base, 1e-5)
        assert (run(2 * ks, vs) - base).abs().max() > 1e-2


class TestPagedQ8DecodeSplits:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("H,K,hd", HEADS)
    @pytest.mark.parametrize("split_keys", SPLIT_KEYS)
    def test_split_then_merge_matches_plain_pallas_and_oracle(self, H, K, hd, split_keys, dtype):
        rng = np.random.default_rng(53 + H + K + hd + split_keys + len(dtype))
        bs, MB, L, layer = 32, 5, 2, 1
        # the decode batch scaled down: a long row ending mid-tile, a row one
        # key into its second block, one key, a whole block, a row ending
        # mid-tile in its first block, and a bystander
        kv_len = np.array([150, 33, 1, 32, 9, 0], np.int32)
        k8, v8, ks, vs, tables = _paged_case(rng, kv_len, L, K, bs, hd, MB)
        qt, qj = _queries(rng, (len(kv_len), 1, H, hd), dtype)
        args_t = tuple(map(_t, (k8, v8, ks, vs, tables, kv_len))) + (layer,)
        got = tattn.paged_decode_attention_split_xla_q8(qt, *args_t, split_keys)
        assert got.dtype == qt.dtype and torch.isfinite(got).all()
        got = _out(got)
        _close(got, _out(tattn.paged_decode_attention_xla_q8(qt, *args_t)), ATOL[dtype])
        args = (qj,) + tuple(map(jnp.asarray, (k8, v8, ks, vs, tables, kv_len))) + (jnp.int32(layer),)
        _close(got, _out(jattn.paged_decode_attention_q8(*args, interpret=True)), PAGED_PALLAS_ATOL[dtype])
        _close(got, _out(jattn.paged_decode_attention_xla_q8(*args)), ATOL[dtype])
        assert not np.abs(got[-1]).max()  # the bystander sees no key

    def test_the_table_decides_which_blocks_a_row_reads(self):
        """Swapping two table entries of a row moves its output (the split
        version follows the table, block by block)."""
        rng = np.random.default_rng(11)
        bs, MB, L, K, H, hd = 32, 4, 1, 1, 4, 32
        kv_len = np.array([128], np.int32)
        k8, v8, ks, vs, tables = _paged_case(rng, kv_len, L, K, bs, hd, MB, spare=0)
        q = _t(rng.standard_normal((1, 1, H, hd)).astype(np.float32))
        swapped = tables.copy()
        swapped[0, [1, 3]] = swapped[0, [3, 1]]

        def run(tab, n):
            return tattn.paged_decode_attention_split_xla_q8(
                q, *map(_t, (k8, v8, ks, vs, tab, np.array([n], np.int32))), 0, 32)

        # over the whole table the order of blocks does not matter; over a
        # frontier inside block 3 it does
        _close(run(swapped, 128), run(tables, 128), 1e-5)
        assert (run(swapped, 100) - run(tables, 100)).abs().max() > 1e-2
