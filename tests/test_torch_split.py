"""Split-KV for the dense cache kernels, on the CPU: the split plan the
decode and chunk kernels follow, and the plain split-then-merge
(``attention_splits_plain`` + ``merge_splits``) against the unsplit plain
versions, the JAX package's Pallas kernels (interpret mode) and its XLA
oracles, on the same numpy inputs.

fp32 throughout: the point is the decomposition (split edges, windows that
start mid-tile, splits no row of a tile sees, rows with no visible key), so
the tolerance is fp32 round-off, 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.ops import attention as jattn
from rag_llm_k8s_tpu_torch.ops import attention as tattn

ATOL = 1e-5
H100_SMS = 132


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# (H, K, hd): GQA G=4 and G=1, hd 64 and 128
HEADS = [(4, 1, 64), (4, 4, 128), (8, 2, 64)]


class TestSplitPlan:
    def test_long_prompt_chunk_takes_one_split(self):
        plan = tattn.chunk_launch_plan(1, 4096, 32, 8, 8448, H100_SMS)
        assert plan["n_splits"] == 1 and plan["split_keys"] >= 8448
        assert plan["block_rows"] == 128 and plan["blocks"] == 128 * 8

    @pytest.mark.parametrize("kind", ["verify", "decode"])
    def test_main_path_shapes_fill_twice_the_sms(self, kind):
        # the speculative verify (S = 16, G = 4: one 64-row tile) and the
        # decode step at B = 1, K = 8 over the 4352-slot cache
        if kind == "verify":
            plan = tattn.chunk_launch_plan(1, 16, 32, 8, 4352, H100_SMS)
            assert plan["block_rows"] == 64 and plan["row_tiles"] == 1
        else:
            plan = tattn.decode_launch_plan(1, 8, 4352, H100_SMS)
        assert plan["blocks"] >= 2 * H100_SMS
        assert plan["split_keys"] == 128 and plan["n_splits"] == 34

    @pytest.mark.parametrize("blocks", [1, 8, 24, 100, 263, 264, 1000])
    @pytest.mark.parametrize("T", [16, 100, 4352, 8448])
    @pytest.mark.parametrize("tile", [16, 64])
    def test_plan_is_tile_aligned_and_reaches_the_target_when_keys_allow(self, blocks, T, tile):
        split_keys, n_splits = tattn.attention_split_plan(blocks, T, tile, H100_SMS)
        n_tiles = -(-T // tile)
        assert split_keys % tile == 0 and split_keys >= tile
        assert n_splits * split_keys >= T  # the splits reach every slot
        if blocks >= 2 * H100_SMS:
            assert n_splits == 1
        elif n_tiles >= -(-2 * H100_SMS // blocks):
            assert blocks * n_splits >= 2 * H100_SMS
        else:  # fewer tiles than the target: one tile per split
            assert split_keys == tile and n_splits == n_tiles

    @pytest.mark.parametrize("lo,hi", [(0, 4352), (100, 4116), (63, 64), (64, 65), (17, 17),
                                       (200, 100), (-5, 40), (4351, 4352)])
    @pytest.mark.parametrize("split_keys,tile", [(16, 16), (48, 16), (128, 64), (4352, 64)])
    def test_bounds_cover_the_window_once(self, lo, hi, split_keys, tile):
        T = 4352
        bounds = tattn.split_bounds(lo, hi, split_keys, tile)
        lo_c = max(lo, 0)
        if hi <= lo_c:
            assert bounds == []
            return
        # consecutive, non-empty, exactly [lo, hi)
        assert bounds[0][0] == lo_c and bounds[-1][1] == hi
        for (a0, b0), (a1, b1) in zip(bounds, bounds[1:]):
            assert b0 == a1
        assert all(a < b for a, b in bounds)
        # every split but the first starts on a tile edge and spans at most
        # split_keys; the first starts at lo inside its aligned split
        assert all(a % tile == 0 for a, _ in bounds[1:])
        assert all(b % tile == 0 or b == hi for _, b in bounds)
        assert all(b - a <= split_keys for a, b in bounds)
        # every plan for this cache allocates the splits any window needs
        for blocks in (1, 8, 264):
            sk, n_splits = tattn.attention_split_plan(blocks, T, tile, H100_SMS)
            assert len(tattn.split_bounds(lo, hi, sk, tile)) <= n_splits


class TestMerge:
    def test_empty_split_adds_nothing_and_no_split_gives_zeros(self):
        rng = np.random.default_rng(3)
        s, v = _t(_rand(rng, 2, 3, 40)), _t(_rand(rng, 2, 40, 8))
        ok = torch.ones(2, 3, 40, dtype=torch.bool)
        m, l, acc = tattn.attention_splits_plain(s, ok, v, [(0, 17), (17, 40)])
        base = tattn.merge_splits(m, l, acc)
        # a split with no visible key: m = NEG_INF, l = 0, acc = 0
        m0 = torch.full_like(m[:1], tattn.NEG_INF)
        padded = tattn.merge_splits(torch.cat([m, m0]), torch.cat([l, torch.zeros_like(l[:1])]),
                                    torch.cat([acc, torch.zeros_like(acc[:1])]))
        assert torch.equal(padded, base)
        # a row that no split sees writes zeros
        none = tattn.merge_splits(m0.expand(3, -1, -1).clone(), torch.zeros(3, 2, 3),
                                  torch.zeros(3, 2, 3, 8))
        assert torch.equal(none, torch.zeros(2, 3, 8))

    def test_one_split_is_the_plain_softmax(self):
        rng = np.random.default_rng(4)
        s, v = _t(_rand(rng, 3, 50)), _t(_rand(rng, 50, 16))
        ok = _t(rng.random((3, 50)) < 0.7)
        got = tattn.merge_splits(*tattn.attention_splits_plain(s, ok, v, [(0, 50)]))
        p = torch.softmax(torch.where(ok, s, torch.full_like(s, tattn.NEG_INF)), -1)
        _close(got, torch.where(ok, p, torch.zeros_like(p)) @ v)

    def test_a_split_the_causal_diagonal_hides_from_some_rows(self):
        # chunk rows of one tile at positions 10..13 over keys [0, 14): the
        # split [12, 14) is visible to rows 12 and 13 only
        rng = np.random.default_rng(5)
        s, v = _t(_rand(rng, 4, 14)), _t(_rand(rng, 14, 8))
        pos = torch.arange(10, 14)
        ok = torch.arange(14)[None, :] <= pos[:, None]
        bounds = tattn.split_bounds(0, 14, 4, 4)
        m, l, acc = tattn.attention_splits_plain(s, ok, v, bounds)
        last = len(bounds) - 1
        assert bounds[last] == (12, 14)
        assert (m[last, :2] == tattn.NEG_INF).all() and (l[last, :2] == 0).all()
        assert (acc[last, :2] == 0).all() and (l[last, 2:] > 0).all()
        p = torch.softmax(torch.where(ok, s, torch.full_like(s, tattn.NEG_INF)), -1)
        _close(tattn.merge_splits(m, l, acc), p @ v)


def _cache(rng, L, B, K, T, hd):
    return _rand(rng, L, B, K, T, hd), _rand(rng, L, B, K, T, hd)


class TestDecodeSplits:
    @pytest.mark.parametrize("H,K,hd", HEADS)
    @pytest.mark.parametrize("split_keys", [16, 48, 192])
    def test_split_then_merge_matches_plain_pallas_and_oracle(self, H, K, hd, split_keys):
        rng = np.random.default_rng(17 + H + hd + split_keys)
        L, B, T = 2, 4, 192
        kc, vc = _cache(rng, L, B, K, T, hd)
        q = _rand(rng, B, 1, H, hd)
        # windows that start and end mid-tile and mid-split, a one-key
        # window, and an empty row
        kv_start = np.array([0, 5, 100, 77], np.int32)
        kv_len = np.array([37, 183, 101, 77], np.int32)
        layer = 1
        args_t = (_t(q), _t(kc), _t(vc), _t(kv_start), _t(kv_len), layer)
        got = tattn.decode_attention_split_xla(*args_t, split_keys).numpy()
        _close(got, tattn.decode_attention_xla(*args_t).numpy())
        args = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kv_start),
                jnp.asarray(kv_len), jnp.int32(layer))
        _close(got, jattn.decode_attention(*args, bk=64, interpret=True))
        _close(got, jattn.decode_attention_xla(*args))
        assert np.all(got[3] == 0)


class TestChunkSplits:
    @pytest.mark.parametrize("H,K,hd", HEADS)
    @pytest.mark.parametrize("split_keys,block_rows", [(64, 64), (128, 128), (192, 64), (256, 128)])
    def test_split_then_merge_matches_plain_pallas_and_oracle(self, H, K, hd, split_keys, block_rows):
        rng = np.random.default_rng(23 + H + hd + split_keys + block_rows)
        L, B, T, S, wi = 2, 3, 256, 32, 150
        kc, vc = _cache(rng, L, B, K, T, hd)
        q = _rand(rng, B, S, H, hd)
        # row 0 starts mid-tile, row 1 at a tile edge with its frontier
        # inside the chunk, row 2 past every key it may see (no visible key)
        kv_start = np.array([37, 64, 200], np.int32)
        kv_len = np.array([wi + S, wi + 9, wi + S], np.int32)
        layer = 1
        args_t = (_t(q), _t(kc), _t(vc), _t(kv_start), _t(kv_len), layer, wi)
        got = tattn.chunk_attention_split_xla(*args_t, split_keys, block_rows).numpy()
        _close(got, tattn.chunk_attention_xla(*args_t).numpy())
        args = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kv_start),
                jnp.asarray(kv_len), jnp.int32(layer), jnp.int32(wi))
        _close(got, jattn.chunk_prefill_attention(*args, bq=16, bk=64, interpret=True))
        _close(got, jattn.chunk_attention_xla(*args))
        # row 2's queries sit before its window: every one writes zeros
        assert np.all(got[2, : 200 - wi] == 0)
