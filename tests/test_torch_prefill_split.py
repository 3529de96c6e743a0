"""Split-KV for ``flash_attention`` and ``paged_chunk_attention``, on the
CPU: the launch plans their kernels follow at the main-path shapes, and the
plain split-then-merge versions (``flash_attention_split_xla``,
``paged_chunk_attention_split_xla``) against the unsplit plain versions, the
JAX package's Pallas kernels (interpret mode) and its XLA oracles, on the
same numpy inputs.

fp32 throughout: the point is the decomposition (row tiles, split edges,
windows that start or end mid-tile and mid-split, rows with no visible key,
junk lanes past a paged row's frontier), so the tolerance is fp32 round-off,
1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.ops import attention as jattn
from rag_llm_k8s_tpu_torch.ops import attention as tattn

ATOL = 1e-5
H100_SMS = 132
TILE = tattn.CHUNK_TILE_KEYS


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# (H, K, hd): GQA G=4 and G=1, hd 64 and 128
HEADS = [(8, 2, 64), (4, 4, 128), (4, 1, 64)]

# the main-path plans: (name, plan, windows [(lo, hi)] of the visible keys
# one row tile may need, expected plan)
LLAMA = tattn.chunk_design_plan(1, 4096, 32, 8, 4096, 128, H100_SMS)
BGE = tattn.chunk_design_plan(8, 512, 16, 16, 512, 64, H100_SMS)
MIXED = tattn.chunk_launch_plan(8, 64, 32, 8, 272 * 16, H100_SMS)
MAIN_PLANS = {
    "flash llama S=4096": (LLAMA, dict(block_rows=128, row_tiles=128, blocks=1024, n_splits=1, design="ws"),
                           4096, [(100, 4096), (100, 101), (0, 4096)]),
    "flash bge-m3 8x512": (BGE, dict(block_rows=128, row_tiles=4, blocks=512, n_splits=1, design="chunk"),
                           512, [(0, 512), (0, 1), (0, 9)]),
    "paged chunk mixed window": (MIXED, dict(block_rows=128, row_tiles=2, split_keys=1408, n_splits=4, blocks=512),
                                 272 * 16, [(0, 4351), (0, 3001), (0, 1088), (0, 4096), (0, 1)]),
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

    def test_mixed_window_fills_the_card_without_reading_kv_len(self):
        # planned from the capacity MB * bs alone: any frontier gives the same grid
        assert MIXED["blocks"] >= 2 * H100_SMS
        assert MIXED == tattn.chunk_launch_plan(8, 64, 32, 8, 272 * 16, H100_SMS)

    @pytest.mark.parametrize("B,S,H,K,T,hd,design,ws_ok", [
        (1, 512, 32, 8, 512, 128, "chunk", False),  # small grid: split-KV, the chunk routine
        (1, 4096, 48, 8, 4096, 128, "chunk", False),  # G = 6 does not divide a 128-row tile
        (8, 512, 16, 16, 512, 64, "chunk", True),  # bge-m3: one split, but faster on the chunk routine
        (2, 1024, 32, 8, 1024, 128, "ws", True),
        (1, 4096, 32, 8, 8448, 128, "ws", True),  # the long prompt's second chunk
        (1, 16, 32, 8, 4352, 128, "chunk", False),  # the speculative verify keeps its splits
    ])
    def test_design_by_shape(self, B, S, H, K, T, hd, design, ws_ok):
        plan = tattn.chunk_design_plan(B, S, H, K, T, hd, H100_SMS)
        assert plan["design"] == design
        assert {k: plan[k] for k in ("split_keys", "n_splits")} == {
            k: v for k, v in tattn.chunk_launch_plan(B, S, H, K, T, H100_SMS).items() if k in ("split_keys", "n_splits")}
        if ws_ok:
            ws = tattn.chunk_design_plan(B, S, H, K, T, hd, H100_SMS, design="ws")
            assert ws["n_splits"] == 1 and ws["block_rows"] == 128
            assert ws["blocks"] == -(-S * (H // K) // 128) * B * K
        else:
            with pytest.raises(ValueError):
                tattn.chunk_design_plan(B, S, H, K, T, hd, H100_SMS, design="ws")


class TestFlashSplits:
    @pytest.mark.parametrize("H,K,hd", HEADS)
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("split_keys,block_rows", [(64, 64), (128, 128), (192, 128), (256, 128)])
    def test_split_then_merge_matches_plain_pallas_and_oracle(self, H, K, hd, causal, split_keys, block_rows):
        rng = np.random.default_rng(31 + H + K + hd + split_keys + block_rows + causal)
        B, S = 4, 160
        q, k, v = _rand(rng, B, S, H, hd), _rand(rng, B, S, K, hd), _rand(rng, B, S, K, hd)
        # row 0 whole; row 1 left-padded mid-tile and mid-split; row 2
        # left-padded and right-padded mid-tile; row 3 right-padded to one key
        kv_start = np.array([0, 37, 70, 0], np.int32)
        kv_len = np.array([S, S, 131, 1], np.int32)
        args_t = (_t(q), _t(k), _t(v), _t(kv_start), _t(kv_len))
        got = tattn.flash_attention_split_xla(*args_t, causal, split_keys, block_rows).numpy()
        _close(got, tattn.attention_xla(*args_t, causal).numpy())
        args = tuple(jnp.asarray(x) for x in (q, k, v, kv_start, kv_len))
        _close(got, jattn.flash_attention(*args, causal=causal, bq=32, bk=32, interpret=True))
        _close(got, jattn.attention_xla(*args, causal=causal))
        if causal:  # queries before a row's window see nothing
            assert np.all(got[1, :37] == 0) and np.all(got[2, :70] == 0)

    @pytest.mark.parametrize("causal", [True, False])
    def test_no_window_is_the_whole_row(self, causal):
        rng = np.random.default_rng(5 + causal)
        q, k, v = _rand(rng, 2, 96, 4, 64), _rand(rng, 2, 96, 1, 64), _rand(rng, 2, 96, 1, 64)
        got = tattn.flash_attention_split_xla(_t(q), _t(k), _t(v), None, None, causal, 64)
        _close(got, tattn.attention_xla(_t(q), _t(k), _t(v), None, None, causal))


def _arena(rng, kv_len, L, K, bs, hd, MB):
    """``[L, N, K, bs, hd]`` arenas (block 0 the null block) and ``[B, MB]``
    tables from a shuffled permutation of the pool; NaN in every block no
    row owns and every slot past a row's frontier."""
    need = [-(-int(n) // bs) for n in kv_len]
    N = 1 + sum(need) + 2
    perm = rng.permutation(np.arange(1, N))
    tables = np.zeros((len(kv_len), MB), np.int32)
    at = 0
    for b, nb in enumerate(need):
        tables[b, :nb] = perm[at:at + nb]
        at += nb
    out = []
    for _ in range(2):
        a = _rand(rng, L, N, K, bs, hd)
        owned = np.zeros(N, bool)
        owned[tables[tables > 0]] = True
        a[:, ~owned] = np.nan
        for b, n in enumerate(kv_len):
            if n % bs:
                a[:, tables[b, n // bs], :, n % bs:] = np.nan
        out.append(a)
    return out[0], out[1], tables


class TestPagedChunkSplits:
    @pytest.mark.parametrize("H,K,hd", HEADS)
    @pytest.mark.parametrize("split_keys,block_rows", [(64, 64), (128, 128), (192, 128)])
    def test_split_then_merge_matches_plain_pallas_and_oracle(self, H, K, hd, split_keys, block_rows):
        rng = np.random.default_rng(47 + H + K + hd + split_keys + block_rows)
        bs, MB, L, S = 16, 20, 2, 16
        # the mixed window scaled down: decode rows (one real lane at the
        # frontier, the other lanes junk), prompt chunks at offsets 0, 64
        # and 252 (the 0, 1024 and 4032 of a 4352-slot row), a bystander
        write_index = np.array([299, 190, 16, 0, 64, 252, 0], np.int32)
        n_real = np.array([1, 1, 1, 16, 16, 16, 0], np.int32)
        kv_len = write_index + n_real
        ka, va, tables = _arena(rng, kv_len, L, K, bs, hd, MB)
        q = _rand(rng, len(kv_len), S, H, hd)
        args_t = (_t(q), _t(ka), _t(va), _t(tables), _t(kv_len), 1, _t(write_index))
        got = tattn.paged_chunk_attention_split_xla(*args_t, split_keys, block_rows).numpy()
        assert np.isfinite(got).all()
        _close(got, tattn.paged_chunk_attention_xla(*args_t).numpy())
        args = (jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va), jnp.asarray(tables),
                jnp.asarray(kv_len), jnp.int32(1), jnp.asarray(write_index))
        # every lane, junk lanes included: a lane past kv_len sees every key below it
        _close(got, jattn.paged_chunk_attention(*args, bq=8, interpret=True))
        _close(got, jattn.paged_chunk_attention_xla(*args))
        assert not np.abs(got[-1]).max()
