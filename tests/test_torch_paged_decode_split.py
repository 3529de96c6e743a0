"""Split-KV for the bf16 paged decode kernel (``paged_decode_attention``), on
the CPU: the launch plan its kernel follows at the main-path shape
(``decode_launch_plan`` from the capacity ``MB * bs``, splits of at most
``DECODE_SPLIT_TILES`` 16-key tiles), and the plain split-then-merge version
(``paged_decode_attention_split_xla``: blocks gathered through the table,
one partial per tile-aligned split, merged) against the unsplit plain
version, the JAX package's Pallas kernel (interpret mode) and its XLA
oracle, on the same numpy inputs.

Every block no row owns and every slot past a row's frontier holds NaN,
the tables map onto a shuffled permutation of the pool, frontiers fall
mid-tile and mid-split, a row sees no key, and the split sizes give several
splits per row. Tolerances, as ``tests/test_torch_q8_split.py`` holds the
split kernels: fp32 to fp32 round-off, 1e-5 (1e-4 against the Pallas
kernel, whose block-wise softmax sums in another order); bf16 arenas and
queries, where the port rounds ``p`` and the output to bf16, to 2e-2 (one
bf16 step of an output below 4, plus the rounding of ``p``); the JAX
functions take the bf16 values as fp32, since JAX's CPU backend has no
bf16 x bf16 -> fp32 product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.ops import attention as jattn
from rag_llm_k8s_tpu_torch.ops import _build
from rag_llm_k8s_tpu_torch.ops import attention as tattn
# the q8 decode splits' heads and the paged cases the other paged tests build
from test_torch_paged import paged_case
from test_torch_q8_decode_split import HEADS
from test_torch_q8_split import ATOL, H100_SMS, PAGED_PALLAS_ATOL, _close, _out, _t

TILE = tattn.DECODE_TILE_KEYS
DTYPES = ["float32", "bfloat16"]
SPLIT_KEYS = [16, 32, 48]

# the continuous engine's bf16 decode batch (chip_smoke.py phase_paged_decode)
MAIN_B, MAIN_K, MAIN_BS, MAIN_MB = 8, 8, 16, 272
MAIN_KV_LEN = [4351, 3100, 1800, 600, 17, 16, 1, 0]
MAIN = tattn.decode_launch_plan(MAIN_B, MAIN_K, MAIN_MB * MAIN_BS, H100_SMS)


def _inputs(rng, kv_len, L, H, K, bs, hd, MB, dtype):
    """Arenas, tables and a query batch, as torch tensors in ``dtype`` (the
    tables and frontiers int32) and as the JAX functions' fp32 arrays."""
    ka, va, tables = paged_case(rng, kv_len, L, K, bs, hd, MB)
    q = rng.standard_normal((len(kv_len), 1, H, hd)).astype(np.float32)
    dt = getattr(torch, dtype)
    qt, kt, vt = (_t(x).to(dt) for x in (q, ka, va))
    ints = (_t(tables), _t(kv_len))
    jx = tuple(jnp.asarray(x.float().numpy()) for x in (qt, kt, vt)) + tuple(map(jnp.asarray, (tables, kv_len)))
    return (qt, kt, vt) + ints, jx


class TestMainPathPlan:
    def test_plan_is_pinned(self):
        assert MAIN == dict(split_keys=128, n_splits=34, blocks=2176)

    def test_splits_are_whole_tiles_under_the_cap_that_cover_the_capacity(self):
        T = MAIN_MB * MAIN_BS
        assert MAIN["split_keys"] % TILE == 0
        assert MAIN["split_keys"] <= tattn.DECODE_SPLIT_TILES * TILE
        assert MAIN["n_splits"] * MAIN["split_keys"] >= T > (MAIN["n_splits"] - 1) * MAIN["split_keys"]
        assert MAIN["blocks"] == MAIN_B * MAIN_K * MAIN["n_splits"] >= 2 * H100_SMS

    def test_the_plan_reads_the_capacity_and_serves_every_frontier(self):
        """The plan is a function of (B, K, MB * bs): reading kv_len would
        sync with the host. Every frontier up to the capacity is covered by
        at most n_splits whole-tile splits; at the main-path frontiers 656
        warps read keys (and one more per kv head writes the empty row's
        zeros)."""
        T = MAIN_MB * MAIN_BS
        for n in range(0, T + 1, 37):
            bounds = tattn.split_bounds(0, n, MAIN["split_keys"], TILE)
            assert len(bounds) <= MAIN["n_splits"]
            if n:
                assert bounds[0][0] == 0 and bounds[-1][1] == n
                assert all(b0 == a1 and a1 % TILE == 0 for (_, b0), (a1, _) in zip(bounds, bounds[1:]))
        live = sum(len(tattn.split_bounds(0, n, MAIN["split_keys"], TILE)) for n in MAIN_KV_LEN)
        assert live * MAIN_K == 656


class TestPagedDecodeSplits:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("H,K,hd", HEADS)
    @pytest.mark.parametrize("bs", [16, 32])
    @pytest.mark.parametrize("split_keys", SPLIT_KEYS)
    def test_split_then_merge_matches_plain_pallas_and_oracle(self, H, K, hd, bs, split_keys, dtype):
        rng = np.random.default_rng(71 + H + K + hd + bs + split_keys + len(dtype))
        L, layer = 2, 1
        MB = 160 // bs
        # the decode batch scaled down: a long row ending mid-tile and
        # mid-split, a row one key into its second block, one key, a whole
        # block, a row ending mid-tile in its first block, the full table
        # and a bystander
        kv_len = np.array([150, bs + 1, 1, bs, 9, MB * bs, 0], np.int32)
        args_t, args_j = _inputs(rng, kv_len, L, H, K, bs, hd, MB, dtype)
        got = tattn.paged_decode_attention_split_xla(*args_t, layer, split_keys)
        assert got.dtype == args_t[0].dtype and torch.isfinite(got).all()
        got = _out(got)
        _close(got, _out(tattn.paged_decode_attention_xla(*args_t, layer)), ATOL[dtype])
        _close(got, _out(jattn.paged_decode_attention(*args_j, jnp.int32(layer), interpret=True)),
               PAGED_PALLAS_ATOL[dtype])
        _close(got, _out(jattn.paged_decode_attention_xla(*args_j, jnp.int32(layer))), ATOL[dtype])
        assert not np.abs(got[-1]).max()  # the bystander sees no key: zeros

    def test_one_split_is_the_unsplit_plain_version(self):
        rng = np.random.default_rng(7)
        kv_len = np.array([70, 16, 0, 33], np.int32)
        args_t, _ = _inputs(rng, kv_len, 1, 8, 2, 16, 32, 5, "float32")
        _close(tattn.paged_decode_attention_split_xla(*args_t, 0, 5 * 16),
               tattn.paged_decode_attention_xla(*args_t, 0), 1e-5)

    def test_the_table_decides_which_blocks_a_row_reads(self):
        """Swapping two table entries of a row moves its output once the
        frontier falls inside one of them (the split version follows the
        table block by block)."""
        rng = np.random.default_rng(11)
        bs, MB = 16, 4
        kv_len = np.array([64], np.int32)
        (q, ka, va, tables, _), _ = _inputs(rng, kv_len, 1, 4, 1, bs, 32, MB, "float32")
        swapped = tables.clone()
        swapped[0, [1, 3]] = swapped[0, [3, 1]]

        def run(tab, n):
            return tattn.paged_decode_attention_split_xla(
                q, ka, va, tab, torch.tensor([n], dtype=torch.int32), 0, 32)

        # over the whole table the order of blocks does not matter; over a
        # frontier inside block 3 it does
        _close(run(swapped, 64), run(tables, 64), 1e-5)
        assert (run(swapped, 50) - run(tables, 50)).abs().max() > 1e-2

    def test_main_path_plan_on_a_scaled_batch(self):
        """The main path's plan (128-key splits) over frontiers of the
        capacity, a permuted table and NaN outside the live blocks: the split
        version equals the unsplit one."""
        rng = np.random.default_rng(13)
        bs, MB = 16, 20
        kv_len = np.array([MB * bs, 300, 129, 128, 127, 1, 0], np.int32)
        args_t, _ = _inputs(rng, kv_len, 1, 8, 2, bs, 32, MB, "float32")
        _close(tattn.paged_decode_attention_split_xla(*args_t, 0, MAIN["split_keys"]),
               tattn.paged_decode_attention_xla(*args_t, 0), 1e-5)

    def test_wrapper_takes_the_plain_version_on_cpu_without_a_launch(self):
        rng = np.random.default_rng(3)
        kv_len = np.array([5, 33, 0], np.int32)
        args_t, _ = _inputs(rng, kv_len, 2, 4, 2, 16, 16, 4, "float32")
        before = dict(_build.LAUNCHES)
        got = tattn.paged_decode_attention(*args_t, 1)
        assert torch.equal(got, tattn.paged_decode_attention_xla(*args_t, 1))
        assert _build.LAUNCHES == before
