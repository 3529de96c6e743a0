"""The kNN kernel's plan and its plain two-pass version, on the CPU:
``knn_launch_plan`` (contiguous parts of the rows, chunks of at most 8
queries) pinned at the main-path shapes, and ``knn_topk_split_xla`` (a top k
per (query, part) with the tie rule, then the parts' lists merged) against
the JAX package's Pallas kernel (interpret mode), its XLA oracle and the
port's unsplit plain version, on the same numpy inputs.

Ids must be equal and distances within rtol = atol = 1e-5 (fp32 round-off,
as ``tests/test_torch_ops.py::TestKnn`` holds them). Padded rows carry
``BIG`` norms; with fewer real rows than k the port reports ``(BIG, -1)``
fill entries where the Pallas kernel repeats an id and the XLA oracle names
a padded row, so there only the real entries are compared. Duplicated
small-integer rows (exact dot products) straddle part boundaries: the
lowest id must win every tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.ops import knn as jknn
from rag_llm_k8s_tpu_torch.ops import _build
from rag_llm_k8s_tpu_torch.ops import knn as tknn

H100_SMS = 132
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _store(rng, Q, n_pad, n_valid, D):
    q = rng.standard_normal((Q, D)).astype(np.float32)
    emb = np.zeros((n_pad, D), np.float32)
    emb[:n_valid] = rng.standard_normal((n_valid, D)).astype(np.float32)
    norms = np.full((1, n_pad), jknn.BIG, np.float32)
    norms[0, :n_valid] = (emb[:n_valid] ** 2).sum(1)
    return q, emb, norms


def _jax(q, emb, norms, k):
    args = tuple(map(jnp.asarray, (q, emb, norms)))
    pv, pi = jknn.knn_topk_pallas(*args, k=k, block_n=256, interpret=True)
    xv, xi = jknn.knn_topk_xla(*args, k=k)
    return (np.asarray(pv), np.asarray(pi)), (np.asarray(xv), np.asarray(xi))


def _split(q, emb, norms, k):
    plan = tknn.knn_launch_plan(q.shape[0], emb.shape[0], H100_SMS)
    v, i = tknn.knn_topk_split_xla(_t(q), _t(emb), _t(norms), k, plan)
    return v.numpy(), i.numpy()


class TestPlan:
    @pytest.mark.parametrize("Q,chunks", [(1, (1,)), (8, (8,)), (9, (8, 1))])
    def test_main_path_plan_is_pinned(self, Q, chunks):
        plan = tknn.knn_launch_plan(Q, 65536, H100_SMS)
        assert plan == dict(rows_per_part=256, n_parts=256, query_chunks=chunks, blocks=256 * len(chunks))
        assert plan["blocks"] >= H100_SMS

    @pytest.mark.parametrize("Q", [1, 3, 8, 9, 17])
    @pytest.mark.parametrize("N", [512, 4096, 65536, 1000])
    def test_parts_cover_every_row_once(self, Q, N):
        plan = tknn.knn_launch_plan(Q, N, H100_SMS)
        rpp, n = plan["rows_per_part"], plan["n_parts"]
        assert rpp % tknn.KNN_PART_ALIGN == 0
        assert (n - 1) * rpp < N <= n * rpp  # no part empty, none past the rows
        covered = np.concatenate([np.arange(p * rpp, min(N, (p + 1) * rpp)) for p in range(n)])
        np.testing.assert_array_equal(covered, np.arange(N))
        assert sum(plan["query_chunks"]) == Q and max(plan["query_chunks"]) <= tknn.KNN_QUERY_CHUNK
        assert plan["blocks"] == n * len(plan["query_chunks"])

    def test_part_lists_hold_their_parts_rows(self):
        rng = np.random.default_rng(2)
        q, emb, norms = _store(rng, 3, 512, 500, 16)
        plan = tknn.knn_launch_plan(3, 512, H100_SMS)
        v, i = tknn.knn_part_lists(_t(q), _t(emb), _t(norms), 5, plan)
        assert tuple(i.shape) == (3, plan["n_parts"], 5)
        part = torch.arange(plan["n_parts"])[None, :, None] * plan["rows_per_part"]
        real = i >= 0
        assert ((i >= part) & (i < part + plan["rows_per_part"]))[real].all()
        assert (v[~real] == np.float32(tknn.BIG)).all()


class TestSplitKnn:
    @pytest.mark.parametrize("Q", [1, 3, 8, 9])
    @pytest.mark.parametrize("k", [1, 5, 8])
    @pytest.mark.parametrize("n_pad,n_valid", [(512, 300), (4096, 4000)])
    def test_matches_pallas_oracle_and_unsplit(self, Q, k, n_pad, n_valid):
        rng = np.random.default_rng(Q * 100 + k * 10 + n_pad)
        q, emb, norms = _store(rng, Q, n_pad, n_valid, 16)
        gv, gi = _split(q, emb, norms, k)
        uv, ui = tknn.knn_topk_xla(_t(q), _t(emb), _t(norms), k=k)
        (pv, pi), (xv, xi) = _jax(q, emb, norms, k)
        for wv, wi in ((uv.numpy(), ui.numpy()), (pv, pi), (xv, xi)):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gv, wv, **TOL)
        assert (gi < n_valid).all()  # a padded row never enters

    @pytest.mark.parametrize("Q", [1, 9])
    @pytest.mark.parametrize("k", [5, 8])
    def test_fewer_real_rows_than_k_report_fill_entries(self, Q, k):
        rng = np.random.default_rng(9 + Q + k)
        n_valid = 3
        q, emb, norms = _store(rng, Q, 512, n_valid, 8)
        gv, gi = _split(q, emb, norms, k)
        uv, ui = tknn.knn_topk_xla(_t(q), _t(emb), _t(norms), k=k)
        np.testing.assert_array_equal(gi, ui.numpy())
        np.testing.assert_array_equal(gv, uv.numpy())
        (pv, pi), (xv, xi) = _jax(q, emb, norms, k)
        for wv, wi in ((pv, pi), (xv, xi)):
            np.testing.assert_array_equal(gi[:, :n_valid], wi[:, :n_valid])
            np.testing.assert_allclose(gv[:, :n_valid], wv[:, :n_valid], **TOL)
        assert (gi[:, n_valid:] == -1).all() and (gv[:, n_valid:] == np.float32(tknn.BIG)).all()

    @pytest.mark.parametrize("k", [1, 5, 8])
    def test_ties_across_part_boundaries_go_to_the_lowest_id(self, k):
        """Small-integer rows make every dot product exact, so duplicates tie
        bit for bit: rows straddling part boundaries (16-row parts at this
        N) and a duplicate in the last real part must come out lowest id
        first, as from the Pallas kernel."""
        rng = np.random.default_rng(5)
        D, n_pad, n_valid = 16, 512, 500
        plan = tknn.knn_launch_plan(2, n_pad, H100_SMS)
        rpp = plan["rows_per_part"]
        base = rng.integers(-2, 3, size=(10, D)).astype(np.float32)
        emb = np.zeros((n_pad, D), np.float32)
        emb[:n_valid] = base[rng.integers(2, 10, size=n_valid)]  # no row equals base 0 or 1
        dups = {0: [rpp - 1, rpp, 5 * rpp - 1, 5 * rpp, n_valid - 1], 1: [2 * rpp - 1, 2 * rpp, 3 * rpp]}
        for j, rows in dups.items():
            emb[rows] = base[j]
        norms = np.full((1, n_pad), jknn.BIG, np.float32)
        norms[0, :n_valid] = (emb[:n_valid] ** 2).sum(1)
        q = base[:2].copy()
        gv, gi = _split(q, emb, norms, k)
        (pv, pi), _ = _jax(q, emb, norms, k)
        np.testing.assert_array_equal(gi, pi)
        np.testing.assert_array_equal(gv, pv)
        for j, rows in dups.items():
            n = min(k, len(rows))
            np.testing.assert_array_equal(gi[j, :n], rows[:n])
            assert (gv[j, :n] == 0).all()

    def test_wrapper_takes_the_plain_version_on_cpu_without_a_launch(self):
        rng = np.random.default_rng(4)
        q, emb, norms = _store(rng, 2, 512, 100, 16)
        before = dict(_build.LAUNCHES)
        gv, gi = tknn.knn_topk(_t(q), _t(emb), _t(norms), k=5)
        wv, wi = tknn.knn_topk_xla(_t(q), _t(emb), _t(norms), k=5)
        assert torch.equal(gi, wi) and torch.equal(gv, wv)
        assert _build.LAUNCHES == before
