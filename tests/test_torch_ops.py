"""The port's plain kNN and attention against the JAX package's Pallas kernels
(interpret mode) and XLA oracles, on the same numpy inputs.

fp32 throughout: the point is the algorithm (masking, windows, GQA mapping,
offset causality, tie-breaks), so the tolerance is fp32 round-off, 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.ops import attention as jattn
from rag_llm_k8s_tpu.ops import knn as jknn
from rag_llm_k8s_tpu_torch.ops import attention as tattn
from rag_llm_k8s_tpu_torch.ops import knn as tknn

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# (H, K, hd): GQA G=4 and G=1, hd 64 and 128
HEADS = [(4, 1, 64), (4, 4, 128), (8, 2, 64)]


class TestFlashAttention:
    @pytest.mark.parametrize("H,K,hd", HEADS)
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_pallas_and_oracle(self, H, K, hd, causal):
        rng = np.random.default_rng(H * 100 + hd + causal)
        B, S = 3, 64
        q, k, v = _rand(rng, B, S, H, hd), _rand(rng, B, S, K, hd), _rand(rng, B, S, K, hd)
        # left padding (row 1), a short valid frontier (row 2) and, for the
        # bidirectional case, a row with an empty window (row 0 of kv_len 0)
        kv_start = np.array([0, 11, 3], np.int32)
        kv_len = np.array([S, S, 40], np.int32) if causal else np.array([0, S, 40], np.int32)
        got = tattn.attention_xla(_t(q), _t(k), _t(v), _t(kv_start), _t(kv_len), causal).numpy()
        pallas = jattn.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_start),
            jnp.asarray(kv_len), causal=causal, bq=32, bk=32, interpret=True,
        )
        oracle = jattn.attention_xla(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_start),
            jnp.asarray(kv_len), causal=causal,
        )
        _close(got, pallas)
        _close(got, oracle)
        # fully masked query rows write zeros (left-pad rows of a causal
        # prefill; every row of an empty window)
        if causal:
            assert np.all(got[1, :11] == 0)
        else:
            assert np.all(got[0] == 0)

    def test_wrapper_takes_plain_version_on_cpu(self):
        rng = np.random.default_rng(0)
        q, k, v = _rand(rng, 1, 16, 4, 64), _rand(rng, 1, 16, 2, 64), _rand(rng, 1, 16, 2, 64)
        ks, kl = torch.tensor([2]), torch.tensor([16])
        want = tattn.attention_xla(_t(q), _t(k), _t(v), ks, kl, True)
        got = tattn.flash_attention(_t(q), _t(k), _t(v), ks, kl, causal=True)
        assert torch.equal(got, want)


def _cache(rng, L, B, K, T, hd):
    return _rand(rng, L, B, K, T, hd), _rand(rng, L, B, K, T, hd)


class TestDecodeAttention:
    @pytest.mark.parametrize("H,K,hd", HEADS)
    def test_matches_pallas_and_oracle(self, H, K, hd):
        rng = np.random.default_rng(7 + H + hd)
        L, B, T = 3, 3, 128
        kc, vc = _cache(rng, L, B, K, T, hd)
        q = _rand(rng, B, 1, H, hd)
        kv_start = np.array([0, 5, 40], np.int32)
        kv_len = np.array([37, 100, 40], np.int32)  # row 2: empty window
        layer = 1
        got = tattn.decode_attention_xla(
            _t(q), _t(kc), _t(vc), _t(kv_start), _t(kv_len), layer
        ).numpy()
        args = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kv_start),
                jnp.asarray(kv_len), jnp.int32(layer))
        _close(got, jattn.decode_attention(*args, bk=64, interpret=True))
        _close(got, jattn.decode_attention_xla(*args))
        assert np.all(got[2] == 0)


class TestChunkAttention:
    @pytest.mark.parametrize("H,K,hd", HEADS)
    @pytest.mark.parametrize("S,wi", [(16, 32), (1, 50), (32, 64)])
    def test_matches_pallas_and_oracle(self, H, K, hd, S, wi):
        rng = np.random.default_rng(11 + H + hd + S)
        L, B, T = 2, 2, 128
        kc, vc = _cache(rng, L, B, K, T, hd)
        q = _rand(rng, B, S, H, hd)
        kv_start = np.array([0, 10], np.int32)
        kv_len = np.full((B,), wi + S, np.int32)
        layer = 1
        got = tattn.chunk_attention_xla(
            _t(q), _t(kc), _t(vc), _t(kv_start), _t(kv_len), layer, wi
        ).numpy()
        args = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kv_start),
                jnp.asarray(kv_len), jnp.int32(layer), jnp.int32(wi))
        _close(got, jattn.chunk_prefill_attention(*args, bq=min(S, 16), bk=64, interpret=True))
        _close(got, jattn.chunk_attention_xla(*args))


class TestKnn:
    def _data(self, rng, Q, n_pad, n_valid, D):
        q = _rand(rng, Q, D)
        emb = np.zeros((n_pad, D), np.float32)
        emb[:n_valid] = _rand(rng, n_valid, D)
        norms = np.full((1, n_pad), jknn.BIG, np.float32)
        norms[0, :n_valid] = (emb[:n_valid] ** 2).sum(1)
        return q, emb, norms

    @pytest.mark.parametrize("Q,n_valid", [(1, 300), (3, 512), (8, 7)])
    def test_matches_pallas_and_oracle(self, Q, n_valid):
        rng = np.random.default_rng(Q * 1000 + n_valid)
        q, emb, norms = self._data(rng, Q, 512, n_valid, 32)
        k = 5
        gv, gi = tknn.knn_topk_xla(_t(q), _t(emb), _t(norms), k=k)
        pv, pi = jknn.knn_topk_pallas(
            jnp.asarray(q), jnp.asarray(emb), jnp.asarray(norms), k=k, block_n=256,
            interpret=True,
        )
        xv, xi = jknn.knn_topk_xla(jnp.asarray(q), jnp.asarray(emb), jnp.asarray(norms), k=k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(pi))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(xi))
        np.testing.assert_allclose(gv.numpy(), np.asarray(pv), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gv.numpy(), np.asarray(xv), rtol=1e-5, atol=1e-5)
        # the wrapper takes the plain version for CPU tensors
        wv, wi = tknn.knn_topk(_t(q), _t(emb), _t(norms), k=k)
        assert torch.equal(wi, gi) and torch.equal(wv, gv)

    def test_duplicate_vectors_tie_to_lowest_row(self):
        # small-integer vectors: every dot product is exact, so duplicated
        # rows tie bit-for-bit and only the tie-break orders them
        rng = np.random.default_rng(5)
        D, n_valid = 16, 40
        base = rng.integers(-2, 3, size=(10, D)).astype(np.float32)
        emb = np.zeros((512, D), np.float32)
        emb[:n_valid] = base[rng.integers(0, 10, size=n_valid)]
        norms = np.full((1, 512), jknn.BIG, np.float32)
        norms[0, :n_valid] = (emb[:n_valid] ** 2).sum(1)
        q = base[:2].copy()
        gv, gi = tknn.knn_topk_xla(_t(q), _t(emb), _t(norms), k=5)
        pv, pi = jknn.knn_topk_pallas(
            jnp.asarray(q), jnp.asarray(emb), jnp.asarray(norms), k=5, block_n=256,
            interpret=True,
        )
        np.testing.assert_array_equal(gi.numpy(), np.asarray(pi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(pv))
        for row in range(2):
            dup = np.nonzero((emb[:n_valid] == q[row]).all(1))[0]
            want = dup[:5]
            np.testing.assert_array_equal(gi.numpy()[row, : len(want)], want)

    def test_fewer_rows_than_k_report_fill_entries(self):
        rng = np.random.default_rng(9)
        q, emb, norms = self._data(rng, 2, 512, 3, 8)
        gv, gi = tknn.knn_topk_xla(_t(q), _t(emb), _t(norms), k=5)
        pv, pi = jknn.knn_topk_pallas(
            jnp.asarray(q), jnp.asarray(emb), jnp.asarray(norms), k=5, block_n=256,
            interpret=True,
        )
        # real rows agree; past them the Pallas kernel repeats an id once the
        # running list is all BIG, the port reports the (BIG, -1) fill entries
        # (callers ask for k <= ntotal, so neither reaches a result)
        np.testing.assert_array_equal(gi.numpy()[:, :3], np.asarray(pi)[:, :3])
        assert (gi.numpy()[:, 3:] == -1).all()
        assert (gv.numpy()[:, 3:] == np.float32(jknn.BIG)).all()
