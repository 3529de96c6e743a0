"""The port's vector-store persistence against the JAX package's: the same
on-disk format (JSON metadata at ``path``, the vectors at
``path.vectors.npy`` through the C++ codec or as ``.npy``), so a snapshot
saved by either package loads in the other with the same vectors, metadata
and search results."""

import json

import numpy as np
import pytest

from rag_llm_k8s_tpu.index import store as jstore_mod
from rag_llm_k8s_tpu.index.store import VectorStore as JStore
from rag_llm_k8s_tpu_torch.index import store as store_mod
from rag_llm_k8s_tpu_torch.index.store import VectorStore

DIM = 16


def _data(n=40, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    meta = [{"filename": f"doc{i // 4}.pdf", "chunk_id": i % 4, "text": f"chunk text {i}"} for i in range(n)]
    return vecs, meta


def _port(path=None, fingerprint="fp"):
    s = VectorStore(DIM, "cpu", path=path, fingerprint=fingerprint)
    vecs, meta = _data()
    s.add(list(vecs), meta)
    return s


def _hits(results):
    return [(r.metadata, round(r.distance, 5)) for r in results]


QUERIES = _data(5, seed=9)[0]


@pytest.mark.parametrize("native", [True, False], ids=["indexio", "npy"])
def test_save_load_round_trip(tmp_path, native, monkeypatch):
    if not native:  # no C++ toolchain: the npy path
        monkeypatch.setattr(store_mod, "_indexio", lambda: None)
    path = str(tmp_path / "index")
    s = _port(path)
    s.save()
    with open(path) as f:
        assert json.load(f)["vector_format"] == ("indexio" if native else "npy")
    with open(path + ".vectors.npy", "rb") as f:
        assert (f.read(8) == b"TPURIDX1") == native
    got = VectorStore.load(path, dim=DIM, device="cpu")
    np.testing.assert_array_equal(got._vectors, s._vectors)
    assert got._metadata == s._metadata and got._hashes == s._hashes
    assert (got.ntotal, got.generation, got.fingerprint, got.path) == (s.ntotal, s.generation, "fp", path)
    for q in QUERIES:
        assert _hits(got.search(q, k=5)) == _hits(s.search(q, k=5))
    # dedup survives the reload: re-adding the same chunks adds nothing
    vecs, meta = _data()
    assert got.add(list(vecs), meta) == 0


def test_open_or_create(tmp_path):
    path = str(tmp_path / "sub" / "index")
    fresh = VectorStore.open_or_create(path, dim=DIM, fingerprint="a", device="cpu")
    assert fresh.ntotal == 0 and fresh.fingerprint == "a" and fresh.path == path
    vecs, meta = _data()
    fresh.add(list(vecs), meta)
    fresh.save()
    again = VectorStore.open_or_create(path, dim=DIM, fingerprint="a", device="cpu")
    assert again.ntotal == len(meta)
    # another embedder: rebuilt empty, under the new fingerprint
    other = VectorStore.open_or_create(path, dim=DIM, fingerprint="b", device="cpu")
    assert other.ntotal == 0 and other.fingerprint == "b"
    # no fingerprint asked for: whatever is there loads
    assert VectorStore.open_or_create(path, dim=DIM, device="cpu").ntotal == len(meta)
    with pytest.raises(ValueError, match="index dim"):
        VectorStore.open_or_create(path, dim=DIM + 1, device="cpu")


@pytest.mark.parametrize("native", [True, False], ids=["indexio", "npy"])
def test_a_jax_snapshot_loads_in_the_port(tmp_path, native, monkeypatch):
    if not native:
        monkeypatch.setattr(jstore_mod, "_indexio", lambda: None)
    path = str(tmp_path / "index")
    js = JStore(DIM, path=path, fingerprint="fp")
    vecs, meta = _data()
    js.add(list(vecs), meta)
    js.save()
    got = VectorStore.load(path, dim=DIM, device="cpu")
    np.testing.assert_array_equal(got._vectors, js._vectors)
    assert got._metadata == js._metadata and got.fingerprint == "fp" and got.generation == js.generation
    for q in QUERIES:
        assert _hits(got.search(q, k=5)) == _hits(js.search(q, k=5))


@pytest.mark.parametrize("native", [True, False], ids=["indexio", "npy"])
def test_a_port_snapshot_loads_in_jax(tmp_path, native, monkeypatch):
    if not native:
        monkeypatch.setattr(store_mod, "_indexio", lambda: None)
    path = str(tmp_path / "index")
    s = _port(path)
    s.save()
    js = JStore.load(path, dim=DIM)
    np.testing.assert_array_equal(js._vectors, s._vectors)
    assert js._metadata == s._metadata and js.fingerprint == "fp" and js.generation == s.generation
    for q in QUERIES:
        assert _hits(js.search(q, k=5)) == _hits(s.search(q, k=5))


def test_a_corrupt_payload_raises(tmp_path):
    path = str(tmp_path / "index")
    _port(path).save()
    with open(path + ".vectors.npy", "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(ValueError, match="CRC"):
        VectorStore.load(path, dim=DIM, device="cpu")


def test_a_save_without_a_path_raises():
    with pytest.raises(ValueError, match="no path"):
        _port().save()


def test_the_codec_is_the_port_own_build():
    lib = store_mod._indexio()
    assert lib is not None  # g++ builds native/indexio.cpp here
    from rag_llm_k8s_tpu_torch.native import build

    assert build.target("indexio").startswith(build.BUILD_DIR)
