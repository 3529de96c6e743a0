"""Exact-kNN vector store with a device-resident snapshot and an atomic
on-disk snapshot, counterpart of ``rag_llm_k8s_tpu/index/store.py``.

- ``device_snapshot()``: a padded ``[N_pad, D]`` fp32 matrix on the device,
  ``N_pad`` a power of two >= 512, plus ``[1, N_pad]`` squared norms whose
  padded entries are ``BIG``, so padded rows never enter a top-k with
  ``k <= ntotal``.
- ``token_snapshot()``: the chunk-token sidecar ``(tokens [cap, Lc], lens
  [cap])`` row-aligned with the vectors, the gather source of device-side
  prompt assembly. Rows tokenize lazily through the attached token source.

- ``save()`` / ``load()`` / ``open_or_create()``: the JAX package's on-disk
  format, so a snapshot saved by either package loads in the other. The
  vectors go to ``<path>.vectors.npy`` through the C++ codec
  (``native/indexio.cpp``: CRC32-checked, fsynced, renamed into place), or
  through a temporary ``.npy`` and a rename when the codec cannot be built;
  the JSON metadata at ``<path>`` is written last and names the payload's
  format. ``open_or_create`` rebuilds an empty store when the persisted
  embedder fingerprint differs from the caller's.

Mutation takes one lock; a snapshot is rebuilt on the next read after any
add, and a pair already handed out is never modified.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import os
import tempfile
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rag_llm_k8s_tpu_torch.core.device import DeviceLike, resolve_device
from rag_llm_k8s_tpu_torch.ops.knn import BIG, knn_topk
from rag_llm_k8s_tpu_torch.resilience import faults
from rag_llm_k8s_tpu_torch.utils.buckets import next_pow2

logger = logging.getLogger(__name__)

_FORMAT_VERSION = 1
_INDEXIO_MAGIC = b"TPURIDX1"


def _indexio():
    """The C++ snapshot codec (``native/indexio.cpp``); None ⇒ the npy path."""
    from rag_llm_k8s_tpu_torch.native.build import load_library

    lib = load_library("indexio")
    if lib is None:
        return None
    lib.indexio_write.restype = ctypes.c_int32
    lib.indexio_write.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.indexio_read_header.restype = ctypes.c_int32
    lib.indexio_read_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.indexio_read.restype = ctypes.c_int32
    lib.indexio_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    return lib


def _save_vectors(vec_path: str, vectors: np.ndarray, generation: int) -> str:
    """Persist the fp32 payload: the codec when it builds (checksummed,
    fsynced, atomic), a temporary ``.npy`` and a rename otherwise. Returns
    the format written (``"indexio"`` or ``"npy"``)."""
    vectors = np.ascontiguousarray(vectors, np.float32)
    lib = _indexio()
    if lib is not None:
        rc = lib.indexio_write(
            vec_path.encode(), vectors.shape[1] if vectors.ndim == 2 else 0,
            vectors.shape[0], generation,
            vectors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc == 0:
            return "indexio"
        logger.warning("native index write failed (rc=%d); falling back to npy", rc)
    dir_ = os.path.dirname(vec_path) or "."
    fd, tmp = tempfile.mkstemp(dir=dir_, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.save(f, vectors)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, vec_path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return "npy"


def _load_vectors(vec_path: str, dim: int) -> np.ndarray:
    """Load the payload by its magic: the codec's (CRC-checked; corruption
    raises), ``.npy`` otherwise."""
    with open(vec_path, "rb") as f:
        magic = f.read(8)
    if magic != _INDEXIO_MAGIC:
        return np.load(vec_path)
    lib = _indexio()
    if lib is None:
        raise RuntimeError(
            f"{vec_path} is a native-codec snapshot but no C++ toolchain is available to read it"
        )
    hdr = (ctypes.c_int64 * 4)()
    rc = lib.indexio_read_header(vec_path.encode(), hdr)
    if rc != 0:
        raise ValueError(f"index payload header corrupt ({vec_path}, rc={rc})")
    f_dim, count, payload = hdr[0], hdr[1], hdr[3]
    if f_dim != dim:
        raise ValueError(f"index payload dim {f_dim} != expected {dim}")
    # the CRC covers the payload, not the header: an inconsistent header must
    # fail here, before it sizes the read
    if count < 0 or payload != count * dim * 4:
        raise ValueError(
            f"index payload header inconsistent ({vec_path}: count={count}, "
            f"dim={dim}, payload_bytes={payload}) — snapshot is corrupt"
        )
    out = np.empty((count, dim), np.float32)
    rc = lib.indexio_read(vec_path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), payload)
    if rc != 0:
        raise ValueError(f"index payload failed CRC/read ({vec_path}, rc={rc}) — snapshot is corrupt")
    return out


@dataclass
class SearchResult:
    """One hit: metadata, squared-L2 distance, and the store row id."""

    metadata: Dict
    distance: float
    row: int = -1


def _content_hash(metadata: Dict) -> str:
    """Dedup key: document identity + chunk text."""
    h = hashlib.sha256()
    h.update(str(metadata.get("filename", "")).encode())
    h.update(str(metadata.get("chunk_id", "")).encode())
    h.update(str(metadata.get("text", "")).encode())
    return h.hexdigest()


def _pad_bucket(n: int, minimum: int = 512) -> int:
    return max(minimum, next_pow2(n))


class VectorStore:
    """Append-only exact-kNN store; thread-safe."""

    def __init__(self, dim: int, device: DeviceLike = None, path: Optional[str] = None,
                 fingerprint: str = ""):
        self.dim = dim
        self.device = resolve_device(device)
        self.path = path
        # identifies the embedder that produced the stored vectors
        self.fingerprint = fingerprint
        self._lock = threading.RLock()
        self._vectors = np.zeros((0, dim), np.float32)
        self._metadata: List[Dict] = []
        self._hashes: set = set()
        # each row's content hash, in row order (content_key)
        self._row_hashes: List[str] = []
        self.generation = 0
        self._dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._token_fn = None
        self._chunk_tokens: List[Optional[np.ndarray]] = []
        self._tok_dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._tok_build_lock = threading.Lock()

    def add(self, vectors: Sequence[np.ndarray], metadata: Sequence[Dict], dedup: bool = True) -> int:
        """Append vectors; content-hash duplicates are skipped. Returns how
        many were added."""
        if len(vectors) != len(metadata):
            raise ValueError("vectors and metadata length mismatch")
        with self._lock:
            fresh_v, fresh_m, fresh_h = [], [], []
            seen = set()
            for v, m in zip(vectors, metadata):
                v = np.asarray(v, np.float32).reshape(-1)
                if v.shape[0] != self.dim:
                    raise ValueError(f"vector dim {v.shape[0]} != index dim {self.dim}")
                h = _content_hash(m)
                if dedup and (h in self._hashes or h in seen):
                    continue
                seen.add(h)
                fresh_v.append(v)
                fresh_m.append(dict(m))
                fresh_h.append(h)
            if not fresh_v:
                return 0
            self._vectors = np.concatenate([self._vectors, np.stack(fresh_v)], axis=0)
            self._metadata.extend(fresh_m)
            self._hashes.update(fresh_h)
            self._row_hashes.extend(fresh_h)
            self._chunk_tokens.extend([None] * len(fresh_m))
            self.generation += 1
            self._dev = None
            self._tok_dev = None
        return len(fresh_v)

    def device_snapshot(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(emb [N_pad, D] fp32, sq_norms [1, N_pad])`` on the device."""
        with self._lock:
            if self._dev is None:
                n = len(self._metadata)
                n_pad = _pad_bucket(max(n, 1))
                emb = np.zeros((n_pad, self.dim), np.float32)
                emb[:n] = self._vectors
                norms = np.full((1, n_pad), BIG, np.float32)
                norms[0, :n] = (self._vectors**2).sum(axis=1)
                self._dev = (
                    torch.from_numpy(emb).to(self.device),
                    torch.from_numpy(norms).to(self.device),
                )
            return self._dev

    def attach_token_source(self, fn) -> None:
        """Set the chunk → LLM-token-ids callback behind the sidecar; a
        different source (by ``cache_key``) drops the cached rows."""
        with self._lock:
            old = self._token_fn
            if old is not None and getattr(old, "cache_key", old) != getattr(fn, "cache_key", fn):
                self._chunk_tokens = [None] * len(self._metadata)
                self._tok_dev = None
            self._token_fn = fn

    def token_snapshot(self, blocking: bool = True):
        """``(tokens [cap, Lc] int32, lens [cap] int32)`` on the device, with
        ``cap`` a power of two >= 512 and ``Lc`` one >= 128. With
        ``blocking=False`` returns None instead of waiting on another
        thread's build."""
        if not self._tok_build_lock.acquire(blocking=blocking):
            return None
        try:
            with self._lock:
                if self._tok_dev is not None:
                    return self._tok_dev
                fn = self._token_fn
                if fn is None:
                    raise RuntimeError("no token source attached (attach_token_source)")
                metas = list(self._metadata)
                rows = list(self._chunk_tokens)
            for i, r in enumerate(rows):
                if r is None:
                    rows[i] = np.asarray(fn(metas[i]), np.int32)
            n = len(rows)
            cap = _pad_bucket(max(n, 1))
            lc = _pad_bucket(max((r.shape[0] for r in rows), default=1), minimum=128)
            toks = np.zeros((cap, lc), np.int32)
            lens = np.zeros((cap,), np.int32)
            for i, r in enumerate(rows):
                toks[i, : r.shape[0]] = r
                lens[i] = r.shape[0]
            built = (torch.from_numpy(toks).to(self.device), torch.from_numpy(lens).to(self.device))
            with self._lock:
                if self._token_fn is not fn or len(self._metadata) != n:
                    return built  # changed mid-build: serve it, cache nothing
                self._chunk_tokens = rows
                self._tok_dev = built
            return built
        finally:
            self._tok_build_lock.release()

    def content_key(self, row: int) -> Optional[str]:
        """The stable identity of one row's chunk: its content hash (document
        and chunk text, never row order or embedding), so prefix-cache keys
        survive a restart. None when ``row`` is out of range."""
        with self._lock:
            if 0 <= row < len(self._row_hashes):
                return self._row_hashes[row]
            return None

    def cached_token_row(self, row: int) -> Optional[np.ndarray]:
        with self._lock:
            if 0 <= row < len(self._chunk_tokens):
                return self._chunk_tokens[row]
            return None

    def token_lengths(self, idxs) -> List[int]:
        """Cached token-row lengths for the given row ids (0 when not yet
        tokenized)."""
        with self._lock:
            out = []
            for i in idxs:
                i = int(i)
                row = self._chunk_tokens[i] if 0 <= i < len(self._chunk_tokens) else None
                out.append(0 if row is None else int(row.shape[0]))
            return out

    def search(self, query: np.ndarray, k: int = 5) -> List[SearchResult]:
        """Exact kNN by squared L2."""
        n = self.ntotal
        if n == 0:
            return []
        emb, norms = self.device_snapshot()
        q = torch.from_numpy(np.asarray(query, np.float32).reshape(1, self.dim)).to(self.device)
        dists, idx = knn_topk(q, emb, norms, k=min(k, n))
        return self.results_at(idx[0].cpu().numpy(), dists[0].cpu().numpy())

    def results_at(self, idx, dists) -> List[SearchResult]:
        """SearchResults for externally computed (ids, distances) (the
        ``store_lookup`` fault site comes first)."""
        faults.maybe_fail("store_lookup")
        with self._lock:
            return [
                SearchResult(metadata=self._metadata[int(i)], distance=float(d), row=int(i))
                for d, i in zip(dists, idx)
            ]

    @property
    def ntotal(self) -> int:
        return len(self._metadata)

    def info(self) -> Dict:
        with self._lock:
            return {
                "total_vectors": len(self._metadata),
                "dimension": self.dim,
                "total_chunks": len(self._metadata),
                "sample_chunks": [dict(m) for m in self._metadata[:5]],
                "generation": self.generation,
            }

    # -- persistence ------------------------------------------------------
    def save(self, path: Optional[str] = None) -> str:
        """Write the snapshot: the vectors to ``<path>.vectors.npy`` (the
        codec, or ``.npy`` when it cannot be built), then the metadata JSON
        to ``path``, each through a temporary file and a rename."""
        path = path or self.path
        if path is None:
            raise ValueError("no path configured")
        with self._lock:
            meta = {
                "format_version": _FORMAT_VERSION,
                "dim": self.dim,
                "count": len(self._metadata),
                "generation": self.generation,
                "fingerprint": self.fingerprint,
                "metadata": self._metadata,
                "hashes": sorted(self._hashes),
            }
            dir_ = os.path.dirname(path) or "."
            os.makedirs(dir_, exist_ok=True)
            meta["vector_format"] = _save_vectors(path + ".vectors.npy", self._vectors, self.generation)
            fd, tmp = tempfile.mkstemp(dir=dir_, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(meta, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
            dfd = os.open(dir_, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        return path

    @classmethod
    def load(cls, path: str, dim: Optional[int] = None, device: DeviceLike = None) -> "VectorStore":
        with open(path) as f:
            meta = json.load(f)
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ValueError(f"unsupported index format: {meta.get('format_version')}")
        store = cls(meta["dim"], device, path=path)
        vectors = _load_vectors(path + ".vectors.npy", meta["dim"])
        count = meta["count"]
        if vectors.shape[0] < count:
            raise ValueError(f"index corrupt: metadata says {count} vectors, payload has {vectors.shape[0]}")
        store._vectors = np.asarray(vectors[:count], np.float32)
        store._metadata = list(meta["metadata"])
        # token rows are not persisted: they re-derive from the metadata text
        store._chunk_tokens = [None] * len(store._metadata)
        store._hashes = set(meta.get("hashes", []))
        store._row_hashes = [_content_hash(m) for m in store._metadata]
        store.generation = meta.get("generation", 0)
        store.fingerprint = meta.get("fingerprint", "")
        if dim is not None and store.dim != dim:
            raise ValueError(f"index dim {store.dim} != expected {dim}")
        return store

    @classmethod
    def open_or_create(cls, path: str, dim: int, fingerprint: Optional[str] = None,
                       device: DeviceLike = None) -> "VectorStore":
        """Load the snapshot at ``path`` if there is one, else an empty store
        (written on its first save). A snapshot whose embedder fingerprint
        differs from ``fingerprint`` is discarded: its vectors came from
        another encoder."""
        if os.path.exists(path):
            store = cls.load(path, dim=dim, device=device)
            if fingerprint is not None and store.fingerprint != fingerprint:
                logger.warning(
                    "index at %s was built by a different embedder "
                    "(fingerprint %r != %r); rebuilding fresh",
                    path, store.fingerprint, fingerprint,
                )
                return cls(dim, device, path=path, fingerprint=fingerprint)
            return store
        return cls(dim, device, path=path, fingerprint=fingerprint or "")
