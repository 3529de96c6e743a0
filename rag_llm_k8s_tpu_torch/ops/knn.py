"""Brute-force squared-L2 kNN: the CUDA kernel and its plain PyTorch versions.

Counterpart of ``rag_llm_k8s_tpu/ops/knn.py``. The store keeps embeddings as
a padded ``[N_pad, D]`` fp32 matrix whose padded rows carry ``BIG`` squared
norms, so they can never enter a top-k of ``k <= ntotal``. Distances are
true squared L2, ``|q|^2 + |e|^2 - 2 q.e``; ties go to the lowest row id, as
the Pallas kernel's first argmin does, and a slot with no real candidate
reports ``(BIG, -1)``.

The kernel (``csrc/knn.cu``) cuts the rows into contiguous parts, keeps a
list of the best per (query, part) and merges the lists per query in a
second pass; ``knn_launch_plan`` is its grid and ``knn_topk_split_xla`` the
plain version computed through the same parts. It is specialized for
bge-m3's width, 1024, and takes any other width that is a multiple of 4
with the width known at run time.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from rag_llm_k8s_tpu_torch.ops import _build

BIG = 3.4e38

KNN_MAX_K = 8  # length of the kernel's lists (csrc/knn.cu KMAX): k <= 8
KNN_QUERY_CHUNK = 8  # queries that share one pass over the store (QMAX)
KNN_PART_ALIGN = 16  # a part's rows are a whole number of the kernel's row batches

_VP = ctypes.c_void_p
_I = ctypes.c_int


def knn_topk_xla(
    queries: torch.Tensor,  # [Q, D] fp32
    embeddings: torch.Tensor,  # [N_pad, D] fp32
    sq_norms: torch.Tensor,  # [1, N_pad] fp32, padded entries BIG
    k: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version (named after the JAX oracle ``knn_topk_xla``): the full
    distance matrix, then a stable sort behind ``k`` ``(BIG, -1)`` fill
    entries — the lowest id wins a tie and a padded row never displaces a
    fill entry, as in the Pallas kernel."""
    qn = (queries * queries).sum(dim=1, keepdim=True)
    d = qn + sq_norms - 2.0 * (queries @ embeddings.T)
    Q = queries.shape[0]
    fill_v = torch.full((Q, k), BIG, dtype=d.dtype, device=d.device)
    cand_v = torch.cat([fill_v, d], dim=1)
    order = torch.sort(cand_v, dim=1, stable=True).indices[:, :k]
    vals = torch.gather(cand_v, 1, order)
    idx = torch.where(order < k, torch.full_like(order, -1), order - k)
    return vals, idx.to(torch.int32)


def knn_launch_plan(Q: int, N: int, n_sm: int) -> Dict:
    """Grid of the kernel: the rows cut into ``n_parts`` contiguous parts of
    ``rows_per_part`` (a multiple of ``KNN_PART_ALIGN``; two blocks per SM,
    the last part possibly short), the queries into chunks of at most
    ``KNN_QUERY_CHUNK`` (one pass over the store each), and one block per
    (part, chunk)."""
    per = -(-N // (2 * n_sm))
    rows_per_part = max(1, -(-per // KNN_PART_ALIGN)) * KNN_PART_ALIGN
    n_parts = -(-N // rows_per_part)
    chunks = tuple(min(KNN_QUERY_CHUNK, Q - q0) for q0 in range(0, Q, KNN_QUERY_CHUNK))
    return dict(rows_per_part=rows_per_part, n_parts=n_parts, query_chunks=chunks,
                blocks=n_parts * len(chunks))


def knn_part_lists(
    queries: torch.Tensor,
    embeddings: torch.Tensor,
    sq_norms: torch.Tensor,
    k: int,
    plan: Dict,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first pass of ``knn_topk_split_xla``: each part's top ``k`` per
    query (``knn_topk_xla`` over the part's rows, ids as row ids, fill
    entries ``(BIG, -1)``), ``[Q, n_parts, k]`` distances and ids."""
    rpp = plan["rows_per_part"]
    vals, ids = [], []
    for p in range(plan["n_parts"]):
        rows = slice(p * rpp, (p + 1) * rpp)
        v, i = knn_topk_xla(queries, embeddings[rows], sq_norms[:, rows], k=k)
        vals.append(v)
        ids.append(torch.where(i < 0, i, i + p * rpp))
    return torch.stack(vals, dim=1), torch.stack(ids, dim=1)


def knn_merge_lists(vals: torch.Tensor, ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second pass: the first ``k`` of the union of each query's lists
    ``[Q, n_lists, k']``, ordered by (distance, id)."""
    Q = vals.shape[0]
    v, i = vals.reshape(Q, -1), ids.reshape(Q, -1)
    by_id = torch.sort(i, dim=1, stable=True).indices
    v, i = torch.gather(v, 1, by_id), torch.gather(i, 1, by_id)
    order = torch.sort(v, dim=1, stable=True).indices[:, :k]
    return torch.gather(v, 1, order), torch.gather(i, 1, order)


def knn_topk_split_xla(
    queries: torch.Tensor,
    embeddings: torch.Tensor,
    sq_norms: torch.Tensor,
    k: int,
    plan: Dict,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``knn_topk_xla`` computed the way the kernel cuts it: a top ``k`` per
    (query, part of ``plan``), then the parts' lists merged per query."""
    return knn_merge_lists(*knn_part_lists(queries, embeddings, sq_norms, k, plan), k)


def knn_topk(
    queries: torch.Tensor,
    embeddings: torch.Tensor,
    sq_norms: torch.Tensor,
    k: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dists [Q, k] fp32, ids [Q, k] int32)``: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if queries.device.type == "cpu":
        return knn_topk_xla(queries, embeddings, sq_norms, k=k)
    _build.check_no_grad("knn_topk", queries, embeddings, sq_norms)
    Q, D = queries.shape
    N = embeddings.shape[0]
    for name, t in (("queries", queries), ("embeddings", embeddings), ("sq_norms", sq_norms)):
        if t.device != queries.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"knn_topk: {name} must be contiguous fp32 on {queries.device}")
    if queries.data_ptr() % 16 or embeddings.data_ptr() % 16:
        raise ValueError("knn_topk: queries and embeddings must be 16-byte aligned (float4 loads)")
    if embeddings.shape[1] != D or tuple(sq_norms.shape) != (1, N):
        raise ValueError(
            f"knn_topk: shapes q{tuple(queries.shape)} e{tuple(embeddings.shape)} "
            f"n{tuple(sq_norms.shape)} do not match"
        )
    if D % 4 or not 1 <= k <= KNN_MAX_K:
        raise ValueError(f"knn_topk: the kernel takes D % 4 == 0 and 1 <= k <= {KNN_MAX_K} (D={D}, k={k})")
    dev = queries.device
    plan = knn_launch_plan(Q, N, _build.sm_count(dev.index))
    part_v = torch.empty((Q, plan["n_parts"], KNN_MAX_K), dtype=torch.float32, device=dev)
    part_i = torch.empty((Q, plan["n_parts"], KNN_MAX_K), dtype=torch.int32, device=dev)
    vals = torch.empty((Q, k), dtype=torch.float32, device=dev)
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.knn_topk_f32(
        queries.data_ptr(), embeddings.data_ptr(), sq_norms.data_ptr(),
        part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        Q, N, D, k, plan["rows_per_part"], plan["n_parts"], torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, "knn_topk")
    _build.LAUNCHES["knn_topk"] += 1
    _build.KNN_LAUNCHES_BY_QUERIES[Q] = _build.KNN_LAUNCHES_BY_QUERIES.get(Q, 0) + 1
    return vals, idx


def _lib() -> ctypes.CDLL:
    return _build.load("knn", {
        "knn_topk_f32": ([_VP] * 7 + [_I] * 6 + [_VP], _I),
    })
