"""Brute-force squared-L2 kNN: the CUDA kernel and its plain PyTorch version.

Counterpart of ``rag_llm_k8s_tpu/ops/knn.py``. The store keeps embeddings as
a padded ``[N_pad, D]`` fp32 matrix whose padded rows carry ``BIG`` squared
norms, so they can never enter a top-k of ``k <= ntotal``. Distances are
true squared L2, ``|q|^2 + |e|^2 - 2 q.e``; ties go to the lowest row id, as
the Pallas kernel's first argmin does, and a slot with no real candidate
reports ``(BIG, -1)``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from rag_llm_k8s_tpu_torch.ops import _build

BIG = 3.4e38

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
    Q, D = queries.shape
    N = embeddings.shape[0]
    for name, t in (("queries", queries), ("embeddings", embeddings), ("sq_norms", sq_norms)):
        if t.device != queries.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"knn_topk: {name} must be contiguous fp32 on {queries.device}")
    if embeddings.shape[1] != D or tuple(sq_norms.shape) != (1, N):
        raise ValueError(
            f"knn_topk: shapes q{tuple(queries.shape)} e{tuple(embeddings.shape)} "
            f"n{tuple(sq_norms.shape)} do not match"
        )
    if D % 4 or not 1 <= k <= 8:
        raise ValueError(f"knn_topk: the kernel takes D % 4 == 0 and 1 <= k <= 8 (D={D}, k={k})")
    lib = _lib()
    n_tiles = -(-N // lib.knn_tile_rows())
    dev = queries.device
    part_v = torch.empty((Q, n_tiles, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((Q, n_tiles, k), dtype=torch.int32, device=dev)
    vals = torch.empty((Q, k), dtype=torch.float32, device=dev)
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    rc = lib.knn_topk_f32(
        queries.data_ptr(), embeddings.data_ptr(), sq_norms.data_ptr(),
        part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        Q, N, D, k, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, "knn_topk")
    _build.LAUNCHES["knn_topk"] += 1
    return vals, idx


def _lib() -> ctypes.CDLL:
    return _build.load("knn", {
        "knn_topk_f32": ([_VP] * 7 + [_I] * 4 + [_VP], _I),
        "knn_tile_rows": ([], _I),
    })
