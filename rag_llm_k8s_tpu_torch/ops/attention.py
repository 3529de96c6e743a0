"""GQA attention for the Llama and bge-m3 forwards: five CUDA kernel
wrappers and their plain PyTorch versions.

Counterpart of ``rag_llm_k8s_tpu/ops/attention.py`` kernels 2-4, 7 and 9:

- ``flash_attention``: fresh ``[B, S, K, hd]`` K/V, causal or not, per-row
  key window ``[kv_start, kv_len)`` (Llama prefill; bge-m3 with
  ``causal=False``);
- ``decode_attention``: one query token over the stacked head-major cache
  ``[L, B, K, T, hd]`` read at ``layer`` (no per-layer copy);
- ``chunk_prefill_attention``: ``S`` queries written at ``write_index`` over
  the cache, offset causality ``t_k <= write_index + t`` (long-prompt chunks
  and the speculative verify);
- ``paged_decode_attention`` and ``paged_chunk_attention``: the same over
  the continuous engine's block-pool arena ``[L, N, K, bs, hd]``, where
  logical key ``t`` of row ``b`` sits in physical block
  ``block_tables[b, t // bs]``; rows are right-padded (window ``[0,
  kv_len)``) and the chunk kernel takes a per-row ``write_index``.

Query head ``h`` reads kv head ``h // G``; a query row with no visible key
yields zeros. The plain versions are named after the JAX oracles they match
(``attention_xla``, ``decode_attention_xla``, ``chunk_attention_xla``,
``paged_*_xla``) and compute in fp32 with ``p`` cast to the V dtype before
the PV product. Each wrapper takes its plain version only for CPU tensors; a
CUDA tensor goes to the kernel in ``csrc/attention.cu`` or
``csrc/paged_attention.cu``, or the wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from rag_llm_k8s_tpu_torch.ops import _build

NEG_INF = -1e30

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


def _softmax_pv(s: torch.Tensor, ok: torch.Tensor, v: torch.Tensor, spec: str) -> torch.Tensor:
    """Masked softmax over the last axis, rows with no valid key zeroed, then
    the PV product with ``p`` in the V dtype and fp32 accumulation."""
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(ok, p, torch.zeros_like(p))
    return torch.einsum(spec, p.to(v.dtype).float(), v.float())


def attention_xla(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Sk, K, hd]
    v: torch.Tensor,  # [B, Sk, K, hd]
    kv_start: Optional[torch.Tensor] = None,  # [B] int
    kv_len: Optional[torch.Tensor] = None,  # [B] int
    causal: bool = True,
) -> torch.Tensor:
    """Plain version of ``flash_attention`` (JAX oracle ``attention_xla``)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (hd**-0.5)
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    ok = torch.ones((B, Sq, Sk), dtype=torch.bool, device=q.device)
    if kv_start is not None:
        ok = ok & (k_pos[None, None, :] >= kv_start.to(q.device)[:, None, None])
    if kv_len is not None:
        ok = ok & (k_pos[None, None, :] < kv_len.to(q.device)[:, None, None])
    if causal:
        ok = ok & (k_pos[None, None, :] <= q_pos[None, :, None])
    o = _softmax_pv(s, ok[:, None, None], v, "bkgqs,bskd->bqkgd")
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention_xla(
    q: torch.Tensor,  # [B, 1, H, hd]
    k_cache: torch.Tensor,  # [L, B, K, T, hd]
    v_cache: torch.Tensor,
    kv_start: torch.Tensor,  # [B]
    kv_len: torch.Tensor,  # [B]
    layer: int,
) -> torch.Tensor:
    """Plain version of ``decode_attention`` (JAX oracle ``decode_attention_xla``)."""
    B, _, H, hd = q.shape
    K, T = k_cache.shape[2], k_cache.shape[3]
    G = H // K
    kc, vc = k_cache[layer], v_cache[layer]
    qg = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgd,bktd->bkgt", qg, kc.float()) * (hd**-0.5)
    t_pos = torch.arange(T, device=q.device)
    ok = (t_pos[None, :] >= kv_start.to(q.device)[:, None]) & (
        t_pos[None, :] < kv_len.to(q.device)[:, None]
    )
    o = _softmax_pv(s, ok[:, None, None, :], vc, "bkgt,bktd->bkgd")
    return o.reshape(B, 1, H, hd).to(q.dtype)


def chunk_attention_xla(
    q: torch.Tensor,  # [B, S, H, hd]
    k_cache: torch.Tensor,  # [L, B, K, T, hd]
    v_cache: torch.Tensor,
    kv_start: torch.Tensor,
    kv_len: torch.Tensor,
    layer: int,
    write_index: int,
) -> torch.Tensor:
    """Plain version of ``chunk_prefill_attention`` (JAX oracle
    ``chunk_attention_xla``)."""
    B, S, H, hd = q.shape
    K, T = k_cache.shape[2], k_cache.shape[3]
    G = H // K
    kc, vc = k_cache[layer], v_cache[layer]
    qg = q.reshape(B, S, K, G, hd).float()
    s = torch.einsum("bqkgd,bktd->bkgqt", qg, kc.float()) * (hd**-0.5)
    q_pos = write_index + torch.arange(S, device=q.device)
    t_pos = torch.arange(T, device=q.device)
    ok = (t_pos[None, None, :] >= kv_start.to(q.device)[:, None, None]) & (
        t_pos[None, None, :] < kv_len.to(q.device)[:, None, None]
    )
    ok = ok & (t_pos[None, None, :] <= q_pos[None, :, None])
    o = _softmax_pv(s, ok[:, None, None], vc, "bkgqt,bktd->bqkgd")
    return o.reshape(B, S, H, hd).to(q.dtype)


def _gather_paged_layer(
    arena: torch.Tensor,  # [L, N, K, bs, hd]
    block_tables: torch.Tensor,  # [B, MB]
    kv_len: torch.Tensor,  # [B]
    layer: int,
) -> torch.Tensor:
    """``[B, K, MB * bs, hd]`` logical view of one layer, gathered through
    the tables, with slots at or past ``kv_len`` zeroed (they may hold
    another request's data or NaN, and 0 * NaN = NaN)."""
    g = arena[layer][block_tables.long()]  # [B, MB, K, bs, hd]
    B, MB, K, bs, hd = g.shape
    g = g.permute(0, 2, 1, 3, 4).reshape(B, K, MB * bs, hd)
    ok = torch.arange(MB * bs, device=g.device)[None, :] < kv_len.to(g.device)[:, None]
    return torch.where(ok[:, None, :, None], g, torch.zeros((), dtype=g.dtype, device=g.device))


def paged_decode_attention_xla(
    q: torch.Tensor,  # [B, 1, H, hd]
    k_arena: torch.Tensor,  # [L, N, K, bs, hd]
    v_arena: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int
    kv_len: torch.Tensor,  # [B]
    layer: int,
) -> torch.Tensor:
    """Plain version of ``paged_decode_attention`` (JAX oracle
    ``paged_decode_attention_xla``): gather each row's blocks, then the
    dense decode math over ``[0, kv_len)``."""
    k = _gather_paged_layer(k_arena, block_tables, kv_len, layer)[None]
    v = _gather_paged_layer(v_arena, block_tables, kv_len, layer)[None]
    zero = torch.zeros_like(kv_len)
    return decode_attention_xla(q, k, v, zero, kv_len, 0)


def paged_chunk_attention_xla(
    q: torch.Tensor,  # [B, S, H, hd]
    k_arena: torch.Tensor,  # [L, N, K, bs, hd]
    v_arena: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int
    kv_len: torch.Tensor,  # [B]
    layer: int,
    write_index: torch.Tensor,  # [B]: logical slot of each row's query 0
) -> torch.Tensor:
    """Plain version of ``paged_chunk_attention`` (JAX oracle
    ``paged_chunk_attention_xla``): per-row offset causality
    ``t_k <= write_index[b] + t`` over ``[0, kv_len[b])``."""
    B, S, H, hd = q.shape
    k = _gather_paged_layer(k_arena, block_tables, kv_len, layer)
    v = _gather_paged_layer(v_arena, block_tables, kv_len, layer)
    K, T = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd).float()
    s = torch.einsum("bqkgd,bktd->bkgqt", qg, k.float()) * (hd**-0.5)
    q_pos = write_index.to(q.device)[:, None] + torch.arange(S, device=q.device)[None, :]
    t_pos = torch.arange(T, device=q.device)
    ok = (t_pos[None, None, :] < kv_len.to(q.device)[:, None, None]) & (
        t_pos[None, None, :] <= q_pos[:, :, None]
    )
    o = _softmax_pv(s, ok[:, None, None], v, "bkgqt,bktd->bqkgd")
    return o.reshape(B, S, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    return _build.load("attention", {
        "flash_attention_bf16": (
            [_VP, _LL, _LL, _LL] * 3 + [_VP, _VP, _VP] + [_I] * 7 + [_F, _VP], _I,
        ),
        "decode_attention_bf16": ([_VP] * 6 + [_I] * 7 + [_F, _VP], _I),
        "chunk_attention_bf16": ([_VP] * 6 + [_I] * 9 + [_F, _VP], _I),
    })


def _check_bf16(what: str, dev: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.bfloat16:
            raise ValueError(f"{what}: {name} must be bf16 on {dev} (got {t.dtype} on {t.device})")
        # 16-byte vector loads along the contiguous head dim
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} needs a contiguous, 16-byte aligned head dim")


def _window(t: Optional[torch.Tensor], B: int, fill: int, dev: torch.device) -> torch.Tensor:
    if t is None:
        return torch.full((B,), fill, dtype=torch.int32, device=dev)
    if tuple(t.shape) != (B,):
        raise ValueError(f"kv window must have shape ({B},), got {tuple(t.shape)}")
    return t.to(device=dev, dtype=torch.int32).contiguous()


def _check_heads(what: str, H: int, K: int, hd: int) -> None:
    if hd not in (64, 128) or K < 1 or H % K:
        raise ValueError(f"{what}: the kernel takes hd in (64, 128) and H % K == 0 (H={H}, K={K}, hd={hd})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Sk, K, hd]
    v: torch.Tensor,
    kv_start: Optional[torch.Tensor] = None,
    kv_len: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Attention over fresh K/V; returns ``[B, Sq, H, hd]`` in q's dtype."""
    if q.device.type == "cpu":
        return attention_xla(q, k, v, kv_start, kv_len, causal)
    B, S, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    dev = q.device
    if tuple(k.shape) != (B, Sk, K, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    _check_heads("flash_attention", H, K, hd)
    _check_bf16("flash_attention", dev, q=q, k=k, v=v)
    ks = _window(kv_start, B, 0, dev)
    kl = _window(kv_len, B, Sk, dev)
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    lib = _lib()
    rc = lib.flash_attention_bf16(
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
        out.data_ptr(), ks.data_ptr(), kl.data_ptr(),
        B, S, Sk, H, K, hd, int(causal), hd**-0.5, _stream(dev),
    )
    _build.check(lib, rc, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out


def _check_cache(what: str, q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, layer: int):
    L, B, K, T, hd = k_cache.shape
    H = q.shape[2]
    if tuple(v_cache.shape) != tuple(k_cache.shape) or q.shape[0] != B or q.shape[3] != hd:
        raise ValueError(f"{what}: q{tuple(q.shape)} cache{tuple(k_cache.shape)} do not match")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous() and q.is_contiguous()):
        raise ValueError(f"{what}: q and the caches must be contiguous")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} outside [0, {L})")
    _check_heads(what, H, K, hd)
    _check_bf16(what, q.device, q=q, k_cache=k_cache, v_cache=v_cache)
    return L, B, K, T, H, hd


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, hd]
    k_cache: torch.Tensor,  # [L, B, K, T, hd]
    v_cache: torch.Tensor,
    kv_start: torch.Tensor,  # [B]
    kv_len: torch.Tensor,  # [B]
    layer: int,
) -> torch.Tensor:
    """Single-token attention over the stacked cache at ``layer``."""
    if q.device.type == "cpu":
        return decode_attention_xla(q, k_cache, v_cache, kv_start, kv_len, layer)
    if q.shape[1] != 1:
        raise ValueError(f"decode_attention is single-token (got S={q.shape[1]})")
    layer = int(layer)
    L, B, K, T, H, hd = _check_cache("decode_attention", q, k_cache, v_cache, layer)
    dev = q.device
    ks, kl = _window(kv_start, B, 0, dev), _window(kv_len, B, T, dev)
    out = torch.empty_like(q)
    lib = _lib()
    rc = lib.decode_attention_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        ks.data_ptr(), kl.data_ptr(), L, B, K, T, H, hd, layer, hd**-0.5, _stream(dev),
    )
    _build.check(lib, rc, "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return out


def chunk_prefill_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k_cache: torch.Tensor,  # [L, B, K, T, hd]
    v_cache: torch.Tensor,
    kv_start: torch.Tensor,
    kv_len: torch.Tensor,
    layer: int,
    write_index: int,
) -> torch.Tensor:
    """``S`` queries at cache slots ``write_index + t`` over the cache at
    ``layer``, offset-causal."""
    if q.device.type == "cpu":
        return chunk_attention_xla(q, k_cache, v_cache, kv_start, kv_len, layer, write_index)
    layer, write_index = int(layer), int(write_index)
    L, B, K, T, H, hd = _check_cache("chunk_prefill_attention", q, k_cache, v_cache, layer)
    S = q.shape[1]
    dev = q.device
    ks, kl = _window(kv_start, B, 0, dev), _window(kv_len, B, T, dev)
    out = torch.empty_like(q)
    lib = _lib()
    rc = lib.chunk_attention_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        ks.data_ptr(), kl.data_ptr(), L, B, K, T, S, H, hd, layer, write_index,
        hd**-0.5, _stream(dev),
    )
    _build.check(lib, rc, "chunk_prefill_attention")
    _build.LAUNCHES["chunk_prefill_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# paged arena ([L, N, K, bs, hd] block pool + [B, MB] block tables)
# ---------------------------------------------------------------------------

# logical blocks one decode split walks; the key range of a row is cut into
# ceil(MB / PAGED_SPLIT_BLOCKS) splits, merged by a second pass
PAGED_SPLIT_BLOCKS = 16


def _paged_lib() -> ctypes.CDLL:
    return _build.load("paged_attention", {
        "paged_decode_attention_bf16": ([_VP] * 9 + [_I] * 11 + [_F, _VP], _I),
        "paged_chunk_attention_bf16": ([_VP] * 7 + [_I] * 10 + [_F, _VP], _I),
    })


def _check_paged(what: str, q, k_arena, v_arena, block_tables, kv_len, layer: int):
    L, N, K, bs, hd = k_arena.shape
    B, S, H, _ = q.shape
    dev = q.device
    if tuple(v_arena.shape) != tuple(k_arena.shape) or q.shape[3] != hd:
        raise ValueError(f"{what}: q{tuple(q.shape)} arena{tuple(k_arena.shape)} do not match")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or tuple(kv_len.shape) != (B,):
        raise ValueError(
            f"{what}: tables{tuple(block_tables.shape)} kv_len{tuple(kv_len.shape)} for B={B}"
        )
    for name, t in (("block_tables", block_tables), ("kv_len", kv_len)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous int32 on {dev}")
    if not (k_arena.is_contiguous() and v_arena.is_contiguous() and q.is_contiguous()):
        raise ValueError(f"{what}: q and the arenas must be contiguous")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} outside [0, {L})")
    if bs % 16:
        raise ValueError(f"{what}: block size {bs} must be a multiple of 16")
    _check_heads(what, H, K, hd)
    _check_bf16(what, dev, q=q, k_arena=k_arena, v_arena=v_arena)
    return L, N, K, bs, hd, B, S, H, block_tables.shape[1]


def paged_decode_attention(
    q: torch.Tensor,  # [B, 1, H, hd]
    k_arena: torch.Tensor,  # [L, N, K, bs, hd]
    v_arena: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int32
    kv_len: torch.Tensor,  # [B] int32
    layer: int,
) -> torch.Tensor:
    """One query per row over the row's live blocks ``[0, kv_len)`` of the
    arena at ``layer``; a row with ``kv_len = 0`` gets zeros."""
    if q.device.type == "cpu":
        return paged_decode_attention_xla(q, k_arena, v_arena, block_tables, kv_len, layer)
    if q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention is single-token (got S={q.shape[1]})")
    layer = int(layer)
    L, N, K, bs, hd, B, _, H, MB = _check_paged(
        "paged_decode_attention", q, k_arena, v_arena, block_tables, kv_len, layer
    )
    G = H // K
    if G not in (1, 2, 4, 8):
        raise ValueError(f"paged_decode_attention: the kernel takes H // K in (1, 2, 4, 8), got {G}")
    dev = q.device
    n_splits = -(-MB // PAGED_SPLIT_BLOCKS)
    part_m = torch.empty((B, K, n_splits, G), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, K, n_splits, G, hd), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    lib = _paged_lib()
    rc = lib.paged_decode_attention_bf16(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), out.data_ptr(),
        block_tables.data_ptr(), kv_len.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        L, N, B, K, bs, MB, H, hd, layer, PAGED_SPLIT_BLOCKS, n_splits, hd**-0.5, _stream(dev),
    )
    _build.check(lib, rc, "paged_decode_attention")
    _build.LAUNCHES["paged_decode_attention"] += 1
    return out


def paged_chunk_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k_arena: torch.Tensor,  # [L, N, K, bs, hd]
    v_arena: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int32
    kv_len: torch.Tensor,  # [B] int32
    layer: int,
    write_index: torch.Tensor,  # [B] int32
) -> torch.Tensor:
    """``S`` queries per row at logical slots ``write_index[b] + t`` over
    the row's live blocks, offset-causal (``t_k <= write_index[b] + t``)."""
    if q.device.type == "cpu":
        return paged_chunk_attention_xla(q, k_arena, v_arena, block_tables, kv_len, layer, write_index)
    layer = int(layer)
    L, N, K, bs, hd, B, S, H, MB = _check_paged(
        "paged_chunk_attention", q, k_arena, v_arena, block_tables, kv_len, layer
    )
    if tuple(write_index.shape) != (B,) or write_index.dtype != torch.int32 or write_index.device != q.device:
        raise ValueError("paged_chunk_attention: write_index must be int32 [B] on q's device")
    dev = q.device
    out = torch.empty_like(q)
    lib = _paged_lib()
    rc = lib.paged_chunk_attention_bf16(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), out.data_ptr(),
        block_tables.data_ptr(), kv_len.data_ptr(), write_index.contiguous().data_ptr(),
        L, N, B, K, bs, MB, S, H, hd, layer, hd**-0.5, _stream(dev),
    )
    _build.check(lib, rc, "paged_chunk_attention")
    _build.LAUNCHES["paged_chunk_attention"] += 1
    return out
