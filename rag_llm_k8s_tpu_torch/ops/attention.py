"""GQA attention for the Llama and bge-m3 forwards: nine CUDA kernel
wrappers and their plain PyTorch versions.

Counterpart of ``rag_llm_k8s_tpu/ops/attention.py`` kernels 2-10:

- ``flash_attention``: fresh ``[B, S, K, hd]`` K/V, causal or not, per-row
  key window ``[kv_start, kv_len)`` (Llama prefill; bge-m3 with
  ``causal=False``);
- ``decode_attention``: one query token over the stacked head-major cache
  ``[L, B, K, T, hd]`` read at ``layer`` (no per-layer copy);
- ``chunk_prefill_attention``: ``S`` queries written at ``write_index`` over
  the cache, offset causality ``t_k <= write_index + t`` (long-prompt chunks
  and the speculative verify); the kernel reads ``write_index`` from device
  memory (a one-element int32 tensor, as JAX's scalar prefetch), so a step
  that keeps its slot on the card launches without a host read;
- ``paged_decode_attention`` and ``paged_chunk_attention``: the same over
  the continuous engine's block-pool arena ``[L, N, K, bs, hd]``, where
  logical key ``t`` of row ``b`` sits in physical block
  ``block_tables[b, t // bs]``; rows are right-padded (window ``[0,
  kv_len)``) and the chunk kernel takes a per-row ``write_index``;
- ``*_q8``: the four cache kernels over an int8 cache or arena with one fp32
  scale per (token, kv head) vector (``quantize_kv``), dequantized in the
  epilogues: each score column times its k-scale, each probability times
  its v-scale before the bf16 rounding for the PV product. Scales outside
  a row's window are zeroed before they multiply anything (they may hold
  NaN); the int8 payload is finite by construction.

Query head ``h`` reads kv head ``h // G``; a query row with no visible key
yields zeros. The plain versions are named after the JAX oracles they match
(``attention_xla``, ``decode_attention_xla``, ``chunk_attention_xla``,
``paged_*_xla``, and their ``*_q8`` forms, which dequantize one layer and
reuse the bf16 math) and compute in fp32 with ``p`` cast to the V dtype
before the PV product. Each wrapper takes its plain version only for CPU
tensors; a CUDA tensor goes to the kernel in ``csrc/attention.cu``
(fresh K/V), ``csrc/attention_sm90.cu`` (the dense bf16 cache: decode and
chunk), ``csrc/paged_attention.cu`` or ``csrc/attention_q8.cu``, or the
wrapper raises. The kernels have no backward: with grad enabled, a wrapper
given a non-CPU input that requires grad raises (``_build.check_no_grad``)
instead of cutting the gradient; training runs the plain versions. Every attention kernel runs a routine of
``csrc/attention_sm90.cuh``; the four q8 kernels run its int8 forms of the
chunk and decode routines.

Every kernel may cut each row's visible keys into splits and merge the
partial ``(m, l, acc)`` in a second pass (split-KV, when the grid is small).
``attention_split_plan`` and ``split_bounds`` are the plan they follow
(``chunk_launch_plan``, ``chunk_design_plan``, ``decode_launch_plan``), and
``decode_attention_split_xla``, ``chunk_attention_split_xla``,
``flash_attention_split_xla``, ``paged_decode_attention_split_xla``,
``paged_chunk_attention_split_xla`` and the q8 forms
``decode_attention_split_xla_q8``, ``chunk_attention_split_xla_q8``,
``paged_decode_attention_split_xla_q8`` and
``paged_chunk_attention_split_xla_q8`` compute the plain versions through
the same splits (``attention_splits_plain`` and ``merge_splits``).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

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


def slot_positions(write_index, n: int, device: torch.device) -> torch.Tensor:
    """``write_index + arange(n)`` as int64 on ``device``: the cache slots of
    ``n`` queries from their first slot, an int or a one-element int tensor
    (``[]`` or ``[1]``, read where it lies, never on the host)."""
    base = write_index.reshape(-1)[:1].to(device=device, dtype=torch.int64) if torch.is_tensor(write_index) \
        else int(write_index)
    return base + torch.arange(n, device=device)


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
    write_index,
) -> torch.Tensor:
    """Plain version of ``chunk_prefill_attention`` (JAX oracle
    ``chunk_attention_xla``). ``write_index``: an int, or a one-element
    int tensor (``[]`` or ``[1]``) that is never read on the host."""
    B, S, H, hd = q.shape
    K, T = k_cache.shape[2], k_cache.shape[3]
    G = H // K
    kc, vc = k_cache[layer], v_cache[layer]
    qg = q.reshape(B, S, K, G, hd).float()
    s = torch.einsum("bqkgd,bktd->bkgqt", qg, kc.float()) * (hd**-0.5)
    q_pos = slot_positions(write_index, S, q.device)
    t_pos = torch.arange(T, device=q.device)
    ok = (t_pos[None, None, :] >= kv_start.to(q.device)[:, None, None]) & (
        t_pos[None, None, :] < kv_len.to(q.device)[:, None, None]
    )
    ok = ok & (t_pos[None, None, :] <= q_pos[None, :, None])
    o = _softmax_pv(s, ok[:, None, None], vc, "bkgqt,bktd->bqkgd")
    return o.reshape(B, S, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# split-KV: the plan the dense cache kernels follow, and the plain
# split-then-merge
# ---------------------------------------------------------------------------

CHUNK_TILE_KEYS = 64  # key tile of the chunk routine (csrc/attention_sm90.cuh CBN)
DECODE_TILE_KEYS = 16  # key tile of the decode routine (DBN)
# A decode warp walks its split's tiles one after another, so the longest
# split sets the kernel's time, while each split adds a partial to the merge
# pass. On the H100 the int8 paged decode at B = 8 took 0.0532 ms with
# 54-tile splits, 0.0322 with 16, 0.0287 with 8 and 0.0382 with 4
# (chip_smoke.py phase_paged_decode_q8, PERF.md §6); the bf16 one, whose
# tiles are twice the bytes, 0.0556, 0.0308, 0.0326 and 0.0417
# (phase_paged_decode). Splits are capped at 8 for every decode kernel.
DECODE_SPLIT_TILES = 8


def attention_split_plan(blocks: int, T: int, tile: int, n_sm: int) -> Tuple[int, int]:
    """``(split_keys, n_splits)`` for a grid of ``blocks`` (row tile, batch
    row, kv head) blocks over a ``T``-slot cache with key tile ``tile``.
    When the grid already holds ``2 * n_sm`` blocks, one split takes every
    key. Otherwise splits are a whole number of tiles, as long as still
    gives ``blocks * n_splits >= 2 * n_sm`` (one tile at the shortest).
    ``n_splits`` splits of ``split_keys`` cover any window of the cache cut
    as ``split_bounds`` cuts it."""
    n_tiles = max(1, -(-T // tile))
    if blocks >= 2 * n_sm:
        return n_tiles * tile, 1
    per = max(1, n_tiles // -(-2 * n_sm // blocks))
    return per * tile, -(-n_tiles // per)


def split_bounds(lo: int, hi: int, split_keys: int, tile: int) -> List[Tuple[int, int]]:
    """The kernels' splits of the visible keys ``[lo, hi)``: consecutive
    ranges of ``split_keys`` from ``lo`` rounded down to ``tile``, clipped to
    ``[lo, hi)``; none when the range is empty."""
    lo = max(lo, 0)
    if hi <= lo:
        return []
    lo_a = lo // tile * tile
    n = -(-(hi - lo_a) // split_keys)
    return [(max(lo, lo_a + i * split_keys), min(hi, lo_a + (i + 1) * split_keys)) for i in range(n)]


def chunk_launch_plan(B: int, S: int, H: int, K: int, T: int, n_sm: int) -> dict:
    """Grid of ``chunk_prefill_attention``'s kernel: query rows per block
    (one warpgroup, 64, when the rows fit in it, else two), row tiles, the
    split plan, and the blocks of the split pass."""
    n_rows = S * (H // K)
    block_rows = 64 if n_rows <= 64 else 128
    row_tiles = -(-n_rows // block_rows)
    split_keys, n_splits = attention_split_plan(row_tiles * B * K, T, CHUNK_TILE_KEYS, n_sm)
    return dict(block_rows=block_rows, row_tiles=row_tiles, split_keys=split_keys,
                n_splits=n_splits, blocks=row_tiles * B * K * n_splits)


# The chunk-shaped bf16 kernels' designs (csrc/attention_sm90.cuh): the wgmma
# chunk routine, or the warp-specialized routine (a TMA producer warp and two
# consumer warpgroups; one split, 128-row tiles of whole positions)
CHUNK_DESIGNS = {"chunk": 0, "ws": 1}
WS_BLOCK_ROWS = 128
# where the warp-specialized routine measured faster (H100, PERF.md §6):
# the long hd = 128 rows (Llama prefill and long chunks); at bge-m3's 8 x 512,
# hd = 64 the chunk routine is faster
WS_HEAD_DIMS = (128,)


def chunk_design_plan(B: int, S: int, H: int, K: int, T: int, hd: int, n_sm: int,
                      design: Optional[str] = None) -> dict:
    """``chunk_launch_plan`` plus the kernel design of ``flash_attention``
    and ``chunk_prefill_attention``. The warp-specialized routine ("ws")
    takes a shape whose chunk plan is one split and whose head group ``G``
    divides 128; ``design=None`` picks it there for ``hd`` in
    ``WS_HEAD_DIMS``, and the chunk routine elsewhere."""
    plan = chunk_launch_plan(B, S, H, K, T, n_sm)
    G = H // K
    ws_ok = plan["n_splits"] == 1 and WS_BLOCK_ROWS % G == 0
    design = design or ("ws" if ws_ok and hd in WS_HEAD_DIMS else "chunk")
    if design not in CHUNK_DESIGNS or (design == "ws" and not ws_ok):
        raise ValueError(f"design {design!r} does not take this shape ({plan})")
    if design == "ws":
        row_tiles = -(-S * G // WS_BLOCK_ROWS)
        plan.update(block_rows=WS_BLOCK_ROWS, row_tiles=row_tiles, blocks=row_tiles * B * K)
    plan["design"] = design
    return plan


def decode_launch_plan(B: int, K: int, T: int, n_sm: int) -> dict:
    """Grid of the decode kernels (``decode_attention``,
    ``paged_decode_attention`` and the two q8 ones; the paged ones at
    ``T = MB * bs``): one warp per (split, kv head,
    row), ``attention_split_plan``'s splits cut to at most
    ``DECODE_SPLIT_TILES`` tiles."""
    split_keys, n_splits = attention_split_plan(B * K, T, DECODE_TILE_KEYS, n_sm)
    if split_keys > DECODE_SPLIT_TILES * DECODE_TILE_KEYS:
        split_keys = DECODE_SPLIT_TILES * DECODE_TILE_KEYS
        n_splits = -(-T // split_keys)
    return dict(split_keys=split_keys, n_splits=n_splits, blocks=B * K * n_splits)


def attention_splits_plain(
    s: torch.Tensor,  # [..., Q, T] scaled scores, fp32
    ok: torch.Tensor,  # [..., Q, T] visible keys
    v: torch.Tensor,  # [..., T, hd]
    bounds: List[Tuple[int, int]],
    v_scale: Optional[torch.Tensor] = None,  # [..., T] int8 V's scales (0 outside the window)
    p_dtype: Optional[torch.dtype] = None,
):
    """Partial ``(m, l, acc)`` of each key split ``[a, b)`` in ``bounds``,
    stacked on a leading split axis: ``m`` the max visible score
    (``NEG_INF`` where a row sees none of the split's keys), ``l`` the sum
    of ``exp(s - m)`` over visible keys, ``acc`` the same weights, cast to
    ``p_dtype`` (default v's dtype), times v, in fp32. With ``v_scale`` (an
    int8 v) the weights are multiplied by it before the cast, and ``l``
    takes them unscaled."""
    ms, ls, accs = [], [], []
    for a, b in bounds:
        sk, okk = s[..., a:b], ok[..., a:b]
        x = torch.where(okk, sk, torch.full_like(sk, NEG_INF))
        m = x.amax(dim=-1)
        p = torch.where(okk, torch.exp(x - m[..., None]), torch.zeros_like(x))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        pv = p if v_scale is None else p * v_scale[..., None, a:b]
        accs.append(torch.matmul(pv.to(p_dtype or v.dtype).float(), v[..., a:b, :].float()))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def merge_splits(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Merge split partials (leading axis): ``sum(acc_s e_s) / sum(l_s
    e_s)`` with ``e_s = exp(m_s - max m)``; a split with no visible key
    (``m = NEG_INF``, ``l = 0``, ``acc = 0``) adds nothing, and a row no
    split sees gets zeros."""
    e = torch.exp(m - m.amax(dim=0))
    return (acc * e[..., None]).sum(dim=0) / (l * e).sum(dim=0).clamp_min(1e-30)[..., None]


def decode_attention_split_xla(
    q: torch.Tensor,  # [B, 1, H, hd]
    k_cache: torch.Tensor,  # [L, B, K, T, hd]
    v_cache: torch.Tensor,
    kv_start: torch.Tensor,
    kv_len: torch.Tensor,
    layer: int,
    split_keys: int,
    tile: int = DECODE_TILE_KEYS,
) -> torch.Tensor:
    """``decode_attention_xla`` computed the way the decode kernel cuts it:
    each row's window into ``split_bounds``, one partial per split, merged."""
    B, _, H, hd = q.shape
    K, T = k_cache.shape[2], k_cache.shape[3]
    G = H // K
    out = torch.zeros((B, K, G, hd), dtype=torch.float32, device=q.device)
    t = torch.arange(T, device=q.device)
    for b in range(B):
        lo, hi = int(kv_start[b]), min(int(kv_len[b]), T)
        bounds = split_bounds(lo, hi, split_keys, tile)
        if not bounds:
            continue
        s = torch.einsum("kgd,ktd->kgt", q[b, 0].reshape(K, G, hd).float(),
                         k_cache[layer, b].float()) * (hd**-0.5)
        ok = ((t >= lo) & (t < hi)).expand_as(s)
        out[b] = merge_splits(*attention_splits_plain(s, ok, v_cache[layer, b], bounds))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _split_merge_row(
    qr: torch.Tensor,  # [K, n_rows, hd] one batch row's query rows (position, head in group)
    kk: torch.Tensor,  # [K, T, hd]
    vv: torch.Tensor,  # [K, T, hd]
    lo: int,
    len_b: int,
    pos: Optional[torch.Tensor],  # [n_rows] each query row's position (read only when causal)
    causal: bool,
    split_keys: int,
    block_rows: int,
    tile: int,
    k_scale: Optional[torch.Tensor] = None,  # [K, T] an int8 kk's scales, 0 outside [lo, len_b)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One batch row cut the way the chunk routine cuts it: query rows in
    tiles of ``block_rows``, each tile's visible keys ``[lo, hi)`` (``hi``
    clipped by causality at its last row) cut by ``split_bounds``, one
    partial per split, merged. ``[K, n_rows, hd]`` fp32; rows of a tile no
    split covers are zero. With scales (int8 kk and vv), each score column
    is multiplied by its k-scale and the PV operand is ``p * v_scale``
    rounded to q's dtype, as the q8 chunk kernels do."""
    K, n_rows, hd = qr.shape
    T = kk.shape[1]
    out = torch.zeros((K, n_rows, hd), dtype=torch.float32, device=qr.device)
    t = torch.arange(T, device=qr.device)
    s = torch.einsum("krd,ktd->krt", qr.float(), kk.float()) * (hd**-0.5)
    if k_scale is not None:
        s = s * k_scale[:, None, :]
    ok = ((t >= lo) & (t < len_b))[None, :].expand(n_rows, T)
    if causal:
        ok = ok & (t[None, :] <= pos[:, None])
    for r0 in range(0, n_rows, block_rows):
        r1 = min(r0 + block_rows, n_rows)
        hi = min(len_b, int(pos[r1 - 1]) + 1) if causal else len_b
        bounds = split_bounds(lo, hi, split_keys, tile)
        if bounds:
            out[:, r0:r1] = merge_splits(*attention_splits_plain(
                s[:, r0:r1], ok[r0:r1].expand(K, -1, -1), vv, bounds, v_scale,
                None if v_scale is None else qr.dtype))
    return out


def _query_rows(q_b: torch.Tensor, K: int) -> torch.Tensor:
    """``[S, H, hd] -> [K, S * G, hd]``: row ``t * G + g`` of kv head ``k``
    is query head ``k * G + g`` at position ``t``."""
    S, H, hd = q_b.shape
    return q_b.reshape(S, K, H // K, hd).transpose(0, 1).reshape(K, S * (H // K), hd)


def _from_query_rows(out: torch.Tensor, S: int, dtype: torch.dtype) -> torch.Tensor:
    """``[B, K, S * G, hd] -> [B, S, H, hd]``, the inverse of ``_query_rows``."""
    B, K, n_rows, hd = out.shape
    G = n_rows // S
    return out.reshape(B, K, S, G, hd).permute(0, 2, 1, 3, 4).reshape(B, S, K * G, hd).to(dtype)


def chunk_attention_split_xla(
    q: torch.Tensor,  # [B, S, H, hd]
    k_cache: torch.Tensor,  # [L, B, K, T, hd]
    v_cache: torch.Tensor,
    kv_start: torch.Tensor,
    kv_len: torch.Tensor,
    layer: int,
    write_index,
    split_keys: int,
    block_rows: int = 64,
    tile: int = CHUNK_TILE_KEYS,
) -> torch.Tensor:
    """``chunk_attention_xla`` computed the way the chunk kernel cuts it
    (``_split_merge_row`` for each batch row); ``write_index`` an int or a
    one-element int tensor."""
    B, S, H, hd = q.shape
    K, T = k_cache.shape[2], k_cache.shape[3]
    pos = slot_positions(write_index, S, q.device).repeat_interleave(H // K)
    out = torch.stack([
        _split_merge_row(_query_rows(q[b], K), k_cache[layer, b], v_cache[layer, b], int(kv_start[b]),
                         min(int(kv_len[b]), T), pos, True, split_keys, block_rows, tile)
        for b in range(B)])
    return _from_query_rows(out, S, q.dtype)


def flash_attention_split_xla(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, Sk, K, hd]
    v: torch.Tensor,
    kv_start: Optional[torch.Tensor],
    kv_len: Optional[torch.Tensor],
    causal: bool,
    split_keys: int,
    block_rows: int = 128,
    tile: int = CHUNK_TILE_KEYS,
) -> torch.Tensor:
    """``attention_xla`` computed the way ``flash_attention``'s kernels cut
    it: query ``t`` at position ``t``, each batch row's window ``[kv_start,
    min(kv_len, Sk))`` through ``_split_merge_row`` (the warp-specialized
    routine is one split of 128-row tiles with 128-key tiles)."""
    B, S, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    pos = torch.arange(S * (H // K), device=q.device) // (H // K)
    out = torch.stack([
        _split_merge_row(_query_rows(q[b], K), k[b].transpose(0, 1), v[b].transpose(0, 1),
                         0 if kv_start is None else int(kv_start[b]),
                         Sk if kv_len is None else min(int(kv_len[b]), Sk),
                         pos, causal, split_keys, block_rows, tile)
        for b in range(B)])
    return _from_query_rows(out, S, q.dtype)


def _gather_paged_layer(
    arena: torch.Tensor,  # [L, N, K, bs, hd], or [L, N, K, bs] scales
    block_tables: torch.Tensor,  # [B, MB]
    kv_len: torch.Tensor,  # [B]
    layer: int,
) -> torch.Tensor:
    """``[B, K, MB * bs(, hd)]`` logical view of one layer, gathered through
    the tables, with slots at or past ``kv_len`` zeroed (they may hold
    another request's data or NaN, and 0 * NaN = NaN)."""
    g = arena[layer][block_tables.long()]  # [B, MB, K, bs(, hd)]
    B, MB, K, bs = g.shape[:4]
    g = g.transpose(1, 2).reshape(B, K, MB * bs, *g.shape[4:])
    ok = torch.arange(MB * bs, device=g.device)[None, :] < kv_len.to(g.device)[:, None]
    ok = ok[:, None, :, None] if g.dim() == 4 else ok[:, None, :]
    return torch.where(ok, g, torch.zeros((), dtype=g.dtype, device=g.device))


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


def paged_decode_attention_split_xla(
    q: torch.Tensor,  # [B, 1, H, hd]
    k_arena: torch.Tensor,  # [L, N, K, bs, hd]
    v_arena: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int
    kv_len: torch.Tensor,  # [B]
    layer: int,
    split_keys: int,
    tile: int = DECODE_TILE_KEYS,
) -> torch.Tensor:
    """``paged_decode_attention_xla`` computed the way the paged decode
    kernel cuts it: each row's blocks gathered through the table (slots past
    ``kv_len`` zeroed), the window ``[0, min(kv_len, MB * bs))`` cut by
    ``split_bounds``, through ``_split_merge_row`` (no causality; the G
    heads are one row tile)."""
    B, _, H, _ = q.shape
    K = k_arena.shape[2]
    k = _gather_paged_layer(k_arena, block_tables, kv_len, layer)
    v = _gather_paged_layer(v_arena, block_tables, kv_len, layer)
    out = torch.stack([
        _split_merge_row(_query_rows(q[b], K), k[b], v[b], 0, min(int(kv_len[b]), k.shape[2]), None, False,
                         split_keys, H // K, tile)
        for b in range(B)])
    return _from_query_rows(out, 1, q.dtype)


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
    k = _gather_paged_layer(k_arena, block_tables, kv_len, layer)
    v = _gather_paged_layer(v_arena, block_tables, kv_len, layer)
    return _paged_chunk_on_views(q, k, v, kv_len, write_index)


def _paged_chunk_on_views(q, k, v, kv_len, write_index) -> torch.Tensor:
    """Offset-causal attention over gathered ``[B, K, T, hd]`` views."""
    B, S, H, hd = q.shape
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


def paged_chunk_attention_split_xla(
    q: torch.Tensor,  # [B, S, H, hd]
    k_arena: torch.Tensor,  # [L, N, K, bs, hd]
    v_arena: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int
    kv_len: torch.Tensor,  # [B]
    layer: int,
    write_index: torch.Tensor,  # [B]
    split_keys: int,
    block_rows: int = 128,
    tile: int = CHUNK_TILE_KEYS,
) -> torch.Tensor:
    """``paged_chunk_attention_xla`` computed the way its kernel cuts it:
    each row's blocks gathered through the table (slots past ``kv_len``
    zeroed), window ``[0, min(kv_len, MB * bs))``, query ``t`` at
    ``write_index[b] + t``, through ``_split_merge_row``."""
    B, S, H, _ = q.shape
    K = k_arena.shape[2]
    k = _gather_paged_layer(k_arena, block_tables, kv_len, layer)
    v = _gather_paged_layer(v_arena, block_tables, kv_len, layer)
    rows = torch.arange(S * (H // K), device=q.device) // (H // K)
    out = torch.stack([
        _split_merge_row(_query_rows(q[b], K), k[b], v[b], 0, min(int(kv_len[b]), k.shape[2]),
                         int(write_index[b]) + rows, True, split_keys, block_rows, tile)
        for b in range(B)])
    return _from_query_rows(out, S, q.dtype)


# ---------------------------------------------------------------------------
# int8 KV: quantization and the plain q8 versions
# ---------------------------------------------------------------------------


# 1/127 in fp32. The JAX package always runs its quantizers compiled, and
# XLA turns the division by the constant 127 into a multiplication by this
# reciprocal; copying the compiled arithmetic keeps the scales equal bit for
# bit.
INV_127 = 1.0 / 127.0


def quantize_kv(x: torch.Tensor):
    """``[..., hd] -> (int8 [..., hd], fp32 scale [...])``: one symmetric
    scale per head vector, ``max(amax, 1e-8) / 127``, and ``x / scale``
    rounded half to even (JAX ``quantize_kv``, as compiled). A scale reads
    one head's ``hd`` values only, so on a tp mesh each rank quantizes its
    own kv heads with no collective."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) * INV_127
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


# ---------------------------------------------------------------------------
# RoPE re-rotation of cached K planes (chunk-granular prefix reuse)
# ---------------------------------------------------------------------------
#
# K computed at position p and reused at p + delta differs only by a further
# rotation of angle delta * inv_freq of each (i, i + hd/2) pair; V carries no
# position. The JAX package computes these outside Pallas, so they are plain
# PyTorch here. Both copy the compiled XLA arithmetic on the CPU, bit for
# bit: the phases' cos and sin are the C library's cosf/sinf (what XLA calls
# on the CPU), and each a*b - c*d is contracted to fma(a, b, -(c*d)).

_LIBM: Optional[ctypes.CDLL] = None


def _libm() -> ctypes.CDLL:
    global _LIBM
    if _LIBM is None:
        import ctypes.util

        lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        for name in ("cosf", "sinf"):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = _F, [_F]
        _LIBM = lib
    return _LIBM


def rope_delta_cos_sin(delta: int, inv_freqs: torch.Tensor, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cos, sin`` of the phases ``delta * inv_freqs`` (fp32 ``[hd/2]``),
    computed on the host (``hd/2`` values) and placed on ``device``."""
    phase = torch.tensor(float(delta), dtype=torch.float32) * inv_freqs.detach().to("cpu", torch.float32)
    lib = _libm()
    vals = phase.tolist()
    c = torch.tensor([lib.cosf(x) for x in vals], dtype=torch.float32)
    s = torch.tensor([lib.sinf(x) for x in vals], dtype=torch.float32)
    return c.to(device), s.to(device)


def _rotate(xf: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The pairwise-by-halves rotation of fp32 ``xf [..., hd]``, each half as
    ``fma(x, c, -+(y * s))``: the product of two fp32 values is exact in
    fp64, so one fp64 sum rounded to fp32 is the fused multiply-add."""
    half = xf.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    cd = c.double()
    return torch.cat([
        (x1.double() * cd - (x2 * s).double()).float(),
        (x2.double() * cd + (x1 * s).double()).float(),
    ], dim=-1)


def rope_rerotate(k: torch.Tensor, delta: int, inv_freqs: torch.Tensor) -> torch.Tensor:
    """Rotate cached K planes ``[..., hd]`` by a uniform position ``delta``
    (JAX ``rope_rerotate``): fp32 math, returned in ``k``'s dtype."""
    c, s = rope_delta_cos_sin(delta, inv_freqs, k.device)
    return _rotate(k.float(), c, s).to(k.dtype)


def rope_rerotate_q8(
    k_q: torch.Tensor, k_scale: torch.Tensor, delta: int, inv_freqs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rope_rerotate`` over the int8 K layout (JAX ``rope_rerotate_q8``):
    dequantize, rotate, requantize with each vector's scale recomputed as
    ``quantize_kv`` does (the rotation changes its max-abs)."""
    c, s = rope_delta_cos_sin(delta, inv_freqs, k_q.device)
    rot = _rotate(k_q.float() * k_scale[..., None], c, s)
    scale = rot.abs().amax(dim=-1).clamp_min(1e-8) * INV_127
    return torch.round(rot / scale[..., None]).to(torch.int8), scale


def dequantize_layer_slice(
    cache: torch.Tensor,  # [L, B, K, T, hd] int8
    scale: torch.Tensor,  # [L, B, K, T] fp32
    layer: int,
    kv_start: torch.Tensor,  # [B]
    kv_len: torch.Tensor,  # [B]
    dtype: torch.dtype,
) -> torch.Tensor:
    """``[1, B, K, T, hd]`` dequantized view of one layer; scales outside
    ``[kv_start, kv_len)`` are zeroed first (they may hold NaN)."""
    T = cache.shape[3]
    t = torch.arange(T, device=cache.device)
    ok = (t[None, :] >= kv_start.to(cache.device)[:, None]) & (t[None, :] < kv_len.to(cache.device)[:, None])
    s = torch.where(ok[:, None, :], scale[layer], torch.zeros((), dtype=scale.dtype, device=scale.device))
    return (cache[layer].float() * s[..., None]).to(dtype)[None]


def decode_attention_xla_q8(q, k_cache, v_cache, k_scale, v_scale, kv_start, kv_len, layer) -> torch.Tensor:
    """Plain version of ``decode_attention_q8`` (JAX oracle
    ``decode_attention_xla_q8``): dequantize this layer, then the bf16 math."""
    kd = dequantize_layer_slice(k_cache, k_scale, layer, kv_start, kv_len, q.dtype)
    vd = dequantize_layer_slice(v_cache, v_scale, layer, kv_start, kv_len, q.dtype)
    return decode_attention_xla(q, kd, vd, kv_start, kv_len, 0)


def chunk_attention_xla_q8(
    q, k_cache, v_cache, k_scale, v_scale, kv_start, kv_len, layer, write_index
) -> torch.Tensor:
    """Plain version of ``chunk_prefill_attention_q8`` (JAX oracle
    ``chunk_attention_xla_q8``)."""
    kd = dequantize_layer_slice(k_cache, k_scale, layer, kv_start, kv_len, q.dtype)
    vd = dequantize_layer_slice(v_cache, v_scale, layer, kv_start, kv_len, q.dtype)
    return chunk_attention_xla(q, kd, vd, kv_start, kv_len, 0, write_index)


def _dequant_paged_layer(k_arena, v_arena, k_scale, v_scale, block_tables, kv_len, layer, dtype):
    """Gathered, dequantized ``[B, K, MB * bs, hd]`` K/V views of one layer
    of an int8 arena, scales past each row's frontier zeroed."""
    out = []
    for arena, scale in ((k_arena, k_scale), (v_arena, v_scale)):
        x = _gather_paged_layer(arena, block_tables, kv_len, layer)
        s = _gather_paged_layer(scale, block_tables, kv_len, layer)
        out.append((x.float() * s[..., None]).to(dtype))
    return out


def paged_decode_attention_xla_q8(
    q, k_arena, v_arena, k_scale, v_scale, block_tables, kv_len, layer
) -> torch.Tensor:
    """Plain version of ``paged_decode_attention_q8`` (JAX oracle
    ``paged_decode_attention_xla_q8``)."""
    kd, vd = _dequant_paged_layer(k_arena, v_arena, k_scale, v_scale, block_tables, kv_len, layer, q.dtype)
    return decode_attention_xla(q, kd[None], vd[None], torch.zeros_like(kv_len), kv_len, 0)


def paged_chunk_attention_xla_q8(
    q, k_arena, v_arena, k_scale, v_scale, block_tables, kv_len, layer, write_index
) -> torch.Tensor:
    """Plain version of ``paged_chunk_attention_q8`` (JAX oracle
    ``paged_chunk_attention_xla_q8``)."""
    kd, vd = _dequant_paged_layer(k_arena, v_arena, k_scale, v_scale, block_tables, kv_len, layer, q.dtype)
    return _paged_chunk_on_views(q, kd, vd, kv_len, write_index)


def _window_scales(scale: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``[K, T]`` scales of one row with those outside ``[lo, hi)`` set to 0
    (they may hold NaN)."""
    t = torch.arange(scale.shape[-1], device=scale.device)
    return torch.where((t >= lo) & (t < hi), scale, torch.zeros((), dtype=scale.dtype, device=scale.device))


def chunk_attention_split_xla_q8(
    q: torch.Tensor,  # [B, S, H, hd]
    k_cache: torch.Tensor,  # [L, B, K, T, hd] int8
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # [L, B, K, T] fp32
    v_scale: torch.Tensor,
    kv_start: torch.Tensor,
    kv_len: torch.Tensor,
    layer: int,
    write_index,
    split_keys: int,
    block_rows: int = 64,
    tile: int = CHUNK_TILE_KEYS,
) -> torch.Tensor:
    """``chunk_attention_xla_q8`` computed the way the q8 chunk kernel cuts
    it: the int8 payload as it is, each score column times its k-scale, the
    PV operand ``p * v_scale`` in q's dtype, scales outside each row's window
    zeroed, through ``_split_merge_row``; ``write_index`` an int or a
    one-element int tensor."""
    B, S, H, hd = q.shape
    K, T = k_cache.shape[2], k_cache.shape[3]
    pos = slot_positions(write_index, S, q.device).repeat_interleave(H // K)
    rows = []
    for b in range(B):
        lo, hi = int(kv_start[b]), min(int(kv_len[b]), T)
        rows.append(_split_merge_row(
            _query_rows(q[b], K), k_cache[layer, b], v_cache[layer, b], lo, hi, pos, True, split_keys,
            block_rows, tile, _window_scales(k_scale[layer, b], lo, hi), _window_scales(v_scale[layer, b], lo, hi)))
    return _from_query_rows(torch.stack(rows), S, q.dtype)


def paged_chunk_attention_split_xla_q8(
    q: torch.Tensor,  # [B, S, H, hd]
    k_arena: torch.Tensor,  # [L, N, K, bs, hd] int8
    v_arena: torch.Tensor,
    k_scale: torch.Tensor,  # [L, N, K, bs] fp32
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int
    kv_len: torch.Tensor,  # [B]
    layer: int,
    write_index: torch.Tensor,  # [B]
    split_keys: int,
    block_rows: int = 128,
    tile: int = CHUNK_TILE_KEYS,
) -> torch.Tensor:
    """``paged_chunk_attention_xla_q8`` computed the way the q8 paged chunk
    kernel cuts it: payload and scales gathered through the table (slots past
    ``kv_len`` zeroed), then ``chunk_attention_split_xla_q8``'s arithmetic
    per row with query ``t`` at ``write_index[b] + t``."""
    B, S, H, _ = q.shape
    K = k_arena.shape[2]
    k = _gather_paged_layer(k_arena, block_tables, kv_len, layer)
    v = _gather_paged_layer(v_arena, block_tables, kv_len, layer)
    ks = _gather_paged_layer(k_scale, block_tables, kv_len, layer)
    vs = _gather_paged_layer(v_scale, block_tables, kv_len, layer)
    rows = torch.arange(S * (H // K), device=q.device) // (H // K)
    out = torch.stack([
        _split_merge_row(_query_rows(q[b], K), k[b], v[b], 0, min(int(kv_len[b]), k.shape[2]),
                         int(write_index[b]) + rows, True, split_keys, block_rows, tile, ks[b], vs[b])
        for b in range(B)])
    return _from_query_rows(out, S, q.dtype)


def decode_attention_split_xla_q8(
    q: torch.Tensor,  # [B, 1, H, hd]
    k_cache: torch.Tensor,  # [L, B, K, T, hd] int8
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # [L, B, K, T] fp32
    v_scale: torch.Tensor,
    kv_start: torch.Tensor,
    kv_len: torch.Tensor,
    layer: int,
    split_keys: int,
    tile: int = DECODE_TILE_KEYS,
) -> torch.Tensor:
    """``decode_attention_xla_q8`` computed the way the q8 decode kernel
    cuts it: this layer dequantized to q's dtype as the plain version
    dequantizes it (scales outside each row's window zeroed), then
    ``decode_attention_split_xla``'s arithmetic."""
    kd = dequantize_layer_slice(k_cache, k_scale, layer, kv_start, kv_len, q.dtype)
    vd = dequantize_layer_slice(v_cache, v_scale, layer, kv_start, kv_len, q.dtype)
    return decode_attention_split_xla(q, kd, vd, kv_start, kv_len, 0, split_keys, tile)


def paged_decode_attention_split_xla_q8(
    q: torch.Tensor,  # [B, 1, H, hd]
    k_arena: torch.Tensor,  # [L, N, K, bs, hd] int8
    v_arena: torch.Tensor,
    k_scale: torch.Tensor,  # [L, N, K, bs] fp32
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int
    kv_len: torch.Tensor,  # [B]
    layer: int,
    split_keys: int,
    tile: int = DECODE_TILE_KEYS,
) -> torch.Tensor:
    """``paged_decode_attention_xla_q8`` computed the way the q8 paged
    decode kernel cuts it: payload and scales gathered through the table
    (slots past ``kv_len`` zeroed) and dequantized to q's dtype, then
    ``paged_decode_attention_split_xla``'s arithmetic over the window
    ``[0, min(kv_len, MB * bs))``."""
    B, _, H, _ = q.shape
    K = k_arena.shape[2]
    kd, vd = _dequant_paged_layer(k_arena, v_arena, k_scale, v_scale, block_tables, kv_len, layer, q.dtype)
    out = torch.stack([
        _split_merge_row(_query_rows(q[b], K), kd[b], vd[b], 0, min(int(kv_len[b]), kd.shape[2]), None, False,
                         split_keys, H // K, tile)
        for b in range(B)])
    return _from_query_rows(out, 1, q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    return _build.load("attention", {
        "flash_attention_sm90": ([_VP, _LL, _LL, _LL] * 3 + [_VP] * 6 + [_I] * 11 + [_F, _VP], _I),
    })


def _sm90_lib() -> ctypes.CDLL:
    return _build.load("attention_sm90", {
        "chunk_attention_sm90": ([_VP] * 10 + [_I] * 12 + [_F, _VP], _I),
        "decode_attention_sm90": ([_VP] * 9 + [_I] * 9 + [_F, _VP], _I),
    })


def _split_parts(BK: int, n_splits: int, n_rows: int, hd: int, dev: torch.device):
    """Scratch of the split pass, one fp32 allocation holding ``[BK,
    n_splits, n_rows]`` m, then l, then ``[..., hd]`` acc, and the three
    pointers (null when there is one split). The caller holds the tensor
    until the launch is enqueued."""
    if n_splits == 1:
        return None, (None, None, None)
    n = -(-BK * n_splits * n_rows // 4) * 4  # keeps l and acc 16-byte aligned
    buf = torch.empty(n * (2 + hd), dtype=torch.float32, device=dev)
    p = buf.data_ptr()
    return buf, (p, p + 4 * n, p + 8 * n)


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
    if t.dtype == torch.int32 and t.device == dev and t.is_contiguous():
        return t
    return t.to(device=dev, dtype=torch.int32).contiguous()


def _write_slot(what: str, write_index, dev: torch.device) -> torch.Tensor:
    """The chunk kernels' write slot as one int32 in device memory: a
    one-element int tensor (``[]`` or ``[1]``) on ``dev`` as it is (a
    conversion stays on the card), a Python int filled in on the card. The
    host never reads a tensor slot, so a step that hands one in does not
    wait on the card."""
    if not torch.is_tensor(write_index):
        return torch.full((1,), int(write_index), dtype=torch.int32, device=dev)
    if write_index.numel() != 1 or write_index.device != dev or write_index.is_floating_point():
        raise ValueError(f"{what}: write_index must be an int or a one-element int tensor on {dev} "
                         f"(got {tuple(write_index.shape)} {write_index.dtype} on {write_index.device})")
    return write_index.reshape(1).to(torch.int32).contiguous()


def _check_heads(what: str, H: int, K: int, hd: int) -> None:
    if hd not in (64, 128) or K < 1 or H % K:
        raise ValueError(f"{what}: the kernel takes hd in (64, 128) and H % K == 0 (H={H}, K={K}, hd={hd})")


def _check_decode_heads(what: str, H: int, K: int) -> int:
    """The head group of a decode kernel: the ``G = H // K`` query heads of
    a kv head are rows of one 16-row mma tile."""
    if H // K > 16:
        raise ValueError(f"{what}: the kernel takes H // K <= 16 (the rows of one mma tile), got {H // K}")
    return H // K


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Sk, K, hd]
    v: torch.Tensor,
    kv_start: Optional[torch.Tensor] = None,
    kv_len: Optional[torch.Tensor] = None,
    causal: bool = True,
    design: Optional[str] = None,
) -> torch.Tensor:
    """Attention over fresh K/V; returns ``[B, Sq, H, hd]`` in q's dtype.
    ``design`` ("chunk" or "ws") overrides ``chunk_design_plan``'s choice
    of kernel by shape."""
    if q.device.type == "cpu":
        return attention_xla(q, k, v, kv_start, kv_len, causal)
    _build.check_no_grad("flash_attention", q, k, v)
    B, S, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    dev = q.device
    if tuple(k.shape) != (B, Sk, K, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    _check_heads("flash_attention", H, K, hd)
    _check_bf16("flash_attention", dev, q=q, k=k, v=v)
    ks = _window(kv_start, B, 0, dev)
    kl = _window(kv_len, B, Sk, dev)
    plan = chunk_design_plan(B, S, H, K, Sk, hd, _build.sm_count(dev.index), design)
    parts, (pm, pl, pa) = _split_parts(B * K, plan["n_splits"], S * (H // K), hd, dev)
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    lib = _lib()
    rc = lib.flash_attention_sm90(
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
        out.data_ptr(), ks.data_ptr(), kl.data_ptr(), pm, pl, pa,
        B, S, Sk, H, K, hd, int(causal), CHUNK_DESIGNS[plan["design"]], plan["block_rows"],
        plan["split_keys"], plan["n_splits"], hd**-0.5, _stream(dev),
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
    _build.check_no_grad("decode_attention", q, k_cache, v_cache)
    if q.shape[1] != 1:
        raise ValueError(f"decode_attention is single-token (got S={q.shape[1]})")
    layer = int(layer)
    L, B, K, T, H, hd = _check_cache("decode_attention", q, k_cache, v_cache, layer)
    G = _check_decode_heads("decode_attention", H, K)
    dev = q.device
    ks, kl = _window(kv_start, B, 0, dev), _window(kv_len, B, T, dev)
    plan = decode_launch_plan(B, K, T, _build.sm_count(dev.index))
    parts, (pm, pl, pa) = _split_parts(B * K, plan["n_splits"], G, hd, dev)
    out = torch.empty_like(q)
    lib = _sm90_lib()
    rc = lib.decode_attention_sm90(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        ks.data_ptr(), kl.data_ptr(), pm, pl, pa, L, B, K, T, H, hd, layer,
        plan["split_keys"], plan["n_splits"], hd**-0.5, _stream(dev),
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
    write_index,
    design: Optional[str] = None,
) -> torch.Tensor:
    """``S`` queries at cache slots ``write_index + t`` over the cache at
    ``layer``, offset-causal. ``write_index``: a one-element int32 tensor
    on q's device (``[]`` or ``[1]``, as JAX's scalar-prefetched index),
    which the kernel reads from device memory, or an int. ``design``
    ("chunk" or "ws") overrides ``chunk_design_plan``'s choice of kernel by
    shape."""
    if q.device.type == "cpu":
        return chunk_attention_xla(q, k_cache, v_cache, kv_start, kv_len, layer, write_index)
    _build.check_no_grad("chunk_prefill_attention", q, k_cache, v_cache)
    layer = int(layer)
    L, B, K, T, H, hd = _check_cache("chunk_prefill_attention", q, k_cache, v_cache, layer)
    S = q.shape[1]
    dev = q.device
    ks, kl = _window(kv_start, B, 0, dev), _window(kv_len, B, T, dev)
    wi = _write_slot("chunk_prefill_attention", write_index, dev)
    plan = chunk_design_plan(B, S, H, K, T, hd, _build.sm_count(dev.index), design)
    parts, (pm, pl, pa) = _split_parts(B * K, plan["n_splits"], S * (H // K), hd, dev)
    out = torch.empty_like(q)
    lib = _sm90_lib()
    rc = lib.chunk_attention_sm90(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        ks.data_ptr(), kl.data_ptr(), wi.data_ptr(), pm, pl, pa, L, B, K, T, S, H, hd, layer,
        CHUNK_DESIGNS[plan["design"]], plan["block_rows"], plan["split_keys"], plan["n_splits"],
        hd**-0.5, _stream(dev),
    )
    _build.check(lib, rc, "chunk_prefill_attention")
    _build.LAUNCHES["chunk_prefill_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# paged arena ([L, N, K, bs, hd] block pool + [B, MB] block tables)
# ---------------------------------------------------------------------------

def _paged_lib() -> ctypes.CDLL:
    return _build.load("paged_attention", {
        "paged_decode_attention_bf16": ([_VP] * 9 + [_I] * 11 + [_F, _VP], _I),
        "paged_chunk_attention_sm90": ([_VP] * 10 + [_I] * 13 + [_F, _VP], _I),
    })


def _check_tables(what: str, q, block_tables, kv_len, bs: int) -> int:
    """The ``[B, MB]`` tables and ``[B]`` frontiers of a paged call; returns MB."""
    B = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != B or tuple(kv_len.shape) != (B,):
        raise ValueError(f"{what}: tables{tuple(block_tables.shape)} kv_len{tuple(kv_len.shape)} for B={B}")
    for name, t in (("block_tables", block_tables), ("kv_len", kv_len)):
        if t.device != q.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous int32 on {q.device}")
    if bs % 16:
        raise ValueError(f"{what}: block size {bs} must be a multiple of 16")
    return block_tables.shape[1]


def _check_paged(what: str, q, k_arena, v_arena, block_tables, kv_len, layer: int):
    L, N, K, bs, hd = k_arena.shape
    B, S, H, _ = q.shape
    if tuple(v_arena.shape) != tuple(k_arena.shape) or q.shape[3] != hd:
        raise ValueError(f"{what}: q{tuple(q.shape)} arena{tuple(k_arena.shape)} do not match")
    MB = _check_tables(what, q, block_tables, kv_len, bs)
    if not (k_arena.is_contiguous() and v_arena.is_contiguous() and q.is_contiguous()):
        raise ValueError(f"{what}: q and the arenas must be contiguous")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} outside [0, {L})")
    _check_heads(what, H, K, hd)
    _check_bf16(what, q.device, q=q, k_arena=k_arena, v_arena=v_arena)
    return L, N, K, bs, hd, B, S, H, MB


def paged_decode_attention(
    q: torch.Tensor,  # [B, 1, H, hd]
    k_arena: torch.Tensor,  # [L, N, K, bs, hd]
    v_arena: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int32
    kv_len: torch.Tensor,  # [B] int32
    layer: int,
) -> torch.Tensor:
    """One query per row over the row's live blocks ``[0, kv_len)`` of the
    arena at ``layer``; a row with ``kv_len = 0`` gets zeros. Split-KV
    planned from the capacity ``MB * bs`` (no read of ``kv_len``)."""
    if q.device.type == "cpu":
        return paged_decode_attention_xla(q, k_arena, v_arena, block_tables, kv_len, layer)
    _build.check_no_grad("paged_decode_attention", q, k_arena, v_arena)
    if q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention is single-token (got S={q.shape[1]})")
    layer = int(layer)
    L, N, K, bs, hd, B, _, H, MB = _check_paged(
        "paged_decode_attention", q, k_arena, v_arena, block_tables, kv_len, layer
    )
    G = _check_decode_heads("paged_decode_attention", H, K)
    dev = q.device
    # split plan from the host-known capacity MB * bs: no read of kv_len
    plan = decode_launch_plan(B, K, MB * bs, _build.sm_count(dev.index))
    parts, (pm, pl, pa) = _split_parts(B * K, plan["n_splits"], G, hd, dev)
    out = torch.empty_like(q)
    lib = _paged_lib()
    rc = lib.paged_decode_attention_bf16(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), out.data_ptr(),
        block_tables.data_ptr(), kv_len.data_ptr(), pm, pl, pa,
        L, N, B, K, bs, MB, H, hd, layer, plan["split_keys"], plan["n_splits"], hd**-0.5, _stream(dev),
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
    _build.check_no_grad("paged_chunk_attention", q, k_arena, v_arena)
    layer = int(layer)
    L, N, K, bs, hd, B, S, H, MB = _check_paged(
        "paged_chunk_attention", q, k_arena, v_arena, block_tables, kv_len, layer
    )
    if tuple(write_index.shape) != (B,) or write_index.dtype != torch.int32 or write_index.device != q.device:
        raise ValueError("paged_chunk_attention: write_index must be int32 [B] on q's device")
    dev = q.device
    # split plan from the host-known capacity MB * bs: no read of kv_len
    plan = chunk_launch_plan(B, S, H, K, MB * bs, _build.sm_count(dev.index))
    parts, (pm, pl, pa) = _split_parts(B * K, plan["n_splits"], S * (H // K), hd, dev)
    out = torch.empty_like(q)
    lib = _paged_lib()
    rc = lib.paged_chunk_attention_sm90(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), out.data_ptr(),
        block_tables.data_ptr(), kv_len.data_ptr(), write_index.contiguous().data_ptr(), pm, pl, pa,
        L, N, B, K, bs, MB, S, H, hd, layer, plan["block_rows"], plan["split_keys"], plan["n_splits"],
        hd**-0.5, _stream(dev),
    )
    _build.check(lib, rc, "paged_chunk_attention")
    _build.LAUNCHES["paged_chunk_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# int8 cache and arena (csrc/attention_q8.cu)
# ---------------------------------------------------------------------------

def _q8_lib() -> ctypes.CDLL:
    return _build.load("attention_q8", {
        "decode_attention_q8": ([_VP] * 11 + [_I] * 9 + [_F, _VP], _I),
        "chunk_attention_q8": ([_VP] * 12 + [_I] * 11 + [_F, _VP], _I),
        "paged_decode_attention_q8": ([_VP] * 11 + [_I] * 11 + [_F, _VP], _I),
        "paged_chunk_attention_q8": ([_VP] * 12 + [_I] * 13 + [_F, _VP], _I),
    })


def _check_q8(what: str, q, k, v, k_scale, v_scale, layer: int):
    """The int8 payload pair, its fp32 scale planes and the bf16 query:
    shapes, types, contiguity and 16-byte alignment. Returns the payload's
    shape and the query's head count."""
    dev = q.device
    L, n, K, t, hd = k.shape
    if tuple(v.shape) != tuple(k.shape) or q.shape[3] != hd:
        raise ValueError(f"{what}: q{tuple(q.shape)} payload{tuple(k.shape)} v{tuple(v.shape)} do not match")
    for name, x, dt in (("k", k, torch.int8), ("v", v, torch.int8),
                        ("k_scale", k_scale, torch.float32), ("v_scale", v_scale, torch.float32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous, 16-byte aligned {dt} on {dev}")
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(s.shape) != tuple(k.shape[:-1]):
            raise ValueError(f"{what}: {name}{tuple(s.shape)} must be {tuple(k.shape[:-1])}")
    if not q.is_contiguous():
        raise ValueError(f"{what}: q must be contiguous")
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} outside [0, {L})")
    H = q.shape[2]
    _check_heads(what, H, K, hd)
    _check_bf16(what, dev, q=q)
    return L, n, K, t, hd, H


def decode_attention_q8(
    q: torch.Tensor,  # [B, 1, H, hd] bf16
    k_cache: torch.Tensor,  # [L, B, K, T, hd] int8
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # [L, B, K, T] fp32
    v_scale: torch.Tensor,
    kv_start: torch.Tensor,  # [B]
    kv_len: torch.Tensor,  # [B]
    layer: int,
) -> torch.Tensor:
    """Single-token attention over the int8 cache at ``layer``, window
    ``[kv_start, kv_len)``; split-KV as ``decode_launch_plan`` plans it."""
    if q.device.type == "cpu":
        return decode_attention_xla_q8(q, k_cache, v_cache, k_scale, v_scale, kv_start, kv_len, layer)
    _build.check_no_grad("decode_attention_q8", q, k_cache, v_cache, k_scale, v_scale)
    if q.shape[1] != 1:
        raise ValueError(f"decode_attention_q8 is single-token (got S={q.shape[1]})")
    layer = int(layer)
    L, B, K, T, hd, H = _check_q8("decode_attention_q8", q, k_cache, v_cache, k_scale, v_scale, layer)
    if q.shape[0] != B or T % 16:
        raise ValueError(f"decode_attention_q8: q{tuple(q.shape)} against a cache of B={B}, T={T} (T % 16 == 0)")
    G = _check_decode_heads("decode_attention_q8", H, K)
    dev = q.device
    ks, kl = _window(kv_start, B, 0, dev), _window(kv_len, B, T, dev)
    plan = decode_launch_plan(B, K, T, _build.sm_count(dev.index))
    parts, (pm, pl, pa) = _split_parts(B * K, plan["n_splits"], G, hd, dev)
    out = torch.empty_like(q)
    lib = _q8_lib()
    rc = lib.decode_attention_q8(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        out.data_ptr(), ks.data_ptr(), kl.data_ptr(), pm, pl, pa, L, B, K, T, H, hd, layer,
        plan["split_keys"], plan["n_splits"], hd**-0.5, _stream(dev),
    )
    _build.check(lib, rc, "decode_attention_q8")
    _build.LAUNCHES["decode_attention_q8"] += 1
    return out


def chunk_prefill_attention_q8(
    q: torch.Tensor,  # [B, S, H, hd] bf16
    k_cache: torch.Tensor,  # [L, B, K, T, hd] int8
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # [L, B, K, T] fp32
    v_scale: torch.Tensor,
    kv_start: torch.Tensor,
    kv_len: torch.Tensor,
    layer: int,
    write_index,
) -> torch.Tensor:
    """``S`` queries at cache slots ``write_index + t`` over the int8 cache
    at ``layer``, offset-causal; split-KV as ``chunk_launch_plan`` plans it.
    ``write_index`` as ``chunk_prefill_attention`` takes it."""
    if q.device.type == "cpu":
        return chunk_attention_xla_q8(q, k_cache, v_cache, k_scale, v_scale, kv_start, kv_len, layer, write_index)
    _build.check_no_grad("chunk_prefill_attention_q8", q, k_cache, v_cache, k_scale, v_scale)
    layer = int(layer)
    L, B, K, T, hd, H = _check_q8("chunk_prefill_attention_q8", q, k_cache, v_cache, k_scale, v_scale, layer)
    if q.shape[0] != B or T % 4:
        raise ValueError(f"chunk_prefill_attention_q8: q{tuple(q.shape)} against a cache of B={B}, T={T} "
                         "(T % 4 == 0: the scales travel in 16-byte pieces)")
    S = q.shape[1]
    dev = q.device
    ks, kl = _window(kv_start, B, 0, dev), _window(kv_len, B, T, dev)
    wi = _write_slot("chunk_prefill_attention_q8", write_index, dev)
    plan = chunk_launch_plan(B, S, H, K, T, _build.sm_count(dev.index))
    parts, (pm, pl, pa) = _split_parts(B * K, plan["n_splits"], S * (H // K), hd, dev)
    out = torch.empty_like(q)
    lib = _q8_lib()
    rc = lib.chunk_attention_q8(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        out.data_ptr(), ks.data_ptr(), kl.data_ptr(), wi.data_ptr(), pm, pl, pa, L, B, K, T, S, H, hd, layer,
        plan["block_rows"], plan["split_keys"], plan["n_splits"], hd**-0.5, _stream(dev),
    )
    _build.check(lib, rc, "chunk_prefill_attention_q8")
    _build.LAUNCHES["chunk_prefill_attention_q8"] += 1
    return out


def paged_decode_attention_q8(
    q: torch.Tensor,  # [B, 1, H, hd] bf16
    k_arena: torch.Tensor,  # [L, N, K, bs, hd] int8
    v_arena: torch.Tensor,
    k_scale: torch.Tensor,  # [L, N, K, bs] fp32
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int32
    kv_len: torch.Tensor,  # [B] int32
    layer: int,
) -> torch.Tensor:
    """One query per row over the row's live blocks ``[0, kv_len)`` of the
    int8 arena at ``layer``; a row with ``kv_len = 0`` gets zeros. Split-KV
    planned from the capacity ``MB * bs`` (no read of ``kv_len``)."""
    if q.device.type == "cpu":
        return paged_decode_attention_xla_q8(q, k_arena, v_arena, k_scale, v_scale, block_tables, kv_len, layer)
    _build.check_no_grad("paged_decode_attention_q8", q, k_arena, v_arena, k_scale, v_scale)
    if q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention_q8 is single-token (got S={q.shape[1]})")
    layer = int(layer)
    L, N, K, bs, hd, H = _check_q8("paged_decode_attention_q8", q, k_arena, v_arena, k_scale, v_scale, layer)
    MB = _check_tables("paged_decode_attention_q8", q, block_tables, kv_len, bs)
    G = _check_decode_heads("paged_decode_attention_q8", H, K)
    B, dev = q.shape[0], q.device
    # split plan from the host-known capacity MB * bs: no read of kv_len
    plan = decode_launch_plan(B, K, MB * bs, _build.sm_count(dev.index))
    parts, (pm, pl, pa) = _split_parts(B * K, plan["n_splits"], G, hd, dev)
    out = torch.empty_like(q)
    lib = _q8_lib()
    rc = lib.paged_decode_attention_q8(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        out.data_ptr(), block_tables.data_ptr(), kv_len.data_ptr(), pm, pl, pa,
        L, N, B, K, bs, MB, H, hd, layer, plan["split_keys"], plan["n_splits"], hd**-0.5, _stream(dev),
    )
    _build.check(lib, rc, "paged_decode_attention_q8")
    _build.LAUNCHES["paged_decode_attention_q8"] += 1
    return out


def paged_chunk_attention_q8(
    q: torch.Tensor,  # [B, S, H, hd] bf16
    k_arena: torch.Tensor,  # [L, N, K, bs, hd] int8
    v_arena: torch.Tensor,
    k_scale: torch.Tensor,  # [L, N, K, bs] fp32
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int32
    kv_len: torch.Tensor,  # [B] int32
    layer: int,
    write_index: torch.Tensor,  # [B] int32
) -> torch.Tensor:
    """``S`` queries per row at logical slots ``write_index[b] + t`` over
    the row's live blocks of the int8 arena, offset-causal; split-KV planned
    from the capacity ``MB * bs`` (no read of ``kv_len``)."""
    if q.device.type == "cpu":
        return paged_chunk_attention_xla_q8(
            q, k_arena, v_arena, k_scale, v_scale, block_tables, kv_len, layer, write_index
        )
    _build.check_no_grad("paged_chunk_attention_q8", q, k_arena, v_arena, k_scale, v_scale)
    layer = int(layer)
    L, N, K, bs, hd, H = _check_q8("paged_chunk_attention_q8", q, k_arena, v_arena, k_scale, v_scale, layer)
    MB = _check_tables("paged_chunk_attention_q8", q, block_tables, kv_len, bs)
    B, S, dev = q.shape[0], q.shape[1], q.device
    if tuple(write_index.shape) != (B,) or write_index.dtype != torch.int32 or write_index.device != dev:
        raise ValueError("paged_chunk_attention_q8: write_index must be int32 [B] on q's device")
    plan = chunk_launch_plan(B, S, H, K, MB * bs, _build.sm_count(dev.index))
    parts, (pm, pl, pa) = _split_parts(B * K, plan["n_splits"], S * (H // K), hd, dev)
    out = torch.empty_like(q)
    lib = _q8_lib()
    rc = lib.paged_chunk_attention_q8(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        out.data_ptr(), block_tables.data_ptr(), kv_len.data_ptr(), write_index.contiguous().data_ptr(),
        pm, pl, pa, L, N, B, K, bs, MB, S, H, hd, layer, plan["block_rows"], plan["split_keys"],
        plan["n_splits"], hd**-0.5, _stream(dev),
    )
    _build.check(lib, rc, "paged_chunk_attention_q8")
    _build.LAUNCHES["paged_chunk_attention_q8"] += 1
    return out


# ---------------------------------------------------------------------------
# the head-sharded layout of kernels 7-10 on a tp mesh
# ---------------------------------------------------------------------------
_HEADS = (None, None, "tp", None)  # q / output [B, S, H, hd]
_ARENA = (None, None, "tp", None, None)  # arena planes [L, N, K, bs, hd]
_SCALES = (None, None, "tp", None)  # scale planes [L, N, K, bs]
_TABLES = (None, None)  # block tables [B, MB]
_WHOLE = (None,)  # kv_len, layer, write_index


def paged_partition_specs(mode: str, q8: bool = False):
    """``(in_specs, out_spec)`` of the paged kernels on a tp mesh (JAX
    ``paged_partition_specs``): each spec names, per axis of one argument,
    the mesh axis it is split over (``"tp"``) or None. q and the output are
    split by query heads, the arena planes and scales by kv heads (every
    rank holds K/tp heads of every block), and the block tables,
    ``kv_len``, ``layer`` and the chunk path's ``write_index`` are whole on
    every rank (one host allocator per rank serves every shard). ``mode``:
    ``"decode"`` (``q, k, v[, k_scale, v_scale], tables, kv_len, layer``)
    or ``"chunk"`` (the same, then ``write_index``). The continuous engine
    sizes its arena by it (``kv_heads_per_rank``)."""
    planes = (_HEADS, _ARENA, _ARENA) + ((_SCALES, _SCALES) if q8 else ())
    if mode == "decode":
        return planes + (_TABLES, _WHOLE, _WHOLE), _HEADS
    if mode == "chunk":
        return planes + (_TABLES, _WHOLE, _WHOLE, _WHOLE), _HEADS
    raise ValueError(f"paged_partition_specs: unknown mode {mode!r}")


def kv_heads_per_rank(num_kv_heads: int, tp: int) -> int:
    """The kv heads of the arena each rank holds under
    ``paged_partition_specs``: the axis marked ``"tp"`` split evenly."""
    if tp > 1 and num_kv_heads % tp:
        raise ValueError(f"{num_kv_heads} kv heads do not split over tp={tp}")
    return num_kv_heads // tp if tp > 1 else num_kv_heads
