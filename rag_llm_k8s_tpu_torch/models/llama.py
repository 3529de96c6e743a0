"""Llama-3.x decoder in PyTorch, counterpart of ``rag_llm_k8s_tpu/models/llama.py``.

- One KV cache for the whole stack, head-major ``[L, B, kv_heads, T, hd]``,
  written IN PLACE at ``write_index`` (the JAX package threads it through a
  scan carry; here the forward mutates the tensors it is handed). Prompts
  are left-padded, so every row appends at the same index and the valid keys
  of row ``b`` are the window ``[kv_start[b], kv_len[b])``.
- The dense continuous engine keeps that cache (one row per request) and
  decodes with ``row_frontier=True``: ``write_index`` is a ``[B]`` device
  tensor and row ``b`` writes its token at its own slot
  (``write_row_frontier``).
- The one-shot decode and verify keep their slot on the card too
  (JAX's traced scalar): a ``DeviceSlot`` ``write_index`` makes every row
  write its ``S`` tokens at the slot's ``S`` slots, and the chunk kernels
  read its ``[1]`` int32 slot. The engines' cache slack keeps it in range
  (JAX's k-slack: its ``dynamic_update_slice`` never has to clamp). No host
  read of the slot, so a step never waits on the card. An int
  ``write_index`` (prefill, the chunked prefill's host loop) writes a slice
  and is range-checked on the host.
- Or, for the paged continuous engine, the PAGED arena ``[L, N, kv_heads, bs,
  hd]`` (``make_kv_arena``) with ``block_tables [B, MB]``: rows are
  right-padded, ``write_index`` is a per-row ``[B]`` frontier, and token
  ``t`` of row ``b`` is written at logical position ``write_index[b] + t``,
  i.e. physical block ``block_tables[b, pos // bs]``, slot ``pos % bs``.
  Positions past the table land in the null block 0, which no kernel reads.
- Three attention modes, chosen per call: prefill (``S > 1`` at slot 0,
  attention over the fresh K/V), decode (``S == 1``) and chunk (``S > 1`` at
  ``write_index``, offset causality over the cache; long-prompt chunks and
  the speculative verify). Decode and chunk hand the kernels the whole
  stacked cache plus ``layer``, so no per-layer copy is made.
- bf16 storage and compute with RMSNorm statistics, RoPE phases and logits in
  fp32 (the head projection accumulates in fp32, as the JAX package's
  ``preferred_element_type=float32`` does); Llama-3.1 NTK-by-parts RoPE
  scaling.
- Projections may be fused: q|k|v into ``wqkv`` and gate|up into
  ``w_gateup`` (same bytes, fewer launches per decode step).
- int8 serving (``EngineConfig.weight_quant`` / ``kv_quant``):
  ``quantize_llama`` turns every projection into a ``QuantLinear`` (int8
  weight, fp32 per-output-channel scale) and the head (untied ``lm_head``,
  or the tied embedding) likewise; an int8 cache (``quant="int8"``) stores
  each written K/V vector as int8 plus one fp32 scale
  (``ops.attention.quantize_kv``). Prefill at slot 0 still attends over the
  fresh K/V in the compute dtype: quantization touches only the cache.
- Tensor and sequence parallelism (``mesh``, a ``core.mesh.MeshContext``;
  the JAX package's ``shard_map`` paths): each rank builds the modules at
  its slice's shapes (``parallel.sharding.tp_layout``). wq, wk, wv, w_gate
  and w_up are column-parallel (this rank's output features); wo and
  w_down row-parallel (its input features), followed by an all-reduce over
  tp in the compute dtype; the embedding is vocab-parallel (a masked lookup
  plus an all-reduce) and the head vocab-sharded, its logits all-gathered,
  so sampling reads the whole vocabulary on every rank. The attention
  kernels run per rank on the local heads (H/tp query heads over K/tp kv
  heads, and the cache holds K/tp heads); head counts that do not tile tp
  leave attention replicated. With ``sp > 1`` a single-shot prefill whose
  ``S`` divides over sp attends through ring attention
  (``parallel/ring_attention.py``): every sp rank holds the whole q/k/v,
  takes its ``S/sp`` slice, runs the ring and all-gathers the output. dp
  replicates the computation.
- The attention choice of the single-shot prefill (``attn_impl``, JAX's):
  ``"kernels"`` (the default: ``flash_attention``) or ``"xla"``, its plain
  version ``attention_xla`` (``ops/attention.py``), the differentiable
  forward training runs (``engine/training.py``; the kernels have no
  backward, and on a CUDA tensor that requires grad they raise). The ring
  is plain either way, and the cache paths always take their kernels.
  ``build_llama(..., trainable=True)`` gives the unfused layout with every
  parameter taking a gradient; ``cache=None`` runs the forward without a
  cache (a single-shot prefill over the fresh K/V: JAX's loss throws its
  cache away, so nothing is written), and on a mesh the collectives carry
  the gradient through (``core/mesh.py`` ``region_in`` / ``reduce_out`` /
  ``gather_out``).

Linear weights use PyTorch's ``[out, in]`` layout; ``models/convert.py``
maps the JAX package's ``[in, out]`` kernels onto them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, LlamaConfig
from rag_llm_k8s_tpu_torch.ops.attention import (
    INV_127,
    attention_xla,
    chunk_prefill_attention,
    chunk_prefill_attention_q8,
    decode_attention,
    decode_attention_q8,
    flash_attention,
    paged_chunk_attention,
    paged_chunk_attention_q8,
    paged_decode_attention,
    paged_decode_attention_q8,
    quantize_kv,
    rope_rerotate,
    rope_rerotate_q8,
)
from rag_llm_k8s_tpu_torch.parallel.ring_attention import ring_attention_sharded
from rag_llm_k8s_tpu_torch.parallel.sharding import tp_layout

ATTN_IMPLS = ("kernels", "xla")


@dataclass
class KVCache:
    """``k, v: [L, B, kv_heads, T, head_dim]`` (the arena: ``[L, N,
    kv_heads, bs, head_dim]``), updated in place by the forward. An int8
    cache holds int8 payloads in ``k``/``v`` and one fp32 scale per (token,
    kv head) vector in ``k_scale``/``v_scale`` (the same shape without
    ``head_dim``); ``None`` for a bf16 cache."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def _zeros_cache(shape, dtype: torch.dtype, device: torch.device, quant: str) -> KVCache:
    if quant == "int8":
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        )
    if quant != "bf16":
        raise ValueError(f"kv_quant={quant!r}: expected 'bf16' or 'int8'")
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def make_kv_cache(
    config: LlamaConfig, batch_size: int, max_seq_len: int,
    dtype: torch.dtype, device: torch.device, quant: str = "bf16",
) -> KVCache:
    shape = (config.num_layers, batch_size, config.num_kv_heads, max_seq_len, config.head_dim)
    return _zeros_cache(shape, dtype, device, quant)


def make_kv_arena(
    config: LlamaConfig, num_blocks: int, block_size: int,
    dtype: torch.dtype, device: torch.device, quant: str = "bf16",
) -> KVCache:
    """The paged cache: ``[L, num_blocks, kv_heads, block_size, hd]`` block
    pool (block 0 is the engine's reserved null block). Rows reach their
    blocks through block tables, never by position."""
    shape = (config.num_layers, num_blocks, config.num_kv_heads, block_size, config.head_dim)
    return _zeros_cache(shape, dtype, device, quant)


def _cache_values(cache: KVCache, k: torch.Tensor, v: torch.Tensor):
    """What the cache stores for fresh ``k, v [B, S, K, hd]``: the values in
    the cache dtype, or int8 payloads and their ``[B, S, K]`` scales."""
    if cache.quantized:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        return kq, vq, ks, vs
    return k.to(cache.k.dtype), v.to(cache.v.dtype), None, None


def write_paged(
    cache: KVCache, layer: int, k: torch.Tensor, v: torch.Tensor,
    block_tables: torch.Tensor, write_index: torch.Tensor,
) -> None:
    """Write ``k, v [B, S, K, hd]`` of token ``t`` of row ``b`` at logical
    position ``write_index[b] + t`` through the row's block table, in
    place. Positions past the table go to the null block 0 (never clipped
    into the last logical block, which may hold valid KV)."""
    B, S = k.shape[0], k.shape[1]
    bs, MB = cache.k.shape[3], block_tables.shape[1]
    pos = write_index.to(torch.int64)[:, None] + torch.arange(S, device=k.device)[None, :]
    blk = pos // bs
    phys = torch.gather(block_tables.to(torch.int64), 1, blk.clamp(max=MB - 1))
    phys = torch.where(blk < MB, phys, torch.zeros_like(phys))
    off = pos % bs
    kw, vw, ks, vs = _cache_values(cache, k, v)
    cache.k[layer][phys, :, off] = kw
    cache.v[layer][phys, :, off] = vw
    if cache.quantized:
        cache.k_scale[layer][phys, :, off] = ks
        cache.v_scale[layer][phys, :, off] = vs


def write_row_frontier(cache: KVCache, layer: int, k: torch.Tensor, v: torch.Tensor, write_index) -> None:
    """The row-frontier write over the dense cache (JAX ``row_frontier``):
    row ``b``'s fresh tokens ``k, v [B, S, K, hd]`` (and their scales under
    int8) land at slots ``write_index[b] + t`` of its own row, in place, as
    ``write_paged`` does through the tables. ``write_index`` is a ``[B]``
    device tensor, or a ``DeviceSlot`` whose slots every row shares (the
    one-shot loops: one ``index_copy_`` a plane). It is never read on the
    host, so the write needs no host sync (what capturing a step in a CUDA
    graph needs). (JAX writes a masked full plane because an XLA scatter
    copies the cache; the result is the same.)"""
    kw, vw, ks, vs = _cache_values(cache, k, v)
    planes = ((cache.k, kw), (cache.v, vw)) + (((cache.k_scale, ks), (cache.v_scale, vs)) if cache.quantized else ())
    if isinstance(write_index, DeviceSlot):
        for plane, x in planes:
            plane[layer].index_copy_(2, write_index.slots, x.transpose(1, 2))
        return
    B, S = k.shape[0], k.shape[1]
    wi = write_index.to(torch.int64)[:, None]
    at = (torch.arange(B, device=k.device)[:, None], slice(None),
          wi if S == 1 else wi + torch.arange(S, device=k.device))
    for plane, x in planes:
        plane[layer][at] = x


@dataclass(frozen=True)
class DeviceSlot:
    """A one-shot forward's write slot held on the card: ``index`` the
    ``[1]`` int32 slot of token 0 (the chunk kernels' ``write_index``),
    ``slots`` the ``[S]`` int64 slots ``index + t`` that
    ``write_row_frontier`` writes in every row (``index_copy_`` takes int64
    only). The decode loop builds one and advances both in place each
    step; a verify builds one from its device slot."""

    index: torch.Tensor
    slots: torch.Tensor


def _mm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in fp32: ``torch.mm(...,
    out_dtype=)`` on the card, without an fp32 copy of either operand; on
    the CPU, which lacks that form, the operands upcast (a product of two
    bf16 values is exact in fp32, so both sum the same terms)."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class HeadMatmul(torch.autograd.Function):
    """``h [N, D] @ w [V, D]^T`` in fp32 (``_mm_fp32``) with a gradient,
    which ``torch.mm(..., out_dtype=)`` lacks: the fp32 cotangent rounded
    to the operands' dtype, each product accumulated in fp32 and rounded to
    its operand's dtype."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return _mm_fp32(h, w.t())

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        gh = _mm_fp32(g, w).to(h.dtype) if ctx.needs_input_grad[0] else None
        gw = _mm_fp32(g.t(), h).to(w.dtype) if ctx.needs_input_grad[1] else None
        return gh, gw


def head_logits(
    h: torch.Tensor, head: torch.Tensor, logits_dtype: torch.dtype,
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``h [..., D] @ head [V, D]^T`` accumulated in fp32 (``HeadMatmul``,
    differentiable) and returned in ``logits_dtype``. An int8 head is
    converted to ``h``'s dtype (exact; a transient copy) and its fp32
    per-row ``scale`` multiplies the fp32 logits."""
    head = head.to(h.dtype)
    if h.dtype == logits_dtype:
        out = F.linear(h, head)
    else:
        flat = HeadMatmul.apply(h.reshape(-1, h.shape[-1]), head).to(logits_dtype)
        out = flat.reshape(*h.shape[:-1], head.shape[0])
    return out if scale is None else out * scale.to(out.dtype)


def rope_frequencies(config: LlamaConfig, device: torch.device) -> torch.Tensor:
    """Per-pair inverse frequencies ``[head_dim // 2]`` in fp32, with the
    Llama-3.1 wavelength-dependent rescaling when configured."""
    hd = config.head_dim
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    freqs = 1.0 / torch.pow(torch.tensor(config.rope_theta, dtype=torch.float32, device=device), exps)
    s = config.rope_scaling
    if s is None:
        return freqs
    low_wavelen = s.original_max_position_embeddings / s.low_freq_factor
    high_wavelen = s.original_max_position_embeddings / s.high_freq_factor
    wavelen = 2.0 * math.pi / freqs
    smooth = (s.original_max_position_embeddings / wavelen - s.low_freq_factor) / (
        s.high_freq_factor - s.low_freq_factor
    )
    smooth = smooth.clamp(0.0, 1.0)
    scaled = (1.0 - smooth) * freqs / s.factor + smooth * freqs
    return torch.where(
        wavelen < high_wavelen, freqs,
        torch.where(wavelen > low_wavelen, freqs / s.factor, scaled),
    )


def rope_cos_sin(positions: torch.Tensor, inv_freqs: torch.Tensor):
    """``positions [B, S] -> cos, sin [B, S, head_dim // 2]`` (fp32)."""
    phase = positions.float()[..., None] * inv_freqs[None, None, :]
    return torch.cos(phase), torch.sin(phase)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [B, S, H, hd]`` by halves (dim ``i`` pairs with ``i + hd/2``)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def rerotate_prefix_planes(config: LlamaConfig, planes: Tuple, delta: int) -> Tuple:
    """Position-shift a cached segment-KV plane tuple by ``delta`` tokens
    (JAX ``rerotate_prefix_planes``): K re-rotates by the closed-form RoPE
    delta, V passes through. ``planes`` is ``(k, v)`` with payloads ``[L, 1,
    K, S, hd]``, or the int8 ``(k, v, k_scale, v_scale)`` (scales ``[L, 1,
    K, S]``; dequantize, rotate, requantize). ``delta == 0`` returns
    ``planes`` itself, so a canonical-position hit stays bit-identical."""
    if int(delta) == 0:
        return planes
    inv = rope_frequencies(config, planes[0].device)
    if len(planes) == 4:
        k_q, k_scale = rope_rerotate_q8(planes[0], planes[2], int(delta), inv)
        return (k_q, planes[1], k_scale, planes[3])
    return (rope_rerotate(planes[0], int(delta), inv), planes[1])


def mask_window(pad_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[B, S]`` contiguous 0/1 pad mask → ``(kv_start, kv_len)`` ``[B]``."""
    m = pad_mask.to(torch.int64)
    start = torch.argmax(m, dim=-1)
    return start, start + m.sum(dim=-1)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtypes: DTypePolicy):
        super().__init__()
        self.eps = eps
        self.out_dtype = dtypes.compute_dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtypes.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.weight.float()).to(self.out_dtype)


class QuantLinear(nn.Module):
    """Weight-only int8 linear (JAX ``QuantDense``): ``x @ weight^T`` with
    the int8 ``weight [out, in]`` converted to the compute dtype (exact),
    times the fp32 per-output-channel ``scale [out]``, also converted to
    the compute dtype. On the TPU, XLA fused the conversion into the
    product; here it builds a transient compute-dtype copy of the weight on
    every call, and the scale is one more elementwise launch."""

    def __init__(self, in_features: int, out_features: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.zeros(out_features, in_features, dtype=torch.int8), requires_grad=False)
        self.scale = nn.Parameter(torch.ones(out_features, dtype=torch.float32), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x, self.weight.to(dt)) * self.scale.to(dt)


class QuantEmbedding(nn.Module):
    """The tied int8 embedding (JAX ``embedding_q``/``embedding_scale``):
    gathered int8 rows times their fp32 row scales, both in the compute
    dtype. The same table and scales serve as the int8 head."""

    def __init__(self, num: int, dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.zeros(num, dim, dtype=torch.int8), requires_grad=False)
        self.scale = nn.Parameter(torch.ones(num, dtype=torch.float32), requires_grad=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self.weight[tokens].to(dt) * self.scale[tokens].to(dt)[..., None]


def _linear(i: int, o: int, dtypes: DTypePolicy, quantized: bool = False) -> nn.Module:
    if quantized:
        return QuantLinear(i, o, dtypes.compute_dtype)
    return nn.Linear(i, o, bias=False, dtype=dtypes.param_dtype)


class Attention(nn.Module):
    """``config`` is this rank's slice (``tp_layout(...).local``); with
    ``sharded`` the output of wo is a partial sum, all-reduced over tp.
    ``attn_impl``: the single-shot prefill's attention, ``"kernels"`` or
    ``"xla"`` (``LlamaModel.set_attn_impl``)."""

    def __init__(self, config: LlamaConfig, dtypes: DTypePolicy, fused: bool, quantized: bool = False,
                 mesh=None, sharded: bool = False):
        super().__init__()
        c = config
        self.config, self.dtypes, self.fused = c, dtypes, fused
        self.mesh, self.sharded = mesh, sharded
        self.attn_impl = "kernels"
        H, K, hd, D = c.num_heads, c.num_kv_heads, c.head_dim, c.hidden_size
        if fused:
            self.wqkv = _linear(D, (H + 2 * K) * hd, dtypes, quantized)
        else:
            self.wq = _linear(D, H * hd, dtypes, quantized)
            self.wk = _linear(D, K * hd, dtypes, quantized)
            self.wv = _linear(D, K * hd, dtypes, quantized)
        self.wo = _linear(H * hd, D, dtypes, quantized)

    def forward(
        self, x: torch.Tensor, cache: Optional[KVCache], layer: int, kv_start: torch.Tensor,
        kv_len: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
        write_index, chunked: bool, block_tables: Optional[torch.Tensor] = None,
        row_frontier: bool = False,
    ) -> torch.Tensor:
        c = self.config
        B, S, _ = x.shape
        H, K, hd = c.num_heads, c.num_kv_heads, c.head_dim
        if self.sharded:
            x = self.mesh.region_in(x, "tp")
        if self.fused:
            q, k, v = self.wqkv(x).split([H * hd, K * hd, K * hd], dim=-1)
        else:
            q, k, v = self.wq(x), self.wk(x), self.wv(x)
        q = apply_rope(q.reshape(B, S, H, hd), cos, sin)
        k = apply_rope(k.reshape(B, S, K, hd), cos, sin)
        v = v.reshape(B, S, K, hd)

        if cache is None:
            # no cache (training): the single-shot prefill over the fresh K/V
            if block_tables is not None or row_frontier or chunked or write_index != 0:
                raise ValueError("cache=None is a single-shot prefill at write_index 0")
            return self._out(self._prefill(q, k, v, kv_start, kv_len), B, S)
        if block_tables is not None:
            out = self._attend_paged(q, k, v, cache, layer, kv_start, kv_len, write_index,
                                     chunked, block_tables)
            return self._out(out, B, S)
        if row_frontier:
            # continuous decode over the dense cache: each row writes at its
            # own frontier, then attends over its own [kv_start, kv_len)
            write_row_frontier(cache, layer, k, v, write_index)
            if cache.quantized:
                out = decode_attention_q8(q, cache.k, cache.v, cache.k_scale, cache.v_scale, kv_start, kv_len,
                                          layer)
            else:
                out = decode_attention(q, cache.k, cache.v, kv_start, kv_len, layer)
            return self._out(out, B, S)
        if isinstance(write_index, DeviceSlot):
            # the slot lives on the card: written and read there
            write_row_frontier(cache, layer, k, v, write_index)
            wi = write_index.index
        else:
            T = cache.k.shape[3]
            if write_index < 0 or write_index + S > T:
                raise ValueError(
                    f"cache write [{write_index}, {write_index + S}) outside the {T}-slot cache"
                )
            # in-place write into the one stacked cache
            kw, vw, ks, vs = _cache_values(cache, k, v)
            cache.k[layer, :, :, write_index : write_index + S] = kw.transpose(1, 2)
            cache.v[layer, :, :, write_index : write_index + S] = vw.transpose(1, 2)
            if cache.quantized:
                cache.k_scale[layer, :, :, write_index : write_index + S] = ks.transpose(1, 2)
                cache.v_scale[layer, :, :, write_index : write_index + S] = vs.transpose(1, 2)
            wi = write_index
        if cache.quantized:
            planes = (cache.k, cache.v, cache.k_scale, cache.v_scale)
        if S == 1:
            if cache.quantized:
                out = decode_attention_q8(q, *planes, kv_start, kv_len, layer)
            else:
                out = decode_attention(q, cache.k, cache.v, kv_start, kv_len, layer)
        elif chunked:
            if cache.quantized:
                out = chunk_prefill_attention_q8(q, *planes, kv_start, kv_len, layer, wi)
            else:
                out = chunk_prefill_attention(q, cache.k, cache.v, kv_start, kv_len, layer, wi)
        else:
            if isinstance(write_index, DeviceSlot) or write_index != 0:
                raise ValueError("multi-token calls at write_index > 0 must pass chunked=True")
            out = self._prefill(q, k, v, kv_start, kv_len)
        return self._out(out, B, S)

    def _prefill(self, q, k, v, kv_start, kv_len) -> torch.Tensor:
        """Single-shot prefill: the fresh K/V are the populated prefix."""
        mesh, S = self.mesh, q.shape[1]
        if mesh is not None and mesh.sp > 1 and S % mesh.sp == 0:
            # sequence parallelism: the prefill's attention as the ring
            # over sp (JAX _attend_ring)
            t = torch.arange(S, device=q.device)
            valid = (t[None, :] >= kv_start[:, None]) & (t[None, :] < kv_len[:, None])
            return ring_attention_sharded(mesh, q, k, v, causal=True, kv_valid=valid).to(q.dtype)
        attend = attention_xla if self.attn_impl == "xla" else flash_attention
        return attend(q, k, v, kv_start, kv_len, causal=True)

    def _out(self, out: torch.Tensor, B: int, S: int) -> torch.Tensor:
        """wo over the attention output; a row-parallel partial sum is
        all-reduced over tp in the compute dtype."""
        c = self.config
        y = self.wo(out.to(self.dtypes.compute_dtype).reshape(B, S, c.num_heads * c.head_dim))
        return self.mesh.reduce_out(y, "tp") if self.sharded else y

    @staticmethod
    def _attend_paged(q, k, v, cache, layer, kv_start, kv_len, write_index, chunked, block_tables):
        """Paged arena: write through the tables, then attend. Decode
        (``S == 1``) and chunks read the arena; a whole-prompt prefill at
        ``write_index`` 0 attends over the fresh K/V it just wrote."""
        write_paged(cache, layer, k, v, block_tables, write_index)
        kl = kv_len.to(torch.int32)
        planes = (cache.k, cache.v) + ((cache.k_scale, cache.v_scale) if cache.quantized else ())
        if chunked:
            fn = paged_chunk_attention_q8 if cache.quantized else paged_chunk_attention
            return fn(q, *planes, block_tables, kl, layer, write_index.to(torch.int32))
        if q.shape[1] == 1:
            fn = paged_decode_attention_q8 if cache.quantized else paged_decode_attention
            return fn(q, *planes, block_tables, kl, layer)
        return flash_attention(q, k, v, kv_start, kv_len, causal=True)


class MLP(nn.Module):
    """``config`` is this rank's slice; with ``sharded`` the output of
    w_down is a partial sum, all-reduced over tp."""

    def __init__(self, config: LlamaConfig, dtypes: DTypePolicy, fused: bool, quantized: bool = False,
                 mesh=None, sharded: bool = False):
        super().__init__()
        D, I = config.hidden_size, config.intermediate_size
        self.fused = fused
        self.mesh, self.sharded = mesh, sharded
        if fused:
            self.w_gateup = _linear(D, 2 * I, dtypes, quantized)
        else:
            self.w_gate = _linear(D, I, dtypes, quantized)
            self.w_up = _linear(D, I, dtypes, quantized)
        self.w_down = _linear(I, D, dtypes, quantized)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.sharded:
            x = self.mesh.region_in(x, "tp")
        if self.fused:
            gate, up = self.w_gateup(x).chunk(2, dim=-1)
        else:
            gate, up = self.w_gate(x), self.w_up(x)
        y = self.w_down(F.silu(gate) * up)
        return self.mesh.reduce_out(y, "tp") if self.sharded else y


class Block(nn.Module):
    def __init__(self, config: LlamaConfig, dtypes: DTypePolicy, fused: bool, quantized: bool = False,
                 mesh=None, layout=None):
        super().__init__()
        self.input_norm = RMSNorm(config.hidden_size, config.rms_norm_eps, dtypes)
        self.attn = Attention(config, dtypes, fused, quantized, mesh, layout is not None and layout.attn)
        self.post_attn_norm = RMSNorm(config.hidden_size, config.rms_norm_eps, dtypes)
        self.mlp = MLP(config, dtypes, fused, quantized, mesh, layout is not None and layout.mlp)

    def forward(self, h, cache, layer, kv_start, kv_len, cos, sin, write_index, chunked,
                block_tables=None, row_frontier=False):
        h = h + self.attn(
            self.input_norm(h), cache, layer, kv_start, kv_len, cos, sin, write_index, chunked,
            block_tables, row_frontier,
        )
        return h + self.mlp(self.post_attn_norm(h))


class LlamaModel(nn.Module):
    """``(tokens [B,S], positions [B,S], cache, kv_start [B], kv_len [B],
    write_index)`` → logits ``[B, S or 1, V]`` in the logits dtype.

    - prefill: bucketed ``S``, ``write_index = 0``, ``kv_len = S``;
    - decode: ``S = 1``, ``write_index = t``, ``kv_len = t + 1``;
    - chunk: ``chunked=True``, ``write_index`` = slot of the first token;
    - decode and chunk may take ``write_index`` as a ``DeviceSlot`` on the
      card: the one-shot loops' slot, never read on the host;
    - row-frontier decode (``row_frontier=True``, the dense continuous
      engine): ``S = 1`` and ``write_index`` a ``[B]`` tensor, row ``b``
      writing at its own slot (``write_row_frontier``).

    With ``block_tables`` the cache is the paged arena and ``write_index``
    is a ``[B]`` tensor (see the module docstring); ``logit_index [B]``
    projects only each row's own position (right-padded prompts). The
    head projection accumulates in fp32 (``head_logits``). ``quantized``
    builds the int8 layout (``QuantLinear`` projections and head; a tied
    embedding becomes a ``QuantEmbedding``); ``quantize_llama`` fills it.

    ``mesh`` (a ``core.mesh.MeshContext``) builds this rank's shard:
    ``self.local`` is the config at the slice's shapes (its heads, kv
    heads, MLP width and vocabulary), ``self.layout`` what is sharded; the
    logits come back whole (``[..., V]``) on every rank.

    ``attn_impl`` (``ATTN_IMPLS``; ``set_attn_impl`` changes it): the
    single-shot prefill's attention, ``flash_attention`` or its plain
    version (``"xla"``, differentiable). ``cache``
    may be None: a single-shot prefill at ``write_index`` 0 that writes
    nothing (training).
    """

    def __init__(
        self, config: LlamaConfig, dtypes: DTypePolicy = DTypePolicy(), fused: bool = False,
        quantized: bool = False, mesh=None, attn_impl: str = "kernels",
    ):
        super().__init__()
        c = config
        self.config, self.dtypes, self.fused, self.quantized = c, dtypes, fused, quantized
        self.mesh = mesh
        tp = mesh.tp if mesh is not None else 1
        self.layout = tp_layout(c, tp) if tp > 1 else None
        lc = self.layout.local if self.layout is not None else c
        self.local = lc
        if quantized and c.tie_word_embeddings:
            self.embed = QuantEmbedding(lc.vocab_size, c.hidden_size, dtypes.compute_dtype)
        else:
            self.embed = nn.Embedding(lc.vocab_size, c.hidden_size, dtype=dtypes.param_dtype)
        self.layers = nn.ModuleList(Block(lc, dtypes, fused, quantized, mesh, self.layout)
                                    for _ in range(c.num_layers))
        self.final_norm = RMSNorm(c.hidden_size, c.rms_norm_eps, dtypes)
        if not c.tie_word_embeddings:
            self.lm_head = _linear(c.hidden_size, lc.vocab_size, dtypes, quantized)
        self._inv_freqs: Optional[torch.Tensor] = None
        self.set_attn_impl(attn_impl)

    @property
    def vocab_sharded(self) -> bool:
        return self.layout is not None and self.layout.vocab

    def set_attn_impl(self, attn_impl: str) -> "LlamaModel":
        """Switch every layer's single-shot prefill attention between
        ``flash_attention`` and its plain version (``ATTN_IMPLS``)."""
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r}: expected one of {ATTN_IMPLS}")
        self.attn_impl = attn_impl
        for blk in self.layers:
            blk.attn.attn_impl = attn_impl
        return self

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The token embeddings; vocab-parallel, a masked lookup of this
        rank's rows plus an all-reduce over tp (one term per token is not
        zero, so the sum is exact)."""
        if not self.vocab_sharded:
            return self.embed(tokens)
        V = self.local.vocab_size
        idx = tokens - self.mesh.axis_index("tp") * V
        own = (idx >= 0) & (idx < V)
        e = self.embed(idx.clamp(0, V - 1))
        e = torch.where(own[..., None], e, torch.zeros((), dtype=e.dtype, device=e.device))
        return self.mesh.reduce_out(e.contiguous(), "tp")

    def forward(
        self,
        tokens: torch.Tensor,
        positions: torch.Tensor,
        cache: Optional[KVCache],
        kv_start: torch.Tensor,
        kv_len: torch.Tensor,
        write_index,
        chunked: bool = False,
        last_logit_only: bool = False,
        block_tables: Optional[torch.Tensor] = None,
        logit_index: Optional[torch.Tensor] = None,
        row_frontier: bool = False,
    ) -> torch.Tensor:
        c, dt = self.config, self.dtypes
        h = self._embed(tokens).to(dt.compute_dtype)
        if self._inv_freqs is None or self._inv_freqs.device != h.device:
            self._inv_freqs = rope_frequencies(c, h.device)
        cos, sin = rope_cos_sin(positions, self._inv_freqs)
        if row_frontier and (tokens.shape[1] != 1 or block_tables is not None):
            raise ValueError("row_frontier=True is the dense cache's one-token decode")
        if block_tables is not None or row_frontier or isinstance(write_index, DeviceSlot):
            wi = write_index
        else:
            wi = int(write_index)
        if block_tables is None:
            # the cache kernels take int32 windows: convert once, not per layer
            kv_start, kv_len = kv_start.to(torch.int32), kv_len.to(torch.int32)
        for i, blk in enumerate(self.layers):
            h = blk(h, cache, i, kv_start, kv_len, cos, sin, wi, chunked, block_tables, row_frontier)
        h = self.final_norm(h)
        if logit_index is not None:
            # each row's own last real position (right-padded prompts)
            idx = logit_index.to(torch.int64).clamp(0, h.shape[1] - 1)
            h = torch.gather(h, 1, idx[:, None, None].expand(-1, 1, h.shape[2]))
        elif last_logit_only:
            # only the last position is sampled: skip the [B, S, V] projection
            h = h[:, -1:, :]
        head = self.embed if c.tie_word_embeddings else self.lm_head
        if self.vocab_sharded:
            h = self.mesh.region_in(h, "tp")
        logits = head_logits(h, head.weight, dt.logits_dtype, head.scale if self.quantized else None)
        # vocab-sharded head: every rank gets the whole vocabulary's logits
        return self.mesh.gather_out(logits, dim=-1, axis="tp") if self.vocab_sharded else logits


def build_llama(
    config: LlamaConfig, dtypes: DTypePolicy, device: torch.device, fused: bool = False,
    quantized: bool = False, mesh=None, attn_impl: str = "kernels", trainable: bool = False,
) -> LlamaModel:
    """An uninitialized model on ``device`` (no host-side init pass); fill it
    with ``convert.load_llama`` or ``convert.init_random_`` (bf16 layout).
    With ``mesh``, this rank's shard (``parallel.sharding``). ``trainable``:
    every parameter takes a gradient, in the unfused unquantized layout
    (JAX's canonical one); train it with ``attn_impl="xla"``."""
    if trainable and (fused or quantized):
        raise ValueError("a trainable model keeps the unfused, unquantized layout")
    with torch.device("meta"):
        model = LlamaModel(config, dtypes, fused=fused, quantized=quantized, mesh=mesh, attn_impl=attn_impl)
    model = model.to_empty(device=device)
    return model.requires_grad_(True).train() if trainable else model.requires_grad_(False).eval()


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _concat_linears(*mods: nn.Module) -> nn.Module:
    """One linear whose output rows are the ``mods``' rows in order; int8
    linears keep their per-output-channel scales, which concatenate too."""
    w = torch.cat([m.weight for m in mods], dim=0)
    with torch.device("meta"):
        if isinstance(mods[0], QuantLinear):
            out = QuantLinear(w.shape[1], w.shape[0], mods[0].compute_dtype)
            out.scale = _param(torch.cat([m.scale for m in mods]))
        else:
            out = nn.Linear(w.shape[1], w.shape[0], bias=False)
    out.weight = _param(w)
    return out


@torch.no_grad()
def fuse_projections_(model: LlamaModel) -> LlamaModel:
    """Switch an unfused model to the fused layout in place: ``wq|wk|wv ->
    wqkv`` and ``w_gate|w_up -> w_gateup`` (one concat along the output dim;
    the source weights are released). bf16 or int8."""
    if model.fused:
        return model
    if model.layout is not None:
        raise ValueError("fuse_projections_: a tp-sharded model keeps the unfused layout (its column shards "
                         "of q|k|v and gate|up would not concatenate into the fused weight's shard)")
    for blk in model.layers:
        a, m = blk.attn, blk.mlp
        a.wqkv = _concat_linears(a.wq, a.wk, a.wv)
        del a.wq, a.wk, a.wv
        a.fused = True
        m.w_gateup = _concat_linears(m.w_gate, m.w_up)
        del m.w_gate, m.w_up
        m.fused = True
    model.fused = True
    return model


def quantize_weight(w: torch.Tensor, amax_reduce=None):
    """Symmetric per-output-channel int8 of ``w [out, in]`` (JAX
    ``_quantize_leaf``, as compiled: see ``ops.attention.INV_127``):
    ``scale = max(amax over in / 127, 1e-8)``, ``w / scale`` rounded half
    to even. Returns ``(int8 [out, in], fp32 [out])``. ``amax_reduce``
    completes each row's amax over the other ranks' slices of its input
    features (a row-parallel weight on a tp mesh)."""
    wf = w.float()
    amax = wf.abs().amax(dim=1)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    scale = (amax * INV_127).clamp_min(1e-8)
    return torch.round(wf / scale[:, None]).to(torch.int8), scale


@torch.no_grad()
def quantize_llama(model: LlamaModel) -> LlamaModel:
    """A new ``LlamaModel`` with int8 weights (JAX
    ``quantize_llama_params``): every projection and the untied ``lm_head``
    (or the tied embedding) become int8 with fp32 per-output-channel
    scales; the norms and an untied embedding are the source's own modules,
    shared, not copied. The source model is left as it is. A quantized
    model passes through; either order with ``fuse_projections_`` gives the
    same weights."""
    if model.quantized:
        return model
    c = model.config
    with torch.device("meta"):
        qm = LlamaModel(c, model.dtypes, fused=model.fused, quantized=True, mesh=model.mesh,
                        attn_impl=model.attn_impl)

    def fill(dst: nn.Module, weight: torch.Tensor, amax_reduce=None) -> None:
        w, s = quantize_weight(weight, amax_reduce)
        dst.weight, dst.scale = _param(w), _param(s)

    def row_max(amax: torch.Tensor) -> torch.Tensor:
        return model.mesh.all_reduce(amax.contiguous(), "tp", op="max")

    for qb, sb in zip(qm.layers, model.layers):
        qb.input_norm, qb.post_attn_norm = sb.input_norm, sb.post_attn_norm
        for group in ("attn", "mlp"):
            src = getattr(sb, group)
            for name, lin in getattr(qb, group).named_children():
                # a row-parallel weight's rows are split over tp: their
                # per-output-channel amax is the max over every rank's slice
                row_parallel = src.sharded and name in ("wo", "w_down")
                fill(lin, getattr(src, name).weight, row_max if row_parallel else None)
    qm.final_norm = model.final_norm
    if c.tie_word_embeddings:
        fill(qm.embed, model.embed.weight)
    else:
        qm.embed = model.embed
        fill(qm.lm_head, model.lm_head.weight)
    if any(p.is_meta for p in qm.parameters()):
        raise RuntimeError("quantize_llama left a parameter unfilled")
    return qm.requires_grad_(False).eval()
