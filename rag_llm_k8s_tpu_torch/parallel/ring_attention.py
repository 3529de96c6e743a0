"""Ring attention over the ``sp`` axis, counterpart of
``rag_llm_k8s_tpu/parallel/ring_attention.py``.

Sequences shard over ``sp``: each rank holds one block of Q/K/V, and the K/V
blocks rotate around the ring (``MeshContext.ring_shift``, JAX's
``ppermute``) while every rank accumulates its queries' attention with an
online softmax: running (max, sum, out) in fp32, renormalized at each
block. The block a rank holds at step ``i`` originated at ``(my - i) % n``,
so its key positions come from that origin, and its validity mask rotates
with it. Rows with no valid key come out as zeros. GQA: K/V may carry fewer
heads; queries group over them.

The JAX body is ``jnp.einsum``, not a Pallas kernel, so the block step here
is plain PyTorch too. It is differentiable, as JAX's is (training over long
sequences, ``engine/training.py``): autograd runs back through the unrolled
ring, each ``ring_shift``'s gradient one hop the other way; in
``ring_attention_sharded`` the slice of the replicated q/k/v gathers the
slices' gradients over sp, and the gathered output's gradient is this
rank's slice (``core/mesh.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _block_attend(q, k, v, bias, scale):
    """One block pair: ``(scores max, exp scores @ v, exp row sums)``.
    ``q [B, Sq, K, G, hd]``, ``k``/``v`` ``[B, Sk, K, hd]``, ``bias [B, 1,
    Sq, Sk]`` additive; all accumulation fp32."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())
    s = s * scale + bias[:, :, None, :, :]  # [B, K, G, Sq, Sk]
    m = s.amax(dim=-1)
    # masked entries sit at <= NEG_INF/2 even after the score add; zero them
    # explicitly so fully masked rows accumulate l = 0 (zeros, not mean(V))
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return m, o, l


def ring_attention(
    q: torch.Tensor,  # [B, Sq_local, H, hd]   this rank's block
    k: torch.Tensor,  # [B, Sk_local, K, hd]
    v: torch.Tensor,  # [B, Sk_local, K, hd]
    ctx,
    axis: str = "sp",
    causal: bool = True,
    kv_valid: Optional[torch.Tensor] = None,  # [B, Sk_local] bool (local block)
) -> torch.Tensor:
    """Distributed attention over ``axis``; every rank of the axis calls
    it with its block. Returns fp32 ``[B, Sq_local, H, hd]``."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    n = ctx.axis_size(axis)
    my = ctx.axis_index(axis)
    scale = hd ** -0.5
    dev = q.device
    qg = q.reshape(B, Sq, K, G, hd)
    q_pos = my * Sq + torch.arange(Sq, device=dev)
    valid = torch.ones((B, Sk), dtype=torch.bool, device=dev) if kv_valid is None else kv_valid.bool()

    def bias(valid_blk, src):
        k_pos = src * Sk + torch.arange(Sk, device=dev)
        ok = valid_blk[:, None, :].expand(B, Sq, Sk)
        if causal:
            ok = ok & (k_pos[None, None, :] <= q_pos[None, :, None])
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return torch.where(ok, zero, torch.full_like(zero, NEG_INF))[:, None]

    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=dev)
    o = torch.zeros((B, Sq, K, G, hd), dtype=torch.float32, device=dev)
    k_blk, v_blk, valid_blk = k, v, valid
    for i in range(n):
        src = (my - i) % n  # global block index of the k/v slice held now
        bm, bo, bl = _block_attend(qg, k_blk, v_blk, bias(valid_blk, src), scale)
        new_m = torch.maximum(m, bm)
        # renormalize both accumulators onto the new running max
        alpha = torch.exp(m - new_m)
        beta = torch.exp(bm - new_m)
        l = l * alpha + bl * beta
        o = o * alpha.permute(0, 3, 1, 2)[..., None] + bo * beta.permute(0, 3, 1, 2)[..., None]
        m = new_m
        if i < n - 1:
            # rotate k/v and their validity one hop around the ring (JAX
            # rotates once more after the last block; nothing reads it)
            k_blk, v_blk, valid_blk = ctx.ring_shift((k_blk, v_blk, valid_blk), axis)
    # rows with no valid key (fully masked) produce l = 0: zeros, not NaN
    safe_l = l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return (o / safe_l).reshape(B, Sq, H, hd)


def ring_attention_sharded(
    ctx,
    q: torch.Tensor,  # [B, S, H, hd]: the whole arrays, on every rank
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """What JAX's ``shard_map`` wrapper computes: each sp rank takes its
    ``S / sp`` slice of the sequence, runs the ring, and the output is
    all-gathered over sp. Returns fp32 ``[B, S, H, hd]`` on every rank."""
    n = ctx.sp
    if kv_valid is None:
        kv_valid = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    S = q.shape[1]
    if S % n:
        raise ValueError(f"ring_attention_sharded: S={S} does not divide over sp={n}")
    c = S // n
    sl = slice(ctx.axis_index("sp") * c, (ctx.axis_index("sp") + 1) * c)
    ql, kl, vl = ctx.split_in((q, k, v), dim=1, axis="sp")
    out = ring_attention(ql, kl, vl, ctx, "sp", causal, kv_valid[:, sl])
    return ctx.gather_out(out, dim=1, axis="sp")
