"""Token sampling: greedy and temperature/top-p, counterpart of
``rag_llm_k8s_tpu/engine/sampling.py``.

A categorical draw is ``argmax(logits + gumbel)``, which is how
``jax.random.categorical`` draws. The Gumbel noise comes from an explicit
``torch.Generator``, from the caller (the parity tests hand in the noise
JAX drew and get the same token) or, for the continuous engine, from a
counter-based hash of each row's ``(seed, position)``. Served sampled
streams therefore differ from the JAX package's for the same seed: the
generators differ.
"""

from __future__ import annotations

from typing import Optional

import torch

from rag_llm_k8s_tpu_torch.core.config import SamplingConfig

NEG_INF = -1e9


def top_p_filter(logits: torch.Tensor, top_p: float, iters: int = 30) -> torch.Tensor:
    """Mask logits outside the nucleus, sort-free: bisect the probability
    threshold ``t`` such that the mass of ``{p > t}`` still reaches ``top_p``.
    Keeps every token tied at the boundary; the argmax always survives."""
    probs = torch.softmax(logits, dim=-1)
    pmax = probs.max(dim=-1, keepdim=True).values
    lo = torch.zeros_like(pmax)
    hi = pmax
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        mass = torch.where(probs > mid, probs, torch.zeros_like(probs)).sum(dim=-1, keepdim=True)
        ge = mass >= top_p
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    keep = (probs > lo) | (probs >= pmax)
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def prepared_logits(logits: torch.Tensor, sampling: SamplingConfig) -> Optional[torch.Tensor]:
    """``None`` means greedy; otherwise the temperature-scaled,
    nucleus-filtered logits to draw from."""
    if not sampling.do_sample or sampling.temperature <= 0.0:
        return None
    scaled = logits / sampling.temperature
    if sampling.top_p < 1.0:
        scaled = top_p_filter(scaled, sampling.top_p)
    return scaled


def gumbel_noise(shape, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """Standard Gumbel draws, ``-log(-log(u))`` with ``u`` in ``[tiny, 1)``."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def categorical(
    logits: torch.Tensor, generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One draw per row of ``logits [..., V]``."""
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(gumbel + logits, dim=-1)


def sample_token(
    logits: torch.Tensor,  # [B, V] fp32
    sampling: SamplingConfig,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One sampling step → token ids ``[B]`` (int64)."""
    scaled = prepared_logits(logits, sampling)
    if scaled is None:
        return torch.argmax(logits, dim=-1)
    return categorical(scaled, generator, gumbel)


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche hash on int64 tensors holding values below 2**32.
    The multipliers are odd and below 2**31, so no product overflows int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x68E31DA5) & _M32
    return x ^ (x >> 16)


def keyed_gumbel(seeds: torch.Tensor, positions: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gumbel noise ``[B, vocab]`` that is a pure function of each row's
    ``(seed, position)`` and the token id: a counter-based hash in plain
    tensor ops, so it runs where the logits are, with no generator state
    and no host sync. ``seeds`` are non-negative ints below 2**62."""
    s = seeds.to(torch.int64)
    key = _mix32((s & _M32) ^ 0x3C6EF372)
    key = _mix32(key ^ _mix32(((s >> 32) & _M32) ^ 0x1B873593))
    key = _mix32(key ^ (positions.to(torch.int64) & _M32))
    ids = _mix32(torch.arange(vocab, device=seeds.device, dtype=torch.int64) ^ 0x5BD1E995)
    h = _mix32(_mix32(key[:, None] ^ ids[None, :]) ^ 0x27D4EB2F)
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # in (0, 1)
    return -torch.log(-torch.log(u))


def sample_token_per_row(
    logits: torch.Tensor,  # [B, V] fp32
    greedy: torch.Tensor,  # [B] bool
    temperature: torch.Tensor,  # [B] (1 on greedy rows)
    top_p: torch.Tensor,  # [B]
    seeds: torch.Tensor,  # [B] int
    positions: torch.Tensor,  # [B] int: position of the token being drawn
) -> torch.Tensor:
    """One draw per row with the row's own sampling settings, keyed by its
    ``(seed, position)`` only (counterpart of the JAX package's
    ``sample_token_per_row``): a request samples the same stream alone or
    beside others, whatever window shape produced its logits. Each row
    computes what ``sample_token`` computes for its settings."""
    scaled = logits / temperature[:, None]
    scaled = torch.where((top_p < 1.0)[:, None], top_p_filter(scaled, top_p[:, None]), scaled)
    drawn = categorical(scaled, gumbel=keyed_gumbel(seeds, positions, logits.shape[-1]))
    return torch.where(greedy, torch.argmax(logits, dim=-1), drawn)


# ---------------------------------------------------------------------------
# the speculative verify's acceptance (paged draft-and-verify)
# ---------------------------------------------------------------------------


def sample_targets_per_row(
    logits: torch.Tensor,  # [B, S, V] fp32: one plane per fed token
    greedy: torch.Tensor,  # [B] bool
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    seeds: torch.Tensor,  # [B] int
    positions: torch.Tensor,  # [B, S] int: position of the token plane j draws
) -> torch.Tensor:
    """The verify window's TARGET tokens ``[B, S]`` (JAX
    ``sample_targets_per_row``): plane ``j`` of row ``b`` is the row's own
    ``sample_token_per_row`` draw at ``positions[b, j]``, the same call a
    plain window makes for that position, so a seeded verify stream equals
    the plain stream by construction."""
    B, S, V = logits.shape
    flat = sample_token_per_row(
        logits.reshape(B * S, V), greedy.repeat_interleave(S), temperature.repeat_interleave(S),
        top_p.repeat_interleave(S), seeds.repeat_interleave(S), positions.reshape(B * S),
    )
    return flat.reshape(B, S)


def accept_drafts(
    drafts: torch.Tensor,  # [B, K] proposed continuations
    targets: torch.Tensor,  # [B, K + 1] the model's own token per plane
    n_drafts: torch.Tensor,  # [B] real drafts per row (<= K)
):
    """Per-row longest-prefix acceptance (JAX ``accept_drafts``): row ``b``
    accepts drafts while they equal its targets (and stay within its own
    ``n_drafts``), then emits the target at the first mismatch (the
    correction, or on full acceptance the bonus target of the last plane).
    Returns ``(m [B], emitted [B, K + 1])``: planes ``0..m`` are the row's
    emitted tokens, the planes past ``m`` junk the host never reads. No
    branch and no host sync."""
    B, K = drafts.shape
    j = torch.arange(K, device=drafts.device)[None, :]
    ok = (drafts == targets[:, :K]) & (j < n_drafts[:, None])
    m = torch.cumprod(ok.to(torch.int64), dim=1).sum(dim=1)  # [B] in [0, n_drafts]
    jj = torch.arange(K + 1, device=drafts.device)[None, :]
    ext = torch.cat([drafts, torch.zeros((B, 1), dtype=drafts.dtype, device=drafts.device)], dim=1)
    corr = torch.gather(targets, 1, m[:, None])  # [B, 1]
    return m, torch.where(jj == m[:, None], corr.to(ext.dtype), ext)
