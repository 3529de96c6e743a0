"""Token sampling: greedy and temperature/top-p, counterpart of
``rag_llm_k8s_tpu/engine/sampling.py``.

A categorical draw is ``argmax(logits + gumbel)``, which is how
``jax.random.categorical`` draws. The Gumbel noise comes from an explicit
``torch.Generator`` or from the caller (the parity tests hand in the noise
JAX drew and get the same token). Served sampled streams therefore differ
from the JAX package's for the same seed: the two generators differ.
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
