"""The continuous scheduler's decision core as pure functions, the port's
own copy of ``rag_llm_k8s_tpu/sim/policy.py`` (the parts the paged
continuous engine runs). Standard library only (and the port's stdlib-only
``utils.buckets``): block arithmetic,
admission verdicts, prefill grouping, window growth, the registration
reclaim order, preemption order,
the mixed-window budget split and the resubmission rule.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from rag_llm_k8s_tpu_torch.utils.buckets import bucket_len  # noqa: F401  (the prompt-shape ladder)


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks covering ``tokens`` KV positions (ceil; 0 for 0)."""
    return max(0, -(-int(tokens) // int(block_size)))


def admission_blocks(prompt_len: int, block_size: int) -> int:
    """Admission-time block cost of a prompt (at least one token)."""
    return blocks_for(max(int(prompt_len), 1), block_size)


def window_blocks(kv_ub: int, horizon: int, block_size: int, max_blocks_per_row: int) -> int:
    """Blocks a row must have mapped before a window that writes
    ``horizon`` positions past ``kv_ub``, capped at the table size."""
    return min(blocks_for(int(kv_ub) + int(horizon), block_size), int(max_blocks_per_row))


def admission_verdict(
    need: int, usable: int, interleave_on: bool, max_blocks_per_row: int
) -> Tuple[str, int]:
    """``("never", 0)`` when the prompt alone outsizes the pool, ``("ok",
    0)`` for interleaved admission (blocks come per chunk), else
    ``("check", want)``: the caller must find ``want`` free blocks, the
    prompt's plus one of headroom for the first decode window, capped at
    the table size."""
    if need > usable:
        return "never", 0
    if interleave_on:
        return "ok", 0
    return "check", min(int(need) + 1, int(max_blocks_per_row))


def clamp_max_new(max_new: int, bucket: int, max_seq_len: int) -> int:
    """A request's budget clamped to the slot room past its bucket."""
    return max(1, min(int(max_new), int(max_seq_len) - int(bucket)))


def admission_chunks(
    bucketed: Sequence[Tuple[int, int]], max_batch: int
) -> List[Tuple[int, List[int]]]:
    """Same-bucket admissions grouped into power-of-two prefill chunks, in
    arrival order. ``bucketed`` is ``(item_index, bucket)`` per request;
    returns ``(bucket, [item_index, ...])`` chunks in execution order."""
    by_bucket: Dict[int, List[int]] = {}
    for idx, s in bucketed:
        by_bucket.setdefault(int(s), []).append(idx)
    chunks: List[Tuple[int, List[int]]] = []
    for s, group in by_bucket.items():
        pos = 0
        while pos < len(group):
            n = 1
            while n * 2 <= min(len(group) - pos, int(max_batch)):
                n *= 2
            chunks.append((s, group[pos:pos + n]))
            pos += n
    return chunks


def grow_shortfall(
    rows: Iterable[Tuple[int, int, int, int]],  # (admit_seq, row, kv_ub, have)
    default_horizon: int,
    horizon: Optional[Dict[int, int]],
    block_size: int,
    max_blocks_per_row: int,
) -> List[Tuple[int, int, int, int]]:
    """Active rows that must grow before the next window, oldest admission
    first: ``(admit_seq, row, missing, have)``. Rows absent from an
    explicit ``horizon`` map default to one position."""
    short: List[Tuple[int, int, int, int]] = []
    for admit_seq, row, kv_ub, have in rows:
        h = default_horizon if horizon is None else horizon.get(row, 1)
        need_total = window_blocks(kv_ub, h, block_size, max_blocks_per_row)
        if need_total > have:
            short.append((admit_seq, row, need_total - have, have))
    short.sort()
    return short


def reclaim_registration(prefix_keys: Iterable, tier_of: Dict, gen_of: Dict):
    """Growth-pressure registration victim: non-hot before hot (a warm
    chain costs one re-scatter to bring back, a hot one a proven-shared
    re-stage), the oldest registration generation first within a tier;
    None when there is none."""
    keys = list(prefix_keys)
    if not keys:
        return None
    return min(keys, key=lambda k: (tier_of.get(k, "hot") == "hot", gen_of.get(k, 0)))


def preempt_victim(active: Iterable[Tuple[int, int]]) -> Tuple[int, int]:
    """The newest-admitted active ``(admit_seq, row)``: its tokens go back
    to the scheduler, which resubmits once blocks free."""
    return sorted(active)[-1]


def plan_mixed_window(
    admissions: Sequence[Tuple[int, int, int]],  # (rid, prompt_len, progress)
    window_budget: int,
    n_decode: int,
    chunk_tokens: int,
) -> List[Tuple[int, int, int, bool]]:
    """Budget split of one mixed window: each decode lane costs one token,
    the rest slices pending admissions oldest first, at most
    ``chunk_tokens`` each. Returns ``(rid, offset, take, final)``."""
    remaining = max(0, int(window_budget) - int(n_decode))
    sched: List[Tuple[int, int, int, bool]] = []
    for rid, prompt_len, progress in admissions:
        if remaining <= 0:
            break
        left = int(prompt_len) - int(progress)
        take = min(int(chunk_tokens), remaining, left)
        if take <= 0:
            continue
        sched.append((rid, int(progress), take, progress + take >= prompt_len))
        remaining -= take
    return sched


def resume_fits(prompt_len: int, n_emitted: int, max_bucket: int) -> bool:
    """Whether a preempted request may resume from prompt + emitted: past
    the largest bucket admission would left-truncate the context, and a
    restart from scratch is the exact choice."""
    return n_emitted > 0 and prompt_len + n_emitted <= max_bucket
