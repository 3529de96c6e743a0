"""Shape-bucketing helpers shared by the decode engine and the encoder runner
(one executable per bucket; requests pad to the next bucket)."""

from __future__ import annotations

from typing import Sequence


def bucket_len(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n, clamping to the largest."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b
