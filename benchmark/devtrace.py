"""The device trace of a run, read into numbers: the card's busy time and
idle gaps, the device ops that took the most time, and each hand-written
kernel's events in issue order.

The interval arithmetic (``merged``, ``busy``, ``idle_gaps``) is a frozen
copy of the port's ``tools/trace_summary.py``, and ``KERNEL_NAMES`` of the
map beside its launch counters (``ops/_build.py``), so that later changes
to the program do not move the yardstick. ``MERGE_KERNEL`` adds the split
kernels' merge pass, which takes the KV type of the kernel it follows.
"""

from __future__ import annotations

import bisect
import functools
import re
from typing import Dict, List, Optional, Sequence, Tuple

# wrapper -> (kernel templates, KV type), as a device trace names them
KERNEL_NAMES: Dict[str, Tuple[Tuple[str, ...], str]] = {
    "knn_topk": (("knn_merge_parts",), ""),
    "flash_attention": (("chunk_kernel", "ws_kernel"), "StridedKV"),
    "decode_attention": (("decode_kernel",), "DenseKV"),
    "chunk_prefill_attention": (("chunk_kernel", "ws_kernel"), "DenseKV"),
    "paged_decode_attention": (("decode_kernel",), "PagedKV"),
    "paged_chunk_attention": (("chunk_kernel", "ws_kernel"), "PagedKV"),
    "decode_attention_q8": (("decode_q8_kernel",), "DenseQ8"),
    "chunk_prefill_attention_q8": (("chunk_q8_kernel",), "DenseQ8"),
    "paged_decode_attention_q8": (("decode_q8_kernel",), "PagedQ8"),
    "paged_chunk_attention_q8": (("chunk_q8_kernel",), "PagedQ8"),
}
MERGE_KERNEL = re.compile(r"\bmerge_kernel[<(]")
# the marker a traced run's recorder puts before its first recorded call
# (``torch.cuda._sleep``: ATen's ``spin_kernel``)
MARKER = re.compile(r"\bspin_kernel\b")
_COMPILED = {w: (re.compile(r"\b(%s)[<(]" % "|".join(names)), kv) for w, (names, kv) in KERNEL_NAMES.items()}


@functools.lru_cache(maxsize=None)
def wrapper_of(kernel_name: str) -> Optional[str]:
    """The wrapper whose main kernel ``kernel_name`` is, or None."""
    for wrapper, (pat, kv) in _COMPILED.items():
        if pat.search(kernel_name) and kv in kernel_name:
            return wrapper
    return None


def merged(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside ``[lo, hi]``."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged(intervals))


def idle_gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """``(start, length)`` of each stretch of ``[lo, hi]`` no interval
    covers, longest first."""
    gaps, t = [], lo
    for s, e in merged(intervals):
        if s > t:
            gaps.append((t, min(s, hi) - t))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi - t))
    return sorted((g for g in gaps if g[1] > 0), key=lambda g: -g[1])


class DeviceTrace:
    """The device events of one traced window: ``events`` are ``(name,
    start_s, end_s)`` on the profiler's clock, ``lo`` and ``hi`` the
    window's edges on it."""

    def __init__(self, events: List[Tuple[str, float, float]], lo: float, hi: float):
        self.events = sorted(events, key=lambda e: e[1])
        self.lo, self.hi = lo, hi

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self) -> float:
        return busy([(s, e) for _, s, e in self.events], self.lo, self.hi)

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, s, e in self.events:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def gaps(self, n: int = 10) -> List[List]:
        """The longest idle gaps, each named by the device ops on either
        side of it (what the card last ran and what the host issued next)."""
        iv = [(s, e) for _, s, e in self.events]
        starts = [s for s, _ in iv]
        out = []
        for at, length in idle_gaps(iv, self.lo, self.hi)[:n]:
            j = bisect.bisect_left(starts, at + length - 1e-12)
            prev = self.events[j - 1][0] if j > 0 else "window start"
            nxt = self.events[j][0] if j < len(self.events) else "window end"
            out.append([f"after {_short(prev)} / before {_short(nxt)}", length])
        return out

    def kv_calls(self, kv: str, after_marker: bool = False) -> Optional[List[Tuple[str, float, float]]]:
        """``(wrapper, device start, device seconds)`` of every call of a
        kernel of KV type ``kv``, in issue order, merge passes folded in;
        with ``after_marker`` only those after the first marker (None when
        the trace holds no marker)."""
        events = self.events
        if after_marker:
            at = next((i for i, e in enumerate(events) if MARKER.search(e[0])), None)
            if at is None:
                return None
            events = events[at + 1 :]
        out: List[List] = []
        for name, s, e in events:
            w = wrapper_of(name)
            if w is not None and KERNEL_NAMES[w][1] == kv:
                out.append([w, s, e - s])
            elif MERGE_KERNEL.search(name) and kv in name and out:
                out[-1][2] += e - s
        return [(w, s, t) for w, s, t in out]

def _short(name: str) -> str:
    name = re.sub(r"^void ", "", name)
    return name[:80]
