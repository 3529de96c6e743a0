"""Read a ``torch.profiler`` Chrome trace of a served request (``POST /profile``).

The trace holds, on one clock in microseconds: the CPU ops and the
``record_function`` ranges of the capturing thread (``cat`` ``cpu_op`` and
``user_annotation``; the service's spans and, on the fused path, the engine's
``decode_forward``/``verify_forward`` ranges are among them), and every
thread's CUDA runtime calls (``cuda_runtime``, each with a ``correlation``
id) and kernels (``kernel``, with the ``correlation`` of the launch that
issued them).

``summarize`` turns one into what ``PERF.md`` records of a request:

- the kernel launches per wrapper of ``ops/``, counted from the kernel names
  (``wrapper_launches``: each wrapper call issues exactly one kernel that
  ``ops._build.KERNEL_NAMES`` names), to hold against ``ops._build.LAUNCHES``;
- the card's busy share over a window: the union of the kernel intervals over
  the window's length;
- one forward's host issue time (its range's length) and busy share (the
  union of the kernels it launched over the time from the range's start to
  its last kernel's end);
- the device ops that took the most time, and the longest idle gaps with the
  innermost CPU op or range that encloses each.

Pure Python over the parsed JSON, so it runs (and is tested) on any host.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from rag_llm_k8s_tpu_torch.ops._build import KERNEL_NAMES

# wrapper -> (kernel-name pattern, KV type), from the map beside the launch
# counters
_COMPILED = {
    w: (re.compile(r"\b(%s)[<(]" % "|".join(names)), kv) for w, (names, kv) in KERNEL_NAMES.items()
}


def events(trace: Dict, cat: str) -> List[Dict]:
    """The complete (``ph == "X"``) events of one category."""
    return [e for e in trace.get("traceEvents", ()) if e.get("ph") == "X" and e.get("cat") == cat]


def wrapper_of(kernel_name: str) -> Optional[str]:
    """The ``ops/`` wrapper whose one kernel ``kernel_name`` is, or None."""
    for wrapper, (pat, kv) in _COMPILED.items():
        if pat.search(kernel_name) and kv in kernel_name:
            return wrapper
    return None


def wrapper_launches(kernels: Sequence[Dict]) -> Dict[str, int]:
    out = {w: 0 for w in KERNEL_NAMES}
    for k in kernels:
        w = wrapper_of(k["name"])
        if w is not None:
            out[w] += 1
    return out


def merged(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside ``[lo, hi]``."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged(intervals))


def idle_gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """``(start, length)`` of every stretch of ``[lo, hi]`` no interval covers,
    longest first."""
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


def enclosing(host: Sequence[Dict], start: float, length: float) -> Optional[str]:
    """The innermost host event (CPU op or range) spanning ``[start, start +
    length]``, as ``"name (cat)"``."""
    best = None
    for e in host:
        if e["ts"] <= start and e["ts"] + e["dur"] >= start + length:
            if best is None or e["dur"] < best["dur"]:
                best = e
    return None if best is None else f"{best['name']} ({best['cat']})"


def forward(trace: Dict, range_name: str, index: int = -1) -> Optional[Dict]:
    """One ``record_function`` range's host issue time and its kernels' busy
    time and share: the kernels are those whose launches (by correlation id) fall in
    the range on its thread; the window runs from the range's start to the
    last such kernel's end. ``index`` picks the occurrence (default: the
    last, a warm one)."""
    ranges = [e for e in events(trace, "user_annotation") if e["name"] == range_name]
    if not ranges:
        return None
    r = sorted(ranges, key=lambda e: e["ts"])[index]
    t0, t1 = r["ts"], r["ts"] + r["dur"]
    corr = {
        e["args"]["correlation"] for e in events(trace, "cuda_runtime")
        if e.get("tid") == r.get("tid") and t0 <= e["ts"] <= t1 and "correlation" in e.get("args", {})
    }
    ks = [(k["ts"], k["ts"] + k["dur"]) for k in events(trace, "kernel")
          if k.get("args", {}).get("correlation") in corr]
    if not ks:
        return {"host_issue_us": r["dur"], "kernels": 0, "busy_share": None}
    end = max(e for _, e in ks)
    busy = busy_us(ks, t0, end)
    return {
        "host_issue_us": r["dur"], "kernels": len(ks), "window_us": end - t0,
        "busy_us": busy, "busy_share": busy / (end - t0),
    }


def summarize(trace: Dict, lo: Optional[float] = None, hi: Optional[float] = None,
              n_ops: int = 10, n_gaps: int = 5) -> Dict:
    """The request's numbers over ``[lo, hi]`` (default: the first kernel's
    start to the last kernel's end)."""
    kernels = events(trace, "kernel")
    iv = [(k["ts"], k["ts"] + k["dur"]) for k in kernels]
    if lo is None:
        lo = min((s for s, _ in iv), default=0.0)
    if hi is None:
        hi = max((e for _, e in iv), default=lo)
    inside = [k for k in kernels if k["ts"] < hi and k["ts"] + k["dur"] > lo]
    by_name: Dict[str, List[float]] = {}
    for k in inside:
        by_name.setdefault(k["name"], []).append(k["dur"])
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:n_ops]
    host = events(trace, "cpu_op") + events(trace, "user_annotation")
    span = max(hi - lo, 1e-9)
    return {
        "window_us": hi - lo,
        "kernels": len(inside),
        "busy_us": busy_us(iv, lo, hi),
        "busy_share": busy_us(iv, lo, hi) / span,
        "wrapper_launches": wrapper_launches(inside),
        "top_ops": [{"name": n[:120], "calls": len(d), "us": sum(d)} for n, d in top],
        "gaps": [{"at_us": s - lo, "us": g, "inside": enclosing(host, s, g)}
                 for s, g in idle_gaps(iv, lo, hi)[:n_gaps]],
    }
