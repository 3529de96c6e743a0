"""What a metric reader is handed (``Run``), and the window's edges.

A rate counts the work of the window whole: each generate call's tokens in
the share of the call's time that lies inside the window (its decode steps
each add a token to every live row, so the tokens accrue over the call's
time), over the window's length. A batch cut by an edge then counts for
the part of it that ran inside, not all or nothing. A request is in the
window when its reply came before the window closed.

In a traced run the metrics read from the harness's records (``t_from``
on) start where the traced slice ends, so the profiler's host cost is not
in them: a call counts there from that moment, a request when it was sent
after it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from benchmark.check import Call


@dataclass
class Run:
    cell: str
    model: Dict
    seconds: float
    t_open: float
    t_close: float
    records: List[Dict]
    calls: List[Call]
    trace: Optional[object]
    setup_s: float
    t_from: float
    attn: Optional[list] = None  # the traced slice's recorded attention calls (attn_calls.py)

    def calls_in(self) -> List[Call]:
        """Calls that started at ``t_from`` or later and ended inside the window."""
        return [c for c in self.calls if c.t0 >= self.t_from and c.t1 <= self.t_close]

    @property
    def eos(self) -> List[int]:
        return [int(self.model["eos_token_id"])]


def replies(run: Run) -> List[Dict]:
    """The answers (status 200) whose reply came inside the window."""
    return [r for r in run.records
            if r["status"] == 200 and r["send"] >= run.t_from and run.t_open <= r["recv"] <= run.t_close]


def window_shares(run: Run) -> Tuple[List[Tuple[Call, float]], float]:
    """``([(call, share of its time inside the window)], window length)``
    over ``[t_from, t_close]``."""
    lo, hi = run.t_from, run.t_close
    out = []
    for c in run.calls:
        inside = min(c.t1, hi) - max(c.t0, lo)
        if inside > 0:
            out.append((c, inside / (c.t1 - c.t0)))
    return out, hi - lo


def p95(values: List[float]) -> Optional[float]:
    """The 95th percentile by nearest rank."""
    if not values:
        return None
    v = sorted(values)
    k = max(0, -(-95 * len(v) // 100) - 1)
    return v[k]
