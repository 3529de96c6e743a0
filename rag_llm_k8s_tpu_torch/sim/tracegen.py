"""Seeded synthetic traces: load shapes for the simulator, the port's copy
of ``rag_llm_k8s_tpu/sim/tracegen.py`` (one seed gives the JAX module's
trace, arrival for arrival).

A trace has the schema ``sim/replay.py`` ``extract_trace`` gives a
recording, so ``LockstepDriver``, ``SimEngine`` and ``diff_journals`` read
generated and recorded load alike. What it models, the parts of RAG load
that move capacity numbers:

- **arrivals**: Poisson at ``rate_qps`` with burst episodes (``burst_prob``
  per arrival, the rate times ``burst_factor`` for ``burst_len``
  arrivals), the tail a mean rate hides;
- **sessions**: follow-up turns arrive again with their history folded
  into the prompt (longer prompts deeper in a session);
- **tenant mix**: weighted tenant classes scaling prompt and output budgets;
- **hot-chunk skew**: with ``emit_ids``, prompts are built from chunk-shaped
  token runs drawn Zipf(``zipf_a``) over ``hot_chunks`` distinct chunks;
- **lengths**: lognormal prompt lengths clamped to ``prompt_len_range``,
  uniform output budgets in ``max_new_range``.

One ``random.Random(seed)`` drives everything, so the same seed and knobs
give the same trace. Standard library only.
"""

from __future__ import annotations

import bisect
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

TRACE_SCHEMA_VERSION = 1

DEFAULT_TENANTS: Tuple[Tuple[str, float, float], ...] = (
    # (name, mix weight, budget scale)
    ("free", 0.7, 1.0),
    ("pro", 0.3, 1.6),
)


class _Zipf:
    """Rank-skewed sampler: P(rank r) ∝ 1/(r+1)^a over ``n`` items."""

    def __init__(self, n: int, a: float):
        w = [1.0 / ((r + 1) ** a) for r in range(max(1, int(n)))]
        total = sum(w)
        acc, self.cum = 0.0, []
        for x in w:
            acc += x / total
            self.cum.append(acc)

    def sample(self, rng: random.Random) -> int:
        return bisect.bisect_left(self.cum, rng.random())


def generate(
    n_requests: int,
    seed: int = 0,
    rate_qps: float = 8.0,
    burst_prob: float = 0.05,
    burst_factor: float = 4.0,
    burst_len: int = 8,
    session_prob: float = 0.35,
    session_max_turns: int = 5,
    tenants: Sequence[Tuple[str, float, float]] = DEFAULT_TENANTS,
    prompt_len_lognorm: Tuple[float, float] = (4.6, 0.6),
    prompt_len_range: Tuple[int, int] = (16, 512),
    max_new_range: Tuple[int, int] = (8, 128),
    hot_chunks: int = 64,
    chunk_len: int = 32,
    zipf_a: float = 1.1,
    step_period_s: float = 0.05,
    emit_ids: bool = False,
    rid_base: int = 1,
) -> Dict:
    """A reproducible synthetic trace of ``n_requests`` arrivals. Each
    arrival carries ``t`` (seconds), ``t_step`` (``t`` quantized by
    ``step_period_s`` — the lockstep visibility clock), ``prompt_len``,
    ``max_new``, ``session``, ``tenant``, and (``emit_ids``) the prompt
    token ids themselves, chunk-structured with Zipf-hot chunks."""
    if n_requests <= 0:
        return {"schema_version": TRACE_SCHEMA_VERSION, "arrivals": []}
    rng = random.Random(int(seed))
    zipf = _Zipf(hot_chunks, zipf_a)
    t_names = [t[0] for t in tenants]
    t_weights = [max(0.0, float(t[1])) for t in tenants]
    t_scale = {t[0]: float(t[2]) for t in tenants}
    lo_p, hi_p = int(prompt_len_range[0]), int(prompt_len_range[1])
    lo_m, hi_m = int(max_new_range[0]), int(max_new_range[1])
    mu, sigma = prompt_len_lognorm

    arrivals: List[Dict] = []
    open_sessions: List[Dict] = []
    t = 0.0
    burst_left = 0
    next_session = 1
    for i in range(int(n_requests)):
        rate = rate_qps * (burst_factor if burst_left > 0 else 1.0)
        if burst_left > 0:
            burst_left -= 1
        elif rng.random() < burst_prob:
            burst_left = int(burst_len)
        t += rng.expovariate(max(rate, 1e-9))

        sess: Optional[Dict] = None
        if open_sessions and rng.random() < session_prob:
            sess = rng.choice(open_sessions)
        if sess is None:
            sess = {
                "id": next_session,
                "tenant": rng.choices(t_names, weights=t_weights)[0],
                "turns": 0,
                "history": 0,  # tokens of prior turns folded forward
                "chunks": [],  # the session's retrieved hot-chunk ranks
            }
            next_session += 1
            open_sessions.append(sess)
        scale = t_scale.get(sess["tenant"], 1.0)
        base_len = int(round(math.exp(rng.gauss(mu, sigma)) * scale))
        prompt_len = max(lo_p, min(hi_p, base_len + sess["history"]))
        max_new = rng.randint(lo_m, min(hi_m, max(lo_m, int(hi_m * scale))))
        a: Dict = {
            "rid": rid_base + i,
            "t": round(t, 6),
            "t_step": int(t / max(step_period_s, 1e-9)),
            "prompt_len": prompt_len,
            "max_new": max_new,
            "session": sess["id"],
            "tenant": sess["tenant"],
        }
        if emit_ids:
            want_chunks = max(1, prompt_len // max(1, chunk_len))
            while len(sess["chunks"]) < want_chunks:
                sess["chunks"].append(zipf.sample(rng))
            ids: List[int] = []
            for rank in sess["chunks"][:want_chunks]:
                ids.extend(
                    1000 + rank * chunk_len + j for j in range(chunk_len)
                )
            # per-turn query tail: fresh (cold) tokens after the chunks
            while len(ids) < prompt_len:
                ids.append(100000 + rng.randrange(20000))
            a["ids"] = ids[:prompt_len]
        arrivals.append(a)
        sess["turns"] += 1
        sess["history"] += max_new // 2  # half the answer quoted back
        if sess["turns"] >= session_max_turns:
            open_sessions.remove(sess)
    return {"schema_version": TRACE_SCHEMA_VERSION, "arrivals": arrivals}


def describe(trace: Dict) -> Dict:
    """Shape summary of a trace (generated or extracted): counts, rate,
    prompt/output length quantiles, tenant/session mix — the sanity
    check before a capacity run."""
    arrivals = trace.get("arrivals", [])
    n = len(arrivals)
    if n == 0:
        return {"requests": 0}
    ts = [float(a.get("t", 0.0)) for a in arrivals]
    span = max(ts) - min(ts)
    plens = sorted(int(a.get("prompt_len", 0)) for a in arrivals)
    mnews = sorted(int(a.get("max_new", 0)) for a in arrivals)
    tenants: Dict[str, int] = {}
    sessions = set()
    for a in arrivals:
        if "tenant" in a:
            tenants[a["tenant"]] = tenants.get(a["tenant"], 0) + 1
        if "session" in a:
            sessions.add(a["session"])

    def q(xs: List[int], f: float) -> int:
        return xs[min(len(xs) - 1, int(f * (len(xs) - 1)))]

    return {
        "requests": n,
        "span_s": round(span, 3),
        "rate_qps": round(n / span, 3) if span > 0 else float(n),
        "prompt_len": {"p50": q(plens, 0.5), "p95": q(plens, 0.95),
                       "max": plens[-1]},
        "max_new": {"p50": q(mnews, 0.5), "p95": q(mnews, 0.95)},
        "tenants": tenants,
        "sessions": len(sessions),
    }
