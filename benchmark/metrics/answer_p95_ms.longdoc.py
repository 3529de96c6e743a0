"""answer_p95_ms.longdoc: the tail of a long-document answer (a per-layer
reading: over a window's 16-30 answers in two alternating groups of rows,
its spread across runs is too wide for an end-to-end bound): the 95th
percentile of every answer's latency in the window, from the client's send
to its reply (host clock)."""

from benchmark.window import p95, replies


def read(run):
    v = p95([(r["recv"] - r["send"]) * 1e3 for r in replies(run)])
    return v
