"""answer_p95_ms.rag: the tail of a RAG answer, where the host paces it (a
per-layer reading in the cells whose batches are full): the 95th percentile
of every answer's latency in the window, from the client's send to its
reply (host clock)."""

from benchmark.window import p95, replies


def read(run):
    v = p95([(r["recv"] - r["send"]) * 1e3 for r in replies(run)])
    return v
