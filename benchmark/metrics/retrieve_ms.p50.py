"""retrieve_ms.p50: the median over the window's answers of the service's
own retrieve times, ``timings.tokenize_ms + embed_retrieve_ms`` (host
clock, as the response reports them)."""

import statistics

from benchmark.window import replies


def read(run):
    v = [r["body"]["timings"]["tokenize_ms"] + r["body"]["timings"]["embed_retrieve_ms"] for r in replies(run)
         if "tokenize_ms" in r["body"].get("timings", {})]
    return statistics.median(v) if v else None
