"""answer_tokens_per_s: the answer tokens the generate calls produced in
the window, each call's counted in the share of its time inside the window
(``window.window_shares``), over the window's length (host clock)."""

from benchmark.window import window_shares


def read(run):
    shares, span = window_shares(run)
    if not shares or span <= 0:
        return None
    return sum(f * len(r.answer(run.eos)) for c, f in shares for r in c.rows) / span
