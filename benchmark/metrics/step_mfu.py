"""step_mfu: the model FLOPs of the prompt and answer tokens of the
generate calls (``arith.sequence_flops``, padding left out), each call's
counted in the share of its time inside the window
(``window.window_shares``), over the window's length times the H100's bf16
peak, in percent."""

from benchmark import arith
from benchmark.window import window_shares


def read(run):
    shares, span = window_shares(run)
    if not shares or span <= 0:
        return None
    flops = sum(f * arith.sequence_flops(run.model, len(r.prompt), len(r.answer(run.eos)))
                for c, f in shares for r in c.rows)
    return 100.0 * flops / (span * arith.PEAK_BF16_FLOPS)
