"""decode_attn_roofline: ``decode_attention`` (kernel 3, with its merge
pass) over the traced window: the least time its calls' bytes and FLOPs
need at the H100's peaks, over their device time, in percent."""

from benchmark.attn_calls import roofline


def read(run):
    return roofline(run, "decode_attention")
