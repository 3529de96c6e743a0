"""prefill_attn_roofline: the decoder's chunked-prefill attention
(``chunk_prefill_attention``, kernel 4, with its merge pass) over the
traced window: the least time its calls need at the H100's peaks (the
larger of the FLOP and byte bounds), over their device time, in percent.
bge-m3's flash calls are not among them; the decoder prefills a prompt past
the largest bucket, as every prompt of a long-document mix is, in chunks."""

from benchmark.attn_calls import roofline


def read(run):
    return roofline(run, "chunk_prefill_attention")
