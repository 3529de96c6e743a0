"""The traffic generator reproduces from the seed and gives every seed the
same sizes."""

import pytest

from benchmark import traffic
from benchmark.reference.tokenize import PlainBPE


@pytest.mark.parametrize("name", ["rag.c16", "longdoc.c8"])
def test_same_seed_same_traffic(name):
    mix = traffic.Mix.load(name)
    small = traffic.Mix.from_dict({**mix.__dict__, "loop": "closed",
                                   "index": {"chunks": 64, "chunk_words": mix.chunk_words,
                                             "chunks_per_doc": mix.chunks_per_doc},
                                   "rounds": list(mix.rounds)})
    seed = 2**31 + 12345
    assert traffic.questions(mix, seed) == traffic.questions(mix, seed)
    assert traffic.chunk_metadata(small, seed) == traffic.chunk_metadata(small, seed)
    assert traffic.questions(mix, seed) != traffic.questions(mix, seed + 1)


@pytest.mark.parametrize("name", ["rag.c16", "longdoc.c8"])
def test_every_seed_sends_the_same_sizes(name):
    mix = traffic.Mix.load(name)

    def sizes(seed):
        return [sorted(len(q[r].split()) for q in traffic.questions(mix, seed)) for r in range(mix.requests_per_client)]

    assert sizes(1) == sizes(2**31 + 7)


def test_rows_name_their_chunks():
    mix = traffic.Mix.load("rag.c16")
    small = traffic.Mix.from_dict({"name": "t", "loop": "closed", "clients": 1, "rounds": [{"question_words": 8}],
                                   "requests_per_client": 1,
                                   "index": {"chunks": 100, "chunk_words": 5, "chunks_per_doc": 16}})
    for i, m in enumerate(traffic.chunk_metadata(small, 3)):
        assert traffic.row_of(m["filename"], m["chunk_id"], small) == i
        assert len(m["text"].split()) == 5
    assert mix.chunks == 65536


def test_rag_prompts_fall_in_their_bands():
    """Questions of 8 to 40 words; every prompt (three chunks of the mix's
    size) inside the 1,024 bucket; the shorter rounds' tails under the
    fused single-fetch path's 128 tokens, so a lone request takes that
    path, and the longer rounds' over it."""
    from benchmark.reference import assemble

    mix = traffic.Mix.load("rag.c16")
    bpe = PlainBPE()
    head = len(assemble.head_ids(bpe, 1))
    metas = traffic.chunk_metadata(traffic.Mix.from_dict({**mix.__dict__, "loop": "closed", "rounds": list(mix.rounds),
                                                          "index": {"chunks": 300, "chunk_words": mix.chunk_words,
                                                                    "chunks_per_doc": 16}}), 5)
    segs = sorted(len(assemble.segment_ids(bpe, m, 4096)) for m in metas)
    qs = traffic.questions(mix, 5)
    short = long = 0
    for r in range(len(mix.rounds)):
        words = [len(q[r].split()) for q in qs]
        assert 8 <= min(words) and max(words) <= 40
        tails = [len(assemble.tail_ids(bpe, q[r])) for q in qs]
        assert head + sum(segs[-3:]) + max(tails) <= 1024
        short += max(tails) < 128
        long += min(tails) > 128
    assert short >= 1 and long >= 2
