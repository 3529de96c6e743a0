"""The FLOP and byte counters against shapes worked by hand."""

import pytest

from benchmark import arith

NEMO = {"hidden_size": 5120, "intermediate_size": 14336, "num_hidden_layers": 40, "num_attention_heads": 32,
        "num_key_value_heads": 8, "head_dim": 128, "vocab_size": 131072}
M7 = {"hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
      "num_key_value_heads": 8, "vocab_size": 32768}


@pytest.mark.parametrize("cfg, per_layer", [
    # 2 * (D * 6144 + 4096 * D + 3 * D * 14336)
    (NEMO, 2 * (5120 * 6144 + 4096 * 5120 + 3 * 5120 * 14336)),
    (M7, 2 * (4096 * 6144 + 4096 * 4096 + 3 * 4096 * 14336)),
])
def test_layer_matmul_flops(cfg, per_layer):
    assert arith.layer_matmul_flops_per_token(cfg) == per_layer


def test_sequence_flops_by_hand():
    # a 3-token prompt and 2 answer tokens: 5 tokens through every layer,
    # keys attended 1 + 2 + 3 + 4 + 5 = 15, the head for the 2 answers
    per_tok = 40 * arith.layer_matmul_flops_per_token(NEMO)
    attn = 40 * 4 * 32 * 128 * 15
    head = 2 * 5120 * 131072 * 2
    assert arith.sequence_flops(NEMO, 3, 2) == 5 * per_tok + attn + head


def test_decode_attention_cost_by_hand():
    # two rows over 100 and 300 keys: 4 * 32 * 128 FLOPs a key; q and out
    # rows (2 x 32 x 128 each), K and V rows of 8 heads x 128 per key, bf16
    flops, nbytes = arith.decode_attention_cost(NEMO, [100, 300])
    assert flops == 4 * 32 * 128 * 400
    assert nbytes == 2 * (2 * 2 * 32 * 128 + 2 * 8 * 128 * 400)


def test_chunk_attention_cost_by_hand():
    # one row whose prompt starts at 2, window [0, 4): queries 2 and 3 see
    # 1 and 2 keys; a second row starting at 0 sees 1 + 2 + 3 + 4 keys
    flops, nbytes = arith.chunk_attention_cost(NEMO, [2, 0], 0, 4)
    assert flops == 4 * 32 * 128 * (1 + 2 + 1 + 2 + 3 + 4)
    assert nbytes == 2 * (2 * 2 * 32 * 128 + 2 * 8 * 128 * 2) + 2 * (2 * 4 * 32 * 128 + 2 * 8 * 128 * 4)
    # a row all padding in the window needs nothing
    assert arith.chunk_attention_cost(NEMO, [8], 0, 4) == (0, 0)


def test_chunk_attention_cost_stops_at_the_window_end():
    # a verify of 3 queries at slots 4, 5, 6 over keys [0, 6): 5, 6 and 6 keys
    flops, nbytes = arith.chunk_attention_cost(NEMO, [0], 4, 3, lens=[6])
    assert flops == 4 * 32 * 128 * (5 + 6 + 6)
    assert nbytes == 2 * (2 * 3 * 32 * 128 + 2 * 8 * 128 * 6)


def test_bound_takes_the_larger():
    assert arith.bound_s(989e12, 0) == pytest.approx(1.0)
    assert arith.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert arith.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)
