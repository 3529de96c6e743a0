"""CPU tests of the benchmark: ``python3 -m pytest benchmark -q``. A test
that needs the card is marked ``card`` and skips inside itself when there
is none."""

import json
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return "cuda"


def tiny_cell(clients: int = 3, chunks: int = 256, mix: str = "rag.c16"):
    """A cell at toy widths for the CPU: the Nemo configuration's file cut to
    2 layers of width 64 (vocabulary 512, so the fixture's ids fit), bge-m3
    to width 32, the mix to ``clients`` clients over ``chunks`` chunks."""
    from benchmark import harness, traffic

    with open(os.path.join(HERE, "configs", "mistral-nemo-12b.json")) as f:
        cfg = json.load(f)
    cfg["model"].update(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=16, vocab_size=512, max_position_embeddings=16384)
    cfg["encoder"].update(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                          vocab_size=256)
    with open(os.path.join(HERE, "mixes", f"{mix}.json")) as f:
        mixd = json.load(f)
    mixd["clients"] = clients
    mixd["index"]["chunks"] = chunks
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    limits = {"prompt_mismatch": 0, "text_mismatch": 0, "score_err": 0.05, "score_err_median": 0.05,
              "decode_gap": 0.5, "checked_tokens": 150}
    return harness.Cell("tiny", cfg, traffic.Mix.from_dict(mixd), mixd, {"name": "tiny", "chips": 1},
                        ["answer_tokens_per_s", "setup_s"],
                        ["retrieve_ms.p50", "batch_rows_mean", "step_ms", "step_mfu"], units, limits, (4, 2))
