"""A whole run on the CPU at toy widths (the harness's look for a card
skipped): it comes out correct, it loads nothing of JAX or the JAX package,
and with the timed path broken underneath it comes out not correct, once
for each fault a serving cell can have."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import harness
from benchmark.conftest import tiny_cell

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 99


def _run(after_build=None, seconds=6.0, trace=False):
    from benchmark import run

    cell = tiny_cell()
    cell.limits["checked_tokens"] = 100
    return run.execute(cell, SEED, seconds, device="cpu", after_build=after_build, trace=trace)


def test_a_toy_run_is_correct_and_loads_no_jax():
    """In a process of its own, so that nothing else imported here counts."""
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from benchmark.test_bench_run import _run\n"
        "from benchmark import harness\n"
        "r = _run()\n"
        "print(json.dumps({'correct': r['correct'], 'checks': r['checks'], 'bad': harness.forbidden_modules()}))\n"
    ) % ROOT
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert got["correct"], got["checks"]


def test_the_import_check_compares_whole_names(monkeypatch):
    for name in ("rag_llm_k8s_tpu_torch", "rag_llm_k8s_tpu_torch.engine", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == [m for m in harness.forbidden_modules() if m in harness.FORBIDDEN]
    for name in ("rag_llm_k8s_tpu_torch", "jaxtyping", "flaxen"):
        assert name not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rag_llm_k8s_tpu.engine", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"rag_llm_k8s_tpu", "jax"} <= set(harness.forbidden_modules())


def _alter_tokens(built):
    """A token altered where it is produced: every row's fifth token, under
    the harness's record of the call."""
    engine, cap = built.engine, built.capture
    inner = cap.inner

    def broken(tokens, pad_mask, S, max_new, chunk, spec, gen):
        out, iters = inner(tokens, pad_mask, S, max_new, chunk, spec, gen)
        out = out.copy()
        out[:, 4] = (out[:, 4] + 7) % engine.config.vocab_size
        return out, iters

    cap.inner = broken


def _scramble_index(built):
    """The retrieval's answer altered where it is produced: the index holds
    other vectors than the ones the chunks were indexed with."""
    store = built.service.store
    rng = np.random.default_rng(0)
    with store._lock:
        store._vectors = store._vectors[rng.permutation(store._vectors.shape[0])]
        store._dev = None


def _drop_head_token(built):
    """The prompt altered where it is assembled: the head loses a token."""
    svc = built.service
    svc._a_ids_cache = svc._a_ids()[:-1]


@pytest.mark.parametrize("fault, caught_by", [
    (_alter_tokens, ["decode_gap"]),
    (_scramble_index, ["score_err", "score_err_median"]),
    (_drop_head_token, ["prompt_mismatch"]),
])
def test_a_broken_timed_path_is_not_correct(fault, caught_by):
    r = _run(after_build=fault)
    assert not r["correct"]
    for name in caught_by:
        v, lim = r["checks"][name]
        assert v > lim, r["checks"]


def test_a_traced_run_records_every_attention_call_with_its_own_window():
    """The recorder copies each forward's window as it is issued: a decode
    step's keys are one more than the step's before it in the same call,
    though the loop advances its window in place. The model's names are
    the program's own again after the run."""
    from rag_llm_k8s_tpu_torch.models import llama
    from rag_llm_k8s_tpu_torch.ops import attention

    held = {}
    r = _run(after_build=lambda b: held.setdefault("built", b), trace=True)
    assert r["correct"], r["checks"]
    recs = held["built"].recorder.calls
    L = tiny_cell().config["model"]["num_hidden_layers"]
    assert recs and recs[0].layer == 0
    assert [c.layer for c in recs[: 2 * L]] == list(range(L)) * 2
    steps = {}
    for c in recs:
        if c.wrapper == "decode_attention" and c.layer == 0:
            steps.setdefault(c.call_no, []).append(c.window[1])
    assert sum(len(v) for v in steps.values()) > 10
    for lens in steps.values():
        for a, b in zip(lens, lens[1:]):
            assert [y - x for x, y in zip(a, b)] == [1] * len(a)
    assert llama.decode_attention is attention.decode_attention
    assert llama.chunk_prefill_attention is attention.chunk_prefill_attention


def test_a_control_run_is_judged_by_the_control_numbers():
    from benchmark import check

    limits = {"prompt_mismatch": 0, "text_mismatch": 0, "score_err_median": 0.01, "decode_gap": 1.0, "checked_tokens": 10}
    numbers = {"prompt_mismatch": 0, "text_mismatch": 0, "score_err": 0.001, "score_err_median": 0.001, "decode_gap": 0.4,
               "checked_tokens": 20, "control_score_err": 0.002, "control_score_err_median": 0.002,
               "control_retrieval_gap": 0.1, "control_decode_gap": 6.0}
    ok, _ = check.verdict(numbers, limits, 0)
    assert ok
    ok, checks = check.verdict(check.control_numbers(numbers), limits, 0)
    assert not ok
    assert checks["decode_gap"] == [6.0, 1.0] and checks["score_err_median"] == [0.002, 0.01]
