"""The device trace's arithmetic: busy time, gaps, and the attention calls
paired with the recorded ones for the rooflines and the step."""

import pytest

from benchmark import arith
from benchmark.attn_calls import AttnCall, roofline, traced_step_ms
from benchmark.devtrace import DeviceTrace, busy, idle_gaps
from benchmark.window import Run

CFG = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 512, "eos_token_id": 2}
DEC = "void attn_sm90::decode_kernel<128, (anonymous namespace)::DenseKV>(attn_sm90::Params, DenseKV)"
MERGE = "void attn_sm90::merge_kernel<128, (anonymous namespace)::DenseKV>(attn_sm90::Params, DenseKV, int, int)"
CHUNK = "void attn_sm90::ws_kernel<128, 2, (anonymous namespace)::DenseKV>(attn_sm90::Params, DenseKV)"
MARKER = "at::cuda::(anonymous namespace)::spin_kernel(long)"
FLASH = "void attn_sm90::ws_kernel<128, 2, (anonymous namespace)::StridedKV>(attn_sm90::Params, StridedKV)"


def test_busy_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert busy(iv, 0.0, 5.0) == 3.0
    assert idle_gaps(iv, 0.0, 5.0) == [(2.0, 1.0), (4.0, 1.0)]


def _rec(wrapper, layer, call_no, S, ks, kl, wi=0):
    return AttnCall(wrapper, layer, call_no, S, [list(ks), list(kl), wi])


def _run_with(ev, recs):
    return Run("t", CFG, 1.0, 0.0, 1.0, [], [], DeviceTrace(ev, 0.0, 1.0), 0.0, 0.0, recs)


def test_the_rooflines_pair_traced_kernels_after_the_marker_with_the_recorded_calls():
    # two layers, a chunk window then two decode steps; kernels before the
    # marker (issued before recording began) are not paired
    recs = [_rec("chunk_prefill_attention", l, 1, 4, [2, 0], [4, 4], 0) for l in range(2)]
    recs += [_rec("decode_attention", l, 1, 1, [2, 0], [5 + i, 5 + i]) for i in range(2) for l in range(2)]
    ev, t = [(DEC, 0.0, 1e-6), (MARKER, 2e-6, 3e-6)], 1e-5
    for r in recs:
        ev.append((FLASH, t, t + 1e-6))  # bge-m3's flash calls are no dense-cache kernel
        name = CHUNK if r.wrapper == "chunk_prefill_attention" else DEC
        ev.append((name, t + 2e-6, t + 4e-6))
        ev.append((MERGE, t + 4e-6, t + 5e-6))
        t += 1e-5
    run = _run_with(ev, recs)
    dec = [r for r in recs if r.wrapper == "decode_attention"]
    assert dec[0].bound_s(CFG) == arith.bound_s(*arith.decode_attention_cost(CFG, [3, 5]))
    assert roofline(run, "decode_attention") == pytest.approx(100.0 * sum(r.bound_s(CFG) for r in dec) / (4 * 3e-6))
    ch = recs[:2]
    assert ch[0].bound_s(CFG) == arith.bound_s(*arith.chunk_attention_cost(CFG, [2, 0], 0, 4))
    assert roofline(run, "chunk_prefill_attention") == pytest.approx(
        100.0 * sum(r.bound_s(CFG) for r in ch) / (2 * 3e-6))
    # the step's period: layer 0 of step 2 starts two calls after layer 0 of step 1
    assert traced_step_ms(run) == pytest.approx(1e3 * 2e-5)


def test_no_marker_or_a_wrong_pairing_reads_nothing():
    recs = [_rec("decode_attention", 0, 1, 1, [0], [3])]
    assert roofline(_run_with([(DEC, 0.0, 1e-6)], recs), "decode_attention") is None
    assert roofline(_run_with([(MARKER, 0.0, 1e-6), (CHUNK, 2e-6, 3e-6)], recs), "decode_attention") is None
    # the trace ends first: the calls recorded after it are left unpaired
    got = roofline(_run_with([(MARKER, 0.0, 1e-6), (DEC, 2e-6, 3e-6)], recs * 3), "decode_attention")
    assert got == pytest.approx(100.0 * recs[0].bound_s(CFG) / 1e-6)


def test_steps_of_different_calls_are_not_one_step():
    recs = [_rec("decode_attention", 0, 1, 1, [0], [3]), _rec("decode_attention", 0, 2, 1, [0], [3]),
            _rec("decode_attention", 0, 2, 1, [0], [4])]
    ev = [(MARKER, 0.0, 1e-6), (DEC, 1.0e-3, 1.1e-3), (DEC, 5.0e-3, 5.1e-3), (DEC, 8.0e-3, 8.1e-3)]
    assert traced_step_ms(_run_with(ev, recs)) == pytest.approx(3.0)
