"""The port's scheduler simulator and trace generator against the JAX
package's, on the CPU.

- **as written**: ``tests/test_replay.py``'s trace-generator, simulator and
  replay-diff cases run unchanged, once on the JAX modules and once with
  the port's ``sim/`` and ``obs/flight.py`` in their place (the speedup
  floor below, at the JAX peaks);
- **the same trace**: ``tracegen.generate`` gives JAX's trace at one seed
  and knobs, arrival for arrival, and ``describe`` the same summary;
- **the same simulation**: ``simulate`` of one trace with the same explicit
  peaks gives JAX's journal (so its decision stream), results, goodput,
  tenant and pool-plan reports; at the JAX peaks it runs 100x faster than
  the time it simulates, as JAX's does;
- **pool sizing** (``tests/test_router.py``'s ``test_pool_split_sizes_both_tiers``
  and ``test_pool_plan_answers_from_a_simulated_trace``, on both packages),
  and ``split_chip_time`` equal on a journal with every window kind.
"""

import pytest
import test_replay as jtests  # the JAX replay tests, run as written on the port below

from rag_llm_k8s_tpu.obs import goodput as jgoodput
from rag_llm_k8s_tpu.sim import policy as jpolicy
from rag_llm_k8s_tpu.sim import replay as jreplay
from rag_llm_k8s_tpu.sim import simulator as jsimulator
from rag_llm_k8s_tpu.sim import tracegen as jtracegen
from rag_llm_k8s_tpu_torch.core.config import AppConfig, FlightConfig
from rag_llm_k8s_tpu_torch.obs import flight as tflight
from rag_llm_k8s_tpu_torch.sim import policy as tpolicy
from rag_llm_k8s_tpu_torch.sim import replay as treplay
from rag_llm_k8s_tpu_torch.sim import simulator as tsimulator
from rag_llm_k8s_tpu_torch.sim import tracegen as ttracegen

PORT_MODULES = {"replay": treplay, "simulator": tsimulator, "tracegen": ttracegen, "flight": tflight,
                "FlightConfig": FlightConfig}
SIM = {"jax": (jsimulator, jtracegen, jpolicy), "port": (tsimulator, ttracegen, tpolicy)}
BUCKETS = jtests.TestSimulator.BUCKETS


@pytest.fixture(autouse=True)
def _clean():
    yield
    tflight.configure(enabled=True, capacity=8192, arrival_ids=True)
    tflight.recorder().clear()


@pytest.fixture(params=["jax", "port"])
def side(request, monkeypatch):
    """Which package the as-written tests run on: the port's modules take
    the JAX modules' names in ``tests/test_replay.py`` for the test."""
    if request.param == "port":
        for name, mod in PORT_MODULES.items():
            monkeypatch.setattr(jtests, name, mod)
    return request.param


def _cases(cls, leave=()):
    return [n for n in vars(cls) if n.startswith("test_") and n not in leave]


@pytest.mark.parametrize("name", _cases(jtests.TestTraceGen))
def test_the_trace_generator_as_written(side, name):
    getattr(jtests.TestTraceGen(), name)()


# the 100x floor is a function of the peaks the simulated card has; the
# port's default card (the H100) is faster than the JAX package's, so the
# port side takes the floor at the JAX peaks below
@pytest.mark.parametrize("name", _cases(jtests.TestSimulator, leave=("test_faster_than_real_time",)))
def test_the_simulator_as_written(side, name, tmp_path):
    case = getattr(jtests.TestSimulator(), name)
    case(tmp_path) if name == "test_renderers_consume_synthetic_journal" else case()


def test_the_replay_diff_cli_as_written(side, tmp_path, capsys):
    jtests.TestFlightviewReplayDiff().test_identical_and_divergent_exit_codes(tmp_path, capsys)


def test_the_arrival_ids_knob():
    """``test_arrival_ids_config_knob`` on the port, whose ``FlightConfig``
    is read by ``AppConfig.from_env``."""
    assert FlightConfig().arrival_ids is True
    assert AppConfig.from_env({"TPU_RAG_FLIGHT_ARRIVAL_IDS": "0"}).flight.arrival_ids is False
    tflight.configure(enabled=True, capacity=64, arrival_ids=False)
    assert tflight.arrival_ids() is False


@pytest.mark.parametrize("knobs", [dict(), dict(emit_ids=True, hot_chunks=32, chunk_len=16, zipf_a=1.2),
                                   dict(rate_qps=2.0, burst_prob=0.3, session_prob=0.8, step_period_s=0.02,
                                        prompt_len_range=(64, 480), max_new_range=(32, 64), rid_base=100)])
def test_tracegen_gives_the_jax_trace(knobs):
    for seed in (0, 11):
        got = ttracegen.generate(120, seed=seed, **knobs)
        assert got == jtracegen.generate(120, seed=seed, **knobs)
        assert ttracegen.describe(got) == jtracegen.describe(got)
    assert ttracegen.generate(0) == jtracegen.generate(0) and ttracegen.describe({}) == jtracegen.describe({})


def _simulate(mod, trace, peaks, **kw):
    args = dict(max_batch_size=8, max_seq_len=1024, buckets=BUCKETS, chip_hour_usd=3.2,
                roofline=mod.llama8b_roofline(*peaks))
    args.update(kw)
    return mod.simulate(trace, **args)


@pytest.mark.parametrize("peaks", ["port", "jax"])
@pytest.mark.parametrize("kw", [dict(), dict(pool_blocks=60, decode_sync_steps=4)])
def test_simulate_gives_the_jax_run_at_equal_peaks(peaks, kw):
    """Either package's default peaks, given to both: the same journal
    (decisions, virtual clock, goodput windows), results and reports."""
    mod = {"port": tsimulator._goodput, "jax": jgoodput}[peaks]
    pk = (mod.DEFAULT_PEAK_TFLOPS, mod.DEFAULT_HBM_GBS)
    trace = jtracegen.generate(40, seed=8, prompt_len_range=(64, 480), max_new_range=(32, 64))
    got, want = _simulate(tsimulator, trace, pk, **kw), _simulate(jsimulator, trace, pk, **kw)
    for key in ("journal", "results", "errors", "virtual_s", "windows", "decode_steps", "steps_per_s",
                "tokens_out", "report", "pool_plan", "tenant_report"):
        assert got[key] == want[key], key
    assert treplay.decision_stream(got["journal"]) == jreplay.decision_stream(want["journal"])
    if kw:
        assert any(e["type"] == "preempt" for e in got["journal"])


def test_the_simulator_runs_100x_faster_than_the_time_it_simulates():
    """``test_faster_than_real_time`` on the port, at the JAX peaks. The
    wall clock is this host's, shared with the other test workers, so the
    speedup is the best of three runs of the same trace."""
    trace = ttracegen.generate(300, seed=31)
    runs = [_simulate(tsimulator, trace, (jgoodput.DEFAULT_PEAK_TFLOPS, jgoodput.DEFAULT_HBM_GBS)) for _ in range(3)]
    assert not any(r["errors"] for r in runs)
    assert max(r["speedup_x"] for r in runs) >= 100, [r["speedup_x"] for r in runs]


def test_the_default_roofline_is_the_h100s():
    rf = tsimulator.llama8b_roofline()
    assert (rf.peak_flops, rf.peak_bytes) == (989e12, 3350e9)
    assert rf.flops_per_token == jsimulator.llama8b_roofline().flops_per_token


@pytest.mark.parametrize("name", sorted(SIM))
def test_pool_split_sizes_both_tiers(name):
    policy = SIM[name][2]
    plan = policy.pool_split(30.0, 120.0, span_s=100.0, target_util=0.6, min_each=1)
    assert plan["prefill"] == 1 and plan["decode"] == 2
    assert 0.0 < plan["prefill_util"] <= 1.0 and 0.0 < plan["decode_util"] <= 1.0
    tight = policy.pool_split(30.0, 120.0, span_s=100.0, target_util=0.2)
    assert tight["prefill"] >= plan["prefill"] and tight["decode"] >= plan["decode"]
    for args in ((30.0, 120.0, 100.0), (0.0, 0.0, 0.0), (500.0, 1.0, 10.0, 0.9, 3), (1.0, 2.0, 5.0, 0.0)):
        assert tpolicy.pool_split(*args) == jpolicy.pool_split(*args), args


@pytest.mark.parametrize("name", sorted(SIM))
def test_pool_plan_answers_from_a_simulated_trace(name):
    sim, tg, _ = SIM[name]
    res = sim.simulate(tg.generate(24, seed=3), max_batch_size=8)
    plan = res["pool_plan"]
    assert plan["prefill"] >= 1 and plan["decode"] >= 1
    assert plan["prefill_s"] > 0 and plan["decode_s"] > 0
    tight = sim.pool_plan(res["journal"], target_util=0.05)
    assert tight["prefill"] >= plan["prefill"] and tight["decode"] >= plan["decode"]


def test_split_chip_time_and_pool_plan_match_jax():
    journal = [{"t": 0.0, "type": "arrival"}]
    for i, (kind, dur, extra) in enumerate([("prefill", 30.0, {}), ("prefill_px", 4.0, {}), ("decode", 5.0, {}),
                                            ("verify", 6.0, {}), ("mixed", 8.0, {"tokens": 40, "decode_tokens": 8}),
                                            ("oneshot", 900.0, {"tokens": 3050, "decode_tokens": 150}),
                                            ("mixed", 7.0, {}), ("decode", 0.0, {})]):
        journal.append({"t": 0.5 * (i + 1), "type": "goodput_window", "kind": kind, "dur_ms": dur, **extra})
    journal.append("not a dict")
    assert tsimulator.split_chip_time(journal) == jsimulator.split_chip_time(journal)
    for kw in (dict(), dict(target_util=0.2, span_s=0.5, min_each=2)):
        assert tsimulator.pool_plan(journal, **kw) == jsimulator.pool_plan(journal, **kw)
