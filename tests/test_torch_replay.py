"""The port's journal replay against the JAX package's, on the CPU.

- **as written**: ``tests/test_replay.py``'s decision-core, journal
  round-trip and decision-diff cases run unchanged, once on the JAX modules
  and once with the port's ``sim/policy.py``, ``sim/replay.py``,
  ``obs/flight.py``, ``obs/goodput.py`` and ``obs/shadow.py`` in their place;
- **equal outputs**: one JAX-recorded journal through both modules'
  ``extract_trace``, ``decision_stream``, ``request_chains`` and
  ``diff_journals``, and one scanned WAL through both
  ``build_restore_report``, give equal results;
- **the fixed points on the port's engine** (``TestReplaySmoke`` with the
  port's ``ContinuousEngine`` on the same tiny fp32 weights): record,
  ``extract_trace``, re-drive gives the recording's decision stream and
  token streams, plain paged, across a planted mid-decode fault (reset and
  resubmit) and with interleaved admission; the port's recording is the
  JAX recording, decision for decision; and the simulator calibrated on
  the port's journal lands within 25 % of its busy chip time.
"""

import dataclasses

import jax
import pytest
import test_replay as jtests  # the JAX replay tests, run as written on the port below

from rag_llm_k8s_tpu.models.llama import init_llama_params
from rag_llm_k8s_tpu.sim import replay as jreplay
from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, EngineConfig, FlightConfig, LlamaConfig, SamplingConfig
from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.llama import build_llama
from rag_llm_k8s_tpu_torch.obs import flight as tflight
from rag_llm_k8s_tpu_torch.obs import goodput as tgoodput
from rag_llm_k8s_tpu_torch.obs import shadow as tshadow
from rag_llm_k8s_tpu_torch.resilience import faults as tfaults
from rag_llm_k8s_tpu_torch.sim import policy as tpolicy
from rag_llm_k8s_tpu_torch.sim import replay as treplay
from rag_llm_k8s_tpu_torch.sim import simulator as tsimulator

FP32 = DTypePolicy.fp32()
PORT_MODULES = {"policy": tpolicy, "replay": treplay, "flight": tflight, "goodput": tgoodput, "shadow": tshadow,
                "simulator": tsimulator, "FlightConfig": FlightConfig}


@pytest.fixture(autouse=True)
def _clean():
    tfaults.clear()
    yield
    tfaults.clear()
    tflight.configure(enabled=True, arrival_ids=True)
    tflight.recorder().clear()
    jtests.flight.recorder().clear()


@pytest.fixture(params=["jax", "port"])
def side(request, monkeypatch):
    """Which package the as-written tests run on: the port's modules take
    the JAX modules' names in ``tests/test_replay.py`` for the test."""
    if request.param == "port":
        for name, mod in PORT_MODULES.items():
            monkeypatch.setattr(jtests, name, mod)
    return request.param


def _cases(cls):
    return [n for n in vars(cls) if n.startswith("test_")]


@pytest.mark.parametrize("name", _cases(jtests.TestPolicy))
def test_the_decision_core_as_written(side, name):
    getattr(jtests.TestPolicy(), name)()


@pytest.mark.parametrize("name", _cases(jtests.TestDecisionDiff))
def test_the_decision_diff_as_written(side, name):
    getattr(jtests.TestDecisionDiff(), name)()


def test_the_journal_round_trip_as_written(side, tmp_path, caplog):
    cases = jtests.TestJournalRoundTrip()
    cases.test_every_event_type_survives_export_parse_replay(tmp_path)
    cases.test_load_journal_warns_on_newer_schema(tmp_path, caplog)
    cases.test_load_journal_shapes(tmp_path)


def test_an_unknown_event_type_is_skipped_with_a_warning(side, caplog):
    """``TestJournalRoundTrip``'s forward-compat case; its log capture names
    the JAX module's logger, so this reads the side's own."""
    caplog.set_level("WARNING")
    mod = jtests.replay
    jtests.flight.configure(enabled=True, capacity=64)
    jtests.flight.recorder().clear()
    jtests.flight.emit("admit", 1, slot=0, prompt_len=4, bucket=16, tok0=5)
    events = jtests.flight.recorder().snapshot()
    events.append({"seq": 10 ** 9, "t": 0.0, "type": "warp_drive_engaged", "rid": 1})
    events.append("not even a dict")
    parsed = mod.parse_journal(events)
    assert parsed["skipped"] == {"warp_drive_engaged": 1, "<malformed>": 1}
    assert [e["type"] for e in parsed["events"]] == ["admit"]
    assert any("warp_drive_engaged" in r.message and r.name == mod.__name__ for r in caplog.records)
    mod.extract_trace(events)
    assert mod.diff_journals(events, events)["identical"]


# ---------------------------------------------------------------------------
# the port's engine under the lockstep driver
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    params = init_llama_params(jax.random.PRNGKey(0), jtests.CFG, jtests.FP32)
    model = convert.load_llama(build_llama(LlamaConfig.tiny(), FP32, "cpu"), convert.flatten_tree(params))
    return params, model


ENG = EngineConfig(prompt_buckets=(16, 32), max_batch_size=4, max_seq_len=64, kv_paged=True, kv_block_size=16)


def record(model, trace, engine_config=ENG, fault=None):
    """``tests/test_replay.py``'s ``record`` on the port: drive ``trace``
    against a fresh port engine under the lockstep driver, journaling to the
    port's flight recorder; returns (journal, results)."""
    eng = ContinuousEngine(LlamaConfig.tiny(), model, sampling=SamplingConfig(do_sample=False, max_new_tokens=8),
                           engine_config=engine_config, dtypes=FP32, device="cpu")
    tflight.configure(enabled=True, capacity=8192)
    tflight.recorder().clear()
    if fault is not None:
        tfaults.arm(fault, times=1)
    drv = treplay.LockstepDriver(eng, emit=tflight.emit)
    results = drv.drive(trace)
    return tflight.recorder().snapshot(), results


@pytest.fixture(scope="module")
def recorded(weights):
    """The JAX and the port recording of ``tests/test_replay.py``'s trace."""
    tflight.recorder().clear()
    jj, jr = jtests.record(weights[0], jtests.TRACE)
    tj, tr = record(weights[1], jtests.TRACE)
    return {"jax": (jj, jr), "port": (tj, tr)}


def test_the_port_records_the_jax_decisions_and_tokens(recorded):
    (jj, jr), (tj, tr) = recorded["jax"], recorded["port"]
    for mod in (jreplay, treplay):
        diff = mod.diff_journals(jj, tj)
        assert diff["identical"], diff["first_divergence"]
        assert diff["requests_identical"]
    assert tr == jr and len(tr) == 7
    # the same trace, less the wall-clock arrival times
    untimed = [[{k: v for k, v in a.items() if k != "t"} for a in mod.extract_trace(j)["arrivals"]]
               for mod, j in ((treplay, tj), (jreplay, jj))]
    assert untimed[0] == untimed[1]


def test_the_modules_agree_on_one_journal(recorded):
    jj, _ = recorded["jax"]
    faulted = [dict(e) for e in jj] + [{"seq": 10 ** 6, "t": 99.0, "type": "reset"}]
    for journal in (jj, faulted, list(reversed(jj))):
        assert treplay.extract_trace(journal) == jreplay.extract_trace(journal)
        assert treplay.decision_stream(journal) == jreplay.decision_stream(journal)
        assert treplay.request_chains(journal) == jreplay.request_chains(journal)
        assert treplay.diff_journals(jj, journal) == jreplay.diff_journals(jj, journal)
    assert treplay.DECISION_EVENTS == jreplay.DECISION_EVENTS and treplay.TIMING_ATTRS == jreplay.TIMING_ATTRS


def test_build_restore_report_matches_jax():
    def ev(seq, typ, **kw):
        return dict(seq=seq, t=0.1 * seq, type=typ, **kw)

    epochs = {
        1: [ev(1, "arrival", rid=1, prompt_len=4, max_new=8, ids=[3, 4, 5, 6]), ev(2, "token_emit", rid=1, toks=[7, 8]),
            ev(3, "arrival", rid=2, prompt_len=3, max_new=8), ev(4, "complete", rid=2, n_tokens=8),
            ev(5, "drain", phase="begin", reason="sigterm", in_flight=1, deadline_s=30.0)],
        2: [ev(1, "restore", phase="resume", rid=10, orig_rid=1, orig_epoch=1, n_emitted=2),
            ev(2, "restore", phase="rehydrate", key="doc:0", tokens=64),
            ev(3, "restore", phase="skip", orig_rid=3, reason="synthetic_prompt"),
            ev(4, "complete", rid=10, n_tokens=8)],
    }
    got = treplay.build_restore_report(epochs)
    assert got == jreplay.build_restore_report(epochs)
    assert [len(e["inflight_at_end"]) for e in got["epochs"]] == [1, 0]


def test_plain_paged_fixed_point(weights, recorded):
    j1, r1 = recorded["port"]
    t1 = treplay.extract_trace(j1)
    assert [(a["rid"], a["t_step"]) for a in t1["arrivals"]] == [
        (101, 0), (102, 0), (103, 0), (104, 0), (105, 2), (106, 3), (107, 5)]
    assert all(a["ids"] for a in t1["arrivals"])  # arrival ids on
    j2, r2 = record(weights[1], t1)
    diff = treplay.diff_journals(j1, j2)
    assert diff["identical"], diff["first_divergence"]
    assert r1 == r2 and len(r1) == 7


def test_chaos_reset_fixed_point(weights):
    j1, r1 = record(weights[1], jtests.TRACE, fault="decode_step")
    assert any(e["type"] == "reset" for e in j1) and any(e["type"] == "resubmit" for e in j1)
    j2, r2 = record(weights[1], treplay.extract_trace(j1), fault="decode_step")
    diff = treplay.diff_journals(j1, j2)
    assert diff["identical"], diff["first_divergence"]
    assert r1 == r2


def test_interleave_fixed_point(weights):
    eng_i = dataclasses.replace(ENG, interleave_prefill=True)
    j1, r1 = record(weights[1], jtests.TRACE, engine_config=eng_i)
    assert any(e["type"] == "window_budget" for e in j1)
    j2, r2 = record(weights[1], treplay.extract_trace(j1), engine_config=eng_i)
    diff = treplay.diff_journals(j1, j2)
    assert diff["identical"], diff["first_divergence"]
    assert r1 == r2


def test_the_simulated_busy_time_lands_in_band(recorded):
    j1, _ = recorded["port"]
    trace = treplay.extract_trace(j1)
    model = tsimulator.CalibratedStepModel.from_journal(j1)
    res = tsimulator.simulate(trace, step_model=model, buckets=ENG.prompt_buckets,
                              max_batch_size=ENG.max_batch_size, max_seq_len=ENG.max_seq_len,
                              block_size=ENG.kv_block_size)
    rec_busy = sum(e.get("dur_ms", 0.0) for e in j1 if e.get("type") == "goodput_window") / 1e3
    assert rec_busy > 0
    assert abs(res["report"]["busy_s"] - rec_busy) / rec_busy <= 0.25
