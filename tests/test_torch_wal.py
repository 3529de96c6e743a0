"""The port's durable lifecycle against the JAX package's, on the CPU: the
flight WAL, the warm restart's record of a dead incarnation, and the
service's restore.

- **durability**: the cases of ``tests/test_lifecycle.py`` for
  ``durable_write`` and ``FlightWAL`` (rotation, pruning, epochs, torn
  tails, dropped appends, the recorder's tee), each on the JAX module and on
  the port's;
- **replay**: ``extract_inflight`` equal to JAX's on the same journals, and
  on a hypothesis sweep of random event orders written to a WAL segment
  with a torn tail (``scan_wal`` equal too);
- **the WAL keys** of ``AppConfig.from_env`` as JAX's ``FlightConfig``
  parses them;
- **the journal and the resume**: the port's continuous engine journals
  ``token_emit`` deltas that rebuild the stream; ``submit(resume_emitted=)``
  delivers the stream JAX's scheduler delivers;
- **restore**: ``restore_from_wal`` on a hand-built dead epoch resumes the
  stream of the uninterrupted JAX and port runs, the knob turns it off, a
  coalescing scheduler skips with ``no_scheduler``, the drain's persist step
  writes the warmth manifest durably and the next boot rehydrates it, with
  a stub cache and with the real prefix cache beside JAX's;
- **the chaos pin**: a subprocess SIGKILLed mid-decode, a second process
  restoring from the same WAL, every stream equal to the uninterrupted run.

Journal checks select events by ``seq`` from the recorder's
``events_emitted`` taken before the request, never by the ring's length.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import types

import jax
import pytest
import test_torch_resilience as R  # the JAX/port service pair's pieces
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rag_llm_k8s_tpu.core.config import FlightConfig as JFlightConfig
from rag_llm_k8s_tpu.core.config import PrefixCacheConfig as JPrefixCacheConfig
from rag_llm_k8s_tpu.obs import flight as jflight
from rag_llm_k8s_tpu.sim import replay as jreplay
from rag_llm_k8s_tpu_torch.core.config import AppConfig, FlightConfig, PrefixCacheConfig
from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine, ContinuousScheduler
from rag_llm_k8s_tpu_torch.obs import flight as tflight
from rag_llm_k8s_tpu_torch.sim import replay as treplay

JAX = types.SimpleNamespace(flight=jflight, replay=jreplay)
PORT = types.SimpleNamespace(flight=tflight, replay=treplay)
CPU = torch.device("cpu")
# the JAX restore tests' continuous engine (dense rows) and budgets
ENG = dict(prompt_buckets=(16, 32), max_batch_size=4, max_seq_len=64)
GREEDY = dict(do_sample=False, max_new_tokens=8)
PROMPT = [5, 6, 7, 8]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _detach_wal():
    """Both recorders are process-wide: no test's WAL tee outlives it."""
    yield
    jflight.configure(wal=None)
    tflight.configure(wal=None)


@pytest.fixture(params=["jax", "port"])
def m(request):
    return {"jax": JAX, "port": PORT}[request.param]


def _ev(seq, etype, rid=None, **attrs):
    d = {"seq": seq, "t": seq / 10.0, "type": etype}
    if rid is not None:
        d["rid"] = rid
    d.update(attrs)
    return d


# ---------------------------------------------------------------------------
# durable_write and the FlightWAL
# ---------------------------------------------------------------------------


class TestDurableWrite:
    def test_round_trip_and_no_tmp_residue(self, m, tmp_path):
        path = str(tmp_path / "state.json")
        m.flight.durable_write(path, {"a": 1, "nested": [1, 2, 3]})
        with open(path) as f:
            assert json.load(f) == {"a": 1, "nested": [1, 2, 3]}
        assert os.listdir(tmp_path) == ["state.json"]

    def test_overwrite_replaces_atomically(self, m, tmp_path):
        path = str(tmp_path / "state.json")
        m.flight.durable_write(path, {"gen": 1})
        m.flight.durable_write(path, {"gen": 2})
        with open(path) as f:
            assert json.load(f) == {"gen": 2}

    def test_export_and_load_journal(self, m, tmp_path):
        path = str(tmp_path / "journal.json")
        events = [_ev(1, "arrival", rid=1, prompt_len=2, max_new=4), _ev(2, "complete", rid=1, n_tokens=4)]
        bundle = m.flight.export_journal(path, events, meta={"note": "x"})
        assert bundle["schema_version"] == m.flight.SCHEMA_VERSION and bundle["note"] == "x"
        assert m.flight.load_journal(path) == events


class TestFlightWAL:
    def test_segment_rotation_and_scan_order(self, m, tmp_path):
        wal = m.flight.FlightWAL(str(tmp_path), segment_events=4)
        for i in range(10):
            wal.append(_ev(i, "arrival", rid=i, prompt_len=2, max_new=4))
        wal.close()
        assert sorted(os.listdir(tmp_path)) == [
            "wal_00000001_000001.jsonl", "wal_00000001_000002.jsonl", "wal_00000001_000003.jsonl"]
        epochs = m.flight.scan_wal(str(tmp_path))
        assert list(epochs) == [1]
        assert [e["seq"] for e in epochs[1]] == list(range(10))
        assert wal.appends == 10 and wal.dropped == 0

    def test_prune_drops_oldest_past_max_segments(self, m, tmp_path):
        wal = m.flight.FlightWAL(str(tmp_path), segment_events=2, max_segments=2)
        for i in range(9):
            wal.append(_ev(i, "arrival", rid=i))
        wal.close()
        names = sorted(os.listdir(tmp_path))
        assert len(names) == 2 and names[-1] == "wal_00000001_000005.jsonl"
        assert [e["seq"] for e in m.flight.scan_wal(str(tmp_path))[1]] == [6, 7, 8]

    def test_epoch_bumps_per_incarnation_and_stays_frozen(self, m, tmp_path):
        w1 = m.flight.FlightWAL(str(tmp_path))
        w1.append(_ev(1, "arrival", rid=1))
        w1.close()
        w2 = m.flight.FlightWAL(str(tmp_path))
        assert w2.epoch == 2
        w2.append(_ev(1, "arrival", rid=9))
        w2.close()
        epochs = m.flight.scan_wal(str(tmp_path))
        assert sorted(epochs) == [1, 2]
        assert epochs[1][0]["rid"] == 1 and epochs[2][0]["rid"] == 9

    def test_scan_skips_torn_tail(self, m, tmp_path):
        wal = m.flight.FlightWAL(str(tmp_path))
        wal.append(_ev(1, "arrival", rid=1))
        wal.append(_ev(2, "token_emit", rid=1, toks=[7, 8]))
        wal.close()
        name = sorted(os.listdir(tmp_path))[-1]
        with open(tmp_path / name, "a") as f:
            f.write('{"seq": 3, "type": "tok')  # a SIGKILL mid-append
        assert [e["seq"] for e in m.flight.scan_wal(str(tmp_path))[1]] == [1, 2]

    def test_append_never_raises_counts_drops(self, m, tmp_path):
        wal = m.flight.FlightWAL(str(tmp_path / "gone"))
        os.rmdir(tmp_path / "gone")
        wal.append(_ev(1, "arrival"))  # the directory vanished: logged and counted
        assert wal.dropped == 1

    def test_recorder_tees_into_wal(self, m, tmp_path):
        wal = m.flight.FlightWAL(str(tmp_path))
        m.flight.configure(enabled=True, wal=wal)
        assert m.flight.wal_enabled()
        m.flight.emit("arrival", 7, prompt_len=3, max_new=4)
        m.flight.emit("token_emit", 7, toks=[11, 12])
        events = m.flight.scan_wal(str(tmp_path))[wal.epoch]
        assert [e["type"] for e in events] == ["arrival", "token_emit"]
        assert all(e["rid"] == 7 for e in events) and events[1]["toks"] == [11, 12]
        assert events[0]["seq"] < events[1]["seq"]
        # the WAL holds what the ring's snapshot returns, event for event
        ring = [e for e in m.flight.recorder().snapshot() if e["seq"] >= events[0]["seq"]]
        assert ring == events
        m.flight.configure(wal=None)
        assert not m.flight.wal_enabled()

    def test_a_capacity_change_keeps_the_tee(self, m, tmp_path):
        wal = m.flight.FlightWAL(str(tmp_path))
        m.flight.configure(wal=wal)
        cap = m.flight.recorder().capacity
        try:
            m.flight.configure(capacity=cap + 1)
            assert m.flight.recorder().wal is wal
        finally:
            m.flight.configure(capacity=cap)

    def test_token_ids_from_a_tokenizers_numpy_output_are_journaled(self, tmp_path):
        """The port's tokenizers hand out numpy ids: the WAL and durable
        writes store their values (a ``TypeError`` there would drop every
        ``arrival`` of a served request)."""
        import numpy as np

        wal = tflight.FlightWAL(str(tmp_path))
        ids = np.array([5, 6, 7], np.int32)
        wal.append(_ev(1, "arrival", rid=1, prompt_len=3, max_new=4, ids=list(ids), seed=np.int64(9)))
        wal.close()
        assert wal.dropped == 0
        assert tflight.scan_wal(str(tmp_path))[1][0]["ids"] == [5, 6, 7]
        path = str(tmp_path / "m.json")
        tflight.durable_write(path, {"entries": [{"ids": ids}]})
        with open(path) as f:
            assert json.load(f) == {"entries": [{"ids": [5, 6, 7]}]}
        with pytest.raises(TypeError):
            tflight.durable_write(path, {"x": object()})

    def test_validation(self, m, tmp_path):
        with pytest.raises(ValueError, match="segment_events"):
            m.flight.FlightWAL(str(tmp_path), segment_events=0)
        with pytest.raises(ValueError, match="max_segments"):
            m.flight.FlightWAL(str(tmp_path), max_segments=1)


# ---------------------------------------------------------------------------
# extract_inflight
# ---------------------------------------------------------------------------


def _epoch1():
    return [
        _ev(1, "arrival", rid=1, prompt_len=3, max_new=6, ids=[5, 6, 7], seed=11, tenant="acme"),
        _ev(2, "token_emit", rid=1, toks=[20, 21]),
        _ev(3, "token_emit", rid=1, toks=[22]),
        _ev(4, "arrival", rid=2, prompt_len=4, max_new=6),  # no ids
        _ev(5, "arrival", rid=3, prompt_len=2, max_new=6, ids=[8, 9]),
        _ev(6, "complete", rid=3, n_tokens=6, stream_fnv=123),
        _ev(7, "arrival", rid=4, prompt_len=2, max_new=6, ids=[8, 9]),
        _ev(8, "resubmit", rid=4, outcome="gave_up", n_emitted=0),
        _ev(9, "drain", phase="begin", reason="sigterm", in_flight=2),
    ]


class TestExtractInflight:
    def test_inflight_records_concat_token_emits(self, m):
        got = m.replay.extract_inflight(_epoch1())
        assert got["arrivals"] == 4
        assert got["terminal"] == {"complete": 1, "gave_up": 1}
        recs = {r["rid"]: r for r in got["inflight"]}
        assert sorted(recs) == [1, 2]
        r1 = recs[1]
        assert r1["prompt"] == [5, 6, 7] and r1["emitted"] == [20, 21, 22]
        assert not r1["synthetic_prompt"]
        assert r1["seed"] == 11 and r1["tenant"] == "acme"
        r2 = recs[2]  # a lengths-only arrival: the deterministic filler, marked
        assert r2["synthetic_prompt"] and len(r2["prompt"]) == 4

    def test_port_equals_jax_on_the_same_journal(self):
        assert treplay.extract_inflight(_epoch1()) == jreplay.extract_inflight(_epoch1())
        shuffled = list(reversed(_epoch1())) + [{"type": "from_the_future", "seq": 10}, "junk"]
        assert treplay.extract_inflight(shuffled) == jreplay.extract_inflight(shuffled)
        assert treplay.parse_journal(shuffled)["skipped"] == jreplay.parse_journal(shuffled)["skipped"]

    @settings(max_examples=60, deadline=None)
    @given(
        events=st.lists(
            st.tuples(
                st.sampled_from(["arrival", "arrival_noids", "token_emit", "complete", "evict", "gave_up",
                                 "resubmitted", "restore", "unknown_type"]),
                st.integers(1, 4), st.lists(st.integers(0, 299), max_size=3)),
            max_size=30),
        order=st.randoms(use_true_random=False),
        torn=st.sampled_from(["", '{"seq": 99, "type": "tok', "garbage\n", '{"type": 5}\n']),
    )
    def test_random_journals_with_torn_tails_match_jax(self, events, order, torn):
        evs = []
        for seq, (kind, rid, toks) in enumerate(events):
            if kind == "arrival":
                evs.append(_ev(seq, "arrival", rid=rid, prompt_len=len(toks) + 1, max_new=5, ids=toks + [3]))
            elif kind == "arrival_noids":
                evs.append(_ev(seq, "arrival", rid=rid, prompt_len=len(toks) + 2, max_new=5, seed=rid))
            elif kind == "token_emit":
                evs.append(_ev(seq, "token_emit", rid=rid, toks=toks))
            elif kind in ("gave_up", "resubmitted"):
                evs.append(_ev(seq, "resubmit", rid=rid, outcome=kind, n_emitted=len(toks)))
            elif kind == "restore":
                evs.append(_ev(seq, "restore", phase="resume", orig_rid=rid, n_emitted=0))
            else:
                evs.append(_ev(seq, kind, rid=rid, n_tokens=len(toks)))
        order.shuffle(evs)  # segments are scanned back into seq order
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "wal_00000001_000001.jsonl"), "w") as f:
                f.write("".join(json.dumps(e) + "\n" for e in evs) + torn)
            scanned = tflight.scan_wal(d)
            assert scanned == jflight.scan_wal(d)
        got = scanned.get(1, [])
        # a parseable tail without a seq (``{"type": 5}``) is kept and sorts first
        assert [e["seq"] for e in got if "seq" in e] == sorted(e["seq"] for e in evs)
        assert treplay.extract_inflight(got) == jreplay.extract_inflight(got)


# ---------------------------------------------------------------------------
# the WAL keys
# ---------------------------------------------------------------------------

WAL_ENV = {
    "TPU_RAG_FLIGHT_WAL": "1", "TPU_RAG_FLIGHT_WAL_DIR": "/pvc/wal", "TPU_RAG_FLIGHT_WAL_SEGMENT_EVENTS": "128",
    "TPU_RAG_FLIGHT_WAL_SEGMENTS": "16", "TPU_RAG_FLIGHT_WAL_RESTORE": "0", "TPU_RAG_FLIGHT_WAL_RESTORE_CHUNKS": "3",
}
WAL_FIELDS = ("enabled", "arrival_ids", "capacity", "debug_endpoints", "wal", "wal_dir", "wal_segment_events",
              "wal_segments", "wal_restore", "wal_restore_chunks")


class TestLifecycleConfig:
    @pytest.mark.parametrize("env", [{}, WAL_ENV, {"TPU_RAG_FLIGHT": "0", "TPU_RAG_FLIGHT_ARRIVAL_IDS": "0"}])
    def test_wal_knobs_round_trip_as_jax(self, env):
        got, want = AppConfig.from_env(env).flight, JFlightConfig.from_env(env)
        assert {f: getattr(got, f) for f in WAL_FIELDS} == {f: getattr(want, f) for f in WAL_FIELDS}
        assert FlightConfig().wal is False and FlightConfig().wal_restore is True  # the defaults

    @pytest.mark.parametrize("env,match", [
        ({"TPU_RAG_FLIGHT_WAL_SEGMENT_EVENTS": "0"}, "SEGMENT_EVENTS"),
        ({"TPU_RAG_FLIGHT_WAL_SEGMENTS": "1"}, "WAL_SEGMENTS"),
        ({"TPU_RAG_FLIGHT_WAL_RESTORE_CHUNKS": "-1"}, "RESTORE_CHUNKS"),
    ])
    def test_wal_knob_validation_as_jax(self, env, match):
        with pytest.raises(ValueError, match=match) as want:
            JFlightConfig.from_env(env)
        with pytest.raises(ValueError, match=match) as got:
            AppConfig.from_env(env)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the engine's journal and the scheduler's resume
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    from rag_llm_k8s_tpu.models.llama import init_llama_params
    from rag_llm_k8s_tpu_torch.models import convert
    from rag_llm_k8s_tpu_torch.models.llama import build_llama

    params = init_llama_params(jax.random.PRNGKey(0), R.JLlamaConfig.tiny(R.VOCAB), R.JFP32)
    return params, convert.load_llama(build_llama(R.LlamaConfig.tiny(R.VOCAB), R.FP32, CPU),
                                      convert.flatten_tree(params))


def _port_sched(model, **ec):
    return ContinuousScheduler(ContinuousEngine(R.LlamaConfig.tiny(R.VOCAB), model, R.SamplingConfig(**GREEDY),
                                                R.EngineConfig(**{**ENG, **ec}), R.FP32, "cpu"),
                               retry_backoff_s=0.0)


def _jax_sched(params, **ec):
    return R.jcontinuous.ContinuousScheduler(
        R.jcontinuous.ContinuousEngine(R.JLlamaConfig.tiny(R.VOCAB), params, sampling=R.JSampling(**GREEDY),
                                       engine_config=R.JEngineConfig(**{**ENG, **ec}, attn_impl="xla"),
                                       dtypes=R.JFP32),
        retry_backoff_s=0.0)


@pytest.fixture(scope="module")
def oracle(weights):
    """The uninterrupted greedy stream of ``PROMPT`` (8 tokens), JAX's and
    the port's, which must agree."""
    params, model = weights
    out = []
    for sched in (_jax_sched(params), _port_sched(model)):
        try:
            out.append(sched.submit(PROMPT, max_new_tokens=8, timeout=120))
        finally:
            sched.shutdown()
    assert out[0] == out[1] and len(out[0]) == 8
    return out[0]


@pytest.mark.parametrize("ec", [{}, {"kv_paged": True, "kv_block_size": 16},
                                {"kv_paged": True, "kv_block_size": 16, "interleave_prefill": True,
                                 "prefill_chunk_tokens": 8}],
                         ids=["dense", "paged", "interleaved"])
def test_token_emits_rebuild_the_stream_only_with_a_wal(weights, oracle, ec, tmp_path):
    _, model = weights
    sched = _port_sched(model, **ec)
    rec = tflight.recorder()
    try:
        n0 = rec.events_emitted
        assert sched.submit(PROMPT, max_new_tokens=8, timeout=120) == oracle
        assert not [e for e in rec.snapshot(etype="token_emit") if e["seq"] >= n0]  # no WAL: no per-window emit
        wal = tflight.FlightWAL(str(tmp_path))
        tflight.configure(wal=wal)
        info = {}
        assert sched.submit(PROMPT, max_new_tokens=8, timeout=120, info=info) == oracle
    finally:
        sched.shutdown()
    evs = [e for e in tflight.scan_wal(str(tmp_path))[wal.epoch] if e.get("rid") == info["request_id"]]
    toks = [t for e in evs if e["type"] == "token_emit" for t in e["toks"]]
    # every window journals its rows' new tokens; a row's last window ends in
    # its complete, so the journaled tokens are a prefix of the stream
    assert toks and oracle[:len(toks)] == toks and len(toks) >= len(oracle) - 2
    assert evs[0]["type"] == "arrival" and evs[0]["ids"] == PROMPT and evs[-1]["type"] == "complete"


@pytest.mark.parametrize("n_emitted", [1, 3, 7])
def test_resume_emitted_delivers_what_jax_delivers(weights, oracle, n_emitted):
    params, model = weights
    got = {}
    for side, sched in (("jax", _jax_sched(params)), ("port", _port_sched(model))):
        rec = (jflight if side == "jax" else tflight).recorder()
        n0 = rec.events_emitted
        try:
            info = {}
            got[side] = sched.submit(PROMPT, max_new_tokens=8, resume_emitted=oracle[:n_emitted], info=info,
                                     timeout=120)
        finally:
            sched.shutdown()
        evs = [(e["type"], e.get("outcome"), e.get("toks")) for e in rec.snapshot(request_id=info["request_id"])
               if e["seq"] >= n0 and e["type"] in ("token_emit", "resubmit")]
        assert evs == [("token_emit", None, oracle[:n_emitted]), ("resubmit", "restored", None)]
    assert got["port"] == got["jax"] == oracle


# ---------------------------------------------------------------------------
# the service's restore
# ---------------------------------------------------------------------------


def _service(model, wal_dir, batching="continuous", **flight):
    """A port service over the tiny model with a WAL in ``wal_dir`` and a
    continuous (dense) or coalescing scheduler."""
    from rag_llm_k8s_tpu_torch.models import convert
    from rag_llm_k8s_tpu_torch.models.bge_m3 import build_encoder

    lc, ec = R.LlamaConfig.tiny(R.VOCAB), R.EncoderConfig.tiny(R.VOCAB)
    eng = R.InferenceEngine(lc, model, R.SamplingConfig(**GREEDY), R.EngineConfig(**R.HTTP_ENGINE), R.FP32, "cpu")
    sched = _port_sched(model) if batching == "continuous" else R.BatchScheduler(eng, max_wait_ms=30.0)
    enc = convert.init_random_(build_encoder(ec, R.FP32, CPU), torch.Generator().manual_seed(1))
    cfg = R.AppConfig(model=lc, encoder=ec, engine=eng.engine_config,
                      flight=FlightConfig(wal=True, wal_dir=wal_dir, **flight))
    svc = R.tapp.RagService(cfg, eng, R.ByteTokenizer(), R.EncoderRunner(ec, enc, device="cpu"),
                            R.ByteTokenizer(), R.VectorStore(dim=ec.hidden_size, device="cpu"), scheduler=sched)
    svc.ready = True
    return svc


def _dead_epoch(wal_dir, emitted):
    w1 = tflight.FlightWAL(wal_dir)
    w1.append(_ev(1, "arrival", rid=1, prompt_len=len(PROMPT), max_new=8, ids=PROMPT))
    w1.append(_ev(2, "token_emit", rid=1, toks=emitted))
    w1.append(_ev(3, "arrival", rid=2, prompt_len=3, max_new=8))  # lengths only
    w1.close()


class TestServiceRestore:
    def test_restore_resumes_byte_identical_to_oracle(self, weights, oracle, tmp_path):
        wal_dir = str(tmp_path / "wal")
        _dead_epoch(wal_dir, oracle[:3])
        svc = _service(weights[1], wal_dir)
        try:
            assert svc.flight_wal is not None and svc.flight_wal.epoch == 2
            assert tflight.recorder().wal is svc.flight_wal
            summary = svc.restore_from_wal(wait=True)
            assert (summary["resumed"], summary["skipped"], summary["rehydrated"]) == (1, 1, 0)
            assert summary["results"][1] == oracle  # the uninterrupted JAX and port stream
            e2 = tflight.scan_wal(wal_dir)[2]
            assert any(e["type"] == "complete" for e in e2)
            skips = [e for e in e2 if e["type"] == "restore" and e.get("phase") == "skip"]
            assert skips and skips[0]["reason"] == "synthetic_prompt"
            resumes = [e for e in e2 if e["type"] == "restore" and e.get("phase") == "resume"]
            assert [(e["orig_rid"], e["orig_epoch"], e["n_emitted"]) for e in resumes] == [(1, 1, 3)]
            # the new epoch alone rebuilds the resumed request's WAL-proven tokens
            rid = next(e["rid"] for e in e2 if e["type"] == "arrival")
            assert [t for e in e2 if e["type"] == "token_emit" and e["rid"] == rid for t in e["toks"]][:3] \
                == oracle[:3]
        finally:
            svc.shutdown()
        assert tflight.recorder().wal is None  # shutdown detached and closed it

    def test_restore_disabled_by_knob(self, weights, tmp_path):
        wal_dir = str(tmp_path / "wal")
        _dead_epoch(wal_dir, [9])
        svc = _service(weights[1], wal_dir, wal_restore=False)
        try:
            assert svc.restore_from_wal(wait=True) == {"resumed": 0, "skipped": 0, "rehydrated": 0,
                                                       "results": {}}
        finally:
            svc.shutdown()

    def test_coalescing_scheduler_skips_with_no_scheduler(self, weights, tmp_path):
        wal_dir = str(tmp_path / "wal")
        _dead_epoch(wal_dir, [9])
        svc = _service(weights[1], wal_dir, batching="coalesce")
        n0 = tflight.recorder().events_emitted
        try:
            summary = svc.restore_from_wal(wait=True)
        finally:
            svc.shutdown()
        assert (summary["resumed"], summary["skipped"]) == (0, 2)
        skips = [e for e in tflight.recorder().snapshot(etype="restore") if e["seq"] >= n0]
        assert [(e["phase"], e["orig_rid"], e["reason"]) for e in skips] == [
            ("skip", 1, "no_scheduler"), ("skip", 2, "no_scheduler")]

    def test_an_unopenable_wal_dir_runs_ring_only(self, weights, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        svc = _service(weights[1], str(blocker / "wal"))
        try:
            assert svc.flight_wal is None and tflight.recorder().wal is None
            assert svc.restore_from_wal()["resumed"] == 0
        finally:
            svc.shutdown()

    def test_persist_writes_warmth_manifest_durably(self, weights, tmp_path):
        wal_dir = str(tmp_path / "wal")
        svc = _service(weights[1], wal_dir)
        staged = [("doc:0", [4, 5, 6, 7])]
        calls = []

        class FakeCache:
            def warmth_manifest(self, top_n=8):
                return [{"key": k, "ids": ids, "tokens": len(ids), "score": 1.0, "spilled": False}
                        for k, ids in staged[:top_n]]

            def prefix_for(self, segments):
                calls.append(segments)
                return object()

        try:
            svc.engine.prefix_cache = FakeCache()
            n0 = tflight.recorder().events_emitted
            svc.lifecycle.begin_drain("sigterm")  # the persist step runs once the drain completes
            assert svc.lifecycle.wait_drained(10)
            with open(os.path.join(wal_dir, "warmth_manifest.json")) as f:
                doc = json.load(f)
            assert doc["entries"][0]["key"] == "doc:0" and doc["schema_version"] == tflight.SCHEMA_VERSION
            assert not [n for n in os.listdir(wal_dir) if n.endswith(".tmp")]
            assert svc._rehydrate_warmth(svc.config.flight) == 1
            assert calls == [[("doc:0", [4, 5, 6, 7])]]
            rehy = [e for e in tflight.recorder().snapshot(etype="restore") if e["seq"] >= n0]
            assert [(e["phase"], e["key"], e["tokens"]) for e in rehy] == [("rehydrate", "doc:0", 4)]
        finally:
            svc.shutdown()


def _prefix_service(side, lparams, wal_dir):
    """The JAX or the port service with the prefix cache on and a WAL in
    ``wal_dir`` (``tests/test_torch_prefix_cache.py``'s settings), warmed
    and over the two documents."""
    from rag_llm_k8s_tpu_torch.models import convert
    from rag_llm_k8s_tpu_torch.models.bge_m3 import build_encoder
    from rag_llm_k8s_tpu.models.bge_m3 import init_encoder_params

    pc = dict(enabled=True, max_prefix_tokens=192, segment_buckets=(16, 32, 64), suffix_buckets=(32, 64, 128),
              hbm_budget_mb=64, boundary_tokens=4, chunk_hot_min=0.0)
    greedy = dict(do_sample=False, max_new_tokens=8)
    eparams = init_encoder_params(jax.random.PRNGKey(1), R.JEncoderConfig.tiny(R.VOCAB), R.JFP32)
    if side == "jax":
        jl, je = R.JLlamaConfig.tiny(R.VOCAB), R.JEncoderConfig.tiny(R.VOCAB)
        eng = R.JEngine(jl, lparams, sampling=R.JSampling(**greedy), dtypes=R.JFP32,
                        engine_config=R.JEngineConfig(**R.HTTP_ENGINE, prefix_cache=JPrefixCacheConfig(**pc)))
        cfg = R.JAppConfig(model=jl, encoder=je, system_message=R.SYSTEM, flight=JFlightConfig(
            spool_dir=tempfile.mkdtemp(prefix="jax_incidents_"), wal=True, wal_dir=wal_dir),
            shadow=R.JShadowConfig(sample_rate=0.0))
        svc = R.JRagService(cfg, eng, R.ByteTokenizer(), R.JEncoderRunner(je, eparams, dtypes=R.JFP32,
                                                                          length_buckets=(32, 64), max_batch=4),
                            R.ByteTokenizer(), R.JStore(dim=je.hidden_size), scheduler=None)
    else:
        lc, ec = R.LlamaConfig.tiny(R.VOCAB), R.EncoderConfig.tiny(R.VOCAB)
        model = convert.load_llama(R.build_llama(lc, R.FP32, CPU), convert.flatten_tree(lparams))
        enc = convert.load_encoder(build_encoder(ec, R.FP32, CPU), convert.flatten_tree(eparams))
        eng = R.InferenceEngine(lc, model, R.SamplingConfig(**greedy),
                                R.EngineConfig(**R.HTTP_ENGINE, prefix_cache=PrefixCacheConfig(**pc)), R.FP32, "cpu")
        cfg = R.AppConfig(model=lc, encoder=ec, engine=eng.engine_config, system_message=R.SYSTEM,
                          flight=FlightConfig(wal=True, wal_dir=wal_dir), shadow=R.ShadowConfig(sample_rate=0.0))
        svc = R.tapp.RagService(cfg, eng, R.ByteTokenizer(), R.EncoderRunner(ec, enc, device="cpu",
                                                                             length_buckets=(32, 64), max_batch=4),
                                R.ByteTokenizer(), R.VectorStore(dim=ec.hidden_size, device="cpu"))
    meta = [{"filename": "f", "chunk_id": i, "text": t} for i, t in enumerate(R.TEXTS)]
    svc.store.add(list(svc.encoder.encode([R.ByteTokenizer().encode(t) for t in R.TEXTS])), meta)
    head_key = f"head:{len(svc._a_ids())}"
    svc.engine.prefix_cache.pin(head_key)
    svc.engine.prefix_cache.prefix_for([(head_key, svc._a_ids())])
    svc.ready = True
    return svc


def test_a_drained_prefix_cache_rehydrates_on_the_next_boot_as_jax(weights, tmp_path):
    """The drain writes the hottest segments next to the WAL, and the next
    incarnation re-prefills them: the same manifest and the same count on
    both sides."""
    params = weights[0]
    manifests, rehydrated, answers = {}, {}, {}
    for side in ("jax", "port"):
        flight_mod = jflight if side == "jax" else tflight
        wal_dir = str(tmp_path / side)
        svc = _prefix_service(side, params, wal_dir)
        try:
            client = (R.jcreate_app if side == "jax" else R.tapp.create_app)(svc).test_client()
            answers[side] = [R._post(side, client, "/generate", {"prompt": q}).get_json()["generated_text"]
                             for q in ("alpha", "delta", "alpha")]
            svc._persist_for_restart()
        finally:
            svc.shutdown()
            flight_mod.configure(wal=None)
        with open(os.path.join(wal_dir, "warmth_manifest.json")) as f:
            manifests[side] = [(e["key"], e["ids"], e["tokens"]) for e in json.load(f)["entries"]]
        svc2 = _prefix_service(side, params, wal_dir)
        try:
            summary = svc2.restore_from_wal(wait=True)
            rehydrated[side] = summary["rehydrated"]
            assert svc2.flight_wal.epoch == 2
        finally:
            svc2.shutdown()
            flight_mod.configure(wal=None)
    assert answers["port"] == answers["jax"]
    assert manifests["port"] == manifests["jax"] and manifests["port"]
    assert rehydrated["port"] == rehydrated["jax"] > 0


# ---------------------------------------------------------------------------
# the chaos pin: SIGKILL mid-decode, restore in a new process
# ---------------------------------------------------------------------------

_CHAOS_COMMON = """
import sys, time, threading
import torch
from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, EngineConfig, LlamaConfig, SamplingConfig
from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine, ContinuousScheduler
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.llama import build_llama
from rag_llm_k8s_tpu_torch.obs import flight

FP32 = DTypePolicy.fp32()
CFG = LlamaConfig.tiny()
ENG_CFG = EngineConfig(prompt_buckets=(16, 32), max_batch_size=4, max_seq_len=64)
SAMP = SamplingConfig(do_sample=False, max_new_tokens=40)
PROMPTS = ([5, 6, 7, 8], [9, 10, 11, 12])

def build_engine():
    model = convert.init_random_(build_llama(CFG, FP32, torch.device("cpu")), torch.Generator().manual_seed(0))
    return ContinuousEngine(CFG, model, SAMP, ENG_CFG, FP32, "cpu")
"""

_CHAOS_VICTIM = _CHAOS_COMMON + """
wal_dir = sys.argv[1]
eng = build_engine()
# a slow window, so that the parent's SIGKILL lands mid-stream
real_step = eng.step
def slow_step(*a, **k):
    time.sleep(0.05)
    return real_step(*a, **k)
eng.step = slow_step
flight.configure(enabled=True, arrival_ids=True, wal=flight.FlightWAL(wal_dir))
sched = ContinuousScheduler(eng, retry_backoff_s=0.0)
for p in PROMPTS:
    threading.Thread(target=lambda p=p: sched.submit(p, max_new_tokens=40, timeout=600), daemon=True).start()
print("VICTIM-UP", flush=True)
time.sleep(600)  # the parent SIGKILLs this process mid-decode
"""

_CHAOS_RESTORER = _CHAOS_COMMON + """
import json
from rag_llm_k8s_tpu_torch.sim import replay

wal_dir, out_path = sys.argv[1], sys.argv[2]
eng = build_engine()
wal = flight.FlightWAL(wal_dir)
flight.configure(enabled=True, arrival_ids=True, wal=wal)
sched = ContinuousScheduler(eng, retry_backoff_s=0.0)
epochs = flight.scan_wal(wal_dir)
dead = [e for e in sorted(epochs) if e < wal.epoch]
records = replay.extract_inflight(epochs[dead[-1]])["inflight"]
out = {}
for rec in records:
    flight.emit("restore", phase="resume", orig_rid=rec["rid"], orig_epoch=dead[-1], n_emitted=len(rec["emitted"]))
    toks = sched.submit(rec["prompt"], max_new_tokens=rec["max_new"], resume_emitted=rec["emitted"], timeout=600)
    out[str(rec["rid"])] = {"prompt": rec["prompt"], "tokens": toks, "n_emitted": len(rec["emitted"])}
with open(out_path, "w") as f:
    json.dump(out, f)
sched.shutdown()
print("RESTORED", flush=True)
"""


def _tiny_oracle_streams():
    """The chaos prompts' uninterrupted greedy streams on an engine built as
    the scripts build theirs (the same seeded weights in every process)."""
    exec_ns = {}
    exec(compile(_CHAOS_COMMON, "chaos_common", "exec"), exec_ns)
    sched = ContinuousScheduler(exec_ns["build_engine"](), retry_backoff_s=0.0)
    try:
        return {tuple(p): sched.submit(p, max_new_tokens=40, timeout=120) for p in exec_ns["PROMPTS"]}
    finally:
        sched.shutdown()


class TestCrashRestartChaos:
    def test_sigkill_mid_decode_then_byte_identical_resume(self, tmp_path):
        """SIGKILL a process with two requests mid-decode, restore a new
        process from the same WAL directory: every stream equals the
        uninterrupted run, and the decoded tokens are not decoded again."""
        wal_dir = str(tmp_path / "wal")
        victim_py = tmp_path / "victim.py"
        victim_py.write_text(_CHAOS_VICTIM)
        env = dict(os.environ, PYTHONPATH=REPO)
        victim = subprocess.Popen([sys.executable, str(victim_py), wal_dir], cwd=REPO, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            t_end = time.monotonic() + 120
            while time.monotonic() < t_end:
                if victim.poll() is not None:
                    pytest.fail("victim exited early:\n" + victim.stdout.read())
                evs = tflight.scan_wal(wal_dir).get(1, [])
                emitted = {e.get("rid") for e in evs if e["type"] == "token_emit"}
                done = {e.get("rid") for e in evs if e["type"] == "complete"}
                if len(emitted) >= 2 and not done:
                    break
                time.sleep(0.05)
            else:
                pytest.fail("the WAL never showed 2 requests mid-decode")
            os.kill(victim.pid, signal.SIGKILL)
            victim.wait(30)
        finally:
            if victim.poll() is None:
                victim.kill()
                victim.wait(30)
            victim.stdout.close()

        dead = treplay.extract_inflight(tflight.scan_wal(wal_dir)[1])
        assert dead == jreplay.extract_inflight(jflight.scan_wal(wal_dir)[1])
        assert len(dead["inflight"]) == 2
        assert all(r["emitted"] and not r["synthetic_prompt"] for r in dead["inflight"])

        restorer_py = tmp_path / "restorer.py"
        restorer_py.write_text(_CHAOS_RESTORER)
        out_path = str(tmp_path / "restored.json")
        r = subprocess.run([sys.executable, str(restorer_py), wal_dir, out_path], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        with open(out_path) as f:
            restored = json.load(f)
        assert len(restored) == 2
        oracle = _tiny_oracle_streams()
        for rec in restored.values():
            assert rec["n_emitted"] >= 1  # resumed, not decoded again
            assert rec["tokens"] == oracle[tuple(rec["prompt"])]
        e2 = tflight.scan_wal(wal_dir)[2]
        resumes = [e for e in e2 if e["type"] == "restore" and e.get("phase") == "resume"]
        assert {e["orig_rid"] for e in resumes} == {r["rid"] for r in dead["inflight"]}
        assert sum(1 for e in e2 if e["type"] == "complete") == 2
