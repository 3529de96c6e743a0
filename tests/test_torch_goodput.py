"""The port's goodput ledger against the JAX package's, on the CPU.

- **the module**: ``tests/test_goodput.py``'s ``TestRoofline`` and
  ``TestLedgerUnits`` cases on both packages' ``obs/goodput.py``, and one
  scripted sequence of ``record_*`` calls through both ledgers (peaks pinned
  on both sides) giving equal window summaries, states, tenant rollups,
  reports and journal reconstructions. The port's default peaks are the
  H100 SXM's (989 dense bf16 TFLOP/s, 3,350 GB/s), and no TPU figure is
  written in the port's sources;
- **the engines**: through the port's paged scheduler, the attributed chip
  time of a mixed-length burst sums to ``busy_seconds()`` within 5% and
  every ``goodput_window`` event's categories sum to its ``dur_ms``;
  preemption and reset rework is attributed once; the ledger off attributes
  nothing; the one-shot window fills ``info``; spec stats reach the
  request; ``state_from_events`` of the journal renders the live report;
  one burst through the JAX and the port scheduler on shared weights
  records the same windows and tokens per kind; and behind a router with
  prefill- and decode-role engines each engine books its own windows and
  the request's tenant, as the JAX engines do;
- **the service pair** (``tests/test_torch_resilience.py``'s, shared tiny
  weights): ``/debug/goodput`` with the JAX keys, equal windows and tokens
  per kind and the same categories present, 403 unless debug is armed, the
  same ``/generate`` timings keys, and the merge over both engines of one
  service.
"""

import contextlib
import dataclasses
import os
import re
import threading

import jax
import pytest
import test_torch_resilience as pairs_mod  # the JAX/port service pair on shared weights

from rag_llm_k8s_tpu.models.llama import init_llama_params
from rag_llm_k8s_tpu.obs import goodput as jgoodput
from rag_llm_k8s_tpu_torch.core.config import EngineConfig, GoodputConfig, LlamaConfig, SamplingConfig
from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine, ContinuousScheduler
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.llama import build_llama
from rag_llm_k8s_tpu_torch.obs import flight as tflight
from rag_llm_k8s_tpu_torch.obs import goodput as tgoodput
from rag_llm_k8s_tpu_torch.resilience import faults as tfaults

GP = {"jax": jgoodput, "port": tgoodput}
FP32 = pairs_mod.FP32
GREEDY = SamplingConfig(do_sample=False, max_new_tokens=24)
# sync=4, as the JAX tests: the busy timer also covers the ledger's own
# bookkeeping per window, which sub-ms windows would not amortize
PAGED = EngineConfig(prompt_buckets=(16, 32), max_batch_size=4, max_seq_len=128, kv_paged=True, kv_block_size=16,
                     decode_sync_steps=4)
MIXED_PROMPTS = [[3, 17, 42, 7, 99], [5, 5, 8], [11] * 12, [2, 9], [4] * 20, [7, 8, 9, 10, 11, 12]]
PORT_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rag_llm_k8s_tpu_torch")


@pytest.fixture(autouse=True)
def _clean_faults():
    tfaults.clear()
    yield
    tfaults.clear()


@pytest.fixture(params=sorted(GP))
def gp(request):
    return GP[request.param]


def _roofline(mod, **kw):
    return mod.roofline_for_llama(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=16,
                                  intermediate_size=128, vocab_size=256, **kw)


# ---------------------------------------------------------------------------
# tests/test_goodput.py TestRoofline and TestLedgerUnits, on both modules
# ---------------------------------------------------------------------------


class TestRoofline:
    def test_figures_and_ridge(self, gp):
        rf = _roofline(gp)
        assert rf.flops_per_token > 0 and rf.weight_bytes > 0 and rf.kv_bytes_per_token > 0
        assert rf.ridge == pytest.approx(rf.peak_flops / rf.peak_bytes)
        assert 0.0 < rf.splice_weight <= 1.0

    def test_classification_compute_vs_bandwidth(self, gp):
        rf = _roofline(gp)
        assert rf.classify(rf.peak_flops, rf.peak_bytes / 100) == "compute"
        assert rf.classify(rf.flops_per_token, rf.weight_bytes) == "bandwidth"

    def test_int8_variants_change_bytes_not_flops(self, gp):
        base = _roofline(gp)
        w8 = gp.roofline_for_llama(2, 64, 4, 2, 16, 128, 256, weight_bytes_per_param=1.0)
        kv8 = gp.roofline_for_llama(2, 64, 4, 2, 16, 128, 256, kv_quant="int8")
        assert w8.flops_per_token == base.flops_per_token
        assert w8.weight_bytes == pytest.approx(base.weight_bytes / 2)
        assert base.kv_bytes_per_token / 2 < kv8.kv_bytes_per_token < base.kv_bytes_per_token

    def test_peak_overrides(self, gp):
        rf = gp.roofline_for_llama(2, 64, 4, 2, 16, 128, 256, peak_tflops=100.0, hbm_gbs=500.0)
        assert rf.peak_flops == pytest.approx(100e12)
        assert rf.peak_bytes == pytest.approx(500e9)


class TestLedgerUnits:
    def test_decode_window_conserves_and_splits_equally(self, gp):
        led = gp.GoodputLedger(_roofline(gp))
        w = led.record_decode(0.1, batch=4, steps=2, kept={1: 2, 2: 1})
        assert sum(w[c] for c in gp.WINDOW_CATEGORIES if c in w) == pytest.approx(w["dur_ms"], rel=1e-6)
        assert w["decode_useful"] == pytest.approx(100.0 * 3 / 8, rel=1e-6)
        r1, r2 = led.pop_request(1), led.pop_request(2)
        assert r1["chip_ms"] == pytest.approx(50.0, rel=1e-6)
        assert r2["chip_ms"] == pytest.approx(50.0, rel=1e-6)
        assert r1["goodput_frac"] > r2["goodput_frac"]
        assert led.pop_request(1) is None

    def test_disabled_ledger_records_nothing(self, gp):
        led = gp.GoodputLedger(_roofline(gp), enabled=False)
        assert led.record_decode(0.1, 4, 2, {1: 2}) is None
        assert led.pop_request(1) is None
        assert led.state()["busy_s"] == 0.0

    def test_prefill_rework_attributed_not_useful(self, gp):
        led = gp.GoodputLedger(_roofline(gp))
        w = led.record_prefill(0.1, bucket=16, rows={1: 8, 2: 8}, rework={2})
        assert w["prefill_compute"] == pytest.approx(25.0, rel=1e-6)
        assert w["preempt_rework"] == pytest.approx(25.0, rel=1e-6)
        r1, r2 = led.pop_request(1), led.pop_request(2)
        assert r1["chip_ms"] == pytest.approx(r2["chip_ms"])
        assert r1["goodput_frac"] > 0.0 and r2["goodput_frac"] == 0.0

    def test_prefill_px_skipped_weighting(self, gp):
        led = gp.GoodputLedger(_roofline(gp))
        w = led.record_prefill_px(0.1, bucket=8, rid=1, computed=8, skipped=64)
        assert 0.0 < w["prefill_skipped"] < w["prefill_compute"] * 64 / 8
        assert sum(w[c] for c in gp.WINDOW_CATEGORIES if c in w) == pytest.approx(w["dur_ms"], rel=1e-6)

    def test_verify_window_spec_stats_reach_the_request(self, gp):
        led = gp.GoodputLedger(_roofline(gp))
        led.record_verify(0.1, batch=2, lanes_per_row=5, rows={1: (4, 4, 3), 2: (1, 2, 0)})
        led.record_verify(0.1, batch=2, lanes_per_row=5, rows={1: (2, 3, 1), 2: (1, 0, 0)})
        r1 = led.pop_request(1)
        assert r1["spec_drafted"] == 7 and r1["spec_accepted"] == 4
        assert r1["spec_accept_len_mean"] == pytest.approx(2.0)
        r2 = led.pop_request(2)
        assert r2["spec_drafted"] == 2 and r2["spec_accepted"] == 0
        assert r2["spec_accept_len_mean"] == pytest.approx(0.0)

    def test_cost_usd_appears_only_when_priced(self, gp):
        led = gp.GoodputLedger(_roofline(gp), chip_hour_usd=3.6)
        led.record_decode(1.0, batch=1, steps=1, kept={1: 1})
        assert led.pop_request(1)["cost_usd"] == pytest.approx(0.001, rel=1e-6)
        led2 = gp.GoodputLedger(_roofline(gp))
        led2.record_decode(1.0, batch=1, steps=1, kept={1: 1})
        assert "cost_usd" not in led2.pop_request(1)

    def test_merge_and_render(self, gp):
        a, b = gp.GoodputLedger(_roofline(gp)), gp.GoodputLedger(_roofline(gp))
        a.record_decode(0.2, 2, 1, {1: 1})
        b.record_prefill(0.1, 16, {2: 8})
        merged = gp.merge_states([a.state(), b.state()])
        assert merged["busy_s"] == pytest.approx(0.3, rel=1e-6)
        report = gp.render_report(merged, chip_hour_usd=1.0)
        assert sum(v["frac"] for c, v in report["categories"].items() if c != "idle") == pytest.approx(1.0, rel=1e-6)
        assert report["conservation"]["ratio"] == pytest.approx(1.0, rel=1e-6)
        assert set(report["kinds"]) == {"decode", "prefill"}
        assert report["cost"]["chip_hour_usd"] == 1.0


def _script(mod):
    """One ledger through every ``record_*`` kind, tenants and pops: the
    window summaries, the state (wall clock aside), the tenant rollups, the
    pops and the journal it would write."""
    led = mod.GoodputLedger(_roofline(mod, peak_tflops=500.0, hbm_gbs=2000.0), chip_hour_usd=2.0)
    for rid, t in ((1, "a"), (2, "b"), (3, "a")):
        led.note_tenant(rid, t)
    wins = [
        led.record_prefill(0.03, bucket=16, rows={1: 9, 2: 12}, rework={2}),
        led.record_decode(0.02, batch=4, steps=4, kept={1: 4, 2: 3}, ctx_tokens=40),
        led.record_prefill_px(0.01, bucket=8, rid=3, computed=5, skipped=48),
        led.record_verify(0.015, batch=4, lanes_per_row=5, rows={1: (3, 4, 2), 3: (1, 2, 0)}, ctx_tokens=70),
        led.record_mixed(0.025, batch=4, lanes=8, decode_kept={1: 1, 3: 0}, chunk_rows={2: 8}, rework={2},
                         ctx_tokens=90),
        led.record_preempt_stall(0.004, [2]),
        led.record_preempt_stall(0.002, [3], kind="prefill"),
        led.record_oneshot(0.5, bucket=32, batch=2, computed_tokens=40, decode_tokens=30, decode_steps=20,
                           skipped=10),
    ]
    pops = [led.pop_request(r, tokens=n) for r, n in ((1, 9), (2, 4), (3, 1))]
    state = led.state()
    state.pop("wall_s")
    events = [dict(w, type="goodput_window", t=float(i)) for i, w in enumerate(wins)]
    events += [{"type": "complete", "t": 9.0, "chip_ms": p["chip_ms"]} for p in pops]
    rebuilt = mod.state_from_events(events)
    return wins, pops, state, led.tenant_state(), rebuilt, mod.render_report(rebuilt, chip_hour_usd=2.0)


def test_the_same_records_give_the_jax_summaries_states_and_reports():
    got = {side: _script(mod) for side, mod in GP.items()}
    assert got["port"] == got["jax"]
    wins, pops, state, tenants, _, report = got["port"]
    assert {w["kind"] for w in wins} == set(tgoodput.KINDS)
    assert set(tenants) == {"a", "b"} and all(p["cost_usd"] > 0 for p in pops)
    assert report["kinds"]["oneshot"]["windows"] == 1
    assert tgoodput.CATEGORIES == jgoodput.CATEGORIES and tgoodput.KINDS == jgoodput.KINDS


def test_the_port_default_peaks_are_the_h100_s():
    rf = _roofline(tgoodput)
    assert (rf.peak_flops, rf.peak_bytes) == (989e12, 3350e9)
    assert (tgoodput.DEFAULT_PEAK_TFLOPS, tgoodput.DEFAULT_HBM_GBS) == (989.0, 3350.0)
    led = tgoodput.ledger_for(LlamaConfig.tiny(), EngineConfig())
    assert (led.roofline.peak_flops, led.roofline.peak_bytes) == (989e12, 3350e9)
    pinned = tgoodput.ledger_for(LlamaConfig.tiny(), EngineConfig(goodput=GoodputConfig(peak_tflops=100.0,
                                                                                        hbm_gbs=500.0)))
    assert (pinned.roofline.peak_flops, pinned.roofline.peak_bytes) == (100e12, 500e9)
    # no TPU figure (the JAX defaults: 275 TFLOP/s, 1,200 GB/s) in the port's sources
    tpu = re.compile(r"\b(275|1,?200)(\.0)?\b|TPU[- ]?v4")
    hits = []
    for root, _, files in os.walk(PORT_ROOT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f), encoding="utf-8") as fh:
                    hits += [f"{f}:{i}" for i, line in enumerate(fh, 1) if tpu.search(line)]
    assert not hits, hits


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """The tiny JAX parameters and the port's model loaded from them."""
    params = init_llama_params(jax.random.PRNGKey(0), pairs_mod.JLlamaConfig.tiny(), pairs_mod.JFP32)
    return params, convert.load_llama(build_llama(LlamaConfig.tiny(), FP32, "cpu"), convert.flatten_tree(params))


@pytest.fixture(scope="module")
def model(weights):
    return weights[1]


def _burst(sched, prompts, **kw):
    infos, outs = [{} for _ in prompts], [None] * len(prompts)

    def run(i):
        outs[i] = sched.submit(prompts[i], timeout=120, info=infos[i], **kw)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(o is not None for o in outs)
    return outs, infos


def _windows(seq0):
    return [e for e in tflight.recorder().snapshot(etype="goodput_window") if e["seq"] >= seq0]


@contextlib.contextmanager
def _scheduler(model, ec, **kw):
    eng = ContinuousEngine(LlamaConfig.tiny(), model, GREEDY, ec, FP32, "cpu")
    sched = ContinuousScheduler(eng, **kw)
    try:
        yield eng, sched
    finally:
        sched.shutdown()


def test_a_mixed_length_burst_conserves_chip_time(model):
    tflight.configure(enabled=True, capacity=8192)
    seq0 = tflight.recorder().events_emitted
    with _scheduler(model, PAGED) as (eng, sched):
        _, infos = _burst(sched, MIXED_PROMPTS)
        total = 0.0
        for info in infos:
            g = info["goodput"]
            assert g["chip_ms"] > 0 and 0.0 < g["goodput_frac"] <= 1.0
            total += g["chip_ms"] / 1e3
        busy = sched.busy_seconds()
        assert busy > 0 and abs(total - busy) / busy < 0.05, (total, busy)
    events = _windows(seq0)
    assert events
    seen = {c: 0.0 for c in tgoodput.WINDOW_CATEGORIES}
    for e in events:
        assert sum(e.get(c, 0.0) for c in tgoodput.WINDOW_CATEGORIES) == pytest.approx(e["dur_ms"], abs=0.01)
        for c in seen:
            seen[c] += e.get(c, 0.0)
    assert seen["prefill_compute"] > 0 and seen["decode_useful"] > 0 and seen["padding_bubble"] > 0


def test_preemption_rework_is_attributed_once(model):
    # 8 blocks of 16: rows of 12-token prompts decoding 80 tokens collide
    with _scheduler(model, dataclasses.replace(PAGED, kv_pool_blocks=8)) as (eng, sched):
        _, infos = _burst(sched, [[11] * 12, [7] * 12, [3] * 12, [9] * 12], max_new_tokens=80)
        st = eng.ledger.state()
        assert eng.kv_pool.blocks_in_use() == 0
        assert eng.stats.preemptions > 0 and st["categories"]["preempt_rework"] > 0
        total = sum(i["goodput"]["chip_ms"] / 1e3 for i in infos)
        busy = sched.busy_seconds()
        assert abs(total - busy) / busy < 0.05, (total, busy)
        # at most once per re-feeding admission: within the admissions' time
        # and the stalls' (a window that preempted every row)
        adm = sum(st["kinds"].get(k, {}).get("busy_s", 0.0) for k in ("prefill", "prefill_px"))
        stalls = sum(e.get("preempt_rework", 0.0) / 1e3 for e in tflight.recorder().snapshot(etype="goodput_window")
                     if e.get("kind") == "decode" and e.get("tokens") == 0)
        assert st["categories"]["preempt_rework"] <= adm + stalls + 1e-9


def test_a_reset_resubmission_is_rework(model):
    with _scheduler(model, PAGED, retry_backoff_s=0.0) as (eng, sched):
        tfaults.arm("decode_step", times=1)
        info = {}
        assert sched.submit([3, 17, 42], timeout=120, info=info)
        assert info["goodput"]["chip_ms"] > 0
        assert eng.ledger.state()["categories"]["preempt_rework"] > 0


def test_the_ledger_off_attributes_nothing(model):
    seq0 = tflight.recorder().events_emitted
    with _scheduler(model, dataclasses.replace(PAGED, goodput=GoodputConfig(enabled=False))) as (eng, sched):
        info = {}
        assert sched.submit([3, 17, 42], timeout=120, info=info)
        assert "goodput" not in info
        assert eng.ledger.state()["busy_s"] == 0.0
        assert not _windows(seq0)


def test_the_one_shot_window_fills_info(model):
    eng = InferenceEngine(LlamaConfig.tiny(), model, GREEDY,
                          EngineConfig(prompt_buckets=(16, 32), max_batch_size=2, max_seq_len=64,
                                       goodput=GoodputConfig(chip_hour_usd=3.6)), FP32, "cpu")
    info = {}
    assert eng.generate([[3, 17, 42, 7]], info=info)[0]
    g = info["goodput"]
    assert g["chip_ms"] > 0 and 0.0 < g["goodput_frac"] <= 1.0 and g["cost_usd"] > 0
    st = eng.ledger.state()
    assert st["kinds"]["oneshot"]["windows"] == 1
    assert st["categories"]["prefill_compute"] > 0 and st["categories"]["decode_useful"] > 0
    # a chunked call (3 prompts past a batch cap of 2) records per sub-batch
    # and accumulates one share
    info = {}
    eng.generate([[3, 4, 5], [6, 7, 8], [9, 9, 9]], info=info)
    assert eng.ledger.state()["kinds"]["oneshot"]["windows"] == 3
    assert info["goodput"]["chip_ms"] > 0


def test_spec_stats_reach_the_request(model):
    spec = dataclasses.replace(PAGED, spec_paged=True, spec_paged_tokens=4, decode_sync_steps=1)
    with _scheduler(model, spec) as (eng, sched):
        info = {}
        assert sched.submit([3, 17, 42, 3, 17, 42, 3, 17], timeout=120, info=info)
        g = info["goodput"]
        assert g["spec_drafted"] > 0 and g["spec_accept_len_mean"] >= 0.0
        assert g["spec_drafted"] == eng.stats.spec_drafted_tokens
        assert g["spec_accepted"] == eng.stats.spec_accepted_tokens


def test_the_journal_rebuilds_the_live_report(model):
    tflight.configure(enabled=True, capacity=8192)
    seq0 = tflight.recorder().events_emitted
    with _scheduler(model, PAGED) as (eng, sched):
        _burst(sched, MIXED_PROMPTS[:4])
        live = tgoodput.render_report(eng.ledger.state())
    events = [e for e in tflight.recorder().snapshot() if e["seq"] >= seq0]
    offline = tgoodput.render_report(tgoodput.state_from_events(events))
    for c in tgoodput.WINDOW_CATEGORIES:
        assert offline["categories"][c]["chip_s"] == pytest.approx(live["categories"][c]["chip_s"], abs=2e-3)
    assert {k: (v["windows"], v["tokens"]) for k, v in offline["kinds"].items()} == \
        {k: (v["windows"], v["tokens"]) for k, v in live["kinds"].items()}
    assert offline["cost"]["per_query_chip_ms"]["n"] == live["cost"]["per_query_chip_ms"]["n"] == 4


@pytest.mark.parametrize("mode", sorted(pairs_mod.MODES))
def test_one_burst_records_the_jax_windows(weights, mode):
    got = {}
    for name, side in pairs_mod.SIDES.items():
        _, _, eng = pairs_mod.run_burst(side, weights, pairs_mod.MODES[mode])
        st = eng.ledger.state()
        got[name] = ({k: (v["windows"], v["tokens"], v["bound"]) for k, v in st["kinds"].items()},
                     {c for c, v in st["categories"].items() if v > 0})
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# the service pair
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pairs():
    made = {}

    def get(mode):
        if mode not in made:
            made[mode] = pairs_mod._make_pair(mode)
        return made[mode]

    yield get
    for pair in made.values():
        for svc, _ in pair.values():
            svc.shutdown()


@contextlib.contextmanager
def armed(pair):
    """``TPU_RAG_DEBUG=1`` on both services."""
    old = {}
    for side, (svc, _) in pair.items():
        old[side] = svc.config
        svc.config = dataclasses.replace(svc.config, flight=dataclasses.replace(svc.config.flight,
                                                                                debug_endpoints=True))
    try:
        yield
    finally:
        for side, (svc, _) in pair.items():
            svc.config = old[side]


def _get(pair, path):
    return {side: client.get(path) for side, (_, client) in pair.items()}


@pytest.mark.parametrize("mode", [None, "continuous"])
def test_debug_goodput_serves_the_jax_report(pairs, mode, monkeypatch):
    pair = pairs(mode)
    monkeypatch.delenv("TPU_RAG_FAULTS", raising=False)
    before = {side: svc.goodput_report()["kinds"] for side, (svc, _) in pair.items()}
    for q in ("alpha", "delta epsilon", "alpha beta"):
        r = {side: pairs_mod._post(side, client, "/generate", {"prompt": q}) for side, (_, client) in pair.items()}
        assert [x.status_code for x in r.values()] == [200, 200]
        t = {side: x.get_json()["timings"] for side, x in r.items()}
        assert set(t["port"]) == set(t["jax"])
        assert t["port"]["chip_ms"] > 0 and 0.0 < t["port"]["goodput_frac"] <= 1.0
    assert {s: r.status_code for s, r in _get(pair, "/debug/goodput").items()} == {"jax": 403, "port": 403}
    with armed(pair):
        got = {s: r.get_json() for s, r in _get(pair, "/debug/goodput").items()}
    rep, jrep = got["port"], got["jax"]
    assert sorted(rep) == sorted(jrep)
    assert sorted(rep["categories"]) == sorted(jrep["categories"]) == sorted(tgoodput.CATEGORIES)
    assert sorted(rep["cost"]) == sorted(jrep["cost"])

    def new(side, report):
        return {k: (v["windows"] - before[side].get(k, {}).get("windows", 0),
                    v["tokens"] - before[side].get(k, {}).get("tokens", 0)) for k, v in report["kinds"].items()}

    assert new("port", rep) == new("jax", jrep)
    assert {c for c, v in rep["categories"].items() if v["chip_s"] > 0} == \
        {c for c, v in jrep["categories"].items() if v["chip_s"] > 0}
    assert sum(v["frac"] for c, v in rep["categories"].items() if c != "idle") == pytest.approx(1.0, rel=1e-4)
    # continuous windows attribute all their time to requests; one-shot
    # windows attribute none (a one-shot share rides the call's info)
    assert rep["conservation"]["ratio"] == pytest.approx(jrep["conservation"]["ratio"], abs=1e-3)
    assert rep["conservation"]["ratio"] == pytest.approx(0.0 if mode is None else 1.0, abs=1e-3)
    assert all(v["bound"] in ("compute", "bandwidth") for v in rep["kinds"].values())


def test_debug_goodput_merges_both_engines_of_a_service(pairs):
    svc, client = pairs("continuous")["port"]
    errs = []

    def sched_traffic():
        try:
            for i in range(3):
                svc.scheduler.submit([5 + i, 7, 9, 7, 9], timeout=120)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    def oneshot_traffic():
        try:
            for i in range(2):
                svc.engine.generate([[3 + i, 8, 11]])
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=sched_traffic), threading.Thread(target=oneshot_traffic)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs, errs
    report = svc.goodput_report()
    assert report["kinds"]["oneshot"]["windows"] > 0
    assert report["kinds"].get("decode", {}).get("windows", 0) + report["kinds"].get("prefill", {}).get("windows", 0)
    assert sum(v["frac"] for c, v in report["categories"].items() if c != "idle") == pytest.approx(1.0, rel=1e-4)
    for e in (svc.engine, svc.scheduler.engine):
        assert e.ledger.state()["busy_s"] <= report["busy_s"] + 1e-9
    # the price is the highest of the engines' ledgers
    svc.scheduler.engine.ledger.chip_hour_usd = 2.5
    try:
        assert svc._goodput_price() == 2.5 and svc.goodput_report()["cost"]["chip_hour_usd"] == 2.5
    finally:
        svc.scheduler.engine.ledger.chip_hour_usd = 0.0


def test_a_disaggregated_request_is_attributed_on_both_engines_as_jax(weights):
    """Prefill- and decode-role engines behind a router: each engine's ledger
    records its own windows and books the request to its tenant (the decode
    side stamps the tenant at the migration import); the two ledgers merge
    into one report. The same on both packages, on shared weights."""
    import test_torch_router as rt

    params, model = weights
    got = {}
    for name in ("jax", "port"):
        if name == "port":
            pre, dec, router = rt.port_pair(model)
        else:
            pre, dec = rt.jax_sched(params, pool_role="prefill"), rt.jax_sched(params, pool_role="decode")
            router = rt.jrouter.Router([rt.jrouter.Replica("prefill-0", pre), rt.jrouter.Replica("decode-0", dec)])
        try:
            infos = []
            for p in rt.PROMPTS[:3]:
                info = {}
                router.submit(p, info=info, tenant="t-disagg")
                infos.append(info)
            assert all(i["goodput"]["chip_ms"] > 0 for i in infos)
            states = [s.engine.ledger.state() for s in (pre, dec)]
            merged = GP[name].merge_states(states)
            got[name] = (
                [{k: (v["windows"], v["tokens"]) for k, v in st["kinds"].items()} for st in states],
                [{t: r["requests"] for t, r in s.engine.ledger.tenant_state().items()} for s in (pre, dec)],
                sorted(merged["kinds"]),
            )
        finally:
            pre.shutdown()
            dec.shutdown()
    assert got["port"] == got["jax"]
    assert got["port"][1] == [{"t-disagg": 3.0}, {"t-disagg": 3.0}]
    assert "prefill" in got["port"][0][0] and "decode" in got["port"][0][1]
