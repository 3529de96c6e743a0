"""The port's shadow quality auditor against the JAX package's, on the CPU.

- **as written**: ``tests/test_shadow.py``'s state and report, auditor
  discipline and config cases run unchanged, once on the JAX modules and
  once with the port's ``obs/shadow.py``, ``ShadowConfig``, ``AppConfig``
  and ``obs/slo.py`` in their place (sampling driven by the JAX tests'
  ``_FixedRng`` or ``force=True``, never by the 5 % draw);
- **the scorer**: ``InferenceEngine.score_exact`` on the same tiny fp32
  weights and the same numpy streams gives JAX's argmax chain exactly and
  its max and chosen logits within 1e-4 (one chunk, several chunks, a
  perturbed stream; int8 KV at the int8 forward's tolerance), raises where
  JAX raises, and records no stats and no goodput window;
- **equal reports**: one event sequence through both modules' ``record``
  gives equal states and reports;
- **the port's approximations audited** (``TestShadowSmoke`` on the port's
  engines): exact-chain prefix reuse and greedy paged speculation audit
  clean with their fingerprints, forced warm-tier serving within the 0.15
  tolerance;
- **the service pair** (``tests/test_torch_resilience.py``'s, shared tiny
  weights, every request selected): the same ``/debug/quality`` report,
  the same ``rag_quality_*`` series and values, 403 unless debug is armed,
  and a divergence burst that spools a ``quality_divergence`` bundle whose
  journal renders the live report and feeds the quality SLO.
"""

import dataclasses
import time
import types

import jax
import numpy as np
import pytest
import test_shadow as jtests  # the JAX shadow tests, run as written on the port below
import test_torch_resilience as pairs_mod  # the JAX/port service pair on shared weights
import torch

from rag_llm_k8s_tpu.core.config import EngineConfig as JEngineConfig
from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
from rag_llm_k8s_tpu.core.config import SamplingConfig as JSampling
from rag_llm_k8s_tpu.engine.engine import InferenceEngine as JEngine
from rag_llm_k8s_tpu.models.llama import init_llama_params
from rag_llm_k8s_tpu.obs import shadow as jshadow
from rag_llm_k8s_tpu_torch.core.config import (
    AppConfig,
    EngineConfig,
    KVTieringConfig,
    LlamaConfig,
    PrefixCacheConfig,
    SamplingConfig,
    ShadowConfig,
)
from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine, ContinuousScheduler
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.llama import build_llama
from rag_llm_k8s_tpu_torch.obs import flight as tflight
from rag_llm_k8s_tpu_torch.obs import shadow as tshadow
from rag_llm_k8s_tpu_torch.obs import slo as tslo

CPU = torch.device("cpu")
FP32 = pairs_mod.FP32
JFP32 = pairs_mod.JFP32
VOCAB = 128
GREEDY = dict(do_sample=False, max_new_tokens=10)
ONESHOT = dict(prompt_buckets=(64,), max_batch_size=2, max_seq_len=256, speculative="off")
LOGIT_TOL = 1e-4
Q8_LOGIT_TOL = 5e-4  # tests/test_torch_quant.py: one int8 rounding step moves a logit ~1e-4
PORT_MODULES = {"obs_shadow": tshadow, "ShadowConfig": ShadowConfig, "AppConfig": AppConfig, "obs_slo": tslo}


@pytest.fixture(params=["jax", "port"])
def side(request, monkeypatch):
    """Which package the as-written tests run on: the port's modules take
    the JAX modules' names in ``tests/test_shadow.py`` for the test."""
    if request.param == "port":
        for name, mod in PORT_MODULES.items():
            monkeypatch.setattr(jtests, name, mod)
    return request.param


def _cases(cls):
    return [n for n in vars(cls) if n.startswith("test_")]


@pytest.mark.parametrize("cls,name", [(c, n) for c in ("TestStateAndReport", "TestAuditorDiscipline")
                                      for n in _cases(getattr(jtests, c))])
def test_the_module_cases_as_written(side, cls, name):
    getattr(getattr(jtests, cls)(), name)()


def test_the_config_cases_as_written(side):
    cases = jtests.TestConfig()
    cases.test_env_round_trip()
    cases.test_defaults_on_at_five_percent()
    for env in ({"TPU_RAG_SHADOW": "2"}, {"TPU_RAG_SHADOW_SAMPLE_RATE": "1.5"}, {"TPU_RAG_SHADOW_BACKLOG": "0"},
                {"TPU_RAG_SHADOW_BURST_WINDOW_S": "0"}):
        cases.test_invalid_values_raise(env)
    cases.test_slo_quality_hostile_env_falls_back()
    cases.test_default_specs_include_the_quality_slo()


# ---------------------------------------------------------------------------
# the scorer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    params = init_llama_params(jax.random.PRNGKey(0), JLlamaConfig.tiny(VOCAB), JFP32)
    model = convert.load_llama(build_llama(LlamaConfig.tiny(VOCAB), FP32, CPU), convert.flatten_tree(params))
    return params, model


def _engines(weights, **ec):
    """The JAX and the port one-shot engine of ``tests/test_shadow.py``
    (``_oneshot``: one 64-token bucket, so the scorer's chunk is 64)."""
    params, _ = weights
    jeng = JEngine(JLlamaConfig.tiny(VOCAB), params, sampling=JSampling(**GREEDY),
                   engine_config=JEngineConfig(**ONESHOT, **ec), dtypes=JFP32)
    return jeng, _port_oneshot(weights, **ec)


def _prompt(n, seed=0):
    rng = np.random.default_rng(seed)
    return [LlamaConfig.tiny(VOCAB).bos_token_id] + [int(t) for t in rng.integers(3, VOCAB, n - 1)]


def _windows(eng):
    """The ledger's state less its wall clock (which runs on regardless)."""
    return {k: v for k, v in eng.ledger.state().items() if k != "wall_s"}


SCORE_CASES = {
    # (prompt length, KV dtype, the emitted position to perturb or None)
    "one_chunk": (7, "bf16", None),
    "three_chunks": (150, "bf16", None),
    "perturbed": (40, "bf16", 3),
    "int8_kv": (90, "int8", None),
}


@pytest.mark.parametrize("case", sorted(SCORE_CASES))
def test_score_exact_matches_jax(weights, case):
    n, kvq, bad_at = SCORE_CASES[case]
    jeng, teng = _engines(weights, kv_quant=kvq)
    prompt = _prompt(n, seed=n)
    out = teng.generate([prompt])[0]
    assert out
    if bad_at is not None:
        out = list(out)
        out[bad_at] = (out[bad_at] + 1) % VOCAB
    stats, windows = dataclasses.asdict(teng.stats), _windows(teng)
    got, want = teng.score_exact(prompt, out), jeng.score_exact(prompt, out)
    tol = Q8_LOGIT_TOL if kvq == "int8" else LOGIT_TOL
    assert got["argmax"].dtype == np.int64 and got["max_logit"].dtype == np.float64
    np.testing.assert_array_equal(got["argmax"], np.asarray(want["argmax"]))
    for k in ("max_logit", "chosen_logit"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=tol, rtol=0)
    if bad_at is None:
        # the engine's own greedy stream is the exact path's argmax chain
        assert [int(t) for t in got["argmax"]] == out
        assert float(np.max(got["max_logit"] - got["chosen_logit"])) == 0.0
    else:
        assert [int(t) for t in got["argmax"][:bad_at]] == out[:bad_at]
        assert int(got["argmax"][bad_at]) != out[bad_at]
        assert got["max_logit"][bad_at] - got["chosen_logit"][bad_at] > 0.0
    # the scorer is not a generate call: no stats, no goodput window
    assert dataclasses.asdict(teng.stats) == stats and _windows(teng) == windows


def test_score_exact_raises_where_jax_raises(weights):
    jeng, teng = _engines(weights)
    cap = teng.engine_config.max_chunked_prompt
    assert cap == jeng.engine_config.max_chunked_prompt
    for prompt, emitted in (([1] * (cap + 1), [2]), ([1, 2, 3], []), ([], [5])):
        for eng in (jeng, teng):
            with pytest.raises(ValueError):
                eng.score_exact(prompt, emitted)


# ---------------------------------------------------------------------------
# equal states and reports
# ---------------------------------------------------------------------------

EVENTS = [
    {"outcome": "clean", "n": 8, "err": 0.0, "approx": ["prefix_reuse"], "tenant": "a"},
    {"outcome": "diverged", "n": 4, "pos": 3, "err": 0.12, "approx": ["warm_tier", "prefix_reuse"], "tenant": "b"},
    {"outcome": "skipped", "reason": "sampled", "n": 0, "tenant": "a"},
    {"outcome": "diverged", "n": 300, "pos": 299, "err": 7.5, "approx": ["splice", "rerotate"]},
    {"outcome": "failed", "n": 0, "approx": ["spec_verify"]},
    {"outcome": "skipped", "reason": "oversize", "n": 0},
    {"outcome": "clean", "n": 2, "err": 0.0},
    {"outcome": "diverged", "n": 1, "pos": 0, "err": 0.15, "approx": ["boundary_fixup"]},
    {"outcome": "bogus"},
]


def test_record_and_render_equal_jax_on_one_event_sequence():
    states = {}
    for name, mod in (("jax", jshadow), ("port", tshadow)):
        st = mod.new_state()
        for ev in EVENTS:
            mod.record(st, dict(ev))
        journal = [dict(ev, type="shadow_audit", seq=len(EVENTS) - i) for i, ev in enumerate(EVENTS)]
        states[name] = (st, mod.render_report(st), mod.render_report(mod.state_from_events(journal)))
    assert states["port"] == states["jax"]
    for name in ("APPROXIMATIONS", "SKIP_REASONS", "ERR_BUCKETS", "POS_BUCKETS", "SCHEMA_VERSION"):
        assert getattr(tshadow, name) == getattr(jshadow, name), name


# ---------------------------------------------------------------------------
# the port's approximations, audited by the port's scorer
# ---------------------------------------------------------------------------

PC = PrefixCacheConfig(enabled=True, hbm_budget_mb=64, max_prefix_tokens=128, segment_buckets=(16, 32, 64),
                       suffix_buckets=(16, 32))
WARM = KVTieringConfig(enabled=True, warm_below=1e9, cold_below=0.01, half_life_s=3600.0, retier_interval_s=3600.0)


def _port_oneshot(weights, **ec):
    return InferenceEngine(LlamaConfig.tiny(VOCAB), weights[1], SamplingConfig(**GREEDY),
                           EngineConfig(**ONESHOT, **ec), FP32, "cpu")


def _segments(rng, tag):
    head = [LlamaConfig.tiny(VOCAB).bos_token_id] + list(map(int, rng.integers(3, 120, 7)))
    chunk = list(map(int, rng.integers(3, 120, 11)))
    return [(f"head:{tag}", head), (f"chunk:{tag}", chunk)]


def _auditor(score_fn, **kw):
    return tshadow.ShadowAuditor(ShadowConfig(sample_rate=1.0, **kw), score_fn=score_fn)


def test_exact_chain_prefix_reuse_audits_clean(weights):
    eng = _port_oneshot(weights, prefix_cache=PC)
    aud = _auditor(eng.score_exact)
    rng = np.random.default_rng(9)
    segments = _segments(rng, "smoke")
    suffix = list(map(int, rng.integers(3, 120, 6)))
    prompt = [t for _, seg in segments for t in seg] + suffix
    try:
        approx = []
        for _ in range(2):  # built, then served from the memo
            cp = eng.prefix_cache.prefix_for(segments)
            out = eng.generate_prefixed(suffix, cp)
            assert out
            approx.append(cp.approx)
            aud.observe(out, approx=cp.approx, prompt_ids=prompt, force=True)
        assert aud.drain(timeout=60.0)
        st = aud.stats()
        assert approx[0] == () and "prefix_reuse" in approx[1]
        assert st["audits_clean"] == 2.0 and st["audits_diverged"] == 0.0
        assert st["attr_prefix_reuse_clean"] == 1.0 and st["attr_none_clean"] == 1.0
    finally:
        aud.shutdown()


def test_forced_warm_tier_audits_within_the_tolerance(weights):
    eng = _port_oneshot(weights, prefix_cache=PC, kv_tiering=WARM)
    aud = _auditor(eng.score_exact)
    cache = eng.prefix_cache
    rng = np.random.default_rng(13)
    try:
        audited = 0
        for tag in ("w0", "w1", "w2"):
            segments = _segments(rng, tag)
            suffix = list(map(int, rng.integers(3, 120, 6)))
            cache.prefix_for(segments)
            assert cache.force_demote("warm") == 2
            cache._assembled.clear()
            cache.assembled_bytes = 0
            cp = cache.prefix_for(segments)
            assert "warm_tier" in cp.approx
            out = eng.generate_prefixed(suffix, cp)
            assert out
            aud.observe(out, approx=cp.approx, prompt_ids=[t for _, s in segments for t in s] + suffix, force=True)
            audited += 1
        assert aud.drain(timeout=60.0)
        st = aud.stats()
        judged = st["audits_clean"] + st["audits_diverged"]
        assert judged == audited and st["audits_failed"] == 0.0
        assert st["attr_warm_tier_clean"] + st["attr_warm_tier_diverged"] == judged
        assert tshadow.render_report(aud.state())["logit_err"]["max"] <= 0.15 + 1e-6
    finally:
        aud.shutdown()


@pytest.mark.parametrize("ledger_on", [True, False])
def test_greedy_paged_speculation_audits_clean_with_its_fingerprint(weights, ledger_on):
    """The verify fingerprint comes from the engine's state, so the goodput
    ledger off must not erase it; the stream audits clean."""
    from rag_llm_k8s_tpu_torch.core.config import GoodputConfig

    _, model = weights
    eng = ContinuousEngine(
        LlamaConfig.tiny(VOCAB), model, sampling=SamplingConfig(**GREEDY), dtypes=FP32, device="cpu",
        engine_config=EngineConfig(prompt_buckets=(16, 32), max_batch_size=4, max_seq_len=64, kv_paged=True,
                                   kv_block_size=16, spec_paged=True, spec_paged_tokens=4,
                                   goodput=GoodputConfig(enabled=ledger_on)),
    )
    sched = ContinuousScheduler(eng)
    aud = _auditor(_port_oneshot(weights).score_exact)
    try:
        for p in ([5, 7] * 5, [11] * 8):
            info = {}
            out = sched.submit(p, max_new_tokens=10, timeout=120, info=info)
            assert out and "spec_verify" in info.get("approx", ())
            aud.observe(out, approx=tuple(info["approx"]), request_id=info.get("request_id"), prompt_ids=p,
                        force=True)
        assert aud.drain(timeout=60.0)
        st = aud.stats()
        assert st["audits_clean"] == 2.0 and st["divergence_rate"] == 0.0
        assert st["attr_spec_verify_clean"] == 2.0
        assert eng.stats.spec_accepted_tokens > 0 and not eng._spec_rids
    finally:
        sched.shutdown()
        aud.shutdown()


# ---------------------------------------------------------------------------
# the service pair
# ---------------------------------------------------------------------------


# the process recorder's event count when the pair was built: its journal
# starts there (an earlier file in the same xdist worker may have journaled
# audits of its own services into the same recorder)
PAIR_SEQ = [0]


@pytest.fixture(scope="module")
def pair():
    PAIR_SEQ[0] = tflight.recorder().events_emitted
    pr = pairs_mod._make_pair("coalesce", shadow=dict(sample_rate=1.0, burst_window_s=300.0))
    yield pr
    for svc, _ in pr.values():
        svc.shutdown()


def _armed(pair, monkeypatch):
    for svc, _ in pair.values():
        monkeypatch.setattr(svc, "config", dataclasses.replace(
            svc.config, flight=dataclasses.replace(svc.config.flight, debug_endpoints=True)))


def _quality_series(client):
    from test_torch_obs import _exposition

    fams, samples = _exposition(client.get("/metrics").get_data(as_text=True))
    return ({k: v for k, v in fams.items() if k.startswith("rag_quality_")},
            {k: v for k, v in samples.items() if k[0].startswith("rag_quality_") and not k[0].endswith("_sum")})


def test_debug_quality_and_the_quality_families_match_jax(pair, monkeypatch):
    monkeypatch.delenv("TPU_RAG_FAULTS", raising=False)
    monkeypatch.delenv("TPU_RAG_DEBUG", raising=False)
    codes = {side: client.get("/debug/quality").status_code for side, (_, client) in pair.items()}
    assert codes == {"jax": 403, "port": 403}
    for side, (svc, client) in pair.items():
        r = pairs_mod._post(side, client, "/query", {"prompt": "alpha"})
        assert r.status_code == 200, side
        assert svc.shadow.drain(timeout=60.0), side
    _armed(pair, monkeypatch)
    reps = {side: client.get("/debug/quality").get_json() for side, (_, client) in pair.items()}
    assert reps["port"] == reps["jax"]
    assert reps["port"]["enabled"] and reps["port"]["report"]["audits"]["clean"] == 1
    assert reps["port"]["sampling"]["seen"] == reps["port"]["sampling"]["selected"] == 1
    series = {side: _quality_series(client) for side, (_, client) in pair.items()}
    assert series["port"] == series["jax"]  # # TYPE / # HELP, labels, buckets and values
    assert series["port"][1][("rag_quality_audits_total", '{outcome="clean"}')] == 1.0


def test_a_divergence_burst_spools_a_bundle_that_renders_the_live_report(pair, monkeypatch):
    monkeypatch.delenv("TPU_RAG_FAULTS", raising=False)
    _armed(pair, monkeypatch)
    svc, client = pair["port"]
    n0 = tflight.recorder().events_emitted
    prompt = _prompt(7)
    bad = list(svc.engine.generate([prompt])[0])
    bad[1] = (bad[1] + 1) % VOCAB
    before = client.get("/debug/quality").get_json()["report"]["audits"]
    snap0 = svc.metrics.snapshot()
    for _ in range(2):  # the second diverged audit inside the window is the burst
        svc.shadow.observe(bad, approx=("warm_tier",), prompt_ids=prompt, force=True)
        assert svc.shadow.drain(timeout=60.0)
    incidents = client.get("/debug/incidents").get_json()["incidents"]
    bid = [i["id"] for i in incidents if i["trigger"] == "quality_divergence"]
    assert len(bid) == 1
    bundle = client.get(f"/debug/incidents?id={bid[0]}").get_json()
    types_ = [e["type"] for e in bundle["journal"] if e["seq"] >= n0]
    assert types_.count("shadow_audit") == 2 and types_.count("quality_divergence") == 2
    live = client.get("/debug/quality").get_json()["report"]
    assert live["audits"]["diverged"] == before["diverged"] + 2 and live["attribution"]["warm_tier"]["diverged"] == 2
    assert live["first_divergence_token"]["hist"]["le_1"] == 2
    # the journal the service wrote renders the live report
    journal = [e for e in svc.flight.snapshot() if e["seq"] >= PAIR_SEQ[0]]
    assert tshadow.render_report(tshadow.state_from_events(journal)) == live
    # the histograms feed the quality SLO
    time.sleep(0.3)  # past the 0.25 s stats memo
    snap = svc.metrics.snapshot()
    assert snap["rag_quality_divergence_rate"] == pytest.approx(live["divergence_rate"], abs=1e-6)
    for name in ("rag_quality_logit_err_count", "rag_quality_first_divergence_token_count"):
        assert snap[name] - snap0[name] == 2, name
    slo = {e["name"]: e for e in client.get("/slo?force=1").get_json()["slos"]}["quality_p99_logit_err"]
    assert slo["metric"] == "rag_quality_logit_err"
    assert max(slo["window_events"].values()) == live["audits"]["clean"] + live["audits"]["diverged"]


def test_a_sampled_stream_counts_as_a_sampled_skip(pair):
    svc, _ = pair["port"]
    before = svc.shadow.stats()
    svc._shadow_observe(types.SimpleNamespace(sampling=SamplingConfig()), [5, 6], {}, prompt_ids=[1, 2])
    svc._shadow_observe(svc.engine, [5, 6], {}, prompt_ids=[1, 2], sampling=SamplingConfig(temperature=0.7))
    assert svc.shadow.drain(timeout=10.0)
    after = svc.shadow.stats()
    assert after["skip_sampled"] - before["skip_sampled"] == 2.0
    assert after["audits_clean"] == before["audits_clean"]
