"""The one-shot engine's device loops against the JAX package's
``lax.while_loop`` generate, on the same tiny fp32 weights.

The vanilla decode and the prompt-lookup speculative loop keep their state
on the device and the host reads the all-done flag ``DONE_LAG`` steps
behind the newest step (``engine/engine.py``). Held here: greedy tokens
equal to JAX's, and the verify count equal to JAX's ``iters``
(``stats.spec_verify_steps``), for batches of 1, 2 and 4 whose rows end at
different steps, at budgets of 1, 2 and exactly the last EOS; speculation
with an EOS inside an accepted run and up to the cache-slack boundary; the
chunked long prompt and the prefixed decode. Steps issued past the end
leave ``out`` as it was at lags 0, 1 and 2, and a sampled stream and its
generator do not depend on the lag. The host's waits: none inside a step
(no ``.item()``, ``int()``, ``bool()`` or ``.cpu()`` on a tensor there),
none on the step just issued; only the lagged reads and the final fetch.
The chunk kernels' plain versions take a ``[1]`` int32 ``write_index`` and
equal the int form and JAX's ``chunk_prefill_attention`` in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
from rag_llm_k8s_tpu.core.config import EngineConfig as JEngineConfig
from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
from rag_llm_k8s_tpu.core.config import PrefixCacheConfig as JPrefixCacheConfig
from rag_llm_k8s_tpu.core.config import SamplingConfig as JSampling
from rag_llm_k8s_tpu.engine.engine import InferenceEngine as JEngine
from rag_llm_k8s_tpu.models.llama import init_llama_params
from rag_llm_k8s_tpu.ops import attention as jattn
from rag_llm_k8s_tpu_torch.core.config import (
    DTypePolicy,
    EngineConfig,
    LlamaConfig,
    PrefixCacheConfig,
    SamplingConfig,
)
from rag_llm_k8s_tpu_torch.engine import engine as engine_mod
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.llama import build_llama
from rag_llm_k8s_tpu_torch.ops import attention as tattn

FP32 = DTypePolicy.fp32()
JFP32 = JDTypes.fp32()
VOCAB = 300
NO_EOS = (VOCAB,)  # an id the model never emits
ATOL = 1e-5


@pytest.fixture(scope="module")
def params():
    return init_llama_params(jax.random.PRNGKey(0), JLlamaConfig.tiny(VOCAB), JFP32)


@pytest.fixture(scope="module")
def flat(params):
    return convert.flatten_tree(params)


def _port(flat, eos, max_new, sampling=None, **ekw):
    cfg = dataclasses.replace(LlamaConfig.tiny(VOCAB), eos_token_ids=tuple(eos))
    model = convert.load_llama(build_llama(cfg, FP32, "cpu"), flat)
    samp = sampling or SamplingConfig(do_sample=False, max_new_tokens=max_new)
    return InferenceEngine(cfg, model, samp, EngineConfig(**ekw), FP32, "cpu")


def _jax(params, eos, max_new, **ekw):
    cfg = dataclasses.replace(JLlamaConfig.tiny(VOCAB), eos_token_ids=tuple(eos))
    return JEngine(cfg, params, sampling=JSampling(do_sample=False, max_new_tokens=max_new),
                   engine_config=JEngineConfig(**ekw), dtypes=JFP32)


def _prompts(n, seed=1):
    r = np.random.default_rng(seed)
    return [[int(x) for x in r.integers(3, VOCAB, 4 + 3 * i)] for i in range(n)]


def _raw_outs(eng):
    """Record every ``_device_run`` result (the untrimmed ``out``)."""
    got, real = [], eng._device_run

    def run(*a, **kw):
        out = real(*a, **kw)
        got.append(out)
        return out

    eng._device_run = run
    return got


# ---------------------------------------------------------------------------
# the vanilla loop
# ---------------------------------------------------------------------------

VANILLA_EC = dict(prompt_buckets=(16, 32), max_batch_size=4, max_seq_len=64, speculative="off")


def _eos_at_different_steps(flat, prompts):
    """EOS ids taken from each row's own stream (row b's token at step 2 +
    3b), so the rows end at different steps; ``(eos, ends)``."""
    streams = _port(flat, NO_EOS, 12, **VANILLA_EC).generate(prompts)
    eos = sorted({s[min(2 + 3 * b, len(s) - 1)] for b, s in enumerate(streams)})
    ends = [next(i for i, t in enumerate(s) if t in eos) for s in streams]
    return eos, ends


@pytest.mark.parametrize("B", [1, 2, 4])
@pytest.mark.parametrize("budget", ["1", "2", "exact"])
def test_vanilla_gives_the_jax_tokens(params, flat, B, budget):
    prompts = _prompts(B)
    eos, ends = _eos_at_different_steps(flat, prompts)
    if B > 1:
        assert len(set(ends)) > 1, ends  # the rows end at different steps
    max_new = max(ends) + 1 if budget == "exact" else int(budget)
    teng = _port(flat, eos, max_new, **VANILLA_EC)
    got = teng.generate(prompts)
    assert got == _jax(params, eos, max_new, **VANILLA_EC).generate(prompts)
    assert [len(g) for g in got] == [min(e, max_new) for e in ends]
    assert teng.loop_counts.last["newest"] == 0


def test_the_chunked_long_prompt_gives_the_jax_tokens(params, flat):
    # 40 tokens over buckets (16, 32): two chunks of 32, then the decode
    prompt = _prompts(1, seed=9)[0] * 10
    prompt = prompt[:40]
    stream = _port(flat, NO_EOS, 10, **VANILLA_EC).generate([prompt])[0]
    eos = (stream[6],)
    teng = _port(flat, eos, 10, **VANILLA_EC)
    got = teng.generate([prompt])
    assert got == _jax(params, eos, 10, **VANILLA_EC).generate([prompt])
    assert len(got[0]) == stream.index(stream[6])


def test_the_prefixed_decode_gives_the_jax_tokens(params, flat):
    pc = dict(enabled=True, max_prefix_tokens=64, segment_buckets=(16, 32), suffix_buckets=(16,))
    ec = dict(prompt_buckets=(64, 128), max_batch_size=2, speculative="off", max_seq_len=256)
    r = np.random.default_rng(3)
    head, a, suffix = ([int(x) for x in r.integers(3, 250, n)] for n in (12, 16, 7))
    segs = [("head", head), ("A", a)]
    tcfg = dataclasses.replace(LlamaConfig.tiny(VOCAB), eos_token_ids=NO_EOS)
    cold = InferenceEngine(tcfg, convert.load_llama(build_llama(tcfg, FP32, "cpu"), flat),
                           SamplingConfig(do_sample=False, max_new_tokens=12), EngineConfig(**ec), FP32, "cpu")
    stream = cold.generate([head + a + suffix])[0]
    eos = (stream[5],)
    teng = _port(flat, eos, 12, prefix_cache=PrefixCacheConfig(**pc), **ec)
    jeng = JEngine(dataclasses.replace(JLlamaConfig.tiny(VOCAB), eos_token_ids=eos), params,
                   sampling=JSampling(do_sample=False, max_new_tokens=12), dtypes=JFP32,
                   engine_config=JEngineConfig(prefix_cache=JPrefixCacheConfig(**pc), **ec))
    got = teng.generate_prefixed(suffix, teng.prefix_cache.prefix_for(segs))
    assert got == jeng.generate_prefixed(suffix, jeng.prefix_cache.prefix_for(segs))
    assert got == stream[: stream.index(stream[5])]


# ---------------------------------------------------------------------------
# the speculative loop
# ---------------------------------------------------------------------------

SPEC_EC = dict(prompt_buckets=(16, 32, 64), max_batch_size=2, max_seq_len=256, speculative="prompt_lookup")


def _accepted_runs(prompt, stream, n, k):
    """The greedy verify iterations ``(e, m)`` of a prompt whose greedy
    stream is ``stream`` (greedy speculation emits the vanilla stream): the
    proposal rule of ``_make_gen_spec`` replayed on the host."""
    hist = list(prompt) + list(stream[:1])
    e, runs = 1, []
    while e < len(stream):
        wi = len(hist) - 1
        src = None
        for c in range(wi - k, n - 2, -1):
            if all(hist[c - j] == hist[wi - j] for j in range(n)):
                src = c + 1
                break
        props = [] if src is None else hist[src : src + k]
        m = 0
        while m < min(len(props), len(stream) - e) and props[m] == stream[e + m]:
            m += 1
        runs.append((e, m))
        step = min(m, len(stream) - e - 1) + 1
        hist += list(stream[e : e + step])
        e += step
    return runs


def test_speculation_with_an_eos_inside_an_accepted_run(params, flat):
    """The prompt carries the model's own earlier stream, so the drafts it
    proposes are accepted; the EOS is a token the stream first emits inside
    an accepted run."""
    base = [int(x) for x in np.random.default_rng(6).integers(3, VOCAB, size=7)] * 2
    plain = _port(flat, NO_EOS, 60, **dict(SPEC_EC, speculative="off"))
    prompt = base + plain.generate([base])[0][:28]
    stream = plain.generate([prompt], max_new_tokens=40)[0]
    ec = EngineConfig()
    runs = _accepted_runs(prompt, stream, ec.spec_ngram, ec.spec_tokens)
    first = {}
    for i, t in enumerate(stream):
        first.setdefault(t, i)
    inside = [t for t, i in first.items() if i > 0 and any(e < i < e + m for e, m in runs)]
    assert inside, runs  # the case exists on these weights
    eos = (inside[0],)
    teng = _port(flat, eos, 40, **SPEC_EC)
    jeng = _jax(params, eos, 40, **SPEC_EC)
    got = teng.generate([prompt])
    assert got == jeng.generate([prompt]) == [stream[: first[eos[0]]]]
    assert teng.stats.spec_verify_steps == jeng.stats.spec_verify_steps < len(got[0])


def test_speculation_up_to_the_cache_slack_boundary(params, flat):
    # S = 64, k = 15, max_new = 49: T = 64 + 49 + 15 = 128 exactly, so the
    # last verify writes the cache's final slot; drafts are accepted up to
    # the budget (the prompt holds the model's own looping stream)
    base = ([int(x) for x in np.random.default_rng(7).integers(3, VOCAB, size=7)] * 5)[:30]
    prompt = base + _port(flat, NO_EOS, 60, **dict(SPEC_EC, speculative="off")).generate([base])[0][:34]
    assert len(prompt) == 64
    teng = _port(flat, NO_EOS, 49, **SPEC_EC)
    jeng = _jax(params, NO_EOS, 49, **SPEC_EC)
    got = teng.generate([prompt])
    assert got == jeng.generate([prompt]) and len(got[0]) == 49
    assert teng.stats.spec_verify_steps == jeng.stats.spec_verify_steps < 24
    assert got == _port(flat, NO_EOS, 49, **dict(SPEC_EC, speculative="off")).generate([prompt])


# ---------------------------------------------------------------------------
# steps past the end, the generator, and the host's waits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lag", [0, 1, 2])
def test_steps_issued_past_the_end_leave_out_unchanged(flat, monkeypatch, lag):
    monkeypatch.setattr(engine_mod, "DONE_LAG", lag)
    prompts = _prompts(2)
    eos, ends = _eos_at_different_steps(flat, prompts)
    max_new = 12
    van = _port(flat, eos, max_new, **VANILLA_EC)
    raw = _raw_outs(van)
    got = van.generate(prompts)
    out = raw[0][0][: len(prompts)]
    real = max(ends)  # the step that ended the last row
    assert van.loop_counts.last["overrun"] == min(lag, max_new - 1 - real)
    # rows end in EOS after their own end, pad after every row has ended
    for b, e in enumerate(ends):
        assert list(out[b, : e]) == got[b] and out[b, e] in eos
        assert all(t in eos for t in out[b, e + 1 : real + 1])
    assert (out[:, real + 1 :] == 0).all()
    # the speculative loop: its out, hist, e and iters stay as they were
    spec = _port(flat, eos, max_new, **dict(VANILLA_EC, speculative="prompt_lookup"))
    raw = _raw_outs(spec)
    want = _port(flat, eos, max_new, **dict(VANILLA_EC, speculative="off")).generate(prompts[:1])
    assert spec.generate(prompts[:1]) == want
    out, iters = raw[0]
    assert list(out[0, : len(want[0])]) == want[0] and out[0, len(want[0])] in eos
    assert (out[0, len(want[0]) + 1 :] == 0).all()
    assert spec.loop_counts.last["overrun"] <= lag and spec.loop_counts.last["steps"] == iters + \
        spec.loop_counts.last["overrun"]


def test_a_sampled_stream_does_not_depend_on_the_lag(flat, monkeypatch):
    """Steps past the end draw from the generator; it is set back, so the
    next sub-batch's stream is the one lag 0 gives."""
    eos = tuple(range(3, 120))  # many ids: rows end early, at random steps
    prompts = _prompts(3, seed=5)
    samp = SamplingConfig(do_sample=True, temperature=1.0, top_p=1.0, max_new_tokens=16)
    outs = {}
    for lag in (0, 1, 2):
        monkeypatch.setattr(engine_mod, "DONE_LAG", lag)
        for mode in ("off", "prompt_lookup"):
            eng = _port(flat, eos, 16, sampling=samp, **dict(VANILLA_EC, max_batch_size=1, speculative=mode))
            outs[lag, mode] = (eng.generate(prompts, seed=17), eng.generate(prompts[:1], seed=18))
    for mode in ("off", "prompt_lookup"):
        assert outs[0, mode] == outs[1, mode] == outs[2, mode]
    assert any(len(r) < 16 for r in outs[0, "off"][0])


class _NoHostRead:
    """Inside a step: a host read of a tensor raises."""

    NAMES = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__float__", "__index__")

    def __init__(self, device):
        self.saved = {}

    def __enter__(self):
        for name in self.NAMES:
            self.saved[name] = torch.Tensor.__dict__.get(name)

            def refuse(*a, _name=name, **kw):
                raise AssertionError(f"Tensor.{_name} inside a loop step")

            setattr(torch.Tensor, name, refuse)

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)
        return False


@pytest.mark.parametrize("mode", ["off", "prompt_lookup"])
def test_150_tokens_wait_only_on_lagged_reads_and_the_final_fetch(flat, monkeypatch, mode):
    monkeypatch.setattr(engine_mod, "_SyncDebug", _NoHostRead)
    reads = []
    real_ended = engine_mod._DoneReader.ended

    def ended(self):
        reads.append(self.issued)
        before = self.waits
        out = real_ended(self)
        if self.waits > before:
            reads[-1] = (self.issued - self.lag, self.issued)
        return out

    monkeypatch.setattr(engine_mod._DoneReader, "ended", ended)
    eng = _port(flat, NO_EOS, 150, **dict(VANILLA_EC, max_seq_len=256, speculative=mode))
    eng.strict_sync = True
    got = eng.generate(_prompts(1))
    assert len(got[0]) == 150
    last = eng.loop_counts.last
    waited = [r for r in reads if isinstance(r, tuple)]
    # every wait reads the step DONE_LAG behind the newest issued one
    assert waited and all(issued - j == engine_mod.DONE_LAG for j, issued in waited)
    assert last == {"waits": len(waited) + 1, "newest": 0, "overrun": last["overrun"], "steps": last["steps"]}
    if mode == "off":
        # the budget bounds the loop on the host: nothing runs past it
        assert last["steps"] == 149 and len(waited) == 149 - engine_mod.DONE_LAG and last["overrun"] == 0
    else:
        # the card decides when e reaches the budget: at most DONE_LAG more
        assert last["overrun"] <= engine_mod.DONE_LAG and eng.stats.spec_verify_steps == last["steps"] - \
            last["overrun"]


# ---------------------------------------------------------------------------
# the chunk kernels' plain versions at a device write slot
# ---------------------------------------------------------------------------

def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("wi", [32, 112])
def test_chunk_plain_versions_take_a_device_write_index(wi):
    rng = np.random.default_rng(wi)
    L, B, K, H, hd, T, S = 2, 2, 2, 4, 16, 128, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    kc, vc = (rng.standard_normal((L, B, K, T, hd)).astype(np.float32) for _ in range(2))
    kv_start, kv_len = np.array([0, 10], np.int32), np.full((B,), wi + S, np.int32)
    slot = torch.tensor([wi], dtype=torch.int32)
    win = (_t(kv_start), _t(kv_len))
    got = tattn.chunk_attention_xla(_t(q), _t(kc), _t(vc), *win, 1, slot)
    assert torch.equal(got, tattn.chunk_attention_xla(_t(q), _t(kc), _t(vc), *win, 1, wi))
    assert torch.equal(tattn.chunk_prefill_attention(_t(q), _t(kc), _t(vc), *win, 1, slot.reshape(())), got)
    args = tuple(map(jnp.asarray, (q, kc, vc, kv_start, kv_len))) + (jnp.int32(1), jnp.int32(wi))
    np.testing.assert_allclose(got.numpy(), np.asarray(jattn.chunk_prefill_attention(
        *args, bq=16, bk=64, interpret=True)), atol=ATOL, rtol=0)
    # the int8 form
    k8, ks = jattn.quantize_kv(jnp.asarray(kc))
    v8, vs = jattn.quantize_kv(jnp.asarray(vc))
    planes = [np.asarray(x) for x in (k8, v8, ks, vs)]
    got8 = tattn.chunk_attention_xla_q8(_t(q), *map(_t, planes), *win, 1, slot)
    assert torch.equal(got8, tattn.chunk_attention_xla_q8(_t(q), *map(_t, planes), *win, 1, wi))
    assert torch.equal(tattn.chunk_prefill_attention_q8(_t(q), *map(_t, planes), *win, 1, slot), got8)
    args8 = tuple(map(jnp.asarray, [q] + planes + [kv_start, kv_len])) + (jnp.int32(1), jnp.int32(wi))
    np.testing.assert_allclose(got8.numpy(), np.asarray(jattn.chunk_prefill_attention_q8(
        *args8, bq=8, bk=64, interpret=True)), atol=ATOL, rtol=0)
    # the split forms the kernels' plans follow
    split = tattn.chunk_attention_split_xla(_t(q), _t(kc), _t(vc), *win, 1, slot, split_keys=64, block_rows=16)
    np.testing.assert_allclose(split.numpy(), got.numpy(), atol=ATOL, rtol=0)
