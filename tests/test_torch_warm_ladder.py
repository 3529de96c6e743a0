"""The boot's warm set against the JAX package's.

JAX's ``RagService.warmup`` asks its ``InferenceEngine.warmup`` for a set
of executables: batch 1 at every prompt bucket (the speculative one, and
under ``speculative="auto"`` the vanilla one too), and under the coalescing
scheduler the padded batch ladder 2 .. ``next_pow2(max_batch_size)`` at the
largest bucket, or at every bucket with ``TPU_RAG_WARM_FULL_LADDER=1``
(``EngineConfig.warm_full_ladder``). Its ``_get_compiled`` is replaced here
by a recorder (no compile runs), and the JAX warmup runs unbound on a stub
service. The port's ``RagService.warm_shapes`` must run each of the same
``(batch, bucket, variant)`` shapes once, through ``_device_run`` on its
tiny fp32 engine, and record no stats.
"""

import dataclasses
import types

import jax
import pytest
import torch

from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
from rag_llm_k8s_tpu.core.config import EngineConfig as JEngineConfig
from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
from rag_llm_k8s_tpu.core.config import SamplingConfig as JSampling
from rag_llm_k8s_tpu.engine.batching import BatchScheduler as JBatchScheduler
from rag_llm_k8s_tpu.engine.engine import InferenceEngine as JEngine
from rag_llm_k8s_tpu.models.llama import init_llama_params
from rag_llm_k8s_tpu.server.app import RagService as JRagService
from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, EngineConfig, LlamaConfig, SamplingConfig
from rag_llm_k8s_tpu_torch.engine.batching import BatchScheduler
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.llama import build_llama
from rag_llm_k8s_tpu_torch.server.app import RagService

VOCAB = 128
BUCKETS = (16, 32, 64)


@pytest.fixture(scope="module")
def jparams():
    return init_llama_params(jax.random.PRNGKey(0), JLlamaConfig.tiny(VOCAB), JDTypes.fp32())


@pytest.fixture(scope="module")
def model():
    cfg = LlamaConfig.tiny(VOCAB)
    return convert.init_random_(build_llama(cfg, DTypePolicy.fp32(), "cpu"), torch.Generator().manual_seed(0))


def _jax_set(jparams, ec, scheduler):
    """The ``(batch, bucket, variant)`` keys JAX's service warmup compiles
    (variant: None vanilla, "spec", or a chunk width)."""
    jeng = JEngine(JLlamaConfig.tiny(VOCAB), jparams, sampling=JSampling(max_new_tokens=8),
                   engine_config=JEngineConfig(**ec), dtypes=JDTypes.fp32())
    keys = []
    jeng._get_compiled = lambda B, S, max_new, chunk=None: keys.append((B, S, chunk))
    sched = None
    if scheduler == "coalesce":
        sched = JBatchScheduler.__new__(JBatchScheduler)  # its type, without its worker thread
        sched.engine = jeng
    stub = types.SimpleNamespace(
        scheduler=sched, engine=jeng, embed_texts=lambda texts: None, _retrieve=lambda q: None,
        retrieve_coalescer=None, store=types.SimpleNamespace(ntotal=0), _prefix_enabled=lambda: False, ready=False)
    JRagService.warmup(stub)
    assert stub.ready
    return keys


def _port_set(model, ec, scheduler):
    """The shapes the port's warmup runs, read at ``_device_run``."""
    eng = InferenceEngine(LlamaConfig.tiny(VOCAB), model, SamplingConfig(max_new_tokens=8), EngineConfig(**ec),
                          DTypePolicy.fp32(), "cpu")
    ran, real = [], eng._device_run

    def run(tokens, pad_mask, S, max_new, chunk, spec, gen):
        ran.append((tokens.shape[0], S, "spec" if spec else chunk))
        assert max_new == 2 and tokens.shape[1] == S
        return real(tokens, pad_mask, S, max_new, chunk, spec, gen)

    eng._device_run = run
    sched = None
    if scheduler == "coalesce":
        sched = BatchScheduler.__new__(BatchScheduler)
        sched.engine = eng
    stub = types.SimpleNamespace(engine=eng, scheduler=sched)
    shapes = RagService.warm_shapes(stub)
    assert shapes == ran
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(type(eng.stats)())  # no stats, no EMA
    assert eng._spec_ema is None and eng._rng_counter == 0
    return ran


@pytest.mark.parametrize("scheduler", ["coalesce", None])
@pytest.mark.parametrize("max_batch", [8, 6])
@pytest.mark.parametrize("full_ladder", [False, True])
def test_the_port_warms_the_jax_set(jparams, model, scheduler, max_batch, full_ladder):
    ec = dict(prompt_buckets=BUCKETS, max_batch_size=max_batch, max_seq_len=128, speculative="auto",
              warm_full_ladder=full_ladder)
    want = _jax_set(jparams, ec, scheduler)
    got = _port_set(model, ec, scheduler)
    assert sorted(got, key=repr) == sorted(want, key=repr)
    assert len(set(got)) == len(got)  # each shape once
    # batch 1 at every bucket, both loops under "auto"
    assert {(1, s, v) for s in BUCKETS for v in ("spec", None)} <= set(got)
    if scheduler == "coalesce":
        ladder = {(b, s, None) for b in (2, 4, 8) for s in (BUCKETS if full_ladder else BUCKETS[-1:])}
        assert ladder <= set(got)


@pytest.mark.parametrize("speculative", ["off", "prompt_lookup"])
def test_the_static_mode_chooses_the_loops(jparams, model, speculative):
    ec = dict(prompt_buckets=BUCKETS, max_batch_size=2, max_seq_len=128, speculative=speculative)
    want = _jax_set(jparams, ec, "coalesce")
    assert sorted(_port_set(model, ec, "coalesce"), key=repr) == sorted(want, key=repr)
    assert all(v == ("spec" if speculative == "prompt_lookup" and b == 1 else None) for b, _, v in want)
