"""The port's production boot (``server/main.py``) on a staged directory.

A tiny directory is staged with the port's ``utils/synth.py`` (a 2-shard
Llama checkpoint and ``config.json``, an XLM-R encoder under ``bge-m3/``),
the fixture ``tokenizer.json`` files and two PDFs. ``build_service(config,
device="cpu")`` boots from it; its greedy ``/generate`` answers equal those
of a JAX ``RagService`` assembled by hand from the JAX loaders over the same
directory (the JAX ``build_service`` cannot take a tiny encoder). Also:
``AppConfig.from_env`` against the JAX one, the keys the port refuses, and
the threaded WSGI server coalescing two concurrent requests."""

import contextlib
import dataclasses
import json
import os
import shutil
import threading
import urllib.request

import numpy as np
import pytest
import torch

from rag_llm_k8s_tpu.core.config import AppConfig as JAppConfig
from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
from rag_llm_k8s_tpu.core.config import EncoderConfig as JEncoderConfig
from rag_llm_k8s_tpu.core.config import EngineConfig as JEngineConfig
from rag_llm_k8s_tpu.core.config import RetrievalConfig as JRetrieval
from rag_llm_k8s_tpu.core.config import SamplingConfig as JSampling
from rag_llm_k8s_tpu.core.config import ServerConfig as JServerConfig
from rag_llm_k8s_tpu.engine.batching import BatchScheduler as JBatchScheduler
from rag_llm_k8s_tpu.engine.encoder import EncoderRunner as JEncoderRunner
from rag_llm_k8s_tpu.engine.engine import InferenceEngine as JEngine
from rag_llm_k8s_tpu.index.store import VectorStore as JStore
from rag_llm_k8s_tpu.models import loader as jloader
from rag_llm_k8s_tpu.server.app import RagService as JRagService
from rag_llm_k8s_tpu.server.app import create_app as jcreate_app
from rag_llm_k8s_tpu.tokenizer import load_tokenizer as jload_tokenizer
from rag_llm_k8s_tpu_torch.core.config import (
    AppConfig,
    DTypePolicy,
    EncoderConfig,
    EngineConfig,
    LlamaConfig,
    RetrievalConfig,
    SamplingConfig,
    ServerConfig,
)
from rag_llm_k8s_tpu_torch.server import main as tmain
from rag_llm_k8s_tpu_torch.server.app import create_app, make_server
from rag_llm_k8s_tpu_torch.utils import synth

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "tokenizers")
VOCAB = 512
ENGINE = dict(prompt_buckets=(128, 512), max_batch_size=2, max_seq_len=640)
QUESTIONS = ["what do kernels tile?", "how are chunks ranked?", "where is the prompt assembled?"]


def _pdf(text):
    content = f"BT /F1 12 Tf ({text}) Tj ET".encode()
    return b"".join([
        b"%PDF-1.4\n",
        b"1 0 obj << /Type /Catalog /Pages 2 0 R >> endobj\n",
        b"2 0 obj << /Type /Pages /Kids [3 0 R] /Count 1 >> endobj\n",
        b"3 0 obj << /Type /Page /Parent 2 0 R /Contents 4 0 R "
        b"/Resources << /Font << /F1 5 0 R >> >> >> endobj\n",
        b"4 0 obj << /Length %d >> stream\n%s\nendstream endobj\n" % (len(content), content),
        b"5 0 obj << /Type /Font /Subtype /Type1 /BaseFont /Helvetica >> endobj\n",
        b"%%EOF",
    ])


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("staged"))
    lc = LlamaConfig.tiny(VOCAB)
    synth.write_synth_checkpoint(root, lc, n_shards=2, seed=3)
    synth.write_hf_config(root, lc)
    shutil.copy(os.path.join(FIXTURES, "bpe_multi.json"), os.path.join(root, "tokenizer.json"))
    enc_dir = os.path.join(root, "bge-m3")
    synth.write_synth_encoder(enc_dir, EncoderConfig.tiny(VOCAB), seed=4)
    shutil.copy(os.path.join(FIXTURES, "unigram_norm.json"), os.path.join(enc_dir, "tokenizer.json"))
    pdf_dir = os.path.join(root, "pdfs")
    os.makedirs(pdf_dir)
    for i, text in enumerate(["flash attention kernels tile queries and keys in shared memory",
                              "retrieval ranks chunk embeddings by squared distance"]):
        with open(os.path.join(pdf_dir, f"doc{i}.pdf"), "wb") as f:
            f.write(_pdf(text))
    return root


def _port_config(root):
    return AppConfig(
        dtypes=DTypePolicy.fp32(), encoder=EncoderConfig.tiny(VOCAB), retrieval=RetrievalConfig(embed_dim=32),
        sampling=SamplingConfig(do_sample=False, max_new_tokens=8), engine=EngineConfig(**ENGINE),
        server=ServerConfig(model_path=root, index_path=os.path.join(root, "tpu_index"),
                            pdf_dir=os.path.join(root, "pdfs"), embedder_path=os.path.join(root, "bge-m3"), port=0),
    )


@pytest.fixture(scope="module")
def booted(staged):
    info = {}
    svc = tmain.build_service(_port_config(staged), device="cpu", info=info)
    assert svc.ingest_directory() == 2
    svc.warmup()
    yield svc, info
    svc.shutdown()


@pytest.fixture(scope="module")
def jax_service(staged):
    jfp32 = JDTypes.fp32()
    jl = jloader.config_from_hf_json(staged)
    je = JEncoderConfig.tiny(VOCAB)
    cfg = JAppConfig(model=jl, encoder=je, dtypes=jfp32, retrieval=JRetrieval(embed_dim=32),
                     sampling=JSampling(do_sample=False, max_new_tokens=8), engine=JEngineConfig(**ENGINE),
                     server=JServerConfig(pdf_dir=os.path.join(staged, "pdfs")))
    engine = JEngine(jl, jloader.load_safetensors_params(staged, jl, jfp32), sampling=cfg.sampling,
                     engine_config=cfg.engine, dtypes=jfp32)
    enc_tok = jload_tokenizer(os.path.join(staged, "bge-m3"))
    encoder = JEncoderRunner(je, jloader.load_encoder_safetensors(os.path.join(staged, "bge-m3"), je, jfp32),
                             dtypes=jfp32, eos_id=enc_tok.eos_id)
    svc = JRagService(cfg, engine, jload_tokenizer(staged), encoder, enc_tok, JStore(dim=32),
                      scheduler=JBatchScheduler(engine, max_wait_ms=30.0))
    svc.ingest_directory()
    svc.ready = True
    yield svc
    svc.shutdown()


def test_the_boot_converts_then_reuses_its_cache_and_index(staged, booted):
    svc, info = booted
    assert info == {"params_source": "converted", "index_loaded_vectors": 0}
    assert svc.store.ntotal == 2 and os.path.exists(os.path.join(staged, "tpu_index"))
    assert svc.llm_tokenizer.native and svc.ready
    assert svc.config.model == LlamaConfig.tiny(VOCAB)  # from config.json
    again = {}
    svc2 = tmain.build_service(_port_config(staged), device="cpu", info=again)
    try:
        assert again == {"params_source": "cache", "index_loaded_vectors": 2}
        for (n, p), (_, q) in zip(svc.engine.model.named_parameters(), svc2.engine.model.named_parameters()):
            assert torch.equal(p, q), n
    finally:
        svc2.shutdown()


def test_the_int8_boot_streams_the_jax_loaders_int8_weights(staged):
    env = {"MODEL_PATH": staged, "TPU_RAG_WEIGHT_QUANT": "int8"}
    cfg = dataclasses.replace(AppConfig.from_env(env), dtypes=DTypePolicy.fp32(),
                              encoder=EncoderConfig.tiny(VOCAB), retrieval=RetrievalConfig(embed_dim=32),
                              engine=dataclasses.replace(EngineConfig(**ENGINE), weight_quant="int8"))
    info = {}
    svc = tmain.build_service(cfg, device="cpu", info=info)
    try:
        assert info["params_source"] == "converted"
        assert os.path.isdir(os.path.join(staged, "tpu_rag_param_cache_int8"))
        jl = jloader.config_from_hf_json(staged)
        jtree = jloader.load_safetensors_params(staged, jl, JDTypes.fp32(), quant="int8")
        wqkv = svc.engine.model.layers[0].attn.wqkv  # fused by the engine: q | k | v rows
        want = torch.cat([torch.from_numpy(np.asarray(jtree["layers"]["attn"][n]["kernel_q"][0]).T.copy())
                          for n in ("wq", "wk", "wv")])
        assert torch.equal(wqkv.weight, want)
        want_s = torch.cat([torch.from_numpy(np.asarray(jtree["layers"]["attn"][n]["qscale"][0]).copy())
                            for n in ("wq", "wk", "wv")])
        assert torch.equal(wqkv.scale, want_s)
    finally:
        svc.shutdown()


def test_greedy_answers_match_a_jax_service_over_the_same_directory(booted, jax_service):
    svc, _ = booted
    tc, jc = create_app(svc).test_client(), jcreate_app(jax_service).test_client()
    assert tc.get("/index_info").get_json() == jc.get("/index_info").get_json()
    fused = []
    real = svc.engine.generate_rag
    svc.engine.generate_rag = lambda *a, **kw: fused.append(1) or real(*a, **kw)
    try:
        for q in QUESTIONS:
            got = tc.post("/generate", json_body={"prompt": q}).get_json()
            want = jc.post("/generate", json={"prompt": q}).get_json()
            assert got["generated_text"] == want["generated_text"]
            assert got["context"] == want["context"] and "Document '" in got["context"]
    finally:
        svc.engine.generate_rag = real
    assert len(fused) == len(QUESTIONS)  # solo queries take the single-fetch path


@contextlib.contextmanager
def _wide_windows(svc):
    """Coalescing windows long enough for concurrent requests to meet on a
    loaded machine: the retrieve coalescer holds each batch 2 s, and the
    scheduler waits up to 2 s but leaves as soon as every request in flight
    has joined (its hint). The service's own windows are 25 and 30 ms."""
    co, sched = svc.retrieve_coalescer, svc.scheduler
    saved = co.max_wait_ms, co.hint_grace_ms, sched.max_wait_ms
    co.max_wait_ms = co.hint_grace_ms = sched.max_wait_ms = 2000.0
    try:
        yield
    finally:
        co.max_wait_ms, co.hint_grace_ms, sched.max_wait_ms = saved


def test_a_coalesced_burst_answers_what_each_question_answers_alone(booted):
    svc, _ = booted
    client = create_app(svc).test_client()
    alone = [client.post("/generate", json_body={"prompt": q}).get_json() for q in QUESTIONS]
    sizes, retrieves = [], []
    real_gen, real_many = svc.engine.generate, svc._retrieve_many
    svc.engine.generate = lambda p, *a, **kw: sizes.append(len(p)) or real_gen(p, *a, **kw)
    svc._retrieve_many = lambda t, *a, **kw: retrieves.append(len(t)) or real_many(t, *a, **kw)
    got = [None] * len(QUESTIONS)
    try:
        def ask(i):
            got[i] = client.post("/generate", json_body={"prompt": QUESTIONS[i]}).get_json()

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(QUESTIONS))]
        with _wide_windows(svc):
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
    finally:
        svc.engine.generate, svc._retrieve_many = real_gen, real_many
    assert [g["generated_text"] for g in got] == [a["generated_text"] for a in alone]
    assert [g["context"] for g in got] == [a["context"] for a in alone]
    assert max(retrieves) > 1 and max(sizes) > 1  # one retrieve batch, batched generates


def test_the_threaded_server_coalesces_two_concurrent_requests(booted):
    svc, _ = booted
    server = make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    sizes = []
    real = svc.engine.generate
    gate = threading.Barrier(2, timeout=30)
    svc.engine.generate = lambda p, *a, **kw: sizes.append(len(p)) or real(p, *a, **kw)
    out = [None, None]

    def post(i):
        gate.wait()
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_port}/generate",
                                     data=json.dumps({"prompt": QUESTIONS[i]}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out[i] = (r.status, json.loads(r.read()))

    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        with _wide_windows(svc):
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
        with urllib.request.urlopen(f"http://127.0.0.1:{server.server_port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        svc.engine.generate = real
        server.shutdown()
        server.server_close()
    assert [o[0] for o in out] == [200, 200]
    assert sizes == [2]  # both prompts in one coalesced engine.generate
    assert health["status"] == "ok" and health["engine_mode"] == "coalesce"


# the ported keys, each with a value that differs from its default
PORTED_ENV = {
    "MODEL_PATH": "/staged/models", "TPU_RAG_INDEX_PATH": "/idx/index", "TPU_RAG_PDF_DIR": "/docs",
    "TPU_RAG_PORT": "6001", "TPU_RAG_MAX_NEW_TOKENS": "64", "TPU_RAG_BATCHING": "continuous",
    "TPU_RAG_WEIGHT_QUANT": "int8", "TPU_RAG_KV_QUANT": "int8", "TPU_RAG_KV_PAGED": "1",
    "TPU_RAG_KV_BLOCK_SIZE": "32", "TPU_RAG_KV_POOL_BLOCKS": "100", "TPU_RAG_INTERLEAVE_PREFILL": "1",
    "TPU_RAG_PREFILL_CHUNK_TOKENS": "32", "TPU_RAG_WINDOW_TOKEN_BUDGET": "48", "TPU_RAG_DO_SAMPLE": "0",
    "TPU_RAG_SPECULATIVE": "off", "TPU_RAG_SYNC_STEPS": "4", "TPU_RAG_FUSED": "0",
    "TPU_RAG_SPEC_PAGED": "1", "TPU_RAG_SPEC_PAGED_TOKENS": "5", "TPU_RAG_SPEC_PAGED_MIN_ACCEPT": "0.4",
    "TPU_RAG_DEBUG": "1", "TPU_RAG_FLIGHT_EVENTS": "1024",
    "TPU_RAG_PREFIX_CACHE": "1", "TPU_RAG_PREFIX_HBM_MB": "64", "TPU_RAG_PREFIX_REUSE": "chunk",
    "TPU_RAG_PREFIX_BOUNDARY_TOKENS": "4", "TPU_RAG_PREFIX_CHUNK_HOT_MIN": "0.5",
    "TPU_RAG_PREFIX_CHUNK_POOL_REGS": "4", "TPU_RAG_KV_TIERING": "1", "TPU_RAG_KV_TIERING_WARM_BELOW": "0.5",
    "TPU_RAG_KV_TIERING_COLD_BELOW": "0.125", "TPU_RAG_KV_TIERING_HALF_LIFE_S": "30",
    "TPU_RAG_KV_TIERING_HOST_MB": "16", "TPU_RAG_KV_TIERING_INTERVAL_S": "0.5",
    "TPU_RAG_POOL_ROLE": "decode", "TPU_RAG_FLIGHT": "0", "TPU_RAG_FLIGHT_ARRIVAL_IDS": "0",
    "TPU_RAG_FLIGHT_WAL": "1", "TPU_RAG_FLIGHT_WAL_DIR": "/pvc/wal", "TPU_RAG_FLIGHT_WAL_SEGMENT_EVENTS": "128",
    "TPU_RAG_FLIGHT_WAL_SEGMENTS": "16", "TPU_RAG_FLIGHT_WAL_RESTORE": "0", "TPU_RAG_FLIGHT_WAL_RESTORE_CHUNKS": "3",
    "TPU_RAG_ROUTER_AFFINITY_WEIGHT": "2.5", "TPU_RAG_ROUTER_LOAD_WEIGHT": "0.25", "TPU_RAG_ROUTER_HOT_CHUNKS": "64",
    "TPU_RAG_ROUTER_SESSION_TTL_S": "30",
}


def _shared(port_cfg, jax_cfg):
    """Every field the two configs share, section by section."""
    out = {}
    for section in ("server", "sampling", "engine", "retrieval", "flight", "router", "lookahead"):
        p, j = getattr(port_cfg, section), getattr(jax_cfg, section)
        names = {f.name for f in dataclasses.fields(p)} & {f.name for f in dataclasses.fields(j)}
        # a nested config (the prefix cache's, tiering's) compares field by field
        val = lambda x: dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x  # noqa: E731
        out[section] = {n: (val(getattr(p, n)), val(getattr(j, n))) for n in sorted(names)}
    return out


@pytest.mark.parametrize("key", [None] + sorted(PORTED_ENV))
def test_from_env_matches_the_jax_config_on_every_shared_field(key):
    env = dict(PORTED_ENV) if key is None else {key: PORTED_ENV[key]}
    if key in ("TPU_RAG_INTERLEAVE_PREFILL", "TPU_RAG_POOL_ROLE"):
        env["TPU_RAG_KV_PAGED"] = "1"  # the cross-field rules both packages apply
    for section, fields in _shared(AppConfig.from_env(env), JAppConfig.from_env(env)).items():
        for name, (got, want) in fields.items():
            assert got == want, (section, name)
    assert AppConfig.from_env(env).system_message == JAppConfig.from_env(env).system_message


@pytest.mark.parametrize("env", [
    {"TPU_RAG_KV_BLOCK_SIZE": "0"}, {"TPU_RAG_BATCHING": "bogus"}, {"TPU_RAG_WEIGHT_QUANT": "int4"},
    {"TPU_RAG_KV_PAGED": "yes"}, {"TPU_RAG_SYNC_STEPS": "0"}, {"TPU_RAG_SPECULATIVE": "always"},
    {"TPU_RAG_INTERLEAVE_PREFILL": "1"},
    {"TPU_RAG_ADMISSION_MAX_CONCURRENCY": "0"}, {"TPU_RAG_ADMISSION_MAX_QUEUE": "-1"},
    {"TPU_RAG_ADMISSION_RETRY_AFTER_S": "-0.5"}, {"TPU_RAG_DEADLINE_MS": "0"}, {"TPU_RAG_DEADLINE_MS": "soon"},
    {"TPU_RAG_BREAKER_RESETS": "0"}, {"TPU_RAG_BREAKER_WINDOW_S": "0.5"}, {"TPU_RAG_INFLIGHT_RETRIES": "-1"},
    {"TPU_RAG_RETRY_BACKOFF_MS": "-1"}, {"TPU_RAG_DRAIN_DEADLINE_S": "0"}, {"TPU_RAG_DRAIN_RETRY_AFTER_S": "-1"},
    {"TPU_RAG_DEBUG": "yes"}, {"TPU_RAG_FLIGHT_EVENTS": "0"}, {"TPU_RAG_FLIGHT_EVENTS": "many"},
])
def test_from_env_validation_messages_match(env):
    with pytest.raises(ValueError) as want:
        JAppConfig.from_env(env)
    with pytest.raises(ValueError) as got:
        AppConfig.from_env(env)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("env,item", [
    ({"TPU_RAG_MESH": "tp=2"}, "item 10"),
])
def test_a_key_that_turns_on_an_unported_feature_raises(env, item):
    with pytest.raises(ValueError, match=f"ROADMAP.md Queue 1 {item}"):
        AppConfig.from_env(env)


# the lookahead keys (ROADMAP.md Queue 1 item 8): the deployment's values
# (deploy/llm/deploy.yaml) and the rest parse to JAX's fields, bad ones raise
# JAX's message
LOOKAHEAD_GOOD = [
    {"TPU_RAG_LOOKAHEAD": "1"},
    {"TPU_RAG_LOOKAHEAD": "1", "TPU_RAG_LOOKAHEAD_WORKERS": "2", "TPU_RAG_LOOKAHEAD_INFLIGHT": "8",
     "TPU_RAG_LOOKAHEAD_TTL_S": "30", "TPU_RAG_LOOKAHEAD_PRESTAGE": "1", "TPU_RAG_LOOKAHEAD_SESSIONS": "1",
     "TPU_RAG_LOOKAHEAD_SESSION_TURNS": "2", "TPU_RAG_LOOKAHEAD_SESSION_MAX": "256",
     "TPU_RAG_LOOKAHEAD_SESSION_TTL_S": "600"},
    {"TPU_RAG_LOOKAHEAD": "0", "TPU_RAG_LOOKAHEAD_PRESTAGE": "0", "TPU_RAG_LOOKAHEAD_SESSIONS": "0",
     "TPU_RAG_LOOKAHEAD_TTL_S": "0.1", "TPU_RAG_LOOKAHEAD_SESSION_TTL_S": "1"},
]
LOOKAHEAD_BAD = [
    {"TPU_RAG_LOOKAHEAD": "yes"}, {"TPU_RAG_LOOKAHEAD_PRESTAGE": "2"}, {"TPU_RAG_LOOKAHEAD_WORKERS": "0"},
    {"TPU_RAG_LOOKAHEAD_INFLIGHT": "0"}, {"TPU_RAG_LOOKAHEAD_TTL_S": "0.05"},
    {"TPU_RAG_LOOKAHEAD_SESSION_TURNS": "0"}, {"TPU_RAG_LOOKAHEAD_SESSION_MAX": "many"},
    {"TPU_RAG_LOOKAHEAD_SESSION_TTL_S": "0.5"},
]


@pytest.mark.parametrize("env", LOOKAHEAD_GOOD + LOOKAHEAD_BAD)
def test_the_lookahead_keys_parse_as_jax_parses_them(env, caplog):
    try:
        want = JAppConfig.from_env(env)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            AppConfig.from_env(env)
        assert str(got.value) == str(e)
        return
    assert env not in LOOKAHEAD_BAD
    got = AppConfig.from_env(env)
    assert dataclasses.asdict(got.lookahead) == dataclasses.asdict(want.lookahead)
    assert "ignoring" not in caplog.text  # keys from_env reads


# the pool-role, flight WAL and router keys (ROADMAP.md Queue 1 item 8):
# good values parse to JAX's fields, bad ones raise JAX's message
LIFECYCLE_GOOD = [
    {"TPU_RAG_POOL_ROLE": "prefill", "TPU_RAG_KV_PAGED": "1"},
    {"TPU_RAG_POOL_ROLE": "decode", "TPU_RAG_KV_PAGED": "1", "TPU_RAG_SPEC_PAGED": "1"},
    {"TPU_RAG_POOL_ROLE": "unified"},
    {"TPU_RAG_FLIGHT_WAL": "1", "TPU_RAG_FLIGHT_WAL_RESTORE": "1", "TPU_RAG_FLIGHT_WAL_DIR": "/pvc/wal"},
    {"TPU_RAG_FLIGHT_WAL_SEGMENT_EVENTS": "1", "TPU_RAG_FLIGHT_WAL_SEGMENTS": "2",
     "TPU_RAG_FLIGHT_WAL_RESTORE_CHUNKS": "0"},
    {"TPU_RAG_FLIGHT": "0", "TPU_RAG_FLIGHT_ARRIVAL_IDS": "0"},
    {"TPU_RAG_ROUTER_AFFINITY_WEIGHT": "0", "TPU_RAG_ROUTER_LOAD_WEIGHT": "3", "TPU_RAG_ROUTER_HOT_CHUNKS": "1",
     "TPU_RAG_ROUTER_SESSION_TTL_S": "0.5"},
]
LIFECYCLE_BAD = [
    {"TPU_RAG_POOL_ROLE": "both"}, {"TPU_RAG_POOL_ROLE": "prefill"}, {"TPU_RAG_POOL_ROLE": "decode",
                                                                     "TPU_RAG_KV_PAGED": "0"},
    {"TPU_RAG_FLIGHT_WAL": "yes"}, {"TPU_RAG_FLIGHT_WAL_RESTORE": "on"}, {"TPU_RAG_FLIGHT": "2"},
    {"TPU_RAG_FLIGHT_ARRIVAL_IDS": "true"},
    {"TPU_RAG_FLIGHT_WAL_SEGMENT_EVENTS": "0"}, {"TPU_RAG_FLIGHT_WAL_SEGMENTS": "1"},
    {"TPU_RAG_FLIGHT_WAL_RESTORE_CHUNKS": "-1"}, {"TPU_RAG_FLIGHT_WAL_SEGMENTS": "many"},
    {"TPU_RAG_ROUTER_AFFINITY_WEIGHT": "-1"}, {"TPU_RAG_ROUTER_LOAD_WEIGHT": "-0.5"},
    {"TPU_RAG_ROUTER_HOT_CHUNKS": "0"}, {"TPU_RAG_ROUTER_SESSION_TTL_S": "0"}, {"TPU_RAG_ROUTER_HOT_CHUNKS": "x"},
]


@pytest.mark.parametrize("env", LIFECYCLE_GOOD + LIFECYCLE_BAD)
def test_the_pool_role_wal_and_router_keys_parse_as_jax_parses_them(env, caplog):
    try:
        want = JAppConfig.from_env(env)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            AppConfig.from_env(env)
        assert str(got.value) == str(e)
        return
    assert env not in LIFECYCLE_BAD
    got = AppConfig.from_env(env)
    for section, fields in _shared(got, want).items():
        for name, (g, w) in fields.items():
            assert g == w, (section, name)
    assert "ignoring" not in caplog.text  # keys from_env reads


# the keys of the paged speculative verify and the dense continuous cache
# (ROADMAP.md Queue 1 item 7), alone and in the pairs that used to be
# refused: good values parse to JAX's fields, bad ones raise JAX's message
ITEM7_GOOD = [
    {"TPU_RAG_SPEC_PAGED": "1"}, {"TPU_RAG_SPEC_PAGED": "0"},
    {"TPU_RAG_SPEC_PAGED": "1", "TPU_RAG_SPEC_PAGED_TOKENS": "3", "TPU_RAG_SPEC_PAGED_MIN_ACCEPT": "0"},
    {"TPU_RAG_BATCHING": "continuous"}, {"TPU_RAG_BATCHING": "continuous", "TPU_RAG_KV_PAGED": "0"},
    {"TPU_RAG_BATCHING": "continuous", "TPU_RAG_KV_PAGED": "1", "TPU_RAG_SPEC_PAGED": "1"},
]
ITEM7_BAD = [
    {"TPU_RAG_SPEC_PAGED": "yes"}, {"TPU_RAG_SPEC_PAGED_TOKENS": "0"}, {"TPU_RAG_SPEC_PAGED_TOKENS": "many"},
    {"TPU_RAG_SPEC_PAGED_MIN_ACCEPT": "-0.1"}, {"TPU_RAG_SPEC_PAGED_MIN_ACCEPT": "1.01"},
]


@pytest.mark.parametrize("env", ITEM7_GOOD + ITEM7_BAD)
def test_the_item_7_keys_parse_as_jax_parses_them(env, caplog):
    try:
        want = JAppConfig.from_env(env)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            AppConfig.from_env(env)
        assert str(got.value) == str(e)
        return
    assert env not in ITEM7_BAD
    got = AppConfig.from_env(env)
    for section, fields in _shared(got, want).items():
        for name, (g, w) in fields.items():
            assert g == w, (section, name)
    assert "ignoring" not in caplog.text  # keys from_env reads


# the prefix-cache and tiering keys (ROADMAP.md Queue 1 item 6): good values
# parse to JAX's fields, bad ones raise JAX's message
PREFIX_GOOD = [
    {"TPU_RAG_PREFIX_CACHE": "1"}, {"TPU_RAG_PREFIX_CACHE": "0"}, {"TPU_RAG_PREFIX_HBM_MB": "64"},
    {"TPU_RAG_PREFIX_REUSE": "chunk"}, {"TPU_RAG_PREFIX_REUSE": "slot"}, {"TPU_RAG_PREFIX_BOUNDARY_TOKENS": "0"},
    {"TPU_RAG_PREFIX_CHUNK_HOT_MIN": "0.5"}, {"TPU_RAG_PREFIX_CHUNK_POOL_REGS": "4"},
    {"TPU_RAG_KV_TIERING": "1", "TPU_RAG_KV_TIERING_WARM_BELOW": "0.5", "TPU_RAG_KV_TIERING_COLD_BELOW": "0.1",
     "TPU_RAG_KV_TIERING_HALF_LIFE_S": "30", "TPU_RAG_KV_TIERING_HOST_MB": "16",
     "TPU_RAG_KV_TIERING_INTERVAL_S": "0.5"},
]
PREFIX_BAD = [
    {"TPU_RAG_PREFIX_CACHE": "yes"}, {"TPU_RAG_PREFIX_HBM_MB": "0"}, {"TPU_RAG_PREFIX_HBM_MB": "lots"},
    {"TPU_RAG_PREFIX_REUSE": "fuzzy"}, {"TPU_RAG_PREFIX_BOUNDARY_TOKENS": "-1"},
    {"TPU_RAG_PREFIX_CHUNK_HOT_MIN": "-1"}, {"TPU_RAG_PREFIX_CHUNK_POOL_REGS": "0"}, {"TPU_RAG_KV_TIERING": "on"},
    {"TPU_RAG_KV_TIERING_WARM_BELOW": "0.01"}, {"TPU_RAG_KV_TIERING_HALF_LIFE_S": "0"},
    {"TPU_RAG_KV_TIERING_HOST_MB": "0"}, {"TPU_RAG_KV_TIERING_INTERVAL_S": "soon"},
]


@pytest.mark.parametrize("env", PREFIX_GOOD)
def test_a_prefix_cache_key_parses_as_jax_parses_it(env, caplog):
    jcfg, tcfg = JAppConfig.from_env(env).engine, AppConfig.from_env(env).engine
    for name in ("prefix_cache", "kv_tiering"):
        assert dataclasses.asdict(getattr(tcfg, name)) == dataclasses.asdict(getattr(jcfg, name)), name
    assert "ignoring" not in caplog.text  # keys from_env reads


@pytest.mark.parametrize("env", PREFIX_BAD)
def test_a_bad_prefix_cache_key_raises_the_jax_message(env):
    with pytest.raises(ValueError) as want:
        JAppConfig.from_env(env)
    with pytest.raises(ValueError) as got:
        AppConfig.from_env(env)
    assert str(got.value) == str(want.value)


def test_tpu_rag_faults_is_read_and_arms_the_site(caplog):
    from rag_llm_k8s_tpu_torch.resilience import faults

    env = {"TPU_RAG_FAULTS": "embed:1"}
    try:
        with caplog.at_level("WARNING"):
            AppConfig.from_env(env)
        assert "ignoring" not in caplog.text  # a key from_env knows
        assert tmain.arm_faults(env) == {"embed": 1}
        with pytest.raises(faults.InjectedFault, match="embed"):
            faults.maybe_fail("embed")
        faults.maybe_fail("embed")  # one traversal, then disarmed
        assert tmain.arm_faults({"TPU_RAG_FAULTS": "1"}) == {}  # enables the endpoint only
    finally:
        faults.clear()


def test_from_env_reads_the_resilience_keys_like_jax():
    env = {"TPU_RAG_ADMISSION_MAX_CONCURRENCY": "4", "TPU_RAG_ADMISSION_MAX_QUEUE": "0",
           "TPU_RAG_ADMISSION_RETRY_AFTER_S": "2.5", "TPU_RAG_DEADLINE_MS": "3000", "TPU_RAG_BREAKER_RESETS": "2",
           "TPU_RAG_BREAKER_WINDOW_S": "30", "TPU_RAG_INFLIGHT_RETRIES": "0", "TPU_RAG_RETRY_BACKOFF_MS": "0",
           "TPU_RAG_DRAIN_DEADLINE_S": "12.5", "TPU_RAG_DRAIN_RETRY_AFTER_S": "0.5"}
    for e in ({}, env):
        assert dataclasses.asdict(AppConfig.from_env(e).resilience) == dataclasses.asdict(
            JAppConfig.from_env(e).resilience)


def test_keys_that_leave_unported_features_off_are_accepted(caplog):
    env = {"TPU_RAG_MESH": "tp=-1", "TPU_RAG_SPEC_PAGED": "0", "TPU_RAG_POOL_ROLE": "unified",
           "TPU_RAG_SLO_TTFT_P95_S": "2", "TPU_RAG_SHADOW": "0", "TPU_RAG_WARM_FULL_LADDER": "1"}
    with caplog.at_level("WARNING"):
        AppConfig.from_env(env)
    # logged as ignored, not silently; the SLO and shadow keys are read now
    assert "TPU_RAG_WARM_FULL_LADDER" in caplog.text
    assert "TPU_RAG_SLO_TTFT_P95_S" not in caplog.text and "TPU_RAG_SHADOW" not in caplog.text


def test_only_the_shadow_and_warm_ladder_keys_are_left_unread():
    """Every ``TPU_RAG_*`` key the JAX config reads is read or refused by
    the port's, but ``TPU_RAG_WARM_FULL_LADDER`` (ROADMAP.md Queue 3 item
    A); the shadow auditor's keys are read since it was ported."""
    import re

    from rag_llm_k8s_tpu.core import config as jconfig
    from rag_llm_k8s_tpu_torch.core import config as tconfig

    with open(jconfig.__file__, encoding="utf-8") as f:
        keys = set(re.findall(r'"(TPU_RAG_[A-Z0-9_]+)"', f.read()))
    left = sorted(k for k in keys if k not in tconfig.PORTED_KEYS and k not in tconfig.UNPORTED_KEYS)
    assert left == ["TPU_RAG_WARM_FULL_LADDER"], left


# the goodput, SLO, tenant and incident-spool keys (ROADMAP.md Queue 1 item
# 9c-i): good values parse to JAX's fields; a malformed SLO value falls back
# to its default, as in JAX; the other malformed values raise JAX's message
OBS_GOOD = [
    {"TPU_RAG_GOODPUT": "0"}, {"TPU_RAG_GOODPUT": "1", "TPU_RAG_CHIP_HOUR_USD": "3.0"},
    {"TPU_RAG_GOODPUT_PEAK_TFLOPS": "197", "TPU_RAG_GOODPUT_HBM_GBS": "819"},
    {"TPU_RAG_SLO_AVAILABILITY_OBJECTIVE": "0.99", "TPU_RAG_SLO_REQUEST_P95_OBJECTIVE": "0.9",
     "TPU_RAG_SLO_REQUEST_P95_S": "3.5", "TPU_RAG_SLO_TTFT_P95_OBJECTIVE": "0.8", "TPU_RAG_SLO_TTFT_P95_S": "0.5",
     "TPU_RAG_SLO_QUALITY_OBJECTIVE": "0.98", "TPU_RAG_SLO_QUALITY_LOGIT_ERR": "0.2"},
    {"TPU_RAG_SLO_AVAILABILITY_OBJECTIVE": "7", "TPU_RAG_SLO_REQUEST_P95_S": "two seconds",
     "TPU_RAG_SLO_TTFT_P95_S": "0", "TPU_RAG_SLO_QUALITY_OBJECTIVE": "", "TPU_RAG_SLO_QUALITY_LOGIT_ERR": "-1"},
    {"TPU_RAG_TENANTS": "0", "TPU_RAG_TENANT_TOP_K": "3"},
    {"TPU_RAG_FLIGHT_SPOOL": "/srv/incidents", "TPU_RAG_FLIGHT_SPOOL_MAX": "4", "TPU_RAG_FLIGHT_COOLDOWN_S": "0"},
]
OBS_BAD = [
    {"TPU_RAG_GOODPUT": "yes"}, {"TPU_RAG_CHIP_HOUR_USD": "-1"}, {"TPU_RAG_GOODPUT_PEAK_TFLOPS": "-5"},
    {"TPU_RAG_GOODPUT_HBM_GBS": "fast"}, {"TPU_RAG_TENANTS": "yes"}, {"TPU_RAG_TENANT_TOP_K": "0"},
    {"TPU_RAG_TENANT_TOP_K": "many"}, {"TPU_RAG_FLIGHT_SPOOL_MAX": "0"}, {"TPU_RAG_FLIGHT_COOLDOWN_S": "-1"},
]


@pytest.mark.parametrize("env", OBS_GOOD)
def test_the_item_9c_i_keys_parse_as_jax_parses_them(env, caplog):
    with caplog.at_level("WARNING"):
        got = AppConfig.from_env(env)
    want = JAppConfig.from_env(env)
    assert dataclasses.asdict(got.engine.goodput) == dataclasses.asdict(want.engine.goodput)
    assert dataclasses.asdict(got.slo) == dataclasses.asdict(want.slo)
    assert dataclasses.asdict(got.tenants) == dataclasses.asdict(want.tenants)
    for name in ("spool_dir", "spool_max", "cooldown_s"):
        assert getattr(got.flight, name) == getattr(want.flight, name), name
    assert "ignoring" not in caplog.text  # keys from_env reads


@pytest.mark.parametrize("env", OBS_BAD)
def test_a_bad_item_9c_i_key_raises_the_jax_message(env):
    with pytest.raises(ValueError) as want:
        JAppConfig.from_env(env)
    with pytest.raises(ValueError) as got:
        AppConfig.from_env(env)
    assert str(got.value) == str(want.value)


# the shadow auditor's keys (ROADMAP.md Queue 1 item 9c-ii): good values
# parse to JAX's fields, bad ones raise JAX's message
SHADOW_GOOD = [
    {}, {"TPU_RAG_SHADOW": "0"}, {"TPU_RAG_SHADOW": "1", "TPU_RAG_SHADOW_SAMPLE_RATE": "1"},
    {"TPU_RAG_SHADOW_SAMPLE_RATE": "0", "TPU_RAG_SHADOW_BACKLOG": "1", "TPU_RAG_SHADOW_BURST_WINDOW_S": "0.5"},
    {"TPU_RAG_SHADOW_SAMPLE_RATE": "0.25", "TPU_RAG_SHADOW_BACKLOG": "32", "TPU_RAG_SHADOW_BURST_WINDOW_S": "60"},
]
SHADOW_BAD = [
    {"TPU_RAG_SHADOW": "2"}, {"TPU_RAG_SHADOW": "yes"}, {"TPU_RAG_SHADOW_SAMPLE_RATE": "1.5"},
    {"TPU_RAG_SHADOW_SAMPLE_RATE": "-0.1"}, {"TPU_RAG_SHADOW_SAMPLE_RATE": "often"}, {"TPU_RAG_SHADOW_BACKLOG": "0"},
    {"TPU_RAG_SHADOW_BACKLOG": "2.5"}, {"TPU_RAG_SHADOW_BURST_WINDOW_S": "0"},
    {"TPU_RAG_SHADOW_BURST_WINDOW_S": "-3"},
]


@pytest.mark.parametrize("env", SHADOW_GOOD)
def test_the_shadow_keys_parse_as_jax_parses_them(env, caplog):
    with caplog.at_level("WARNING"):
        got = AppConfig.from_env(env)
    assert dataclasses.asdict(got.shadow) == dataclasses.asdict(JAppConfig.from_env(env).shadow)
    assert "ignoring" not in caplog.text  # keys from_env reads


@pytest.mark.parametrize("env", SHADOW_BAD)
def test_a_bad_shadow_key_raises_the_jax_message(env):
    with pytest.raises(ValueError) as want:
        JAppConfig.from_env(env)
    with pytest.raises(ValueError) as got:
        AppConfig.from_env(env)
    assert str(got.value) == str(want.value)


def test_json_logs_make_a_request_line_one_object_with_its_trace_id(booted):
    """``TPU_RAG_JSON_LOGS=1``: ``main()`` installs the JSON formatter before
    anything logs; a request's access line is then one JSON object carrying
    the trace id the response names."""
    import io
    import logging

    svc, _ = booted
    root = logging.getLogger()
    saved = (list(root.handlers), root.level)
    try:
        tmain.configure_logging({"TPU_RAG_JSON_LOGS": "1", "TPU_RAG_LOG_LEVEL": "INFO"})
        (handler,) = root.handlers
        handler.setStream(buf := io.StringIO())
        r = create_app(svc).test_client().post("/generate", json_body={"prompt": QUESTIONS[0]})
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
        for h in saved[0]:
            root.addHandler(h)
        root.setLevel(saved[1])
    assert r.status_code == 200
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]  # every line one object
    access = [d for d in lines if d["logger"] == "rag_llm_k8s_tpu_torch.access"]
    assert len(access) == 1 and access[0]["trace_id"] == r.headers["x-trace-id"]
    assert access[0]["status"] == 200 and access[0]["route"] == "/generate" and access[0]["span_id"]
