"""The port's service against the JAX package's: the same tiny fp32 weights
(bridged by ``models/convert.py``), the same PDFs, the same questions —
identical ``generated_text``, ``context`` and ``/index_info``.

Both services run under their ``BatchScheduler``, as ``server/main.py``
builds them, so a solo query takes the single-fetch path (device-side prompt
assembly) in both.
"""

import io
import subprocess
import sys
import zlib

import jax
import pytest
import torch

from rag_llm_k8s_tpu.core.config import AppConfig as JAppConfig
from rag_llm_k8s_tpu.core.config import DTypePolicy as JDTypes
from rag_llm_k8s_tpu.core.config import EncoderConfig as JEncoderConfig
from rag_llm_k8s_tpu.core.config import EngineConfig as JEngineConfig
from rag_llm_k8s_tpu.core.config import LlamaConfig as JLlamaConfig
from rag_llm_k8s_tpu.core.config import SamplingConfig as JSampling
from rag_llm_k8s_tpu.core.config import ShadowConfig as JShadowConfig
from rag_llm_k8s_tpu.engine.batching import BatchScheduler
from rag_llm_k8s_tpu.engine.encoder import EncoderRunner as JEncoderRunner
from rag_llm_k8s_tpu.engine.engine import InferenceEngine as JEngine
from rag_llm_k8s_tpu.index.store import VectorStore as JStore
from rag_llm_k8s_tpu.models.bge_m3 import init_encoder_params
from rag_llm_k8s_tpu.models.llama import init_llama_params
from rag_llm_k8s_tpu.server.app import RagService as JRagService
from rag_llm_k8s_tpu.server.app import create_app as jcreate_app
from rag_llm_k8s_tpu_torch.core.config import (
    AppConfig,
    DTypePolicy,
    EncoderConfig,
    EngineConfig,
    LlamaConfig,
    SamplingConfig,
    ShadowConfig,
)
from rag_llm_k8s_tpu_torch.engine.batching import BatchScheduler as TBatchScheduler
from rag_llm_k8s_tpu_torch.engine.encoder import EncoderRunner
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.index.store import VectorStore
from rag_llm_k8s_tpu_torch.models import convert
from rag_llm_k8s_tpu_torch.models.bge_m3 import build_encoder
from rag_llm_k8s_tpu_torch.models.llama import build_llama
from rag_llm_k8s_tpu_torch.server.app import RagService, create_app

CPU = torch.device("cpu")
VOCAB = 300
# 512: the byte-tokenized head (system message) is ~345 ids, so the fused
# path needs the 512 bucket to leave room for context
ENGINE = dict(prompt_buckets=(128, 512), max_batch_size=2, max_seq_len=640)
ENC_BUCKETS = (32, 64)


class ByteTokenizer:
    """Reversible byte-level stub tokenizer (ids = byte + 3)."""

    def encode(self, text):
        return [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids, skip_special_tokens=True):
        return bytes((i - 3) % 256 for i in ids if i >= 3).decode("utf-8", "replace")


def make_pdf(text: str, compress: bool = False) -> bytes:
    content = f"BT /F1 12 Tf ({text}) Tj ET".encode()
    filt = b""
    if compress:
        content = zlib.compress(content)
        filt = b" /Filter /FlateDecode"
    return b"".join([
        b"%PDF-1.4\n",
        b"1 0 obj << /Type /Catalog /Pages 2 0 R >> endobj\n",
        b"2 0 obj << /Type /Pages /Kids [3 0 R] /Count 1 >> endobj\n",
        b"3 0 obj << /Type /Page /Parent 2 0 R /Contents 4 0 R "
        b"/Resources << /Font << /F1 5 0 R >> >> >> endobj\n",
        b"4 0 obj << /Length %d%s >> stream\n%s\nendstream endobj\n" % (len(content), filt, content),
        b"5 0 obj << /Type /Font /Subtype /Type1 /BaseFont /Helvetica >> endobj\n",
        b"%%EOF",
    ])


PDFS = [
    ("kernels.pdf", make_pdf("flash attention kernels tile queries and keys in shared memory")),
    ("retrieval.pdf", make_pdf("retrieval ranks chunk embeddings by squared distance", compress=True)),
    ("serving.pdf", make_pdf("the server assembles the prompt on the device from chunk tokens")),
]
QUESTIONS = ["what do kernels tile?", "how are chunks ranked?"]
# a tail past the 128-token fused bucket: the host path serves it
LONG_QUESTION = "which component assembles the prompt, and where does it do that? " * 2


@pytest.fixture(scope="module")
def clients():
    jl, je = JLlamaConfig.tiny(VOCAB), JEncoderConfig.tiny(VOCAB)
    jfp32 = JDTypes.fp32()
    lparams = init_llama_params(jax.random.PRNGKey(0), jl, jfp32)
    eparams = init_encoder_params(jax.random.PRNGKey(1), je, jfp32)

    jengine = JEngine(
        jl, lparams, sampling=JSampling(do_sample=False, max_new_tokens=8),
        engine_config=JEngineConfig(**ENGINE), dtypes=jfp32,
    )
    jencoder = JEncoderRunner(je, eparams, dtypes=jfp32, length_buckets=ENC_BUCKETS, max_batch=4)
    jsvc = JRagService(
        JAppConfig(model=jl, encoder=je, shadow=JShadowConfig(sample_rate=0.0)), jengine, ByteTokenizer(), jencoder,
        ByteTokenizer(), JStore(dim=je.hidden_size), scheduler=BatchScheduler(jengine, max_wait_ms=5.0),
    )
    jsvc.ready = True

    lc, ec, fp32 = LlamaConfig.tiny(VOCAB), EncoderConfig.tiny(VOCAB), DTypePolicy.fp32()
    model = convert.load_llama(build_llama(lc, fp32, CPU), convert.flatten_tree(lparams))
    enc = convert.load_encoder(build_encoder(ec, fp32, CPU), convert.flatten_tree(eparams))
    engine = InferenceEngine(
        lc, model, sampling=SamplingConfig(do_sample=False, max_new_tokens=8),
        engine_config=EngineConfig(**ENGINE), dtypes=fp32, device="cpu",
    )
    encoder = EncoderRunner(ec, enc, device="cpu", length_buckets=ENC_BUCKETS, max_batch=4)
    svc = RagService(
        AppConfig(model=lc, encoder=ec, shadow=ShadowConfig(sample_rate=0.0)), engine, ByteTokenizer(), encoder,
        ByteTokenizer(), VectorStore(dim=ec.hidden_size, device="cpu"),
        scheduler=TBatchScheduler(engine, max_wait_ms=5.0),
    )
    svc.ready = True
    try:
        yield jcreate_app(jsvc).test_client(), create_app(svc).test_client(), svc
    finally:
        jsvc.shutdown()
        svc.shutdown()


@pytest.fixture(scope="module")
def uploaded(clients):
    jc, tc, _ = clients
    for name, pdf in PDFS:
        jr = jc.post("/upload_pdf", data={"file": (io.BytesIO(pdf), name)},
                     content_type="multipart/form-data")
        tr = tc.post("/upload_pdf", files={"file": (name, pdf)})
        assert tr.status_code == jr.status_code == 200
        assert tr.get_json() == jr.get_json()
    return clients


def test_index_info_matches(uploaded):
    jc, tc, _ = uploaded
    assert tc.get("/index_info").get_json() == jc.get("/index_info").get_json()


@pytest.mark.parametrize("route", ["/generate", "/query"])
def test_fused_answers_match(uploaded, route, monkeypatch):
    jc, tc, svc = uploaded
    fused = []
    real = svc.engine.generate_rag
    monkeypatch.setattr(svc.engine, "generate_rag", lambda *a, **kw: fused.append(1) or real(*a, **kw))
    for q in QUESTIONS:
        want = jc.post(route, json={"prompt": q}).get_json()
        got = tc.post(route, json_body={"prompt": q}).get_json()
        assert got["generated_text"] == want["generated_text"]
        assert got["context"] == want["context"]
        assert "Document '" in got["context"]
        assert {"tokenize_ms", "embed_retrieve_ms", "generate_ms", "total_ms"} <= set(got["timings"])
    assert len(fused) == len(QUESTIONS)  # every solo query took the single-fetch path


def test_long_question_takes_the_host_path_and_matches(uploaded, monkeypatch):
    jc, tc, svc = uploaded
    assert len(svc._b_ids(LONG_QUESTION)) > svc.engine.RAG_TAIL_BUCKET
    host = []
    real = svc.engine.generate
    monkeypatch.setattr(svc.engine, "generate", lambda *a, **kw: host.append(1) or real(*a, **kw))
    want = jc.post("/generate", json={"prompt": LONG_QUESTION}).get_json()
    got = tc.post("/generate", json_body={"prompt": LONG_QUESTION}).get_json()
    assert host == [1]
    assert got["generated_text"] == want["generated_text"]
    assert got["context"] == want["context"]


def test_irreducible_question_takes_chunked_prefill_and_matches(uploaded):
    # head + question overflow the 512 bucket: the budgeted whole-string
    # prompt goes through whole, to chunked prefill
    jc, tc, svc = uploaded
    question = "tell me everything about kernels and chunks and devices " * 8
    assert len(svc._a_ids()) + len(svc._b_ids(question)) > max(ENGINE["prompt_buckets"])
    want = jc.post("/generate", json={"prompt": question}).get_json()
    got = tc.post("/generate", json_body={"prompt": question}).get_json()
    assert got["generated_text"] == want["generated_text"]
    assert got["context"] == want["context"]


def test_upload_rejections_and_health(clients):
    _, tc, _ = clients
    assert tc.get("/healthz").status_code == 200
    assert tc.post("/upload_pdf", json_body={}).get_json() == {"error": "No file part"}
    r = tc.post("/upload_pdf", files={"file": ("notes.txt", b"x")})
    assert r.status_code == 400 and r.get_json() == {"error": "Invalid file format"}
    assert tc.get("/nope").status_code == 404
    assert tc.get("/generate").status_code == 405


def test_empty_index_message():
    lc, ec, fp32 = LlamaConfig.tiny(VOCAB), EncoderConfig.tiny(VOCAB), DTypePolicy.fp32()
    gen = torch.Generator().manual_seed(0)
    engine = InferenceEngine(
        lc, convert.init_random_(build_llama(lc, fp32, CPU), gen),
        engine_config=EngineConfig(prompt_buckets=(128,)), dtypes=fp32, device="cpu",
    )
    encoder = EncoderRunner(ec, convert.init_random_(build_encoder(ec, fp32, CPU), gen), device="cpu")
    svc = RagService(AppConfig(model=lc, encoder=ec), engine, ByteTokenizer(), encoder,
                     ByteTokenizer(), VectorStore(dim=ec.hidden_size, device="cpu"))
    c = create_app(svc).test_client()
    assert c.get("/healthz").status_code == 503  # not marked ready
    body = c.post("/generate", json_body={"prompt": "anything"}).get_json()
    assert body == {"generated_text": "No relevant information found in the index."}


def test_default_device_is_the_card_or_an_error():
    from rag_llm_k8s_tpu_torch.core.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_port_imports_neither_jax_nor_the_jax_package():
    # every module of the port, found by walking the package (so a module
    # added later is covered), and chip_smoke.py; the card machine has none
    # of jax, flax, regex, safetensors, tokenizers or ml_dtypes
    code = (
        "import importlib, pkgutil, sys\n"
        "for absent in ('jax', 'flax', 'regex', 'safetensors', 'tokenizers', 'ml_dtypes'):\n"
        "    sys.modules[absent] = None\n"
        "import rag_llm_k8s_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'rag_llm_k8s_tpu' or m.startswith('rag_llm_k8s_tpu.')]\n"
        "assert not bad, bad\n"
        "need = {'engine.continuous', 'engine.kv_pool', 'sim.policy', 'server.app', 'ops.attention',\n"
        "        'tokenizer.bpe', 'tokenizer.unigram', 'models.loader', 'engine.batching', 'server.main',\n"
        "        'obs.flight', 'obs.metrics', 'obs.tracing', 'obs.logging', 'resilience', 'resilience.faults',\n"
        "        'resilience.deadline', 'resilience.breaker', 'resilience.admission', 'resilience.lifecycle',\n"
        "        'server.router', 'sim.replay', 'rag.lookahead', 'obs.goodput', 'obs.slo', 'obs.tenants',\n"
        "        'obs.devices', 'obs.regression', 'obs.shadow', 'sim.simulator', 'sim.tracegen',\n"
        "        'core.mesh', 'parallel.sharding', 'parallel.ring_attention', 'parallel.launch',\n"
        "        'parallel.commands', 'engine.engine', 'engine.prefix_cache', 'engine.tiering',\n"
        "        'engine.training', 'parallel.dryrun'}\n"
        "assert need <= {m.split('.', 1)[1] for m in mods}, mods\n"
        "print('clean', len(mods))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]),
    )
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
