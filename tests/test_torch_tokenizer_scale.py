"""The port's tokenizers against the JAX package's at true scale: the 128k
byte-level BPE and the 250k-piece Unigram of ``tests/fixtures/
tokenizers_scale`` (gitignored; generated with the ``tokenizers`` wheel as
``tests/test_tokenizer_scale.py`` generates them, here into a temporary
directory when the shared copy is missing or half written, so two test
processes never read each other's partial files). Skipped where the
``tokenizers`` wheel is absent."""

import importlib.util
import json
import os

import pytest

pytest.importorskip("tokenizers")

from rag_llm_k8s_tpu.tokenizer import load_tokenizer as jax_load_tokenizer  # noqa: E402
from rag_llm_k8s_tpu_torch.tokenizer import load_tokenizer  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SCALE_DIR = os.path.join(FIXTURES, "tokenizers_scale")
NAMES = ("bpe_128k.json", "unigram_250k.json")

SAMPLES = [
    "The Technology Radar is a snapshot of tools, techniques and platforms.",
    "def chunk_prefill_attention_q8(q, k_cache, v_cache, k_scale, v_scale):",
    "punctuation!!! and... spaces   here\ttabs\nnewlines\r\n\r\n  x",
    "기술 레이더는 도구, 기법, 플랫폼의 스냅샷입니다.",
    "日本語のテキストも正しく分割されるべきです。",
    "café naïve über résumé — ça va? 🚀 हिन्दी देवनागरी",
    "digits 1 12 123 1234 12345 ١٢٣٤",
    "<|begin_of_text|>hello world<|end_of_text|>",
    "",
    "x",
]


def _complete(path):
    try:
        with open(path, encoding="utf-8") as f:
            json.load(f)
        return True
    except (OSError, ValueError):
        return False


@pytest.fixture(scope="module")
def scale_dir(tmp_path_factory):
    if all(_complete(os.path.join(SCALE_DIR, n)) for n in NAMES):
        return SCALE_DIR
    spec = importlib.util.spec_from_file_location("gen_tokenizers", os.path.join(FIXTURES, "gen_tokenizers.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    out = str(tmp_path_factory.mktemp("tokenizers_scale"))
    gen.gen_scale(out)
    return out


@pytest.fixture(scope="module", params=NAMES)
def trio(request, scale_dir):
    path = os.path.join(scale_dir, request.param)
    port = load_tokenizer(path)
    # the Unigram tokenizer has no native loop: one load serves both roles
    plain = load_tokenizer(path, native=False) if hasattr(port, "native") else port
    return jax_load_tokenizer(path), port, plain


@pytest.mark.parametrize("text", SAMPLES)
def test_ids_match_the_jax_tokenizer_at_scale(trio, text):
    jtok, port, plain = trio
    want = jtok.encode(text)
    assert port.encode(text) == want
    assert plain.encode(text) == want
    assert port.decode(want) == jtok.decode(want)


def test_a_long_document_matches_at_scale(trio):
    jtok, port, _ = trio
    text = " ".join(SAMPLES) * 20
    assert port.encode(text) == jtok.encode(text)
