"""The port's tokenizers against the JAX package's, on the committed
``tokenizer.json`` fixtures: identical ids from the port's C++ merge loop
and from its pure-Python loop, with and without BOS / special tokens, and
identical decodes.

The JAX tokenizer compiles HF's ``\\p{L}`` / ``\\p{N}`` patterns with the
third-party ``regex`` module; the port translates them for stdlib ``re``
(``tokenizer/bpe.py``). The corpus leans on where the two could part:
combining marks (the JAX package's own stdlib fallback counts them as
letters), digit runs, ``\\r\\n`` and whitespace runs, the information
separators U+001C-U+001F (``re``'s ``\\s`` has them, ``regex``'s does not),
emoji and special-token strings inside text. The property test draws text
from code points this Python's ``unicodedata`` assigns.
"""

import ast
import glob
import os

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rag_llm_k8s_tpu.tokenizer import load_tokenizer as jax_load_tokenizer
from rag_llm_k8s_tpu_torch.tokenizer import load_tokenizer
from rag_llm_k8s_tpu_torch.tokenizer.bpe import translate_hf_regex

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FILES = sorted(glob.glob(os.path.join(FIXTURES, "tokenizers", "*.json")))


def _fixture_corpora():
    """The training corpora of the committed fixtures (read from
    ``gen_tokenizers.py`` without importing it: it needs ``tokenizers``)."""
    tree = ast.parse(open(os.path.join(FIXTURES, "gen_tokenizers.py")).read())
    out = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") in ("CORPUS", "MULTI_CORPUS"):
            value = node.value.left if isinstance(node.value, ast.BinOp) else node.value
            if isinstance(value, ast.List):
                out += [ast.literal_eval(e) for e in value.elts if isinstance(e, ast.Constant)]
    return sorted(set(out))


CORPUS = _fixture_corpora() + [
    "", "a", " ", "  leading and trailing  ", "tabs\tand\nnewlines\r\nand\r\n\r\nmore",
    "digits 1 12 123 1234 12345 0.5 3,141,592", "١٢٣٤ ١٢ ²³ Ⅻ ½ ٣٫١٤",  # non-ASCII N* classes
    "기술 레이더는 도구, 기법, 플랫폼의 스냅샷입니다.", "日本語のテキストも正しく分割されるべきです。",
    "café naïve über résumé — ça va?", "café é̂ composed",  # combining marks
    "हिन्दी देवनागरी लिपि", "नमस्ते दुनिया",  # Devanagari vowel signs (Mc / Mn)
    "ＦＵＬＬｗｉｄｔｈ１２３", "nbsp\xa0and em-space　ideographic",
    "emoji 🚀 🧭 👩‍💻 fin", "ψψφ consecutive unknowns ψ",
    "I'LL 'S 'ſ don't we'VE they'Re", "sep\x1cfile\x1dgroup\x1erecord\x1funit", "x\x0by\x0cz",
    "ψ<unk>ψ", "a <s> b", "<s>hello</s>", "<unk><unk>",
    "<|begin_of_text|>hello world<|end_of_text|>", "mid<|end_of_text|>text",
    "punctuation!!! and... spaces   here", "def f(x): return x+1  # code",
]


@pytest.fixture(scope="module", params=[os.path.basename(f) for f in FILES])
def trio(request):
    path = os.path.join(FIXTURES, "tokenizers", request.param)
    port = load_tokenizer(path)
    plain = load_tokenizer(path, native=False)
    return jax_load_tokenizer(path), port, plain


def test_the_native_loop_builds_and_the_plain_one_stays_plain(trio):
    _, port, plain = trio
    if hasattr(port, "native"):
        assert port.native and not plain.native


@pytest.mark.parametrize("text", CORPUS)
def test_ids_match_the_jax_tokenizer(trio, text):
    jtok, port, plain = trio
    want = jtok.encode(text)
    assert port.encode(text) == want
    assert plain.encode(text) == want


@pytest.mark.parametrize("text", CORPUS[::3])
def test_bos_and_special_tokens_match(trio, text):
    jtok, port, plain = trio
    if hasattr(jtok, "ranks"):  # BPE: an explicit BOS id
        for tok in (port, plain):
            assert tok.encode(text, add_bos=True, bos_id=7) == jtok.encode(text, add_bos=True, bos_id=7)
    else:  # Unigram: <s> ... </s> or not
        for flag in (True, False):
            assert port.encode(text, add_special=flag) == jtok.encode(text, add_special=flag)


@pytest.mark.parametrize("text", CORPUS[::2])
def test_decode_round_trips_match(trio, text):
    jtok, port, _ = trio
    ids = jtok.encode(text)
    assert port.decode(ids) == jtok.decode(ids)
    assert port.decode(ids, skip_special_tokens=False) == jtok.decode(ids, skip_special_tokens=False)
    if hasattr(jtok, "ranks") and not port.special_tokens:
        assert port.decode(port.encode(text)) == text  # byte-level BPE is lossless


@settings(max_examples=150, deadline=None)
@given(text=st.text(alphabet=st.characters(blacklist_categories=("Cn", "Cs")), max_size=40))
def test_ids_match_on_any_assigned_code_points(text):
    for path in FILES:
        want = _jax_tok(path).encode(text)
        assert _port_tok(path, True).encode(text) == want, path
        assert _port_tok(path, False).encode(text) == want, path


_CACHE = {}


def _jax_tok(path):
    return _CACHE.setdefault(("jax", path), jax_load_tokenizer(path))


def _port_tok(path, native):
    return _CACHE.setdefault(("port", path, native), load_tokenizer(path, native=native))


def test_the_pattern_translation_is_exact_on_every_assigned_code_point():
    import re
    import sys
    import unicodedata

    regex = pytest.importorskip("regex")
    for pat in (r"\p{L}", r"\p{N}", r"\s", r"[^\s\p{L}\p{N}]", r"[^\r\n\p{L}\p{N}]", r"\S"):
        ours, theirs = re.compile(translate_hf_regex(pat)), regex.compile(pat)
        bad = [cp for cp in range(sys.maxunicode + 1)
               if unicodedata.category(chr(cp)) not in ("Cn", "Cs")
               and bool(ours.fullmatch(chr(cp))) != bool(theirs.fullmatch(chr(cp)))]
        assert not bad, (pat, [hex(c) for c in bad[:10]])


def test_unsupported_property_classes_raise():
    with pytest.raises(ValueError, match="unsupported property class"):
        translate_hf_regex(r"\p{Lu}+")
