"""Byte-level BPE tokenizer (the Llama-3 / GPT-2 family algorithm), the port's
copy of ``rag_llm_k8s_tpu/tokenizer/bpe.py``.

Loads an HF ``tokenizer.json`` and reproduces HF ``tokenizers`` behavior:
byte→unicode remapping, regex pre-tokenization, the ranked merge loop and
special-token splitting. The merge loop runs in C++ (``native/bpe.cpp``,
built with ``g++`` at first use) when the library builds; the pure-Python
loop here is its plain version and gives the same ids.

Pre-tokenization patterns are HF's (oniguruma-style) regexes with ``\\p{L}``
and ``\\p{N}`` classes. The JAX package compiles them with the third-party
``regex`` module; the port uses the standard library's ``re`` only, so
:func:`translate_hf_regex` rewrites ``\\p{L}``, ``\\p{N}``, ``\\s`` and ``\\S``
as explicit code-point classes built from ``unicodedata`` (general categories
``L*`` and ``N*``; ``\\s`` as ``regex`` defines it, which differs from
``re``'s by U+001C-U+001F). The classes are exact for every code point that
this Python's ``unicodedata`` assigns (Unicode 15.0 on Python 3.12). A newer
``regex`` release knows later Unicode versions, so the two can disagree on
code points assigned after 15.0, which ``unicodedata`` calls unassigned.
"""

from __future__ import annotations

import ctypes
import functools
import json
import logging
import re
import sys
import unicodedata
from typing import Dict, Iterable, List, Optional, Tuple

from rag_llm_k8s_tpu_torch.utils.tokens import compile_special_re

logger = logging.getLogger(__name__)

# regex's \s: White_Space minus nothing, and NOT the information separators
# U+001C-U+001F that stdlib re's \s (str.isspace) also matches
_SPACE_RANGES = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"


def _escape_cp(cp: int) -> str:
    return f"\\U{cp:08x}"


@functools.lru_cache(maxsize=None)
def _category_ranges(prefix: str) -> str:
    """The code points whose ``unicodedata`` general category starts with
    ``prefix``, as ``re`` character-class ranges (no brackets)."""
    out: List[str] = []
    start = prev = None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)).startswith(prefix):
            if start is None:
                start = cp
            prev = cp
            continue
        if start is not None:
            out.append(_escape_cp(start) if start == prev else f"{_escape_cp(start)}-{_escape_cp(prev)}")
            start = None
    if start is not None:
        out.append(f"{_escape_cp(start)}-{_escape_cp(prev)}")
    return "".join(out)


def _class_body(esc: str) -> Optional[str]:
    """Ranges for a class escape that may sit inside ``[...]``."""
    if esc == r"\p{L}":
        return _category_ranges("L")
    if esc == r"\p{N}":
        return _category_ranges("N")
    if esc == r"\s":
        return _SPACE_RANGES
    return None


_ESCAPE = re.compile(r"\\p\{[A-Za-z_]+\}|\\P\{[A-Za-z_]+\}|\\.", re.S)


def translate_hf_regex(pattern: str) -> str:
    """Rewrite an HF pre-tokenization pattern for stdlib ``re`` with the
    exact classes (see the module docstring). Other escapes pass through;
    a property class other than ``\\p{L}`` / ``\\p{N}`` raises."""
    out: List[str] = []
    i, in_class = 0, False
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\":
            m = _ESCAPE.match(pattern, i)
            esc = m.group(0)
            i = m.end()
            body = _class_body(esc)
            if body is not None:
                out.append(body if in_class else f"[{body}]")
            elif esc == r"\S":
                if in_class:
                    raise ValueError(f"\\S inside a character class is not supported: {pattern!r}")
                out.append(f"[^{_SPACE_RANGES}]")
            elif esc.startswith(("\\p{", "\\P{")):
                raise ValueError(f"unsupported property class {esc} in {pattern!r}")
            else:
                out.append(esc)
            continue
        if in_class:
            if ch == "]":
                in_class = False
        elif ch == "[":
            in_class = True
            out.append(ch)
            i += 1
            # a leading ^ and a leading ] belong to the class
            if i < len(pattern) and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < len(pattern) and pattern[i] == "]":
                out.append("\\]")
                i += 1
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def compile_hf_regex(pattern: str):
    """Compile an HF tokenizers (oniguruma-style) pattern with stdlib ``re``."""
    return re.compile(translate_hf_regex(pattern))


# GPT-2's byte-level pre-tokenization regex (what a bare ByteLevel
# pre-tokenizer with use_regex=True applies).
_GPT2_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)

# Llama-3's pattern (tokenizer.json carries it in a Split pre-tokenizer; this
# is the default when none is specified).
_LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)


def _pattern_from_spec(spec: dict) -> str:
    """The raw pre-tokenization regex of a tokenizer.json ``pre_tokenizer``
    section (Split nodes carry explicit regexes; a bare ByteLevel with
    use_regex implies the GPT-2 pattern)."""
    pre = spec.get("pre_tokenizer") or {}
    nodes = pre.get("pretokenizers", [pre]) if pre.get("type") == "Sequence" else [pre]
    for node in nodes:
        if node.get("type") == "Split":
            pat = node.get("pattern", {})
            if "Regex" in pat:
                return pat["Regex"]
    for node in nodes:
        if node.get("type") == "ByteLevel" and node.get("use_regex", True):
            return _GPT2_PATTERN
    return _LLAMA3_PATTERN


@functools.lru_cache(maxsize=1)
def byte_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→printable-unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAD))
        + list(range(0xAE, 0x100))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(maxsize=1)
def unicode_to_byte() -> Dict[str, int]:
    return {v: k for k, v in byte_to_unicode().items()}


class ByteLevelBPETokenizer:
    """``native=True`` builds and loads the C++ merge loop (a failed build is
    logged and leaves ``self.native`` False: the pure-Python loop serves);
    ``native=False`` never tries."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: List[Tuple[str, str]],
        special_tokens: Optional[Dict[str, int]] = None,
        pattern: str = _LLAMA3_PATTERN,
        native: bool = True,
    ):
        self.vocab = vocab
        self.id_to_token = {i: t for t, i in vocab.items()}
        self.ranks: Dict[Tuple[str, str], int] = {m: r for r, m in enumerate(merges)}
        self.special_tokens = dict(special_tokens or {})
        self.id_to_special = {i: t for t, i in self.special_tokens.items()}
        self._pattern = compile_hf_regex(pattern)
        self._special_re = compile_special_re(self.special_tokens)
        self._b2u = byte_to_unicode()
        self._u2b = unicode_to_byte()
        self._cache: Dict[str, List[int]] = {}
        self._native = self._init_native() if native else None
        # texts encoded through the C++ loop (read by chip_smoke.py)
        self.native_calls = 0

    @property
    def native(self) -> bool:
        """Whether the C++ merge loop is loaded."""
        return self._native is not None

    def _init_native(self):
        """Load the C++ merge loop; None ⇒ the pure-Python loop."""
        from rag_llm_k8s_tpu_torch.native.build import load_library

        lib = load_library("bpe")
        if lib is None:
            return None
        lib.bpe_create.restype = ctypes.c_void_p
        lib.bpe_destroy.argtypes = [ctypes.c_void_p]
        lib.bpe_add_token.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
        lib.bpe_add_merge.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32]
        for fn in (lib.bpe_encode_word, lib.bpe_encode_words):
            fn.restype = ctypes.c_int32
            fn.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
        handle = ctypes.c_void_p(lib.bpe_create())
        for token, tid in self.vocab.items():
            lib.bpe_add_token(handle, token.encode("utf-8"), tid)
        for (a, b), rank in self.ranks.items():
            lib.bpe_add_merge(handle, a.encode("utf-8"), b.encode("utf-8"), rank)
        return (lib, handle)

    def __del__(self):
        nat = getattr(self, "_native", None)
        if nat is not None:
            nat[0].bpe_destroy(nat[1])

    @property
    def vocab_size(self) -> int:
        return len(self.vocab) + len(
            [t for t in self.special_tokens if t not in self.vocab]
        )

    # ------------------------------------------------------------------
    def _bpe_word(self, word: str) -> List[int]:
        """Merge loop over one pre-token (already byte-remapped)."""
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        parts = list(word)
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        ids = []
        for p in parts:
            tid = self.vocab.get(p)
            if tid is None:
                # unmergeable unknown: emit per-char byte tokens where known
                ids.extend(self.vocab[c] for c in p if c in self.vocab)
            else:
                ids.append(tid)
        if len(self._cache) < 65536:
            self._cache[word] = ids
        return ids

    def _encode_ordinary(self, text: str) -> List[int]:
        remapped_words = [
            "".join(self._b2u[b] for b in m.group(0).encode("utf-8"))
            for m in self._pattern.finditer(text)
        ]
        if self._native is not None and remapped_words:
            ids = self._encode_words_native(remapped_words)
            if ids is not None:
                self.native_calls += 1
                return ids
        out: List[int] = []
        for word in remapped_words:
            out.extend(self._bpe_word(word))
        return out

    def _encode_words_native(self, words: List[str]) -> Optional[List[int]]:
        """One ctypes crossing for the whole text (``bpe_encode_words``);
        None when the output buffer overflows twice."""
        lib, handle = self._native
        joined = "\n".join(words).encode("utf-8")
        buf_len = max(64, 2 * sum(len(w) for w in words) + 8)
        for _ in range(2):
            buf = (ctypes.c_int32 * buf_len)()
            n = lib.bpe_encode_words(handle, joined, buf, buf_len)
            if n >= 0:
                return list(buf[:n])
            buf_len *= 4
        return None

    def encode(self, text: str, add_bos: bool = False, bos_id: Optional[int] = None) -> List[int]:
        """Encode, honoring special tokens embedded in the text (chat headers)."""
        ids: List[int] = []
        if add_bos and bos_id is not None:
            ids.append(bos_id)
        if self._special_re is None:
            ids.extend(self._encode_ordinary(text))
            return ids
        pos = 0
        for m in self._special_re.finditer(text):
            if m.start() > pos:
                ids.extend(self._encode_ordinary(text[pos : m.start()]))
            ids.append(self.special_tokens[m.group(0)])
            pos = m.end()
        if pos < len(text):
            ids.extend(self._encode_ordinary(text[pos:]))
        return ids

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        out: List[str] = []
        buf: List[int] = []

        def flush():
            if buf:
                out.append(bytes(buf).decode("utf-8", errors="replace"))
                buf.clear()

        for i in ids:
            sp = self.id_to_special.get(int(i))
            if sp is not None:
                flush()
                if not skip_special_tokens:
                    out.append(sp)
                continue
            tok = self.id_to_token.get(int(i))
            if tok is None:
                continue
            buf.extend(self._u2b[c] for c in tok if c in self._u2b)
        flush()
        return "".join(out)

    # ------------------------------------------------------------------
    @classmethod
    def from_tokenizer_json(cls, path: str, native: bool = True) -> "ByteLevelBPETokenizer":
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model.get("type") != "BPE":
            raise ValueError(f"not a BPE tokenizer.json: {model.get('type')}")
        vocab = dict(model["vocab"])
        merges = []
        for m in model["merges"]:
            if isinstance(m, str):
                a, b = m.split(" ", 1)
            else:
                a, b = m
            merges.append((a, b))
        specials = {
            t["content"]: t["id"] for t in spec.get("added_tokens", []) if t.get("special")
        }
        return cls(
            vocab=vocab,
            merges=merges,
            special_tokens=specials,
            pattern=_pattern_from_spec(spec),
            native=native,
        )
