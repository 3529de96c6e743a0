"""Text normalization for the Unigram (SentencePiece) tokenizer pipeline,
the port's copy of ``rag_llm_k8s_tpu/tokenizer/normalize.py``.

The reference gets normalization for free from HF ``tokenizers``: bge-m3's
``tokenizer.json`` carries a ``Precompiled`` normalizer — a serialized
charsmap implementing SentencePiece's ``nmt_nfkc`` rules — applied before
segmentation (the reference's ``llm/rag.py:33``, via SentenceTransformer).

This module reimplements that behavior from the SentencePiece specification
rather than the binary charsmap: NMT character cleanup (control chars
dropped, separators to ASCII space), Unicode NFKC, and whitespace-run
folding. It also interprets the declarative ``normalizer`` section of any
``tokenizer.json`` (Sequence/NFx/Lowercase/Strip/Replace/Prepend/Nmt), so a
tokenizer whose spec differs from bge-m3's still normalizes correctly.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Callable, Optional

Normalizer = Callable[[str], str]

_WS_RUN = re.compile(r"\s+")


def _nmt_clean(text: str) -> str:
    """SentencePiece's NMT cleanup: drop control/format characters, map every
    separator (tab, newline, NBSP, ideographic space, ...) to ASCII space."""
    out = []
    for ch in text:
        cp = ord(ch)
        if ch in ("\t", "\n", "\r") or cp in (0x0085, 0x2028, 0x2029):
            out.append(" ")
            continue
        cat = unicodedata.category(ch)
        if cat == "Zs":  # all Unicode space separators → plain space
            out.append(" ")
            continue
        if cat in ("Cc", "Cf"):  # controls + zero-width/format chars: dropped
            continue
        out.append(ch)
    return "".join(out)


def nmt_nfkc(text: str, collapse_ws: bool = True) -> str:
    """The ``nmt_nfkc`` rule set (SentencePiece's default, and what bge-m3's
    Precompiled charsmap encodes): NMT cleanup → NFKC → fold whitespace runs
    to single spaces and strip the ends."""
    text = _nmt_clean(text)
    text = unicodedata.normalize("NFKC", text)
    if collapse_ws:
        text = _WS_RUN.sub(" ", text).strip()
    return text


def _precompiled(text: str) -> str:
    return nmt_nfkc(text, collapse_ws=False)


def _replace_fn(node: dict) -> Normalizer:
    from rag_llm_k8s_tpu_torch.tokenizer.bpe import compile_hf_regex

    pat = node.get("pattern", {})
    content = node.get("content", "")
    if "String" in pat:
        return lambda t, s=pat["String"], c=content: t.replace(s, c)
    # oniguruma-style pattern (\p{..} classes are common in SPM exports);
    # HF substitutes `content` LITERALLY — no backslash-escape/group
    # expansion, hence the lambda instead of a template string
    rx = compile_hf_regex(pat.get("Regex", ""))
    return lambda t, r=rx, c=content: r.sub(lambda _m: c, t)


def _strip_fn(node: dict) -> Normalizer:
    left, right = node.get("strip_left", True), node.get("strip_right", True)
    if left and right:
        return str.strip
    return str.lstrip if left else str.rstrip


def normalizer_from_spec(spec: Optional[dict]) -> Normalizer:
    """Build a normalizer from a ``tokenizer.json`` ``normalizer`` section.

    ``Precompiled`` (the serialized charsmap) is mapped to :func:`nmt_nfkc`,
    which is the rule set every SentencePiece-exported charsmap in the model
    families served here encodes. ``None`` means identity.
    """
    if not spec:
        return lambda t: t
    kind = spec.get("type")
    if kind == "Sequence":
        fns = [normalizer_from_spec(n) for n in spec.get("normalizers", [])]

        def _chain(t: str) -> str:
            for f in fns:
                t = f(t)
            return t

        return _chain
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda t, k=kind: unicodedata.normalize(k, t)
    if kind == "Lowercase":
        return str.lower
    if kind == "Strip":
        return _strip_fn(spec)
    if kind == "Replace":
        return _replace_fn(spec)
    if kind == "Prepend":
        # HF prepends unconditionally on non-empty input, even when the text
        # already starts with the prefix
        pre = spec.get("prepend", "")
        return lambda t, p=pre: (p + t) if t else t
    if kind == "Precompiled":
        # the charsmap is a per-character mapping: it folds separators and
        # applies NFKC-style rules but CANNOT collapse runs or strip ends —
        # specs that want folding add an explicit Replace node after it
        # (bge-m3: Sequence[Precompiled, Replace(" {2,}" -> " ")])
        return _precompiled
    if kind == "Nmt":
        return _nmt_clean
    # unknown node: pass text through rather than silently mis-normalizing —
    # segmentation still works, only exotic normalizers degrade
    return lambda t: t
