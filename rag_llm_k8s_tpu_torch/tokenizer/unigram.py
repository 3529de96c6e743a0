"""Unigram (SentencePiece) tokenizer — the XLM-R / bge-m3 algorithm; the
port's copy of ``rag_llm_k8s_tpu/tokenizer/unigram.py``.

Loads the HF ``tokenizer.json`` of a Unigram model and segments with Viterbi
over piece log-probabilities (max-likelihood segmentation), after the spec's
normalizer (``tokenizer/normalize.py`` — NFKC/charsmap rules) and the
Metaspace pre-tokenizer (word-initial ``▁``). Replaces the Rust tokenizer
behind the reference's ``SentenceTransformer('BAAI/bge-m3')``
(the reference's ``llm/rag.py:33``).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple

from rag_llm_k8s_tpu_torch.tokenizer.normalize import (
    Normalizer,
    nmt_nfkc,
    normalizer_from_spec,
)
from rag_llm_k8s_tpu_torch.utils.tokens import compile_special_re

_SPACE = "\u2581"  # the SentencePiece metaspace marker


class _Trie:
    __slots__ = ("children", "piece_id", "score")

    def __init__(self):
        self.children: Dict[str, "_Trie"] = {}
        self.piece_id: Optional[int] = None
        self.score: float = 0.0


def _metaspace_from_spec(spec: dict) -> Tuple[str, str]:
    """(replacement, prepend_scheme) from a tokenizer.json pre_tokenizer.
    Scheme is HF's: "always" | "first" (only the input's first segment gets
    the marker — newer SPM exports) | "never". Defaults match SentencePiece
    exports: ``▁``, always prepended."""
    pre = spec.get("pre_tokenizer") or {}
    nodes = pre.get("pretokenizers", [pre]) if pre.get("type") == "Sequence" else [pre]
    for node in nodes:
        if node.get("type") == "Metaspace":
            repl = node.get("replacement", _SPACE)
            if "prepend_scheme" in node:
                scheme = node["prepend_scheme"]
            else:
                scheme = "always" if node.get("add_prefix_space", True) else "never"
            return repl, scheme
    return _SPACE, "always"


class UnigramTokenizer:
    def __init__(
        self,
        pieces: List[Tuple[str, float]],
        unk_id: Optional[int] = None,
        special_tokens: Optional[Dict[str, int]] = None,
        bos_id: Optional[int] = 0,
        eos_id: Optional[int] = 2,
        add_bos_eos: bool = True,
        normalize: Optional[Normalizer] = None,
        replacement: str = _SPACE,
        prepend: object = True,  # bool (legacy) or "always"|"first"|"never"
    ):
        self.pieces = pieces
        self.unk_id = unk_id
        self.special_tokens = dict(special_tokens or {})
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.add_bos_eos = add_bos_eos
        # bge-m3 (and every SentencePiece export) normalizes before
        # segmenting; defaulting to nmt_nfkc keeps direct constructions
        # (tests, fixtures) on the same behavior as spec-loaded tokenizers
        self.normalize: Normalizer = nmt_nfkc if normalize is None else normalize
        self.replacement = replacement
        # normalize bool (legacy API) to the HF scheme vocabulary
        if prepend is True:
            prepend = "always"
        elif prepend is False:
            prepend = "never"
        if prepend not in ("always", "first", "never"):
            raise ValueError(f"prepend={prepend!r}: expected always|first|never")
        self.prepend = prepend
        self.id_to_piece = {i: p for i, (p, _) in enumerate(pieces)}
        for t, i in self.special_tokens.items():
            self.id_to_piece.setdefault(i, t)
        # HF extracts special-token strings from raw text BEFORE
        # normalization/pre-tokenization (AddedVocabulary)
        self._special_re = compile_special_re(self.special_tokens)
        # SentencePiece's unk scoring rule (kUnkPenalty, mirrored by the HF
        # Rust Unigram's unk_score_penalty=10): the unk fallback scores 10
        # below the WORST in-vocab piece, derived from the spec instead of a
        # hardcoded constant — OOV-heavy multilingual text segments the same
        # way the Rust engine does regardless of the vocab's score range
        scores = [s for _, s in pieces]
        self.unk_score = (min(scores) if scores else 0.0) - 10.0
        self._root = _Trie()
        for i, (piece, score) in enumerate(pieces):
            node = self._root
            for ch in piece:
                node = node.children.setdefault(ch, _Trie())
            node.piece_id = i
            node.score = score

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    # ------------------------------------------------------------------
    def _viterbi(self, text: str) -> List[int]:
        n = len(text)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Tuple[int, Optional[int]]] = [(-1, None)] * (n + 1)
        best[0] = 0.0
        unk_penalty = self.unk_score
        for i in range(n):
            if best[i] == NEG:
                continue
            node = self._root
            j = i
            matched = False
            while j < n:
                node = node.children.get(text[j])
                if node is None:
                    break
                j += 1
                if node.piece_id is not None:
                    matched = True
                    s = best[i] + node.score
                    if s > best[j]:
                        best[j] = s
                        back[j] = (i, node.piece_id)
            if not matched or best[i + 1] == NEG:
                # unk fallback: single char
                s = best[i] + unk_penalty
                if s > best[i + 1]:
                    best[i + 1] = s
                    back[i + 1] = (i, self.unk_id)
        ids: List[int] = []
        pos = n
        while pos > 0:
            prev, pid = back[pos]
            if pid is not None:
                ids.append(pid)
            pos = prev
        ids.reverse()
        if self.unk_id is None:
            return ids
        # HF Unigram fuses runs of unknown characters into ONE <unk>; the
        # per-char fallback above must collapse the same way for id parity
        fused: List[int] = []
        for pid in ids:
            if pid == self.unk_id and fused and fused[-1] == self.unk_id:
                continue
            fused.append(pid)
        return fused

    def _encode_segment(self, text: str, first: bool = True) -> List[int]:
        """Normalize + Metaspace + Viterbi over one special-free span.
        ``first``: whether this span starts the whole input (the
        "first" prepend scheme marks only that one)."""
        text = self.normalize(text)
        if not text:
            return []
        # Metaspace: spaces → ▁, word-initial ▁ (sentencepiece handling)
        body = text.replace(" ", self.replacement)
        mark = self.prepend == "always" or (self.prepend == "first" and first)
        if mark and not body.startswith(self.replacement):
            body = self.replacement + body
        return self._viterbi(body)

    def encode(self, text: str, add_special: Optional[bool] = None) -> List[int]:
        add_special = self.add_bos_eos if add_special is None else add_special
        if self._special_re is None:
            ids = self._encode_segment(text)
        else:
            ids = []
            pos = 0
            for m in self._special_re.finditer(text):
                ids.extend(self._encode_segment(text[pos : m.start()], first=pos == 0))
                ids.append(self.special_tokens[m.group()])
                pos = m.end()
            ids.extend(self._encode_segment(text[pos:], first=pos == 0))
        if add_special and self.bos_id is not None and self.eos_id is not None:
            return [self.bos_id] + ids + [self.eos_id]
        return ids

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        specials = set(self.special_tokens.values())
        if self.bos_id is not None:
            specials.add(self.bos_id)
        if self.eos_id is not None:
            specials.add(self.eos_id)
        parts: List[str] = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in specials:
                continue
            parts.append(self.id_to_piece.get(i, ""))
        return "".join(parts).replace(self.replacement, " ").strip()

    # ------------------------------------------------------------------
    @classmethod
    def from_tokenizer_json(cls, path: str) -> "UnigramTokenizer":
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model.get("type") != "Unigram":
            raise ValueError(f"not a Unigram tokenizer.json: {model.get('type')}")
        pieces = [(p, float(s)) for p, s in model["vocab"]]
        specials = {
            t["content"]: t["id"] for t in spec.get("added_tokens", []) if t.get("special")
        }
        bos = specials.get("<s>")
        eos = specials.get("</s>")
        replacement, prepend = _metaspace_from_spec(spec)
        return cls(
            pieces=pieces,
            unk_id=model.get("unk_id"),
            special_tokens=specials,
            bos_id=bos,
            eos_id=eos,
            normalize=normalizer_from_spec(spec.get("normalizer")),
            replacement=replacement,
            prepend=prepend,
        )
