"""Plain tokenizers for the reference: byte-level BPE and Unigram over the
frozen ``tokenizer.json`` copies in ``benchmark/tokenizers``.

Written from the published algorithms (GPT-2's byte-level BPE with its
pre-tokenization pattern; SentencePiece's Unigram with a Viterbi search,
Metaspace marking and the NFKC / whitespace normalizer the fixture names),
for ASCII text only: the benchmark's texts are ASCII, and there the
pattern's classes are ``[A-Za-z]``, ``[0-9]`` and ASCII white space. A
non-ASCII text raises rather than risk a silent difference.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, List, Tuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BPE_FILE = os.path.join(HERE, "tokenizers", "bpe_multi.json")
UNIGRAM_FILE = os.path.join(HERE, "tokenizers", "unigram_norm.json")

# GPT-2's pre-tokenization pattern with its classes spelled for ASCII
_GPT2_ASCII = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+", re.ASCII
)


def _check_ascii(text: str) -> None:
    if not text.isascii():
        raise ValueError("the reference tokenizers take ASCII text only")


def _byte_chars() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character table."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class PlainBPE:
    """Byte-level BPE: each pre-token's bytes as characters, then the
    lowest-ranked adjacent pair merged, leftmost first, until none is
    ranked."""

    def __init__(self, path: str = BPE_FILE):
        with open(path, encoding="utf-8") as f:
            model = json.load(f)["model"]
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.ranks: Dict[Tuple[str, str], int] = {}
        for r, m in enumerate(model["merges"]):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.ranks[(a, b)] = r
        self.chars = _byte_chars()
        self.bytes_of = {c: b for b, c in self.chars.items()}
        self.token_of = {i: t for t, i in self.vocab.items()}
        self._memo: Dict[str, List[int]] = {}

    def _word(self, word: str) -> List[int]:
        got = self._memo.get(word)
        if got is not None:
            return got
        parts = list(word)
        while len(parts) > 1:
            pairs = [(self.ranks.get((parts[i], parts[i + 1])), i) for i in range(len(parts) - 1)]
            ranked = [p for p in pairs if p[0] is not None]
            if not ranked:
                break
            _, i = min(ranked)
            parts[i : i + 2] = [parts[i] + parts[i + 1]]
        ids: List[int] = []
        for p in parts:
            if p in self.vocab:
                ids.append(self.vocab[p])
            else:
                ids.extend(self.vocab[c] for c in p if c in self.vocab)
        self._memo[word] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        _check_ascii(text)
        out: List[int] = []
        for m in _GPT2_ASCII.finditer(text):
            out.extend(self._word("".join(self.chars[b] for b in m.group(0).encode())))
        return out

    def decode(self, ids: Iterable[int]) -> str:
        """Known ids to their bytes, read as UTF-8 (ids outside the
        vocabulary give nothing)."""
        buf = bytearray()
        for i in ids:
            tok = self.token_of.get(int(i))
            if tok is not None:
                buf.extend(self.bytes_of[c] for c in tok if c in self.bytes_of)
        return bytes(buf).decode("utf-8", errors="replace")


class PlainUnigram:
    """Unigram: NFKC (the identity on ASCII), white-space runs to one space,
    ends stripped, spaces to the meta symbol with one in front, then the
    most likely segmentation (Viterbi; an unknown character scores 10 below
    the worst piece, runs of unknowns fold into one), between ``<s>`` and
    ``</s>``."""

    META = "▁"

    def __init__(self, path: str = UNIGRAM_FILE):
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        self.pieces: Dict[str, Tuple[int, float]] = {}
        for i, (p, s) in enumerate(model["vocab"]):
            self.pieces[p] = (i, float(s))
        self.longest = max(len(p) for p in self.pieces)
        self.unk_id = model.get("unk_id")
        self.unk_score = min(s for _, s in model["vocab"]) - 10.0
        specials = {t["content"]: t["id"] for t in spec.get("added_tokens", []) if t.get("special")}
        self.bos_id, self.eos_id = specials["<s>"], specials["</s>"]

    def encode(self, text: str) -> List[int]:
        _check_ascii(text)
        text = re.sub(r"\s+", " ", text).strip()
        ids: List[int] = []
        if text:
            body = self.META + text.replace(" ", self.META)
            ids = self._viterbi(body)
        return [self.bos_id] + ids + [self.eos_id]

    def _viterbi(self, s: str) -> List[int]:
        n = len(s)
        neg = float("-inf")
        best = [neg] * (n + 1)
        back: List[Tuple[int, object]] = [(-1, None)] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == neg:
                continue
            matched = False
            for j in range(i + 1, min(n, i + self.longest) + 1):
                hit = self.pieces.get(s[i:j])
                if hit is None:
                    continue
                matched = True
                score = best[i] + hit[1]
                if score > best[j]:
                    best[j], back[j] = score, (i, hit[0])
            if not matched or best[i + 1] == neg:
                score = best[i] + self.unk_score
                if score > best[i + 1]:
                    best[i + 1], back[i + 1] = score, (i, self.unk_id)
        ids: List[int] = []
        pos = n
        while pos > 0:
            prev, pid = back[pos]
            if pid is not None:
                ids.append(pid)
            pos = prev
        ids.reverse()
        folded: List[int] = []
        for pid in ids:
            if pid == self.unk_id and folded and folded[-1] == self.unk_id:
                continue
            folded.append(pid)
        return folded
