"""The one traffic generator: it reads a mix's parameters (a JSON file
under ``benchmark/mixes``) and makes, from the seed, the index's chunk
texts and each client's questions.

A mix's rounds fix the sizes: round ``r`` of every client takes
``rounds[r % len(rounds)]``, a question of that many words (and, where the
round names one, a report of that many words pasted before it), give or
take ``jitter_words`` (on the report where there is one). The offsets of one round are a fixed set spread over
the clients, and the seed only deals them out and picks the words. So every
seed sends the same sizes in the same rounds, in another order and with
other words, and a batch formed in round ``r`` pads to the same bucket
whatever the seed.

Texts are ASCII words from one frozen list (``WORDS``), so the reference's
tokenizers read them exactly.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MIX_DIR = os.path.join(HERE, "mixes")


def _word_list(n: int = 4096) -> List[str]:
    """Lower-case words of 2 to 9 letters, the same on every run."""
    rng = np.random.default_rng(20240718)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    out, seen = [], set()
    while len(out) < n:
        w = "".join(rng.choice(letters, int(rng.integers(2, 10))))
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


WORDS = np.array(_word_list())


def _seed_ints(seed: int, tag: str) -> np.random.Generator:
    """A numpy generator for one use of one run's seed (any size of seed)."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
                                  int.from_bytes(tag.encode()[:8].ljust(8, b"\0"), "little") & 0xFFFFFFFF])


@dataclass(frozen=True)
class Mix:
    name: str
    clients: int
    think_ms: float
    chunks: int
    chunk_words: int
    chunks_per_doc: int
    rounds: tuple
    jitter_words: int
    requests_per_client: int

    @classmethod
    def load(cls, name: str, path: Optional[str] = None) -> "Mix":
        with open(path or os.path.join(MIX_DIR, f"{name}.json")) as f:
            d = json.load(f)
        return cls.from_dict(d)

    @classmethod
    def from_dict(cls, d: Dict) -> "Mix":
        if d.get("loop") != "closed":
            raise ValueError(f"mix {d.get('name')}: only closed loops are generated")
        idx = d["index"]
        return cls(
            name=d["name"], clients=int(d["clients"]), think_ms=float(d.get("think_ms", 0.0)),
            chunks=int(idx["chunks"]), chunk_words=int(idx["chunk_words"]),
            chunks_per_doc=int(idx["chunks_per_doc"]), rounds=tuple(dict(r) for r in d["rounds"]),
            jitter_words=int(d.get("jitter_words", 0)), requests_per_client=int(d["requests_per_client"]),
        )


def _words(rng: np.random.Generator, n: int) -> str:
    return " ".join(WORDS[rng.integers(0, len(WORDS), n)])


def chunk_metadata(mix: Mix, seed: int) -> List[Dict]:
    """The index's chunks: ``{"filename", "chunk_id", "text"}``, row ``i``
    being chunk ``i % chunks_per_doc`` of document ``i // chunks_per_doc``."""
    rng = _seed_ints(seed, "chunks")
    idx = rng.integers(0, len(WORDS), (mix.chunks, mix.chunk_words))
    per = mix.chunks_per_doc
    return [{"filename": f"doc{i // per:05d}.pdf", "chunk_id": i % per, "text": " ".join(WORDS[row])}
            for i, row in enumerate(idx)]


def row_of(filename: str, chunk_id: int, mix: Mix) -> int:
    """The index row of a chunk named as ``chunk_metadata`` names it."""
    return int(filename[3:8]) * mix.chunks_per_doc + int(chunk_id)


def _offsets(n: int, jitter: int) -> np.ndarray:
    """A fixed spread of ``n`` offsets in ``[-jitter, jitter]``."""
    if jitter <= 0 or n <= 1:
        return np.zeros(n, np.int64)
    return np.rint(np.linspace(-jitter, jitter, n)).astype(np.int64)


def questions(mix: Mix, seed: int) -> List[List[str]]:
    """Each client's questions, in the order it sends them."""
    rng = _seed_ints(seed, "questions")
    out: List[List[str]] = [[] for _ in range(mix.clients)]
    offs = _offsets(mix.clients, mix.jitter_words)
    for r in range(mix.requests_per_client):
        spec = mix.rounds[r % len(mix.rounds)]
        dealt = rng.permutation(offs)
        for c in range(mix.clients):
            report = int(spec.get("report_words", 0))
            if report:
                # the report takes the round's spread; the question keeps its size
                q = _words(rng, int(spec["question_words"]))
                text = f"Report: {_words(rng, report + int(dealt[c]))}. Question: {q}?"
            else:
                text = _words(rng, max(1, int(spec["question_words"]) + int(dealt[c]))) + "?"
            out[c].append(text)
    return out
