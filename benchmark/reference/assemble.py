"""The RAG prompt as the deployment defines it, built from the chunks a
request retrieved: a fixed head (BOS, the system message, "Context: "),
the top chunks' segments that fit the largest bucket, the question's tail.
A question whose head and tail leave under 16 tokens of room instead takes
the whole-string prompt: the context shrinks (trailing chunks dropped, then
the first chunk's words trimmed) until the prompt fits or cannot shrink.

Frozen here with the system message, so that the yardstick does not move
with the program.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

SYSTEM_MESSAGE = (
    "You are a helpful assistant. Answer the user's question based ONLY on the given context.\n"
    "If the context doesn't contain relevant information to the specific question, say "
    "'I don't have enough information to answer that specific question.'\n"
    "Do not make up information or use general knowledge outside of the given context."
)

_CONTEXT_ITEM = re.compile(r"Document '([^']*)' \(chunk (\d+), score: (-?[0-9.]+)\): ")


def context_text(items: Sequence[Tuple[Dict, str]]) -> str:
    """``items``: ``(chunk metadata, score as printed)``."""
    return "".join(f"Document '{m['filename']}' (chunk {m['chunk_id']}, score: {s}): {m['text']}\n\n"
                   for m, s in items)


def parse_context(context: str) -> List[Tuple[str, int, str]]:
    """``(filename, chunk_id, score as printed)`` of each chunk a response's
    context names, in order."""
    return [(m.group(1), int(m.group(2)), m.group(3)) for m in _CONTEXT_ITEM.finditer(context)]


def head_ids(bpe, bos: int) -> List[int]:
    ids = bpe.encode(f"{SYSTEM_MESSAGE}\n\nContext: ")
    return ids if ids and ids[0] == bos else [bos] + ids


def tail_ids(bpe, question: str) -> List[int]:
    return bpe.encode(f"\n\nUser: {question}\n\nChatbot:")


def segment_ids(bpe, meta: Dict, largest: int) -> List[int]:
    return bpe.encode(f"Document '{meta['filename']}' (chunk {meta['chunk_id']}): {meta['text']}\n\n")[:largest]


def kept_chunks(lens: Sequence[int], avail: int) -> Tuple[int, Optional[int]]:
    """The longest prefix of the segments that fits ``avail``; a first
    segment that alone overflows is cut to ``avail``. ``(n_kept, cut)``."""
    used = n = 0
    for j, L in enumerate(lens):
        if used + L > avail:
            return (1, max(avail, 0)) if j == 0 else (n, None)
        used += L
        n += 1
    return n, None


def piecewise(bpe, question: str, metas: Sequence[Dict], bos: int, largest: int) -> Optional[Tuple[int, List[int]]]:
    """``(chunks kept, prompt ids)``, or None when head and tail leave under
    16 tokens of room."""
    a, b = head_ids(bpe, bos), tail_ids(bpe, question)
    avail = largest - len(a) - len(b)
    if avail < 16:
        return None
    segs = [segment_ids(bpe, m, largest) for m in metas]
    n, cut = kept_chunks([len(s) for s in segs], avail)
    kept = segs[:n]
    if cut is not None:
        kept[0] = kept[0][:cut]
    return n, a + [t for s in kept for t in s] + b


def whole_string(bpe, question: str, items: Sequence[Tuple[Dict, str]], bos: int,
                 largest: int) -> Tuple[str, List[int]]:
    """``(context, prompt ids)`` of the whole-string prompt, shrunk from
    ``items`` (chunk metadata, score as printed)."""
    used = [(dict(m), s) for m, s in items]
    while True:
        context = context_text(used)
        ids = bpe.encode(f"{SYSTEM_MESSAGE}\n\nContext: {context}\n\nUser: {question}\n\nChatbot:")
        if not ids or ids[0] != bos:
            ids = [bos] + ids
        if len(ids) <= largest:
            return context, ids
        if len(used) > 1:
            used.pop()
            continue
        words = used[0][0]["text"].split()
        target = min(len(words) - 1, int(len(words) * largest / len(ids) * 0.9))
        if target < 10:
            return context, ids
        used[0][0]["text"] = " ".join(words[:target])


def extract_answer(text: str) -> str:
    """What a response's ``generated_text`` is: the text after the last
    "Chatbot:", stripped."""
    return text.split("Chatbot:")[-1].strip()
