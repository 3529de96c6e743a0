"""Word-window chunking (a copy of the JAX package's module).

Split on whitespace, windows of ``chunk_size`` words advancing by
``chunk_size - overlap`` (default 1000/200 ⇒ stride 800), last window may be
short, joined back with single spaces.
"""

from __future__ import annotations

from typing import List


def split_text(text: str, chunk_size: int = 1000, overlap: int = 200) -> List[str]:
    if chunk_size <= overlap:
        raise ValueError(f"chunk_size ({chunk_size}) must exceed overlap ({overlap})")
    words = text.split()
    stride = chunk_size - overlap
    return [" ".join(words[i : i + chunk_size]) for i in range(0, len(words), stride)]
