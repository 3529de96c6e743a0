"""Small token-sequence utilities shared across the serving stack."""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence


def compile_special_re(special_tokens: Iterable[str]):
    """Longest-first escaped alternation matching literal special-token
    strings in raw text (HF AddedVocabulary extraction order), or ``None``
    when there are none."""
    toks = sorted(special_tokens, key=len, reverse=True)
    if not toks:
        return None
    return re.compile("|".join(re.escape(t) for t in toks))


def truncate_keep_eos(
    ids: Sequence[int], limit: int, eos_id: Optional[int]
) -> List[int]:
    """Cut ``ids`` to ``limit``, restoring the trailing EOS the encoder was
    trained to expect — a bare ``[:limit]`` slice drops it and skews
    CLS-pooled embeddings (bge-m3 inputs are ``</s>``-terminated)."""
    ids = list(ids)
    if len(ids) <= limit:
        return ids
    ids = ids[:limit]
    if eos_id is not None:
        ids[-1] = eos_id
    return ids
