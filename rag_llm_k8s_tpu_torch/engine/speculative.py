"""Host half of the paged speculative verify, counterpart of
``rag_llm_k8s_tpu/engine/speculative.py`` (a copy: numpy only).

The continuous engine's verify window splits in two: the device half is one
multi-token forward per window (``ContinuousEngine._step_verify``: K + 1 fed
tokens per row through the block tables, K + 1 logit planes, acceptance on
the device), and this module decides between windows what to draft:

- :func:`prompt_lookup_draft`, the draft source: the tokens that followed
  the most recent earlier occurrence of the row's trailing ``ngram``-gram
  in its own history (assembled prompt + emitted). Grounded answers quote
  their retrieved context, so the context is the draft corpus.
- :func:`adaptive_draft_len` / :func:`fold_acceptance`, the per-row
  controller: each verify window folds a row's acceptance fraction into a
  decayed EMA, and the next window's draft length scales with it.

Correctness lives in the verify's acceptance rule (``engine/sampling.py``
``accept_drafts``: accept while the draft equals the model's own keyed
target), so nothing here changes what a request emits.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = [
    "SPEC_EMA_DECAY",
    "adaptive_draft_len",
    "fold_acceptance",
    "prompt_lookup_draft",
]

#: Per-row acceptance EMA decay: ~5-window memory, so a row that alternates
#: between quoted spans and free text tracks the current one.
SPEC_EMA_DECAY = 0.8


def prompt_lookup_draft(
    history: Sequence[int], ngram: int, k: int
) -> List[int]:
    """Up to ``k`` draft tokens for a row whose token history is
    ``history``: the continuation of the most recent EARLIER occurrence of
    the trailing ``ngram``-gram, ``[]`` when the gram never repeats. A
    continuation is truncated at the frontier rather than rejected."""
    n = len(history)
    if k <= 0 or ngram <= 0 or n < ngram + 1:
        return []
    h = np.asarray(history, dtype=np.int64)
    tail = h[-ngram:]
    # candidate END positions j in [0, n-2]: the gram occupies
    # [j-ngram+1, j] and must end strictly before the frontier gram (an
    # occurrence ending at n-1 is the frontier matching itself)
    ok = np.ones(n - 1, dtype=bool)
    for i in range(ngram):
        col = np.empty(n - 1, dtype=np.int64)
        col[:i] = -1  # j < i cannot hold a full gram
        if i:
            col[i:] = h[: n - 1 - i]
        else:
            col[:] = h[: n - 1]
        ok &= col == tail[ngram - 1 - i]
    idx = np.nonzero(ok)[0]
    if idx.size == 0:
        return []
    j = int(idx[-1])
    return [int(t) for t in h[j + 1 : j + 1 + k]]


def adaptive_draft_len(
    ema: Optional[float], k_max: int, min_accept: float
) -> int:
    """This window's draft length for a row with acceptance EMA ``ema``:
    ``k_max`` with no evidence yet (``None``), 1 below ``min_accept``,
    else ``round(ema * k_max)`` clamped to ``[1, k_max]``."""
    if k_max < 1:
        return 0
    if ema is None:
        return k_max
    if ema < min_accept:
        return 1
    return max(1, min(k_max, int(round(ema * k_max))))


def fold_acceptance(
    ema: Optional[float], offered: int, accepted: int
) -> Optional[float]:
    """Fold one verify window's acceptance fraction into a row's decayed
    EMA (identity when the window offered nothing)."""
    if offered <= 0:
        return ema
    r = accepted / offered
    if ema is None:
        return r
    return SPEC_EMA_DECAY * ema + (1.0 - SPEC_EMA_DECAY) * r
