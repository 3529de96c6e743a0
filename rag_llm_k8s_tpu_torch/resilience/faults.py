"""Deterministic fault injection for the serving path.

The port's copy of ``rag_llm_k8s_tpu/resilience/faults.py`` (standard library
only, like the original).

Production resilience claims ("an engine reset is invisible to the client",
"a queue over cap sheds instead of blocking") are only claims until a test
can MAKE the fault happen on demand. This module is the switchboard: code
at a handful of named *sites* calls :func:`maybe_fail`, which is a no-op in
normal operation and raises :class:`InjectedFault` when the site is armed.

Arming is count-based and deterministic — ``arm("decode_step", times=2)``
fires the next two traversals of that site and then disarms itself — so a
chaos test asserts exact behavior (first submit hits the reset, the
resubmit succeeds) rather than probabilistic flakiness.

Three ways to arm:

- programmatic (the chaos suite): ``faults.arm(site, times)`` / ``clear()``;
- environment (a chaos run / a staging pod): ``TPU_RAG_FAULTS`` as a
  ``site:count`` list, e.g. ``TPU_RAG_FAULTS=decode_step:1,embed:2``
  (``TPU_RAG_FAULTS=1`` enables the debug endpoint without arming anything);
- HTTP (a running server with the env flag set): ``POST /debug/faults``
  with ``{"site": ..., "times": N}`` — gated on the env flag so a
  production pod can never be fault-armed remotely by default.

The site catalog (``SITES``) is closed on purpose: a typo'd site name is a
programming error, not a silently-never-firing fault. The catalog is the
JAX package's whole; the port's paths traverse ``store_lookup``, ``embed``,
``insert``, ``decode_step``, ``generate``, ``migrate`` and the prefix
cache's ``kv_swap_in`` and ``chunk_splice``; ``lookahead_retrieve`` sits on
a path it has not ported yet (``ROADMAP.md`` Queue 1 item 8).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

__all__ = [
    "SITES",
    "InjectedFault",
    "arm",
    "arm_from_env",
    "armed",
    "clear",
    "endpoint_enabled",
    "maybe_fail",
]

# Every call site that can be armed, with the failure it models:
#   store_lookup — the vector store's result materialization (index corruption
#                  / a wedged mmap);
#   embed        — the encoder forward (device fault during embedding);
#   insert       — the continuous engine's KV splice (fires inside the donated
#                  region, so it triggers the EngineStateLost reset path);
#   decode_step  — the continuous engine's decode step (device fault mid-
#                  generation — the recovery/resubmit path's trigger);
#   generate     — the one-shot engine's generate call (coalesce-mode
#                  equivalent of decode_step);
#   lookahead_retrieve — the lookahead executor's worker-side retrieval
#                  (rag/lookahead.py): a failed speculation must fall back
#                  to the inline retrieve path and release everything it
#                  staged — never fail the request.
#   kv_swap_in   — a cold-tier host→HBM KV swap-in (engine/prefix_cache.py
#                  and the paged prestage scatter): a failed swap must fall
#                  back to recompute-from-tokens, release the host buffer,
#                  and leak zero blocks on either substrate.
#   chunk_splice — a chunk-granular prefix-reuse splice (engine/
#                  prefix_cache.py rerotate path and the paged per-chunk
#                  block assembly in engine/continuous.py): a failed splice
#                  must fall back to recompute-from-tokens (cache) or the
#                  buffer-scatter path (pool) and leak zero blocks/entries.
#   migrate      — a prefill→decode pool-block hand-off landing on the
#                  decode-role engine (engine/continuous.py import_request):
#                  fires inside the donated region, so the decode engine
#                  resets (EngineStateLost) and the scheduler re-prefills
#                  prompt+emitted there — streams stay byte-identical and
#                  neither engine leaks a block (docs/ROUTER.md).
SITES = (
    "store_lookup", "embed", "insert", "decode_step", "generate",
    "lookahead_retrieve", "kv_swap_in", "chunk_splice", "migrate",
)

ENV_VAR = "TPU_RAG_FAULTS"


class InjectedFault(RuntimeError):
    """A deliberately injected failure (carries its site name)."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at site {site!r}")
        self.site = site


_lock = threading.Lock()
_armed: Dict[str, int] = {}


def _check_site(site: str) -> None:
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r}; sites: {SITES}")


def arm(site: str, times: int = 1) -> None:
    """Arm ``site`` to fail its next ``times`` traversals."""
    _check_site(site)
    if times < 1:
        raise ValueError(f"times={times}: expected >= 1")
    with _lock:
        _armed[site] = times


def clear(site: Optional[str] = None) -> None:
    """Disarm one site, or everything when ``site`` is None."""
    with _lock:
        if site is None:
            _armed.clear()
        else:
            _armed.pop(site, None)


def armed() -> Dict[str, int]:
    """Snapshot of remaining failure counts per armed site."""
    with _lock:
        return dict(_armed)


def maybe_fail(site: str) -> None:
    """The injection point. Free when nothing is armed (one dict read)."""
    if not _armed:  # benign race: arming concurrently just delays one shot
        return
    with _lock:
        n = _armed.get(site, 0)
        if n <= 0:
            return
        if n == 1:
            del _armed[site]
        else:
            _armed[site] = n - 1
    raise InjectedFault(site)


def endpoint_enabled(env: Optional[dict] = None) -> bool:
    """Whether the ``/debug/faults`` endpoint may arm sites: only when the
    operator set ``TPU_RAG_FAULTS`` (to anything) at process start."""
    env = os.environ if env is None else env
    return ENV_VAR in env


def arm_from_env(env: Optional[dict] = None) -> Dict[str, int]:
    """Parse ``TPU_RAG_FAULTS`` and arm the listed sites.

    Grammar: comma-separated ``site[:count]`` entries (count defaults to 1).
    The bare values ``""``/``"0"``/``"1"`` arm nothing — they exist so an
    operator can enable the debug endpoint without pre-arming a fault.
    A malformed entry raises: a chaos run with a typo'd site must fail
    loudly, not run green having injected nothing.
    """
    env = os.environ if env is None else env
    spec = env.get(ENV_VAR, "").strip()
    if spec in ("", "0", "1"):
        return {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            site, _, cnt = part.partition(":")
            try:
                times = int(cnt)
            except ValueError as e:
                raise ValueError(
                    f"{ENV_VAR}={spec!r}: bad count in {part!r}"
                ) from e
        else:
            site, times = part, 1
        arm(site.strip(), times)
    return armed()
