"""Engine flight recorder, the port's copy of ``rag_llm_k8s_tpu/obs/flight.py``.

- :data:`EVENTS` — the CLOSED catalog of typed event names, copied whole
  with :data:`SCHEMA_VERSION`, so a journal from either package reads the
  same. A typo'd event name raises instead of journaling nothing.
- :class:`FlightRecorder` — a fixed-size ring of monotonic-stamped events:
  one append under one small lock, no device work, no I/O.
- ``timeline(rid)`` — one request's ordered event chain with inter-event
  deltas; events carry the scheduler's request id.
- :func:`stream_hash` — FNV-1a over a token stream, the identity a
  ``complete`` event records of what the client received.

Not here yet: the durable WAL tee (``FlightWAL``, ``scan_wal``,
``durable_write``, ``export_journal``, ``load_journal``) and the incident
spooler (``ROADMAP.md`` Queue 1 items 8 and 9c).

The module imports only the standard library.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional

__all__ = [
    "EVENTS",
    "SCHEMA_VERSION",
    "FlightRecorder",
    "arrival_ids",
    "configure",
    "emit",
    "recorder",
    "stream_hash",
]

#: Journal schema version (the JAX package's): bumped whenever an event's
#: attrs change meaning.
SCHEMA_VERSION = 1

# The closed event catalog: name -> what the event records (the JAX
# package's whole catalog; the port emits the ones its paths have).
EVENTS: Dict[str, str] = {
    # -- continuous engine / scheduler (engine/continuous.py) ------------
    "arrival": "request submitted to the scheduler (prompt_len, max_new; "
               "seed/deadline_ms when set; prompt token ids while the "
               "arrival_ids knob is on) — the replay trace record "
               "sim/replay.py re-drives a journal from",
    "admit": "request admitted into a decode slot (slot, prompt_len, "
             "bucket, tok0; prefixed admissions add prefix_len/shared)",
    "sync_window_open": "decode sync window dispatched (steps, active rows)",
    "sync_window_close": "decode sync window drained (steps, rows done, "
                         "duration_ms)",
    "eos": "row finished decoding (reason: eos | budget; n_tokens)",
    "preempt": "row preempted mid-decode by pool exhaustion (blocks "
               "returned); the scheduler resubmits it",
    "evict": "row evicted mid-decode (deadline expiry / caller gone)",
    "block_grow": "row's block table grown ahead of a sync window "
                  "(blocks added, total mapped)",
    "reset": "engine device state rebuilt after a failed step/insert "
             "(every in-flight slot wiped)",
    "resubmit": "in-flight request re-queued after a reset, preemption, or "
                "warm restart (outcome: resubmitted | preempt_resume | "
                "gave_up | restored; n_emitted tokens carried over)",
    "complete": "request delivered (n_tokens, stream_fnv — FNV-1a over "
                "the emitted token stream, the byte-consistency anchor)",
    "token_emit": "a row's emitted-token delta journaled at a sync-window "
                  "drain while the flight WAL is on (toks — the tokens "
                  "appended since the row's last watermark); concatenating "
                  "a request's token_emit events in seq order rebuilds its "
                  "full emitted stream, the state a warm restart resumes "
                  "from",
    "spec_draft": "a speculative sync window drafted continuations by "
                  "prompt-lookup over each row's history (rows drafting, "
                  "active rows, drafted tokens total)",
    "spec_verify": "a multi-token verify step judged its window's drafts "
                   "(drafted, accepted, rejected, emitted token counts — "
                   "accepted/drafted is the window's acceptance rate)",
    "goodput_window": "one device sync window's goodput attribution "
                      "(obs/goodput.py): kind, dur_ms, active requests, "
                      "per-category chip-ms (summing to dur_ms — the "
                      "conservation invariant), tokens, per-window "
                      "mfu/bw/bound — flightview --goodput rebuilds the "
                      "/debug/goodput report from these offline",
    "window_budget": "a unified ragged sync window split its token budget "
                     "(budget, decode_lanes, chunk_tokens scheduled, "
                     "chunks, queued admissions still pending)",
    "prefill_chunk_sched": "the window planner scheduled one admission's "
                           "prefill chunk (offset into the prompt, tokens "
                           "fed, remaining after, final=1 samples tok0)",
    # -- KV block pool (engine/kv_pool.py) -------------------------------
    "pool_alloc": "physical KV blocks taken from the pool (blocks, free "
                  "remaining)",
    "pool_free": "physical KV blocks returned to the pool (blocks, free)",
    "pool_exhausted": "an allocation the pool could not serve (requested, "
                      "free) — backpressure, not failure",
    # -- prefix cache + tiering (engine/prefix_cache.py, engine/tiering.py)
    "prefix_hit": "segment KV served from the prefix cache (segments, "
                  "tokens; memo=1 when the whole assembled chain hit)",
    "prefix_miss": "segment KV built fresh on the resolve path (segments, "
                   "tokens prefilled)",
    "retier": "a tier-maintenance sweep moved entries between hotness "
              "tiers (moved)",
    "swap_in": "cold-tier chunk KV swapped host→HBM (trigger: lookahead — "
               "prefetched off the critical path; demand — on a serving "
               "tail)",
    "swap_in_fallback": "a failed swap-in fell back to "
                        "recompute-from-tokens (host buffer released)",
    "chunk_splice": "a hot chunk's canonical KV spliced at an arbitrary "
                    "prompt position (chunk-granular reuse; tokens, delta; "
                    "pool=1 when assembled straight into pool blocks)",
    "rerotate": "cached K planes position-shifted by the closed-form RoPE "
                "delta rotation (tokens, delta) — no re-prefill",
    "boundary_fixup": "a spliced chunk's first tokens re-prefilled with "
                      "the true left context (tokens) — the bounded "
                      "boundary-correction pass",
    "host_spill_evict": "the host spill store's byte budget evicted a "
                        "cold chunk's backing (bytes)",
    # -- retrieval lookahead (rag/lookahead.py) --------------------------
    "lookahead_launch": "retrieval launched ahead of need (trigger: "
                        "admission | session)",
    "lookahead_join": "serving tail joined its retrieval (outcome: hit | "
                      "late | miss)",
    "lookahead_waste": "a lookahead retrieval died unconsumed (reason: "
                       "superseded | expired | abandoned | stale | failed)",
    "prestage": "a resolved retrieval's chunk KV pre-staged ahead of "
                "admission (prefix-cache entries / pool registration)",
    # -- shadow quality auditor (obs/shadow.py) --------------------------
    "shadow_audit": "one sampled request's shadow audit finished (outcome: "
                    "clean | diverged | skipped | failed; n tokens "
                    "compared, err — the minimal explaining logit "
                    "perturbation, pos — first divergence, approx — the "
                    "request's approximation fingerprint, reason on "
                    "skips). flightview --quality rebuilds the "
                    "/debug/quality report from these offline",
    "quality_divergence": "a shadow audit caught the delivered stream "
                          "diverging from the exact path (pos, err, "
                          "approx — the approximations the divergence is "
                          "attributed to); a second one inside the burst "
                          "window spools an incident bundle",
    # -- disaggregated pools + router (engine/continuous.py,
    #    server/router.py) --------------------------------------------------
    "route_decision": "the front-tier router picked replicas for a request "
                      "(prefill/decode targets, mode: disagg | unified, "
                      "affinity score and affinity_hit, candidates "
                      "considered) — flightview --router aggregates these "
                      "into the affinity hit rate",
    "migrate_begin": "a prefill-role engine exported a request's pool "
                     "blocks for hand-off to a decode-role engine (blocks, "
                     "kv_len; every exported block is released on the "
                     "prefill side before the event returns)",
    "migrate_done": "a decode-role engine imported a migrated request into "
                    "a fresh row (slot, blocks, kv_len) — decode continues "
                    "the same (seed, position) sampling sequence, so the "
                    "stream is byte-identical to a unified run",
    # -- resilience (resilience/) ----------------------------------------
    "shed": "request rejected at the admission gate (reason, status)",
    "deadline": "a request's end-to-end deadline expired (stage)",
    "breaker_open": "the engine-reset circuit breaker flipped open "
                    "(resets in window) — readiness goes 503",
    "drain": "the lifecycle coordinator changed drain phase (phase: begin "
             "| timeout | complete; reason on begin, in_flight counts) — "
             "the graceful-shutdown state machine's journal trail",
    "restore": "a warm restart acted on a prior incarnation's WAL (phase: "
               "resume — one in-flight request resubmitted with orig_rid/"
               "n_emitted; rehydrate — warmth-manifest chunks re-staged; "
               "skip — a request the restart could not resume, with "
               "reason)",
}


def stream_hash(tokens: Iterable[int]) -> int:
    """FNV-1a (64-bit) over a token stream — the content identity a
    ``complete`` event records, so a timeline can be checked against the
    stream the client actually received."""
    h = 0xCBF29CE484222325
    for t in tokens:
        h ^= int(t) & 0xFFFFFFFFFFFFFFFF
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class FlightRecorder:
    """Bounded in-process event journal: a ring of ``(seq, t_monotonic,
    type, request_id, attrs)`` tuples. ``emit`` takes one lock to claim a
    slot; readers copy the ring under the same lock, and events are
    immutable tuples, so a snapshot is always consistent."""

    def __init__(self, capacity: int = 4096, enabled: bool = True, arrival_ids: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity={capacity}: expected >= 1")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        # whether ``arrival`` events carry the prompt token ids
        self.arrival_ids = bool(arrival_ids)
        self._lock = threading.Lock()
        self._buf: List[Optional[tuple]] = [None] * self.capacity
        self._next = 0  # total events ever emitted (seq of the next event)

    def emit(self, etype: str, request_id: Optional[int] = None, **attrs) -> None:
        """Append one event. Unknown event types raise: the catalog is closed."""
        if not self.enabled:
            return
        if etype not in EVENTS:
            raise ValueError(f"unknown flight event {etype!r}; the catalog is flight.EVENTS")
        t = time.monotonic()
        with self._lock:
            seq = self._next
            self._next = seq + 1
            self._buf[seq % self.capacity] = (seq, t, etype, request_id, attrs)

    def snapshot(self, request_id: Optional[int] = None, etype: Optional[str] = None) -> List[Dict]:
        """The surviving events, oldest first, as JSON-ready dicts."""
        with self._lock:
            live = sorted((e for e in self._buf if e is not None), key=lambda e: e[0])
        out = []
        for seq, t, typ, rid, attrs in live:
            if request_id is not None and rid != request_id:
                continue
            if etype is not None and typ != etype:
                continue
            d = {"seq": seq, "t": round(t, 6), "type": typ}
            if rid is not None:
                d["rid"] = rid
            if attrs:
                d.update(attrs)
            out.append(d)
        return out

    def timeline(self, request_id: int) -> Dict:
        """One request's ordered event chain with inter-event deltas, times
        relative to its first surviving event."""
        evs = self.snapshot(request_id=request_id)
        t0 = evs[0]["t"] if evs else 0.0
        prev = t0
        out = []
        for e in evs:
            t = e.pop("t")
            e["t_ms"] = round((t - t0) * 1e3, 3)
            e["dt_ms"] = round((t - prev) * 1e3, 3)
            prev = t
            e.pop("rid", None)  # redundant inside a per-request timeline
            out.append(e)
        return {"schema_version": SCHEMA_VERSION, "request_id": request_id, "events": out}

    @property
    def events_emitted(self) -> int:
        """Events ever emitted (keeps counting past the ring): the source of
        ``rag_flight_events_total``."""
        return self._next

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._next = 0


# the process recorder: engines are built long before any service exists,
# and the journal must see every layer's events in one causal order
_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


def configure(enabled: Optional[bool] = None, capacity: Optional[int] = None,
              arrival_ids: Optional[bool] = None) -> FlightRecorder:
    """Apply settings to the process recorder. A capacity change rebuilds
    the ring (the journal starts fresh); an enabled-only change keeps it."""
    global _RECORDER
    if capacity is not None and int(capacity) != _RECORDER.capacity:
        old = _RECORDER
        _RECORDER = FlightRecorder(
            int(capacity),
            old.enabled if enabled is None else bool(enabled),
            old.arrival_ids if arrival_ids is None else bool(arrival_ids),
        )
    elif enabled is not None:
        _RECORDER.enabled = bool(enabled)
    if arrival_ids is not None:
        _RECORDER.arrival_ids = bool(arrival_ids)
    return _RECORDER


def emit(etype: str, request_id: Optional[int] = None, **attrs) -> None:
    """Append ``etype`` to the process journal (free when disabled)."""
    rec = _RECORDER
    if not rec.enabled:
        return
    rec.emit(etype, request_id, **attrs)


def arrival_ids() -> bool:
    """Whether ``arrival`` events should carry prompt token ids (False when
    the recorder is disabled)."""
    rec = _RECORDER
    return rec.enabled and rec.arrival_ids
