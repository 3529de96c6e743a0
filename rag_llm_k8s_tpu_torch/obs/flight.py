"""Engine flight recorder, the port's copy of ``rag_llm_k8s_tpu/obs/flight.py``.

- :data:`EVENTS` — the CLOSED catalog of typed event names, copied whole
  with :data:`SCHEMA_VERSION`, so a journal from either package reads the
  same. A typo'd event name raises instead of journaling nothing.
- :class:`FlightRecorder` — a fixed-size ring of monotonic-stamped events:
  one append under one small lock, no device work. With a WAL attached
  (``configure(wal=...)``) every event is also appended to it.
- ``timeline(rid)`` — one request's ordered event chain with inter-event
  deltas; events carry the scheduler's request id.
- :func:`stream_hash` — FNV-1a over a token stream, the identity a
  ``complete`` event records of what the client received.
- :class:`FlightWAL` — the durable tee: every event lands on disk as one
  fsynced JSON line in a bounded, segment-rotated journal with one epoch
  per process incarnation. The ring explains a live process; the WAL a
  dead one: a warm restart (``server/app.py`` ``restore_from_wal``) scans
  it (:func:`scan_wal`), finds the requests with an ``arrival`` and no
  terminal event (``sim/replay.py``) and resumes them. Every other file
  this module writes goes through :func:`durable_write` (tmp, fsync,
  rename, directory fsync); :func:`export_journal` and
  :func:`load_journal` write and read a journal bundle.
- :class:`IncidentSpooler` — a bounded on-disk spool of self-contained
  incident bundles (journal, metrics snapshot, config fingerprint, traces),
  written on a closed set of :data:`TRIGGERS` with a per-trigger cooldown;
  :func:`config_fingerprint` gives a bundle its config identity.

The module imports only the standard library.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

__all__ = [
    "EVENTS",
    "SCHEMA_VERSION",
    "FlightRecorder",
    "FlightWAL",
    "IncidentSpooler",
    "TRIGGERS",
    "arrival_ids",
    "config_fingerprint",
    "configure",
    "durable_write",
    "emit",
    "export_journal",
    "load_journal",
    "recorder",
    "scan_wal",
    "stream_hash",
    "wal_enabled",
]

logger = logging.getLogger(__name__)

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
        # the durable tee every emitted event is also appended to (None:
        # the ring only)
        self.wal: Optional["FlightWAL"] = None
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
        wal = self.wal
        if wal is not None:
            wal.append(_as_dict(seq, t, etype, request_id, attrs))

    def snapshot(self, request_id: Optional[int] = None, etype: Optional[str] = None) -> List[Dict]:
        """The surviving events, oldest first, as JSON-ready dicts."""
        with self._lock:
            live = sorted((e for e in self._buf if e is not None), key=lambda e: e[0])
        return [
            _as_dict(*e) for e in live
            if (request_id is None or e[3] == request_id) and (etype is None or e[2] == etype)
        ]

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


def _as_dict(seq: int, t: float, etype: str, request_id: Optional[int], attrs: Dict) -> Dict:
    """One event as the JSON-ready dict a snapshot returns and the WAL
    stores."""
    d = {"seq": seq, "t": round(t, 6), "type": etype}
    if request_id is not None:
        d["rid"] = request_id
    if attrs:
        d.update(attrs)
    return d


# the process recorder: engines are built long before any service exists,
# and the journal must see every layer's events in one causal order
_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


_UNSET = object()


def configure(enabled: Optional[bool] = None, capacity: Optional[int] = None,
              arrival_ids: Optional[bool] = None, wal=_UNSET) -> FlightRecorder:
    """Apply settings to the process recorder. A capacity change rebuilds
    the ring (the journal starts fresh, the WAL tee stays); an enabled-only
    change keeps it. ``wal`` attaches (a :class:`FlightWAL`) or detaches
    (None) the durable tee; omitted, the current tee stays."""
    global _RECORDER
    if capacity is not None and int(capacity) != _RECORDER.capacity:
        old = _RECORDER
        _RECORDER = FlightRecorder(
            int(capacity),
            old.enabled if enabled is None else bool(enabled),
            old.arrival_ids if arrival_ids is None else bool(arrival_ids),
        )
        _RECORDER.wal = old.wal
    elif enabled is not None:
        _RECORDER.enabled = bool(enabled)
    if arrival_ids is not None:
        _RECORDER.arrival_ids = bool(arrival_ids)
    if wal is not _UNSET:
        _RECORDER.wal = wal
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


def wal_enabled() -> bool:
    """Whether emitted events reach a durable WAL: the gate of the
    continuous engine's per-window ``token_emit`` journaling, so that extra
    emit (and its fsync) costs nothing without a WAL."""
    rec = _RECORDER
    return rec.enabled and rec.wal is not None


# ---------------------------------------------------------------------------
# journal export / ingest
# ---------------------------------------------------------------------------


def export_journal(path: str, events: Optional[List[Dict]] = None, meta: Optional[Dict] = None) -> Dict:
    """Write the process journal (or ``events``) as a JSON bundle
    ``{"schema_version", "journal", ...meta}`` through :func:`durable_write`;
    returns the bundle."""
    bundle: Dict = {
        "schema_version": SCHEMA_VERSION,
        "journal": _RECORDER.snapshot() if events is None else list(events),
    }
    for k, v in (meta or {}).items():
        bundle.setdefault(k, v)
    durable_write(path, bundle)
    return bundle


def load_journal(path: str) -> List[Dict]:
    """Read a journal written by :func:`export_journal` (or a bare event
    list) back to its events. A newer schema loads with a warning: the
    replay parser (``sim/replay.py``) skips event types it does not know."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):
        return doc
    ver = doc.get("schema_version")
    if ver is not None and int(ver) > SCHEMA_VERSION:
        logger.warning(
            "journal %s has schema_version %s (this build knows %s); unknown event types will be skipped",
            path, ver, SCHEMA_VERSION,
        )
    journal = doc.get("journal")
    if not isinstance(journal, list):
        raise ValueError(f"{path}: no 'journal' event list in bundle")
    return journal


# ---------------------------------------------------------------------------
# durable writes + the flight WAL
# ---------------------------------------------------------------------------


def _plain(o):
    """JSON for the array scalars and arrays an event may carry (token ids
    from a tokenizer's numpy output): their Python values."""
    if hasattr(o, "tolist"):
        return o.tolist()
    raise TypeError(f"Object of type {type(o).__name__} is not JSON serializable")


def durable_write(path: str, obj: Dict) -> None:
    """The crash-consistent JSON write: tmp file, flush, fsync,
    ``os.replace``, then an fsync of the directory, so a reader sees the old
    content or the new, never a torn or empty file, even across SIGKILL or
    power loss."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, separators=(",", ":"), default=_plain)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    # without the directory's fsync the data is durable but its name may not be
    dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


class FlightWAL:
    """Bounded, segment-rotated write-ahead journal of flight events, one
    JSON line per event, fsynced per append, under
    ``dir/wal_<epoch>_<seg>.jsonl``:

    - **epoch**: one per process incarnation, ``max(existing) + 1`` at
      construction, so a restart never appends into a dead incarnation's
      segments and what was in flight when it died stays as it was.
    - **segments**: a new file every ``segment_events`` appends; the oldest
      files past ``max_segments`` (across all epochs) are pruned.
    - **torn tails**: an append killed mid-write leaves a partial last
      line; :func:`scan_wal` skips it, so a SIGKILL costs at most the event
      being written.

    An append takes one lock and one fsync: the durability the warm restart
    rests on. A failed append is logged and counted in ``dropped``; it never
    raises into the serving path."""

    def __init__(self, dir: str, segment_events: int = 256, max_segments: int = 64):
        if segment_events < 1:
            raise ValueError(f"segment_events={segment_events}: expected >= 1")
        if max_segments < 2:
            raise ValueError(f"max_segments={max_segments}: expected >= 2")
        self.dir = dir
        self.segment_events = int(segment_events)
        self.max_segments = int(max_segments)
        os.makedirs(dir, exist_ok=True)
        existing = _wal_segments(dir)
        self.epoch = (max(e for e, _, _ in existing) + 1) if existing else 1
        self._lock = threading.Lock()
        self._seg = 0
        self._file = None
        self._seg_events = 0
        self.appends = 0
        self.dropped = 0
        # seconds spent in fsync, summed (the durability's cost per window)
        self.fsync_s = 0.0

    def append(self, event: Dict) -> None:
        """Durably append one event dict (one JSON line and an fsync)."""
        try:
            with self._lock:
                if self._file is None or self._seg_events >= self.segment_events:
                    self._rotate_locked()
                self._file.write(json.dumps(event, separators=(",", ":"), default=_plain) + "\n")
                self._file.flush()
                t = time.perf_counter()
                os.fsync(self._file.fileno())
                self.fsync_s += time.perf_counter() - t
                self._seg_events += 1
                self.appends += 1
        except Exception:  # noqa: BLE001 — a WAL fault must not break the emitting path
            self.dropped += 1
            logger.warning("flight WAL append failed (dir=%s)", self.dir, exc_info=True)

    def _rotate_locked(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
        self._seg += 1
        path = os.path.join(self.dir, f"wal_{self.epoch:08d}_{self._seg:06d}.jsonl")
        # append mode: "a" never truncates evidence
        self._file = open(path, "a")
        self._seg_events = 0
        self._prune_locked()

    def _prune_locked(self) -> None:
        segs = _wal_segments(self.dir)
        while len(segs) > self.max_segments:
            _, _, name = segs.pop(0)  # oldest: names sort by epoch, then segment
            try:
                os.remove(os.path.join(self.dir, name))
            except OSError:
                pass

    def sync(self) -> None:
        """Flush and fsync the open segment (the drain's persist step)."""
        with self._lock:
            if self._file is not None:
                try:
                    self._file.flush()
                    os.fsync(self._file.fileno())
                except OSError:
                    pass

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


def _wal_segments(dir: str) -> List[tuple]:
    """Sorted ``(epoch, seg, filename)`` of every WAL segment in ``dir``;
    other names are ignored (the directory may be shared)."""
    try:
        names = os.listdir(dir)
    except OSError:
        return []
    out = []
    for n in names:
        if not (n.startswith("wal_") and n.endswith(".jsonl")):
            continue
        parts = n[len("wal_"):-len(".jsonl")].split("_")
        if len(parts) != 2 or not (parts[0].isdigit() and parts[1].isdigit()):
            continue
        out.append((int(parts[0]), int(parts[1]), n))
    out.sort()
    return out


def scan_wal(dir: str) -> Dict[int, List[Dict]]:
    """A WAL directory read back to ``{epoch: [events]}``, each epoch's
    events in seq order. Unparseable lines (the torn tail a SIGKILL leaves)
    and unreadable segments are skipped: a scan never fails a restart."""
    epochs: Dict[int, List[Dict]] = {}
    for epoch, _, name in _wal_segments(dir):
        try:
            with open(os.path.join(dir, name)) as f:
                raw = f.read()
        except OSError:
            continue
        for line in raw.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue  # a torn tail: skip it and keep scanning
            if isinstance(ev, dict):
                epochs.setdefault(epoch, []).append(ev)
    for evs in epochs.values():
        evs.sort(key=lambda e: e.get("seq", 0))
    return epochs


# ---------------------------------------------------------------------------
# incident bundles
# ---------------------------------------------------------------------------


def config_fingerprint(config) -> Dict:
    """A bundle's config identity: the full (dataclass) config rendered to
    plain JSON types plus a stable sha256 digest — enough to tell "same
    incident, different config" from "same config, new incident" without a
    live pod."""
    try:
        raw = dataclasses.asdict(config)
    except TypeError:
        raw = {"repr": repr(config)}

    def _plain(v):
        if isinstance(v, dict):
            return {str(k): _plain(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [_plain(x) for x in v]
        if isinstance(v, (str, int, float, bool)) or v is None:
            return v
        return repr(v)

    plain = _plain(raw)
    digest = hashlib.sha256(
        json.dumps(plain, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()
    return {"sha256": digest, "config": plain}


#: incident triggers the spooler accepts (closed, like the event catalog)
TRIGGERS = (
    "breaker_open", "reset_storm", "pool_exhausted_shed", "deadline_exceeded",
    "quality_divergence", "drain_timeout",
)


class IncidentSpooler:
    """Bounded on-disk spool of self-contained incident bundles.

    ``trigger(name, context_fn)`` writes ``context_fn()`` + trigger
    metadata as one JSON file (through :func:`durable_write`'s
    tmp-fsync-rename — a bundle is never torn) and prunes the oldest
    files past ``max_bundles``. Per-trigger
    cooldown keeps a storm from writing a bundle per reset: the FIRST
    occurrence captures the journal that explains the rest.

    Thread-safe; ``clock`` is injectable so tests exercise the cooldown
    without sleeping.
    """

    def __init__(self, spool_dir: str, max_bundles: int = 16,
                 cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if max_bundles < 1:
            raise ValueError(f"max_bundles={max_bundles}: expected >= 1")
        self.spool_dir = spool_dir
        self.max_bundles = int(max_bundles)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._last: Dict[str, float] = {}  # trigger -> last write (clock)
        self._seq = 0

    # -- write -----------------------------------------------------------
    def trigger(self, name: str, context_fn: Callable[[], Dict]
                ) -> Optional[str]:
        """Spool one bundle for ``name`` unless it fired inside the
        cooldown. Returns the bundle id, or None when suppressed. A write
        failure logs and returns None — incident capture must never take
        the serving path down with it."""
        if name not in TRIGGERS:
            raise ValueError(
                f"unknown incident trigger {name!r}; triggers: {TRIGGERS}"
            )
        now = self.clock()
        with self._lock:
            last = self._last.get(name)
            if last is not None and now - last < self.cooldown_s:
                return None
            self._last[name] = now
            self._seq += 1
            seq = self._seq
        try:
            bundle = dict(context_fn())
            bundle["schema_version"] = SCHEMA_VERSION
            bundle["trigger"] = name
            bundle["ts"] = time.time()
            bid = f"{int(bundle['ts'] * 1e3):013d}_{seq:04d}_{name}"
            bundle["id"] = bid
            os.makedirs(self.spool_dir, exist_ok=True)
            path = os.path.join(self.spool_dir, f"incident_{bid}.json")
            durable_write(path, bundle)
            self._prune()
            return bid
        except Exception:  # noqa: BLE001 — capture must not fail serving
            logger.exception("incident bundle write failed (trigger=%s)", name)
            with self._lock:
                # a FAILED capture must not burn the cooldown: the next
                # trigger retries (only un-stamp our own attempt — a
                # concurrent success keeps its newer stamp)
                if self._last.get(name) == now:
                    del self._last[name]
            return None

    def _prune(self) -> None:
        files = self._files()
        while len(files) > self.max_bundles:
            victim = files.pop(0)  # oldest (ids sort chronologically)
            try:
                os.remove(os.path.join(self.spool_dir, victim))
            except OSError:
                pass

    def _files(self) -> List[str]:
        try:
            names = [
                n for n in os.listdir(self.spool_dir)
                if n.startswith("incident_") and n.endswith(".json")
            ]
        except OSError:
            return []
        return sorted(names)

    # -- read ------------------------------------------------------------
    def list(self) -> List[Dict]:
        """Spooled bundles, oldest first: ``{id, trigger, ts, path}``."""
        out = []
        for n in self._files():
            bid = n[len("incident_"):-len(".json")]
            parts = bid.split("_", 2)
            out.append({
                "id": bid,
                "trigger": parts[2] if len(parts) == 3 else "unknown",
                "ts": int(parts[0]) / 1e3 if parts[0].isdigit() else 0.0,
                "path": os.path.join(self.spool_dir, n),
            })
        return out

    def load(self, bundle_id: str) -> Optional[Dict]:
        """One bundle's full JSON (None when unknown). The id is validated
        against the directory listing — it is never joined into a path
        straight from the request."""
        for entry in self.list():
            if entry["id"] == bundle_id:
                try:
                    with open(entry["path"]) as f:
                        return json.load(f)
                except (OSError, ValueError):
                    return None
        return None
