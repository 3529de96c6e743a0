"""Journal replay, the port's copy of ``rag_llm_k8s_tpu/sim/replay.py``:
parse flight journals, extract traces, diff decision streams, and re-drive a
trace against a live engine deterministically.

Three layers, bottom up:

- **Parsing** (``parse_journal``): seq-orders a journal's events and skips
  event types this build does not know, logged and never raised, so a
  journal from a newer build still replays on its known subset.
  ``extract_trace`` turns a journal's arrivals into a re-drivable trace;
  ``extract_inflight`` lists what a dead incarnation's WAL epoch owes the
  next one (the warm restart), and ``build_restore_report`` what each epoch
  did about it.
- **Decision streams** (``decision_stream`` / ``diff_journals``): a
  journal's projection onto scheduler decisions (admissions, window plans,
  budget splits, preemptions, evictions, EOS, resubmissions, completions)
  with wall-clock measurements stripped, so two runs of one trace compare
  equal exactly when the scheduler decided the same things.
- **The lockstep driver** (``LockstepDriver``): re-drives a trace's
  arrivals against a live engine on one thread, making the decisions
  ``ContinuousScheduler._run_loop`` makes (group admission up to the free
  slots, a step under backpressure, preemption resumes, reset recovery) on
  a step-indexed clock instead of wall time. Record, ``extract_trace``,
  re-drive is a fixed point: the re-driven decision stream equals the
  recording.

The engine is duck-typed: the port's ``ContinuousEngine`` (on the card or
the CPU) for fidelity replay, or ``sim/simulator.py``'s ``SimEngine`` for
host-only what-if runs; both answer ``admission_state``, ``free_slots``,
``admit_many``, ``step``, ``drain_preempted``, ``has_active``, ``slots``,
``reset`` and ``buckets``. Standard library only; the event catalog is the
port's own (``obs/flight.py`` ``EVENTS``).
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from rag_llm_k8s_tpu_torch.obs.flight import EVENTS, stream_hash
from rag_llm_k8s_tpu_torch.sim import policy

logger = logging.getLogger(__name__)

TRACE_SCHEMA_VERSION = 1

#: Journal events that ARE scheduler decisions (vs measurements): the
#: decision-stream projection keeps exactly these, in seq order.
DECISION_EVENTS = (
    "arrival", "admit", "sync_window_open", "sync_window_close",
    "window_budget", "prefill_chunk_sched", "block_grow", "preempt",
    "evict", "eos", "reset", "resubmit", "complete",
    "pool_exhausted",
)

#: Attrs that carry wall-clock measurements, not decisions — stripped
#: before comparison (two identical re-drives never clock alike).
TIMING_ATTRS = frozenset(
    {"seq", "t", "duration_ms", "chip_ms", "cost_usd", "t_ms", "dt_ms"}
)


# ----------------------------------------------------------------------
# parsing (forward-compatible)
# ----------------------------------------------------------------------

def parse_journal(events: Iterable[Dict]) -> Dict:
    """Normalize a raw journal: seq-order its events, drop malformed
    entries and event types outside this build's ``flight.EVENTS`` —
    logged once per unknown type, never raised (a newer recorder's
    journal replays on the known subset). Returns ``{"events": [...],
    "skipped": {type_or_reason: count}}``."""
    known = set(EVENTS)
    out: List[Dict] = []
    skipped: Dict[str, int] = {}
    for e in events:
        if not isinstance(e, dict) or not isinstance(e.get("type"), str):
            skipped["<malformed>"] = skipped.get("<malformed>", 0) + 1
            continue
        t = e["type"]
        if t not in known:
            skipped[t] = skipped.get(t, 0) + 1
            continue
        out.append(e)
    out.sort(key=lambda e: e.get("seq", 0))
    for t, n in skipped.items():
        logger.warning(
            "journal: skipped %d event(s) of unknown type %r — recorded "
            "by a newer schema? replaying the known subset", n, t,
        )
    return {"events": out, "skipped": skipped}


def extract_trace(events: Iterable[Dict]) -> Dict:
    """A journal's request arrivals as a re-drivable trace. Each arrival
    carries what ``LockstepDriver`` needs — rid, prompt (ids when the
    recording kept them, else length), max_new, seed — plus two clocks:
    ``t`` (seconds since the first arrival, for timed load generation)
    and ``t_step`` (scheduler step boundaries that preceded it, the
    lockstep visibility clock), and ``n_out`` (the recorded output
    length, the simulator's generation-length oracle)."""
    parsed = parse_journal(events)["events"]
    arrivals: List[Dict] = []
    out_lens: Dict[int, int] = {}
    steps_before = 0
    t0: Optional[float] = None
    for e in parsed:
        typ = e["type"]
        if typ == "sync_window_open":
            steps_before += 1
        elif typ == "goodput_window" and _is_stall_window(e):
            # a preempt-stall step opened no window but WAS one scheduler
            # step call — the lockstep clock must count it
            steps_before += 1
        elif typ == "reset":
            # a step that died mid-flight (fault, device loss) emitted no
            # window at all, only the reset — but it consumed one step
            # boundary on the lockstep clock. (Caveat: a reset raised at
            # admission time would overcount by one; admission resets are
            # rare and chaos recordings fault the step path.)
            steps_before += 1
        elif typ == "arrival":
            t = float(e.get("t", 0.0))
            if t0 is None:
                t0 = t
            a: Dict = {
                "rid": e.get("rid"),
                "t": round(t - t0, 6),
                "t_step": steps_before,
                "prompt_len": int(e.get("prompt_len", 0)),
                "max_new": int(e.get("max_new", 1)),
            }
            for k in ("seed", "deadline_ms", "ids", "session", "tenant"):
                if k in e:
                    a[k] = e[k]
            arrivals.append(a)
        elif typ == "eos" and e.get("rid") is not None:
            out_lens[e["rid"]] = int(e.get("n_tokens", 0))
        elif typ == "complete" and e.get("rid") is not None:
            out_lens[e["rid"]] = int(e.get("n_tokens", 0))
    for a in arrivals:
        if a["rid"] in out_lens:
            a["n_out"] = out_lens[a["rid"]]
    return {"schema_version": TRACE_SCHEMA_VERSION, "arrivals": arrivals}


#: event types that END a request's lifecycle in a journal — a request
#: whose chain lacks all of them was in flight when the recording stopped
#: (i.e. when the process died, for a WAL epoch)
_TERMINAL_EVENTS = ("complete", "evict")


def extract_inflight(events: Iterable[Dict]) -> Dict:
    """What a dead incarnation's WAL owes the next one: every request
    with an ``arrival`` but no terminal event (``complete``, ``evict``,
    or a gave-up ``resubmit``), each with the prompt the arrival recorded
    (real ids, or the deterministic synthetic filler when the recording
    kept lengths only) and the emitted-token stream rebuilt by
    concatenating its ``token_emit`` deltas in seq order. The warm
    restart (``RagService.restore_from_wal``) resubmits each record through the
    scheduler's fold path; ``synthetic_prompt`` marks records a restart
    should SKIP when byte-exactness matters (a synthetic prompt resumes
    the shape, not the stream)."""
    parsed = parse_journal(events)["events"]
    arrivals: Dict[int, Dict] = {}
    emitted: Dict[int, List[int]] = {}
    terminal: Dict[int, str] = {}
    for e in parsed:
        rid = e.get("rid")
        if rid is None:
            continue
        typ = e["type"]
        if typ == "arrival" and rid not in arrivals:
            arrivals[rid] = e
        elif typ == "token_emit":
            emitted.setdefault(rid, []).extend(
                int(t) for t in e.get("toks", ())
            )
        elif typ in _TERMINAL_EVENTS:
            terminal[rid] = typ
        elif typ == "resubmit" and e.get("outcome") == "gave_up":
            terminal[rid] = "gave_up"
    inflight: List[Dict] = []
    for rid in sorted(arrivals):
        if rid in terminal:
            continue
        a = arrivals[rid]
        rec: Dict = {
            "rid": rid,
            "prompt": _arrival_prompt(a),
            "prompt_len": int(a.get("prompt_len", 0)),
            "max_new": int(a.get("max_new", 1)),
            "emitted": emitted.get(rid, []),
            "synthetic_prompt": not bool(a.get("ids")),
        }
        for k in ("seed", "deadline_ms", "tenant", "session"):
            if k in a:
                rec[k] = a[k]
        inflight.append(rec)
    return {
        "inflight": inflight,
        "arrivals": len(arrivals),
        "terminal": {
            out: sum(1 for v in terminal.values() if v == out)
            for out in sorted(set(terminal.values()))
        },
    }


def build_restore_report(epochs: Dict[int, List[Dict]]) -> Dict:
    """The restore report over a scanned WAL directory (``flight.scan_wal``'s ``{epoch: [events]}``): per epoch,
    what the incarnation did (arrivals/completions/drain trail), what it
    left in flight, and what the NEXT incarnation's restore pass actually
    did about it (resumed / rehydrated / skipped — the ``restore`` and
    ``outcome="restored"`` resubmit events it journaled)."""
    report: Dict = {"epochs": []}
    for epoch in sorted(epochs):
        evs = parse_journal(epochs[epoch])["events"]
        flight_state = extract_inflight(evs)
        drain = [
            {k: v for k, v in e.items() if k in
             ("phase", "reason", "in_flight", "deadline_s", "timed_out")}
            for e in evs if e["type"] == "drain"
        ]
        resumed, rehydrated, skipped = [], [], []
        for e in evs:
            if e["type"] == "restore":
                phase = e.get("phase")
                if phase == "resume":
                    resumed.append({
                        "rid": e.get("rid"),
                        "orig_rid": e.get("orig_rid"),
                        "orig_epoch": e.get("orig_epoch"),
                        "n_emitted": int(e.get("n_emitted", 0)),
                    })
                elif phase == "rehydrate":
                    rehydrated.append({
                        "key": e.get("key"),
                        "tokens": int(e.get("tokens", 0)),
                    })
                elif phase == "skip":
                    skipped.append({
                        "orig_rid": e.get("orig_rid"),
                        "reason": e.get("reason"),
                    })
        completes = sum(1 for e in evs if e["type"] == "complete")
        report["epochs"].append({
            "epoch": epoch,
            "events": len(evs),
            "arrivals": flight_state["arrivals"],
            "completes": completes,
            "inflight_at_end": [
                {"rid": r["rid"], "prompt_len": r["prompt_len"],
                 "n_emitted": len(r["emitted"]),
                 "synthetic_prompt": r["synthetic_prompt"]}
                for r in flight_state["inflight"]
            ],
            "drain": drain,
            "restored": resumed,
            "rehydrated": rehydrated,
            "skipped": skipped,
        })
    return report


def _is_stall_window(e: Dict) -> bool:
    """A ``goodput_window`` whose whole duration is preempt churn (the
    ledger's ``record_preempt_stall``): a scheduler step that opened no
    sync window — still one step boundary on the lockstep clock."""
    return "preempt_rework" in e and not any(
        k in e for k in
        ("decode_useful", "prefill_compute", "padding_bubble",
         "spec_rejected", "prefill_skipped")
    )


# ----------------------------------------------------------------------
# decision streams + diffing
# ----------------------------------------------------------------------

def decision_stream(events: Iterable[Dict]) -> List[Dict]:
    """The journal's decisions, normalized for comparison: only
    ``DECISION_EVENTS``, timing attrs stripped, seq order kept."""
    parsed = parse_journal(events)["events"]
    keep = set(DECISION_EVENTS)
    return [
        {k: v for k, v in e.items() if k not in TIMING_ATTRS}
        for e in parsed if e["type"] in keep
    ]


def request_chains(events: Iterable[Dict]) -> Dict[int, List[Dict]]:
    """Per-request decision chains: the rid-keyed subset of the decision
    stream. Window-plan events carry no rid and are excluded — this is
    the projection that stays exact even for journals recorded by the
    THREADED scheduler, whose window interleaving is timing-dependent
    while every per-request decision is not."""
    chains: Dict[int, List[Dict]] = {}
    for d in decision_stream(events):
        rid = d.get("rid")
        if rid is not None:
            chains.setdefault(rid, []).append(d)
    return chains


def first_divergence(
    a: Sequence[Dict], b: Sequence[Dict]
) -> Optional[Tuple[int, Optional[Dict], Optional[Dict]]]:
    """Index + both sides of the first differing decision (None when the
    streams are identical; a pure length mismatch diverges at the end of
    the shorter stream with the missing side None)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x, y
    if len(a) != len(b):
        i = min(len(a), len(b))
        return i, (a[i] if i < len(a) else None), (b[i] if i < len(b) else None)
    return None


def _occupancy(events: Sequence[Dict]) -> Dict:
    """Mean active rows / steps per sync window — the occupancy shape a
    replay or simulation must land near even when exact interleaving
    cannot be compared."""
    opens = [e for e in events if e.get("type") == "sync_window_open"]
    n = len(opens)
    return {
        "windows": n,
        "mean_active": round(
            sum(int(e.get("active", 0)) for e in opens) / n, 4
        ) if n else 0.0,
        "mean_steps": round(
            sum(int(e.get("steps", 1)) for e in opens) / n, 4
        ) if n else 0.0,
    }


def diff_journals(events_a: Iterable[Dict], events_b: Iterable[Dict]) -> Dict:
    """Event-by-event comparison of two journals' decision streams (live
    vs replayed/simulated): identical flag, the first divergent decision,
    per-event-type count deltas, and occupancy deltas."""
    ea = parse_journal(events_a)["events"]
    eb = parse_journal(events_b)["events"]
    sa, sb = decision_stream(ea), decision_stream(eb)
    div = first_divergence(sa, sb)
    counts: Dict[str, List[int]] = {}
    for side, evs in ((0, ea), (1, eb)):
        for e in evs:
            counts.setdefault(e["type"], [0, 0])[side] += 1
    occ_a, occ_b = _occupancy(ea), _occupancy(eb)
    chains_a, chains_b = request_chains(ea), request_chains(eb)
    rid_div = sorted(
        rid for rid in set(chains_a) | set(chains_b)
        if chains_a.get(rid) != chains_b.get(rid)
    )
    return {
        "identical": div is None,
        "decisions": [len(sa), len(sb)],
        "first_divergence": None if div is None else {
            "index": div[0], "a": div[1], "b": div[2],
        },
        "event_counts": {
            t: {"a": c[0], "b": c[1], "delta": c[1] - c[0]}
            for t, c in sorted(counts.items())
        },
        "occupancy": {
            "a": occ_a, "b": occ_b,
            "mean_active_delta": round(
                occ_b["mean_active"] - occ_a["mean_active"], 4
            ),
        },
        "requests_diverged": rid_div,
        "requests_identical": div is None or not rid_div,
    }


# ----------------------------------------------------------------------
# the lockstep driver
# ----------------------------------------------------------------------

class _Req:
    """Driver-side mirror of the scheduler's ``_Pending`` (no threading
    — lockstep has no other thread to signal)."""

    __slots__ = ("rid", "prompt", "max_new", "seed", "emitted",
                 "retries_left", "retried", "resumed", "tenant")

    def __init__(self, rid, prompt, max_new, seed, retries_left,
                 tenant=None):
        self.rid = rid
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.seed = seed
        self.emitted: List[int] = []
        self.retries_left = int(retries_left)
        self.retried = False
        self.resumed = False
        self.tenant = tenant


def _arrival_prompt(a: Dict) -> List[int]:
    """An arrival's prompt: the recorded ids when the journal kept them,
    else a deterministic synthetic filler of the recorded length (shape-
    faithful replay: every scheduling decision depends on lengths, only
    token streams need the real ids)."""
    ids = a.get("ids")
    if ids:
        return [int(x) for x in ids]
    n = max(1, int(a.get("prompt_len", 1)))
    rid = int(a.get("rid") or 0)
    return [(7 + ((rid * 131 + i * 31) % 97)) for i in range(n)]


class LockstepDriver:
    """Deterministic single-threaded re-drive of a trace against a live
    (duck-typed) engine — the scheduler's decision loop on a step-indexed
    clock. ``emit`` receives the scheduler-level events the threaded
    scheduler would journal (``arrival``/``resubmit``/``complete``);
    engine-level events flow from the engine itself. Pass the package's
    ``flight.emit`` to record, a collector to capture, or nothing to
    discard."""

    def __init__(
        self,
        engine,
        emit: Optional[Callable] = None,
        retries: int = 1,
        arrival_ids: bool = True,
    ):
        self.engine = engine
        self.emit = emit if emit is not None else (lambda *a, **k: None)
        self.retries = max(0, int(retries))
        self.arrival_ids = bool(arrival_ids)
        self.steps_done = 0
        self.results: Dict[int, List[int]] = {}
        self.errors: Dict[int, BaseException] = {}
        self._queue: deque = deque()

    # -- driving -------------------------------------------------------
    def drive(self, trace) -> Dict[int, List[int]]:
        """Re-drive every arrival to completion; returns rid → emitted
        tokens (failures land in ``self.errors`` instead). Deadlines in
        the trace are ignored — lockstep has no wall clock to expire
        them against (timed load generation goes through the real
        threaded scheduler instead)."""
        arrivals = trace["arrivals"] if isinstance(trace, dict) else list(trace)
        pending = deque(
            sorted(arrivals, key=lambda a: int(a.get("t_step", 0)))
        )
        waiting: Dict[int, _Req] = {}
        eng = self.engine

        def make_visible():
            while pending and int(pending[0].get("t_step", 0)) <= self.steps_done:
                a = pending.popleft()
                req = _Req(
                    a.get("rid"), _arrival_prompt(a),
                    a.get("max_new", 1), a.get("seed"), self.retries,
                    tenant=a.get("tenant"),
                )
                arr = {"prompt_len": len(req.prompt), "max_new": req.max_new}
                if req.seed is not None:
                    arr["seed"] = req.seed
                if "deadline_ms" in a:
                    arr["deadline_ms"] = a["deadline_ms"]
                if req.tenant is not None:
                    # forward the trace's tenant into the live submit: the
                    # re-driven journal prices per tenant exactly like the
                    # recording (and the engine's ledger rolls it up)
                    arr["tenant"] = req.tenant
                    ledger = getattr(eng, "ledger", None)
                    note = getattr(ledger, "note_tenant", None)
                    if note is not None:
                        note(req.rid, req.tenant)
                if self.arrival_ids:
                    arr["ids"] = list(req.prompt)
                self.emit("arrival", req.rid, **arr)
                self._queue.append(req)

        while True:
            make_visible()
            if not self._queue:
                if waiting or eng.has_active():
                    self._step(waiting)
                    continue
                if pending:
                    # idle: jump the clock to the next arrival
                    self.steps_done = int(pending[0].get("t_step", 0))
                    continue
                break
            item = self._queue.popleft()
            while item is not None:
                state = eng.admission_state(len(item.prompt))
                if state == "never":
                    self.errors[item.rid] = RuntimeError(
                        f"pool cannot hold request {item.rid}'s prompt "
                        f"({len(item.prompt)} tokens)"
                    )
                    item = self._queue.popleft() if self._queue else None
                    continue
                if state == "wait":
                    self._step(waiting)
                    make_visible()
                    continue
                free = eng.free_slots()
                if not free:
                    self._step(waiting)
                    make_visible()
                    continue
                batch = [item]
                while len(batch) < len(free) and self._queue:
                    batch.append(self._queue.popleft())
                self._admit(batch, waiting)
                item = self._queue.popleft() if self._queue else None
            if waiting or eng.has_active():
                self._step(waiting)
        return self.results

    # -- internals -----------------------------------------------------
    def _admit(self, batch: List[_Req], waiting: Dict[int, _Req]) -> None:
        eng = self.engine
        try:
            admitted = eng.admit_many(
                [(b.rid, b.prompt, b.max_new, b.seed) for b in batch]
            )
        except BaseException as e:  # noqa: BLE001 — duck-typed engines
            if type(e).__name__ == "EngineStateLost":
                self._handle_reset(e, waiting, extra=batch, emitted={})
                return
            for b in batch:
                self.errors[b.rid] = e
            return
        for b, res in zip(batch, admitted):
            if isinstance(res, BaseException):
                if type(res).__name__ == "PoolExhausted":
                    # the chunk raced the pool: requeue (backpressure)
                    self._queue.append(b)
                else:
                    self.errors[b.rid] = res
                continue
            _, finished = res
            if finished is not None:
                self._deliver(b, finished)
            else:
                waiting[b.rid] = b

    def _step(self, waiting: Dict[int, _Req]) -> None:
        eng = self.engine
        try:
            done = eng.step()
        except BaseException as e:  # noqa: BLE001 — mirror _safe_step
            emitted = {
                s.request_id: list(s.tokens) for s in eng.slots if s.active
            }
            try:
                eng.reset()
            except BaseException:  # noqa: BLE001
                logger.exception("engine reset failed after step failure")
            self._handle_reset(e, waiting, extra=[], emitted=emitted)
            self.steps_done += 1
            return
        self.steps_done += 1
        for rid, tokens in done:
            it = waiting.pop(rid, None)
            if it is not None:
                self._deliver(it, tokens)
        # pool-preemption resume (scheduled backpressure, burns no retry)
        for rid, toks in eng.drain_preempted():
            it = waiting.pop(rid, None)
            if it is None:
                continue
            self._fold(it, toks)
            it.resumed = True
            mark = getattr(eng, "mark_rework", None)
            if mark:
                mark(rid)
            self.emit("resubmit", rid, outcome="preempt_resume",
                      n_emitted=len(toks))
            self._queue.append(it)

    def _fold(self, it: _Req, toks: List[int]) -> None:
        if policy.resume_fits(len(it.prompt), len(toks),
                              max(self.engine.buckets)):
            it.emitted.extend(toks)
            it.prompt = list(it.prompt) + toks
            it.max_new = max(1, it.max_new - len(toks))

    def _handle_reset(self, cause, waiting, extra, emitted) -> None:
        items = list(waiting.values()) + list(extra)
        waiting.clear()
        retry = []
        for it in items:
            if it.retries_left > 0:
                retry.append(it)
            else:
                self.emit("resubmit", it.rid, outcome="gave_up")
                disc = getattr(self.engine, "discard_request_goodput", None)
                if disc:
                    disc(it.rid)
                self.errors[it.rid] = cause
        for it in retry:
            toks = emitted.get(it.rid, [])
            self._fold(it, toks)
            it.retries_left -= 1
            it.retried = True
            mark = getattr(self.engine, "mark_rework", None)
            if mark:
                mark(it.rid)
            self.emit("resubmit", it.rid, outcome="resubmitted",
                      n_emitted=len(toks))
            self._queue.append(it)

    def _deliver(self, it: _Req, tokens: List[int]) -> None:
        result = it.emitted + list(tokens)
        self.results[it.rid] = result
        eng = self.engine
        pop_blocks = getattr(eng, "pop_blocks_allocated", None)
        if pop_blocks:
            pop_blocks(it.rid)
        extra = {}
        pop_gp = getattr(eng, "pop_request_goodput", None)
        gp = pop_gp(it.rid) if pop_gp else None
        if gp is not None:
            extra["chip_ms"] = gp["chip_ms"]
            if "cost_usd" in gp:
                extra["cost_usd"] = round(gp["cost_usd"], 8)
        pop_spec = getattr(eng, "pop_spec_seen", None)
        if pop_spec:
            pop_spec(it.rid)
        if it.tenant is not None:
            extra["tenant"] = it.tenant
        self.emit(
            "complete", it.rid, n_tokens=len(result),
            stream_fnv=stream_hash(result), **extra,
        )


def replay_journal(
    engine,
    events: Iterable[Dict],
    emit: Optional[Callable] = None,
    retries: int = 1,
) -> Dict:
    """Convenience fidelity check: extract the trace from ``events``,
    re-drive it on ``engine``, and return ``{"trace", "results",
    "errors", "driver"}`` — the caller diffs the engine's fresh journal
    against the recording with ``diff_journals``."""
    trace = extract_trace(events)
    drv = LockstepDriver(engine, emit=emit, retries=retries)
    results = drv.drive(trace)
    return {
        "trace": trace, "results": results,
        "errors": drv.errors, "driver": drv,
    }
