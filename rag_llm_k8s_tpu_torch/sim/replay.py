"""Journal parsing and the warm restart's record of a dead incarnation, the
port's copy of the parts of ``rag_llm_k8s_tpu/sim/replay.py`` that a warm
restart runs:

- ``parse_journal`` seq-orders a journal's events and skips event types
  this build does not know (logged, never raised), so a journal from a
  newer build still reads on its known subset;
- ``extract_inflight`` lists what a dead incarnation's WAL epoch owes the
  next one: every request with an ``arrival`` and no terminal event, with
  its prompt and the emitted tokens its ``token_emit`` events prove.

The rest of the JAX module (``extract_trace``, the decision-stream diff,
``build_restore_report`` and the lockstep re-drive) is ``ROADMAP.md``
Queue 1 item 9c. Standard library only, and the event catalog is the
port's own (``obs/flight.py`` ``EVENTS``).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List

from rag_llm_k8s_tpu_torch.obs.flight import EVENTS

logger = logging.getLogger(__name__)

#: event types that end a request's lifecycle in a journal; a request whose
#: chain has none of them (nor a gave-up ``resubmit``) was in flight when
#: the recording stopped, that is when the process died, for a WAL epoch
_TERMINAL_EVENTS = ("complete", "evict")


def parse_journal(events: Iterable[Dict]) -> Dict:
    """A raw journal normalized: seq-ordered, malformed entries and event
    types outside ``flight.EVENTS`` dropped (logged once per type). Returns
    ``{"events": [...], "skipped": {type_or_reason: count}}``."""
    out: List[Dict] = []
    skipped: Dict[str, int] = {}
    for e in events:
        if not isinstance(e, dict) or not isinstance(e.get("type"), str):
            skipped["<malformed>"] = skipped.get("<malformed>", 0) + 1
            continue
        if e["type"] not in EVENTS:
            skipped[e["type"]] = skipped.get(e["type"], 0) + 1
            continue
        out.append(e)
    out.sort(key=lambda e: e.get("seq", 0))
    for t, n in skipped.items():
        logger.warning(
            "journal: skipped %d event(s) of unknown type %r — recorded by a newer schema? "
            "replaying the known subset", n, t,
        )
    return {"events": out, "skipped": skipped}


def _arrival_prompt(a: Dict) -> List[int]:
    """An arrival's prompt: the recorded ids when the journal kept them,
    else a deterministic synthetic filler of the recorded length (the shape
    of the request, not its stream)."""
    ids = a.get("ids")
    if ids:
        return [int(x) for x in ids]
    n = max(1, int(a.get("prompt_len", 1)))
    rid = int(a.get("rid") or 0)
    return [(7 + ((rid * 131 + i * 31) % 97)) for i in range(n)]


def extract_inflight(events: Iterable[Dict]) -> Dict:
    """What a dead incarnation's WAL owes the next one: every request with
    an ``arrival`` and no terminal event (``complete``, ``evict``, or a
    gave-up ``resubmit``), with the prompt its arrival recorded (the ids,
    or the synthetic filler when the recording kept lengths only) and its
    emitted stream, its ``token_emit`` deltas concatenated in seq order.
    ``synthetic_prompt`` marks the records a restart skips: a filler prompt
    resumes the shape, not the stream."""
    arrivals: Dict[int, Dict] = {}
    emitted: Dict[int, List[int]] = {}
    terminal: Dict[int, str] = {}
    for e in parse_journal(events)["events"]:
        rid = e.get("rid")
        if rid is None:
            continue
        typ = e["type"]
        if typ == "arrival" and rid not in arrivals:
            arrivals[rid] = e
        elif typ == "token_emit":
            emitted.setdefault(rid, []).extend(int(t) for t in e.get("toks", ()))
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
        "terminal": {out: sum(1 for v in terminal.values() if v == out) for out in sorted(set(terminal.values()))},
    }
