"""Per-tenant attribution report, the port's copy of
``rag_llm_k8s_tpu/obs/tenants.py``: one renderer for a live journal and a
saved one.

``GET /debug/tenants`` folds the flight recorder's live snapshot through
:func:`state_from_events` + :func:`render_report`; a journal exported to
disk folds through the same two functions, so both render identical
reports over the same events. The module imports only the standard
library and nothing else of the package.

Attribution sources, all free-form attrs on events already in the closed
flight catalog:

- ``arrival.tenant`` — the edge-interned tenant (K tracked names +
  ``__other__``; default ``anon``). Also seeds a rid→tenant map so
  events that only carry ``rid`` (``admit``) attribute correctly.
- ``complete.tenant`` / ``.n_tokens`` / ``.chip_ms`` / ``.cost_usd`` —
  tokens, chip-seconds, and cost per tenant (the goodput ledger's
  per-request attribution, one dimension finer).
- ``shed.tenant`` — admission rejections per tenant (the signal a
  fair-share gate acts on).
- ``shadow_audit.tenant`` / ``.outcome`` — quality audits and divergence
  per tenant.

Events with no tenant anywhere fold into ``anon`` — a pre-tenant journal
renders as one honest unattributed row instead of failing.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

__all__ = [
    "SCHEMA_VERSION",
    "OTHER",
    "new_state",
    "record",
    "state_from_events",
    "render_report",
]

SCHEMA_VERSION = 1
#: the tracker's overflow bucket (mirrors metrics.TenantTracker.OTHER —
#: restated here because this module may not import it)
OTHER = "__other__"
#: tenant of record for events carrying no tenant anywhere
DEFAULT_TENANT = "anon"

#: event types this report consumes (everything else only advances the
#: wall-clock span)
_CONSUMED = ("arrival", "admit", "complete", "shed", "shadow_audit")


def _row() -> Dict[str, float]:
    return {
        "arrivals": 0,
        "admitted": 0,
        "completed": 0,
        "sheds": 0,
        "tokens": 0,
        "chip_s": 0.0,
        "cost_usd": 0.0,
        "audits": 0,
        "diverged": 0,
    }


def new_state() -> Dict[str, object]:
    return {
        "schema_version": SCHEMA_VERSION,
        "tenants": {},
        "events": 0,
        "t_first": None,
        "t_last": None,
        "_rids": {},
    }


def record(state: Dict[str, object], ev: Dict[str, object]) -> None:
    """Fold one flight event (live snapshot dict or journal line) into
    ``state``. Order-sensitive only through the rid→tenant map, which both
    renderers see in the same (seq) order."""
    state["events"] = int(state.get("events", 0)) + 1
    t = ev.get("t")
    if isinstance(t, (int, float)):
        if state["t_first"] is None or t < state["t_first"]:
            state["t_first"] = t
        if state["t_last"] is None or t > state["t_last"]:
            state["t_last"] = t
    et = ev.get("type")
    if et not in _CONSUMED:
        return
    tenants: Dict[str, Dict[str, float]] = state["tenants"]  # type: ignore[assignment]
    rids: Dict[object, str] = state.setdefault("_rids", {})  # type: ignore[assignment]
    tenant = ev.get("tenant")
    rid = ev.get("rid")
    if et == "arrival":
        tenant = str(tenant) if tenant is not None else DEFAULT_TENANT
        if rid is not None:
            rids[rid] = tenant
    else:
        if tenant is None and rid is not None:
            tenant = rids.get(rid)
        tenant = str(tenant) if tenant is not None else DEFAULT_TENANT
    row = tenants.get(tenant)
    if row is None:
        row = tenants[tenant] = _row()
    if et == "arrival":
        row["arrivals"] += 1
    elif et == "admit":
        row["admitted"] += 1
    elif et == "complete":
        row["completed"] += 1
        n = ev.get("n_tokens")
        if isinstance(n, (int, float)):
            row["tokens"] += int(n)
        chip_ms = ev.get("chip_ms")
        if isinstance(chip_ms, (int, float)):
            row["chip_s"] += float(chip_ms) / 1e3
        cost = ev.get("cost_usd")
        if isinstance(cost, (int, float)):
            row["cost_usd"] += float(cost)
    elif et == "shed":
        row["sheds"] += 1
    else:  # shadow_audit
        row["audits"] += 1
        if ev.get("outcome") == "diverged":
            row["diverged"] += 1


def state_from_events(events: Iterable[Dict[str, object]]) -> Dict[str, object]:
    state = new_state()
    for ev in events:
        record(state, ev)
    return state


def render_report(
    state: Dict[str, object], chip_hour_usd: float = 0.0
) -> Dict[str, object]:
    """The report both surfaces serve: rows sorted by chip-seconds
    descending (name-tiebroken — determinism is what makes byte-identity
    testable), shares of the attributed total, and a totals row. When the
    journal predates pricing (no ``cost_usd`` on completes) but the caller
    knows the chip rate, cost is derived from chip-seconds."""
    tenants: Dict[str, Dict[str, float]] = state.get("tenants", {})  # type: ignore[assignment]
    total_chip = sum(r["chip_s"] for r in tenants.values())
    rows: List[Dict[str, object]] = []
    totals = _row()
    for name in sorted(tenants, key=lambda n: (-tenants[n]["chip_s"], n)):
        r = tenants[name]
        cost = r["cost_usd"]
        if not cost and chip_hour_usd:
            cost = r["chip_s"] / 3600.0 * float(chip_hour_usd)
        for k in totals:
            totals[k] += r[k]
        totals["cost_usd"] += cost - r["cost_usd"]  # count the derived form
        rows.append({
            "tenant": name,
            "arrivals": int(r["arrivals"]),
            "admitted": int(r["admitted"]),
            "completed": int(r["completed"]),
            "sheds": int(r["sheds"]),
            "tokens": int(r["tokens"]),
            "chip_s": round(r["chip_s"], 6),
            "chip_share": round(r["chip_s"] / total_chip, 4) if total_chip else 0.0,
            "cost_usd": round(cost, 6),
            "tokens_per_chip_s": (
                round(r["tokens"] / r["chip_s"], 2) if r["chip_s"] else 0.0
            ),
            "audits": int(r["audits"]),
            "diverged": int(r["diverged"]),
        })
    t0, t1 = state.get("t_first"), state.get("t_last")
    wall_s = round(float(t1) - float(t0), 3) if (
        isinstance(t0, (int, float)) and isinstance(t1, (int, float))
    ) else 0.0
    return {
        "schema_version": SCHEMA_VERSION,
        "wall_s": wall_s,
        "events": int(state.get("events", 0)),
        "tenants": rows,
        "totals": {
            "tenants": len(rows),
            "arrivals": int(totals["arrivals"]),
            "admitted": int(totals["admitted"]),
            "completed": int(totals["completed"]),
            "sheds": int(totals["sheds"]),
            "tokens": int(totals["tokens"]),
            "chip_s": round(totals["chip_s"], 6),
            "cost_usd": round(totals["cost_usd"], 6),
            "audits": int(totals["audits"]),
            "diverged": int(totals["diverged"]),
        },
    }
