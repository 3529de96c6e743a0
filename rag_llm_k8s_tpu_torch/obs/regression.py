"""Bench regression gate, the port's copy of
``rag_llm_k8s_tpu/obs/regression.py``: direction-aware metric comparison.

A benchmark emits one JSON document of headline metrics; this module
compares a fresh one against a baseline with per-metric tolerance bands
and **direction awareness** — latency going up is a regression, tokens/sec
going down is a regression, and a metric moving the GOOD way is never
flagged no matter how far it moves.

Metric classification is by key pattern over the FLATTENED document (nested
dicts join with '.'), ordered first-match-wins:

- higher-is-better: throughputs (``tok_per_s``, ``qps``, ``chunks_per_s``,
  ``steps_per_s``), efficiency ratios (``mfu``, ``vs_baseline``,
  ``tokens_per_verify``, ``prefix_prefill_reduction``);
- lower-is-better: durations (``*_ms``, ``*_s``, ``*_seconds``) and byte
  sizes (``snapshot_bytes``);
- ignored: counts/config echoes (``*_n``, ``batch``, booleans, strings,
  lists, ``truncated`` markers) — they are workload descriptors, not
  performance;
- band (ideal = 1.0): fidelity ratios (``steps_per_s_ratio``,
  ``cost_ratio`` — a simulator's predicted-over-measured figures) —
  judged against the ABSOLUTE ``1.0 ± tolerance`` band, not against the
  baseline, because drifting high is exactly as wrong as drifting low.

Keys present in only one document are reported as ``missing`` (information,
not failure, unless ``strict``): benchmarks evolve and the gate must not
freeze the schema. The module imports only the standard library.
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

__all__ = [
    "classify",
    "flatten",
    "compare",
    "comparable_overlap",
    "Finding",
    "DEFAULT_TOLERANCE",
]

# relative band: run-to-run spread on a shared machine is ~5-10%; 25% flags
# real regressions while riding out the noise (compare(tolerance=) tightens)
DEFAULT_TOLERANCE = 0.25

# (pattern, direction) — first match wins; direction 'ignore' short-circuits
_RULES: Tuple[Tuple[re.Pattern, str], ...] = tuple(
    (re.compile(p), d)
    for p, d in (
        # -- ignore: workload/config echoes and markers --------------------
        (r"(^|\.)(n|query_n|metric|unit)$", "ignore"),
        # the headline: a benchmark's "value" is decode tokens/sec/chip
        (r"(^|\.)value$", "higher"),
        (r"(_|^|\.)(batch|bucket|concurrency|dim|vectors?|chunks|steps)$", "ignore"),
        (r"passes", "ignore"),
        (r"truncated|legs_skipped|quant$|identical", "ignore"),
        (r"fetches_per_query|verify_steps|spec_verify", "ignore"),
        (r"alpha|top1_prob|longctx_T", "ignore"),
        (r"tokens_computed|tokens_reused|index_vectors", "ignore"),
        # environment property (the harness's host link), not repo perf —
        # and the per-round target constant
        (r"tunnel_fetch|target", "ignore"),
        # chunk-reuse leg's exact-policy CONTROL numbers (reported for
        # contrast, deliberately unjudged) — must precede the qps rule
        (r"exact_skip_frac|exact_resolve_qps", "ignore"),
        # -- band: ideal is exactly 1.0 -----------------------------------
        # replay-fidelity leg: the simulator's
        # predicted-over-measured ratios — must precede the _per_s rule,
        # which would read steps_per_s_ratio=1.4 as an "improvement"
        (r"steps_per_s_ratio|cost_ratio", "band"),
        # -- higher is better ---------------------------------------------
        (r"tok_per_s|tokens_per_sec|per_s$|_per_s(\.|_|$)|qps", "higher"),
        (r"mfu|vs_baseline|tokens_per_verify|reduction", "higher"),
        # paged-KV leg: dense→paged step-rate ratio and the
        # admittable-slots-at-fixed-HBM gain
        (r"speedup|_gain$", "higher"),
        # KV-tiering leg: servable-capacity multiplier at fixed
        # HBM and the fraction of swap-ins hidden under decode
        (r"effective_capacity_x|hide_rate", "higher"),
        # paged-speculation leg: mean accepted draft length per
        # verify window — shrinkage means the draft source stopped firing
        # (the speedups themselves match the "speedup" rule above)
        (r"accept_len_mean", "higher"),
        # chunk-reuse leg: prefill tokens skipped on the
        # shuffled-composition stream — shrinkage is a regression; the
        # measured logit error must not grow past its pin either
        (r"prefill_skip_frac", "higher"),
        (r"logit_max_err", "lower"),
        (r"logit_tol", "ignore"),
        # goodput ledger: useful-work shares and tokens/$ must
        # not shrink (mfu_* matches the mfu rule above)
        (r"tokens_per_usd|goodput_frac|useful_frac", "higher"),
        # -- lower is better ----------------------------------------------
        # goodput ledger: padding-bubble share of busy chip
        # time — growth means admission shapes/batch occupancy regressed
        (r"bubble_frac", "lower"),
        # flight-recorder cost: fraction of decode steps/s the
        # journal costs with the recorder on — growth is a regression
        (r"overhead_frac", "lower"),
        (r"_ms($|\.|_)|_s$|seconds|_bytes$", "lower"),
    )
)


def classify(key: str) -> str:
    """'higher' | 'lower' | 'band' | 'ignore' for one flattened key."""
    for rx, direction in _RULES:
        if rx.search(key):
            return direction
    return "ignore"


def flatten(doc: Dict, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k, v in doc.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


@dataclass(frozen=True)
class Finding:
    key: str
    kind: str  # 'regression' | 'improvement' | 'missing'
    direction: str  # 'higher' | 'lower'
    baseline: Optional[float]
    current: Optional[float]
    ratio: Optional[float]  # current / baseline

    def describe(self) -> str:
        if self.kind == "missing":
            side = "current" if self.current is None else "baseline"
            return f"{self.key}: absent from {side}"
        arrow = "↑" if (self.ratio or 1.0) >= 1.0 else "↓"
        pct = abs((self.ratio or 1.0) - 1.0) * 100.0
        if self.direction == "band":
            off = abs((self.current if self.current is not None else 1.0) - 1.0)
            return (
                f"{self.key}: {self.baseline:g} → {self.current:g} "
                f"({off * 100.0:.1f}% off the 1.0 fidelity ideal)"
            )
        want = "lower" if self.direction == "lower" else "higher"
        return (
            f"{self.key}: {self.baseline:g} → {self.current:g} "
            f"({arrow}{pct:.1f}%, {want}-is-better)"
        )


def _numeric(v) -> Optional[float]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    f = float(v)
    return f if math.isfinite(f) else None


def compare(
    current: Dict,
    baseline: Dict,
    tolerance: float = DEFAULT_TOLERANCE,
) -> Dict[str, List[Finding]]:
    """Compare two bench documents → findings bucketed by kind.

    A metric regresses when it moves the BAD way past the relative band:
    lower-is-better: ``current > baseline * (1 + tolerance)``;
    higher-is-better: ``current < baseline * (1 - tolerance)``;
    band (ideal 1.0): ``abs(current - 1) > tolerance`` regardless of the
    baseline — the fidelity contract is absolute.
    Baselines of 0 compare only for direction (any bad nonzero flags).
    """
    cur = flatten(current)
    base = flatten(baseline)
    out: Dict[str, List[Finding]] = {
        "regression": [], "improvement": [], "missing": []
    }
    for key in sorted(set(cur) | set(base)):
        direction = classify(key)
        if direction == "ignore":
            continue
        cv, bv = _numeric(cur.get(key)), _numeric(base.get(key))
        if cv is None and bv is None:
            continue
        if cv is None or bv is None:
            out["missing"].append(Finding(key, "missing", direction, bv, cv, None))
            continue
        ratio = cv / bv if bv else (math.inf if cv > 0 else 1.0)
        if direction == "band":
            # absolute band around the 1.0 ideal — the baseline only
            # matters for "improvement" (moved meaningfully closer to 1)
            bad = abs(cv - 1.0) > tolerance
            good = abs(cv - 1.0) < abs(bv - 1.0) * (1.0 - tolerance)
        elif direction == "lower":
            bad = cv > bv * (1.0 + tolerance) if bv else cv > 0
            good = cv < bv * (1.0 - tolerance)
        else:
            bad = cv < bv * (1.0 - tolerance)
            good = cv > bv * (1.0 + tolerance) if bv else cv > 0
        if bad:
            out["regression"].append(
                Finding(key, "regression", direction, bv, cv, ratio)
            )
        elif good:
            out["improvement"].append(
                Finding(key, "improvement", direction, bv, cv, ratio)
            )
    return out


def load_json(path: str) -> Dict:
    """Load a bench document; tolerates a file whose LAST line is the JSON
    (a benchmark prints one line, but logs can precede it in captured
    runs) and unwraps a ``{"parsed": {...}}`` envelope, so a saved run can
    serve as the baseline with the key namespace a fresh run emits."""
    with open(path, encoding="utf-8") as f:
        text = f.read().strip()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
        for line in reversed(text.splitlines()):
            line = line.strip()
            if line.startswith("{"):
                doc = json.loads(line)
                break
        if doc is None:
            raise
    if isinstance(doc, dict) and isinstance(doc.get("parsed"), dict):
        return doc["parsed"]
    return doc


def comparable_overlap(current: Dict, baseline: Dict) -> List[str]:
    """The flattened keys BOTH documents carry as comparable numerics —
    the gate's judged surface. Empty overlap means the gate would be
    vacuous (nothing judged), which callers must treat as an ERROR, not a
    pass: a schema mismatch silently green-lighting every regression is
    exactly the failure mode this gate exists to prevent."""
    cur, base = flatten(current), flatten(baseline)
    return sorted(
        k for k in set(cur) & set(base)
        if classify(k) != "ignore"
        and _numeric(cur[k]) is not None and _numeric(base[k]) is not None
    )


def schema_check(doc: Dict) -> List[str]:
    """Dry-run validation: the document must parse (caller's job), be a
    JSON object, and carry at least one comparable numeric metric. Returns
    human-readable problems (empty = OK)."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return [f"top level must be a JSON object, got {type(doc).__name__}"]
    flat = flatten(doc)
    comparable = [
        k for k, v in flat.items()
        if classify(k) != "ignore" and _numeric(v) is not None
    ]
    if not comparable:
        problems.append(
            "no comparable numeric metrics found (every key classified "
            "'ignore' or non-numeric)"
        )
    return problems
