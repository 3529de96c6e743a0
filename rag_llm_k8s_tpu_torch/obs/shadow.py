"""The shadow quality auditor, the port's copy of
``rag_llm_k8s_tpu/obs/shadow.py``: online divergence tracking for every
approximation in the serving path.

The service serves four approximations whose quality contracts the tests
pin: int8 warm-tier KV, chunk-granular splice with boundary correction,
speculative verify windows, and prefix reuse generally. This module
observes them on live traffic:

- ``ShadowAuditor`` re-runs a sampled fraction of completed requests on the
  exact path through an injected ``score_fn`` (in the service,
  ``InferenceEngine.score_exact``: one teacher-forced chunked forward over
  prompt + delivered tokens on the one-shot engine, so the continuous
  pool's blocks are untouched). Audits ride one bounded worker behind a
  headroom gate (the lookahead executor's: an open breaker or a queued
  admission defers the audit), so shadow work never competes with live
  traffic.
- **comparison**: the delivered stream is judged token by token against the
  exact path's argmax chain. ``first_div`` is the first position where they
  disagree; ``logit_err`` is half the exact logit gap between the exact
  argmax and the delivered token there, the smallest symmetric logit
  perturbation that explains the delivered choice, so an approximation
  whose per-logit tolerance is 0.15 cannot measure above 0.15. Sampled
  (non-greedy) requests cannot be judged this way and count as
  ``skipped{reason="sampled"}``.
- **attribution**: every audit carries the request's approximation
  fingerprint (``APPROXIMATIONS``; the prefix cache stamps
  ``CachedPrefix.approx``, the continuous engine its verify windows), so a
  divergence names the approximation that served it.
- **one report, two sources**: each audit is journaled as a
  ``shadow_audit`` flight event, and ``render_report(state_from_events(...))``
  over a journal rebuilds exactly the report the live auditor's ``state()``
  renders (``GET /debug/quality``).

Standard library only, as in the JAX package: ``score_fn`` results are read
as plain sequences, and journaling goes through the service's ``on_result``
hook. Configuration is ``core/config.py`` ``ShadowConfig`` (env
``TPU_RAG_SHADOW*``); this module reads no environment itself.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "APPROXIMATIONS",
    "ERR_BUCKETS",
    "POS_BUCKETS",
    "SCHEMA_VERSION",
    "SKIP_REASONS",
    "ShadowAuditor",
    "new_state",
    "record",
    "render_report",
    "state_from_events",
]

logger = logging.getLogger(__name__)

#: report schema; an offline reader refuses versions newer than it knows
SCHEMA_VERSION = 1

#: the CLOSED approximation catalog a fingerprint may name (plus the
#: implicit "none" for requests that served with every approximation off)
APPROXIMATIONS = (
    "prefix_reuse",    # cached-KV reuse engaged (lossless by contract)
    "warm_tier",       # int8 warm-tier KV served (bounded drift)
    "splice",          # chunk-granular splice at a non-canonical placement
    "rerotate",        # RoPE delta re-rotation of cached K planes
    "boundary_fixup",  # bounded boundary-correction re-prefill
    "spec_verify",     # speculative draft-and-verify (byte-identical)
)

#: why a SELECTED audit did not run (unsampled requests are not skips)
SKIP_REASONS = (
    "sampled",   # non-greedy request: no deterministic exact reference
    "empty",     # nothing was emitted, nothing to compare
    "no_prompt", # the serving path could not reconstruct the prompt ids
    "oversize",  # prompt + stream exceeds the exact path's scoring cap
    "backlog",   # the bounded audit queue was full
    "headroom",  # live traffic never left the device idle long enough
)

#: logit-error histogram ladder (upper bounds; +Inf overflow implied).
#: 0.15 is a bucket bound ON PURPOSE: it is the pinned warm/splice
#: tolerance, and the quality SLO evaluates at exactly that bound.
ERR_BUCKETS = (0.01, 0.02, 0.05, 0.1, 0.15, 0.25, 0.5, 1.0, 2.5)

#: first-divergence-token histogram ladder (upper bounds, 0-indexed
#: emitted position; +Inf overflow implied)
POS_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

_OUTCOMES = ("clean", "diverged", "skipped", "failed")


def _bucket_index(value: float, bounds: Sequence[float]) -> int:
    """Index of the first bound >= value, len(bounds) for overflow —
    the same "observation <= bound lands in the bucket" rule the metrics
    registry's histograms use, so the SLO's bucket math and this module's
    agree on what 0.15 means."""
    for i, b in enumerate(bounds):
        if value <= b:
            return i
    return len(bounds)


def _hist_labels(bounds: Sequence[float]) -> List[str]:
    return [f"le_{b:g}" for b in bounds] + ["inf"]


def new_state() -> Dict:
    """An empty accumulator — everything in it is derivable from the
    ``shadow_audit`` journal events alone (the same-report contract)."""
    return {
        "schema_version": SCHEMA_VERSION,
        "audits": {k: 0 for k in _OUTCOMES},
        "skips": {},
        "attribution": {},  # approximation -> {"clean": n, "diverged": n}
        "tokens_compared": 0,
        "err_hist": [0] * (len(ERR_BUCKETS) + 1),
        "pos_hist": [0] * (len(POS_BUCKETS) + 1),
        "err_max": 0.0,
        "tenants": {},  # tenant -> {"clean": n, "diverged": n}
    }


def record(state: Dict, ev: Dict) -> None:
    """Fold one audit event's facts into ``state`` — used verbatim by the
    live auditor and by ``state_from_events``, so the two can only agree."""
    oc = ev.get("outcome")
    if oc not in state["audits"]:
        return
    state["audits"][oc] += 1
    if oc == "skipped":
        reason = str(ev.get("reason", "unknown"))
        state["skips"][reason] = state["skips"].get(reason, 0) + 1
        return
    if oc == "failed":
        return
    state["tokens_compared"] += int(ev.get("n", 0))
    approx = list(ev.get("approx") or []) or ["none"]
    for a in approx:
        slot = state["attribution"].setdefault(a, {"clean": 0, "diverged": 0})
        slot[oc] += 1
    tenant = ev.get("tenant")
    if tenant:
        trow = state.setdefault("tenants", {}).setdefault(
            str(tenant), {"clean": 0, "diverged": 0}
        )
        trow[oc] += 1
    err = float(ev.get("err", 0.0))
    state["err_hist"][_bucket_index(err, ERR_BUCKETS)] += 1
    if err > state["err_max"]:
        state["err_max"] = err
    if oc == "diverged":
        pos = int(ev.get("pos", 0))
        state["pos_hist"][_bucket_index(pos, POS_BUCKETS)] += 1


def state_from_events(events: Sequence[Dict]) -> Dict:
    """Rebuild the auditor state from a journal/bundle's ``shadow_audit``
    events — the offline half of the same-report contract."""
    st = new_state()
    for e in sorted(events, key=lambda e: e.get("seq", 0)):
        if e.get("type") == "shadow_audit":
            record(st, e)
    return st


def _quantile(hist: Sequence[int], bounds: Sequence[float], q: float,
              overflow: float) -> float:
    """The smallest bucket bound covering fraction ``q`` of observations
    (``overflow`` — in practice the tracked max — when the quantile lands
    past the ladder). 0.0 on an empty histogram."""
    total = sum(hist)
    if total == 0:
        return 0.0
    need = q * total
    cum = 0
    for i, b in enumerate(bounds):
        cum += hist[i]
        if cum >= need:
            return float(b)
    return float(overflow)


def render_report(state: Dict) -> Dict:
    """The quality report: served live by ``GET /debug/quality`` and rebuilt
    offline from a journal's ``shadow_audit`` events by the same function."""
    audits = dict(state["audits"])
    judged = audits["clean"] + audits["diverged"]
    rate = (audits["diverged"] / judged) if judged else 0.0
    err_hist = {
        lbl: int(n)
        for lbl, n in zip(_hist_labels(ERR_BUCKETS), state["err_hist"])
    }
    pos_hist = {
        lbl: int(n)
        for lbl, n in zip(_hist_labels(POS_BUCKETS), state["pos_hist"])
    }
    return {
        "schema_version": state.get("schema_version", SCHEMA_VERSION),
        "audits": audits,
        "divergence_rate": round(rate, 6),
        "skips": dict(state["skips"]),
        "attribution": {
            a: dict(v) for a, v in sorted(state["attribution"].items())
        },
        "tokens_compared": int(state["tokens_compared"]),
        "logit_err": {
            "p50": _quantile(
                state["err_hist"], ERR_BUCKETS, 0.5, state["err_max"]
            ),
            "p99": _quantile(
                state["err_hist"], ERR_BUCKETS, 0.99, state["err_max"]
            ),
            "max": round(float(state["err_max"]), 6),
            "hist": err_hist,
        },
        "first_divergence_token": {
            "p50": _quantile(state["pos_hist"], POS_BUCKETS, 0.5,
                             POS_BUCKETS[-1]),
            "hist": pos_hist,
        },
        # per-tenant judged-audit split: which tenant's traffic the
        # divergences landed on; absent tenants never appear, so journals
        # without tenants render an empty dict, not an error
        "tenants": {
            t: dict(v)
            for t, v in sorted(state.get("tenants", {}).items())
        },
    }


class _Job:
    __slots__ = ("request_id", "prompt", "emitted", "approx", "tenant")

    def __init__(self, request_id, prompt, emitted, approx, tenant=None):
        self.request_id = request_id
        self.prompt = prompt
        self.emitted = emitted
        self.approx = approx
        self.tenant = tenant


class ShadowAuditor:
    """Sampled shadow-execution auditor over completed live requests.

    ``observe()`` is called once per delivered response (serving thread:
    one rng draw and, when selected, one bounded enqueue — never device
    work). One daemon worker drains the queue, waits out the headroom
    gate, runs ``score_fn(prompt_ids, emitted_ids)`` and folds the
    comparison into the state; per-audit facts go to ``on_result`` (the
    service journals them as ``shadow_audit`` flight events and feeds the
    metric histograms) and a second diverged audit inside
    ``burst_window_s`` fires ``on_burst`` (the service spools a
    ``quality_divergence`` incident bundle).

    ``rng``/``clock`` are injectable so tests drive sampling and the
    burst window deterministically.
    """

    #: headroom polls before a queued audit is abandoned as "headroom"
    _HEADROOM_TRIES = 40
    _HEADROOM_SLEEP_S = 0.05

    def __init__(
        self,
        config,
        score_fn: Callable[[Sequence[int], Sequence[int]], Dict],
        headroom_fn: Optional[Callable[[], bool]] = None,
        on_result: Optional[Callable[[Optional[int], Dict], None]] = None,
        on_burst: Optional[Callable[[], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        rng=None,
    ):
        config.validate()
        self.config = config
        self.score_fn = score_fn
        self.headroom_fn = headroom_fn
        self.on_result = on_result
        self.on_burst = on_burst
        self.clock = clock
        if rng is None:
            import random

            rng = random.Random()
        self._rng = rng
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._state = new_state()
        self._seen = 0
        self._selected = 0
        self._div_stamps: deque = deque()
        self._stop = False
        self._inflight = False  # a popped job the worker is still judging
        self._worker: Optional[threading.Thread] = None

    # -- serving-thread side ---------------------------------------------
    def observe(
        self,
        emitted: Sequence[int],
        approx: Tuple[str, ...] = (),
        request_id: Optional[int] = None,
        prompt_ids: Optional[Sequence[int]] = None,
        prompt_fn: Optional[Callable[[], Optional[Sequence[int]]]] = None,
        eligible: bool = True,
        ineligible_reason: str = "sampled",
        force: bool = False,
        tenant: Optional[str] = None,
    ) -> bool:
        """One delivered response. Returns True when an audit was enqueued.

        ``eligible=False`` marks a request the exact path cannot judge (a
        non-greedy stream); the reason is counted only when the sampler
        actually selected it — unsampled traffic is not a "skip".
        ``prompt_fn`` defers prompt-id reconstruction to selection time so
        the 95% unsampled case never pays it. ``force`` bypasses the
        sampler (the chip smoke script and tests). ``tenant`` (edge-interned)
        rides the audit so divergence attributes to the tenant whose
        traffic exercised the approximation."""
        with self._lock:
            self._seen += 1
        if not self.config.enabled:
            return False
        if not force and not (self._rng.random() < self.config.sample_rate):
            return False
        with self._lock:
            self._selected += 1
        if not eligible:
            self._skip(request_id, ineligible_reason, tenant=tenant)
            return False
        if not emitted:
            self._skip(request_id, "empty", tenant=tenant)
            return False
        if prompt_ids is None and prompt_fn is not None:
            try:
                prompt_ids = prompt_fn()
            except Exception:  # noqa: BLE001 — audit prep must not fail serving
                logger.exception("shadow prompt reconstruction failed")
                prompt_ids = None
        if not prompt_ids:
            self._skip(request_id, "no_prompt", tenant=tenant)
            return False
        job = _Job(
            request_id, [int(t) for t in prompt_ids],
            [int(t) for t in emitted], tuple(approx), tenant=tenant,
        )
        with self._lock:
            if self._stop:
                return False
            if len(self._queue) >= self.config.backlog:
                pass  # counted outside the lock below
            else:
                self._queue.append(job)
                self._ensure_worker_locked()
                self._cv.notify()
                return True
        self._skip(request_id, "backlog", tenant=tenant)
        return False

    # -- worker side ------------------------------------------------------
    def _ensure_worker_locked(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._run, name="shadow-audit", daemon=True
            )
            self._worker.start()

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._stop:
                    self._cv.wait(0.5)
                if self._stop and not self._queue:
                    return
                job = self._queue.popleft()
                self._inflight = True
            try:
                if not self._await_headroom():
                    self._skip(job.request_id, "headroom", tenant=job.tenant)
                    continue
                try:
                    ev = self._audit(job)
                except ValueError:
                    # the scorer declined the shape (prompt + stream over
                    # its cap) — an honest skip, not a failure
                    self._skip(job.request_id, "oversize", tenant=job.tenant)
                    continue
                except Exception:  # noqa: BLE001 — an audit crash must stay contained
                    logger.exception(
                        "shadow audit failed (request %s)", job.request_id
                    )
                    ev = {
                        "outcome": "failed", "n": 0,
                        "approx": list(job.approx),
                    }
                    if job.tenant:
                        ev["tenant"] = job.tenant
                self._finish(job.request_id, ev)
            finally:
                with self._lock:
                    self._inflight = False

    def _await_headroom(self) -> bool:
        """Wait for live traffic to leave the device alone; give up after
        the bounded poll budget (the audit is then an honest skip — shadow
        work must never queue behind a saturated serving path)."""
        if self.headroom_fn is None:
            return True
        for _ in range(self._HEADROOM_TRIES):
            with self._lock:
                if self._stop:
                    return False
            try:
                if self.headroom_fn():
                    return True
            except Exception:  # noqa: BLE001 — a broken gate must not kill the worker
                logger.exception("shadow headroom probe failed")
                return False
            time.sleep(self._HEADROOM_SLEEP_S)
        return False

    def _audit(self, job: _Job) -> Dict:
        """Run the exact-path replay and compare: first token where the
        exact argmax chain disagrees with the delivered stream, and the
        minimal logit perturbation that explains the delivered token."""
        score = self.score_fn(job.prompt, job.emitted)
        argmax = score["argmax"]
        tn = {"tenant": job.tenant} if job.tenant else {}
        first_div = None
        for t, tok in enumerate(job.emitted):
            if int(argmax[t]) != int(tok):
                first_div = t
                break
        if first_div is None:
            return {
                "outcome": "clean", "n": len(job.emitted), "err": 0.0,
                "approx": list(job.approx), **tn,
            }
        gap = float(score["max_logit"][first_div]) - float(
            score["chosen_logit"][first_div]
        )
        return {
            "outcome": "diverged",
            "n": first_div + 1,  # tokens compared up to the divergence
            "pos": first_div,
            "err": round(max(gap, 0.0) / 2.0, 6),
            "approx": list(job.approx), **tn,
        }

    def _skip(self, request_id: Optional[int], reason: str,
              tenant: Optional[str] = None) -> None:
        ev = {"outcome": "skipped", "reason": reason, "n": 0}
        if tenant:
            ev["tenant"] = tenant
        self._finish(request_id, ev)

    def _finish(self, request_id: Optional[int], ev: Dict) -> None:
        with self._lock:
            record(self._state, ev)
            burst = False
            if ev.get("outcome") == "diverged":
                now = self.clock()
                self._div_stamps.append(now)
                cutoff = now - float(self.config.burst_window_s)
                while self._div_stamps and self._div_stamps[0] < cutoff:
                    self._div_stamps.popleft()
                burst = len(self._div_stamps) >= 2
        hook = self.on_result
        if hook is not None:
            try:
                hook(request_id, dict(ev))
            except Exception:  # noqa: BLE001 — observers must not kill the worker
                logger.exception("shadow on_result hook failed")
        if burst and self.on_burst is not None:
            try:
                self.on_burst()
            except Exception:  # noqa: BLE001
                logger.exception("shadow on_burst hook failed")

    # -- readers ----------------------------------------------------------
    def state(self) -> Dict:
        """A consistent copy of the journal-derivable accumulator."""
        with self._lock:
            st = self._state
            return {
                "schema_version": st["schema_version"],
                "audits": dict(st["audits"]),
                "skips": dict(st["skips"]),
                "attribution": {
                    a: dict(v) for a, v in st["attribution"].items()
                },
                "tokens_compared": st["tokens_compared"],
                "err_hist": list(st["err_hist"]),
                "pos_hist": list(st["pos_hist"]),
                "err_max": st["err_max"],
                "tenants": {
                    t: dict(v) for t, v in st.get("tenants", {}).items()
                },
            }

    def stats(self) -> Dict[str, float]:
        """Flat numbers for the metric callbacks (seen/selected are
        auditor-local sampling facts, deliberately NOT in the report —
        the report holds only what the journal can reproduce)."""
        with self._lock:
            st = self._state
            judged = st["audits"]["clean"] + st["audits"]["diverged"]
            out: Dict[str, float] = {
                "seen": float(self._seen),
                "selected": float(self._selected),
                "backlog_depth": float(len(self._queue)),
                "divergence_rate": (
                    st["audits"]["diverged"] / judged if judged else 0.0
                ),
            }
            for oc, n in st["audits"].items():
                out[f"audits_{oc}"] = float(n)
            for r in SKIP_REASONS:
                out[f"skip_{r}"] = float(st["skips"].get(r, 0))
            for a, v in st["attribution"].items():
                out[f"attr_{a}_clean"] = float(v["clean"])
                out[f"attr_{a}_diverged"] = float(v["diverged"])
            return out

    def drain(self, timeout: float = 5.0) -> bool:
        """Block until the queue is empty and the worker idles (tests and
        the chip smoke script; serving never calls this)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._queue and not self._inflight:
                    return True
            time.sleep(0.01)
        return False

    def shutdown(self) -> None:
        with self._lock:
            self._stop = True
            self._cv.notify_all()
            worker = self._worker
        if worker is not None:
            worker.join(timeout=5.0)
