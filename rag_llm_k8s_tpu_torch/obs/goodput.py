"""Goodput ledger, the port's copy of ``rag_llm_k8s_tpu/obs/goodput.py``:
per-window chip-time attribution and roofline accounting.

- :data:`CATEGORIES` — the CLOSED attribution set every device sync
  window decomposes into. Per window the six non-idle categories sum to
  exactly the window's measured duration (the conservation invariant);
  ``idle`` is derived (wall − busy).
- :class:`RooflineModel` — an analytic FLOPs/bytes model derived from the
  model config (params, heads, dtypes): classifies each executable kind as
  compute- or bandwidth-bound (arithmetic intensity against the card's
  ridge point) and yields per-window MFU and bandwidth-use estimates. MFU
  credits only REAL token lanes: padding lanes execute but earn nothing.
  The peaks default to the H100 SXM data sheet's dense bf16 989 TFLOP/s
  and 3,350 GB/s of HBM3 (``TPU_RAG_GOODPUT_PEAK_TFLOPS`` /
  ``TPU_RAG_GOODPUT_HBM_GBS`` override them).
- :class:`GoodputLedger` — the engine-side step ledger. The engines call
  ``record_*`` once per device sync window (scheduler thread only), after
  the window's own token fetch and on numbers the host already holds: no
  tensor, no launch, no device sync. Each call updates the rolling
  per-category chip-second totals, the per-kind roofline aggregates and
  the per-request attribution map, and returns the window summary the
  caller journals as a ``goodput_window`` flight event, so
  :func:`state_from_events` rebuilds from a journal the report
  ``GET /debug/goodput`` renders live.

The window clock is the host's: a window's duration is the host wall time
of its sync window, as in the JAX package, not card time from CUDA events.

Attribution model:

- a window of duration ``d`` with ``A`` active requests attributes
  ``d / A`` chip-seconds to each (every row runs in lockstep), so
  concurrent requests' attributed chip-seconds sum to the scheduler's
  measured busy time by construction;
- within the window, ``d`` splits across categories by weighted lane
  counts: useful decode lanes, drafted-but-rejected verify lanes,
  computed prefill tokens, re-fed tokens after a preemption or reset
  (``preempt_rework``), splice/scatter service of reused KV
  (``prefill_skipped``, weighted by the roofline's copy-vs-compute
  ratio), and everything else — inactive rows, right-pad slack,
  post-EOS lanes — as ``padding_bubble``.

The module imports only the standard library and nothing else of the
package: the flight event is emitted by the CALLER from the summary dict
``record_*`` returns.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "CATEGORIES",
    "WINDOW_CATEGORIES",
    "KINDS",
    "GoodputLedger",
    "RooflineModel",
    "ledger_for",
    "merge_states",
    "render_report",
    "roofline_for_llama",
    "state_from_events",
]

#: The closed attribution set. The first six decompose every device sync
#: window (they sum to the window's duration); ``idle`` is wall − busy,
#: derived at report time — a window is never idle by definition.
CATEGORIES = (
    "prefill_compute",
    "prefill_skipped",
    "decode_useful",
    "spec_rejected",
    "padding_bubble",
    "preempt_rework",
    "idle",
)
WINDOW_CATEGORIES = CATEGORIES[:-1]

#: Executable kinds the ledger aggregates roofline figures per.
KINDS = ("prefill", "prefill_px", "decode", "verify", "oneshot", "mixed")

#: The card's peaks when the config does not pin them
#: (TPU_RAG_GOODPUT_PEAK_TFLOPS / TPU_RAG_GOODPUT_HBM_GBS): the H100 SXM
#: data sheet's dense bf16 989 TFLOP/s and 3,350 GB/s of HBM3 bandwidth. On
#: a CPU host the absolute MFU is meaningless-small, but every RELATIVE
#: read (category split, bubble fraction, per-request attribution) holds.
DEFAULT_PEAK_TFLOPS = 989.0
DEFAULT_HBM_GBS = 3350.0


class RooflineModel:
    """Analytic per-token FLOPs/bytes figures for one model config.

    All inputs are plain numbers, so a journal reader could build one
    from a bundle's config fingerprint — though the ``goodput_window``
    events carry their per-window mfu/bw/bound precomputed, so it
    normally does not.
    """

    def __init__(
        self,
        flops_per_token: float,
        weight_bytes: float,
        kv_bytes_per_token: float,
        peak_tflops: float = 0.0,
        hbm_gbs: float = 0.0,
    ):
        if flops_per_token <= 0 or weight_bytes <= 0 or kv_bytes_per_token <= 0:
            raise ValueError("roofline figures must be positive")
        self.flops_per_token = float(flops_per_token)
        self.weight_bytes = float(weight_bytes)
        self.kv_bytes_per_token = float(kv_bytes_per_token)
        self.peak_flops = (
            float(peak_tflops) if peak_tflops > 0 else DEFAULT_PEAK_TFLOPS
        ) * 1e12
        self.peak_bytes = (
            float(hbm_gbs) if hbm_gbs > 0 else DEFAULT_HBM_GBS
        ) * 1e9

    # -- derived ---------------------------------------------------------
    @property
    def ridge(self) -> float:
        """FLOPs/byte above which the chip is compute-bound."""
        return self.peak_flops / self.peak_bytes

    @property
    def t_compute_token(self) -> float:
        """Best-case seconds to COMPUTE one token's forward."""
        return self.flops_per_token / self.peak_flops

    @property
    def t_copy_token(self) -> float:
        """Best-case seconds to MOVE one token's KV (read + write)."""
        return 2.0 * self.kv_bytes_per_token / self.peak_bytes

    @property
    def splice_weight(self) -> float:
        """Relative per-token cost of SERVING a reused-KV token (a
        bandwidth-bound splice/scatter/re-rotation) vs computing one — the
        lane weight ``prefill_skipped`` earns in a window's split. Clamped
        so a degenerate config can neither zero out reuse service time nor
        claim a copy costs more than the compute it saved."""
        w = self.t_copy_token / max(self.t_compute_token, 1e-30)
        return min(max(w, 1e-4), 1.0)

    def classify(self, flops: float, nbytes: float) -> str:
        """'compute' | 'bandwidth' by arithmetic intensity vs the ridge."""
        intensity = flops / max(nbytes, 1e-30)
        return "compute" if intensity >= self.ridge else "bandwidth"

    def mfu(self, flops: float, seconds: float) -> float:
        return flops / max(seconds * self.peak_flops, 1e-30)

    def bw_util(self, nbytes: float, seconds: float) -> float:
        return nbytes / max(seconds * self.peak_bytes, 1e-30)


def roofline_for_llama(
    num_layers: int,
    hidden_size: int,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    intermediate_size: int,
    vocab_size: int,
    weight_bytes_per_param: float = 2.0,
    kv_quant: str = "bf16",
    peak_tflops: float = 0.0,
    hbm_gbs: float = 0.0,
) -> RooflineModel:
    """The serving stack's roofline from a LlamaConfig's fields.

    ``flops_per_token ≈ 2 × matmul params`` (attention-score FLOPs are
    context-dependent and second-order at serving context lengths);
    ``weight_bytes`` is the full
    streamed parameter footprint a decode step reads once per batch;
    ``kv_bytes_per_token`` is one position's K+V across all layers (plus
    fp32 scale planes under int8 KV).
    """
    L, d = int(num_layers), int(hidden_size)
    H, K, hd = int(num_heads), int(num_kv_heads), int(head_dim)
    inter, V = int(intermediate_size), int(vocab_size)
    matmul_params = L * (
        d * H * hd          # q projection
        + 2 * d * K * hd    # k, v projections
        + H * hd * d        # o projection
        + 3 * d * inter     # gate / up / down
    ) + V * d               # lm head
    kv_b = 1 if kv_quant == "int8" else 2
    kv_bytes = 2 * L * K * hd * kv_b
    if kv_quant == "int8":
        kv_bytes += 2 * L * K * 4  # per-position fp32 scale planes
    # weight_bytes = the matmul params a decode step actually STREAMS
    # (lm head included via matmul_params); the embedding table is a
    # per-token row gather, not a full stream — counting it would
    # overstate decode bytes ~7% at 8B scale
    return RooflineModel(
        flops_per_token=2.0 * matmul_params,
        weight_bytes=matmul_params * float(weight_bytes_per_param),
        kv_bytes_per_token=float(kv_bytes),
        peak_tflops=peak_tflops,
        hbm_gbs=hbm_gbs,
    )


def ledger_for(model_config, engine_config) -> "GoodputLedger":
    """THE ledger constructor both serving engines share (duck-typed over
    the config dataclasses — still no package imports). One site means the
    two engines' rooflines cannot drift: ``merge_states`` sums their
    states into one report, which is only meaningful when both were
    derived from the same arithmetic."""
    gp = getattr(engine_config, "goodput", None)
    return GoodputLedger(
        roofline_for_llama(
            model_config.num_layers, model_config.hidden_size,
            model_config.num_heads, model_config.num_kv_heads,
            model_config.head_dim, model_config.intermediate_size,
            model_config.vocab_size,
            weight_bytes_per_param=(
                1.0 if getattr(engine_config, "weight_quant", "bf16") == "int8"
                else 2.0
            ),
            kv_quant=getattr(engine_config, "kv_quant", "bf16"),
            peak_tflops=getattr(gp, "peak_tflops", 0.0) or 0.0,
            hbm_gbs=getattr(gp, "hbm_gbs", 0.0) or 0.0,
        ),
        enabled=getattr(gp, "enabled", True),
        chip_hour_usd=getattr(gp, "chip_hour_usd", 0.0) or 0.0,
    )


def _percentile(values: Sequence[float], q: float) -> Optional[float]:
    if not values:
        return None
    s = sorted(values)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


class GoodputLedger:
    """The engine-side step ledger (one per engine; ON by default).

    Writers (``record_*`` / ``pop_request``) run on the engine's owning
    thread only; readers (``state`` / ``totals``, the /metrics callbacks
    and ``/debug/goodput``) come from scrape threads — a single tiny lock
    over plain dict math covers both, and no record ever touches device
    state (``chip_smoke.py`` times the ``record_*`` calls against the
    windows they record).
    """

    MAX_REQUESTS = 8192  # raw-engine callers (tests, benches) never pop
    COST_RING = 512      # completed-request chip_s ring (percentiles)
    # distinct per-tenant rollup rows (interned names churn slowly through
    # the top-K tracker; when even that overflows, the coldest row folds
    # into __other__ — the rollup can never grow with raw-tenant traffic)
    MAX_TENANT_ROWS = 64
    OTHER_TENANT = "__other__"

    def __init__(
        self,
        roofline: RooflineModel,
        enabled: bool = True,
        chip_hour_usd: float = 0.0,
    ):
        self.roofline = roofline
        self.enabled = bool(enabled)
        self.chip_hour_usd = max(0.0, float(chip_hour_usd))
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._cat_s: Dict[str, float] = {c: 0.0 for c in WINDOW_CATEGORIES}
        self._kinds: Dict[str, Dict[str, float]] = {}
        self._busy_s = 0.0
        self._attributed_s = 0.0
        self._useful_decode_tokens = 0.0
        self._requests: Dict[int, Dict[str, float]] = {}
        self._completed: "deque[float]" = deque(maxlen=self.COST_RING)
        # tenant attribution: rid -> interned tenant (stamped at submit),
        # folded into the per-tenant rollup when the request pops
        self._rid_tenant: Dict[int, str] = {}
        self._tenant_roll: Dict[str, Dict[str, float]] = {}

    # ------------------------------------------------------------------
    # recording (engine thread)
    # ------------------------------------------------------------------
    def _req(self, rid: int) -> Dict[str, float]:
        r = self._requests.get(rid)
        if r is None:
            if len(self._requests) >= self.MAX_REQUESTS:
                # drop the OLDEST half (dict preserves insertion order):
                # raw-engine callers never pop, so stale entries accrete —
                # but a wholesale clear would also wipe every in-flight
                # request's accrued chip time and under-bill its delivery
                for k in list(self._requests)[: self.MAX_REQUESTS // 2]:
                    del self._requests[k]
            r = self._requests[rid] = {
                "chip_s": 0.0, "useful_s": 0.0,
                "spec_drafted": 0.0, "spec_accepted": 0.0,
                "spec_windows": 0.0,
            }
        return r

    def discard_request(self, rid: int) -> None:
        """Drop a request that will never be delivered (gave up, deadline
        eviction, scheduler shutdown) — its attribution stays in the
        aggregate totals (the chip time WAS spent) but must not linger in
        the per-request map nor enter the completed-cost percentiles."""
        with self._lock:
            self._requests.pop(rid, None)
            self._rid_tenant.pop(rid, None)

    # ------------------------------------------------------------------
    # tenant attribution (engine/scheduler thread)
    # ------------------------------------------------------------------
    def note_tenant(self, rid: int, tenant: str) -> None:
        """Stamp the (edge-interned, cardinality-bounded) tenant a request
        belongs to; the request's chip time folds into that tenant's
        rollup when it pops. NOT gated on ``enabled``: the map also serves
        ``tenant_of`` (the engine stamps ``admit`` events from it), which
        must work with chip-time attribution off. Cheap — one dict write."""
        if tenant is None:
            return
        with self._lock:
            if len(self._rid_tenant) >= self.MAX_REQUESTS:
                for k in list(self._rid_tenant)[: self.MAX_REQUESTS // 2]:
                    del self._rid_tenant[k]
            self._rid_tenant[rid] = str(tenant)

    def tenant_of(self, rid: int) -> Optional[str]:
        """The tenant stamped for an in-flight request (None when the edge
        never stamped one) — how admit-time emit sites label events for
        requests they only know by rid."""
        with self._lock:
            return self._rid_tenant.get(rid)

    def _fold_tenant(self, tenant: str, r: Dict[str, float],
                     tokens: float) -> None:
        """Caller holds ``self._lock``."""
        roll = self._tenant_roll.get(tenant)
        if roll is None:
            if len(self._tenant_roll) >= self.MAX_TENANT_ROWS \
                    and tenant != self.OTHER_TENANT:
                cold = min(
                    (t for t in self._tenant_roll if t != self.OTHER_TENANT),
                    key=lambda t: (self._tenant_roll[t]["chip_s"], t),
                    default=None,
                )
                if cold is not None:
                    folded = self._tenant_roll.pop(cold)
                    other = self._tenant_roll.setdefault(
                        self.OTHER_TENANT,
                        {"requests": 0.0, "chip_s": 0.0, "useful_s": 0.0,
                         "tokens": 0.0, "cost_usd": 0.0},
                    )
                    for k in other:
                        other[k] += folded.get(k, 0.0)
            roll = self._tenant_roll[tenant] = {
                "requests": 0.0, "chip_s": 0.0, "useful_s": 0.0,
                "tokens": 0.0, "cost_usd": 0.0,
            }
        roll["requests"] += 1.0
        roll["chip_s"] += r["chip_s"]
        roll["useful_s"] += r["useful_s"]
        roll["tokens"] += float(tokens)
        if self.chip_hour_usd > 0:
            roll["cost_usd"] += r["chip_s"] / 3600.0 * self.chip_hour_usd

    def tenant_state(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant rollups (chip_s, cost_usd, tokens, goodput_frac) —
        the live source behind the ``rag_tenant_*`` goodput counters and
        the per-tenant conservation test (summed rollup chip_s tracks the
        ledger's attributed total, one dimension finer)."""
        with self._lock:
            out: Dict[str, Dict[str, float]] = {}
            for t, roll in self._tenant_roll.items():
                row = dict(roll)
                row["goodput_frac"] = round(
                    min(1.0, roll["useful_s"] / max(roll["chip_s"], 1e-30)), 6
                )
                out[t] = row
            return out

    def _apply(
        self,
        kind: str,
        dur_s: float,
        cat_s: Dict[str, float],
        per_request: Dict[int, float],  # rid -> useful weighted-lane share
        weight_total: float,
        flops: float,
        nbytes: float,
        tokens: float,
    ) -> Dict:
        """Fold one window into the rolling state and build the summary
        the caller journals (``flight.emit("goodput_window", **summary)``).
        ``cat_s`` values sum to ``dur_s`` exactly — the per-window
        conservation the tests pin."""
        rf = self.roofline
        mfu = rf.mfu(flops, dur_s)
        bw = rf.bw_util(nbytes, dur_s)
        bound = rf.classify(flops, nbytes)
        n_req = len(per_request)
        with self._lock:
            self._busy_s += dur_s
            for c, v in cat_s.items():
                self._cat_s[c] += v
            ks = self._kinds.setdefault(kind, {
                "busy_s": 0.0, "windows": 0.0, "tokens": 0.0,
                "mfu_w": 0.0, "bw_w": 0.0, "flops": 0.0, "bytes": 0.0,
            })
            ks["busy_s"] += dur_s
            ks["windows"] += 1
            ks["tokens"] += tokens
            ks["mfu_w"] += mfu * dur_s
            ks["bw_w"] += bw * dur_s
            ks["flops"] += flops
            ks["bytes"] += nbytes
            ks["bound"] = bound  # static per kind in practice
            if n_req:
                share = dur_s / n_req
                for rid, useful_w in per_request.items():
                    r = self._req(rid)
                    r["chip_s"] += share
                    if weight_total > 0:
                        r["useful_s"] += dur_s * useful_w / weight_total
                self._attributed_s += dur_s
        summary = {
            "kind": kind,
            "dur_ms": round(dur_s * 1e3, 4),
            "active": n_req,
            "tokens": int(tokens),
            "mfu": round(mfu, 6),
            "bw": round(bw, 6),
            "bound": bound,
        }
        for c, v in cat_s.items():
            if v > 0:
                summary[c] = round(v * 1e3, 4)
        return summary

    @staticmethod
    def _split(dur_s: float, weights: Dict[str, float]) -> Tuple[Dict[str, float], float]:
        """Weights → per-category chip-seconds summing to ``dur_s``."""
        total = sum(v for v in weights.values() if v > 0)
        if total <= 0:
            return {"padding_bubble": dur_s}, 0.0
        return (
            {c: dur_s * v / total for c, v in weights.items() if v > 0},
            total,
        )

    def record_decode(
        self,
        dur_s: float,
        batch: int,
        steps: int,
        kept: Dict[int, int],
        ctx_tokens: int = 0,
    ) -> Optional[Dict]:
        """One plain decode sync window: ``batch × steps`` token lanes;
        ``kept[rid]`` = tokens the host drain kept for each request that
        was active at dispatch. Everything else — inactive rows, post-EOS
        lanes, over-budget lanes — is padding bubble."""
        if not self.enabled or dur_s <= 0:
            return None
        lanes = max(1, batch * steps)
        useful = sum(kept.values())
        cat_s, total = self._split(dur_s, {
            "decode_useful": float(useful),
            "padding_bubble": float(lanes - useful),
        })
        rf = self.roofline
        flops = rf.flops_per_token * useful
        nbytes = steps * (rf.weight_bytes + ctx_tokens * rf.kv_bytes_per_token)
        with self._lock:
            self._useful_decode_tokens += useful
        return self._apply(
            "decode", dur_s, cat_s,
            {rid: float(n) for rid, n in kept.items()}, total,
            flops, nbytes, float(useful),
        )

    def record_verify(
        self,
        dur_s: float,
        batch: int,
        lanes_per_row: int,
        rows: Dict[int, Tuple[int, int, int]],  # rid -> (kept, offered, accepted)
        ctx_tokens: int = 0,
    ) -> Optional[Dict]:
        """One speculative verify window: ``batch × (K+1)`` lanes; a row's
        accepted+correction lanes are useful, drafted-but-rejected lanes
        are ``spec_rejected`` (real compute, discarded result), the rest is
        bubble. Per-row draft outcomes also accumulate into the request's
        speculation stats (``/generate`` timings satellite)."""
        if not self.enabled or dur_s <= 0:
            return None
        lanes = max(1, batch * lanes_per_row)
        useful = sum(k for k, _, _ in rows.values())
        rejected = sum(max(0, o - a) for _, o, a in rows.values())
        cat_s, total = self._split(dur_s, {
            "decode_useful": float(useful),
            "spec_rejected": float(rejected),
            "padding_bubble": float(lanes - useful - rejected),
        })
        rf = self.roofline
        flops = rf.flops_per_token * (useful + rejected)
        nbytes = rf.weight_bytes + ctx_tokens * rf.kv_bytes_per_token
        with self._lock:
            self._useful_decode_tokens += useful
            for rid, (_, offered, accepted) in rows.items():
                r = self._req(rid)
                r["spec_drafted"] += offered
                r["spec_accepted"] += accepted
                if offered > 0:
                    r["spec_windows"] += 1
        return self._apply(
            "verify", dur_s, cat_s,
            {rid: float(k) for rid, (k, _, _) in rows.items()}, total,
            flops, nbytes, float(useful),
        )

    def record_preempt_stall(
        self, dur_s: float, rids: Sequence[int], kind: str = "decode"
    ) -> Optional[Dict]:
        """Pool-pressure churn that ran no lanes but kept the scheduler
        busy: a window that preempted EVERY active row before dispatch
        (the step's early return, kind="decode"), or an admission chunk
        the exhausted pool bounced back to the queue (kind="prefill") —
        attributed wholesale to ``preempt_rework`` and split across the
        requests whose churn consumed it, so the conservation invariant
        survives pool storms. Zero flops/bytes: a stalled attempt
        honestly drags the MFU of the kind it cost."""
        if not self.enabled or dur_s <= 0:
            return None
        return self._apply(
            kind, dur_s, {"preempt_rework": dur_s},
            {rid: 0.0 for rid in rids}, 0.0, 0.0, 0.0, 0.0,
        )

    def record_prefill(
        self,
        dur_s: float,
        bucket: int,
        rows: Dict[int, int],  # rid -> computed prompt tokens
        rework: Optional[Set[int]] = None,
    ) -> Optional[Dict]:
        """One batched admission prefill: ``len(rows) × bucket`` lanes.
        Real prompt tokens are ``prefill_compute`` — unless the request is
        a preemption/reset resubmission, whose re-fed tokens were already
        computed once and count as ``preempt_rework`` (attributed exactly
        once, at the re-feeding admission); right-pad slack is bubble."""
        if not self.enabled or dur_s <= 0 or not rows:
            return None
        rework = rework or set()
        lanes = max(1, bucket * len(rows))
        computed = sum(n for rid, n in rows.items() if rid not in rework)
        refed = sum(n for rid, n in rows.items() if rid in rework)
        cat_s, total = self._split(dur_s, {
            "prefill_compute": float(computed),
            "preempt_rework": float(refed),
            "padding_bubble": float(lanes - computed - refed),
        })
        rf = self.roofline
        flops = rf.flops_per_token * (computed + refed)
        nbytes = rf.weight_bytes
        return self._apply(
            "prefill", dur_s, cat_s,
            {rid: (0.0 if rid in rework else float(n))
             for rid, n in rows.items()},
            total, flops, nbytes, float(computed + refed),
        )

    def record_prefill_px(
        self,
        dur_s: float,
        bucket: int,
        rid: int,
        computed: int,
        skipped: int,
        rework: bool = False,
    ) -> Optional[Dict]:
        """One prefixed admission: only the ``computed``-token suffix ran
        the model; the ``skipped`` prefix tokens were SERVED by a
        splice/scatter whose lane weight is the roofline's copy-vs-compute
        ratio (``prefill_skipped`` — the cheap residue of the prefill the
        cache avoided). Suffix pad is bubble."""
        if not self.enabled or dur_s <= 0:
            return None
        w_skip = self.roofline.splice_weight * max(0, skipped)
        key = "preempt_rework" if rework else "prefill_compute"
        cat_s, total = self._split(dur_s, {
            key: float(computed),
            "prefill_skipped": w_skip,
            "padding_bubble": float(max(0, bucket - computed)),
        })
        rf = self.roofline
        flops = rf.flops_per_token * computed
        nbytes = rf.weight_bytes + 2.0 * rf.kv_bytes_per_token * max(0, skipped)
        useful_w = (0.0 if rework else float(computed)) + w_skip
        return self._apply(
            "prefill_px", dur_s, cat_s, {rid: useful_w}, total,
            flops, nbytes, float(computed),
        )

    def record_oneshot(
        self,
        dur_s: float,
        bucket: int,
        batch: int,
        computed_tokens: int,
        decode_tokens: int,
        decode_steps: int,
        skipped: int = 0,
    ) -> Optional[Dict]:
        """One one-shot ``generate`` call (prefill + decode fused into one
        device program): the roofline model splits the measured duration
        into a prefill share (compute-bound: computed tokens ×
        t_compute) and a decode share (bandwidth-bound: steps × weight
        stream), then each sub-window decomposes like its continuous
        twin. Returns the summary plus ``chip_ms_per_row`` /
        ``goodput_frac`` for the caller's per-request timings."""
        if not self.enabled or dur_s <= 0:
            return None
        rf = self.roofline
        pad = max(0, batch * bucket - computed_tokens - skipped)
        t_pref = (
            computed_tokens * rf.t_compute_token + skipped * rf.t_copy_token
        )
        t_dec = max(0, decode_steps) * rf.weight_bytes / rf.peak_bytes
        est = t_pref + t_dec
        dur_p = dur_s * (t_pref / est) if est > 0 else dur_s
        dur_d = dur_s - dur_p
        cat_p, tot_p = self._split(dur_p, {
            "prefill_compute": float(computed_tokens),
            "prefill_skipped": rf.splice_weight * max(0, skipped),
            "padding_bubble": float(pad),
        })
        dec_lanes = max(1, batch * max(1, decode_steps))
        cat_d, tot_d = self._split(dur_d, {
            "decode_useful": float(decode_tokens),
            "padding_bubble": float(dec_lanes - decode_tokens),
        })
        cat_s = dict(cat_p)
        for c, v in cat_d.items():
            cat_s[c] = cat_s.get(c, 0.0) + v
        flops = rf.flops_per_token * (computed_tokens + decode_tokens)
        nbytes = (
            rf.weight_bytes * (1 + max(0, decode_steps))
            + 2.0 * rf.kv_bytes_per_token * max(0, skipped)
        )
        with self._lock:
            self._useful_decode_tokens += decode_tokens
        useful_s = (
            (dur_p * (cat_p.get("prefill_compute", 0.0)
                      + cat_p.get("prefill_skipped", 0.0)) / max(dur_p, 1e-30))
            + cat_d.get("decode_useful", 0.0)
        )
        summary = self._apply(
            "oneshot", dur_s, cat_s, {}, 0.0,
            flops, nbytes, float(computed_tokens + decode_tokens),
        )
        # the decode share alone, so the offline reconstruction counts the
        # same useful-decode-token total the live ledger does
        summary["decode_tokens"] = int(decode_tokens)
        summary["chip_ms_per_row"] = round(dur_s * 1e3 / max(batch, 1), 4)
        summary["goodput_frac"] = round(
            min(1.0, useful_s / max(dur_s, 1e-30)), 6
        )
        return summary

    def record_mixed(
        self,
        dur_s: float,
        batch: int,
        lanes: int,
        decode_kept: Dict[int, int],  # rid -> decode tokens the drain kept
        chunk_rows: Dict[int, int],  # rid -> prefill tokens fed this window
        rework: Optional[Set[int]] = None,
        ctx_tokens: int = 0,
    ) -> Optional[Dict]:
        """One UNIFIED ragged sync window: ``batch × lanes``
        lane grid, where each active decode row used exactly one real lane
        and each scheduled admission used its chunk's ``chunk_rows[rid]``
        lanes. Decode lanes that kept their token are ``decode_useful``;
        chunked-prefill lanes are ``prefill_compute`` — the whole point of
        the mixed window is that these lanes STOP being the
        ``padding_bubble`` the phase-separated scheduler burned — unless
        the admission is a preemption/reset resubmission
        (``preempt_rework``, attributed exactly once, same rule as
        ``record_prefill``). Everything else in the grid is bubble.
        Conservation is exact by ``_split``; only decode tokens feed the
        useful-decode throughput figure (prompt tokens never did)."""
        if not self.enabled or dur_s <= 0:
            return None
        rework = rework or set()
        grid = max(1, batch * max(1, lanes))
        useful = sum(decode_kept.values())
        computed = sum(
            n for rid, n in chunk_rows.items() if rid not in rework
        )
        refed = sum(n for rid, n in chunk_rows.items() if rid in rework)
        cat_s, total = self._split(dur_s, {
            "decode_useful": float(useful),
            "prefill_compute": float(computed),
            "preempt_rework": float(refed),
            "padding_bubble": float(grid - useful - computed - refed),
        })
        rf = self.roofline
        flops = rf.flops_per_token * (useful + computed + refed)
        nbytes = rf.weight_bytes + ctx_tokens * rf.kv_bytes_per_token
        with self._lock:
            self._useful_decode_tokens += useful
        per_request = {rid: float(n) for rid, n in decode_kept.items()}
        for rid, n in chunk_rows.items():
            per_request[rid] = per_request.get(rid, 0.0) + (
                0.0 if rid in rework else float(n)
            )
        summary = self._apply(
            "mixed", dur_s, cat_s, per_request, total,
            flops, nbytes, float(useful + computed + refed),
        )
        # the decode share alone (record_oneshot's convention), so the
        # offline reconstruction counts the same useful-decode-token total
        # the live ledger does
        summary["decode_tokens"] = int(useful)
        return summary

    # ------------------------------------------------------------------
    # per-request attribution (engine/scheduler thread)
    # ------------------------------------------------------------------
    def pop_request(self, rid: int,
                    tokens: float = 0.0) -> Optional[Dict[str, float]]:
        """A completed request's attributed figures (None when the ledger
        is disabled or the request never touched it): ``chip_ms``,
        ``goodput_frac``, ``cost_usd`` (when a chip-hour price is set),
        and the speculation stats when the request ever drafted. Feeds the
        /generate timings block; also stamps the completed-cost ring the
        per-query percentiles read. ``tokens`` (the delivered count, known
        only to the caller) feeds the tenant rollup when the request was
        ``note_tenant``-stamped."""
        with self._lock:
            r = self._requests.pop(rid, None)
            tenant = self._rid_tenant.pop(rid, None)
            if r is None:
                return None
            self._completed.append(r["chip_s"])
            if tenant is not None:
                self._fold_tenant(tenant, r, tokens)
        out = {
            "chip_ms": round(r["chip_s"] * 1e3, 4),
            "goodput_frac": round(
                min(1.0, r["useful_s"] / max(r["chip_s"], 1e-30)), 6
            ),
        }
        if self.chip_hour_usd > 0:
            out["cost_usd"] = r["chip_s"] / 3600.0 * self.chip_hour_usd
        if r["spec_windows"] > 0 or r["spec_drafted"] > 0:
            out["spec_drafted"] = int(r["spec_drafted"])
            out["spec_accepted"] = int(r["spec_accepted"])
            out["spec_accept_len_mean"] = round(
                r["spec_accepted"] / max(r["spec_windows"], 1.0), 4
            )
        return out

    # ------------------------------------------------------------------
    # reading (any thread)
    # ------------------------------------------------------------------
    def state(self) -> Dict:
        """A plain-dict snapshot of the rolling state — the mergeable/
        renderable form shared with the offline reconstruction."""
        with self._lock:
            return {
                "wall_s": time.monotonic() - self._t0,
                "busy_s": self._busy_s,
                "attributed_s": self._attributed_s,
                "useful_decode_tokens": self._useful_decode_tokens,
                "categories": dict(self._cat_s),
                "kinds": {k: dict(v) for k, v in self._kinds.items()},
                "request_chip_s": list(self._completed),
            }


# ---------------------------------------------------------------------------
# shared report plumbing (live ledger AND offline journal reconstruction)
# ---------------------------------------------------------------------------

def _empty_state() -> Dict:
    return {
        "wall_s": 0.0, "busy_s": 0.0, "attributed_s": 0.0,
        "useful_decode_tokens": 0.0,
        "categories": {c: 0.0 for c in WINDOW_CATEGORIES},
        "kinds": {}, "request_chip_s": [],
    }


def merge_states(states: Iterable[Dict]) -> Dict:
    """Sum several ledgers' states (the service serves one report over
    BOTH engines — continuous and one-shot). ``wall_s`` takes the max:
    the engines share one wall clock."""
    out = _empty_state()
    for st in states:
        out["wall_s"] = max(out["wall_s"], float(st.get("wall_s", 0.0)))
        out["busy_s"] += float(st.get("busy_s", 0.0))
        out["attributed_s"] += float(st.get("attributed_s", 0.0))
        out["useful_decode_tokens"] += float(
            st.get("useful_decode_tokens", 0.0)
        )
        for c, v in (st.get("categories") or {}).items():
            out["categories"][c] = out["categories"].get(c, 0.0) + float(v)
        for kind, ks in (st.get("kinds") or {}).items():
            dst = out["kinds"].setdefault(kind, {
                "busy_s": 0.0, "windows": 0.0, "tokens": 0.0,
                "mfu_w": 0.0, "bw_w": 0.0, "flops": 0.0, "bytes": 0.0,
            })
            for f in ("busy_s", "windows", "tokens", "mfu_w", "bw_w",
                      "flops", "bytes"):
                dst[f] += float(ks.get(f, 0.0))
            if "bound" in ks:
                dst["bound"] = ks["bound"]
        out["request_chip_s"].extend(st.get("request_chip_s") or [])
    return out


def state_from_events(events: Sequence[Dict]) -> Dict:
    """Rebuild the mergeable state from a flight journal's
    ``goodput_window`` (+ ``complete``) events — the journal's half of
    the same-report contract with ``GET /debug/goodput``. Events carry
    per-window category chip-ms and precomputed mfu/bw, so no model
    config is needed."""
    st = _empty_state()
    t_lo = t_hi = None
    for e in events:
        t = e.get("t")
        if t is not None:
            t_lo = t if t_lo is None else min(t_lo, t)
            t_hi = t if t_hi is None else max(t_hi, t)
        etype = e.get("type")
        if etype == "complete":
            if "chip_ms" in e:
                st["request_chip_s"].append(float(e["chip_ms"]) / 1e3)
            continue
        if etype != "goodput_window":
            continue
        dur_s = float(e.get("dur_ms", 0.0)) / 1e3
        kind = e.get("kind", "decode")
        st["busy_s"] += dur_s
        if int(e.get("active", 0)) > 0:
            st["attributed_s"] += dur_s
        for c in WINDOW_CATEGORIES:
            if c in e:
                st["categories"][c] += float(e[c]) / 1e3
        ks = st["kinds"].setdefault(kind, {
            "busy_s": 0.0, "windows": 0.0, "tokens": 0.0,
            "mfu_w": 0.0, "bw_w": 0.0, "flops": 0.0, "bytes": 0.0,
        })
        ks["busy_s"] += dur_s
        ks["windows"] += 1
        ks["tokens"] += float(e.get("tokens", 0.0))
        ks["mfu_w"] += float(e.get("mfu", 0.0)) * dur_s
        ks["bw_w"] += float(e.get("bw", 0.0)) * dur_s
        if "bound" in e:
            ks["bound"] = e["bound"]
        if kind in ("decode", "verify"):
            st["useful_decode_tokens"] += float(e.get("tokens", 0.0))
        elif kind in ("oneshot", "mixed"):
            # both carry prefill AND decode lanes in one window; the
            # summary stamps the decode share separately
            st["useful_decode_tokens"] += float(e.get("decode_tokens", 0.0))
    if t_lo is not None:
        st["wall_s"] = max(st["busy_s"], float(t_hi) - float(t_lo))
    return st


def render_report(state: Dict, chip_hour_usd: float = 0.0) -> Dict:
    """The capacity picture — ONE renderer for both sources (live ledger
    state, a journal's reconstruction), so the two cannot drift apart."""
    busy = float(state.get("busy_s", 0.0))
    wall = max(float(state.get("wall_s", 0.0)), busy)
    idle = max(0.0, wall - busy)
    cats = {}
    for c in WINDOW_CATEGORIES:
        v = float(state.get("categories", {}).get(c, 0.0))
        cats[c] = {
            "chip_s": round(v, 6),
            "frac": round(v / busy, 6) if busy > 0 else 0.0,
        }
    cats["idle"] = {
        "chip_s": round(idle, 6),
        "frac": round(idle / wall, 6) if wall > 0 else 0.0,
    }
    kinds = {}
    for kind, ks in (state.get("kinds") or {}).items():
        kb = float(ks.get("busy_s", 0.0))
        kinds[kind] = {
            "windows": int(ks.get("windows", 0)),
            "busy_s": round(kb, 6),
            "tokens": int(ks.get("tokens", 0)),
            "mfu": round(float(ks.get("mfu_w", 0.0)) / kb, 6) if kb > 0 else 0.0,
            "bw_util": round(float(ks.get("bw_w", 0.0)) / kb, 6) if kb > 0 else 0.0,
            "bound": ks.get("bound", "unknown"),
        }
    price = max(0.0, float(chip_hour_usd))
    per_query: List[float] = [
        float(v) for v in state.get("request_chip_s") or []
    ]
    usd_per_s = price / 3600.0
    tokens = float(state.get("useful_decode_tokens", 0.0))
    wall_usd = wall * usd_per_s
    cost = {
        "chip_hour_usd": price,
        "wall_usd": round(wall_usd, 8),
        "busy_usd": round(busy * usd_per_s, 8),
        "tokens_per_usd": round(tokens / wall_usd, 2) if wall_usd > 0 else 0.0,
        "per_query_chip_ms": {
            "p50": round((_percentile(per_query, 0.50) or 0.0) * 1e3, 4),
            "p95": round((_percentile(per_query, 0.95) or 0.0) * 1e3, 4),
            "n": len(per_query),
        },
    }
    if price > 0:
        cost["per_query_usd"] = {
            "p50": round((_percentile(per_query, 0.50) or 0.0) * usd_per_s, 8),
            "p95": round((_percentile(per_query, 0.95) or 0.0) * usd_per_s, 8),
        }
    attributed = float(state.get("attributed_s", 0.0))
    return {
        "schema_version": 1,
        "wall_s": round(wall, 4),
        "busy_s": round(busy, 6),
        "idle_s": round(idle, 4),
        "busy_frac": round(busy / wall, 6) if wall > 0 else 0.0,
        "categories": cats,
        "kinds": kinds,
        "cost": cost,
        # live sanity mirror of the tested invariant: chip-seconds handed
        # to requests over chip-seconds windows with requests present
        "conservation": {
            "attributed_s": round(attributed, 6),
            "busy_s": round(busy, 6),
            "ratio": round(attributed / busy, 6) if busy > 0 else 1.0,
        },
    }
