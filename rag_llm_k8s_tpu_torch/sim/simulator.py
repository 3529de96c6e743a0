"""Host-only scheduler simulator, the port's copy of
``rag_llm_k8s_tpu/sim/simulator.py``: the decision core on a virtual clock.

``SimEngine`` answers the surface ``sim/replay.py``'s ``LockstepDriver``
drives the port's ``ContinuousEngine`` through (``admission_state``,
``free_slots``, ``admit_many``, ``step``, ``drain_preempted``,
``has_active``, ``slots``, ``reset``, ``buckets``), but every decision comes
from ``sim/policy.py`` (the functions the live engine delegates to) and
every window's duration from a step model instead of a device:

- ``RooflineStepModel`` prices windows analytically from the ledger's
  ``RooflineModel`` (what-ifs from first principles; the H100's peaks by
  default);
- ``CalibratedStepModel.from_journal`` fits per-kind window durations to a
  measured journal's ``goodput_window`` events (capacity planning anchored
  to a deployment one has).

The simulator writes a flight-schema journal (``admit``,
``sync_window_open`` / ``close``, ``block_grow``, ``preempt``, ``eos``,
``goodput_window`` through a real ``GoodputLedger`` fed virtual durations,
``complete``) with virtual timestamps, so ``goodput.render_report``,
``tenants.render_report`` and ``replay.diff_journals`` read it unchanged.
``simulate()`` runs trace, driver and report, and measures the virtual time
over the wall time it took (``speedup_x``). ``split_chip_time`` and
``pool_plan`` size a disaggregated deployment from any journal.

What it models: the paged one-shot admission path (bucketed grouped
prefill), fixed-horizon decode sync windows, block growth, pool-exhaustion
preemption and resume. What it does not: the interleaved chunked-prefill
planner (``policy.plan_mixed_window`` is pure and tested, but ``SimEngine``
has no mixed-window executor), speculative verify windows and chaos
resets, as in the JAX module. Standard library only, and the port's own
``obs/goodput.py`` and ``obs/tenants.py``.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from rag_llm_k8s_tpu_torch.obs import goodput as _goodput
from rag_llm_k8s_tpu_torch.obs import tenants as _tenants
from rag_llm_k8s_tpu_torch.sim import policy
from rag_llm_k8s_tpu_torch.sim.replay import LockstepDriver


class PoolExhausted(RuntimeError):
    """Name-matched by the driver's requeue path (the driver reads engines
    by duck typing, so it matches the exception by its name)."""


def llama8b_roofline(
    peak_tflops: float = 0.0, hbm_gbs: float = 0.0
) -> "object":
    """A Llama-3-8B-shaped ``RooflineModel``, the default card and model
    arithmetic when the caller plans capacity without a config in hand. A
    peak left at 0 is the ledger's default: the H100 SXM's dense bf16
    989 TFLOP/s and 3,350 GB/s (``obs/goodput.py``)."""
    return _goodput.roofline_for_llama(
        num_layers=32, hidden_size=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, intermediate_size=14336, vocab_size=128256,
        peak_tflops=peak_tflops, hbm_gbs=hbm_gbs,
    )


# ----------------------------------------------------------------------
# step models (virtual window durations)
# ----------------------------------------------------------------------

class RooflineStepModel:
    """Analytic window durations: ``overhead + max(compute, memory)`` at a
    derated fraction of the roofline's peaks, the arithmetic the ledger
    scores real windows with, inverted into a duration. ``efficiency``
    derates both peaks (real kernels do not reach the roofline);
    ``overhead_s`` is the per-window dispatch floor."""

    def __init__(self, roofline, overhead_s: float = 200e-6,
                 efficiency: float = 0.5):
        self.roofline = roofline
        self.overhead_s = max(0.0, float(overhead_s))
        self.efficiency = min(1.0, max(1e-3, float(efficiency)))

    def _dur(self, flops: float, nbytes: float) -> float:
        rf = self.roofline
        eff = self.efficiency
        return self.overhead_s + max(
            flops / (rf.peak_flops * eff), nbytes / (rf.peak_bytes * eff)
        )

    def decode(self, steps: int, useful: int, ctx_tokens: int) -> float:
        rf = self.roofline
        return self._dur(
            rf.flops_per_token * useful,
            steps * (rf.weight_bytes + ctx_tokens * rf.kv_bytes_per_token),
        )

    def prefill(self, bucket: int, rows: int, tokens: int) -> float:
        # padded lanes burn real compute even when they are bubble
        rf = self.roofline
        return self._dur(
            rf.flops_per_token * max(int(bucket) * int(rows), int(tokens)),
            rf.weight_bytes,
        )

    def stall(self) -> float:
        return self.overhead_s


class CalibratedStepModel:
    """Per-kind window durations fitted from a MEASURED journal's
    ``goodput_window`` events: for each kind, a least-squares line
    ``dur_ms = a + b * tokens`` (collapsing to the kind's mean when the
    recording has no token spread). Simulating a recorded deployment back
    through its own fit checks the simulator's decode steps/s against the
    recording's; changing the load against the same fit is capacity
    planning."""

    DEFAULT_MS = 1.0

    def __init__(self, coeffs: Dict[str, Tuple[float, float]],
                 stall_ms: float = 0.1):
        self.coeffs = dict(coeffs)
        self.stall_ms = float(stall_ms)

    @classmethod
    def from_journal(cls, events: Iterable[Dict]) -> "CalibratedStepModel":
        samples: Dict[str, List[Tuple[float, float]]] = {}
        stall: List[float] = []
        for e in events:
            if not isinstance(e, dict) or e.get("type") != "goodput_window":
                continue
            dur = float(e.get("dur_ms", 0.0))
            if dur <= 0:
                continue
            tokens = float(e.get("tokens", 0.0))
            if tokens <= 0 and "preempt_rework" in e:
                stall.append(dur)
                continue
            samples.setdefault(e.get("kind", "decode"), []).append(
                (tokens, dur)
            )
        coeffs: Dict[str, Tuple[float, float]] = {}
        for kind, pts in samples.items():
            coeffs[kind] = cls._fit(pts)
        stall_ms = (sum(stall) / len(stall)) if stall else 0.1
        return cls(coeffs, stall_ms=stall_ms)

    @staticmethod
    def _fit(pts: Sequence[Tuple[float, float]]) -> Tuple[float, float]:
        n = len(pts)
        mean_d = sum(d for _, d in pts) / n
        xs = {x for x, _ in pts}
        if n < 2 or len(xs) < 2:
            return (mean_d, 0.0)
        mean_x = sum(x for x, _ in pts) / n
        sxx = sum((x - mean_x) ** 2 for x, _ in pts)
        sxy = sum((x - mean_x) * (d - mean_d) for x, d in pts)
        b = sxy / sxx
        a = mean_d - b * mean_x
        if b < 0:  # noisy recording: a negative slope predicts garbage
            return (mean_d, 0.0)
        return (a, b)

    def _pred_ms(self, kind: str, tokens: float) -> float:
        c = self.coeffs.get(kind)
        if c is None:
            if self.coeffs:  # nearest thing to a prior: the global mean
                c_vals = list(self.coeffs.values())
                c = (sum(a for a, _ in c_vals) / len(c_vals),
                     sum(b for _, b in c_vals) / len(c_vals))
            else:
                return self.DEFAULT_MS
        return max(1e-3, c[0] + c[1] * float(tokens))

    def decode(self, steps: int, useful: int, ctx_tokens: int) -> float:
        return self._pred_ms("decode", useful) / 1e3

    def prefill(self, bucket: int, rows: int, tokens: int) -> float:
        return self._pred_ms("prefill", tokens) / 1e3

    def stall(self) -> float:
        return max(1e-6, self.stall_ms / 1e3)


# ----------------------------------------------------------------------
# the virtual engine
# ----------------------------------------------------------------------

class _SimSlot:
    __slots__ = ("active", "prefilling", "request_id", "tokens",
                 "remaining", "kv_ub", "admit_seq")

    def __init__(self):
        self.active = False
        self.prefilling = False
        self.request_id = -1
        self.tokens: List[int] = []
        self.remaining = 0
        self.kv_ub = 0
        self.admit_seq = 0


class SimEngine:
    """A virtual paged continuous engine: policy decisions and modeled
    durations, no device. ``LockstepDriver`` drives it exactly like the real
    engine; every scheduler-visible event lands in
    ``self.journal`` with virtual timestamps (``t`` = seconds of modeled
    chip time since construction)."""

    def __init__(
        self,
        buckets: Sequence[int] = (128, 256, 512),
        max_batch_size: int = 8,
        max_seq_len: int = 1024,
        block_size: int = 16,
        pool_blocks: Optional[int] = None,
        decode_sync_steps: int = 1,
        step_model=None,
        roofline=None,
        chip_hour_usd: float = 0.0,
        eos_token_ids: Sequence[int] = (),
        out_len: Optional[Dict[int, int]] = None,
    ):
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.B = int(max_batch_size)
        self.T = int(max_seq_len)
        self.block_size = int(block_size)
        self.MB = policy.blocks_for(self.T, self.block_size)
        self.pool_blocks = (
            int(pool_blocks) if pool_blocks is not None
            else self.MB * self.B
        )
        self.k = max(1, int(decode_sync_steps))
        rf = roofline if roofline is not None else llama8b_roofline()
        self.ledger = _goodput.GoodputLedger(
            rf, enabled=True, chip_hour_usd=chip_hour_usd
        )
        self.step_model = (
            step_model if step_model is not None
            else RooflineStepModel(rf)
        )
        self.chip_hour_usd = float(chip_hour_usd)
        self.eos_token_ids = frozenset(int(x) for x in eos_token_ids)
        self.out_len: Dict[int, int] = dict(out_len or {})
        self.slots: List[_SimSlot] = [_SimSlot() for _ in range(self.B)]
        self._slot_blocks = [0] * self.B
        self._free_blocks = self.pool_blocks
        self._admit_seq = 0
        self._preempted: List[Tuple[int, List[int]]] = []
        self._rework: set = set()
        self._blocks_at_retire: Dict[int, int] = {}
        self.journal: List[Dict] = []
        self._seq = 0
        self.t = 0.0  # virtual seconds of modeled chip time
        self.windows = 0
        self.decode_steps = 0

    # -- journal ------------------------------------------------------
    def emit(self, etype: str, rid: Optional[int] = None, **attrs) -> None:
        """Flight-schema event with a VIRTUAL timestamp. Also the
        ``emit`` callable handed to the driver, so scheduler-level
        events (arrival/resubmit/complete) interleave in sequence."""
        self._seq += 1
        ev: Dict = {"seq": self._seq, "t": round(self.t, 9), "type": etype}
        if rid is not None:
            ev["rid"] = rid
        ev.update(attrs)
        self.journal.append(ev)

    def _advance(self, dur_s: float, summary: Optional[Dict]) -> None:
        self.t += max(0.0, float(dur_s))
        if summary is not None:
            self.emit("goodput_window", **summary)

    # -- driver surface ------------------------------------------------
    def has_active(self) -> bool:
        return any(s.active for s in self.slots)

    def free_slots(self) -> List[int]:
        return [r for r, s in enumerate(self.slots)
                if not s.active and not s.prefilling]

    def admission_state(self, prompt_len: int) -> str:
        need = policy.admission_blocks(prompt_len, self.block_size)
        verdict, want = policy.admission_verdict(
            need, self.pool_blocks, False, self.MB
        )
        if verdict != "check":
            return verdict
        return "ok" if want <= self._free_blocks else "wait"

    def admit_many(self, items: Sequence[Tuple]) -> List:
        """Grouped one-shot admission, the real scheduler's shape:
        bucket + clamp, chunk by ``policy.admission_chunks``, one modeled
        prefill window per chunk. Per-item results align with ``items``:
        ``(row, finished_or_None)`` or an exception instance."""
        prepared = []
        for j, (rid, prompt, max_new, seed) in enumerate(items):
            p = list(prompt)
            S = policy.bucket_len(len(p), self.buckets)
            if len(p) > S:
                p = p[-S:]  # left-truncate, the engine's discipline
            mx = policy.clamp_max_new(int(max_new), S, self.T)
            prepared.append((j, rid, p, S, mx))
        results: List = [None] * len(items)
        free = iter(self.free_slots())
        for S, member_idx in policy.admission_chunks(
            [(i, e[3]) for i, e in enumerate(prepared)], self.B
        ):
            chunk = [prepared[i] for i in member_idx]
            admitted = []
            for j, rid, p, _, mx in chunk:
                need = policy.admission_blocks(len(p), self.block_size)
                _, want = policy.admission_verdict(
                    need, self.pool_blocks, False, self.MB
                )
                if want > self._free_blocks:
                    results[j] = PoolExhausted(
                        f"sim pool: {want} blocks wanted, "
                        f"{self._free_blocks} free"
                    )
                    continue
                row = next(free)
                self._free_blocks -= want
                self._slot_blocks[row] = want
                admitted.append((j, rid, p, mx, row))
            if not admitted:
                continue
            rows_led = {rid: len(p) for _, rid, p, _, _ in admitted}
            rework = {rid for rid in rows_led if rid in self._rework}
            self._rework -= rework
            dur = self.step_model.prefill(
                S, len(admitted), sum(rows_led.values())
            )
            self._advance(dur, self.ledger.record_prefill(
                dur, S, rows_led, rework=rework
            ))
            for j, rid, p, mx, row in admitted:
                tok0 = self._tok(rid, 0)
                tn = self.ledger.tenant_of(rid)
                self.emit("admit", rid, slot=row, prompt_len=len(p),
                          bucket=S, tok0=tok0,
                          **({"tenant": tn} if tn else {}))
                target = mx
                if rid in self.out_len:  # recorded generation length
                    target = max(1, min(mx, int(self.out_len[rid])))
                if target <= 1:
                    self._blocks_at_retire[rid] = self._slot_blocks[row]
                    self._release_row(row)
                    results[j] = (row, [tok0])
                    continue
                self._admit_seq += 1
                s = self.slots[row]
                s.active = True
                s.request_id = rid
                s.tokens = [tok0]
                s.remaining = target - 1
                s.kv_ub = len(p) + 1
                s.admit_seq = self._admit_seq
                results[j] = (row, None)
        return results

    def step(self) -> List[Tuple[int, List[int]]]:
        """One decode sync window of ``decode_sync_steps`` virtual steps:
        grow block tables (preempting newest-first under exhaustion,
        the live discipline), emit every active row's tokens, retire
        budget-exhausted rows."""
        active = [(r, s) for r, s in enumerate(self.slots) if s.active]
        if not active:
            return []
        # ---- growth (policy.grow_shortfall), preempt on exhaustion ----
        while True:
            active = [(r, s) for r, s in enumerate(self.slots) if s.active]
            if not active:
                dur = self.step_model.stall()
                self._advance(dur, self.ledger.record_preempt_stall(
                    dur, [rid for rid, _ in self._preempted]
                ))
                self.windows += 1
                return []
            short = policy.grow_shortfall(
                ((s.admit_seq, r, s.kv_ub, self._slot_blocks[r])
                 for r, s in active),
                self.k, None, self.block_size, self.MB,
            )
            need = sum(m for _, _, m, _ in short)
            if need <= self._free_blocks:
                for _, row, missing, have in short:
                    self._free_blocks -= missing
                    self._slot_blocks[row] = have + missing
                    self.emit("block_grow", self.slots[row].request_id,
                              blocks=missing, total=have + missing)
                break
            _, victim = policy.preempt_victim(
                (s.admit_seq, r) for r, s in active
            )
            vslot = self.slots[victim]
            self._preempted.append((vslot.request_id, list(vslot.tokens)))
            self.emit("preempt", vslot.request_id,
                      blocks=self._slot_blocks[victim],
                      n_tokens=len(vslot.tokens))
            self._release_row(victim)
        # ---- dispatch + drain (virtual) -------------------------------
        active = [(r, s) for r, s in enumerate(self.slots) if s.active]
        k = self.k
        self.emit("sync_window_open", steps=k, active=len(active))
        ctx = sum(s.kv_ub for _, s in active)
        done: List[Tuple[int, List[int]]] = []
        kept: Dict[int, int] = {}
        for row, s in active:
            take = min(k, s.remaining)
            for i in range(take):
                s.tokens.append(self._tok(s.request_id, len(s.tokens)))
            kept[s.request_id] = take
            s.remaining -= take
            s.kv_ub += take
            if s.remaining <= 0:
                done.append((s.request_id, s.tokens))
                self.emit("eos", s.request_id, reason="budget",
                          n_tokens=len(s.tokens))
                self._blocks_at_retire[s.request_id] = self._slot_blocks[row]
                self._release_row(row)
        dur = self.step_model.decode(k, sum(kept.values()), ctx)
        self._advance(dur, self.ledger.record_decode(
            dur, batch=self.B, steps=k, kept=kept, ctx_tokens=ctx
        ))
        self.emit("sync_window_close", steps=k, done=len(done),
                  duration_ms=round(dur * 1e3, 3))
        self.windows += 1
        self.decode_steps += k
        return done

    def drain_preempted(self) -> List[Tuple[int, List[int]]]:
        out, self._preempted = self._preempted, []
        return out

    def reset(self) -> None:
        for r in range(self.B):
            if self.slots[r].active:
                self._release_row(r)
        self._preempted = []
        self.emit("reset", cause="sim")

    # -- scheduler-optional hooks (getattr-probed by the driver) -------
    def mark_rework(self, rid: int) -> None:
        self._rework.add(rid)

    def discard_request_goodput(self, rid: int) -> None:
        self.ledger.discard_request(rid)

    def pop_request_goodput(self, rid: int,
                            tokens: float = 0.0) -> Optional[Dict]:
        return self.ledger.pop_request(rid, tokens=tokens)

    def pop_blocks_allocated(self, rid: int) -> Optional[int]:
        return self._blocks_at_retire.pop(rid, None)

    # -- internals -----------------------------------------------------
    def _release_row(self, row: int) -> None:
        self._free_blocks += self._slot_blocks[row]
        self._slot_blocks[row] = 0
        self.slots[row] = _SimSlot()

    def _tok(self, rid: int, i: int) -> int:
        t = 11 + ((int(rid) * 2654435761 + i * 40503) % 50021)
        while t in self.eos_token_ids:  # EOS comes from length, not luck
            t += 1
        return t


# ----------------------------------------------------------------------
# disaggregated pool sizing (pool-role awareness)
# ----------------------------------------------------------------------

#: executable kinds that are pure prefill work vs pure decode work; the
#: mixed kinds split per-window by their stamped decode-token share
_PREFILL_KINDS = frozenset({"prefill", "prefill_px"})
_DECODE_KINDS = frozenset({"decode", "verify"})


def split_chip_time(events: Iterable[Dict]) -> Dict[str, float]:
    """Walk a flight journal (real or synthetic) and attribute every
    ``goodput_window``'s duration to the prefill or the decode side of a
    disaggregated deployment. Pure-prefill and pure-decode kinds map
    whole; ``oneshot``/``mixed`` windows (which carry both phases in one
    dispatch) split by their ``decode_tokens``/``tokens`` ratio — the
    same stamps ``state_from_events`` reads, so no model config is
    needed offline. Returns ``{"prefill_s", "decode_s", "span_s"}``
    (span = journal timestamp extent, floored at total busy time)."""
    pre_s = dec_s = busy_s = 0.0
    t_lo = t_hi = None
    for e in events:
        if not isinstance(e, dict):
            continue
        t = e.get("t")
        if t is not None:
            t_lo = t if t_lo is None else min(t_lo, t)
            t_hi = t if t_hi is None else max(t_hi, t)
        if e.get("type") != "goodput_window":
            continue
        dur = float(e.get("dur_ms", 0.0)) / 1e3
        if dur <= 0:
            continue
        busy_s += dur
        kind = e.get("kind", "decode")
        if kind in _PREFILL_KINDS:
            pre_s += dur
        elif kind in _DECODE_KINDS:
            dec_s += dur
        else:  # oneshot / mixed: both phases in one window
            tokens = float(e.get("tokens", 0.0))
            dfrac = (float(e.get("decode_tokens", 0.0)) / tokens
                     if tokens > 0 else 0.5)
            dfrac = min(1.0, max(0.0, dfrac))
            dec_s += dur * dfrac
            pre_s += dur * (1.0 - dfrac)
    span = 0.0 if t_lo is None else float(t_hi) - float(t_lo)
    return {
        "prefill_s": round(pre_s, 9),
        "decode_s": round(dec_s, 9),
        "span_s": round(max(span, busy_s, 1e-9), 9),
    }


def pool_plan(events: Iterable[Dict], target_util: float = 0.6,
              span_s: Optional[float] = None, min_each: int = 1) -> Dict:
    """The offline answer to "how many prefill vs decode replicas does
    this trace need?": split the journal's chip time by phase
    (:func:`split_chip_time`), then size each tier with
    ``policy.pool_split``. Works on any flight journal — a live
    deployment's, or a ``simulate()`` run's synthetic one, which is the
    capacity-planning loop: record once, re-simulate the load shape
    you expect, read the split. ``span_s`` overrides the journal's
    timestamp extent (e.g. the wall duration a trace was recorded
    over). Returns the split inputs plus the sized plan."""
    split = split_chip_time(events)
    span = float(span_s) if span_s is not None else split["span_s"]
    plan = policy.pool_split(
        split["prefill_s"], split["decode_s"], span,
        target_util=target_util, min_each=min_each,
    )
    return {**split, "span_s": round(span, 9),
            "target_util": float(target_util), **plan}


# ----------------------------------------------------------------------
# the top-level run
# ----------------------------------------------------------------------

def simulate(trace, engine: Optional[SimEngine] = None, retries: int = 1,
             **engine_kw) -> Dict:
    """Run a trace through a ``SimEngine`` under the lockstep driver and
    return the what-if result: the synthetic journal, per-request token
    streams, virtual/wall seconds + speedup, virtual decode steps/s, and
    the goodput report rendered from the synthetic journal by the SAME
    offline pipeline the live journals go through."""
    eng = engine if engine is not None else SimEngine(**engine_kw)
    arrivals = trace["arrivals"] if isinstance(trace, dict) else list(trace)
    for a in arrivals:  # recorded generation lengths are the oracle
        if "n_out" in a and a.get("rid") is not None:
            eng.out_len.setdefault(a["rid"], int(a["n_out"]))
    drv = LockstepDriver(eng, emit=eng.emit, retries=retries)
    t0 = time.perf_counter()
    results = drv.drive(trace)
    wall_s = max(time.perf_counter() - t0, 1e-9)
    state = _goodput.state_from_events(eng.journal)
    virtual_s = max(eng.t, 1e-12)
    return {
        "results": results,
        "errors": {rid: repr(e) for rid, e in drv.errors.items()},
        "journal": eng.journal,
        "virtual_s": round(virtual_s, 6),
        "wall_s": round(wall_s, 6),
        "speedup_x": round(virtual_s / wall_s, 2),
        "windows": eng.windows,
        "decode_steps": eng.decode_steps,
        "steps_per_s": round(eng.decode_steps / virtual_s, 4),
        "tokens_out": sum(len(v) for v in results.values()),
        "report": _goodput.render_report(state, eng.chip_hour_usd),
        # disaggregated sizing: how many prefill- vs decode-role replicas
        # this load needs at 60% target busy (re-plan at a different
        # target with pool_plan(result["journal"], target_util=...))
        "pool_plan": pool_plan(eng.journal),
        # per-tenant cost split (tracegen traces carry tenant mixes): the
        # same renderer /debug/tenants uses, so
        # "which tenant pays for the next replica" is answerable offline
        "tenant_report": _tenants.render_report(
            _tenants.state_from_events(eng.journal), eng.chip_hour_usd
        ),
    }
