"""Continuous batching, counterpart of ``rag_llm_k8s_tpu/engine/continuous.py``.

Requests join a running batch of ``max_batch_size`` rows; between device
windows the scheduler admits waiting requests into free rows. Two caches:

- **Paged** (``kv_paged=True``): each row owns blocks of a ``[L, N, K, bs,
  hd]`` block-pool arena (``engine/kv_pool.py``) through a host-maintained
  ``[B, MB]`` block table; rows are right-padded, so row ``b``'s keys are
  the window ``[0, kv_len[b])`` and its next token writes at ``kv_len[b]``.
  Blocks are allocated as frontiers reach them. When the pool runs dry the
  newest-admitted row is preempted: its blocks return, and the scheduler
  resubmits it as prompt + emitted tokens (greedy streams are unchanged).
  Inactive rows and lanes past a row's table write into the null block,
  never ``table[row, 0]``.
- **Dense** (``kv_paged=False``, the JAX service's default under
  ``TPU_RAG_BATCHING=continuous``): a ``[L, B, K, T, hd]`` cache, one row
  per request, rows left-padded to their bucket, so row ``b``'s keys are
  ``[kv_start[b], kv_len[b])``. A same-bucket group prefills in one forward
  (``flash_attention``) into fresh row caches that are then copied into its
  rows; decode writes each row's token at its own frontier, a ``[B]``
  device index (``models.llama.write_row_frontier``), and attends with
  ``decode_attention``. Rows hold a whole slot each, so admission never
  waits on memory and nothing is preempted.

Windows:

- **Phase-separated admission** (``interleave_prefill=False``): a group of
  same-bucket prompts prefills in one forward; the first tokens come back
  in one fetch.
- **Interleaved admission** (``interleave_prefill=True``, paged only):
  admission only reserves a row; every window then feeds each active row
  one decode token and the pending prompts ``prefill_chunk_tokens`` at a
  time through ONE chunked forward (``paged_chunk_attention``). A prompt's
  final chunk samples its first token.
- **Decode windows** run ``decode_sync_steps`` single-token steps
  (``paged_decode_attention``, or ``decode_attention`` dense) and fetch the
  ``[k, B]`` token plane once.
- **Verify windows** (``spec_paged=True``, paged only): the host drafts up
  to ``spec_paged_tokens`` tokens per row by prompt lookup over the row's
  own history (``engine/speculative.py``), and ONE forward feeds each row
  its last token and drafts (``paged_chunk_attention``, ``K + 1`` lanes);
  the targets (each plane's keyed draw) and the acceptance stay on the
  card, and one fetch brings back up to ``K + 1`` tokens per row. A window
  verifies when some row drafted and the acceptance EMAs say it retires at
  least as many tokens as a plain window would.

Sampling is keyed by each row's ``(seed, position)`` alone
(``sampling.sample_token_per_row``), so a request samples the same stream
alone or in a batch, with interleaving or speculation on or off, over
either cache. The block table lives on the host and is uploaded (pinned,
non-blocking) only when it changed; the one host sync per window is the
token fetch.

Under ``kv_quant="int8"`` the cache holds int8 payloads plus fp32 scale
planes (zeros at construction) and the windows run the q8 kernels;
``weight_quant="int8"`` serves int8 weights (a model the one-shot engine
already quantized is shared as it is).

Resilience (``resilience/``), as in the JAX scheduler: a failed window or
a failed admission resets the engine (every row and block back) and the
scheduler resubmits each in-flight request ``retries`` times (default 1)
as its prompt plus the tokens it had emitted, so a transient fault is
invisible to the caller; a request out of retries gets the error. Every
reset feeds the service's circuit breaker. A request's ``Deadline`` is
checked while it queues and between windows, and an expired row is evicted
(its blocks return) within one window. The fault sites ``insert`` (inside a
phase-separated admission, between the prefill and the rows' update) and
``decode_step`` (the top of ``step``) make both recoveries testable.
Lifecycle events go to the flight recorder (``obs/flight.py``).

Engine tasks (``ContinuousScheduler.run_on_engine``): another thread hands
the dispatcher a callable, which it runs between admissions and windows; a
task that loses the engine's state recovers like a failed window.

Metrics (``bind_metrics``, the JAX engine's and scheduler's families): exact
time to first token (submit to the first token, once per request: a
resubmission or a preemption resume does not observe it again), per-token
latency per window (``mode="continuous"``: a decode window over its steps,
a mixed window whole, a verify window over the tokens it emitted per row),
the step-time split (``device_fetch`` from a window's first launch to its
token fetch, ``host_drain`` the drain after it, ``admit`` a phase-separated
admission's prefill through its first-token fetch), pool occupancy gauges
read from host state only (0 dense), preemptions, resets, resubmission
outcomes and deadline expiries. The speculation counters are
``ContinuousStats.spec_*``.

Durable journal and warm restart: while a flight WAL is attached
(``flight.wal_enabled()``), every window journals each live row's new
tokens as one ``token_emit`` event (``_journal_emitted``), so a request's
``token_emit`` events rebuild its emitted stream after the process dies;
``ContinuousScheduler.submit(resume_emitted=...)`` folds such WAL-proven
tokens back in (the preemption resume's fold), so the resumed stream is
the uninterrupted one.

The goodput ledger (``ContinuousEngine.ledger``, ``obs/goodput.py``), as in
the JAX engine: every sync window records once, after its own token fetch
and on host numbers (tokens kept per request, the batch, the resident
context), with the host wall time of the window: ``record_prefill`` per
phase-separated admission group, ``record_prefill_px`` per prefixed
admission, ``record_decode``, ``record_mixed`` and ``record_verify`` per
window, and ``record_preempt_stall`` where pool pressure preempted every row
or bounced an admission. Each record is journaled as a ``goodput_window``
event. A preemption resume's or a reset resubmission's next admission is
``preempt_rework`` (``mark_rework``), attributed once. The scheduler's
``busy_seconds()`` (its wall time inside the engine's step, admissions and
migrations) is what the requests' attributed chip time sums to; a delivered
request's share rides ``info["goodput"]`` and its ``complete`` event.

Pool roles (``EngineConfig.pool_role``, paged only): a ``"prefill"``
engine's scheduler exports each request once it is admitted
(``ContinuousEngine.export_request``: the row's blocks gathered out of the
arena, payload and int8 scale planes, its frontier, last token and
sampling state, then the row released) and returns the packet in
``info["migrate_packet"]``; a ``"decode"`` engine's scheduler lands it
(``submit_migrated``, ``import_request``: fresh blocks, the planes
scattered in, the row's state set), so the next draw at the frontier is
the one the prefill engine would have made, and finishes the stream. A
failed export keeps the request decoding where it is; a failed import
(the ``migrate`` fault site) resets the decode engine, which re-prefills
prompt plus emitted tokens. ``server/router.py`` pairs the two.

Prefix registrations (paged only; the continuous half of the KV prefix
cache): a ``CachedPrefix`` chain's full blocks can be registered in the pool
under its ``chain_key`` (one pool ref each), ahead of any admission
(``prestage_prefix``, the lookahead pipeline's paged leg, run as an engine
task) or at an admission's first sighting. ``admit_prefixed`` maps a
registered chain into the row's table copy-free (the row takes its own
ref), scatters the rest of the prefix from the descriptor's splice buffer,
and prefills only the suffix as one paged chunk (``paged_chunk_attention``)
at logical ``plen``; the dense cache prefills the suffix into a spliced
``T_build`` row cache (``chunk_prefill_attention``) and copies it into the
row. Under ``reuse="chunk"`` block-aligned exact spans also become per-chunk
canonical registrations, from which a later admission assembles a permuted
prefix: gather, RoPE re-rotation into fresh blocks, then a boundary
re-prefill of each shifted chunk's first tokens straight into pool blocks.
Registrations carry a hotness tier (the pool's tier ledger); pressure
reclaims chunk registrations first, then non-hot chains, then every chain
when nothing decodes. The service reaches this through lookahead's
prestage, release and retier only; ``admit_prefixed`` has no caller in the
scheduler, as in the JAX service.

On a tp mesh (``mesh``, the model being this rank's shard; JAX's
``mesh=``) the dense cache is ``[L, B, K/tp, T, hd]`` and the arena ``[L,
N, K/tp, bs, hd]`` (``ops.attention.paged_partition_specs``), with int8
scale planes to match; each rank keeps one host allocator, so the block
count is not rounded. Every call that changes the engine (``admit_many``,
``step``, ``evict_requests``, ``reset``, ``export_request`` and
``import_request``, ``admit_prefixed``, ``prestage_prefix``,
``release_prestaged``, the tier moves, ``drain_preempted`` and the
admission reclaim) is a mesh command (``parallel/commands.py``): rank 0
runs the scheduler and sends each call, every rank runs the same host
allocator, tables and slots on the same inputs, each its own shard. Rank 0
decides what could differ and sends it: the window kind and a verify's
drafts, each request's seed, a deadline's eviction, the tier of each
registration, the armed fault sites and the clock. A migration packet's
planes stay on their rank (``SharedPlanes``): rank 0's packet carries the
host state and names them, and ``import_request`` on the twin engine of
the same world scatters each rank's own slice. ``check_mesh`` gathers
every rank's ``state_digest`` and raises on a difference. The followers
keep no per-request bookkeeping (the ledger, the speculation marks).
"""

from __future__ import annotations

import hashlib
import itertools
import logging
import queue
import random
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, EngineConfig, LlamaConfig, SamplingConfig
from rag_llm_k8s_tpu_torch.core.device import DeviceLike, resolve_device
from rag_llm_k8s_tpu_torch.engine.batching import _join_worker
from rag_llm_k8s_tpu_torch.engine.engine import bind_compile_metrics, serving_model, stamp_spec
from rag_llm_k8s_tpu_torch.engine.kv_pool import NULL_BLOCK, KVBlockPool, PoolExhausted
from rag_llm_k8s_tpu_torch.engine.sampling import accept_drafts, sample_targets_per_row, sample_token_per_row
from rag_llm_k8s_tpu_torch.engine.speculative import adaptive_draft_len, fold_acceptance, prompt_lookup_draft
from rag_llm_k8s_tpu_torch.models.llama import LlamaModel, make_kv_arena, make_kv_cache, rope_frequencies
from rag_llm_k8s_tpu_torch.ops.attention import kv_heads_per_rank, rope_rerotate, rope_rerotate_q8
from rag_llm_k8s_tpu_torch.obs import flight, goodput, metrics
from rag_llm_k8s_tpu_torch.parallel.commands import mesh_command, register_target, stream_for
from rag_llm_k8s_tpu_torch.resilience import faults
from rag_llm_k8s_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded
from rag_llm_k8s_tpu_torch.sim import policy

logger = logging.getLogger(__name__)

# process-global: the flight journal keys every lifecycle event on this id
_REQUEST_IDS = itertools.count(1)


def _tenant_attr(ledger, rid: int) -> Dict[str, str]:
    """``{"tenant": ...}`` for an admit-time event when the edge stamped one
    on this request (``GoodputLedger.note_tenant`` at submit), else {}."""
    t = ledger.tenant_of(rid) if ledger is not None else None
    return {"tenant": t} if t else {}


class SharedPlanes(list):
    """A migration packet's planes on a mesh: every rank keeps its own head
    slice under one id (``parallel/commands.py``), so the packet rank 0
    hands on carries host state only and the KV never crosses ranks."""

    _mesh_shared = True


class EngineStateLost(RuntimeError):
    """A failure where a group's state joins the engine's rows: the engine
    has been reset and every request that was in flight is gone."""


@dataclass
class _Slot:
    """Host view of one row."""

    request_id: int = -1
    tokens: List[int] = field(default_factory=list)
    remaining: int = 0
    active: bool = False
    # upper bound of the row's frontier (drives block growth)
    kv_ub: int = 0
    admit_seq: int = 0
    # reserved for an interleaved admission still prefilling
    prefilling: bool = False
    # speculative verify (spec_paged): the row's draft corpus, the
    # assembled prompt + every emitted token, and the decayed acceptance
    # EMA that sets its draft length (None: no evidence yet)
    history: List[int] = field(default_factory=list)
    spec_ema: Optional[float] = None
    # the prompt's token count (the admission bucket a migration reports)
    prompt_len: int = 0
    # tokens the row serves from ref-shared prefix blocks (counted once, by
    # their registration, in the fragmentation gauge)
    shared_tokens: int = 0
    # flight-WAL watermark: how many of ``tokens`` are journaled as
    # ``token_emit`` (``_journal_emitted`` journals only the delta past it)
    wal_mark: int = 0


@dataclass
class ContinuousStats:
    # admissions (one per prefilled prompt, a resubmission's included) and
    # the prompt tokens they prefilled, counted where the JAX engine counts
    generate_calls: int = 0
    prefill_tokens: int = 0
    # prompt tokens a prefixed admission took from a cached prefix
    prefill_tokens_skipped: int = 0
    decode_tokens: int = 0
    windows: int = 0  # device windows of every kind (prefill groups not counted)
    mixed_windows: int = 0
    prefill_calls: int = 0
    preemptions: int = 0
    # host clock from a window's first launch to its token fetch, summed
    decode_window_s: float = 0.0
    mixed_window_s: float = 0.0
    verify_window_s: float = 0.0
    # speculative verify windows (counted in ``windows`` too), the rows
    # that offered drafts, and the drafted, accepted and emitted tokens
    spec_verify_steps: int = 0
    spec_drafted_rows: int = 0
    spec_drafted_tokens: int = 0
    spec_accepted_tokens: int = 0
    spec_emitted_tokens: int = 0


class ContinuousEngine:
    """Owns the KV cache (the paged arena and its block tables, or the dense
    row cache) and the per-row device state. Not thread-safe: the scheduler
    thread makes every call."""

    def __init__(
        self,
        config: LlamaConfig,
        model: LlamaModel,
        sampling: SamplingConfig = SamplingConfig(),
        engine_config: EngineConfig = EngineConfig(),
        dtypes: DTypePolicy = DTypePolicy(),
        device: DeviceLike = None,
        pad_id: int = 0,
        mesh=None,
    ):
        ec = engine_config
        ec.validate_quant()
        model_mesh = getattr(model, "mesh", None)
        if mesh is not None and model_mesh is not mesh and mesh.world > 1:
            raise ValueError("ContinuousEngine(mesh=...): the model must be this rank's shard on that mesh")
        self.mesh = model_mesh if mesh is None else mesh
        tp = self.mesh.tp if self.mesh is not None else 1
        # the head-sharded arena needs the kv heads to tile tp (JAX's rule)
        ec.validate_tp_layout(tp, config.num_kv_heads)
        self.paged = bool(ec.kv_paged)
        # "prefill" engines admit and export, "decode" engines import and
        # decode; role is policy, not capability (a failed export decodes
        # locally)
        ec.validate_pool_role()
        self.pool_role = ec.pool_role
        self.device = resolve_device(device)
        self.config, self.sampling, self.engine_config, self.dtypes = config, sampling, ec, dtypes
        self.pad_id = pad_id
        self.B = ec.max_batch_size
        self.sync_steps = max(1, ec.decode_sync_steps)
        self.T = -(-ec.max_seq_len // 128) * 128
        # only buckets that leave decode room fit a row
        self.buckets = tuple(b for b in ec.prompt_buckets if b < self.T)
        if not self.buckets:
            raise ValueError(
                f"no prompt bucket in {ec.prompt_buckets} fits max_seq_len={ec.max_seq_len} "
                f"(row length {self.T})"
            )
        self.kv_pool: Optional[KVBlockPool] = None
        if self.paged:
            bs = int(ec.kv_block_size)
            tile = 32 if ec.kv_quant == "int8" else 16
            if bs < 1 or bs % tile:
                raise ValueError(
                    f"kv_block_size={bs} must be a positive multiple of {tile} (kv_quant={ec.kv_quant!r})")
            if any(b % bs for b in self.buckets) or self.T % bs:
                raise ValueError(
                    f"kv_block_size={bs} must divide every prompt bucket {self.buckets} and the row "
                    f"length {self.T}"
                )
            self.block_size = bs
            self.MB = self.T // bs
            usable = int(ec.kv_pool_blocks) or self.B * self.MB
            if usable < self.MB:
                raise ValueError(f"kv_pool_blocks={usable}: the pool must hold one full row ({self.MB} blocks)")
            self.kv_pool = KVBlockPool(usable + 1, bs)  # + the null block
        # speculative verify windows (the JAX constructor's checks and messages)
        self.spec_on = bool(ec.spec_paged)
        # requests whose rows ever offered drafts to a verify window
        # (pop_spec_seen); popped at delivery or discarded with the request
        self._spec_rids: set = set()
        if self.spec_on:
            if not self.paged:
                raise ValueError(
                    "spec_paged=True requires kv_paged=True — the verify "
                    "step writes drafted positions through block tables "
                    "(the dense continuous path does not speculate)"
                )
            self.spec_K = int(ec.spec_paged_tokens)
            if self.spec_K < 1:
                raise ValueError(f"spec_paged_tokens={self.spec_K}: expected >= 1")
            self.spec_ngram = max(1, int(ec.spec_ngram))
            self.spec_min_accept = float(ec.spec_paged_min_accept)
            if not 0.0 <= self.spec_min_accept <= 1.0:
                raise ValueError(
                    f"spec_paged_min_accept={self.spec_min_accept}: an "
                    "acceptance-RATE floor must lie in [0, 1]"
                )
        self.interleave_on = bool(ec.interleave_prefill)
        if self.interleave_on:
            ec.validate_interleave()  # requires kv_paged
            self.chunk_tokens = int(ec.prefill_chunk_tokens)
            self.window_budget = int(ec.window_token_budget) or self.B + self.chunk_tokens
        self.model = serving_model(model, ec)
        # this rank's slice of the config: its kv heads size the caches
        self.local = getattr(self.model, "local", config)
        # the paged arena, or the dense [L, B, K, T, hd] row cache; on a tp
        # mesh each holds this rank's K/tp kv heads (paged_partition_specs)
        self.arena = self.cache = None
        if self.paged:
            if self.local.num_kv_heads != kv_heads_per_rank(config.num_kv_heads, tp):
                raise ValueError(f"the model's shard holds {self.local.num_kv_heads} kv heads, the arena's split "
                                 f"over tp={tp} {kv_heads_per_rank(config.num_kv_heads, tp)}")
            self.arena = make_kv_arena(self.local, usable + 1, bs, dtypes.compute_dtype, self.device, ec.kv_quant)
            # this rank's arena bytes from its shapes, once: a scrape never
            # asks the allocator or the card
            self.arena_device_bytes = float(sum(
                t.numel() * t.element_size()
                for t in (self.arena.k, self.arena.v, self.arena.k_scale, self.arena.v_scale) if t is not None
            ))
        else:
            self.cache = make_kv_cache(self.local, self.B, self.T, dtypes.compute_dtype, self.device, ec.kv_quant)
            self.arena_device_bytes = 0.0  # the pool gauge reads 0 under the dense cache, as in JAX
        # a mesh: rank 0 sends each call that changes the engine as a
        # command every rank runs (its own stream shared with the mesh's
        # other engines); the followers keep no per-request bookkeeping
        self._commands = stream_for(self.mesh)
        self._mesh_name = register_target(self.mesh, self, "continuous")
        self._leader = self.mesh is None or self.mesh.leader
        self._eos = torch.tensor(config.eos_token_ids, device=self.device)
        self._seed_counter = 0
        self.stats = ContinuousStats()
        # registration generations stay monotonic across resets, so a stale
        # release can never match a registration made after one
        self._reg_seq = 0
        # chunk splices re-rotate K by phases the host computes from these
        self._inv_freqs = rope_frequencies(config, torch.device("cpu"))
        # the goodput ledger: one record per device sync window, after the
        # window's own fetch, on host numbers only; each returns the summary
        # journaled as a goodput_window event (_journal_window)
        self.ledger = goodput.ledger_for(config, ec)
        if not self._leader:
            self.ledger.enabled = False  # rank 0 attributes every window
        # requests whose next admission re-feeds tokens computed once
        # already (a preemption resume, a reset's resubmission): that
        # admission's lanes are preempt_rework, attributed once
        self._rework_rids: set = set()
        # paged: request id -> blocks held at retirement (pop_blocks_allocated)
        self._blocks_at_retire: Dict[int, int] = {}
        # admit_many's entry stamp: its first group's ledger window absorbs
        # the call's preparation
        self._admit_lead: Optional[float] = None
        self._fresh_state()
        self.bind_metrics(metrics.MetricsRegistry())  # its own until a service binds it, as InferenceEngine

    def bind_metrics(self, registry) -> None:
        """Point this engine's metric handles at ``registry`` (JAX
        ``ContinuousEngine.bind_metrics``). Every gauge reads host state, and
        none holds the engine (a registry may outlive it; a probe of a
        collected engine reads 0)."""
        bind_compile_metrics(registry)
        self._m_ttft = registry.histogram(
            "rag_time_to_first_token_seconds",
            "submit-to-first-token (queue + coalesce + prefill + fetch)",
            buckets=metrics.REQUEST_BUCKETS,
        )
        self._m_itl = registry.labeled_histogram(
            "rag_decode_inter_token_seconds",
            "per-decoded-token latency (mode label: oneshot_est is call "
            "duration over decode steps; continuous is exact per window)",
            buckets=metrics.TOKEN_LATENCY_BUCKETS,
        ).labels(mode="continuous")
        step_fam = registry.labeled_histogram(
            "rag_continuous_step_seconds",
            "continuous-engine step-time breakdown (phase label: "
            "device_fetch | host_drain | admit)",
            buckets=metrics.LATENCY_BUCKETS,
        )
        self._m_step_device = step_fam.labels(phase="device_fetch")
        self._m_step_drain = step_fam.labels(phase="host_drain")
        self._m_step_admit = step_fam.labels(phase="admit")
        pool, stats, nbytes, me = self.kv_pool, self.stats, self.arena_device_bytes, weakref.ref(self)
        # the pool's families exist in both modes and read 0 under the dense cache
        registry.labeled_gauge(
            "rag_kv_pool_blocks_total",
            "allocatable physical KV blocks (paged mode; 0 dense)",
        ).labels_callback(lambda: float(pool.usable_blocks()) if pool is not None else 0.0)
        registry.labeled_gauge(
            "rag_kv_pool_blocks_in_use",
            "physical KV blocks currently referenced (paged mode)",
        ).labels_callback(lambda: float(pool.blocks_in_use()) if pool is not None else 0.0)
        registry.labeled_gauge(
            "rag_kv_pool_fragmentation",
            "fraction of allocated KV token slots not holding live KV "
            "(internal fragmentation — pad/tail waste of the block layout)",
        ).labels_callback(lambda: pool.fragmentation(me().pool_used_tokens()) if pool is not None else 0.0)
        registry.counter(
            "rag_kv_pool_preemptions_total",
            "rows preempted mid-decode by pool exhaustion (resubmitted by "
            "the scheduler; callers see latency, not errors)",
            fn=lambda: float(stats.preemptions),
        )
        dev_fam = registry.labeled_gauge(
            "rag_kv_pool_device_bytes",
            "paged KV arena bytes resident per device (head-sharded over "
            "tp: ~arena_total/tp per chip; 0 under the dense cache)",
        )
        stream, name = self._commands, self._mesh_name
        if stream is None:
            dev_fam.labels_callback(lambda: nbytes, device=str(self.device.index or 0))
            return
        # a mesh: one child per rank, the followers' from the last heartbeat
        # (obs/devices.py reads the HBM families the same way)
        for r in range(self.mesh.world):
            dev_fam.labels_callback(
                lambda r=r: nbytes if r == 0 else float(
                    stream.peer_stats.get(r, {}).get("targets", {}).get(name, {}).get("arena_bytes", 0.0)),
                device=str(r))

    def mesh_stats(self) -> Dict[str, float]:
        """This rank's arena bytes (the heartbeat gathers them)."""
        return {"arena_bytes": self.arena_device_bytes}

    def state_digest(self) -> str:
        """A digest of this rank's host state that every rank of a mesh
        must share: the slots, the block tables and the pool, the
        registrations, the pending admissions, and the device frontiers."""
        h = hashlib.sha256()
        h.update(repr([(s.request_id, s.active, s.prefilling, s.kv_ub, len(s.tokens), s.remaining, s.admit_seq)
                       for s in self.slots]).encode())
        h.update(repr([(rid, r["row"], r["progress"]) for rid, r in self._chunk_admissions.items()]).encode())
        h.update(self._kv_len.cpu().numpy().tobytes() + self._active.cpu().numpy().tobytes())
        if self.paged:
            h.update(self._tables_host.tobytes())
            h.update(repr((self.kv_pool.blocks_in_use(), sorted(map(repr, self._prefix_blocks.items())),
                           sorted(map(repr, self._prefix_tier.items())), list(self._chunk_regs))).encode())
        return h.hexdigest()[:16]

    def check_mesh(self) -> List[str]:
        """Every rank's ``state_digest`` on rank 0 (one command and one
        gather); raises ``parallel.commands.MeshDivergence`` when they
        differ. Off a mesh, this engine's alone."""
        if self._commands is None:
            return [self.state_digest()]
        return self._gather_digests()

    @mesh_command
    def _gather_digests(self) -> Optional[List[str]]:
        if self._commands is not None:
            return self._commands.gather_digests(self.state_digest, self._mesh_name)
        self.mesh.gather_object(self.state_digest())
        return None

    def pool_used_tokens(self) -> int:
        """Live tokens across unique pool blocks (host mirrors): the
        numerator of the fragmentation gauge; 0 under the dense cache.
        Ref-shared prefix blocks count once, through their registration."""
        if not self.paged:
            return 0
        rows = sum(max(s.kv_ub - s.shared_tokens, 0) for s in self.slots if s.active)
        return rows + self._registered_tokens + self._chunk_reg_tokens

    def pop_spec_seen(self, request_id: int) -> bool:
        """True iff a verify window ever judged drafts for this request
        (JAX ``pop_spec_seen``, the shadow auditor's fingerprint source).
        Popping keeps the set bounded by the requests in flight."""
        try:
            self._spec_rids.remove(request_id)
            return True
        except KeyError:
            return False

    def discard_spec_seen(self, request_id: int) -> None:
        """Forget a request that will never be delivered (gave up, deadline,
        shutdown)."""
        self._spec_rids.discard(request_id)

    # ------------------------------------------------------------------
    # goodput ledger plumbing (scheduler thread)
    # ------------------------------------------------------------------
    def mark_rework(self, request_id: int) -> None:
        """The request's next admission re-feeds tokens already computed
        once (a preemption resume, a reset's resubmission): its lanes are
        ``preempt_rework``, not fresh prefill. One admission consumes the
        mark."""
        if len(self._rework_rids) > 4096:  # stale marks of failed retries
            self._rework_rids.clear()
        self._rework_rids.add(request_id)

    def _take_rework(self, rids) -> set:
        taken = {r for r in rids if r in self._rework_rids}
        self._rework_rids -= taken
        return taken

    def pop_request_goodput(self, request_id: int, tokens: float = 0.0) -> Optional[Dict[str, float]]:
        """A delivered request's attribution (``chip_ms``, ``goodput_frac``,
        ``cost_usd`` when priced, its speculation stats), or None with the
        ledger off; ``tokens`` (the delivered count) feeds its tenant's
        rollup."""
        return self.ledger.pop_request(request_id, tokens=tokens)

    def discard_request_goodput(self, request_id: int) -> None:
        """Forget a request that will never be delivered (gave up, deadline,
        shutdown): its chip time stays in the totals."""
        self.ledger.discard_request(request_id)
        self._rework_rids.discard(request_id)

    @staticmethod
    def _journal_window(summary) -> None:
        """Journal one ledger window (None when the ledger is off)."""
        if summary is not None:
            flight.emit("goodput_window", **summary)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def _fresh_state(self) -> None:
        B, dev = self.B, self.device
        # dense rows are left-padded: row b's keys are [kv_start[b], kv_len[b])
        self._kv_start = torch.zeros(B, dtype=torch.int32, device=dev)
        self._kv_len = torch.zeros(B, dtype=torch.int32, device=dev)
        self._last_tok = torch.zeros(B, dtype=torch.int64, device=dev)
        self._active = torch.zeros(B, dtype=torch.bool, device=dev)
        self._seeds = torch.zeros(B, dtype=torch.int64, device=dev)
        # per-row sampling: greedy flag, temperature, top-p
        self._greedy = torch.ones(B, dtype=torch.bool, device=dev)
        self._temp = torch.ones(B, dtype=torch.float32, device=dev)
        self._top_p = torch.ones(B, dtype=torch.float32, device=dev)
        self._zeros = torch.zeros(B, dtype=torch.int32, device=dev)
        self._row_greedy = [True] * B  # host mirror: skip the draw when all rows are greedy
        # host mirror of each row's (seed, sampling): what a migration packet carries
        self._row_sampling: List[Tuple[int, SamplingConfig]] = [(0, self.sampling)] * B
        self.slots = [_Slot() for _ in range(B)]
        if self.paged:
            self._tables_host = np.zeros((B, self.MB), np.int32)
            self._tables_dev: Optional[torch.Tensor] = None
            self._tables_dirty = True
            self._slot_blocks: List[List[int]] = [[] for _ in range(B)]
            # chain registrations: chain_key -> (full block ids, covered
            # tokens, prefix length); the pool holds one ref per block
            self._prefix_blocks: Dict[object, Tuple[List[int], int, int]] = {}
            # admissions that mapped each registration since it was made
            # (release_prestaged(only_unused=True) keeps a used one)
            self._prefix_uses: Dict[object, int] = {}
            # each registration's generation (a deferred release presents
            # the one it staged) and hotness tier
            self._prefix_reg_gen: Dict[object, int] = {}
            self._prefix_tier: Dict[object, str] = {}
            # non-hot registered blocks and covered tokens: single ints the
            # admission gate and the scrape read without a lock
            self._reclaimable_blocks = 0
            self._registered_tokens = 0
            # chunk-granular canonical registrations (reuse="chunk"): seg_key
            # -> (block ids, canonical offset, length, cache-entry stamp,
            # counted); least-recently-planned first
            self._chunk_regs: "OrderedDict[str, tuple]" = OrderedDict()
            self._chunk_reg_tokens = 0
        self._admit_seq = 0
        self._preempted: List[Tuple[int, List[int]]] = []
        # in-flight interleaved admissions, oldest first: rid -> record
        self._chunk_admissions: "OrderedDict[int, dict]" = OrderedDict()

    @mesh_command
    def reset(self) -> None:
        """Drop every row and return every block (after a failed window).
        The cache keeps its memory; no kernel reads outside a row's window,
        and an admission rewrites its row's slots before any read."""
        flight.emit("reset", in_flight=sum(1 for s in self.slots if s.active))
        if self.paged:
            self.kv_pool.reset()
        self._fresh_state()

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device without a host sync (pinned
        staging, non-blocking copy)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _device_tables(self) -> torch.Tensor:
        """The device copy of the block tables, uploaded only when the host
        tables changed."""
        if self._tables_dirty or self._tables_dev is None:
            self._tables_dev = self._h2d(self._tables_host)
            self._tables_dirty = False
        return self._tables_dev

    def _row_seed(self, seed: Optional[int]) -> int:
        """The request's own seed, or a fresh one per request."""
        if seed is None:
            self._seed_counter += 1
            seed = self.sampling.seed * 1_000_003 + self._seed_counter
        return int(seed) % (1 << 62)

    def _set_row_sampling(self, row: int, seed: int, sampling: SamplingConfig) -> None:
        greedy = not sampling.do_sample or sampling.temperature <= 0.0
        self._seeds[row] = seed
        self._greedy[row] = greedy
        self._temp[row] = 1.0 if greedy else float(sampling.temperature)
        self._top_p[row] = float(sampling.top_p)
        self._row_greedy[row] = greedy
        self._row_sampling[row] = (seed, sampling)

    def _sample(self, logits: torch.Tensor, positions: torch.Tensor, rows=None) -> torch.Tensor:
        """Per-row draws at ``positions`` for all rows, or for ``rows``."""
        if rows is None:
            all_greedy = all(self._row_greedy)
            rows = slice(None)
        else:
            all_greedy = False
        if all_greedy:
            return torch.argmax(logits, dim=-1)
        return sample_token_per_row(
            logits, self._greedy[rows], self._temp[rows], self._top_p[rows],
            self._seeds[rows], positions,
        )

    def _sample_targets(self, logits: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """A verify window's targets ``[B, S]``: plane ``j`` of row ``b`` is
        the draw ``_sample`` makes at ``positions[b, j]`` in a plain window."""
        if all(self._row_greedy):
            return torch.argmax(logits, dim=-1)
        return sample_targets_per_row(logits, self._greedy, self._temp, self._top_p, self._seeds, positions)

    def _deactivate(self, rows: Sequence[int]) -> None:
        for r in rows:
            self._active[r] = False

    # ------------------------------------------------------------------
    # block bookkeeping (scheduler thread)
    # ------------------------------------------------------------------
    def _assign_row_blocks(self, row: int, ids: List[int], start_block: int = 0) -> None:
        for j, b in enumerate(ids):
            self._tables_host[row, start_block + j] = b
        self._slot_blocks[row].extend(ids)
        self._tables_dirty = True

    def _note_footprint(self, rid: int, row: int) -> None:
        """The blocks a request held when its row retired (paged), for its
        timings' ``kv_blocks_allocated`` (``pop_blocks_allocated``)."""
        if not self.paged or rid < 0:
            return
        if len(self._blocks_at_retire) > 8192:  # engines driven directly never pop
            self._blocks_at_retire.clear()
        self._blocks_at_retire[rid] = len(self._slot_blocks[row])

    def pop_blocks_allocated(self, request_id: int) -> Optional[int]:
        """The blocks the request held at retirement (paged; None under the
        dense cache): the scheduler puts it in ``info``."""
        return self._blocks_at_retire.pop(request_id, None) if self.paged else None

    def _release_row(self, row: int) -> None:
        """Blocks back to the pool and the row's table nulled, before the
        next window: a stale entry would let junk writes land in a block
        another request may own next. Nothing to return under the dense
        cache."""
        if not self.paged:
            return
        if self._slot_blocks[row]:
            self.kv_pool.free(self._slot_blocks[row])
            self._slot_blocks[row] = []
        if self._tables_host[row].any():
            self._tables_host[row, :] = NULL_BLOCK
            self._tables_dirty = True

    def blocks_needed(self, prompt_len: int) -> int:
        """Admission-time block cost of a prompt (0 under the dense cache)."""
        if not self.paged:
            return 0
        return policy.admission_blocks(prompt_len, self.block_size)

    def admission_state(self, prompt_len: int) -> str:
        """'ok' admissible now; 'wait' until decode frees blocks; 'never'
        when the prompt alone outsizes the pool. Always 'ok' under the
        dense cache, whose rows hold a whole slot each."""
        if not self.paged:
            return "ok"
        verdict, want = policy.admission_verdict(
            self.blocks_needed(prompt_len), self.kv_pool.usable_blocks(),
            self.interleave_on, self.MB,
        )
        if verdict != "check":
            return verdict
        if self.kv_pool.can_alloc(want):
            return "ok"
        return self._reclaim_for(want)

    @mesh_command
    def _reclaim_for(self, want: int) -> str:
        """``admission_state``'s reclaim: registrations dropped until
        ``want`` blocks fit, then the verdict."""
        if self._prefix_blocks or self._chunk_regs:
            # chunk registrations first, then non-hot chains, even while
            # rows decode: their KV is one re-stage away in the prefix cache
            for key in list(self._chunk_regs):
                self._drop_chunk_reg(key)
                if self.kv_pool.can_alloc(want):
                    return "ok"
            for key in [k for k, t in list(self._prefix_tier.items()) if t != "hot"]:
                self._drop_registration(key)
                if self.kv_pool.can_alloc(want):
                    return "ok"
        if self._prefix_blocks and not self.has_active():
            # nothing decodes: the hot chains are the only other holders
            for key in list(self._prefix_blocks):
                self._drop_registration(key)
                if self.kv_pool.can_alloc(want):
                    return "ok"
        return "wait" if self.has_active() else ("ok" if self.kv_pool.can_alloc(want) else "never")

    def _ensure_decode_blocks(self, horizon: Optional[Dict[int, int]] = None) -> None:
        """Grow every active row's table to cover the next window's writes
        before the device call (an unmapped write would vanish into the null
        block). Exhaustion reclaims chunk registrations, then chain
        registrations (non-hot, oldest first), then preempts pending
        interleaved admissions, then the newest-admitted rows, until the
        rest fit."""
        while True:
            short = policy.grow_shortfall(
                ((s.admit_seq, r, s.kv_ub, len(self._slot_blocks[r]))
                 for r, s in enumerate(self.slots) if s.active),
                self.sync_steps, horizon, self.block_size, self.MB,
            )
            ok = True
            for _, row, missing, have in short:
                try:
                    ids = self.kv_pool.alloc(missing)
                except PoolExhausted:
                    ok = False
                    break
                self._assign_row_blocks(row, ids, start_block=have)
                flight.emit("block_grow", self.slots[row].request_id, blocks=missing, total=have + missing)
            if ok:
                return
            if self._chunk_regs:
                self._drop_chunk_reg(next(iter(self._chunk_regs)))
                continue
            if self._prefix_blocks:
                self._drop_registration(policy.reclaim_registration(
                    self._prefix_blocks, self._prefix_tier, self._prefix_reg_gen))
                continue
            if self._chunk_admissions:
                rid, rec = self._chunk_admissions.popitem()
                self._preempt_chunk_admission(rid, rec)
                continue
            _, victim = policy.preempt_victim(
                (s.admit_seq, r) for r, s in enumerate(self.slots) if s.active
            )
            vslot = self.slots[victim]
            logger.warning(
                "kv pool exhausted mid-decode; preempting request %d (%d blocks back)",
                vslot.request_id, len(self._slot_blocks[victim]),
            )
            self._preempted.append((vslot.request_id, list(vslot.tokens)))
            self.stats.preemptions += 1
            flight.emit("preempt", vslot.request_id, blocks=len(self._slot_blocks[victim]),
                        n_tokens=len(vslot.tokens))
            self._deactivate([victim])
            self._release_row(victim)
            self.slots[victim] = _Slot()

    def _preempt_chunk_admission(self, rid: int, rec: dict) -> None:
        """Cancel an interleaved admission under pool pressure: its blocks
        return and the scheduler resubmits it with no emitted tokens."""
        self._preempted.append((rid, []))
        self.stats.preemptions += 1
        flight.emit("preempt", rid, blocks=len(self._slot_blocks[rec["row"]]), n_tokens=0)
        self._release_row(rec["row"])
        self.slots[rec["row"]] = _Slot()

    def _alloc_chunk_blocks(self, n: int) -> Optional[List[int]]:
        """Blocks for a scheduled prefill chunk, reclaiming registrations
        in ``admission_state``'s order under pressure; None when the pool
        really is full."""
        while True:
            try:
                return self.kv_pool.alloc(n)
            except PoolExhausted:
                if self._chunk_regs:
                    self._drop_chunk_reg(next(iter(self._chunk_regs)))
                    continue
                non_hot = [k for k, t in list(self._prefix_tier.items()) if t != "hot"]
                if non_hot:
                    self._drop_registration(non_hot[0])
                    continue
                if self._prefix_blocks and not self.has_active():
                    self._drop_registration(next(iter(self._prefix_blocks)))
                    continue
                return None

    def drain_preempted(self) -> List[Tuple[int, List[int]]]:
        """``(request_id, emitted_tokens)`` preempted since the last call
        (never any under the dense cache)."""
        return self._drain_preempted() if self._preempted else []

    @mesh_command
    def _drain_preempted(self) -> List[Tuple[int, List[int]]]:
        out, self._preempted = self._preempted, []
        return out

    # ------------------------------------------------------------------
    # operations (scheduler thread)
    # ------------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.active and not s.prefilling]

    def has_active(self) -> bool:
        return any(s.active or s.prefilling for s in self.slots)

    @mesh_command
    @torch.inference_mode()
    def evict_requests(self, request_ids: Sequence[int]) -> List[int]:
        """Retire the rows serving ``request_ids`` without a result (their
        blocks return now); returns the freed rows."""
        wanted = set(request_ids)
        rows = [i for i, s in enumerate(self.slots) if s.active and s.request_id in wanted]
        self._deactivate(rows)
        for r in rows:
            flight.emit("evict", self.slots[r].request_id, n_tokens=len(self.slots[r].tokens))
            self._note_footprint(self.slots[r].request_id, r)
            self._release_row(r)
            self.slots[r] = _Slot()
        for rid in [r for r in self._chunk_admissions if r in wanted]:
            flight.emit("evict", rid, n_tokens=0)
            row = self._chunk_admissions.pop(rid)["row"]
            self._note_footprint(rid, row)
            self._release_row(row)
            self.slots[row] = _Slot()
            rows.append(row)
        return rows

    def admit_many(self, items: Sequence[tuple]) -> List:
        """Admit ``(request_id, prompt, max_new, seed[, sampling])`` items
        into free rows; returns ``(row, finished)`` or the exception of the
        item's prefill group, in input order. A prompt over the largest
        bucket keeps its last tokens (with a warning); ``max_new`` is
        clamped to the row's room past the bucket. ``EngineStateLost`` (the
        engine was reset) propagates out of the whole call. Each item's seed
        is resolved here, before a mesh command carries it."""
        free = self.free_slots()
        if len(items) > len(free):
            raise ValueError(f"admit_many: {len(items)} items for {len(free)} free rows")
        return self._admit_many([(it[0], it[1], it[2], self._row_seed(it[3])) + tuple(it[4:]) for it in items])

    @mesh_command
    @torch.inference_mode()
    def _admit_many(self, items: Sequence[tuple]) -> List:
        free = self.free_slots()
        self._admit_lead = time.perf_counter()
        prepared = []
        for i, item in enumerate(items):
            rid, prompt, max_new, seed = item[:4]
            samp = item[4] if len(item) > 4 and item[4] is not None else self.sampling
            S = policy.bucket_len(max(len(prompt), 1), self.buckets)
            if len(prompt) > S:
                logger.warning(
                    "continuous-batch prompt of %d tokens exceeds the largest bucket %d; "
                    "left-truncating", len(prompt), S,
                )
            prepared.append((i, rid, S, list(prompt)[-S:], policy.clamp_max_new(max_new, S, self.T),
                             self._row_seed(seed), samp))
        results: List = [None] * len(items)
        free_iter = iter(free)
        if self.interleave_on:
            for entry in prepared:
                row = next(free_iter)
                self._queue_chunk_admission(entry, row)
                results[entry[0]] = (row, None)
            return results
        for S, idx in policy.admission_chunks([(j, e[2]) for j, e in enumerate(prepared)], self.B):
            chunk = [prepared[j] for j in idx]
            rows = [next(free_iter) for _ in chunk]
            try:
                self._admit_chunk(S, chunk, rows, results)
            except EngineStateLost:
                raise  # every row is gone: the callers must all recover
            except Exception as e:  # noqa: BLE001 — the group's items get the error
                for entry in chunk:
                    results[entry[0]] = e
        return results

    def _admit_chunk_t0(self) -> float:
        """A group's ledger-window start: ``admit_many``'s entry stamp for
        its first group (the preparation absorbed), now for the rest."""
        lead, self._admit_lead = self._admit_lead, None
        return lead if lead is not None else time.perf_counter()

    def _record_prefill(self, t_led: float, S: int, chunk) -> None:
        rows = {rid: len(p) for _, rid, _, p, _, _, _ in chunk}
        self._journal_window(self.ledger.record_prefill(
            time.perf_counter() - t_led, bucket=S, rows=rows, rework=self._take_rework(rows),
        ))

    def _admit_chunk(self, S: int, chunk, rows: List[int], results: List) -> None:
        """One batched prefill and one first-token fetch for a same-bucket
        group, into the arena or the dense cache."""
        if self.paged:
            self._admit_chunk_paged(S, chunk, rows, results)
        else:
            self._admit_chunk_dense(S, chunk, rows, results)

    def _admit_chunk_dense(self, S: int, chunk, rows: List[int], results: List) -> None:
        """Dense admission (JAX ``_admit_chunk``): the group's prompts
        left-padded to ``[n, S]`` (``kv_start = S - len(p)``), one prefill
        through ``flash_attention`` into fresh ``[L, n, K, S, hd]`` row
        caches, the first tokens drawn at position ``len(p)``, then a copy
        into the engine's rows at slots ``[0, S)`` and one fetch. A failed
        prefill propagates (the rows were not taken yet); a failure where
        the group's state joins the engine's rows (the ``insert`` fault
        site, between the prefill and the copy) resets the engine and
        raises ``EngineStateLost``."""
        n = len(chunk)
        t_led = self._admit_chunk_t0()
        t_admit = time.perf_counter()
        # left-padded tokens | kv_start | prompt length | row, in one upload
        host = np.full((n, S + 3), self.pad_id, np.int64)
        for r, (_, _, _, p, _, seed, samp) in enumerate(chunk):
            host[r, S - len(p):S] = p
            host[r, S], host[r, S + 1], host[r, S + 2] = S - len(p), len(p), rows[r]
            self._set_row_sampling(rows[r], seed, samp)
        dh = self._h2d(host)
        tokens, starts, lens, rows_t = dh[:, :S], dh[:, S], dh[:, S + 1], dh[:, S + 2]
        positions = (torch.arange(S, device=self.device)[None, :] - starts[:, None]).clamp(min=0)
        row_cache = make_kv_cache(self.local, n, S, self.dtypes.compute_dtype, self.device,
                                  self.engine_config.kv_quant)
        logits = self.model(tokens, positions, row_cache, starts, torch.full_like(starts, S), 0,
                            last_logit_only=True)
        tok0 = self._sample(logits[:, -1], lens, rows=rows_t)
        try:
            # fault site "insert": a fault while the group's state joins the
            # engine's rows leaves that state unknown, so the engine resets
            faults.maybe_fail("insert")
            for dst, src in zip(self._cache_planes(), self._cache_planes(row_cache)):
                dst[:, rows_t, :, :S] = src
            self._kv_start[rows_t] = starts.to(torch.int32)
            self._kv_len[rows_t] = S
            self._last_tok[rows_t] = tok0
            self._active[rows_t] = True
            tok0_h = tok0.cpu().tolist()  # the one fetch of the group
        except Exception as e:  # noqa: BLE001 — every row's state is suspect
            self.reset()
            raise EngineStateLost("insert failed; engine state reset") from e
        del row_cache
        self._m_step_admit.observe(time.perf_counter() - t_admit)
        self.stats.prefill_calls += 1
        for r, (i, rid, _, p, max_new_c, _, _) in enumerate(chunk):
            self._start_row(rows[r], rid, p, tok0_h[r], max_new_c, S, results, i)
        self._record_prefill(t_led, S, chunk)

    def _cache_planes(self, cache=None) -> Tuple[torch.Tensor, ...]:
        """The dense cache's planes: ``(k, v)``, or with the int8 scales."""
        c = self.cache if cache is None else cache
        return (c.k, c.v) + ((c.k_scale, c.v_scale) if c.quantized else ())

    def _admit_chunk_paged(self, S: int, chunk, rows: List[int], results: List) -> None:
        """One right-padded prefill for a same-bucket group, written into the
        rows' blocks, then one fetch of the first tokens. ``PoolExhausted``
        returns the blocks taken so far and propagates (backpressure); a
        failed prefill releases the group's rows and propagates; a failure
        where the group's state joins the engine's rows (the ``insert``
        fault site) resets the engine and raises ``EngineStateLost``."""
        n = len(chunk)
        t_led = self._admit_chunk_t0()
        taken: List[Tuple[int, List[int]]] = []
        try:
            for r, entry in enumerate(chunk):
                taken.append((rows[r], self.kv_pool.alloc(self.blocks_needed(len(entry[3])))))
        except PoolExhausted:
            for _, ids in taken:
                self.kv_pool.free(ids)
            # the bounced group cost scheduler time: its requests requeue,
            # and the attempt is theirs (preempt_rework), or conservation
            # frays under pool pressure
            self._journal_window(self.ledger.record_preempt_stall(
                time.perf_counter() - t_led, [c[1] for c in chunk], kind="prefill"))
            raise
        for row, ids in taken:
            self._assign_row_blocks(row, ids)
        t_admit = time.perf_counter()
        try:
            host = np.full((n, S + 2), self.pad_id, np.int64)
            for r, (_, _, _, p, _, seed, samp) in enumerate(chunk):
                host[r, :len(p)] = p
                host[r, S] = len(p)
                host[r, S + 1] = rows[r]
                self._set_row_sampling(rows[r], seed, samp)
            dev_host = self._h2d(host)
            tokens, lens, rows_t = dev_host[:, :S], dev_host[:, S], dev_host[:, S + 1]
            positions = torch.arange(S, device=self.device)[None, :].expand(n, S)
            zeros = self._zeros[:n]
            logits = self.model(
                tokens, positions, self.arena, zeros, lens, zeros,
                block_tables=self._device_tables()[rows_t], logit_index=lens - 1,
            )
            tok0 = self._sample(logits[:, 0], lens, rows=rows_t)
        except BaseException:
            self._deactivate(rows)
            for row in rows:
                self._release_row(row)
                self.slots[row] = _Slot()
            raise
        try:
            # fault site "insert": a fault while the group's state joins the
            # engine's rows leaves that state unknown, so the engine resets
            faults.maybe_fail("insert")
            self._kv_len[rows_t] = lens.to(torch.int32)
            self._last_tok[rows_t] = tok0
            self._active[rows_t] = True
            tok0_h = tok0.cpu().tolist()  # the one fetch of the group
        except Exception as e:  # noqa: BLE001 — every row's state is suspect
            self.reset()
            raise EngineStateLost("insert failed; engine state reset") from e
        self._m_step_admit.observe(time.perf_counter() - t_admit)
        self.stats.prefill_calls += 1
        for r, (i, rid, _, p, max_new_c, _, _) in enumerate(chunk):
            self._start_row(rows[r], rid, p, tok0_h[r], max_new_c, S, results, i)
        self._record_prefill(t_led, S, chunk)

    def _start_row(self, row: int, rid: int, p: List[int], tok0: int, max_new_c: int, bucket: int,
                   results: Optional[List] = None, i: int = 0,
                   admit_seq: Optional[int] = None) -> Optional[List[int]]:
        """After a prompt's first token: the row decodes on, or the request
        ends here (EOS or a budget of one) and the row is released. Returns
        the finished tokens, or None."""
        self.stats.generate_calls += 1
        self.stats.prefill_tokens += len(p)
        flight.emit("admit", rid, slot=row, prompt_len=len(p), bucket=bucket, tok0=tok0,
                    **_tenant_attr(self.ledger, rid))
        finished = None
        if tok0 in self.config.eos_token_ids or max_new_c <= 1:
            finished = [] if tok0 in self.config.eos_token_ids else [tok0]
            self._deactivate([row])
            self._note_footprint(rid, row)
            self._release_row(row)
            self.slots[row] = _Slot()
        else:
            if admit_seq is None:
                self._admit_seq += 1
                admit_seq = self._admit_seq
            self.slots[row] = _Slot(
                request_id=rid, tokens=[tok0], remaining=max_new_c - 1, active=True,
                kv_ub=len(p), admit_seq=admit_seq,
                history=(list(p) + [tok0]) if self.spec_on else [], prompt_len=len(p),
            )
        self.stats.decode_tokens += 1 if tok0 not in self.config.eos_token_ids else 0
        if results is not None:
            results[i] = (row, finished)
        return finished

    def _queue_chunk_admission(self, entry, row: int) -> None:
        """Reserve ``row`` for an interleaved admission: no device work
        beyond staging the row's sampling state."""
        _, rid, S, p, max_new_c, seed, samp = entry
        self._set_row_sampling(row, seed, samp)
        self._admit_seq += 1
        self.slots[row] = _Slot(request_id=rid, prefilling=True, admit_seq=self._admit_seq)
        self._chunk_admissions[rid] = {
            "row": row, "prompt": p, "progress": 0, "max_new": max_new_c, "bucket": S,
            "admit_seq": self._admit_seq,
            # the TTFT anchor: the scheduler sets the request's submit time
            # (None for a resubmission or a resume, which observe no TTFT);
            # an engine driven directly falls back to the queue time
            "t_admit": time.monotonic(),
        }

    def step(self) -> List[Tuple[int, List[int]]]:
        """One device window and one token fetch; returns the requests that
        finished as ``(request_id, tokens)`` (EOS excluded) and frees their
        rows. The ``decode_step`` fault site comes first. Then, as the JAX
        engine routes: a mixed window while interleaved admissions are
        pending; under ``spec_paged`` a verify window when some row drafted
        and verifying is expected to retire at least as many tokens as a
        plain window (``_verify_worthwhile``); else ``decode_sync_steps``
        plain decode steps. The choice, and a verify window's drafts, are
        made here, on rank 0 of a mesh, and travel in the command."""
        if self.interleave_on and self._chunk_admissions:
            return self._step("mixed")
        if self.spec_on:
            drafts = self._draft_for_slots()
            if any(drafts.values()) and self._verify_worthwhile(drafts):
                return self._step("verify", drafts)
        return self._step("decode")

    @mesh_command
    @torch.inference_mode()
    def _step(self, window: str, drafts: Optional[Dict[int, List[int]]] = None) -> List[Tuple[int, List[int]]]:
        faults.maybe_fail("decode_step")
        if window == "mixed":
            return self._step_mixed()
        if window == "verify":
            return self._step_verify(drafts)
        t_w = time.perf_counter()  # the ledger window: block growth included
        if self.paged:
            self._ensure_decode_blocks()
            if not self.has_active():
                # every row was preempted: the scheduler was busy all the
                # same, and the stall is the preempted requests'
                self._journal_window(self.ledger.record_preempt_stall(
                    time.perf_counter() - t_w, [rid for rid, _ in self._preempted]))
                return []
        if not self.has_active():
            return []
        k, Tmax, dev = self.sync_steps, self.T, self.device
        flight.emit("sync_window_open", steps=k, active=sum(1 for s in self.slots if s.active))
        # context resident at dispatch (host mirror): the window's KV reads
        # in the roofline's bytes (0 under the dense cache, as in JAX)
        ctx = sum(s.kv_ub for s in self.slots if s.active) if self.paged else 0
        t0 = time.perf_counter()
        tables = self._device_tables() if self.paged else None
        kv_len, last_tok, active = self._kv_len, self._last_tok, self._active
        toks, eoss = [], []
        for _ in range(k):
            wi = torch.where(active, kv_len, self._zeros)
            if self.paged:
                # inactive rows (EOS inside the window, or free) write into
                # the null block, never table[row, 0]
                tables_eff = torch.where(active[:, None], tables, torch.zeros((), dtype=tables.dtype, device=dev))
                logits = self.model(
                    last_tok[:, None], wi[:, None].long(), self.arena, self._zeros, wi + 1, wi,
                    block_tables=tables_eff,
                )
                pos = wi
            else:
                # dense rows are left-padded: a token's position is its slot
                # less the row's kv_start. An inactive row parks at slot 0 of
                # its own row, over the one-key window [0, 1)
                ks = torch.where(active, self._kv_start, self._zeros)
                pos = (wi - ks).clamp(min=0)
                logits = self.model(
                    last_tok[:, None], pos[:, None].long(), self.cache, ks, wi + 1, wi, row_frontier=True,
                )
            tok = self._sample(logits[:, 0], pos + 1)
            hit_eos = torch.isin(tok, self._eos)
            kv_len = torch.where(active, torch.clamp(wi + 1, max=Tmax - 1), kv_len)
            last_tok = tok
            active = active & ~hit_eos
            toks.append(tok)
            eoss.append(hit_eos)
        self._kv_len, self._last_tok, self._active = kv_len, last_tok, active
        host = torch.stack(toks + [e.long() for e in eoss]).cpu().numpy()  # the one fetch
        tok_h, eos_h = host[:k], host[k:]
        t_fetch = time.perf_counter()
        self._m_itl.observe((t_fetch - t0) / k)
        self._m_step_device.observe(t_fetch - t0)
        self.stats.decode_window_s += t_fetch - t0
        self.stats.windows += 1
        for slot in self.slots:
            if slot.active:
                slot.kv_ub = min(slot.kv_ub + k, Tmax - 1)
        done: List[Tuple[int, List[int]]] = []
        retire = []
        kept: Dict[int, int] = {}  # request id -> tokens this window kept
        for i, slot in enumerate(self.slots):
            if not slot.active:
                continue
            finished = False
            n_kept = 0
            for j in range(k):
                if eos_h[j, i]:
                    finished = True  # EOS itself is not emitted
                    break
                slot.tokens.append(int(tok_h[j, i]))
                if self.spec_on:
                    slot.history.append(int(tok_h[j, i]))
                slot.remaining -= 1
                self.stats.decode_tokens += 1
                n_kept += 1
                if slot.remaining <= 0:
                    finished = True
                    break
            kept[slot.request_id] = n_kept
            if finished:
                done.append((slot.request_id, slot.tokens))
                self._emit_eos(slot)
                retire.append(i)
        self._retire(retire)
        self._m_step_drain.observe(time.perf_counter() - t_fetch)
        self._journal_window(self.ledger.record_decode(
            time.perf_counter() - t_w, batch=self.B, steps=k, kept=kept, ctx_tokens=ctx))
        self._journal_emitted()
        flight.emit("sync_window_close", steps=k, done=len(done),
                    duration_ms=round((time.perf_counter() - t0) * 1e3, 3))
        return done

    @staticmethod
    def _emit_eos(slot: "_Slot") -> None:
        """A row's stream ended in this window: by its budget, or by EOS."""
        flight.emit("eos", slot.request_id, reason="budget" if slot.remaining <= 0 else "eos",
                    n_tokens=len(slot.tokens))

    def _retire(self, rows: List[int]) -> None:
        self._deactivate(rows)
        for r in rows:
            self._note_footprint(self.slots[r].request_id, r)
            self._release_row(r)
            self.slots[r] = _Slot()

    def _step_mixed(self) -> List[Tuple[int, List[int]]]:
        """One mixed window: every active row advances one decode token
        (lane 0 fed from the device-resident last token) and a budgeted
        slice of each pending admission prefills, oldest first, through one
        chunked forward. A final chunk samples the prompt's first token
        from its last real lane."""
        C, Tmax, B = self.chunk_tokens, self.T, self.B
        t_w = time.perf_counter()  # the ledger window: planning and growth included
        self._ensure_decode_blocks(horizon={})
        n_dec = sum(1 for s in self.slots if s.active)
        sched = []  # (rid, rec, offset, take, final)
        for rid, off, take, final in policy.plan_mixed_window(
            [(rid, len(rec["prompt"]), rec["progress"]) for rid, rec in self._chunk_admissions.items()],
            self.window_budget, n_dec, C,
        ):
            rec = self._chunk_admissions[rid]
            row = rec["row"]
            need, have = self.kv_pool.blocks_for(off + take), len(self._slot_blocks[row])
            if need > have:
                ids = self._alloc_chunk_blocks(need - have)
                if ids is None:
                    break  # the younger admissions idle this window
                self._assign_row_blocks(row, ids, start_block=have)
            sched.append((rid, rec, off, take, final))
        flight.emit("window_budget", budget=self.window_budget, decode_lanes=n_dec,
                    chunk_tokens=sum(t for _, _, _, t, _ in sched), chunks=len(sched),
                    queued=len(self._chunk_admissions))
        for rid, rec, off, take, final in sched:
            flight.emit("prefill_chunk_sched", rid, offset=off, tokens=take,
                        remaining=len(rec["prompt"]) - off - take, final=int(final))
        if not sched and n_dec == 0:
            # nothing decodes and the pool cannot stage the oldest
            # admission: preempt the newest instead of spinning
            if self._chunk_admissions:
                self._preempt_chunk_admission(*self._chunk_admissions.popitem())
            self._journal_window(self.ledger.record_preempt_stall(
                time.perf_counter() - t_w, [r for r, _ in self._preempted], kind="prefill"))
            return []
        flight.emit("sync_window_open", steps=1, active=n_dec + len(sched))
        # host-fed window inputs in one upload: fed lanes | n_fed | base | final
        host = np.zeros((B, C + 3), np.int64)
        host[:, :C] = self.pad_id
        for rid, rec, off, take, final in sched:
            row = rec["row"]
            host[row, :take] = rec["prompt"][off:off + take]
            host[row, C], host[row, C + 1], host[row, C + 2] = take, off, int(final)
        # context resident at dispatch: the decode rows' frontiers plus each
        # chunk's attended prefix, its own slice included
        ctx = sum(s.kv_ub for s in self.slots if s.active) + sum(off + take for _, _, off, take, _ in sched)
        t0 = time.perf_counter()
        dh = self._h2d(host)
        fed, n_fed, chunk_base, final_v = dh[:, :C], dh[:, C], dh[:, C + 1], dh[:, C + 2].bool()
        kv_len, last_tok, active = self._kv_len.long(), self._last_tok, self._active
        is_chunk = n_fed > 0
        is_dec = active & ~is_chunk
        n_eff = torch.where(is_dec, torch.ones_like(n_fed), n_fed)
        part = n_eff > 0
        base = torch.where(is_chunk, chunk_base, torch.where(active, kv_len, torch.zeros_like(kv_len)))
        lanes = torch.arange(C, device=self.device)
        fed_eff = torch.where(is_dec[:, None] & (lanes == 0)[None, :], last_tok[:, None], fed)
        tables = self._device_tables()
        tables_eff = torch.where(part[:, None], tables, torch.zeros((), dtype=tables.dtype, device=self.device))
        logits = self.model(
            fed_eff, base[:, None] + lanes[None, :], self.arena, self._zeros, base + n_eff, base,
            chunked=True, block_tables=tables_eff, logit_index=(n_eff - 1).clamp(min=0),
        )
        tok = self._sample(logits[:, 0], base + n_eff)
        hit_eos = torch.isin(tok, self._eos)
        self._kv_len = torch.where(part, torch.clamp(base + n_eff, max=Tmax - 1), kv_len).to(torch.int32)
        self._last_tok = torch.where(is_dec | final_v, tok, last_tok)
        self._active = (active | final_v) & ~hit_eos
        tok_h = torch.stack([tok, hit_eos.long()]).cpu().numpy()  # the one fetch
        t_fetch = time.perf_counter()
        self._m_itl.observe(t_fetch - t0)
        self._m_step_device.observe(t_fetch - t0)
        self.stats.mixed_window_s += t_fetch - t0
        self.stats.windows += 1
        self.stats.mixed_windows += 1
        for slot in self.slots:
            if slot.active:
                slot.kv_ub = min(slot.kv_ub + 1, Tmax - 1)
        done: List[Tuple[int, List[int]]] = []
        retire = []
        kept: Dict[int, int] = {}  # request id -> decode tokens kept
        for i, slot in enumerate(self.slots):
            if not slot.active:
                continue
            finished = bool(tok_h[1, i])
            kept[slot.request_id] = 0
            if not finished:
                slot.tokens.append(int(tok_h[0, i]))
                if self.spec_on:
                    slot.history.append(int(tok_h[0, i]))
                slot.remaining -= 1
                self.stats.decode_tokens += 1
                kept[slot.request_id] = 1
                finished = slot.remaining <= 0
            if finished:
                done.append((slot.request_id, slot.tokens))
                self._emit_eos(slot)
                retire.append(i)
        self._retire(retire)
        chunk_led: Dict[int, int] = {}  # request id -> prefill lanes fed
        for rid, rec, off, take, final in sched:
            rec["progress"] = off + take
            chunk_led[rid] = take
            if not final:
                continue
            del self._chunk_admissions[rid]
            ts = rec.get("t_submit", rec["t_admit"])
            if ts is not None:
                self._m_ttft.observe(time.monotonic() - ts)
            out = self._start_row(rec["row"], rid, rec["prompt"], int(tok_h[0, rec["row"]]),
                                  rec["max_new"], rec["bucket"], admit_seq=rec["admit_seq"])
            if out is not None:
                done.append((rid, out))
        self._m_step_drain.observe(time.perf_counter() - t_fetch)
        self._journal_window(self.ledger.record_mixed(
            time.perf_counter() - t_w, batch=self.B, lanes=C, decode_kept=kept, chunk_rows=chunk_led,
            rework=self._take_rework(chunk_led), ctx_tokens=ctx))
        self._journal_emitted()
        flight.emit("sync_window_close", steps=1, done=len(done),
                    duration_ms=round((time.perf_counter() - t0) * 1e3, 3))
        return done

    # ------------------------------------------------------------------
    # speculative verify windows (spec_paged)
    # ------------------------------------------------------------------
    def _draft_for_slots(self) -> Dict[int, List[int]]:
        """This window's draft per active row (JAX ``_draft_for_slots``):
        prompt lookup over the row's own history, length-capped by its
        acceptance EMA, its remaining budget (tokens past it are discarded)
        and the row's top (an accepted frontier past ``T`` cannot be
        mapped). An empty list means a plain decode step for the row."""
        out: Dict[int, List[int]] = {}
        for row, slot in enumerate(self.slots):
            if not slot.active:
                continue
            k_row = adaptive_draft_len(slot.spec_ema, self.spec_K, self.spec_min_accept)
            k_row = min(k_row, slot.remaining - 1, self.T - 2 - slot.kv_ub)
            out[row] = prompt_lookup_draft(slot.history, self.spec_ngram, k_row) if k_row >= 1 else []
        return out

    def _verify_worthwhile(self, drafts: Dict[int, List[int]]) -> bool:
        """Whether this window verifies instead of running the plain path
        (JAX ``_verify_worthwhile``): a verify window retires ``1 +
        accepted`` tokens per row in one forward, a plain window
        ``decode_sync_steps`` per row. At ``k == 1`` any draft wins; at
        ``k > 1`` the EMA-expected verify yield must reach ``k`` per active
        row (a row with no EMA yet counts as accepting everything)."""
        k = self.sync_steps
        if k <= 1:
            return True
        n_active, expected = 0, 0.0
        for row, slot in enumerate(self.slots):
            if not slot.active:
                continue
            n_active += 1
            d = drafts.get(row)
            ema = 1.0 if slot.spec_ema is None else slot.spec_ema
            expected += 1.0 + (ema * len(d) if d else 0.0)
        return expected >= n_active * k

    def _step_verify(self, drafts: Dict[int, List[int]]) -> List[Tuple[int, List[int]]]:
        """One verify window (JAX ``_step_verify`` and
        ``_build_verify_paged``): each row's blocks grow for its own ``nd +
        1`` writes (exhaustion preempts the newest rows, as a plain window
        does), then ONE forward feeds ``[last_tok, drafts]`` at positions
        ``wi + arange(K + 1)`` through ``paged_chunk_attention`` with
        ``kv_len = wi + 1 + nd``; targets and acceptance stay on the card,
        and one fetch brings ``(emitted [K + 1, B], n_emit, eos, m)``. The
        host drains up to ``m + 1`` tokens per row.

        Rejected lanes need no retraction: their writes land past the new
        frontier, where no window reads before the next write. Lanes past a
        row's own drafts write past its frontier or, past its table, into
        the null block; inactive rows write into the null block."""
        K, S, B, Tmax, dev = self.spec_K, self.spec_K + 1, self.B, self.T, self.device
        t_w = time.perf_counter()  # the ledger window: block growth included
        self._ensure_decode_blocks({row: len(d) + 1 for row, d in drafts.items()})
        if not self.has_active():
            self._journal_window(self.ledger.record_preempt_stall(
                time.perf_counter() - t_w, [rid for rid, _ in self._preempted]))
            return []
        # drafts | n_drafts in one upload
        host = np.zeros((B, K + 1), np.int64)
        for row, d in drafts.items():
            if d and self.slots[row].active:
                host[row, :len(d)] = d
                host[row, K] = len(d)
        n_active = sum(1 for s in self.slots if s.active)
        drafted_total = int(host[:, K].sum())
        drafted_rows = int((host[:, K] > 0).sum())
        flight.emit("spec_draft", rows=drafted_rows, active=n_active, drafted=drafted_total)
        flight.emit("sync_window_open", steps=1, active=n_active, spec=1)
        t0 = time.perf_counter()
        dh = self._h2d(host)
        kv_len, last_tok, active = self._kv_len.long(), self._last_tok, self._active
        wi = torch.where(active, kv_len, torch.zeros_like(kv_len))
        nd = torch.where(active, dh[:, K], torch.zeros_like(kv_len))
        d_t = dh[:, :K]
        tables = self._device_tables()
        tables_eff = torch.where(active[:, None], tables, torch.zeros((), dtype=tables.dtype, device=dev))
        fed = torch.cat([last_tok[:, None], d_t], dim=1)
        pos = wi[:, None] + torch.arange(S, device=dev)[None, :]
        # the deepest real lane (j = nd) sees keys <= wi + nd; the junk
        # lanes past it see that window too, and nobody samples them
        logits = self.model(fed, pos, self.arena, self._zeros, wi + 1 + nd, wi, chunked=True,
                            block_tables=tables_eff)
        targets = self._sample_targets(logits, pos + 1)
        m, emitted = accept_drafts(d_t, targets, nd)
        is_eos = torch.isin(emitted, self._eos)
        hit_eos = (is_eos & (torch.arange(S, device=dev)[None, :] <= m[:, None])).any(dim=1)
        # last_tok's KV at wi and the accepted drafts' at wi+1..wi+m are
        # valid; the correction (plane m) is the new last token, written
        # next window: the same bookkeeping as m + 1 plain steps
        self._kv_len = torch.where(active, torch.clamp(wi + m + 1, max=Tmax - 1), kv_len).to(torch.int32)
        self._last_tok = torch.where(active, torch.gather(emitted, 1, m[:, None])[:, 0], last_tok)
        n_emit = torch.where(active, m + 1, torch.zeros_like(m))
        self._active = active & ~hit_eos
        # the one fetch: emitted [S, B] | eos [S, B] | n_emit | m
        out = torch.cat([emitted.t(), is_eos.t().long(), n_emit[None], m[None]]).cpu().numpy()
        tok_h, eos_h, ne_h, acc_h = out[:S], out[S:2 * S], out[2 * S], out[2 * S + 1]
        t_fetch = time.perf_counter()
        emitted_total = int(ne_h.sum())
        # per-row per-token latency, as a plain window's window / k
        self._m_itl.observe((t_fetch - t0) * n_active / max(emitted_total, 1))
        self._m_step_device.observe(t_fetch - t0)
        st = self.stats
        st.verify_window_s += t_fetch - t0
        st.windows += 1
        done: List[Tuple[int, List[int]]] = []
        retire = []
        accepted_total = 0
        # request id -> (tokens kept, drafts offered, drafts accepted)
        led_rows: Dict[int, Tuple[int, int, int]] = {}
        for i, slot in enumerate(self.slots):
            if not slot.active:
                continue
            offered, acc = int(host[i, K]), int(acc_h[i])
            accepted_total += acc
            if offered and self._leader:
                self._spec_rids.add(slot.request_id)
            slot.spec_ema = fold_acceptance(slot.spec_ema, offered, acc)
            # the exact new frontier, not an upper bound
            slot.kv_ub = min(slot.kv_ub + int(ne_h[i]), Tmax - 1)
            finished = False
            n_kept = 0
            for j in range(int(ne_h[i])):
                if eos_h[j, i]:
                    finished = True  # EOS itself is not emitted
                    break
                slot.tokens.append(int(tok_h[j, i]))
                slot.history.append(int(tok_h[j, i]))
                slot.remaining -= 1
                st.decode_tokens += 1
                n_kept += 1
                if slot.remaining <= 0:
                    finished = True  # tokens past the budget are discarded
                    break
            led_rows[slot.request_id] = (n_kept, offered, acc)
            if finished:
                done.append((slot.request_id, slot.tokens))
                self._emit_eos(slot)
                retire.append(i)
        st.spec_verify_steps += 1
        st.spec_drafted_rows += drafted_rows
        st.spec_drafted_tokens += drafted_total
        st.spec_accepted_tokens += accepted_total
        st.spec_emitted_tokens += emitted_total
        flight.emit("spec_verify", drafted=drafted_total, accepted=accepted_total,
                    rejected=drafted_total - accepted_total, emitted=emitted_total)
        self._retire(retire)
        self._m_step_drain.observe(time.perf_counter() - t_fetch)
        self._journal_window(self.ledger.record_verify(
            time.perf_counter() - t_w, batch=B, lanes_per_row=K + 1, rows=led_rows,
            ctx_tokens=sum(s.kv_ub for s in self.slots if s.active)))
        self._journal_emitted()
        flight.emit("sync_window_close", steps=1, done=len(done),
                    duration_ms=round((time.perf_counter() - t0) * 1e3, 3))
        return done

    def _journal_emitted(self) -> None:
        """The flight-WAL watermark pass, after every window (JAX
        ``_journal_emitted``): each live row's tokens past its watermark as
        one ``token_emit`` event, so a request's ``token_emit`` events in seq
        order rebuild its emitted stream, the state a warm restart resumes
        from. A no-op without a WAL. Tokens after the last journaled window
        are recomputed on resume."""
        if not flight.wal_enabled():
            return
        for slot in self.slots:
            if slot.active and len(slot.tokens) > slot.wal_mark:
                flight.emit("token_emit", slot.request_id, toks=slot.tokens[slot.wal_mark:])
                slot.wal_mark = len(slot.tokens)

    # ------------------------------------------------------------------
    # prefill -> decode migration (pool roles)
    # ------------------------------------------------------------------
    def _gather_planes(self, ids: List[int]) -> Tuple[torch.Tensor, ...]:
        """The arena's planes (payload, and int8 scales) at blocks ``ids``,
        copied into new tensors ``[L, len(ids), ...]``."""
        idx = self._h2d(np.asarray(ids, np.int64))
        return tuple(a.index_select(1, idx) for a in self._cache_planes(self.arena))

    def _scatter_planes(self, ids: List[int], planes: Sequence[torch.Tensor]) -> None:
        """Write ``planes`` into the arena's blocks ``ids``, in place."""
        idx = self._h2d(np.asarray(ids, np.int64))
        for dst, src in zip(self._cache_planes(self.arena), planes):
            dst.index_copy_(1, idx, src.to(device=dst.device, dtype=dst.dtype))

    @mesh_command
    @torch.inference_mode()
    def export_request(self, request_id: int) -> Optional[dict]:
        """Take a just-admitted request off this engine as a migration
        packet (JAX ``export_request``): its blocks' planes gathered into new
        tensors, its frontier, tokens, budget and sampling state (the seed
        and the per-row sampling its keyed draw reads), then the row
        released, so after an export this engine holds nothing of the
        request. None for a request that is unknown, finished or still
        prefilling in chunks (the scheduler then decodes it here). Nothing
        is released before the gather returns, so a failed gather leaves
        the engine intact. ``nb_pad`` (the admission bucket's block count)
        is kept for parity with the JAX packet; nothing pads to it here."""
        if not self.paged or request_id in self._chunk_admissions:
            return None
        row = next((i for i, s in enumerate(self.slots) if s.active and s.request_id == request_id), None)
        if row is None:
            return None
        slot = self.slots[row]
        ids = list(self._slot_blocks[row])
        t0 = time.perf_counter()
        planes = self._gather_planes(ids)
        if self._mesh_name is not None:
            # each rank keeps its own head slice: rank 0's packet names it
            planes = SharedPlanes(planes)
        seed, samp = self._row_sampling[row]
        packet = {
            "request_id": request_id,
            "planes": planes,
            "n_blocks": len(ids),
            "nb_pad": policy.bucket_len(max(slot.prompt_len, 1), self.buckets) // self.block_size,
            "kv_len": slot.kv_ub,
            "tokens": list(slot.tokens),
            "remaining": slot.remaining,
            "prompt_len": slot.prompt_len,
            "seed": seed,
            "sampling": samp,
            "history": list(slot.history) if self.spec_on else [],
        }
        self._deactivate([row])
        self._note_footprint(request_id, row)
        self._release_row(row)
        self.slots[row] = _Slot()
        flight.emit("migrate_begin", request_id, blocks=len(ids), kv_len=packet["kv_len"],
                    duration_ms=round((time.perf_counter() - t0) * 1e3, 3), **_tenant_attr(self.ledger, request_id))
        return packet

    @mesh_command
    @torch.inference_mode()
    def import_request(self, packet: dict) -> int:
        """Land a migration packet in a free row (JAX ``import_request``):
        allocate its blocks first (``PoolExhausted`` propagates before
        anything is written, and the packet stays valid), then, past the
        ``migrate`` fault site, scatter the planes in and set the row's
        frontier, last token, active flag and sampling state, so its next
        draw at ``kv_len`` is the one the exporting engine would have made.
        A failure there resets this engine and raises ``EngineStateLost``
        (the scheduler re-prefills prompt plus emitted tokens). With
        ``spec_paged`` on, the row's draft corpus is the packet's history,
        or its prompt and tokens when the exporter kept none. Returns the
        row."""
        if not self.paged:
            raise ValueError("import_request requires kv_paged=True")
        free = self.free_slots()
        if not free:
            raise RuntimeError("import_request without a free row")
        mine = self._cache_planes(self.arena)
        planes = packet["planes"]
        if len(planes) != len(mine) or any(
                p.shape[0] != a.shape[0] or p.shape[2:] != a.shape[2:] or p.shape[1] != packet["n_blocks"]
                for p, a in zip(planes, mine)):
            raise ValueError(
                f"migration packet planes {[tuple(p.shape) for p in planes]} do not fit this engine's arena "
                f"{[tuple(a.shape) for a in mine]}"
            )
        rid = packet["request_id"]
        ids = self.kv_pool.alloc(packet["n_blocks"])  # PoolExhausted: backpressure
        row = free[0]
        t0 = time.perf_counter()
        self._assign_row_blocks(row, ids)
        tokens = list(packet["tokens"])
        try:
            # fault site "migrate": a fault while the packet lands leaves the
            # arena and the row state unknown, so the engine resets
            faults.maybe_fail("migrate")
            self._scatter_planes(ids, planes)
            self._set_row_sampling(row, packet["seed"], packet["sampling"])
            self._kv_len[row] = int(packet["kv_len"])
            self._last_tok[row] = int(tokens[-1])
            self._active[row] = True
        except Exception as e:  # noqa: BLE001 — every row's state is suspect
            self.reset()
            raise EngineStateLost("migrate import failed; engine state reset") from e
        history = []
        if self.spec_on:
            history = list(packet["history"]) or list(packet.get("prompt", ())) + tokens
        self._admit_seq += 1
        self.slots[row] = _Slot(
            request_id=rid, tokens=tokens, remaining=int(packet["remaining"]), active=True,
            kv_ub=int(packet["kv_len"]), admit_seq=self._admit_seq, history=history,
            prompt_len=int(packet["prompt_len"]),
        )
        flight.emit("migrate_done", rid, slot=row, blocks=len(ids), kv_len=int(packet["kv_len"]),
                    duration_ms=round((time.perf_counter() - t0) * 1e3, 3), **_tenant_attr(self.ledger, rid))
        return row

    # ------------------------------------------------------------------
    # prefixed admission and pool prefix registrations (scheduler thread)
    # ------------------------------------------------------------------
    def admit_prefixed(
        self,
        request_id: int,
        suffix: Sequence[int],
        prefix,  # CachedPrefix (engine/prefix_cache.py)
        max_new: int,
        seed: Optional[int] = None,
    ) -> Tuple[int, Optional[List[int]]]:
        """Admit one request whose prompt head is a cached prefix (JAX
        ``admit_prefixed``): the prefix KV comes from the descriptor (or a
        pool registration), only the suffix prefills. Returns ``(row,
        finished)`` as ``admit_many`` does per item. Raises ValueError when
        the shapes do not fit a row (the caller falls back to a plain
        admission); ``PoolExhausted`` (paged) before anything is written.
        The seed is resolved here, before a mesh command carries it."""
        return self._admit_prefixed(request_id, list(suffix), prefix, max_new, self._row_seed(seed))

    @mesh_command
    @torch.inference_mode()
    def _admit_prefixed(self, request_id: int, suffix: List[int], prefix, max_new: int, seed: int):
        free = self.free_slots()
        assert free, "admit_prefixed() without a free slot"
        if not suffix:
            # the first token would be drawn from a pad token's logits
            raise ValueError("admit_prefixed needs a non-empty suffix")
        pc = self.engine_config.prefix_cache
        if pc is None or prefix.capacity != pc.max_prefix_tokens:
            raise ValueError("prefix descriptor does not match this engine's config")
        total = prefix.length + len(suffix)
        S = policy.bucket_len(max(total, 1), self.buckets)
        if total > S:
            raise ValueError(f"prefixed prompt of {total} tokens exceeds the largest continuous bucket {S}")
        if len(suffix) > max(pc.suffix_buckets):
            raise ValueError(
                f"prefixed suffix of {len(suffix)} tokens exceeds the largest suffix bucket {max(pc.suffix_buckets)}"
            )
        C = policy.bucket_len(max(len(suffix), 1), pc.suffix_buckets)
        max_new_c = policy.clamp_max_new(max_new, S, self.T)
        toks = np.full((1, C), self.pad_id, np.int64)
        toks[0, :len(suffix)] = list(suffix)
        row = free[0]
        if self.paged:
            return self._admit_prefixed_paged(request_id, suffix, prefix, C, max_new_c, row, seed, toks)
        return self._admit_prefixed_dense(request_id, suffix, prefix, S, C, max_new_c, row, seed, toks)

    def _admit_prefixed_dense(self, request_id, suffix, prefix, S, C, max_new_c, row, seed, toks):
        """Dense tail of ``admit_prefixed`` (JAX ``_build_prefill_prefixed``
        and ``_insert``): the prefix planes spliced into a fresh ``[L, 1, K,
        T_build]`` row cache at slot ``start = S - total`` (left padding, so
        the row's tokens end at slot ``S``), the suffix prefilled as one chunk
        at slot ``start + plen`` (``chunk_prefill_attention`` over ``[start,
        S)``), then slots ``[0, S)`` copied into the engine's row. ``T_build
        = ceil128(S + P + C)`` keeps the P-wide splice and the C-wide suffix
        write inside the build cache wherever ``start`` lands."""
        P = int(prefix.capacity)
        plen, slen = int(prefix.length), len(suffix)
        total = plen + slen
        start = S - total
        t_admit = time.perf_counter()
        T_build = -(-(S + P + C) // 128) * 128
        self._set_row_sampling(row, seed, self.sampling)
        # tokens | kv_start | kv_len | logit index | draw position | row, in one upload
        host = np.zeros((1, C + 5), np.int64)
        host[0, :C] = toks[0]
        host[0, C:] = (start, S, slen - 1, total, row)
        dh = self._h2d(host)
        cache = make_kv_cache(self.local, 1, T_build, self.dtypes.compute_dtype, self.device,
                              self.engine_config.kv_quant)
        for c, b in zip(self._cache_planes(cache), prefix.planes):
            c[:, :, :, start:start + b.shape[3]] = b.to(c.dtype)
        positions = plen + torch.arange(C, device=self.device)[None, :]
        logits = self.model(dh[:, :C], positions, cache, dh[:, C], dh[:, C + 1], start + plen, chunked=True,
                            logit_index=dh[:, C + 2])
        tok0 = self._sample(logits[:, 0], dh[:, C + 3], rows=dh[:, C + 4])
        try:
            for dst, src in zip(self._cache_planes(), self._cache_planes(cache)):
                dst[:, row, :, :S] = src[:, 0, :, :S]
            self._kv_start[row] = start
            self._kv_len[row] = S
            self._last_tok[row] = tok0[0]
            tok0_h = int(tok0.item())  # the one fetch
        except BaseException as e:  # noqa: BLE001 — the row's state is half written
            self.reset()
            raise EngineStateLost("insert failed; engine state reset") from e
        del cache
        self._m_step_admit.observe(time.perf_counter() - t_admit)
        return self._start_prefixed_row(row, request_id, suffix, plen, tok0_h, max_new_c, kv_ub=S,
                                        t_admit=t_admit, bucket=C)

    def _start_prefixed_row(self, row: int, rid: int, suffix, plen: int, tok0: int, max_new_c: int, kv_ub: int,
                            t_admit: float, bucket: int, shared_tok: Optional[int] = None):
        """After a prefixed admission's first token: the stats, the
        ``admit`` event and the ``prefill_px`` ledger window (JAX's), then
        the row decodes on or the request ends here (EOS or a budget of
        one) and the row is released."""
        total = plen + len(suffix)
        st = self.stats
        st.generate_calls += 1
        st.prefill_tokens += len(suffix)
        st.prefill_tokens_skipped += plen
        extra = {} if shared_tok is None else {"shared": shared_tok}
        flight.emit("admit", rid, slot=row, prompt_len=total, prefix_len=plen, tok0=tok0, **extra,
                    **_tenant_attr(self.ledger, rid))
        self._journal_window(self.ledger.record_prefill_px(
            time.perf_counter() - t_admit, bucket=bucket, rid=rid, computed=len(suffix), skipped=plen,
            rework=bool(self._take_rework((rid,)))))
        if tok0 in self.config.eos_token_ids or max_new_c <= 1:
            out = [] if tok0 in self.config.eos_token_ids else [tok0]
            st.decode_tokens += len(out)
            self._deactivate([row])
            self._note_footprint(rid, row)
            self._release_row(row)
            self.slots[row] = _Slot()
            return row, out
        self._active[row] = True
        self._admit_seq += 1
        self.slots[row] = _Slot(
            request_id=rid, tokens=[tok0], remaining=max_new_c - 1, active=True, kv_ub=kv_ub,
            admit_seq=self._admit_seq, prompt_len=total, shared_tokens=shared_tok or 0,
            # the paged verify's draft corpus: a prefixed admission carries
            # only the suffix's ids (the prefix is KV), so it starts there
            history=(list(suffix) + [tok0]) if self.spec_on else [],
        )
        st.decode_tokens += 1
        return row, None

    def _admit_prefixed_paged(self, request_id, suffix, prefix, C, max_new_c, row, seed, toks):
        """Paged tail of ``admit_prefixed`` (JAX ``_admit_prefixed_paged``):
        the full blocks of a chain registered under the descriptor's
        ``chain_key`` map into the row's table copy-free, pinned by the
        row's own ref; under ``reuse="chunk"`` an unregistered chain may
        assemble from per-chunk registrations (``_chunk_splice_plan``);
        otherwise the prefix slabs the row does not share scatter from the
        splice buffer. Then the suffix prefills as one paged chunk at
        logical ``plen`` over the row's table. A first sighting registers
        its full blocks (and, under chunk reuse, its exact spans) for the
        next admission. A failure once the arena is being written resets
        the engine (``EngineStateLost``)."""
        t_admit = time.perf_counter()
        bs = self.block_size
        plen, slen = int(prefix.length), len(suffix)
        total = plen + slen
        P = int(prefix.capacity)
        if P % bs:
            raise ValueError(f"prefix capacity {P} not a multiple of kv_block_size {bs}")
        key = getattr(prefix, "chain_key", None)
        shared_ids: List[int] = []
        if key is not None:
            entry = self._prefix_blocks.get(key)
            if entry is not None and entry[2] == plen:
                shared_ids = list(entry[0])
                self._prefix_uses[key] = self._prefix_uses.get(key, 0) + 1
        plan = None if shared_ids else self._chunk_splice_plan(prefix)
        covered = len(shared_ids)
        priv = self.kv_pool.alloc(self.kv_pool.blocks_for(max(total, 1)) - covered)  # PoolExhausted: the caller's
        if shared_ids:
            self.kv_pool.ref(shared_ids)  # the row's own pin
        ids_all = shared_ids + priv
        self._assign_row_blocks(row, ids_all)
        nbp = P // bs
        scatter_ids = np.zeros((nbp,), np.int64)
        if plan is None:
            for j in range(covered, min(self.kv_pool.blocks_for(plen), nbp)):
                scatter_ids[j] = ids_all[j]
        self._set_row_sampling(row, seed, self.sampling)
        try:
            if plan is not None:
                self._chunk_splice_into_row(row, ids_all, plan)
            elif scatter_ids.any():
                self._scatter_prefix(prefix.planes, scatter_ids)
            tok0 = self._prefill_px_paged(row, toks, slen, plen)
            self._kv_len[row] = total
            self._last_tok[row] = tok0[0]
            tok0_h = int(tok0.item())  # the one fetch
        except BaseException as e:  # noqa: BLE001 — the arena is half written
            self.reset()
            raise EngineStateLost("prefixed insert failed; engine state reset") from e
        full_n = plen // bs
        shared_tok = covered * bs
        chain_registered = key is not None and not shared_ids and full_n > 0
        if chain_registered:
            reg = ids_all[:full_n]
            self.kv_pool.ref(reg)  # the registration's ref outlives the row
            self._register_prefix(key, reg, plen)
            shared_tok = full_n * bs
        if plan is None and not shared_ids:
            # only the admission that scattered the blocks may make them
            # canonical chunk copies: on a chain hit they hold an earlier
            # admission's content
            self._register_chunks_from_scatter(prefix, ids_all, chain_registered=chain_registered)
        self._m_step_admit.observe(time.perf_counter() - t_admit)
        return self._start_prefixed_row(row, request_id, suffix, plen, tok0_h, max_new_c, kv_ub=total,
                                        t_admit=t_admit, bucket=C, shared_tok=shared_tok)

    def _prefix_slabs(self, plane: torch.Tensor, nbp: int) -> torch.Tensor:
        """A splice-buffer plane ``[L, 1, K, P(, hd)]`` as ``nbp`` block
        slabs ``[L, nbp, K, bs(, hd)]`` in the arena's layout."""
        L, K, bs = plane.shape[0], plane.shape[2], self.block_size
        x = plane[:, 0, :, :nbp * bs]
        x = x.reshape((L, K, nbp, bs) + tuple(plane.shape[4:]))
        return x.transpose(1, 2)

    def _scatter_prefix(self, planes, scatter_ids: np.ndarray) -> None:
        """JAX ``_build_prefix_scatter``: slab ``j`` of the splice buffer
        into physical block ``scatter_ids[j]``, for every ``j`` with a block
        (JAX writes the rest into the null block, which nothing reads)."""
        sel = np.nonzero(scatter_ids)[0]
        idx = self._h2d(np.stack([sel, scatter_ids[sel]]).astype(np.int64))
        for dst, p in zip(self._cache_planes(self.arena), planes):
            slabs = self._prefix_slabs(p, len(scatter_ids)).index_select(1, idx[0])
            dst.index_copy_(1, idx[1], slabs.to(device=dst.device, dtype=dst.dtype))

    def _prefill_px_paged(self, row: int, toks: np.ndarray, slen: int, plen: int) -> torch.Tensor:
        """JAX ``_build_prefill_px_paged``: the right-padded suffix, B = 1,
        as one chunk at logical ``plen + t`` over the row's table
        (``paged_chunk_attention``, ``kv_len = plen + slen``), writing
        straight into pool blocks; the first token drawn from the last real
        lane. Pad lanes write past the row's frontier: into its own blocks,
        or through null table entries into the null block."""
        C = toks.shape[1]
        total = plen + slen
        host = np.zeros((1, C + 5), np.int64)
        host[0, :C] = toks[0]
        host[0, C:] = (total, plen, max(slen - 1, 0), total, row)
        dh = self._h2d(host)
        positions = plen + torch.arange(C, device=self.device)[None, :]
        tables = self._device_tables()[row:row + 1]
        logits = self.model(dh[:, :C], positions, self.arena, self._zeros[:1], dh[:, C], dh[:, C + 1],
                            chunked=True, block_tables=tables, logit_index=dh[:, C + 2])
        return self._sample(logits[:, 0], dh[:, C + 3], rows=dh[:, C + 4])

    @mesh_command
    def prestage_prefix(self, prefix, tier: str = "hot"):
        """Register a ``CachedPrefix``'s full blocks in the pool ahead of any
        admission (JAX ``prestage_prefix``, lookahead's paged leg; scheduler
        thread, through ``ContinuousScheduler.run_on_engine``): allocate
        ``length // block_size`` blocks, scatter the prefix into them and
        register them under the chain key, so the first admission with this
        prompt head maps them copy-free. Takes blocks only while a full
        row's growth stays free. Returns ``"registered"`` when this call made
        the registration (the caller owns its release), ``"resident"`` when
        one existed, False when nothing was staged. A ``"cold"`` tier
        registers as warm (cold blocks are not in the pool). The
        ``kv_swap_in`` fault site sits between the allocation and the
        scatter: the blocks return and nothing is staged."""
        if not self.paged:
            return False
        if tier == "cold":
            tier = "warm"
        if tier not in ("hot", "warm"):
            raise ValueError(f"prestage tier={tier!r}: expected hot|warm|cold")
        key = getattr(prefix, "chain_key", None)
        if key is None:  # "slot" prefixes are not content-identical
            return False
        pc = self.engine_config.prefix_cache
        if pc is None or prefix.capacity != pc.max_prefix_tokens:
            return False
        bs = self.block_size
        P, plen = int(prefix.capacity), int(prefix.length)
        full_n = plen // bs
        if P % bs or full_n <= 0 or full_n > P // bs:
            return False
        entry = self._prefix_blocks.get(key)
        if entry is not None and entry[2] == plen:
            return "resident"
        if not self.kv_pool.can_alloc(full_n + self.MB):
            return False  # live traffic keeps a full row's growth
        ids = self.kv_pool.alloc(full_n)
        try:
            faults.maybe_fail("kv_swap_in")
        except faults.InjectedFault:
            self.kv_pool.free(ids)
            return False
        scatter_ids = np.zeros((P // bs,), np.int64)
        scatter_ids[:full_n] = ids
        try:
            with torch.inference_mode():
                self._scatter_prefix(prefix.planes, scatter_ids)
        except BaseException as e:  # noqa: BLE001 — the arena is half written
            self.reset()  # the blocks return with everything else
            raise EngineStateLost("prefix prestage failed; engine state reset") from e
        # alloc()'s ref is the registration's (no row holds these yet)
        self._register_prefix(key, ids, plen, tier=tier)
        return "registered"

    def prestage_gen(self, chain_key):
        """The live registration's generation for ``chain_key`` (None when
        none): a deferred release presents it back (``release_prestaged(gen=)``)."""
        return self._prefix_reg_gen.get(chain_key)

    def _register_prefix(self, key, ids, plen: int, tier: str = "hot") -> int:
        """Register a chain's full blocks (the caller took the pool ref) and
        return its generation; at most 8 registrations, oldest dropped."""
        self._reg_seq += 1
        cov = len(ids) * self.block_size
        self._prefix_blocks[key] = (list(ids), cov, plen)
        self._prefix_uses[key] = 0
        self._prefix_reg_gen[key] = self._reg_seq
        self._prefix_tier[key] = tier
        self.kv_pool.account_tier(tier, len(ids))
        if tier != "hot":
            self._reclaimable_blocks += len(ids)
        self._registered_tokens += cov
        while len(self._prefix_blocks) > 8:
            self._drop_registration(next(iter(self._prefix_blocks)))
        return self._reg_seq

    def _drop_registration(self, key) -> bool:
        """The one place a chain registration dies: every side table, the
        tier ledger and the counters, then its blocks' refs."""
        entry = self._prefix_blocks.pop(key, None)
        if entry is None:
            return False
        self._prefix_uses.pop(key, None)
        self._prefix_reg_gen.pop(key, None)
        ids, cov, _ = entry
        tier = self._prefix_tier.pop(key, "hot")
        self.kv_pool.account_tier(tier, -len(ids))
        if tier != "hot":
            self._reclaimable_blocks = max(0, self._reclaimable_blocks - len(ids))
        self._registered_tokens -= cov
        self.kv_pool.free(ids)
        return True

    @mesh_command
    def set_prefix_tier(self, chain_key, tier: str) -> bool:
        """Move a registration between hotness tiers; ``"cold"`` drops it
        (its KV lives on in the prefix cache's host spill). True when
        anything changed."""
        if not self.paged:
            return False
        entry = self._prefix_blocks.get(chain_key)
        if entry is None:
            return False
        if tier == "cold":
            return self._drop_registration(chain_key)
        old = self._prefix_tier.get(chain_key, "hot")
        if old == tier:
            return False
        n = len(entry[0])
        self.kv_pool.account_tier(old, -n)
        self.kv_pool.account_tier(tier, n)
        self._prefix_tier[chain_key] = tier
        if old == "hot" and tier != "hot":
            self._reclaimable_blocks += n
        elif old != "hot" and tier == "hot":
            self._reclaimable_blocks = max(0, self._reclaimable_blocks - n)
        return True

    def retier_registrations(self, tier_fn) -> int:
        """Re-tag every registration with ``tier_fn(chain_key)`` (the
        service passes the prefix cache's ``chain_tier``); returns how many
        changed."""
        if not self.paged or not self._prefix_blocks:
            return 0
        return self._apply_tiers([(key, tier_fn(key)) for key in list(self._prefix_blocks)])

    @mesh_command
    def _apply_tiers(self, moves: List[tuple]) -> int:
        """``retier_registrations``'s moves, decided on rank 0."""
        return sum(1 for key, tier in moves if self.set_prefix_tier(key, tier))

    def tier_occupancy(self) -> Dict[str, int]:
        """The pool's tier ledger plus ``rows`` (empty dense); safe to read
        from any thread."""
        if not self.paged:
            return {}
        return self.kv_pool.tier_occupancy()

    def reclaimable_blocks(self) -> int:
        """Non-hot registered blocks a sweep can reclaim without touching a
        row: the admission gate's hint (read without a lock)."""
        if not self.paged:
            return 0
        return self._reclaimable_blocks

    @mesh_command
    def release_prestaged(self, chain_key, only_unused: bool = False, gen=None) -> bool:
        """Drop one chain registration (lookahead's stale-prefetch release):
        rows still decoding over its blocks keep their own refs.
        ``only_unused`` keeps a registration an admission has mapped since
        it was made; ``gen`` keeps one re-created at this key since."""
        if not self.paged:
            return False
        if gen is not None and self._prefix_reg_gen.get(chain_key) != gen:
            return False
        if only_unused and self._prefix_uses.get(chain_key, 0) > 0:
            return False
        return self._drop_registration(chain_key)

    # -- chunk-granular registrations (reuse="chunk") ----------------------
    def _chunk_splice_plan(self, prefix):
        """``[(span, registration), ...]`` covering the whole prefix from
        per-chunk registrations (every span block-aligned, every
        registration stamp-matched to the entry the span was resolved from),
        or None: all or nothing. The ``chunk_splice`` fault site declines
        the plan before anything is allocated."""
        chunks = getattr(prefix, "chunks", None)
        if not chunks or not self._chunk_regs:
            return None
        bs = self.block_size
        if sum(c.length for c in chunks) != int(prefix.length):
            return None
        plan = []
        for c in chunks:
            if c.off % bs or c.length % bs or c.length == 0:
                return None
            reg = self._chunk_regs.get(c.key)
            if reg is None or reg[3] != c.stamp or reg[2] != c.length or reg[1] % bs or len(reg[0]) != c.length // bs:
                return None
            plan.append((c, reg))
        try:
            faults.maybe_fail("chunk_splice")
        except faults.InjectedFault:
            return None
        for c, _ in plan:
            self._chunk_regs.move_to_end(c.key)  # the cap evicts least recently planned
        return plan

    def _chunk_splice_into_row(self, row: int, ids_all: List[int], plan) -> None:
        """JAX ``_build_chunk_splice`` then ``_build_boundary_px_paged``:
        each span's source blocks gathered, K re-rotated by the span's
        position delta (``rope_rerotate``, or ``rope_rerotate_q8`` with the
        scales recomputed) and written into the row's destination blocks
        with V as it is; then, in ascending offset order, each shifted or
        inexact span's first ``W`` tokens re-prefilled at their offset
        straight into pool blocks (``kv_len = off + W`` hides the right)."""
        bs = self.block_size
        for c, reg in plan:
            src_ids, canon_off = reg[0], reg[1]
            nb = len(src_ids)
            delta = c.off - canon_off
            self._splice_blocks(src_ids, ids_all[c.off // bs: c.off // bs + nb], delta)
            if delta:
                flight.emit("rerotate", tokens=c.length, delta=delta)
            flight.emit("chunk_splice", tokens=c.length, delta=delta, pool=1)
        for c, reg in plan:
            delta = c.off - reg[1]
            if (c.exact and delta == 0) or not c.fixup_ids:
                continue  # canonical placement: the content is faithful
            self._boundary_prefill(row, list(c.fixup_ids), c.off)
            flight.emit("boundary_fixup", tokens=len(c.fixup_ids))

    def _splice_blocks(self, src_ids: List[int], dst_ids: List[int], delta: int) -> None:
        idx = self._h2d(np.asarray([src_ids, dst_ids], np.int64))
        a = self.arena
        ks, vs = a.k.index_select(1, idx[0]), a.v.index_select(1, idx[0])
        if a.quantized:
            rk, rks = rope_rerotate_q8(ks, a.k_scale.index_select(1, idx[0]), delta, self._inv_freqs)
            a.k_scale.index_copy_(1, idx[1], rks)
            a.v_scale.index_copy_(1, idx[1], a.v_scale.index_select(1, idx[0]))
        else:
            rk = rope_rerotate(ks, delta, self._inv_freqs)
        a.k.index_copy_(1, idx[1], rk)
        a.v.index_copy_(1, idx[1], vs)

    def _boundary_prefill(self, row: int, toks: List[int], woff: int) -> None:
        """A span's boundary window of ``W`` tokens at logical ``woff``, B =
        1, through ``paged_chunk_attention``; exactly ``W`` positions are
        written, so the re-rotated tail past the window stays."""
        W = len(toks)
        host = np.zeros((1, W + 2), np.int64)
        host[0, :W] = toks
        host[0, W:] = (woff + W, woff)
        dh = self._h2d(host)
        positions = woff + torch.arange(W, device=self.device)[None, :]
        self.model(dh[:, :W], positions, self.arena, self._zeros[:1], dh[:, W], dh[:, W + 1], chunked=True,
                   block_tables=self._device_tables()[row:row + 1], logit_index=self._zeros[:1])

    def _register_chunks_from_scatter(self, prefix, ids_all: List[int], chain_registered: bool = False) -> None:
        """After a buffer-scatter admission, each block-aligned exact span's
        blocks become the chunk's canonical pool copy (one ref each; a
        re-rotated copy never does, or drift would compound). Under a chain
        registration they carry ``counted=False``: dropping them frees no
        block while the chain lives, so they stay out of the tokens, the
        reclaimable hint and the warm ledger. At most ``chunk_pool_regs``."""
        chunks = getattr(prefix, "chunks", None)
        if not chunks:
            return
        bs = self.block_size
        pc = self.engine_config.prefix_cache
        cap = max(1, int(getattr(pc, "chunk_pool_regs", 32) or 32))
        full_tokens = (int(prefix.length) // bs) * bs
        for c in chunks:
            if not c.exact or c.length == 0 or c.off % bs or c.length % bs or c.off + c.length > full_tokens:
                continue
            old = self._chunk_regs.get(c.key)
            if old is not None and old[3] == c.stamp:
                continue  # this entry generation is registered already
            span_ids = ids_all[c.off // bs: c.off // bs + c.length // bs]
            self.kv_pool.ref(span_ids)
            if old is not None:
                self._drop_chunk_reg(c.key)
            counted = not chain_registered
            self._chunk_regs[c.key] = (list(span_ids), c.off, c.length, c.stamp, counted)
            if counted:
                self._chunk_reg_tokens += c.length
                self._reclaimable_blocks += len(span_ids)
                self.kv_pool.account_tier("warm", len(span_ids))
            while len(self._chunk_regs) > cap:
                self._drop_chunk_reg(next(iter(self._chunk_regs)))

    def _drop_chunk_reg(self, key) -> bool:
        """The one place a chunk registration dies."""
        reg = self._chunk_regs.pop(key, None)
        if reg is None:
            return False
        if reg[4]:
            n = len(reg[0])
            self._chunk_reg_tokens -= reg[2]
            self._reclaimable_blocks = max(0, self._reclaimable_blocks - n)
            self.kv_pool.account_tier("warm", -n)
        self.kv_pool.free(reg[0])
        return True

class ContinuousScheduler:
    """Thread-safe front of a :class:`ContinuousEngine`: ``submit`` blocks
    its caller while one dispatcher thread owns the engine, admitting
    queued requests between windows.

    Pool pressure keeps a request queued until decode frees blocks; a
    preempted request is resubmitted as prompt + emitted tokens. Resilience,
    as in the JAX scheduler:

    - **reset recovery**: a failed window, or a failed admission that reset
      the engine (``EngineStateLost``), resubmits every in-flight request
      after a jittered ``retry_backoff_s``, as its prompt plus the tokens it
      had emitted, at most ``retries`` times per request; a request out of
      retries (or past its deadline) gets the error;
    - **breaker feed**: every reset is recorded on ``breaker`` (set by the
      service), which turns readiness off after a storm of them;
    - **deadlines**: a request whose ``Deadline`` expires while queued fails
      with stage ``queue`` before any prefill; one that expires in flight is
      evicted within one window (stage ``decode``); a caller whose own wait
      runs out raises stage ``generate``.

    - **pool roles**: on a ``"prefill"`` engine an admitted request leaves
      as a migration packet (``info["migrate_packet"]``; a failed export
      decodes it here); ``submit_migrated`` lands a packet on a
      ``"decode"`` engine with admission's backpressure, and a failed
      import re-prefills prompt plus emitted tokens here.

    Nothing retries on another device or another kernel."""

    def __init__(self, engine: ContinuousEngine, retries: int = 1, retry_backoff_s: float = 0.05):
        self.engine = engine
        self.retries = max(0, retries)
        self.retry_backoff_s = max(0.0, retry_backoff_s)
        # set by the service: engine resets feed the readiness breaker
        self.breaker = None
        # the dispatcher's wall time inside the engine's step, admissions and
        # migrations: the goodput conservation anchor (busy_seconds)
        self._busy_s = 0.0
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._stop = threading.Event()
        # submit's stop-check + enqueue is atomic against the final drain
        self._lifecycle_lock = threading.Lock()
        self.bind_metrics(metrics.MetricsRegistry())  # its own until a service binds it
        self._worker = threading.Thread(target=self._run, daemon=True, name="continuous-scheduler")
        self._worker.start()

    def bind_metrics(self, registry) -> None:
        """Resilience accounting (JAX ``ContinuousScheduler.bind_metrics``;
        the service rebinds, like the engines)."""
        self._m_resets = registry.counter(
            "rag_engine_resets_total",
            "engine state resets (EngineStateLost / failed decode steps)",
        )
        self._m_retries = registry.labeled_counter(
            "rag_inflight_retries_total",
            "in-flight requests resubmitted after an engine reset "
            "(outcome: resubmitted | succeeded | gave_up)",
        )
        for o in ("resubmitted", "succeeded", "gave_up"):
            self._m_retries.labels(outcome=o)
        dl_fam = registry.labeled_counter(
            "rag_deadline_exceeded_total",
            "requests failed by their end-to-end deadline (stage label)",
        )
        self._m_deadline_queue = dl_fam.labels(stage="queue")
        self._m_deadline_decode = dl_fam.labels(stage="decode")
        self._m_join_timeout = registry.counter(
            "rag_scheduler_join_timeouts_total",
            "scheduler shutdowns whose worker thread outlived join(timeout)",
        )

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: Optional[int] = None,
        seed: Optional[int] = None,
        sampling: Optional[SamplingConfig] = None,
        timeout: Optional[float] = None,
        deadline: Optional[Deadline] = None,
        info: Optional[Dict] = None,
        tenant: Optional[str] = None,
        resume_emitted: Optional[Sequence[int]] = None,
    ) -> List[int]:
        """Generate for one prompt (EOS excluded); ``sampling`` overrides
        the engine's for this request only. ``info`` receives the request's
        id (the flight journal's key) and, on a prefill-role engine, the
        migration packet (``"migrate_packet"``: the return value is then the
        tokens so far, and the decode engine's ``submit_migrated`` finishes
        the stream); ``tenant`` (edge-interned) is stamped on its
        ``arrival`` and ``complete`` events. ``resume_emitted`` (a warm
        restart) are tokens a dead incarnation's WAL proved emitted: they
        fold in as a preemption resume's do, are journaled again in this
        incarnation, and lead the returned stream."""
        if self._stop.is_set():
            raise RuntimeError("scheduler is shut down")
        max_new = self.engine.sampling.max_new_tokens if max_new_tokens is None else max_new_tokens
        if max_new <= 0:
            return []
        rid = next(_REQUEST_IDS)
        item = _Pending(rid, list(prompt), max_new, seed, sampling, deadline=deadline,
                        retries_left=self.retries, tenant=tenant)
        arr = {"prompt_len": len(item.prompt), "max_new": max_new}
        if seed is not None:
            arr["seed"] = seed
        if deadline is not None:
            arr["deadline_ms"] = deadline.budget_ms
        if tenant is not None:
            arr["tenant"] = tenant
            self.engine.ledger.note_tenant(rid, tenant)
        if flight.arrival_ids():
            arr["ids"] = list(item.prompt)
        flight.emit("arrival", rid, **arr)
        if resume_emitted:
            # the arrival recorded the original prompt; the token_emit
            # journals the folded tokens into this incarnation's WAL, so a
            # second crash still rebuilds the whole stream from one epoch
            self._fold_emitted(item, list(resume_emitted))
            if item.emitted:
                item.resumed = True
                flight.emit("token_emit", rid, toks=list(item.emitted))
            flight.emit("resubmit", rid, outcome="restored", n_emitted=len(item.emitted))
        return self._enqueue_and_wait(item, timeout, deadline, info)

    def submit_migrated(
        self,
        packet: Dict,
        timeout: Optional[float] = None,
        deadline: Optional[Deadline] = None,
        info: Optional[Dict] = None,
        tenant: Optional[str] = None,
    ) -> List[int]:
        """Land a prefill-role engine's migration packet on this scheduler's
        engine and block until the stream completes (JAX
        ``submit_migrated``). The request keeps its id, so the journal shows
        one lifecycle across both engines. Returns the whole stream: the
        tokens the prefill side emitted and everything decoded here."""
        if self._stop.is_set():
            raise RuntimeError("scheduler is shut down")
        rid = packet["request_id"]
        item = _Pending(
            rid,
            # a reset here re-prefills prompt + emitted from these
            list(packet.get("prompt", ())),
            int(packet["remaining"]) + len(packet["tokens"]),
            packet["seed"], packet["sampling"], deadline=deadline, retries_left=self.retries,
            tenant=tenant if tenant is not None else packet.get("tenant"), migrate=packet,
        )
        item.emitted = list(packet.get("emitted", ()))
        if item.tenant is not None:
            self.engine.ledger.note_tenant(rid, item.tenant)
        return self._enqueue_and_wait(item, timeout, deadline, info)

    def _enqueue_and_wait(self, item: "_Pending", timeout: Optional[float], deadline: Optional[Deadline],
                          info: Optional[Dict]) -> List[int]:
        if info is not None:
            info["request_id"] = item.request_id
        with self._lifecycle_lock:
            if self._stop.is_set():
                raise RuntimeError("scheduler is shut down")
            self._queue.put(item)
        wait_t = timeout
        if wait_t is None and deadline is not None:
            # a small grace past the deadline: the worker evicts the row and
            # delivers the stage-precise error within one window
            wait_t = deadline.wait_timeout() + 0.25
        if not item.done.wait(wait_t):
            if deadline is not None and deadline.expired():
                # the worker's sweep evicts the row; this expiry is counted
                # once, at the caller's stage "generate", not again there
                item.abandoned = True
                raise DeadlineExceeded("generate", deadline.budget_ms)
            raise TimeoutError("generation timed out")
        if item.error is not None:
            raise item.error
        if info is not None and item.blocks_allocated is not None:
            # paged: the row's block footprint, in the timings
            info["kv_blocks_allocated"] = item.blocks_allocated
        if info is not None and item.goodput is not None:
            # the ledger's attribution (chip_ms, goodput_frac, cost_usd,
            # speculation stats): the service folds it into the timings
            info["goodput"] = item.goodput
        # verify windows judged drafts for this request: read from the
        # engine's state (pop_spec_seen), not the goodput ledger, so turning
        # the ledger off cannot erase the fingerprint
        stamp_spec(info, item.spec_seen)
        if info is not None and item.migrate is not None:
            info["migrate_packet"] = item.migrate
        return item.result

    def busy_seconds(self) -> float:
        """The dispatcher's wall time inside the engine's step, admissions,
        exports and imports: the independent measurement the ledger's
        per-request chip time sums to (gauge-grade across threads)."""
        return self._busy_s

    def run_on_engine(self, fn) -> bool:
        """Queue a host-side engine task, ``fn(engine)``, for the dispatcher
        thread to run between admissions and windows (JAX
        ``run_on_engine``): the engine is single-owner, so this is how
        another thread (the prefix cache's retier mirror) touches it. Fire
        and forget; a failure is contained like a failed window
        (``_run_engine_task``). Returns False once the scheduler is
        stopping."""
        if not callable(fn):
            raise TypeError("run_on_engine expects a callable(engine)")
        with self._lifecycle_lock:
            if self._stop.is_set():
                return False
            self._queue.put(fn)
        return True

    def shutdown(self, timeout: float = 30.0) -> None:
        self._stop.set()
        with self._lifecycle_lock:
            self._queue.put(None)
        _join_worker(self._worker, self._m_join_timeout, "continuous-scheduler", timeout)

    # ------------------------------------------------------------------
    def _run(self) -> None:
        waiting: Dict[int, _Pending] = {}
        held: List[_Pending] = []
        try:
            self._run_loop(waiting, held)
        finally:
            # whatever stopped the loop, no caller may block forever
            self._stop.set()
            leftovers = list(waiting.values()) + held
            with self._lifecycle_lock:
                while True:
                    try:
                        it = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if it is not None and not callable(it):  # a queued engine task is dropped
                        leftovers.append(it)
            for it in leftovers:
                if not it.done.is_set():
                    self.engine.discard_spec_seen(it.request_id)
                    self.engine.discard_request_goodput(it.request_id)
                    it.error = RuntimeError("scheduler is shut down")
                    it.done.set()

    def _next_nowait(self) -> Optional["_Pending"]:
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            return None

    def _run_loop(self, waiting: Dict[int, "_Pending"], held: List["_Pending"]) -> None:
        eng = self.engine
        while not self._stop.is_set():
            # an expired in-flight request frees its row within one window
            self._evict_expired(waiting)
            item = self._next_nowait() if eng.has_active() else self._queue.get()
            while item is not None and not self._stop.is_set():
                if callable(item):
                    # an engine task runs in arrival order between admissions
                    self._run_engine_task(item, waiting)
                    item = self._next_nowait()
                    continue
                held[:] = [item]
                if self._expire_queued(item):
                    # dead work never reaches the device
                    item = self._next_nowait()
                    continue
                if item.migrate is not None:
                    # a prefill-role peer's packet lands through its own
                    # import path (no prefill, no bucketing)
                    self._admit_migrated(item, waiting)
                    if self._stop.is_set():
                        return  # an item still waiting to land stays in held
                    held.clear()
                    item = self._next_nowait()
                    continue
                state = eng.admission_state(len(item.prompt))
                if state == "never":
                    item.error = PoolExhausted(eng.blocks_needed(len(item.prompt)),
                                               eng.kv_pool.usable_blocks())
                    item.done.set()
                    item = self._next_nowait()
                    continue
                free = eng.free_slots()
                if state == "wait" or not free:
                    self._safe_step(waiting)  # decode frees rows and blocks
                    self._evict_expired(waiting)
                    continue
                # group admission: whatever else is queued, up to the free rows
                batch = [item]
                while len(batch) < len(free):
                    nxt = self._next_nowait()
                    if nxt is None:
                        break
                    if callable(nxt):
                        self._run_engine_task(nxt, waiting)
                        continue
                    if self._expire_queued(nxt):
                        continue
                    if nxt.migrate is not None:
                        # packets never batch with prefills: back in the
                        # queue, and the draining stops here
                        self._queue.put(nxt)
                        break
                    batch.append(nxt)
                held[:] = batch
                try:
                    t_busy = time.perf_counter()
                    try:
                        admitted = eng.admit_many(
                            [(b.request_id, b.prompt, b.max_new, b.seed, b.sampling) for b in batch]
                        )
                    finally:
                        self._busy_s += time.perf_counter() - t_busy
                except EngineStateLost as e:
                    # the reset wiped every row: this batch and every
                    # in-flight request restart from their prompts
                    logger.warning("admission reset the engine; recovering %d request(s)",
                                   len(waiting) + len(batch))
                    self._handle_reset(e, waiting, extra=batch, emitted={})
                    admitted = []
                except Exception as e:  # noqa: BLE001 — the callers get the error
                    admitted = [e] * len(batch)
                requeued = False
                for b, res in zip(batch, admitted):
                    if isinstance(res, PoolExhausted):
                        # the group outgrew the pool: backpressure, not failure
                        self._queue.put(b)
                        requeued = True
                        continue
                    if isinstance(res, BaseException):
                        b.error = res
                        b.done.set()
                        continue
                    # the first token exists once a phase-separated admission
                    # returns; an interleaved one samples it in a later
                    # window, which observes TTFT from this submit time. A
                    # resubmission or a resume observed its TTFT already
                    first = not b.retried and not b.resumed
                    chunk_rec = eng._chunk_admissions.get(b.request_id)
                    if chunk_rec is not None:
                        chunk_rec["t_submit"] = b.t_submit if first else None
                    elif first:
                        eng._m_ttft.observe(time.monotonic() - b.t_submit)
                    if res[1] is not None:
                        self._deliver(b, res[1])
                    elif eng.pool_role == "prefill":
                        # the hand-off: the request leaves as a packet, or
                        # decodes here when the export fails
                        self._export_or_keep(b, waiting)
                    else:
                        waiting[b.request_id] = b
                held.clear()
                # after backpressure a window runs before the retry: retrying
                # at once would spin on the same verdict while nothing frees
                item = None if requeued else self._next_nowait()
            if item is not None and not callable(item):  # stopping with an item in hand
                held[:] = [item]
                return
            if eng.has_active():
                self._safe_step(waiting)

    def _evict_expired(self, waiting: Dict[int, "_Pending"]) -> None:
        """Evict in-flight requests whose deadline has passed: their rows
        and blocks free now, and they get the stage-precise error."""
        expired = [rid for rid, it in waiting.items() if it.deadline is not None and it.deadline.expired()]
        if not expired:
            return
        self.engine.evict_requests(expired)
        for rid in expired:
            self.engine.discard_spec_seen(rid)
            self.engine.discard_request_goodput(rid)  # never delivered
            it = waiting.pop(rid)
            if not it.abandoned:  # the caller counted its own expiry
                self._m_deadline_decode.inc()
            it.error = DeadlineExceeded("decode", it.deadline.budget_ms)
            it.done.set()

    def _expire_queued(self, item: "_Pending") -> bool:
        """Fail an item that expired while queued (stage ``queue``); True
        when it had."""
        if item.deadline is None or not item.deadline.expired():
            return False
        if not item.abandoned:
            self._m_deadline_queue.inc()
        item.error = DeadlineExceeded("queue", item.deadline.budget_ms)
        item.done.set()
        return True

    def _deliver(self, item: "_Pending", tokens: List[int]) -> None:
        """Complete one request: tokens emitted before a reset or a
        preemption come first, so the client sees one stream."""
        if item.retried:
            self._m_retries.labels(outcome="succeeded").inc()
        # the verify-window fingerprint the shadow auditor reads; popping
        # keeps the engine's set bounded
        item.spec_seen = self.engine.pop_spec_seen(item.request_id)
        item.result = item.emitted + tokens
        item.blocks_allocated = self.engine.pop_blocks_allocated(item.request_id)
        item.goodput = self.engine.pop_request_goodput(item.request_id, tokens=len(item.result))
        # the attribution rides the complete event, so a journal prices each
        # request (and, with the tenant stamp, each tenant) on its own
        extra = {}
        if item.goodput is not None:
            extra["chip_ms"] = item.goodput["chip_ms"]
            if "cost_usd" in item.goodput:
                extra["cost_usd"] = round(item.goodput["cost_usd"], 8)
        if item.tenant is not None:
            extra["tenant"] = item.tenant
        flight.emit("complete", item.request_id, n_tokens=len(item.result),
                    stream_fnv=flight.stream_hash(item.result), **extra)
        item.done.set()

    def _export_or_keep(self, item: "_Pending", waiting: Dict[int, "_Pending"]) -> None:
        """Prefill-role hand-off (JAX ``_export_or_keep``): take the
        admitted request off the engine as a packet and hand it to the
        submitter (the router forwards it to a decode-role engine). Any
        failure keeps it decoding here. No ``complete`` fires here: the
        engine that imports the packet finishes the stream."""
        packet = None
        t_busy = time.perf_counter()
        try:
            packet = self.engine.export_request(item.request_id)
        except Exception:  # noqa: BLE001 — nothing was released: the engine is intact
            logger.exception("migration export failed; serving request %d locally", item.request_id)
        finally:
            self._busy_s += time.perf_counter() - t_busy
        if packet is None:
            waiting[item.request_id] = item
            return
        # what only the scheduler knows: the prompt a decode-side reset
        # re-prefills from, and tokens emitted before a reset or a preemption
        # here (the decode side delivers them first)
        packet["prompt"] = list(item.prompt)
        packet["emitted"] = list(item.emitted)
        packet["tenant"] = item.tenant
        self.engine.discard_spec_seen(item.request_id)
        item.blocks_allocated = self.engine.pop_blocks_allocated(item.request_id)
        item.goodput = self.engine.pop_request_goodput(item.request_id, tokens=len(packet["tokens"]))
        item.migrate = packet
        item.result = item.emitted + list(packet["tokens"])
        item.done.set()

    def _admit_migrated(self, item: "_Pending", waiting: Dict[int, "_Pending"]) -> None:
        """Land a packet with admission's backpressure (JAX
        ``_admit_migrated``): while the engine has no free row or the pool
        cannot take the packet's blocks, windows run (they retire rows and
        free blocks) and the import retries. Only a packet the whole pool
        could never hold fails. A failed import reset the engine: the
        request re-prefills here as prompt plus the tokens the packet
        carries, like every request the reset interrupted."""
        eng = self.engine
        pkt = item.migrate
        need = int(pkt["n_blocks"])
        while not self._stop.is_set():
            usable = eng.kv_pool.usable_blocks() if eng.paged else 0
            if need > usable:
                item.error = PoolExhausted(need, usable)
                item.done.set()
                return
            if self._expire_queued(item):
                return
            if (not eng.free_slots() or not eng.kv_pool.can_alloc(need)) and eng.has_active():
                self._safe_step(waiting)
                self._evict_expired(waiting)
                continue
            t_busy = time.perf_counter()
            try:
                eng.import_request(pkt)
            except PoolExhausted as e:
                self._busy_s += time.perf_counter() - t_busy
                if eng.has_active():
                    self._safe_step(waiting)  # blocks free as rows retire
                    self._evict_expired(waiting)
                    continue
                item.error = e
                item.done.set()
                return
            except EngineStateLost as e:
                self._busy_s += time.perf_counter() - t_busy
                item.migrate = None
                self._handle_reset(e, waiting, extra=[item], emitted={item.request_id: list(pkt["tokens"])})
                return
            except Exception as e:  # noqa: BLE001 — the caller gets the error
                self._busy_s += time.perf_counter() - t_busy
                item.error = e
                item.done.set()
                return
            self._busy_s += time.perf_counter() - t_busy
            item.migrate = None  # landed: a later reset resubmits it by its prompt
            waiting[item.request_id] = item
            return

    def _safe_step(self, waiting: Dict[int, "_Pending"]) -> None:
        """One window that cannot kill the dispatcher: a failure resets the
        engine and resubmits the in-flight requests (``_handle_reset``)."""
        try:
            t_busy = time.perf_counter()
            try:
                done = self.engine.step()
            finally:
                self._busy_s += time.perf_counter() - t_busy
            for rid, tokens in done:
                item = waiting.pop(rid, None)
                if item is not None:
                    self._deliver(item, tokens)
            self._resume_preempted(waiting)
        except Exception as e:  # noqa: BLE001 — the dispatcher must outlive a failed window
            logger.exception("continuous window failed; recovering %d in-flight request(s)", len(waiting))
            # what each row had emitted, read before reset() wipes the slots
            emitted = {s.request_id: list(s.tokens) for s in self.engine.slots if s.active}
            try:
                self.engine.reset()
            except Exception:  # noqa: BLE001 — a failed reset must not kill the loop
                logger.exception("engine reset failed after a window failure")
            self._handle_reset(e, waiting, extra=[], emitted=emitted)

    def _fold_emitted(self, it: "_Pending", toks: List[int]) -> None:
        """Fold already-emitted tokens into a request about to resubmit,
        when prompt + emitted still fits the largest bucket (past it the
        admission would left-truncate the context; restarting is exact).
        Shared by reset recovery and preemption resume."""
        if policy.resume_fits(len(it.prompt), len(toks), max(self.engine.buckets)):
            it.emitted.extend(toks)
            it.prompt = it.prompt + toks
            it.max_new = max(1, it.max_new - len(toks))

    def _resume_preempted(self, waiting: Dict[int, "_Pending"]) -> None:
        """Requeue preempted requests as prompt + emitted tokens. Preemption
        is backpressure, not a fault: it burns no retry."""
        for rid, toks in self.engine.drain_preempted():
            it = waiting.pop(rid, None)
            if it is None:
                continue
            self._fold_emitted(it, toks)
            it.resumed = True
            # its next admission re-feeds prompt + emitted, computed once
            # already: that admission's lanes are preempt_rework
            self.engine.mark_rework(rid)
            flight.emit("resubmit", rid, outcome="preempt_resume", n_emitted=len(toks))
            self._queue.put(it)

    def _run_engine_task(self, task, waiting: Dict[int, "_Pending"]) -> None:
        """Run one queued engine task (JAX ``_run_engine_task``): an
        ``EngineStateLost`` (the engine reset itself) recovers like a failed
        window, resubmitting the requests in flight from their prompts; any
        other failure is logged and the loop goes on."""
        try:
            task(self.engine)
        except EngineStateLost as e:
            logger.exception("engine task reset the engine; recovering %d in-flight request(s)", len(waiting))
            self._handle_reset(e, waiting, extra=[], emitted={})
        except Exception:  # noqa: BLE001 — a task must never kill the loop
            logger.exception("engine task failed (engine state intact)")

    def _handle_reset(self, cause: BaseException, waiting: Dict[int, "_Pending"],
                      extra: List["_Pending"], emitted: Dict[int, List[int]]) -> None:
        """After an engine reset: resubmit what can still be served, as its
        prompt plus the tokens in ``emitted`` (request id -> tokens produced
        before the reset), and fail the rest with ``cause``."""
        self._m_resets.inc()
        if self.breaker is not None:
            self.breaker.record_reset()
        items = list(waiting.values()) + list(extra)
        waiting.clear()
        retry = []
        for it in items:
            expired = it.deadline is not None and it.deadline.expired()
            if it.retries_left > 0 and not expired and not self._stop.is_set():
                retry.append(it)
            else:
                self._m_retries.labels(outcome="gave_up").inc()
                self.engine.discard_spec_seen(it.request_id)
                self.engine.discard_request_goodput(it.request_id)
                flight.emit("resubmit", it.request_id, outcome="gave_up")
                it.error = cause
                it.done.set()
        if not retry:
            return
        logger.warning("engine reset (%s); resubmitting %d in-flight request(s)", cause, len(retry))
        if self.retry_backoff_s > 0:
            # jittered: a device that just faulted gets a beat before the
            # resubmitted prefills land on it again
            time.sleep(random.uniform(0.5, 1.0) * self.retry_backoff_s)
        for it in retry:
            toks = emitted.get(it.request_id, [])
            self._fold_emitted(it, toks)
            it.retries_left -= 1
            it.retried = True
            # the resubmission re-prefills the whole prompt (+ emitted):
            # rework lanes in the ledger, not fresh prefill
            self.engine.mark_rework(it.request_id)
            self._m_retries.labels(outcome="resubmitted").inc()
            flight.emit("resubmit", it.request_id, outcome="resubmitted", n_emitted=len(toks))
            self._queue.put(it)


@dataclass
class _Pending:
    request_id: int
    prompt: List[int]
    max_new: int
    seed: Optional[int] = None
    sampling: Optional[SamplingConfig] = None
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[List[int]] = None
    error: Optional[BaseException] = None
    # tokens emitted before a reset or a preemption
    emitted: List[int] = field(default_factory=list)
    deadline: Optional[Deadline] = None
    retries_left: int = 0  # reset-recovery resubmissions remaining
    tenant: Optional[str] = None  # edge-interned (complete stamp)
    t_submit: float = field(default_factory=time.monotonic)  # the TTFT anchor
    retried: bool = False  # resubmitted after a reset
    resumed: bool = False  # requeued after a preemption
    abandoned: bool = False  # the caller gave up (it counted the expiry)
    migrate: Optional[Dict] = None  # pool roles: the packet going out or coming in
    goodput: Optional[Dict] = None  # the ledger's attribution (chip_ms, cost, spec stats)
    blocks_allocated: Optional[int] = None  # paged: the row's block footprint
    spec_seen: bool = False  # verify windows judged drafts for this request
