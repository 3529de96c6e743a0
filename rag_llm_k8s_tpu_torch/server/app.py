"""HTTP serving app: a lean counterpart of ``rag_llm_k8s_tpu/server/app.py``.

Routes (same JSON as the JAX service): ``POST /upload_pdf``, ``POST
/generate`` (alias ``POST /query``), ``GET /index_info``, ``GET /healthz``
(``?live=1``: the liveness form), ``POST /drain``, ``GET /metrics``, ``GET
/slo`` (``?force=1``), ``POST /profile``, ``GET /debug/traces``, ``GET
/debug/timeline/<rid>``, ``GET /debug/incidents`` (``?id=``), ``GET
/debug/goodput``, ``GET /debug/quality``, ``GET /debug/tenants`` and ``GET|POST
/debug/faults``.
The WSGI plumbing is the standard library's, so the port needs no web
framework: ``WsgiApp.test_client()`` drives it in-process, and
``make_server`` serves it over HTTP on a threading ``wsgiref`` server (one
thread per request, so concurrent requests can coalesce).

Over a mesh engine (``InferenceEngine(mesh=...)``) the service runs on rank
0 alone: every engine call that reaches a collective or changes what the
ranks hold (a generate, a fused generate, the shadow auditor's
``score_exact``, each continuous-engine call of the scheduler, the
lookahead's prestage and each prefix-cache resolve) goes through the mesh's
one command stream under one lock (``parallel/commands.py``), and
``/healthz`` is not ready while a follower is missing (``peers_ready``).

Retrieval (query embedding + kNN) goes through a ``Coalescer``, as in the
JAX service (which has one whenever it has an encoder): concurrent queries
form one batch of up to 8, padded to 8 rows, run as one encoder forward and
one ``knn_topk`` call with 8 queries (``_retrieve_many``). The service counts
the requests in flight toward retrieval and toward generation and hands the
counts to the coalescer and the scheduler as ``pending_hint``, so a solo
query does not wait out their windows.

Under a ``BatchScheduler`` (``batching="coalesce"``, the default; built by
``server/main.py``) a solo query takes the single-fetch path (``_fused_ok``,
exactly the JAX rule): the retrieve coalescer returns a singleton batch's
packed ``[1, 2k]`` top-k unfetched, and the prompt is assembled on the
device from it and the store's chunk-token sidecar
(``InferenceEngine.generate_rag``). A burst, a long question whose tail
overflows the fused tail bucket, or a store past ``rag_fused_max_vectors``
takes the host path: the hits are fetched, the prompt is assembled on the
host (piecewise, or budgeted) and submitted to the scheduler, which batches
concurrent prompts into one ``engine.generate``.

With the KV prefix cache on (``EngineConfig.prefix_cache``,
``TPU_RAG_PREFIX_CACHE=1``) a solo query leaves the single-fetch path, as
in the JAX service: its prompt is cut into the head and the kept chunk
segments (``_prompt_segments``, keyed by the store's content hash), whose KV
the engine's ``PrefixCache`` resolves (building and caching what it
misses), and only the per-query tail prefills
(``InferenceEngine.generate_prefixed``); a burst, or a prompt the prefixed
path cannot take, goes on to the host path.

With a ``ContinuousScheduler`` (``batching="continuous"``, built by
``build_scheduler`` over the one-shot engine's model, one copy of the
weights) every query takes the host path and its prompt joins the running
batch; a prompt longer than the scheduler's largest bucket goes to the
one-shot engine's chunked prefill. Without a scheduler every query takes
the host path through the one-shot engine.

The resilience layer fronts every ``/generate`` as in the JAX service
(``resilience/``, ``ResilienceConfig``): the request's deadline comes from
the body's ``deadline_ms``, the ``x-request-deadline-ms`` header or the
default (a malformed value is a 400); its tenant from ``tenant_id``,
``x-tenant-id`` or ``"anon"``, interned through a ``TenantTracker``; then
the admission gate (429 ``queue_full`` / ``fair_share`` / ``pool_exhausted``
or 503 ``breaker_open`` / ``draining``, each with ``Retry-After``), and
deadline checks after retrieval and assembly (504 with the stage). The
circuit breaker over the continuous engine's resets turns readiness off;
``POST /drain`` (and SIGTERM, ``server/main.py``) starts the lifecycle's
drain. ``/debug/faults`` arms fault sites only when ``TPU_RAG_FAULTS`` is
set.

Retrieval lookahead, as in the JAX service (``TPU_RAG_LOOKAHEAD=1``,
``rag/lookahead.py``): ``/generate`` launches a request's retrieval into a
bounded executor before the admission gate can queue it, and ``answer``
joins the future (``timings["lookahead_hit"]``); a request with a
``session_id`` speculates its session's next turn before generating. With
the prefix cache on, a resolved retrieval pre-stages its chunk KV into the
cache and, on a paged continuous engine, registers the chain's pool blocks
(``ContinuousEngine.prestage_prefix``, an engine task); a speculation that
dies unconsumed releases both. Greedy streams are the same with it on or
off.

The durable lifecycle, as in the JAX service: with ``TPU_RAG_FLIGHT_WAL=1``
the service opens a ``FlightWAL`` in ``TPU_RAG_FLIGHT_WAL_DIR`` (ring only
when the directory cannot be opened) and tees the flight journal into it;
the drain's persist step (``_persist_for_restart``) fsyncs it and writes
the prefix cache's warmth manifest beside it; on the next boot
``restore_from_wal`` re-stages the manifest's chunks and resubmits every
request the previous incarnation's epoch left in flight, with its
WAL-proven tokens folded in. Under ``TPU_RAG_POOL_ROLE=prefill`` or
``decode`` the continuous engine takes that role; the service answers
``/generate`` as the JAX one does with the same setting (a prefill-role
engine hands each admitted request off as a packet nobody lands here, so
the answer is its first token: ``server/router.py`` pairs the roles).

Observability, as in the JAX service (``obs/``): each service owns a
``MetricsRegistry`` (``GET /metrics``: Prometheus text 0.0.4, or the JSON
snapshot under ``Accept: application/json``) that its engines, scheduler,
coalescers and admission gate report into; every ``/generate`` is a span
tree (``retrieve`` with its ``tokenize`` and ``embed_knn`` share,
``assemble`` on the host path, ``generate``, ``detokenize``) kept in a ring of 128
(``/debug/traces``, 403 unless ``TPU_RAG_FAULTS`` or ``TPU_RAG_DEBUG`` is
set, as ``/debug/timeline``), adopting a valid W3C ``traceparent`` and
answering ``x-trace-id`` and ``traceparent`` on every response; one access
log line per request is written while its trace is current, so the JSON log
formatter stamps its ids. ``POST /profile`` captures a ``torch.profiler``
trace of one request, or of a window over live traffic, as a Chrome-trace
file.

Goodput, SLOs, tenants and incidents, as in the JAX service: both engines
keep a goodput ledger (``obs/goodput.py``), merged for ``/debug/goodput``
and the ``rag_goodput_*`` / ``rag_cost_*`` families, and a request's share
lands in its timings (``chip_ms``, ``goodput_frac``, ``cost_usd`` when
``TPU_RAG_CHIP_HOUR_USD`` is set). ``obs/slo.py`` windows the registry's
families into burn rates (``/slo``, ``rag_slo_*``). The tenant families
(``rag_tenant_*``) are bound to the tracker; ``/debug/tenants`` folds the
journal through ``obs/tenants.py``. ``rag_device_*`` reads the allocator
(``obs/devices.py``). The breaker's flip, a reset storm, a pool-exhaustion
shed, a 504 and a drain timeout each spool an incident bundle
(``record_incident``; ``/debug/incidents``). The ``/debug`` routes answer
403 unless ``TPU_RAG_FAULTS`` or ``TPU_RAG_DEBUG=1`` is set.

The shadow quality auditor, as in the JAX service (``obs/shadow.py``, on by
default at a 5 % sample, ``TPU_RAG_SHADOW*``): each delivered response is
offered to a ``ShadowAuditor`` whose worker re-runs a sampled share on the
exact path (``InferenceEngine.score_exact``) behind lookahead's headroom
gate, judges the greedy stream against the exact argmax chain, journals a
``shadow_audit`` event, feeds ``rag_quality_*`` (the quality SLO's source),
and spools a ``quality_divergence`` bundle on the second divergence inside
its burst window; ``GET /debug/quality`` serves the report.
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging
import math
import os
import socketserver
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server as _wsgiref_make_server

import numpy as np
import torch
from torch.profiler import ProfilerActivity

from rag_llm_k8s_tpu_torch import __version__
from rag_llm_k8s_tpu_torch.core.config import AppConfig, EngineConfig, ResilienceConfig, SamplingConfig
from rag_llm_k8s_tpu_torch.engine.batching import BatchScheduler, Coalescer
from rag_llm_k8s_tpu_torch.engine.continuous import ContinuousEngine, ContinuousScheduler
from rag_llm_k8s_tpu_torch.engine.encoder import EncoderRunner
from rag_llm_k8s_tpu_torch.engine.engine import InferenceEngine
from rag_llm_k8s_tpu_torch.index.store import SearchResult, VectorStore
from rag_llm_k8s_tpu_torch.obs import devices as obs_devices
from rag_llm_k8s_tpu_torch.obs import flight, tracing
from rag_llm_k8s_tpu_torch.obs import goodput as obs_goodput
from rag_llm_k8s_tpu_torch.obs import logging as obs_logging
from rag_llm_k8s_tpu_torch.obs import metrics as obs_metrics
from rag_llm_k8s_tpu_torch.obs import shadow as obs_shadow
from rag_llm_k8s_tpu_torch.obs import slo as obs_slo
from rag_llm_k8s_tpu_torch.obs import tenants as obs_tenants
from rag_llm_k8s_tpu_torch.ops.knn import knn_topk
from rag_llm_k8s_tpu_torch.rag import lookahead as lookahead_mod
from rag_llm_k8s_tpu_torch.rag.chunking import split_text
from rag_llm_k8s_tpu_torch.rag.pdf import extract_text
from rag_llm_k8s_tpu_torch.rag.prompt import assemble_context, assemble_prompt, extract_answer
from rag_llm_k8s_tpu_torch.resilience import faults
from rag_llm_k8s_tpu_torch.resilience.admission import AdmissionController, AdmissionRejected
from rag_llm_k8s_tpu_torch.resilience.breaker import CircuitBreaker
from rag_llm_k8s_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded
from rag_llm_k8s_tpu_torch.resilience.lifecycle import LifecycleCoordinator
from rag_llm_k8s_tpu_torch.utils.buckets import next_pow2
from rag_llm_k8s_tpu_torch.utils.tokens import truncate_keep_eos

logger = logging.getLogger(__name__)
# one line per answered or failed request, written inside the traced region,
# so the JSON formatter (obs/logging.py) stamps it with the request's ids
access_logger = logging.getLogger("rag_llm_k8s_tpu_torch.access")

NO_RESULTS = "No relevant information found in the index."
# the tenant of a request that names none
DEFAULT_TENANT = obs_tenants.DEFAULT_TENANT


def make_segment_source(llm_tokenizer, max_bucket: int):
    """The chunk → prompt-segment token source handed to the store's
    sidecar: a closure over the tokenizer only (never a bound method, so the
    store does not keep a service alive). ``cache_key`` lets the store keep
    its rows across re-attaches with the same tokenizer."""

    def segment_ids(metadata: Dict) -> List[int]:
        seg = (
            f"Document '{metadata.get('filename')}' "
            f"(chunk {metadata.get('chunk_id')}): {metadata.get('text')}\n\n"
        )
        return llm_tokenizer.encode(seg)[:max_bucket]

    segment_ids.cache_key = ("segment_ids_v1", id(llm_tokenizer), max_bucket)
    return segment_ids


def build_scheduler(
    engine: InferenceEngine, engine_config: Optional[EngineConfig] = None,
    resilience: Optional[ResilienceConfig] = None,
) -> Optional[ContinuousScheduler]:
    """The continuous scheduler ``engine_config`` (default: the engine's own)
    asks for: a ``ContinuousScheduler`` over a ``ContinuousEngine`` that
    SHARES the one-shot engine's model (one copy of the weights) when
    ``batching == "continuous"``, else None (``server/main.py`` builds the
    ``BatchScheduler`` of ``batching="coalesce"``). ``resilience`` (default
    ``ResilienceConfig()``) sets its reset-recovery retries and backoff. On
    a mesh the continuous engine takes the one-shot engine's mesh and
    stream; the followers build the same engine (``server.main``)."""
    ec = engine_config or engine.engine_config
    if ec.batching != "continuous":
        return None
    res = resilience or ResilienceConfig()
    cont = ContinuousEngine(
        engine.config, engine.model, engine.sampling, ec, engine.dtypes, engine.device, engine.pad_id,
        mesh=engine.mesh,
    )
    return ContinuousScheduler(cont, retries=res.inflight_retries, retry_backoff_s=res.retry_backoff_ms / 1e3)


def engine_mode(scheduler) -> str:
    """The serving mode ``/healthz`` reports (the JAX service's names)."""
    if scheduler is None:
        return "one-shot"
    if isinstance(scheduler, ContinuousScheduler):
        return "continuous-interleaved" if scheduler.engine.interleave_on else "continuous"
    if isinstance(scheduler, BatchScheduler):
        return "coalesce"
    return type(scheduler).__name__


class _FanoutHistogram:
    """One observation into several histogram children (the retrieve
    coalescer's dispatch is the embed dispatch too)."""

    def __init__(self, *hists):
        self._hists = hists

    def observe(self, value: float) -> None:
        for h in self._hists:
            h.observe(value)


class RagService:
    """The retrieve-then-generate pipeline behind the routes. ``scheduler``
    is a ``BatchScheduler``, a ``ContinuousScheduler`` or None."""

    def __init__(
        self,
        config: AppConfig,
        engine: InferenceEngine,
        llm_tokenizer,
        encoder: EncoderRunner,
        encoder_tokenizer,
        store: VectorStore,
        scheduler=None,
    ):
        self.config = config
        self.engine = engine
        self.scheduler = scheduler
        self.llm_tokenizer = llm_tokenizer
        self.encoder = encoder
        self.encoder_tokenizer = encoder_tokenizer
        self.store = store
        self.ready = False
        # the boot's warm set and its seconds (warmup)
        self.warm_report: Optional[Dict] = None
        # a mesh's followers: not ready while one is missing (server/main.py
        # adds the processes' liveness)
        self.peers_ready: Optional[Callable[[], bool]] = (
            engine.commands.ready if getattr(engine, "commands", None) is not None else None
        )
        # one registry per service: everything it and its engines report
        # lands in one scrape, never the process default
        self.metrics = obs_metrics.MetricsRegistry()
        self.traces = tracing.TraceBuffer(128)
        self.started_at = time.monotonic()
        # the flight journal is process-wide: the service applies its config
        # and owns the durable WAL (ring only when its directory cannot be
        # opened)
        fl = config.flight
        self.flight_wal: Optional[flight.FlightWAL] = None
        if fl.wal:
            try:
                self.flight_wal = flight.FlightWAL(fl.wal_dir, segment_events=fl.wal_segment_events,
                                                   max_segments=fl.wal_segments)
            except OSError:
                logger.exception("flight WAL unavailable at %s; running ring-only", fl.wal_dir)
        flight.configure(enabled=fl.enabled, capacity=fl.capacity, arrival_ids=fl.arrival_ids, wal=self.flight_wal)
        # the incident spool: a bundle per trigger (breaker flip, reset
        # storm, pool-exhaustion shed, deadline expiry, drain timeout),
        # cooldown-bounded (record_incident)
        self.incidents = flight.IncidentSpooler(fl.spool_dir, fl.spool_max, fl.cooldown_s)
        # the resilience layer: the readiness breaker over engine resets,
        # the admission gate in front of both engine modes, the drain
        # coordinator (server/main.py gives it an exit_fn), the tenant interner
        res = config.resilience
        self.breaker = CircuitBreaker(threshold=res.breaker_reset_threshold, window_s=res.breaker_window_s)
        self.admission = AdmissionController(
            max_concurrency=res.admission_max_concurrency, max_queue=res.admission_max_queue,
            retry_after_s=res.admission_retry_after_s, breaker=self.breaker,
        )
        if isinstance(scheduler, ContinuousScheduler):
            scheduler.breaker = self.breaker  # resets feed readiness
            # a dry pool sheds would-be-queued requests with 429 pool_exhausted
            # (the dense cache has no pool)
            pool = scheduler.engine.kv_pool
            if pool is not None:
                self.admission.saturation_hint = lambda: pool.available() == 0
                # non-hot registered blocks are reclaimable warmth: while
                # there are any, a dry pool queues the request, not a 429
                sched_eng = scheduler.engine
                self.admission.reclaimable_hint = lambda: sched_eng.reclaimable_blocks() > 0
        self.lifecycle = LifecycleCoordinator(
            admission=self.admission, deadline_s=res.drain_deadline_s, retry_after_s=res.drain_retry_after_s,
            persist_fn=self._persist_for_restart, incident_hook=self.record_incident,
        )
        # tenant attribution: every request's tenant interns through this
        # top-K tracker at the HTTP edge; the rag_tenant_* families bind to
        # it, so each holds at most top_k + 1 tenant children
        self.tenants_enabled = bool(config.tenants.enabled)
        self.tenant_tracker = obs_metrics.TenantTracker(top_k=int(config.tenants.top_k))
        # tier moves flow cache -> pool registrations after a retier sweep
        pcache = engine.prefix_cache
        if pcache is not None and pcache.tiering is not None:
            pcache.on_retier = self._pool_retier
        if encoder.eos_id is None:
            encoder.eos_id = getattr(encoder_tokenizer, "eos_id", None)
        self._a_ids_cache: Optional[List[int]] = None
        self._segment_source = make_segment_source(
            llm_tokenizer, max(engine.engine_config.prompt_buckets)
        )
        if engine.engine_config.rag_fused:
            store.attach_token_source(self._segment_source)
        # requests in flight toward each batching stage, fed to the
        # coalescer and the scheduler as pending_hint: a stage stops waiting
        # out its window once every request in flight toward it has joined
        self._inflight_lock = threading.Lock()
        self._inflight_retrieve = 0
        self._inflight_generate = 0
        # query batches > 1 pad to this many rows: one more shape, not a ladder
        self._retrieve_cap = 8
        # 25 ms: a cold burst's requests arrive within ms of each other; a
        # solo query leaves after the hint's grace, not the window
        self.retrieve_coalescer = Coalescer(
            lambda items: self._retrieve_many(items, allow_device=True),
            max_batch=self._retrieve_cap, max_wait_ms=25.0,
            pending_hint=lambda: self._inflight_retrieve,
        )
        if scheduler is not None and getattr(scheduler, "pending_hint", False) is None:
            scheduler.pending_hint = lambda: self._inflight_generate
        self._prefix_memo: Dict[str, tuple] = {}
        # one merged ledger snapshot serves a scrape's ~20 goodput callbacks
        self._goodput_memo: Optional[tuple] = None
        # the shadow quality auditor (obs/shadow.py, on by default): a
        # sampled share of completed requests re-runs on the exact path (the
        # one-shot engine's teacher-forced scorer: no reuse, no speculation,
        # the engine's own KV dtype; the continuous pool is never touched),
        # and each divergence is attributed to the approximations that
        # served the request. Audits wait on lookahead's headroom gate.
        self.shadow: Optional[obs_shadow.ShadowAuditor] = None
        self._shadow_stats_memo: Optional[tuple] = None
        sh_cfg = config.shadow
        if sh_cfg.enabled:
            self.shadow = obs_shadow.ShadowAuditor(
                sh_cfg, score_fn=engine.score_exact, headroom_fn=self._lookahead_headroom,
                on_result=self._on_shadow_result, on_burst=lambda: self.record_incident("quality_divergence"),
            )
        self._init_observability()
        # incident triggers: the breaker's flip and a reset storm capture the
        # journal that explains them; the pool-exhaustion shed fires from the
        # admission gate, deadline expiry from the HTTP edge (ep_generate)
        self.breaker.on_open = lambda: self.record_incident("breaker_open")
        self.breaker.on_reset = self._maybe_reset_storm
        self.admission.incident_hook = self.record_incident
        # retrieval lookahead (TPU_RAG_LOOKAHEAD, off by default): a
        # request's retrieval launches before the admission gate can queue
        # it, and answer() joins the future
        self.lookahead: Optional[lookahead_mod.LookaheadExecutor] = None
        self._session_lock = threading.Lock()
        self._sessions: "OrderedDict[str, Tuple[float, List[str]]]" = OrderedDict()
        la_cfg = config.lookahead
        if la_cfg.enabled:
            def _la_retrieve(text: str):
                # the entry point the sequential path uses, so the results
                # and the greedy streams are the same; TTL-bounded, so a
                # wedged coalescer cannot pin the bounded pool
                return self.retrieve_coalescer.submit(text, timeout=float(la_cfg.ttl_s))

            self.lookahead = lookahead_mod.LookaheadExecutor(
                la_cfg, retrieve_fn=_la_retrieve, prestage_fn=self._lookahead_prestage,
                release_fn=self._lookahead_release, headroom_fn=self._lookahead_headroom,
                index_gen_fn=lambda: self.store.ntotal,
                # the current counters, not the scrape's memo
                tier_stats_fn=lambda: self._summed("tier_stats"),
                registry=self.metrics,
            )
            self.lookahead.join_timeout_counter = self.retrieve_coalescer.join_timeout_counter

    @property
    def flight(self):
        """The live process flight recorder (``flight.configure`` may have
        rebuilt it since this service started)."""
        return flight.recorder()

    # -- observability ----------------------------------------------------
    def _init_observability(self) -> None:
        """Register this service's metric families (JAX
        ``RagService._init_observability``, the families whose sources the
        port has; README lists the others and the item that brings each),
        attach the admission, coalescer and scheduler hooks, and rebind the
        engines and the continuous scheduler to this registry. Every
        callback reads host state, so a scrape never syncs the card."""
        reg = self.metrics
        self._m_request = reg.histogram(
            "rag_request_duration_seconds",
            "end-to-end /generate duration, server side",
            buckets=obs_metrics.REQUEST_BUCKETS,
        )
        self._m_stage = reg.labeled_histogram(
            "rag_stage_duration_seconds",
            "per-stage serving duration (stage label)",
        )
        for st in ("retrieve", "assemble", "prefix_resolve", "generate", "detokenize"):
            self._m_stage.labels(stage=st)
        wait = reg.labeled_histogram(
            "rag_coalesce_wait_seconds",
            "enqueue-to-dispatch wait in the coalescing stages (stage label)",
        )
        for st in ("retrieve", "embed", "generate"):
            wait.labels(stage=st)
        # in every mode so dashboards stay uniform; only the continuous
        # engine observes it
        reg.histogram(
            "rag_time_to_first_token_seconds",
            "submit-to-first-token (queue + coalesce + prefill + fetch)",
            buckets=obs_metrics.REQUEST_BUCKETS,
        )
        reg.gauge("rag_batch_occupancy", "requests currently occupying the serving batch/slots",
                  fn=self._batch_occupancy)
        reg.gauge("rag_admission_queue_depth", "requests queued toward the generate scheduler",
                  fn=self._queue_depth)
        # the legacy names (tpu_rag_*): engine stats summed over the serving
        # engines, read at scrape time
        reg.gauge("index_vectors", fn=lambda: self.store.ntotal)
        for name in ("generate_calls", "prefill_tokens", "decode_tokens", "spec_verify_steps",
                     "spec_emitted_tokens"):
            reg.counter(f"engine_{name}", fn=lambda name=name: self._engine_stat(name))
        self._init_spec_metrics(reg)
        self._init_prefix_metrics(reg)
        self._m_http = reg.labeled_counter(
            "rag_http_requests_total",
            "served requests by route and status code",
        )
        rejected = reg.labeled_counter(
            "rag_admission_rejected_total",
            "requests shed at the admission gate (reason: queue_full | "
            "breaker_open | pool_exhausted | fair_share | draining; "
            "tenant: edge-interned, so the series count stays bounded "
            "at reasons x (top-K tenants + __other__))",
        )
        for r in ("queue_full", "breaker_open", "pool_exhausted", "fair_share"):
            rejected.labels(reason=r, tenant="__other__")
        self.admission.reject_counter = rejected
        self._m_deadline = reg.labeled_counter(
            "rag_deadline_exceeded_total",
            "requests failed by their end-to-end deadline (stage label)",
        )
        for st in ("queue", "retrieve", "assemble", "generate", "decode"):
            self._m_deadline.labels(stage=st)
        self.admission.deadline_counter = self._m_deadline
        self._m_degraded = reg.labeled_counter(
            "rag_degraded_responses_total",
            "answers served through a quality-degrading fallback (reason: "
            "prefix_cache | sidecar)",
        )
        for r in ("prefix_cache", "sidecar"):
            self._m_degraded.labels(reason=r)
        reg.counter(
            "rag_engine_resets_total",
            "engine state resets (EngineStateLost / failed decode steps)",
        )
        retries = reg.labeled_counter(
            "rag_inflight_retries_total",
            "in-flight requests resubmitted after an engine reset "
            "(outcome: resubmitted | succeeded | gave_up)",
        )
        for o in ("resubmitted", "succeeded", "gave_up"):
            retries.labels(outcome=o)
        join_counter = reg.counter(
            "rag_scheduler_join_timeouts_total",
            "scheduler shutdowns whose worker thread outlived join(timeout)",
        )
        reg.gauge(
            "rag_breaker_open",
            "1 while the engine-reset circuit breaker holds readiness at "
            "503 (Kubernetes is draining this pod)",
            fn=lambda: float(self.breaker.open),
        )
        reg.gauge(
            "rag_breaker_recent_resets",
            "engine resets inside the breaker window right now",
            fn=lambda: float(self.breaker.recent_resets()),
        )
        reg.counter(
            "rag_flight_events_total",
            "events appended to the flight journal (ring-bounded; the "
            "counter keeps growing past the ring)",
            fn=lambda: float(flight.recorder().events_emitted),
        )
        self._m_incidents = reg.labeled_counter(
            "rag_incident_bundles_total",
            "incident bundles written to the on-disk spool (trigger: "
            "breaker_open | reset_storm | pool_exhausted_shed | "
            "deadline_exceeded; cooldown-suppressed repeats not counted)",
        )
        for t in flight.TRIGGERS:
            self._m_incidents.labels(trigger=t)
        self._init_quality_metrics(reg)
        self._init_goodput_metrics(reg)
        self._init_tenant_metrics(reg)
        # per-device allocator occupancy and prefix-cache residency
        obs_devices.register_device_gauges(reg, self._prefix_bytes_by_device, self.engine.device,
                                           commands=getattr(self.engine, "commands", None))
        for e in self._engines().values():
            e.bind_metrics(reg)
        sched = self.scheduler
        if isinstance(sched, ContinuousScheduler):
            sched.bind_metrics(reg)  # resets, retries, deadline children, join timeouts
        elif sched is not None:
            sched.join_timeout_counter = join_counter
            sched.wait_histogram = wait.labels(stage="generate")
        # the retrieve dispatch is the embed dispatch: one wait, both views
        self.retrieve_coalescer.wait_histogram = _FanoutHistogram(
            wait.labels(stage="retrieve"), wait.labels(stage="embed"),
        )
        self.retrieve_coalescer.join_timeout_counter = join_counter
        # the SLO specs over the families above: rag_slo_* gauges in the same
        # registry, and GET /slo
        self.slo = obs_slo.SloEngine(reg, specs=obs_slo.default_specs(self.config.slo))

    def _init_quality_metrics(self, reg) -> None:
        """The shadow auditor's families (JAX ``_init_observability``):
        audit outcomes, skips by reason, the divergence rate and the
        attribution per approximation, callbacks over one memoized stats
        snapshot (``_shadow_stats``), and the logit-error and
        first-divergence histograms the result hook feeds. Present in every
        mode, zero while the auditor is off."""
        q_audits = reg.labeled_counter(
            "rag_quality_audits_total",
            "shadow audits by outcome (clean — delivered stream matches "
            "the exact path's argmax chain; diverged — it doesn't; "
            "skipped — selected but unjudgeable, see "
            "rag_quality_skipped_total; failed — the audit itself crashed)",
        )
        for oc in ("clean", "diverged", "skipped", "failed"):
            q_audits.labels_callback(lambda oc=oc: self._shadow_stats().get(f"audits_{oc}", 0.0), outcome=oc)
        q_skip = reg.labeled_counter(
            "rag_quality_skipped_total",
            "sampler-selected audits that could not run (reason: sampled "
            "— non-greedy stream has no deterministic exact reference; "
            "empty | no_prompt | oversize — nothing comparable; backlog | "
            "headroom — live traffic kept the device busy)",
        )
        for r in obs_shadow.SKIP_REASONS:
            q_skip.labels_callback(lambda r=r: self._shadow_stats().get(f"skip_{r}", 0.0), reason=r)
        reg.gauge(
            "rag_quality_divergence_rate",
            "diverged / (clean + diverged) over all judged shadow audits "
            "— 0.0 is the byte-identity contracts holding on live traffic",
            fn=lambda: self._shadow_stats().get("divergence_rate", 0.0),
        )
        q_attr = reg.labeled_counter(
            "rag_quality_attribution_total",
            "judged shadow audits per ACTIVE approximation in the "
            "request's fingerprint (approximation: prefix_reuse | "
            "warm_tier | splice | rerotate | boundary_fixup | spec_verify "
            "| none; outcome: clean | diverged) — a diverging "
            "approximation names itself here",
        )
        for a in obs_shadow.APPROXIMATIONS + ("none",):
            for oc in ("clean", "diverged"):
                q_attr.labels_callback(lambda a=a, oc=oc: self._shadow_stats().get(f"attr_{a}_{oc}", 0.0),
                                       approximation=a, outcome=oc)
        self._m_quality_err = reg.histogram(
            "rag_quality_logit_err",
            "per-audit minimal explaining logit perturbation (0.0 on "
            "clean audits; the 0.15 bucket bound IS the pinned warm/"
            "splice tolerance the quality_p99_logit_err SLO evaluates at)",
            buckets=tuple(float(b) for b in obs_shadow.ERR_BUCKETS),
        )
        self._m_quality_first_div = reg.histogram(
            "rag_quality_first_divergence_token",
            "emitted position of the first exact-vs-delivered token "
            "disagreement, per diverged shadow audit (early divergence = "
            "prompt-side approximation; late = accumulated drift)",
            buckets=tuple(float(b) for b in obs_shadow.POS_BUCKETS),
        )

    def _init_goodput_metrics(self, reg) -> None:
        """The goodput ledger's families (JAX ``_init_observability``):
        per-category chip time and shares, MFU and bandwidth use per window
        kind, and cost, all callbacks over one memoized merge of the serving
        engines' ledgers (``_goodput_stats``); present in every mode, zero
        while the ledger is off."""
        gp_chip = reg.labeled_counter(
            "rag_goodput_chip_seconds_total",
            "chip-seconds attributed per goodput category — the six WINDOW "
            "categories only, each a true monotone counter summing to busy "
            "time (idle = wall − busy can shrink while both engines run "
            "concurrently, so it lives in rag_goodput_busy_frac and the "
            "/debug/goodput report, never in a counter)",
        )
        gp_frac = reg.labeled_gauge(
            "rag_goodput_window_frac",
            "fraction of BUSY chip time per attribution category (the six "
            "window categories sum to 1 while anything has run)",
        )
        for c in obs_goodput.WINDOW_CATEGORIES:
            gp_chip.labels_callback(lambda c=c: self._goodput_stats().get(f"chip_s_{c}", 0.0), category=c)
            gp_frac.labels_callback(lambda c=c: self._goodput_stats().get(f"frac_{c}", 0.0), category=c)
        reg.gauge(
            "rag_goodput_busy_frac",
            "busy / wall chip time since the ledger started (1 - this is "
            "the idle fraction the disaggregation router wants to shrink)",
            fn=lambda: self._goodput_stats().get("busy_frac", 0.0),
        )
        gp_mfu = reg.labeled_gauge(
            "rag_goodput_mfu",
            "rolling model-FLOPs utilization per executable kind (useful "
            "token lanes only — padding lanes execute but earn nothing; "
            "peaks from TPU_RAG_GOODPUT_PEAK_TFLOPS or the generic default)",
        )
        gp_bw = reg.labeled_gauge(
            "rag_goodput_bandwidth_util",
            "rolling HBM-bandwidth utilization estimate per executable "
            "kind (roofline bytes model over measured window time)",
        )
        for k in obs_goodput.KINDS:
            gp_mfu.labels_callback(lambda k=k: self._goodput_stats().get(f"mfu_{k}", 0.0), kind=k)
            gp_bw.labels_callback(lambda k=k: self._goodput_stats().get(f"bw_{k}", 0.0), kind=k)
        reg.counter(
            "rag_cost_usd_total",
            "chip rental spend so far at TPU_RAG_CHIP_HOUR_USD over WALL "
            "time (an idle chip still bills; 0 while no price is set)",
            fn=lambda: self._goodput_stats().get("cost_usd_total", 0.0),
        )
        reg.gauge(
            "rag_cost_tokens_per_usd",
            "useful decode tokens per dollar of wall-clock chip rental "
            "(the NinjaLLM tokens/s/$ gate's numerator; 0 while no price)",
            fn=lambda: self._goodput_stats().get("tokens_per_usd", 0.0),
        )

    def _init_tenant_metrics(self, reg) -> None:
        """The tenant families (JAX ``_init_observability``), each bound to
        the tracker: a demotion prunes their children at once, and the
        ``rag_tenant_tracked`` probe re-asserts the bound on every scrape.
        Counters are pushed at the edge (the HTTP outcome, the completion
        rollup, a shed)."""
        self._m_tenant_http = reg.labeled_counter(
            "rag_tenant_http_requests_total",
            "served requests by tenant and status code (tenant values are "
            "tracker-interned: top-K by request count, everything else "
            "folds into __other__) — the per-tenant availability SLO's "
            "good/total source",
        )
        self._m_tenant_req = reg.labeled_histogram(
            "rag_tenant_request_seconds",
            "end-to-end /generate duration per tracked tenant (the "
            "per-tenant latency SLO's SLI source)",
            buckets=obs_metrics.REQUEST_BUCKETS,
        )
        self._m_tenant_chip = reg.labeled_counter(
            "rag_tenant_chip_seconds_total",
            "chip-seconds attributed to completed requests per tenant — "
            "the goodput ledger's per-request attribution rolled up by the "
            "tenant that paid for it (sums to the ledger's attributed "
            "total over the same requests)",
        )
        self._m_tenant_cost = reg.labeled_counter(
            "rag_tenant_cost_usd_total",
            "chip rental spend attributed per tenant at "
            "TPU_RAG_CHIP_HOUR_USD (0 while no price is set)",
        )
        self._m_tenant_tokens = reg.labeled_counter(
            "rag_tenant_tokens_total",
            "delivered decode tokens per tenant",
        )
        self._m_tenant_sheds = reg.labeled_counter(
            "rag_tenant_sheds_total",
            "admission-gate sheds per tenant (the reason detail lives in "
            "rag_admission_rejected_total; this family answers WHO was "
            "shed)",
        )
        self.admission.tenant_shed_counter = self._m_tenant_sheds
        for fam in (self._m_tenant_http, self._m_tenant_req, self._m_tenant_chip, self._m_tenant_cost,
                    self._m_tenant_tokens, self._m_tenant_sheds):
            self.tenant_tracker.bind(fam)
        reg.gauge(
            "rag_tenant_tracked",
            "tenants currently holding tracked (non-__other__) label slots "
            "(<= TPU_RAG_TENANT_TOP_K); reading it also re-asserts the "
            "cardinality bound over every bound family and reconciles the "
            "per-tenant SLO spec set",
            fn=self._tenant_scrape_sync,
        )

    def _init_spec_metrics(self, reg) -> None:
        """The paged verify's families (JAX ``_init_observability``):
        draft-token outcomes summed over the serving engines, in every mode
        (zeros while speculation is off), and, where a continuous engine
        has rows, the acceptance EMA averaged over the active rows of each
        row bucket (bucketed, never one child per row)."""
        spec_fam = reg.labeled_counter(
            "rag_spec_tokens_total",
            "draft tokens judged by paged verify steps (outcome: accepted "
            "— emitted exactly as drafted; rejected — replaced by the "
            "correction target)",
        )
        spec_fam.labels_callback(lambda: self._engine_stat("spec_accepted_tokens"), outcome="accepted")
        spec_fam.labels_callback(
            lambda: self._engine_stat("spec_drafted_tokens") - self._engine_stat("spec_accepted_tokens"),
            outcome="rejected",
        )
        sched_eng = getattr(self.scheduler, "engine", None)
        if int(getattr(sched_eng, "B", 0) or 0) <= 0:
            # a labeled family with no children would show in the JSON
            # snapshot and not in the text exposition
            return
        spec_rows = reg.labeled_gauge(
            "rag_spec_acceptance_rate",
            "decayed draft-acceptance rate (accepted/offered EMA) "
            "averaged over the ACTIVE slots in each row bucket (row: "
            "row_lt_8 | row_lt_64 | row_ge_64; 0 while the bucket has "
            "no active rows or no evidence) — the adaptive-K "
            "controller's input: rows below "
            "TPU_RAG_SPEC_PAGED_MIN_ACCEPT degrade to K=1",
        )

        def bucket_mean(lo: int, hi: int, e=sched_eng) -> float:
            # the engine replaces slots whole, so a scrape-thread read sees
            # a consistent slot; a stale EMA is gauge-grade
            vals = [float(s.spec_ema or 0.0) for s in e.slots[lo:hi] if s.active]
            return sum(vals) / len(vals) if vals else 0.0

        for name, lo, hi in (("row_lt_8", 0, 8), ("row_lt_64", 8, 64), ("row_ge_64", 64, 1 << 30)):
            if lo < int(sched_eng.B):
                spec_rows.labels_callback(lambda lo=lo, hi=hi: bucket_mean(lo, hi), row=name)

    def _init_prefix_metrics(self, reg) -> None:
        """The prefix cache's and tiering's families (JAX
        ``_init_observability``): callbacks over ``PrefixCache.counters``,
        ``tier_stats`` and ``chunk_reuse_counters``, present in every mode
        (zeros while the cache or tiering is off)."""
        # prompt tokens whose prefill was skipped: computed (prefill_tokens)
        # + skipped = the logical prompt total
        reg.counter("prefill_tokens_skipped", fn=lambda: self._engine_stat("prefill_tokens_skipped"))
        for name in ("prefix_cache_hits", "prefix_cache_misses"):
            reg.counter(name, fn=lambda name=name: self._pcache_stat(name))
        for name in ("prefix_cache_entries", "prefix_cache_bytes"):
            reg.gauge(name, fn=lambda name=name: self._pcache_stat(name))
        tier_entries = reg.labeled_gauge(
            "rag_kv_tier_entries",
            "cached chunk entries per hotness tier (hot bf16-native | "
            "warm int8 | cold host-spilled)",
        )
        tier_bytes = reg.labeled_gauge(
            "rag_kv_tier_bytes",
            "bytes held per tier: hot/warm are device (HBM) bytes, cold "
            "is host-spill RAM",
        )
        for t in ("hot", "warm", "cold"):
            tier_entries.labels_callback(lambda t=t: self._pcache_tier_stats().get(f"tier_{t}_entries", 0.0), tier=t)
            src = "tier_cold_host_bytes" if t == "cold" else f"tier_{t}_bytes"
            tier_bytes.labels_callback(lambda src=src: self._pcache_tier_stats().get(src, 0.0), tier=t)
        tier_tr = reg.labeled_counter(
            "rag_kv_tier_transitions_total",
            "tier transitions (change: demote_warm — in-place int8 "
            "quantization; demote_cold — host spill; promote — back to "
            "native residency)",
        )
        for change, key in (("demote_warm", "demotes_warm"), ("demote_cold", "demotes_cold"),
                            ("promote", "promotes")):
            tier_tr.labels_callback(lambda key=key: self._pcache_tier_stats().get(key, 0.0), change=change)
        tier_swap = reg.labeled_counter(
            "rag_kv_tier_swap_ins_total",
            "cold-tier host→HBM swap-ins (trigger: lookahead — prefetched "
            "off the critical path, overlapped with decode; demand — paid "
            "on a serving tail)",
        )
        for trig, key in (("lookahead", "swap_ins_lookahead"), ("demand", "swap_ins_demand")):
            tier_swap.labels_callback(lambda key=key: self._pcache_tier_stats().get(key, 0.0), trigger=trig)
        reg.counter(
            "rag_kv_tier_swap_in_fallbacks_total",
            "failed host→HBM swap-ins that fell back to "
            "recompute-from-tokens (the chunk rebuilt like any miss; its "
            "host buffer released)",
            fn=lambda: self._pcache_tier_stats().get("swap_in_fallbacks", 0.0),
        )
        reg.gauge(
            "rag_kv_tier_host_spill_bytes",
            "host RAM held by cold-spilled chunk KV (bounded by "
            "TPU_RAG_KV_TIERING_HOST_MB; oldest spills evict past it)",
            fn=lambda: self._pcache_tier_stats().get("tier_cold_host_bytes", 0.0),
        )
        chunk_reuse = reg.labeled_counter(
            "rag_prefix_chunk_reuse_total",
            "chunk-granular prefix-reuse outcomes per resolved segment "
            "(chain_exact — bit-identical canonical content, incl. memo "
            "re-serves of exact spans; spliced — drifted reuse at the "
            "same offset or a memo re-serve of corrected content; "
            "rerotated — position-shifted via RoPE re-rotation; "
            "recompute — miss / cold chunk / splice-fault fallback)",
        )
        for oc in ("chain_exact", "spliced", "rerotated", "recompute"):
            chunk_reuse.labels_callback(lambda oc=oc: self._pcache_chunk_counters().get(oc, 0.0), outcome=oc)
        tier_pool = reg.labeled_gauge(
            "rag_kv_tier_pool_blocks",
            "paged-pool blocks by holder tier: hot/warm are registered "
            "prefix chains (warm = reclaimable under pressure), rows are "
            "live decode rows",
        )
        for t in ("hot", "warm", "rows"):
            tier_pool.labels_callback(lambda t=t: float(self._pool_tier_occupancy().get(t, 0)), tier=t)

    def _pool_tier_occupancy(self) -> Dict[str, int]:
        """The paged pool's blocks by holder (JAX ``tier_occupancy``):
        registered prefix chains by tier (lookahead's prestage makes them)
        and the rest, the live rows'; empty without a paged continuous
        scheduler. The pool's ledger is safe to read from a scrape thread."""
        sched = self.scheduler
        if not isinstance(sched, ContinuousScheduler):
            return {}
        return sched.engine.tier_occupancy()

    def _pcache_stat(self, name: str) -> float:
        return float(sum(
            pc.counters().get(name, 0) for pc in self._pcaches()
        ))

    def _pcaches(self) -> List:
        return [pc for e in self._engines().values() if (pc := getattr(e, "prefix_cache", None)) is not None]

    def _summed(self, method: str) -> Dict[str, float]:
        """One method's dicts (``tier_stats``, ``chunk_reuse_counters``)
        summed over the serving engines' caches."""
        out: Dict[str, float] = {}
        for pc in self._pcaches():
            for k, v in getattr(pc, method)().items():
                out[k] = out.get(k, 0.0) + v
        return out

    def _memoized(self, method: str) -> Dict[str, float]:
        """``_summed(method)``, kept for a quarter second: one scrape reads
        it from ~13 callbacks, and each fresh read takes every cache's
        resolve-path lock (JAX ``_pcache_tier_stats``; a benign race on
        the memo)."""
        now = time.monotonic()
        cached = self._prefix_memo.get(method)
        if cached is not None and now - cached[0] < 0.25:
            return cached[1]
        out = self._summed(method)
        self._prefix_memo[method] = (now, out)
        return out

    def _pcache_tier_stats(self) -> Dict[str, float]:
        return self._memoized("tier_stats")

    def _pcache_chunk_counters(self) -> Dict[str, float]:
        return self._memoized("chunk_reuse_counters")

    def _pool_retier(self) -> None:
        """Cache -> pool tier mirror (``PrefixCache.on_retier``, JAX
        ``_pool_retier``): a task on the continuous scheduler's thread
        re-tags each pool registration with its chain's tier
        (``ContinuousEngine.retier_registrations``; a cold chain's
        registration drops). The coalescing scheduler takes no engine
        tasks."""
        sched = self.scheduler
        if not hasattr(sched, "run_on_engine"):
            return
        chain_tier = self.engine.prefix_cache.chain_tier

        def _retier_task(e):
            e.retier_registrations(chain_tier)

        sched.run_on_engine(_retier_task)

    def _engines(self) -> Dict[int, object]:
        """The serving engines, deduplicated (the one-shot engine is also the
        ``BatchScheduler``'s)."""
        engines = {id(self.engine): self.engine}
        sched_engine = getattr(self.scheduler, "engine", None)
        if sched_engine is not None:
            engines[id(sched_engine)] = sched_engine
        return engines

    def _engine_stat(self, name: str) -> float:
        return float(sum(getattr(e.stats, name, 0) for e in self._engines().values()))

    def _batch_occupancy(self) -> float:
        """Continuous serving: the active rows; coalesced: the batch inside
        ``engine.generate``; no scheduler: the generate claims in flight."""
        sched = self.scheduler
        if isinstance(sched, ContinuousScheduler):
            return float(sum(1 for s in sched.engine.slots if s.active))
        if sched is not None:
            return float(sched.in_flight)
        return float(self._inflight_generate)

    def _queue_depth(self) -> float:
        """Requests waiting toward the device: the admission gate's line plus
        the scheduler's queue behind it."""
        q = getattr(self.scheduler, "_queue", None)
        return (float(q.qsize()) if q is not None else 0.0) + float(self.admission.queue_depth())

    def observe_http(self, route: str, code: int, tenant: Optional[str] = None,
                     duration_s: Optional[float] = None) -> None:
        """One served request's outcome (once per ``/generate`` or
        ``/query``); with ``tenant`` (edge-interned) also the per-tenant
        outcome counter and, with ``duration_s``, latency histogram, the
        families the per-tenant SLO specs window."""
        self._m_http.labels(route=route, code=str(int(code))).inc()
        if tenant is not None:
            self._m_tenant_http.labels(tenant=tenant, code=str(int(code))).inc()
            if duration_s is not None:
                self._m_tenant_req.labels(tenant=tenant).observe(duration_s)

    # -- goodput ledger (obs/goodput.py) ---------------------------------
    def _goodput_price(self) -> float:
        """The chip-hour price: the highest of the serving engines' ledgers
        (the source of every request's cost_usd), else the config's."""
        prices = [e.ledger.chip_hour_usd for e in self._engines().values() if getattr(e, "ledger", None) is not None]
        if prices and max(prices) > 0:
            return max(prices)
        return float(self.config.engine.goodput.chip_hour_usd or 0.0)

    def _goodput_state(self) -> Dict:
        """The serving engines' ledger states merged (the one-shot engine's
        and the continuous one's each attribute their own windows)."""
        return obs_goodput.merge_states(
            e.ledger.state() for e in self._engines().values() if getattr(e, "ledger", None) is not None
        )

    def _goodput_stats(self) -> Dict[str, float]:
        """The flat snapshot behind the goodput and cost callbacks, kept for
        a quarter second so one scrape merges the ledgers once (a benign
        race on the memo)."""
        now = time.monotonic()
        cached = self._goodput_memo
        if cached is not None and now - cached[0] < 0.25:
            return cached[1]
        report = self.goodput_report()
        out: Dict[str, float] = {"busy_frac": report["busy_frac"]}
        for c, v in report["categories"].items():
            out[f"chip_s_{c}"] = v["chip_s"]
            if c != "idle":
                out[f"frac_{c}"] = v["frac"]
        for k, v in report["kinds"].items():
            out[f"mfu_{k}"] = v["mfu"]
            out[f"bw_{k}"] = v["bw_util"]
        out["cost_usd_total"] = report["cost"]["wall_usd"]
        out["tokens_per_usd"] = report["cost"]["tokens_per_usd"]
        self._goodput_memo = (now, out)
        return out

    def goodput_report(self) -> Dict:
        """The capacity picture ``GET /debug/goodput`` serves (the renderer
        a journal's reconstruction goes through too)."""
        return obs_goodput.render_report(self._goodput_state(), chip_hour_usd=self._goodput_price())

    @staticmethod
    def _fold_goodput(timings: Dict[str, float], gen_info: Dict) -> None:
        """A request's attribution in its timings: ``chip_ms``,
        ``goodput_frac``, ``cost_usd`` when priced, and its speculation
        stats."""
        gp = gen_info.get("goodput")
        if not gp:
            return
        for key in ("chip_ms", "goodput_frac", "cost_usd", "spec_drafted", "spec_accepted",
                    "spec_accept_len_mean"):
            if key in gp:
                timings[key] = float(gp[key])

    @staticmethod
    def _round_timings(timings: Dict[str, float]) -> Dict[str, float]:
        """The response's rounded timings: cost_usd keeps 8 decimals (a
        query costs micro-dollars), goodput_frac and the acceptance mean 4."""
        digits = {"cost_usd": 8, "goodput_frac": 4, "spec_accept_len_mean": 4}
        return {k: round(v, digits.get(k, 2)) for k, v in timings.items()}

    # -- incident bundles (obs/flight.py) --------------------------------
    def _maybe_reset_storm(self) -> None:
        """The breaker's reset hook: a second reset inside its window is a
        storm (one is routine recovery); the bundle catches the journal
        while the storm's causes are still in the ring."""
        if self.breaker.recent_resets() >= 2:
            self.record_incident("reset_storm")

    def record_incident(self, trigger: str) -> Optional[str]:
        """Spool one self-contained bundle: the journal, the metrics
        snapshot, the config fingerprint and the newest 32 traces. Returns
        its id, or None inside the trigger's cooldown."""
        def _ctx():
            return {
                "journal": self.flight.snapshot(),
                "metrics": self.metrics.snapshot(),
                "config_fingerprint": flight.config_fingerprint(self.config),
                "traces": self.traces.list(32),
                "meta": {"version": __version__, "engine_mode": engine_mode(self.scheduler)},
            }

        bid = self.incidents.trigger(trigger, _ctx)
        if bid is not None:
            self._m_incidents.labels(trigger=trigger).inc()
        return bid

    # -- tenant attribution (obs/tenants.py) -----------------------------
    # -- the shadow quality auditor (obs/shadow.py) --------------------------
    def _shadow_stats(self) -> Dict[str, float]:
        """The flat snapshot behind the rag_quality_* callbacks, memoized for
        0.25 s so one scrape takes the auditor's lock once."""
        if self.shadow is None:
            return {}
        now = time.monotonic()
        cached = self._shadow_stats_memo
        if cached is not None and now - cached[0] < 0.25:
            return cached[1]
        out = self.shadow.stats()
        self._shadow_stats_memo = (now, out)
        return out

    def _on_shadow_result(self, request_id, ev: Dict) -> None:
        """The auditor's result hook (its worker thread): journal the audit
        as a ``shadow_audit`` event (what ``state_from_events`` rebuilds the
        report from), feed the quality histograms (the quality SLO's
        source), and journal a divergence as ``quality_divergence``."""
        flight.emit("shadow_audit", request_id, **ev)
        oc = ev.get("outcome")
        if oc in ("clean", "diverged"):
            self._m_quality_err.observe(float(ev.get("err", 0.0)))
        if oc == "diverged":
            self._m_quality_first_div.observe(float(ev.get("pos", 0)))
            flight.emit("quality_divergence", request_id, pos=ev.get("pos"), err=ev.get("err"),
                        approx=ev.get("approx") or [])

    @staticmethod
    def _approx_fingerprint(gen_info: Optional[Dict], cp=None) -> Tuple[str, ...]:
        """A request's approximation fingerprint: the prefix cache's marks
        for its resolve (``CachedPrefix.approx``) and what the engine stamped
        into ``info`` (the continuous engine's verify windows)."""
        ap = set()
        if cp is not None:
            ap.update(getattr(cp, "approx", ()) or ())
        gi = gen_info or {}
        ap.update(gi.get("approx", ()) or ())
        if (gi.get("goodput") or {}).get("spec_drafted"):
            ap.add("spec_verify")
        return tuple(sorted(ap))

    def _shadow_observe(self, served_by, out_ids, gen_info: Optional[Dict], prompt_ids=None, prompt_fn=None,
                        cp=None, tenant: Optional[str] = None, sampling: Optional[SamplingConfig] = None) -> None:
        """Offer one delivered response to the auditor (sampling, backlog
        and headroom live there). A sampled stream (the request's own
        ``sampling``, else the serving engine's) has no deterministic exact
        reference, so it is ineligible, and counted only when the sampler
        selects it. Never raises: an audit must not fail its response."""
        sh = self.shadow
        if sh is None:
            return
        try:
            s = sampling if sampling is not None else getattr(served_by, "sampling", None)
            eligible = not (s is not None and s.do_sample and s.temperature > 0.0)
            sh.observe(
                emitted=list(out_ids), approx=self._approx_fingerprint(gen_info, cp),
                request_id=(gen_info or {}).get("request_id"), prompt_ids=prompt_ids, prompt_fn=prompt_fn,
                eligible=eligible, tenant=tenant,
            )
        except Exception:  # noqa: BLE001 — auditing must not fail serving
            logger.exception("shadow observe failed")

    def quality_report(self) -> Dict:
        """What ``GET /debug/quality`` serves: ``report`` is
        ``render_report`` of the live state, the function that renders a
        journal's ``shadow_audit`` events offline, and ``sampling`` the
        auditor's own counts (seen, selected), which the journal does not
        carry."""
        sh = self.shadow
        if sh is None:
            return {"enabled": False, "report": obs_shadow.render_report(obs_shadow.new_state())}
        stats = sh.stats()
        return {
            "enabled": True,
            "report": obs_shadow.render_report(sh.state()),
            "sampling": {
                "sample_rate": sh.config.sample_rate,
                "seen": int(stats.get("seen", 0)),
                "selected": int(stats.get("selected", 0)),
                "backlog_depth": int(stats.get("backlog_depth", 0)),
            },
        }

    def _prefix_bytes_by_device(self) -> Dict[int, int]:
        """``{device index: prefix-cache bytes}`` over the serving engines'
        caches (empty with the cache off)."""
        out: Dict[int, int] = {}
        for pc in self._pcaches():
            for did, nbytes in pc.bytes_by_device().items():
                out[did] = out.get(did, 0) + nbytes
        return out

    def _tenant_scrape_sync(self) -> float:
        """The ``rag_tenant_tracked`` probe: it re-asserts the cardinality
        bound over the bound families (healing a demotion that raced a
        ``labels()`` call) and reconciles the per-tenant SLO specs."""
        trk = self.tenant_tracker
        trk.prune()
        tracked = trk.tracked()
        slo = getattr(self, "slo", None)
        if slo is not None:
            slo.set_tenants(tracked)
        return float(len(tracked))

    def _tenant_complete(self, tenant: str, gen_info: Optional[Dict], n_tokens: int) -> None:
        """Fold one completed request into its tenant's counters, from the
        request's own attribution, so the tenants' chip seconds sum to the
        ledger's attributed total over the same requests."""
        try:
            self._m_tenant_tokens.labels(tenant=tenant).inc(float(n_tokens))
            gp = (gen_info or {}).get("goodput") or {}
            chip_ms = float(gp.get("chip_ms", 0.0) or 0.0)
            if chip_ms > 0:
                self._m_tenant_chip.labels(tenant=tenant).inc(chip_ms / 1e3)
            cost = float(gp.get("cost_usd", 0.0) or 0.0)
            if cost > 0:
                self._m_tenant_cost.labels(tenant=tenant).inc(cost)
        except Exception:  # noqa: BLE001 — attribution must not fail serving
            logger.exception("tenant rollup failed")

    def _tenant_ledger_rollups(self) -> Dict[str, Dict[str, float]]:
        """The engines' per-tenant ledger rollups merged (additive keys
        sum; the goodput fraction is recomputed after the merge)."""
        out: Dict[str, Dict[str, float]] = {}
        for e in self._engines().values():
            led = getattr(e, "ledger", None)
            if led is None:
                continue
            for t, row in led.tenant_state().items():
                dst = out.setdefault(t, {})
                for k, v in row.items():
                    if k != "goodput_frac":
                        dst[k] = dst.get(k, 0.0) + float(v)
        for row in out.values():
            row["goodput_frac"] = round(min(1.0, row.get("useful_s", 0.0) / max(row.get("chip_s", 0.0), 1e-30)), 6)
        return out

    def tenant_report(self) -> Dict:
        """The per-tenant picture ``GET /debug/tenants`` serves: the
        journal folded through ``obs/tenants.py`` (the renderer a saved
        journal goes through), plus the live-only tracker table, ledger
        rollups and per-tenant SLO burn."""
        report = obs_tenants.render_report(
            obs_tenants.state_from_events(self.flight.snapshot()), chip_hour_usd=self._goodput_price(),
        )
        self.slo.set_tenants(self.tenant_tracker.tracked())
        return {
            "enabled": self.tenants_enabled,
            "report": report,
            "tracker": self.tenant_tracker.snapshot(),
            "ledger": self._tenant_ledger_rollups(),
            "slo": self.slo.evaluate().get("tenants", {}),
        }

    def _observe_request(self, timings: Dict[str, float]) -> None:
        """Feed the request and stage histograms from one answered request's
        timings, exactly once per request. The assemble and detokenize
        stages have no public timings key: their span sites leave private
        ``_*_s`` entries, popped here."""
        if "total_ms" in timings:
            self._m_request.observe(timings["total_ms"] / 1e3)
        for key, stage in (("embed_retrieve_ms", "retrieve"), ("prefix_resolve_ms", "prefix_resolve"),
                           ("generate_ms", "generate")):
            if key in timings:
                self._m_stage.labels(stage=stage).observe(timings[key] / 1e3)
        for key, stage in (("_assemble_s", "assemble"), ("_detokenize_s", "detokenize")):
            v = timings.pop(key, None)
            if v is not None:
                self._m_stage.labels(stage=stage).observe(v)

    def _trace_retrieve(self, parent, t0: float, timings: Dict[str, float]) -> None:
        """Attach the retrieve stage's interior to the live ``retrieve``
        span: the work ran on the coalescer's thread, so the tokenize and
        embed+kNN split is synthesized from the timings' own numbers (the
        ``embed_knn`` child includes the coalesce wait)."""
        tr = tracing.current_trace()
        if tr is None or parent is None:
            return
        pidx = next((i for i, sp in enumerate(tr.spans) if sp is parent), None)
        if pidx is None:
            return
        tok_s = timings.get("tokenize_ms", 0.0) / 1e3
        tr.add_span("tokenize", t0, tok_s, parent=pidx)
        tr.add_span("embed_knn", t0 + tok_s, timings.get("embed_retrieve_ms", 0.0) / 1e3, parent=pidx)

    def _degrade(self, notes: List[str], reason: str) -> None:
        """Count one quality-degrading fallback and note it for the response."""
        self._m_degraded.labels(reason=reason).inc()
        if reason not in notes:
            notes.append(reason)

    @staticmethod
    def _finish(resp: Dict, notes: List[str]) -> Dict:
        """Stamp the degraded-mode markers onto a response."""
        if notes:
            resp["degraded"] = True
            resp["degraded_reasons"] = list(notes)
        return resp

    # -- ingest ---------------------------------------------------------
    def embed_texts(self, texts: List[str]) -> np.ndarray:
        limit = self.config.encoder.max_encode_len
        eos = getattr(self.encoder_tokenizer, "eos_id", None)
        return self.encoder.encode(
            [truncate_keep_eos(self.encoder_tokenizer.encode(t), limit, eos) for t in texts]
        )

    def ingest_pdf_bytes(self, data: bytes, filename: str) -> int:
        """Extract → chunk → batch-embed → index (and save the snapshot when
        the store has a path). Returns the chunk count."""
        t0 = time.monotonic()
        text = extract_text(data)
        r = self.config.retrieval
        chunks = split_text(text, r.chunk_size, r.chunk_overlap)
        if not chunks:
            return 0
        vectors = self.embed_texts(chunks)
        metadata = [{"filename": filename, "chunk_id": i, "text": c} for i, c in enumerate(chunks)]
        added = self.store.add(list(vectors), metadata)
        if added and self.store.path:
            self.store.save()
        self.metrics.observe("ingest_seconds", time.monotonic() - t0)
        self.metrics.inc("ingested_chunks", added)
        logger.info("ingested %s: %d chunks (%d new)", filename, len(chunks), added)
        return len(chunks)

    def ingest_directory(self, pdf_dir: Optional[str] = None) -> int:
        """Boot-time ingest of every ``*.pdf`` in ``pdf_dir`` (default: the
        config's), idempotent through the store's content-hash dedup; one
        bad PDF is logged and skipped. Returns the number of PDF files."""
        pdf_dir = pdf_dir or self.config.server.pdf_dir
        if not os.path.isdir(pdf_dir):
            logger.warning("No PDF directory at %s", pdf_dir)
            return 0
        files = [f for f in sorted(os.listdir(pdf_dir)) if f.endswith(".pdf")]
        for fname in files:
            try:
                with open(os.path.join(pdf_dir, fname), "rb") as f:
                    self.ingest_pdf_bytes(f.read(), fname)
            except Exception:  # noqa: BLE001 — one bad PDF must not stop the boot
                logger.exception("failed to ingest %s; skipping", fname)
        if not files:
            logger.warning("No PDF files found in %s", pdf_dir)
        return len(files)

    # -- prompt pieces --------------------------------------------------
    def _a_ids(self) -> List[int]:
        """BOS + "{system}\\n\\nContext: " — the fixed prompt head."""
        if self._a_ids_cache is None:
            ids = self.llm_tokenizer.encode(f"{self.config.system_message}\n\nContext: ")
            bos = self.config.model.bos_token_id
            if not ids or ids[0] != bos:
                ids = [bos] + ids
            self._a_ids_cache = ids
        return self._a_ids_cache

    def _b_ids(self, user_prompt: str) -> List[int]:
        """"\\n\\nUser: {q}\\n\\nChatbot:" — the per-query prompt tail."""
        return self.llm_tokenizer.encode(f"\n\nUser: {user_prompt}\n\nChatbot:")

    def _fused_ok(self) -> bool:
        """Single-fetch path applicability, the JAX rule: only under a
        ``BatchScheduler``, and never with the prefix cache on (its path
        needs the retrieve results on the host to resolve segments)."""
        ec = self.engine.engine_config
        return (
            ec.rag_fused
            and not self._prefix_enabled()
            and isinstance(self.scheduler, BatchScheduler)
            and 0 < self.store.ntotal <= ec.rag_fused_max_vectors
        )

    def _scheduler_prompt_cap(self) -> int:
        """Longest prompt the scheduler takes without truncating: the
        continuous engine's largest bucket; the coalescing scheduler hands
        prompts to the chunk-capable one-shot engine, so it has no cap."""
        if isinstance(self.scheduler, ContinuousScheduler):
            return max(self.scheduler.engine.buckets)
        return 1 << 62

    def warm_shapes(self) -> List[Tuple[int, int, object]]:
        """JAX's warm set of the one-shot engine (``RagService.warmup``): with
        no scheduler or the coalescing one, batch 1 at every bucket
        (``InferenceEngine.warmup``: spec and vanilla under ``auto``), and
        under the coalescing scheduler its padded batch ladder 2 ..
        ``next_pow2(max_batch_size)`` at the largest bucket, or at every
        bucket with ``warm_full_ladder`` (``TPU_RAG_WARM_FULL_LADDER=1``).
        Under the continuous scheduler the one-shot engine serves only the
        over-bucket prompts: one chunked prefill of twice the largest
        bucket. Runs each shape once; returns the ``(batch, bucket,
        variant)`` shapes run."""
        ec = self.engine.engine_config
        largest = max(ec.prompt_buckets)
        if isinstance(self.scheduler, ContinuousScheduler):
            self.engine.warm_shape(1, 2 * largest, largest)
            return [(1, 2 * largest, largest)]
        shapes = self.engine.warmup(batch_sizes=(1,), buckets=ec.prompt_buckets)
        if isinstance(self.scheduler, BatchScheduler):
            top, sizes, b = next_pow2(ec.max_batch_size), [], 2
            while b <= top:
                sizes.append(b)
                b *= 2
            if sizes:
                warm_buckets = tuple(ec.prompt_buckets) if ec.warm_full_ladder else (largest,)
                shapes += self.engine.warmup(batch_sizes=tuple(sizes), buckets=warm_buckets)
        return shapes

    def warmup(self) -> None:
        """Build what the first request would otherwise build, then mark the
        service ready: on the card the CUDA kernels (``ops._build``), the
        C++ libraries (the tokenizer's merge loop is built when it loads; the
        index codec here), then one request-shaped pass: an embedding, a
        retrieve alone and a padded burst of them, the chunk-token sidecar,
        and JAX's warm set of generate shapes (``warm_shapes``; the list
        and its seconds in ``warm_report``)."""
        if self.engine.device.type == "cuda":
            from rag_llm_k8s_tpu_torch.ops import _build

            _build.build()
        if self.store.path:
            from rag_llm_k8s_tpu_torch.native.build import load_library

            load_library("indexio")
        self.embed_texts(["warmup"])
        self._retrieve("warmup")
        if self.store.ntotal:
            self._retrieve_many(["warmup"] * self._retrieve_cap)
            if self.engine.engine_config.rag_fused:
                self.store.token_snapshot()
        t_warm = time.perf_counter()
        shapes = self.warm_shapes()
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)
        self.warm_report = {"shapes": shapes, "seconds": time.perf_counter() - t_warm}
        if self._prefix_enabled():
            # build and PIN the head block (every request reuses it), so no
            # request prefills the head
            try:
                head_key = f"head:{len(self._a_ids())}"
                self.engine.prefix_cache.pin(head_key)
                self.engine.prefix_cache.prefix_for([(head_key, self._a_ids())])
                self.engine.warm_prefixed()
            except Exception:  # noqa: BLE001 — warmup must not fail the boot
                logger.exception("prefix-cache warmup failed")
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)
        self.ready = True

    def shutdown(self) -> None:
        if self.shadow is not None:
            # first: the audit worker drives the one-shot engine, which
            # must outlive any audit in flight
            self.shadow.shutdown()
        if self.lookahead is not None:
            # first: its workers submit into the retrieve coalescer
            self.lookahead.shutdown()
        self.retrieve_coalescer.shutdown()
        if self.scheduler is not None:
            self.scheduler.shutdown()
        commands = getattr(self.engine, "commands", None)
        if commands is not None:
            # last: nothing above drives the engine any more
            commands.stop()
        wal = self.flight_wal
        if wal is not None:
            if flight.recorder().wal is wal:
                flight.configure(wal=None)
            wal.close()

    # -- the durable lifecycle ----------------------------------------------
    def _persist_for_restart(self) -> None:
        """The drain's persist step (JAX ``_persist_for_restart``): fsync the
        WAL's tail and write the warmth manifest beside it, what the next
        incarnation needs to come back warm. A failed manifest write makes
        the restart cold; it never blocks the exit."""
        if self.flight_wal is not None:
            self.flight_wal.sync()
        try:
            self._write_warmth_manifest()
        except Exception:  # noqa: BLE001 — persist must not stall the exit
            logger.exception("warmth manifest write failed")

    def _write_warmth_manifest(self) -> Optional[str]:
        """The prefix cache's hottest ``(key, ids)`` records, written
        durably (``flight.durable_write``) into the WAL directory; the path,
        or None with no WAL, no cache or rehydration off."""
        fl = self.config.flight
        cache = self.engine.prefix_cache
        if self.flight_wal is None or fl.wal_restore_chunks <= 0 or cache is None:
            return None
        path = os.path.join(fl.wal_dir, "warmth_manifest.json")
        flight.durable_write(path, {
            "schema_version": flight.SCHEMA_VERSION, "ts": time.time(),
            "entries": cache.warmth_manifest(top_n=fl.wal_restore_chunks),
        })
        return path

    def _rehydrate_warmth(self, fl) -> int:
        """Re-prefill the warmth manifest's segments, hottest first, at most
        ``wal_restore_chunks``, through the prefix cache's own resolve
        (``prefix_for``: its miss path is its populate path). Returns the
        segments staged."""
        cache = self.engine.prefix_cache
        if fl.wal_restore_chunks <= 0 or cache is None:
            return 0
        try:
            with open(os.path.join(fl.wal_dir, "warmth_manifest.json")) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return 0  # no manifest: a first boot, or SIGKILL before any drain
        staged = 0
        for ent in doc.get("entries", ())[:fl.wal_restore_chunks]:
            key, ids = ent.get("key"), ent.get("ids")
            if not key or not ids:
                continue
            try:
                got = cache.prefix_for([(str(key), [int(x) for x in ids])])
            except Exception:  # noqa: BLE001 — warmth is opportunistic
                logger.exception("warmth rehydrate failed (key=%s)", key)
                break
            if got is not None:
                staged += 1
                flight.emit("restore", phase="rehydrate", key=str(key), tokens=len(ids))
        return staged

    def restore_from_wal(self, wait: bool = False) -> Dict:
        """The warm restart (JAX ``restore_from_wal``): re-stage the warmth
        manifest, then resubmit every request the latest dead epoch of the
        WAL left in flight, with the tokens its ``token_emit`` events prove
        folded in (``ContinuousScheduler.submit(resume_emitted=...)``), so
        the stream is the uninterrupted one. Their callers are gone;
        completing them makes the journal whole and warms the cache for
        their retries. Records with a synthetic prompt (the recorder kept
        lengths only) are skipped, and so is every record under a
        scheduler that cannot fold (``reason="no_scheduler"``). Returns
        ``{"resumed", "skipped", "rehydrated", "results"}``; ``wait=True``
        blocks for the resumed completions and keys their streams by the
        original request id."""
        fl = self.config.flight
        summary: Dict = {"resumed": 0, "skipped": 0, "rehydrated": 0, "results": {}}
        wal = self.flight_wal
        if wal is None or not fl.wal_restore:
            return summary
        summary["rehydrated"] = self._rehydrate_warmth(fl)
        epochs = flight.scan_wal(fl.wal_dir)
        dead = [e for e in sorted(epochs) if e < wal.epoch]
        if not dead:
            return summary
        # only the latest dead epoch: anything older and unfinished was
        # restored into it (and journaled there again) or pruned
        from rag_llm_k8s_tpu_torch.sim import replay

        orig_epoch = dead[-1]
        records = replay.extract_inflight(epochs[orig_epoch])["inflight"]
        sched = self.scheduler
        if records and not isinstance(sched, ContinuousScheduler):
            for rec in records:
                summary["skipped"] += 1
                flight.emit("restore", phase="skip", orig_rid=rec["rid"], reason="no_scheduler")
            return summary
        threads = []
        lock = threading.Lock()
        for rec in records:
            if rec["synthetic_prompt"]:
                # a resume would continue a filler prompt, not the request
                summary["skipped"] += 1
                flight.emit("restore", phase="skip", orig_rid=rec["rid"], reason="synthetic_prompt")
                continue
            summary["resumed"] += 1
            flight.emit("restore", phase="resume", orig_rid=rec["rid"], orig_epoch=orig_epoch,
                        n_emitted=len(rec["emitted"]))

            def _resume(rec=rec):
                try:
                    toks = sched.submit(rec["prompt"], max_new_tokens=rec["max_new"], seed=rec.get("seed"),
                                        tenant=rec.get("tenant"), resume_emitted=rec["emitted"])
                except Exception:  # noqa: BLE001 — one lost resume is not a failed boot
                    logger.exception("WAL resume failed (orig_rid=%s)", rec["rid"])
                    return
                with lock:
                    summary["results"][rec["rid"]] = toks

            th = threading.Thread(target=_resume, daemon=True, name=f"wal-restore-{rec['rid']}")
            th.start()
            threads.append(th)
        if wait:
            for th in threads:
                th.join()
        return summary

    @staticmethod
    def _kept_chunks(seg_lens, avail: int):
        """THE context-budget rule, identical to the device assembly: keep the
        longest chunk prefix that fits; token-truncate the first chunk if it
        alone overflows. Returns ``(n_kept, used_tokens, trunc_or_None)``."""
        used = n_kept = 0
        trunc = None
        for j, L in enumerate(seg_lens):
            if used + L <= avail:
                used += L
                n_kept += 1
            else:
                if j == 0:
                    trunc = max(avail, 0)
                    used = trunc
                    n_kept = 1
                break
        return n_kept, used, trunc

    def _segment_ids(self, metadata: Dict) -> List[int]:
        """One chunk's prompt segment as LLM token ids: the store's token
        source and the host path's segment builder alike."""
        return self._segment_source(metadata)

    def _prompt_segments(self, user_prompt: str, results):
        """THE prompt-segment layout (JAX ``_prompt_segments``): ``(context,
        segments, b_ids)`` with ``segments = [(key, ids), ...]`` the head and
        the kept chunk segments under the budget rule (``_kept_chunks``).
        Host assembly and the prefix cache both cut prompts here, so cached
        blocks line up across requests. Chunk keys are the store's content
        hash (stable across restarts); a budget-truncated first chunk gets a
        key of its own. None when head + tail leave fewer than 16 tokens of
        context room."""
        a_ids = self._a_ids()
        b_ids = self._b_ids(user_prompt)
        avail = max(self.engine.engine_config.prompt_buckets) - len(a_ids) - len(b_ids)
        if avail < 16:
            return None
        segs: List[List[int]] = []
        keys: List[str] = []
        for r in results[: self.config.retrieval.context_top_n]:
            cached = self.store.cached_token_row(r.row)
            segs.append(list(cached) if cached is not None else self._segment_ids(r.metadata))
            ck = self.store.content_key(r.row)
            keys.append(f"chunk:{ck}" if ck is not None
                        else f"chunk:anon:{hash(tuple(segs[-1])) & 0xFFFFFFFFFFFF:012x}")
        n_kept, _, trunc = self._kept_chunks([len(s) for s in segs], avail)
        kept, kept_keys = segs[:n_kept], keys[:n_kept]
        if trunc is not None:
            kept[0] = kept[0][:trunc]
            kept_keys[0] = f"{kept_keys[0]}:t{trunc}"
        segments = [(f"head:{len(a_ids)}", list(a_ids))]
        segments.extend(zip(kept_keys, kept))
        return assemble_context(results, n_kept), segments, b_ids

    def _piecewise_prompt(self, user_prompt: str, results):
        """Host mirror of the device assembly: head ‖ kept chunk segments ‖
        tail (``_prompt_segments``). None when head + tail leave fewer than
        16 tokens of context room."""
        ps = self._prompt_segments(user_prompt, results)
        if ps is None:
            return None
        context, segments, b_ids = ps
        ids = [t for _, seg in segments for t in seg]
        ids.extend(b_ids)
        return context, ids

    def _budgeted_prompt(self, user_prompt: str, results):
        """Whole-string prompt, shrinking the context (drop trailing chunks,
        then trim the last chunk's words) until it fits the largest bucket;
        an irreducible question goes through whole, to chunked prefill."""
        budget = max(self.engine.engine_config.prompt_buckets)
        bos = self.config.model.bos_token_id
        used = [
            SearchResult(metadata=dict(r.metadata), distance=r.distance)
            for r in results[: self.config.retrieval.context_top_n]
        ]
        while True:
            context = assemble_context(used, len(used))
            ids = self.llm_tokenizer.encode(
                assemble_prompt(user_prompt, context, self.config.system_message)
            )
            if not ids or ids[0] != bos:
                ids = [bos] + ids
            if len(ids) <= budget:
                return context, ids
            if len(used) > 1:
                used.pop()
                continue
            words = used[0].metadata.get("text", "").split()
            target = min(len(words) - 1, int(len(words) * budget / len(ids) * 0.9))
            if target < 10:
                return context, ids
            used[0].metadata["text"] = " ".join(words[:target])

    # -- retrieve -------------------------------------------------------
    def _retrieve(self, text: str, allow_device: bool = False):
        """One query through :meth:`_retrieve_many`."""
        return self._retrieve_many([text], allow_device)[0]

    def _retrieve_many(self, texts: List[str], allow_device: bool = False):
        """Embed the queries and rank them against the index on the device:
        one encoder forward and one ``knn_topk`` call per length bucket (in
        practice one). A batch of more than one pads to ``_retrieve_cap``
        rows (the padding rows repeat the first query), so bursts add one
        shape, not a ladder. Returns ``[(results, tokenize_ms)]`` in input
        order.

        With ``allow_device``, a singleton batch on the single-fetch path
        returns the packed ``[1, 2k]`` device tensor unfetched:
        ``[("__device__", packed, k_eff, tokenize_ms)]``."""
        n = self.store.ntotal
        if n == 0:
            return [([], 0.0)] * len(texts)
        # never more neighbours than real rows: the kernel's fill entries
        # past ntotal are never asked for
        k_eff = min(self.config.retrieval.k, n)
        emb, norms = self.store.device_snapshot()
        prepped = []
        for text in texts:
            t0 = time.monotonic()
            tokens, mask = self.encoder.prepare_batch(self.encoder_tokenizer.encode(text))
            prepped.append((tokens, mask, (time.monotonic() - t0) * 1e3))

        def rank(tokens: np.ndarray, mask: np.ndarray) -> torch.Tensor:
            with torch.inference_mode():
                vec = self.encoder.embed(tokens, mask)
                d, i = knn_topk(vec.float().contiguous(), emb, norms, k=k_eff)
                # one [B, 2k] tensor: fp32 carries row ids exactly up to 2^24
                return torch.cat([d, i.float()], dim=1)

        if allow_device and len(texts) == 1 and self._fused_ok():
            tokens, mask, tok_ms = prepped[0]
            return [("__device__", rank(tokens, mask), k_eff, tok_ms)]

        out: List = [None] * len(texts)
        by_bucket: Dict[int, List[int]] = {}
        for i, (tokens, _, _) in enumerate(prepped):
            by_bucket.setdefault(tokens.shape[1], []).append(i)
        for S, idxs in by_bucket.items():
            for start in range(0, len(idxs), self._retrieve_cap):
                group = idxs[start : start + self._retrieve_cap]
                B_pad = 1 if len(group) == 1 else self._retrieve_cap
                rows = group + [group[0]] * (B_pad - len(group))
                tokens = np.concatenate([prepped[i][0] for i in rows])
                mask = np.concatenate([prepped[i][1] for i in rows])
                packed = rank(tokens, mask).cpu().numpy()  # one fetch
                dists, idx = packed[:, :k_eff], packed[:, k_eff:].astype(np.int64)
                for row, i in enumerate(group):
                    out[i] = (self.store.results_at(idx[row], dists[row]), prepped[i][2])
        return out

    # -- answer ---------------------------------------------------------
    def _release(self, retrieve: bool = False, generate: bool = False) -> None:
        with self._inflight_lock:
            self._inflight_retrieve -= int(retrieve)
            self._inflight_generate -= int(generate)

    def _deadline_check(self, deadline: Optional[Deadline], stage: str) -> None:
        """One stage-boundary deadline check: count and raise on expiry."""
        if deadline is not None and deadline.expired():
            self._m_deadline.labels(stage=stage).inc()
            raise DeadlineExceeded(stage, deadline.budget_ms)

    # -- retrieval lookahead (rag/lookahead.py callbacks) -------------------
    def _lookahead_headroom(self) -> bool:
        """False while speculative work would press on live traffic: the
        breaker is open, requests queue at the admission gate, or a paged
        pool lacks a full row's blocks (a read-only probe; the authoritative
        gate is ``prestage_prefix``'s, on the scheduler thread)."""
        if self.breaker.open:
            return False
        if self.admission.queue_depth() > 0:
            return False
        eng = getattr(self.scheduler, "engine", None)
        pool = getattr(eng, "kv_pool", None)
        if pool is not None and not pool.can_alloc(eng.MB):
            return False
        return True

    def _lookahead_prestage(self, text: str, r):
        """Executor-worker callback as a lookahead retrieval resolves: the
        resolved chunks' segment KV built into prefix-cache entries
        (``PrefixCache.stage``) and, on a paged continuous engine, the
        chain's full pool blocks registered ahead of admission
        (``prestage_prefix``, an engine task that records the registration's
        generation when it made the registration). Returns the staging
        handle a dead speculation releases, or None."""
        if not self._prefix_enabled():
            return None
        if isinstance(r, tuple) and len(r) == 4 and r[0] == "__device__":
            return None  # unfetched device handle: nothing to key on the host
        results = r[0] if isinstance(r, tuple) else r
        if not results or not self._lookahead_headroom():
            return None
        ps = self._prompt_segments(text, results)
        if ps is None:
            return None
        cache = self.engine.prefix_cache
        cp, record = cache.stage(ps[1])
        if cp is None:
            return None
        handle = {"record": record, "chain_key": cp.chain_key, "pool": None}
        sched = self.scheduler
        if cp.chain_key is not None and isinstance(sched, ContinuousScheduler) and sched.engine.paged:
            # only the task that made the registration may release it, and
            # the generation keeps it from freeing one re-created since; a
            # release task queued later runs after this one
            tier = cache.chain_tier(cp.chain_key)

            def _prestage_task(e, _h=handle, _cp=cp, _tier=tier):
                if e.prestage_prefix(_cp, tier=_tier) == "registered":
                    _h["pool"] = e.prestage_gen(_cp.chain_key)

            sched.run_on_engine(_prestage_task)
        return handle

    def _lookahead_release(self, handle: Dict) -> None:
        """Release what a dead speculation staged and nothing consumed: its
        prefix-cache entries (``release_staged``) and its pool registration
        (``release_prestaged`` with ``only_unused`` and the staged
        generation, as an engine task after the prestage task)."""
        cache = self.engine.prefix_cache
        if cache is not None:
            cache.release_staged(handle.get("record"))
        ck = handle.get("chain_key")
        sched = self.scheduler
        if ck is not None and hasattr(sched, "run_on_engine"):
            sched.run_on_engine(
                lambda e: handle.get("pool") is not None
                and e.release_prestaged(ck, only_unused=True, gen=handle["pool"])
            )

    def _session_note(self, session_id: str, prompt: str) -> str:
        """Fold a turn's prompt into its session and return the speculative
        next-turn query: the trailing ``session_context_turns`` turns joined.
        Sessions are LRU-capped and idle-expired."""
        lc = self.config.lookahead
        now = time.monotonic()
        with self._session_lock:
            _, hist = self._sessions.pop(session_id, (now, []))
            hist = (hist + [prompt])[-max(1, lc.session_context_turns):]
            self._sessions[session_id] = (now, hist)
            for k in list(self._sessions):
                if k == session_id:
                    continue
                ts0, _ = self._sessions[k]
                if len(self._sessions) > lc.session_max or now - ts0 > lc.session_ttl_s:
                    del self._sessions[k]
                else:
                    break  # ordered by recency: the rest are fresher
            return " ".join(hist)

    def _join_lookahead(self, fut, deadline: Optional[Deadline], timings: Dict[str, float]):
        """The serving tail's side of a claimed lookahead future: its
        result, with the worker's tokenize time zeroed (the stage timing is
        the join's wall clock). ``JoinTimeout`` (this request's deadline)
        is a 504 on the retrieve stage; a worker-side failure returns None
        and the request retrieves inline."""
        was_hit = fut.resolved()
        try:
            with tracing.span("lookahead_join"):
                r = self.lookahead.join(fut, timeout=deadline.wait_timeout() if deadline is not None else None)
        except lookahead_mod.JoinTimeout:
            self._m_deadline.labels(stage="retrieve").inc()
            raise DeadlineExceeded("retrieve", deadline.budget_ms if deadline else None) from None
        except Exception:  # noqa: BLE001 — a failed speculation must not fail the request
            logger.warning("lookahead retrieval failed; retrieving inline", exc_info=True)
            return None
        timings["lookahead_hit"] = 1.0 if was_hit else 0.0
        if r[0] == "__device__":
            return (r[0], r[1], r[2], 0.0)
        return (r[0], 0.0)

    def answer(
        self, user_prompt: str, sampling: Optional[SamplingConfig] = None,
        deadline: Optional[Deadline] = None, tenant: Optional[str] = None,
        session_id: Optional[str] = None,
    ) -> Dict:
        """Retrieve, assemble, generate. ``sampling`` overrides the engine's
        settings for this request; only the continuous scheduler takes it.
        ``deadline`` is checked after retrieval and after assembly and
        bounds the waits (``DeadlineExceeded`` names the stage); ``tenant``
        rides to the scheduler. Each stage is a span of the current trace
        (``obs/tracing.py``). With lookahead on, the retrieval is the
        future the HTTP layer launched, joined (else inline), and a
        ``session_id`` speculates the session's next turn before
        generation."""
        if sampling is not None and not isinstance(self.scheduler, ContinuousScheduler):
            raise ValueError("per-request sampling needs batching='continuous'")
        timings: Dict[str, float] = {}
        notes: List[str] = []  # degraded-path reasons (response + counter)
        t_all = time.monotonic()
        with self._inflight_lock:
            self._inflight_retrieve += 1
            self._inflight_generate += 1
        in_retrieve = in_generate = True
        try:
            la = self.lookahead
            fut = la.claim(user_prompt) if la is not None else None
            with tracing.span("retrieve") as retrieve_span:
                r = self._join_lookahead(fut, deadline, timings) if fut is not None else None
                if r is None:
                    if la is not None:
                        la.note_miss()
                    try:
                        r = self.retrieve_coalescer.submit(
                            user_prompt, timeout=deadline.wait_timeout() if deadline is not None else None
                        )
                    except TimeoutError:
                        self._m_deadline.labels(stage="retrieve").inc()
                        raise DeadlineExceeded("retrieve", deadline.budget_ms if deadline else None) from None
            self._release(retrieve=True)
            in_retrieve = False
            self._deadline_check(deadline, "retrieve")
            if session_id and la is not None:
                # speculate the next turn now, so its retrieval and KV
                # staging overlap this turn's generation
                spec_text = self._session_note(session_id, user_prompt)
                if spec_text:
                    la.speculate(session_id, spec_text)
            if r[0] == "__device__":
                timings["tokenize_ms"] = r[3]
                timings["embed_retrieve_ms"] = (time.monotonic() - t_all) * 1e3 - r[3]
                self._trace_retrieve(retrieve_span, t_all, timings)
                # a fused request never reaches the scheduler: release its
                # generate claim now, or the scheduler's hint would wait for it
                self._release(generate=True)
                in_generate = False
                resp = self._answer_fused(user_prompt, r, timings, t_all, notes, tenant)
                if resp is not None:
                    return self._finish(resp, notes)
                with self._inflight_lock:
                    self._inflight_generate += 1
                in_generate = True
                # head + tail did not fit the bucket: fetch the hits, host path
                k_eff = r[2]
                packed = r[1].cpu().numpy()
                results = self.store.results_at(packed[0, k_eff:].astype(np.int64), packed[0, :k_eff])
            else:
                results, tok_ms = r
                timings["tokenize_ms"] = tok_ms
                timings["embed_retrieve_ms"] = (time.monotonic() - t_all) * 1e3 - tok_ms
                self._trace_retrieve(retrieve_span, t_all, timings)
            if not results:
                return self._finish({"generated_text": NO_RESULTS}, notes)
            with self._inflight_lock:
                # this request holds one generate claim; more means a burst,
                # which keeps the batched path
                solo = self._inflight_generate <= 1
            if sampling is None and solo and self._prefix_enabled():
                # the cached head and chunk KV is spliced and only the tail
                # prefills; the batch-1 path bypasses the scheduler, so the
                # generate claim is released (and taken back on fallback)
                self._release(generate=True)
                in_generate = False
                resp = self._answer_prefixed(user_prompt, results, timings, t_all, notes, tenant)
                if resp is not None:
                    return self._finish(resp, notes)
                with self._inflight_lock:
                    self._inflight_generate += 1
                in_generate = True
            t_as = time.monotonic()
            with tracing.span("assemble"):
                pw = self._piecewise_prompt(user_prompt, results) if self.engine.engine_config.rag_fused else None
                context, prompt_ids = pw if pw is not None else self._budgeted_prompt(user_prompt, results)
            timings["_assemble_s"] = time.monotonic() - t_as
            self._deadline_check(deadline, "assemble")
            t0 = time.monotonic()
            gen_info: Dict = {}
            served_engine = self.engine  # whose sampling the audit judges by
            with tracing.span("generate"):
                if self.scheduler is not None and len(prompt_ids) <= self._scheduler_prompt_cap():
                    served_engine = getattr(self.scheduler, "engine", None) or self.engine
                    extra = {"sampling": sampling} if isinstance(self.scheduler, ContinuousScheduler) else {}
                    try:
                        out_ids = self.scheduler.submit(prompt_ids, deadline=deadline, info=gen_info,
                                                        tenant=tenant, **extra)
                    except DeadlineExceeded as e:
                        # the worker counted its own stages (queue, decode)
                        if e.stage == "generate":
                            self._m_deadline.labels(stage="generate").inc()
                        raise
                    except TimeoutError:
                        if deadline is None or not deadline.expired():
                            raise
                        self._m_deadline.labels(stage="generate").inc()
                        raise DeadlineExceeded("generate", deadline.budget_ms) from None
                else:
                    # no scheduler, or past the continuous scheduler's largest
                    # bucket: the one-shot engine (chunked prefill) serves it whole
                    self._release(generate=True)
                    in_generate = False
                    out_ids = self.engine.generate([prompt_ids], info=gen_info)[0]
            if in_generate:
                self._release(generate=True)
                in_generate = False
            t_de = time.monotonic()
            with tracing.span("detokenize"):
                completion = self.llm_tokenizer.decode(out_ids)
            timings["_detokenize_s"] = time.monotonic() - t_de
            timings["generate_ms"] = (time.monotonic() - t0) * 1e3
            if "kv_blocks_allocated" in gen_info:
                # paged: the row's block footprint, beside the pool gauges
                timings["kv_blocks_allocated"] = float(gen_info["kv_blocks_allocated"])
            self._fold_goodput(timings, gen_info)
            timings["total_ms"] = (time.monotonic() - t_all) * 1e3
        finally:
            # error paths and the no-results return release their claims too
            self._release(retrieve=in_retrieve, generate=in_generate)
        self.metrics.observe("query_seconds", timings["total_ms"] / 1e3)
        self.metrics.inc("query_decode_tokens", len(out_ids))
        self._observe_request(timings)
        if tenant is not None:
            self._tenant_complete(tenant, gen_info, len(out_ids))
        # the shadow audit (sampled): the delivered stream against the exact
        # path over the token list that served it
        self._shadow_observe(served_engine, out_ids, gen_info, prompt_ids=prompt_ids, tenant=tenant,
                             sampling=sampling)
        resp = {
            "generated_text": extract_answer(completion),
            "context": context,
            "timings": self._round_timings(timings),
        }
        if "request_id" in gen_info:
            # continuous serving: the id keying this request's flight events
            resp["request_id"] = int(gen_info["request_id"])
        return self._finish(resp, notes)

    def _prefix_enabled(self) -> bool:
        return self.engine.prefix_cache is not None

    def _answer_prefixed(self, user_prompt: str, results, timings, t_all, notes: List[str],
                         tenant: Optional[str] = None):
        """The prefix-cache tail of ``answer`` (JAX ``_answer_prefixed``):
        resolve the segments against the cache (misses build and cache as
        they go), splice the prefix into a fresh cache and prefill only the
        per-query tail. None when the prompt cannot take this path (no
        context room, a prefix past the buffer, a tail past the suffix
        ladder); a resolve failure is also a degraded response."""
        cache = self.engine.prefix_cache
        t_as = time.monotonic()
        with tracing.span("assemble"):
            ps = self._prompt_segments(user_prompt, results)
        timings["_assemble_s"] = time.monotonic() - t_as
        if ps is None:
            return None
        context, segments, b_ids = ps
        if not b_ids:
            return None
        t_r = time.monotonic()
        with tracing.span("prefix_resolve"):
            try:
                cp = cache.prefix_for(segments)
            except Exception:  # noqa: BLE001 — cache trouble must not fail the request
                logger.exception("prefix-cache resolve failed; host fallback")
                self._degrade(notes, "prefix_cache")
                return None
        if cp is None:
            return None
        # a hit is a lookup, a miss the segment build: outside generate_ms
        timings["prefix_resolve_ms"] = (time.monotonic() - t_r) * 1e3
        t0 = time.monotonic()
        gen_info: Dict = {}
        with tracing.span("generate"):
            try:
                out_ids = self.engine.generate_prefixed(b_ids, cp, info=gen_info)
            except ValueError:
                return None  # tail past the suffix ladder: the cold path serves
        t_de = time.monotonic()
        with tracing.span("detokenize"):
            completion = self.llm_tokenizer.decode(out_ids)
        timings["_detokenize_s"] = time.monotonic() - t_de
        timings["generate_ms"] = (time.monotonic() - t0) * 1e3
        timings["prefix_reuse_frac"] = cp.reused_tokens / max(cp.length + len(b_ids), 1)
        timings["prefill_tokens_skipped"] = float(cp.reused_tokens)
        # of the resolved tokens and the tail, the share whose prefill was
        # skipped (chunk reuse's boundary windows count as computed)
        timings["prefill_tokens_skipped_frac"] = cp.reused_tokens / max(
            cp.reused_tokens + cp.computed_tokens + len(b_ids), 1
        )
        self._fold_goodput(timings, gen_info)
        timings["total_ms"] = (time.monotonic() - t_all) * 1e3
        self.metrics.observe("query_seconds", timings["total_ms"] / 1e3)
        self.metrics.inc("query_decode_tokens", len(out_ids))
        self.metrics.inc("query_prefix_cached", 1)
        self._observe_request(timings)
        if tenant is not None:
            self._tenant_complete(tenant, gen_info, len(out_ids))
        # the shadow audit: the prompt as served is the segment chain and the
        # tail; the resolve's CachedPrefix carries the fingerprint
        self._shadow_observe(self.engine, out_ids, gen_info,
                             prompt_ids=[t for _, seg in segments for t in seg] + list(b_ids), cp=cp, tenant=tenant)
        return {
            "generated_text": extract_answer(completion),
            "context": context,
            "timings": self._round_timings(timings),
        }

    def _answer_fused(self, user_prompt: str, fused_r, timings, t_all, notes: List[str],
                      tenant: Optional[str] = None):
        """Device-side prompt assembly + generate from the unfetched
        retrieve output. None when head + tail leave fewer than 16 tokens of
        room, the tail overflows the fused bucket, or the chunk-token
        sidecar is unavailable (the host path serves; a broken sidecar is
        counted as a degraded response)."""
        if self._prefix_enabled():
            return None  # the prefixed path serves (answer() takes it next)
        _, packed_dev, k_eff, tokenize_ms = fused_r
        t_b = time.monotonic()
        a_ids, b_ids = self._a_ids(), self._b_ids(user_prompt)
        S = max(self.engine.engine_config.prompt_buckets)
        if len(a_ids) + len(b_ids) + 16 > S or len(b_ids) > self.engine.RAG_TAIL_BUCKET:
            return None
        try:
            # non-blocking: a sidecar build in progress falls back, not stalls
            snap = self.store.token_snapshot(blocking=False)
        except Exception:  # noqa: BLE001 — a sidecar failure must not fail the request
            logger.exception("chunk-token sidecar unavailable; host fallback")
            self._degrade(notes, "sidecar")
            return None
        if snap is None:
            return None
        toks_dev, lens_dev = snap
        timings["tokenize_ms"] = tokenize_ms + (time.monotonic() - t_b) * 1e3
        n_ctx = min(self.config.retrieval.context_top_n, k_eff)
        t0 = time.monotonic()
        gen_info: Dict = {}
        with tracing.span("generate"):
            out_ids = self.engine.generate_rag(a_ids, b_ids, packed_dev, toks_dev, lens_dev, n_chunks=n_ctx,
                                               info=gen_info)
        t_de = time.monotonic()
        with tracing.span("detokenize"):
            completion = self.llm_tokenizer.decode(out_ids)
        timings["_detokenize_s"] = time.monotonic() - t_de
        timings["generate_ms"] = (time.monotonic() - t0) * 1e3
        # the ids for the response's context text: generation has synced
        # the stream many times already, so this read adds no wait
        packed = packed_dev.cpu().numpy()
        results = self.store.results_at(packed[0, k_eff:].astype(np.int64), packed[0, :k_eff])
        n_kept, used, _ = self._kept_chunks(
            self.store.token_lengths(packed[0, k_eff : k_eff + n_ctx].astype(np.int64)),
            S - len(a_ids) - len(b_ids),
        )
        # the chunk share of the device-assembled prompt, known only now
        self.engine.record_prefill(used)
        self._fold_goodput(timings, gen_info)
        timings["total_ms"] = (time.monotonic() - t_all) * 1e3
        self.metrics.observe("query_seconds", timings["total_ms"] / 1e3)
        self.metrics.inc("query_decode_tokens", len(out_ids))
        self.metrics.inc("query_single_fetch", 1)
        self._observe_request(timings)
        if tenant is not None:
            self._tenant_complete(tenant, gen_info, len(out_ids))
        # the shadow audit: the prompt was assembled on the device, so its ids
        # come from the host mirror, and only once the sampler selects the
        # request (prompt_fn)
        self._shadow_observe(
            self.engine, out_ids, gen_info,
            prompt_fn=lambda: (self._piecewise_prompt(user_prompt, results) or (None, None))[1], tenant=tenant,
        )
        return {
            "generated_text": extract_answer(completion),
            "context": assemble_context(results, n_kept),
            "timings": self._round_timings(timings),
        }


# ---------------------------------------------------------------------------
# WSGI
# ---------------------------------------------------------------------------

_REASONS = {200: "OK", 202: "ACCEPTED", 400: "BAD REQUEST", 403: "FORBIDDEN", 404: "NOT FOUND",
            405: "METHOD NOT ALLOWED", 409: "CONFLICT", 429: "TOO MANY REQUESTS", 500: "INTERNAL SERVER ERROR",
            503: "SERVICE UNAVAILABLE", 504: "GATEWAY TIMEOUT"}
PROMETHEUS_TEXT = "text/plain; version=0.0.4; charset=utf-8"
TIMELINE_PREFIX = "/debug/timeline/"


def _parse_multipart(body: bytes, content_type: str) -> Dict[str, tuple]:
    """``multipart/form-data`` → ``{field: (filename or None, bytes)}``."""
    boundary = None
    for param in content_type.split(";")[1:]:
        key, _, val = param.strip().partition("=")
        if key.lower() == "boundary":
            boundary = val.strip('"')
    if not boundary:
        return {}
    fields: Dict[str, tuple] = {}
    for part in body.split(b"--" + boundary.encode())[1:]:
        if part.startswith(b"--"):
            break
        head, _, data = part.partition(b"\r\n\r\n")
        if data.endswith(b"\r\n"):
            data = data[:-2]
        name = filename = None
        for line in head.decode("utf-8", "replace").split("\r\n"):
            if line.lower().startswith("content-disposition:"):
                for item in line.split(";")[1:]:
                    key, _, val = item.strip().partition("=")
                    if key == "name":
                        name = val.strip('"')
                    elif key == "filename":
                        filename = val.strip('"')
        if name is not None:
            fields[name] = (filename, data)
    return fields


@dataclasses.dataclass
class Request:
    """What a route handler sees of one request: the path, the body, its
    content type, the headers (lower-case names) and the query arguments."""

    method: str
    path: str = "/"
    body: bytes = b""
    content_type: str = ""
    headers: Dict[str, str] = dataclasses.field(default_factory=dict)
    args: Dict[str, str] = dataclasses.field(default_factory=dict)

    def json(self) -> dict:
        """The body as a JSON object, or ``{}`` (Flask's ``get_json(force=True,
        silent=True) or {}``, kept to objects)."""
        try:
            data = json.loads(self.body or b"{}")
        except ValueError:
            return {}
        return data if isinstance(data, dict) else {}

    @classmethod
    def from_environ(cls, environ) -> "Request":
        length = int(environ.get("CONTENT_LENGTH") or 0)
        headers = {k[5:].replace("_", "-").lower(): v for k, v in environ.items() if k.startswith("HTTP_")}
        args = {k: v[0] for k, v in parse_qs(environ.get("QUERY_STRING", ""), keep_blank_values=True).items()}
        return cls(
            method=environ.get("REQUEST_METHOD", "GET"), path=environ.get("PATH_INFO", "/"),
            body=environ["wsgi.input"].read(length) if length else b"",
            content_type=environ.get("CONTENT_TYPE", ""),
            headers=headers, args=args,
        )


class Response:
    def __init__(self, status: int, body: bytes, headers: Optional[Dict[str, str]] = None):
        self.status_code = status
        self.data = body
        self.headers = dict(headers or {})

    @property
    def content_type(self) -> str:
        return self.headers.get("Content-Type", "")

    def get_data(self, as_text: bool = False):
        return self.data.decode() if as_text else self.data

    def get_json(self):
        return json.loads(self.data)


class TestClient:
    """In-process client: builds a WSGI environ, calls the app."""

    __test__ = False  # not a pytest test class

    def __init__(self, app):
        self.app = app

    def open(self, method: str, path: str, body: bytes = b"", content_type: str = "",
             headers: Optional[Dict[str, str]] = None) -> Response:
        """``path`` may carry a query string; ``headers`` are request headers."""
        path, _, query = path.partition("?")
        environ = {
            "REQUEST_METHOD": method, "PATH_INFO": path, "QUERY_STRING": query,
            "CONTENT_TYPE": content_type, "CONTENT_LENGTH": str(len(body)),
            "wsgi.input": io.BytesIO(body), "SERVER_NAME": "localhost",
            "SERVER_PORT": "80", "wsgi.url_scheme": "http",
        }
        for name, value in (headers or {}).items():
            environ["HTTP_" + name.upper().replace("-", "_")] = value
        got = []
        chunks = self.app(environ, lambda s, hdrs: got.append((s, hdrs)))
        status, hdrs = got[0]
        return Response(int(status.split()[0]), b"".join(chunks), dict(hdrs))

    def get(self, path: str, headers: Optional[Dict[str, str]] = None) -> Response:
        return self.open("GET", path, headers=headers)

    def post(self, path: str, json_body=None, files: Optional[Dict[str, tuple]] = None,
             headers: Optional[Dict[str, str]] = None) -> Response:
        """``json_body`` as a JSON request, or ``files={"file": (name, bytes)}``
        as ``multipart/form-data``."""
        if files is None:
            return self.open("POST", path, json.dumps(json_body or {}).encode(), "application/json", headers)
        boundary = "----port-test-boundary"
        parts = []
        for field, (fname, data) in files.items():
            parts.append(
                f'--{boundary}\r\nContent-Disposition: form-data; name="{field}"; '
                f'filename="{fname}"\r\nContent-Type: application/octet-stream\r\n\r\n'.encode()
                + data + b"\r\n"
            )
        body = b"".join(parts) + f"--{boundary}--\r\n".encode()
        return self.open("POST", path, body, f"multipart/form-data; boundary={boundary}", headers)


class WsgiApp:
    """The routes over WSGI. A handler takes a :class:`Request` and returns
    ``(status, payload)`` or ``(status, payload, extra_headers)``; a dict
    payload is sent as JSON, a str as text of the ``Content-Type`` header it
    names."""

    ROUTES = {
        "/upload_pdf": (("POST",), "upload_pdf"),
        "/generate": (("POST",), "generate"),
        "/query": (("POST",), "generate"),
        "/index_info": (("GET",), "index_info"),
        "/healthz": (("GET",), "healthz"),
        "/drain": (("POST",), "drain"),
        "/metrics": (("GET",), "metrics"),
        "/profile": (("POST",), "profile"),
        "/slo": (("GET",), "slo"),
        "/debug/traces": (("GET",), "debug_traces"),
        "/debug/incidents": (("GET",), "debug_incidents"),
        "/debug/goodput": (("GET",), "debug_goodput"),
        "/debug/quality": (("GET",), "debug_quality"),
        "/debug/tenants": (("GET",), "debug_tenants"),
        "/debug/faults": (("GET", "POST"), "debug_faults"),
    }

    def __init__(self, service: RagService):
        self.service = service
        # one profile capture at a time, either mode: its end time (epoch
        # seconds; inf for a blocking capture) while one runs
        self._profile_lock = threading.Lock()
        self._profile_until: Optional[float] = None

    def _route(self, path: str):
        """``(methods, endpoint, kwargs)`` for ``path``, or None: the exact
        paths, and ``/debug/timeline/<rid>`` with a decimal ``rid``."""
        route = self.ROUTES.get(path)
        if route is not None:
            return route + ({},)
        rid = path[len(TIMELINE_PREFIX):]
        if path.startswith(TIMELINE_PREFIX) and rid and all("0" <= c <= "9" for c in rid):
            return ("GET",), "debug_timeline", {"rid": int(rid)}
        return None

    def __call__(self, environ, start_response):
        path, method = environ.get("PATH_INFO", "/"), environ.get("REQUEST_METHOD", "GET")
        route = self._route(path)
        extra: Dict[str, str] = {}
        if route is None:
            status, payload = 404, {"error": "not found"}
        elif method not in route[0]:
            status, payload = 405, {"error": "method not allowed"}
        else:
            out = getattr(self, f"ep_{route[1]}")(Request.from_environ(environ), **route[2])
            status, payload = out[:2]
            if len(out) > 2:
                extra = dict(out[2])
        if isinstance(payload, str):
            data = payload.encode()
            ctype = extra.pop("Content-Type", "text/plain")
        else:
            data = json.dumps(payload).encode()
            ctype = "application/json"
        start_response(
            f"{status} {_REASONS.get(status, '')}",
            [("Content-Type", ctype), ("Content-Length", str(len(data))), *extra.items()],
        )
        return [data]

    def _debug_enabled(self) -> bool:
        """One armed state for every read-only ``/debug`` route: 403 unless
        the process started with ``TPU_RAG_FAULTS`` set or ``TPU_RAG_DEBUG=1``
        (``/debug/faults`` keeps its stricter gate)."""
        return faults.endpoint_enabled() or self.service.config.flight.debug_endpoints

    @staticmethod
    def _debug_forbidden():
        return 403, {"error": "debug endpoints disabled (set TPU_RAG_FAULTS or TPU_RAG_DEBUG)"}

    def ep_upload_pdf(self, request: Request):
        ct = request.content_type
        files = _parse_multipart(request.body, ct) if ct.startswith("multipart/") else {}
        if "file" not in files:
            return 400, {"error": "No file part"}
        filename, data = files["file"]
        if not filename:
            return 400, {"error": "No selected file"}
        if not filename.endswith(".pdf"):
            return 400, {"error": "Invalid file format"}
        try:
            n = self.service.ingest_pdf_bytes(data, filename)
        except Exception as e:  # noqa: BLE001 — any failure → JSON error
            logger.exception("upload_pdf failed")
            return 500, {"error": str(e)}
        return 200, {"message": f"PDF processed and indexed successfully. {n} chunks created."}

    def _request_deadline(self, data: dict, headers: Dict[str, str]):
        """The request's deadline: the body's ``deadline_ms``, then the
        ``x-request-deadline-ms`` header, then the config's default.
        ``(Deadline, None)``, or ``(None, message)`` for a malformed value."""
        raw = data.get("deadline_ms")
        if raw is None:
            raw = headers.get("x-request-deadline-ms")
        if raw is None:
            ms = float(self.service.config.resilience.deadline_ms)
        else:
            try:
                ms = float(raw)
            except (TypeError, ValueError):
                return None, f"deadline_ms={raw!r} is not a number"
            # inf overflows every wait downstream, and nan never compares
            if not math.isfinite(ms) or ms <= 0:
                return None, f"deadline_ms={ms:g}: expected a finite value > 0"
        return Deadline(ms), None

    def ep_generate(self, request: Request):
        """The JAX ``ep_generate``: the trace (adopting a valid
        ``traceparent``; a malformed one is no header), deadline, tenant,
        the admission gate, then ``answer``. ``{"trace": true}`` returns the
        span tree inline, ``{"timeline": true}`` the request's flight
        timeline on continuous serving. Every response carries
        ``x-trace-id`` and ``traceparent``. With lookahead on, the
        retrieval launches before the gate (``session_id`` keys the
        session), and a shed or a queue-stage 504 abandons it. A
        ``sampling`` field is not read
        (per-request sampling is the Python API,
        ``RagService.answer(sampling=)``)."""
        svc = self.service
        ctx = obs_logging.parse_traceparent(request.headers.get("traceparent"))
        t0 = time.monotonic()
        status = 200
        headers: Dict[str, str] = {}
        tr = tracing.start_trace(trace_id=ctx.trace_id if ctx else None,
                                 parent_span_id=ctx.span_id if ctx else None)
        trace_id, span_id = tr.trace_id, tr.span_id
        la = svc.lookahead
        launched_fut = None
        tenant = None
        try:
            data = request.json()
            prompt = data.get("prompt", "")
            session_id = data.get("session_id")
            if session_id is not None:
                session_id = str(session_id)
            if svc.tenants_enabled:
                # the body's tenant_id, then x-tenant-id, then "anon", interned
                # here, so everything downstream sees a tracked name or __other__
                raw_tenant = data.get("tenant_id") or request.headers.get("x-tenant-id") or DEFAULT_TENANT
                tenant = svc.tenant_tracker.intern(str(raw_tenant))
                tr.attrs["tenant"] = tenant
            logger.debug("User query: %s", prompt)
            tr.attrs["prompt"] = prompt[:80]
            deadline, dl_err = self._request_deadline(data, request.headers)
            if la is not None and prompt and dl_err is None:
                # launch the retrieval before the admission gate can queue
                # this request; keep the future itself, so a shed lets go of
                # this one and never of a newer one at the same text
                launched_fut, _ = la.launch_tracked(prompt, trigger="admission", session_id=session_id)
            if dl_err is not None:
                status, payload = 400, {"error": dl_err}
            else:
                with svc.admission.admit(deadline=deadline, tenant=tenant):
                    payload = svc.answer(prompt, deadline=deadline, tenant=tenant, session_id=session_id)
                # the access line while the trace is current (the JSON
                # formatter stamps trace_id/span_id from the contextvar)
                access_logger.info("request served", extra={
                    "route": request.path, "status": 200,
                    "duration_ms": round((time.monotonic() - t0) * 1e3, 2),
                })
                tree = tracing.finish_trace(tr, svc.traces)
                tr = None
                if data.get("trace"):
                    payload = dict(payload, trace=tree)
                if data.get("timeline") and payload.get("request_id") is not None:
                    payload = dict(payload, timeline=svc.flight.timeline(payload["request_id"]))
        except AdmissionRejected as e:
            if la is not None:
                la.abandon(launched_fut)  # the last waiter to let go releases it
            # 429: retry this pod later; 503: the breaker or a drain, go elsewhere
            status, payload = e.status, {
                "error": "server overloaded" if e.status == 429 else "server draining",
                "reason": e.reason,
                "retry_after_s": round(e.retry_after_s, 3),
            }
            headers["Retry-After"] = str(max(1, int(e.retry_after_s + 0.5)))
        except DeadlineExceeded as e:
            if la is not None:
                # a queue-stage expiry never claimed its future (abandon is a
                # no-op on a claimed one)
                la.abandon(launched_fut)
            status, payload = 504, {"error": str(e), "stage": e.stage}
            # the journal still holds what spent the request's budget
            svc.record_incident("deadline_exceeded")
        except Exception as e:  # noqa: BLE001 — any failure → JSON error
            status = 500
            logger.exception("generate failed")
            payload = {"error": str(e)}
        finally:
            if tr is not None:  # a non-200 answer keeps its partial trace
                tr.attrs["error"] = True
                tr.attrs["status"] = status
                access_logger.info("request failed", extra={
                    "route": request.path, "status": status,
                    "duration_ms": round((time.monotonic() - t0) * 1e3, 2),
                })
                tracing.finish_trace(tr, svc.traces)
        headers["x-trace-id"] = trace_id
        headers["traceparent"] = obs_logging.format_traceparent(trace_id, span_id)
        svc.observe_http(request.path, status, tenant=tenant, duration_s=time.monotonic() - t0)
        return status, payload, headers

    def ep_index_info(self, request: Request):
        return 200, self.service.store.info()

    def ep_healthz(self, request: Request):
        """Readiness (503 while warming, while the breaker is open, or while
        draining), or with ``?live=1`` liveness: 200 whenever the process
        answers, so the pod is not restarted mid-drain or mid-reset. The
        fleet fields follow the JAX body: uptime, the port's version, the
        engine mode and the device platform and count."""
        svc = self.service
        dev = svc.engine.device
        breaker_open = svc.breaker.open
        lifecycle_draining = svc.lifecycle.draining
        draining = (breaker_open and svc.ready) or lifecycle_draining
        peers = svc.peers_ready() if svc.peers_ready is not None else True
        ready = svc.ready and not breaker_open and not lifecycle_draining and peers
        live = bool(request.args.get("live"))
        payload = {
            "status": ("alive" if live else "ok") if (ready or live) else ("draining" if draining else "warming"),
            "uptime_s": round(time.monotonic() - svc.started_at, 1),
            "version": __version__,
            "engine_mode": engine_mode(svc.scheduler),
            "device_platform": dev.type,
            "device_count": torch.cuda.device_count() if dev.type == "cuda" else 1,
            "ready": ready,
            "breaker_open": breaker_open,
            "breaker_recent_resets": svc.breaker.recent_resets(),
            "draining": lifecycle_draining,
        }
        mesh = getattr(svc.engine, "mesh", None)
        if mesh is not None and mesh.world > 1:
            payload["mesh"] = dict(mesh.shape)
            payload["followers_ready"] = peers
        return (200 if (ready or live) else 503), payload

    def ep_metrics(self, request: Request):
        """One scrape of the service's registry: Prometheus text exposition
        by default, the flat JSON snapshot under ``Accept:
        application/json`` (the same values)."""
        reg = self.service.metrics
        if "application/json" in request.headers.get("accept", ""):
            return 200, reg.snapshot()
        return 200, reg.render_prometheus(), {"Content-Type": PROMETHEUS_TEXT}

    def ep_debug_traces(self, request: Request):
        """The newest request span trees from the ring (``?limit=N``)."""
        if not self._debug_enabled():
            return self._debug_forbidden()
        try:
            limit = int(request.args["limit"])
        except (KeyError, ValueError):
            limit = None
        return 200, {"traces": self.service.traces.list(limit)}

    def ep_slo(self, request: Request):
        """Compliance and burn per SLO (``obs/slo.py``), from the families
        ``/metrics`` serves; the tenant section covers the tracker's current
        top-K. ``?force=1`` skips the evaluation cache."""
        svc = self.service
        try:
            svc.slo.set_tenants(svc.tenant_tracker.tracked())
            return 200, svc.slo.evaluate(force=bool(request.args.get("force")))
        except Exception as e:  # noqa: BLE001
            logger.exception("slo evaluation failed")
            return 500, {"error": str(e)}

    def ep_debug_incidents(self, request: Request):
        """The incident spool: the bundles (``{id, trigger, ts, path}``), or
        with ``?id=`` one bundle's whole JSON (404 for an unknown id)."""
        if not self._debug_enabled():
            return self._debug_forbidden()
        spool = self.service.incidents
        bid = request.args.get("id")
        if bid:
            bundle = spool.load(bid)
            if bundle is None:
                return 404, {"error": f"no incident bundle {bid!r}"}
            return 200, bundle
        return 200, {"incidents": spool.list()}

    def ep_debug_goodput(self, request: Request):
        """The goodput and cost report merged over the serving engines'
        ledgers (``obs/goodput.py``)."""
        if not self._debug_enabled():
            return self._debug_forbidden()
        try:
            return 200, self.service.goodput_report()
        except Exception as e:  # noqa: BLE001
            logger.exception("goodput report failed")
            return 500, {"error": str(e)}

    def ep_debug_quality(self, request: Request):
        """The shadow auditor's quality report (``obs/shadow.py``): audit
        outcomes, the divergence rate, the logit-error and first-divergence
        distributions and the attribution per approximation."""
        if not self._debug_enabled():
            return self._debug_forbidden()
        try:
            return 200, self.service.quality_report()
        except Exception as e:  # noqa: BLE001
            logger.exception("quality report failed")
            return 500, {"error": str(e)}

    def ep_debug_tenants(self, request: Request):
        """The per-tenant report (``obs/tenants.py``) with the tracker table,
        the ledger rollups and the per-tenant SLO burn."""
        if not self._debug_enabled():
            return self._debug_forbidden()
        try:
            return 200, self.service.tenant_report()
        except Exception as e:  # noqa: BLE001
            logger.exception("tenant report failed")
            return 500, {"error": str(e)}

    def ep_debug_timeline(self, request: Request, rid: int):
        """One request's flight-journal lifecycle, keyed by the ``request_id``
        a continuous ``/generate`` response carries."""
        if not self._debug_enabled():
            return self._debug_forbidden()
        tl = self.service.flight.timeline(rid)
        if not tl["events"]:
            return 404, {"error": f"no journaled events for request {rid} "
                                  "(completed past the ring, or never admitted)"}
        return 200, tl

    def ep_drain(self, request: Request):
        """Begin the graceful drain (the deployment's preStop hook): 202 when
        this call started it, 200 when one was already running."""
        lc = self.service.lifecycle
        started = lc.begin_drain("http")
        return (202 if started else 200), {
            "state": lc.state, "started": started, "active": self.service.admission.active,
            "deadline_s": lc.deadline_s,
        }

    def ep_debug_faults(self, request: Request):
        """Fault arming, only when the process started with ``TPU_RAG_FAULTS``
        set: GET the armed state, POST ``{"site": s, "times": n}`` to arm one
        site, POST ``{"clear": true}`` to disarm everything."""
        if not faults.endpoint_enabled():
            return 403, {"error": "fault injection disabled (set TPU_RAG_FAULTS)"}
        try:
            if request.method == "POST":
                data = request.json()
                if data.get("clear"):
                    faults.clear()
                elif "site" in data:
                    faults.arm(str(data["site"]), int(data.get("times", 1)))
                else:
                    return 400, {"error": "expected {'site': ..., 'times': N} or {'clear': true}"}
            return 200, {"enabled": True, "armed": faults.armed(), "sites": list(faults.SITES)}
        except (TypeError, ValueError) as e:  # unknown site, bad count
            return 400, {"error": str(e)}

    def ep_profile(self, request: Request):
        """Capture a ``torch.profiler`` trace: the CUDA activity of every
        thread when the service runs on the card (kernels, runtime calls),
        and the CPU ops and ``record_function`` ranges of the capturing
        thread. Two modes, one capture at a time (409 with ``until`` while
        one runs):

        - ``{"seconds": N, "dir": str?}`` returns at once; a capture thread
          owns the profiler (it is started and stopped on one thread) and
          writes the trace after ``N`` seconds of live traffic,
          ``0 < N <= 300`` or 400;
        - ``{"prompt": str?, "dir": str?}`` traces one ``service.answer``
          on the handler's thread (on the fused path that thread runs the
          spans and the decode loop; the retrieve's kernels run on the
          coalescer's) and returns when the trace is written.

        The trace is a Chrome-trace JSON file under ``dir`` (default: the
        system temp directory's ``tpu_rag_trace``), named in the response;
        open it in ``chrome://tracing`` or Perfetto. A profiler that fails
        to start answers 500."""
        try:
            data = request.json()
            trace_dir = str(data.get("dir") or os.path.join(tempfile.gettempdir(), "tpu_rag_trace"))
            if "seconds" in data:
                seconds = float(data["seconds"])
                if not 0 < seconds <= 300:
                    return 400, {"error": "seconds must be in (0, 300]"}
                with self._profile_lock:
                    if self._profile_until is not None:
                        return self._profile_busy()
                    self._profile_until = time.time() + seconds
                try:
                    path = self._start_window_capture(trace_dir, seconds)
                except BaseException:
                    with self._profile_lock:
                        self._profile_until = None
                    raise
                return 200, {
                    "trace_dir": trace_dir, "trace_file": path, "seconds": seconds,
                    "message": "background capture started around live traffic; the trace is "
                               "written when the window closes (chrome://tracing or Perfetto)",
                }
            with self._profile_lock:
                if self._profile_until is not None:
                    return self._profile_busy()
                self._profile_until = float("inf")  # blocking: the end is unknown
            try:
                path = _trace_path(trace_dir)
                dev = self.service.engine.device
                with _profiler(dev) as prof:
                    result = self.service.answer(str(data.get("prompt", "What is this document about?")))
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                prof.export_chrome_trace(path)
            finally:
                with self._profile_lock:
                    self._profile_until = None
            return 200, {
                "trace_dir": trace_dir, "trace_file": path, "timings": result.get("timings"),
                "message": "trace captured; open it in chrome://tracing or Perfetto",
            }
        except Exception as e:  # noqa: BLE001 — any failure → JSON error
            logger.exception("profile failed")
            return 500, {"error": str(e)}

    def _profile_busy(self):
        until = self._profile_until
        return 409, {"error": "a profile capture is already running",
                     "until": until if until != float("inf") else None}

    def _start_window_capture(self, trace_dir: str, seconds: float) -> str:
        """Start the profiler on a capture thread that stops it after
        ``seconds`` and writes the trace; returns the trace's path once the
        profiler runs, or raises what starting it raised."""
        path = _trace_path(trace_dir)
        dev = self.service.engine.device
        started = threading.Event()
        failed: List[BaseException] = []

        def capture():
            try:
                prof = _profiler(dev)
                prof.start()
            except BaseException as e:  # noqa: BLE001 — re-raised in the handler
                failed.append(e)
                started.set()
                return
            started.set()
            try:
                time.sleep(seconds)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                prof.stop()
                prof.export_chrome_trace(path)
                logger.info("profile window written to %s", path)
            except Exception:  # noqa: BLE001 — logged; the next capture may start
                logger.exception("profile window capture failed")
            finally:
                with self._profile_lock:
                    self._profile_until = None

        threading.Thread(target=capture, daemon=True, name="profile-capture").start()
        started.wait()
        if failed:
            raise failed[0]
        return path

    def test_client(self) -> TestClient:
        return TestClient(self)


def _profiler(device: torch.device):
    """A ``torch.profiler``: CPU activity (the thread that starts it) and, on
    the card, CUDA activity (every thread's kernels). Not the profiler's
    every-thread CPU option: on torch 2.11 with CUDA it leaves each thread
    that ran during the capture ~2x slower per op afterwards (an 8B decode
    forward issued in ~35 ms instead of ~18 ms), which would slow the
    serving workers for good."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return torch.profiler.profile(activities=acts)


def _trace_path(trace_dir: str) -> str:
    os.makedirs(trace_dir, exist_ok=True)
    return os.path.join(trace_dir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{time.monotonic_ns() % 10**9}.json")


def create_app(service: RagService) -> WsgiApp:
    return WsgiApp(service)


class ThreadingWSGIServer(socketserver.ThreadingMixIn, WSGIServer):
    """``wsgiref``'s server with one thread per request (it serves one at a
    time otherwise, and then nothing ever coalesces). It counts the requests
    whose response is not yet written, so a drain can wait for them."""

    daemon_threads = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._busy_lock = threading.Lock()
        self._busy = 0

    def process_request_thread(self, request, client_address):
        with self._busy_lock:
            self._busy += 1
        try:
            super().process_request_thread(request, client_address)
        finally:
            with self._busy_lock:
                self._busy -= 1

    def requests_in_flight(self) -> int:
        with self._busy_lock:
            return self._busy


class _QuietHandler(WSGIRequestHandler):
    def log_message(self, format, *args):  # noqa: A002 — the base class's name
        logger.debug("%s - %s", self.address_string(), format % args)


def make_server(service: RagService, host: str, port: int) -> ThreadingWSGIServer:
    """An HTTP server for ``service`` on ``host:port`` (port 0: any free
    port, read it from ``server.server_port``); run ``serve_forever()``."""
    return _wsgiref_make_server(host, port, create_app(service), server_class=ThreadingWSGIServer,
                                handler_class=_QuietHandler)

