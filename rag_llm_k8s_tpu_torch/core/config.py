"""Typed configuration: the ported subset of the JAX package's config tree.

Same fields and the same defaults as ``rag_llm_k8s_tpu/core/config.py``, so a
deployment reads one table for both packages. Only ``DTypePolicy`` differs:
it names torch dtypes. ``MeshConfig`` is the JAX package's mesh shape; the
port runs it as one process per rank (``core/mesh.py``).

``AppConfig.from_env`` reads the JAX package's environment surface for the
fields the port has, with the same validation messages. A key that turns on
a feature the port lacks raises and names its ``ROADMAP.md`` item
(``UNPORTED_KEYS``); any other ``TPU_RAG_*`` key the port does not read is
logged as ignored. A mesh takes every engine feature, under the JAX
package's own rules (``validate_tp_layout``, ``validate_pool_role``,
``validate_interleave``); the continuous engine runs on the ``tp`` axis
only and replicates over ``sp`` and ``dp``, as JAX's does.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class DTypePolicy:
    """bf16 storage and compute, fp32 logits; ``fp32()`` for CPU parity tests."""

    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    logits_dtype: torch.dtype = torch.float32

    @classmethod
    def fp32(cls) -> "DTypePolicy":
        return cls(
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
            logits_dtype=torch.float32,
        )


@dataclass(frozen=True)
class RopeScalingConfig:
    """Llama-3.1 NTK-by-parts RoPE scaling (HF ``rope_type="llama3"``)."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclass(frozen=True)
class MeshConfig:
    """The device mesh's shape (JAX ``MeshConfig``): ``dp`` (data parallel:
    replicated serving), ``sp`` (sequence parallel: ring attention over long
    prefills), ``tp`` (tensor parallel: sharded weights, the main axis for
    Llama-3.1-8B over eight devices). ``tp = -1`` means "all remaining
    devices". The port runs one process per rank (``core/mesh.py``), rank
    ``r`` at the mesh coordinate of ``np.arange(world).reshape(dp, sp,
    tp)``."""

    dp: int = 1
    sp: int = 1
    tp: int = -1
    axis_names: Tuple[str, str, str] = ("dp", "sp", "tp")

    def resolved(self, n_devices: int) -> Tuple[int, int, int]:
        dp, sp, tp = self.dp, self.sp, self.tp
        if tp == -1:
            known = dp * sp
            if n_devices % known != 0:
                raise ValueError(
                    f"n_devices={n_devices} not divisible by dp*sp={known}"
                )
            tp = n_devices // known
        if dp * sp * tp != n_devices:
            raise ValueError(
                f"mesh {dp}x{sp}x{tp} != n_devices={n_devices}"
            )
        return dp, sp, tp

    def world(self, n_devices: int) -> int:
        """The ranks this mesh runs on: ``dp * sp * tp``, with ``tp = -1``
        filling ``n_devices`` (``resolved``)."""
        dp, sp, tp = self.resolved(n_devices) if self.tp == -1 else (self.dp, self.sp, self.tp)
        return dp * sp * tp


@dataclass(frozen=True)
class LlamaConfig:
    """Llama-family decoder; defaults are Meta-Llama-3.1-8B-Instruct."""

    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: Optional[RopeScalingConfig] = field(default_factory=RopeScalingConfig)
    max_seq_len: int = 131072
    tie_word_embeddings: bool = False
    bos_token_id: int = 128000
    eos_token_ids: Tuple[int, ...] = (128001, 128008, 128009)

    @classmethod
    def llama_3_1_8b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "LlamaConfig":
        """Miniature config for CPU tests: same code paths, toy shapes."""
        return cls(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            rope_scaling=None,
            max_seq_len=256,
            bos_token_id=1,
            eos_token_ids=(2,),
        )


@dataclass(frozen=True)
class EncoderConfig:
    """Bidirectional embedding encoder; defaults are BAAI/bge-m3 (XLM-R large)."""

    vocab_size: int = 250002
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    max_position_embeddings: int = 8194
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    # XLM-R position ids start at pad_token_id + 1 for real tokens
    position_offset: int = 2
    embed_dim: int = 1024
    max_encode_len: int = 8192

    @classmethod
    def bge_m3(cls) -> "EncoderConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "EncoderConfig":
        return cls(
            vocab_size=vocab_size,
            hidden_size=32,
            intermediate_size=64,
            num_layers=2,
            num_heads=4,
            max_position_embeddings=128,
            embed_dim=32,
            max_encode_len=64,
        )


@dataclass(frozen=True)
class RetrievalConfig:
    """Word chunks of 1000 with overlap 200, top-5 search, top-3 into the
    prompt; squared L2 on unit vectors ranks like cosine."""

    chunk_size: int = 1000
    chunk_overlap: int = 200
    k: int = 5
    context_top_n: int = 3
    embed_dim: int = 1024


@dataclass(frozen=True)
class SamplingConfig:
    """150 new tokens, temperature 0.7, top-p 0.9, sampling on."""

    max_new_tokens: int = 150
    temperature: float = 0.7
    top_p: float = 0.9
    do_sample: bool = True
    seed: int = 0


@dataclass(frozen=True)
class PrefixCacheConfig:
    """Cross-request device-resident KV prefix cache
    (``engine/prefix_cache.py``), the JAX package's fields and defaults.

    The fixed prompt head and popular retrieved chunks keep their KV on the
    card, keyed by segment and position slot; a request's matched prefix is
    spliced into its fresh cache and prefill starts at the first non-shared
    token (the per-query tail).
    """

    # master switch (env TPU_RAG_PREFIX_CACHE); off by default
    enabled: bool = False
    # device bytes of segment blocks AND assembled full-prefix buffers, MiB
    # (env TPU_RAG_PREFIX_HBM_MB). 128 KiB a token at Llama-3.1-8B width in
    # bf16, so one 4096-token assembled buffer fills the default budget;
    # assembled buffers evict first, then least-recently-used blocks, never
    # the pinned head
    hbm_budget_mb: int = 512
    # width (tokens) of the splice buffer every prefixed request carries,
    # and the largest prefix the cache represents
    max_prefix_tokens: int = 4096
    # segment blocks pad to these lengths (one builder shape per bucket)
    segment_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024, 1536, 2048)
    # the un-cached prompt tail pads to these lengths
    suffix_buckets: Tuple[int, ...] = (128, 512, 2048)
    # "exact": a block is reused only under the same preceding segment chain
    # (logits equal the cold path's); "slot": offset match alone; "chunk":
    # one canonical block per chunk, spliced at any offset by a RoPE
    # re-rotation of K plus a boundary re-prefill of its first
    # boundary_tokens tokens (env TPU_RAG_PREFIX_REUSE)
    reuse: str = "exact"
    # chunk reuse's boundary-correction window, tokens (env
    # TPU_RAG_PREFIX_BOUNDARY_TOKENS)
    boundary_tokens: int = 16
    # decayed hit score a chunk needs before it is spliced at a shifted
    # position (env TPU_RAG_PREFIX_CHUNK_HOT_MIN)
    chunk_hot_min: float = 2.0
    # per-chunk canonical pool registrations the paged engine keeps (env
    # TPU_RAG_PREFIX_CHUNK_POOL_REGS)
    chunk_pool_regs: int = 32
    # assembled prefix buffers memoized per (segment chain, length)
    assembled_cache_entries: int = 8


@dataclass(frozen=True)
class KVTieringConfig:
    """Hotness-aware KV tiering over the prefix cache's entries
    (``engine/tiering.py``), the JAX package's fields and defaults: a
    decayed hit score per chunk keeps it hot (native dtype), warm (int8 in
    place, no re-prefill) or cold (spilled to host memory, swapped back on
    its next use). Env ``TPU_RAG_KV_TIERING*``."""

    # master switch (env TPU_RAG_KV_TIERING)
    enabled: bool = False
    # decayed-score demotion thresholds (env TPU_RAG_KV_TIERING_WARM_BELOW /
    # TPU_RAG_KV_TIERING_COLD_BELOW); cold_below must not exceed warm_below
    warm_below: float = 0.25
    cold_below: float = 0.0625
    # hit-score half-life, seconds (env TPU_RAG_KV_TIERING_HALF_LIFE_S)
    half_life_s: float = 60.0
    # host memory for cold-spilled KV, MiB (env TPU_RAG_KV_TIERING_HOST_MB);
    # past it the oldest spills are dropped
    host_spill_mb: int = 1024
    # least seconds between resolve-path retier sweeps (env
    # TPU_RAG_KV_TIERING_INTERVAL_S)
    retier_interval_s: float = 5.0

    def validate(self) -> None:
        if self.cold_below > self.warm_below:
            raise ValueError(
                f"kv tiering: cold_below={self.cold_below} must not exceed "
                f"warm_below={self.warm_below}"
            )
        if self.half_life_s <= 0:
            raise ValueError(
                f"kv tiering: half_life_s={self.half_life_s}: expected > 0"
            )
        if self.host_spill_mb < 1:
            raise ValueError(
                f"kv tiering: host_spill_mb={self.host_spill_mb}: expected >= 1"
            )


@dataclass(frozen=True)
class GoodputConfig:
    """The goodput ledger (``obs/goodput.py``): per-window chip-time
    attribution, roofline MFU and bandwidth use, and cost per query. On by
    default: the ledger is host-side dict math per device sync window, on
    numbers the host already holds (no tensor, no launch, no sync)."""

    # master switch for the step ledger (env TPU_RAG_GOODPUT)
    enabled: bool = True
    # chip rental price, USD per chip-hour: cost_usd in /generate timings,
    # rag_cost_* metrics and /debug/goodput's cost-per-query percentiles; 0
    # keeps chip-time attribution and omits dollar figures
    # (env TPU_RAG_CHIP_HOUR_USD)
    chip_hour_usd: float = 0.0
    # roofline peaks for MFU and bandwidth use; 0 = the H100 SXM defaults in
    # obs/goodput.py (989 dense bf16 TFLOP/s, 3,350 GB/s). Pin another
    # card's data sheet for honest absolute readings; every RELATIVE read
    # holds either way (env TPU_RAG_GOODPUT_PEAK_TFLOPS /
    # TPU_RAG_GOODPUT_HBM_GBS)
    peak_tflops: float = 0.0
    hbm_gbs: float = 0.0

    def validate(self) -> None:
        if self.chip_hour_usd < 0:
            raise ValueError(
                f"goodput: chip_hour_usd={self.chip_hour_usd}: expected >= 0"
            )
        if self.peak_tflops < 0 or self.hbm_gbs < 0:
            raise ValueError(
                "goodput: peak_tflops/hbm_gbs must be >= 0 (0 = default)"
            )


@dataclass(frozen=True)
class EngineConfig:
    """Serving-engine shape limits and the main-path switches."""

    max_batch_size: int = 8
    # each prompt pads left to the next bucket
    prompt_buckets: Tuple[int, ...] = (256, 512, 1024, 2048, 4096)
    # cap on prompt bucket + generated tokens (KV-cache budget)
    max_seq_len: int = 4096 + 256
    # prompts longer than the largest bucket prefill through the cache in
    # bucket-sized chunks up to this many tokens; beyond it the engine
    # left-truncates, with a warning
    max_chunked_prompt: int = 16384
    # fuse q/k/v and gate/up projections into one matmul each at engine
    # construction (same bytes, fewer launches per decode step)
    fuse_matmuls: bool = True
    # weight storage for serving: "bf16" or "int8" (per-output-channel
    # weight-only quantization at engine construction, models/llama.py
    # quantize_llama; an already-quantized model passes through)
    weight_quant: str = "bf16"
    # KV-cache storage: "bf16" or "int8" (one fp32 scale per (token, kv
    # head) vector: 2,112 instead of 4,096 bytes per token and layer at
    # Llama-3.1-8B width); both engines, dense cache and paged arena
    kv_quant: str = "bf16"
    # batch-1 prompt-lookup speculation: "off" | "prompt_lookup" | "auto";
    # "auto" stops speculating while the acceptance EMA (tokens emitted per
    # verify forward) stays below spec_min_accept, re-probing periodically
    speculative: str = "auto"
    spec_ngram: int = 2
    spec_tokens: int = 15
    spec_min_accept: float = 1.5
    # single-fetch solo serving: the prompt is assembled on the device from
    # the fused retrieve's top-k and the store's chunk-token sidecar
    rag_fused: bool = True
    # past this many live vectors solo queries take the host path
    rag_fused_max_vectors: int = 65536
    # request scheduling: "coalesce" (concurrent requests coalesce into
    # batched one-shot generates: engine/batching.py BatchScheduler) or
    # "continuous" (requests join a running batch: engine/continuous.py)
    batching: str = "coalesce"
    # continuous engine: decode steps run per host sync (one token fetch
    # per window)
    decode_sync_steps: int = 1
    # warm every (batch, bucket) pair of the coalescing scheduler's padded
    # batch ladder at boot, not only the largest bucket's (JAX's; here a
    # warm shape is the first run of its shapes, not a compile). Env:
    # TPU_RAG_WARM_FULL_LADDER=1.
    warm_full_ladder: bool = False
    # paged KV for the continuous engine: a [L, N, K, block, hd] block-pool
    # arena with per-row block tables (engine/kv_pool.py)
    kv_paged: bool = False
    # tokens per physical block; must divide every prompt bucket and the
    # slot length, and be a multiple of 16 (32 under kv_quant="int8", the
    # JAX package's rule, kept so both packages accept the same configs)
    kv_block_size: int = 16
    # allocatable blocks (the reserved null block is added on top); 0 =
    # max_batch_size * ceil(slot length / kv_block_size)
    kv_pool_blocks: int = 0
    # interleaved admission: prompts prefill in chunks of
    # prefill_chunk_tokens inside the decode windows instead of one
    # phase-separated prefill per admission group
    interleave_prefill: bool = False
    prefill_chunk_tokens: int = 64
    # tokens per mixed window, decode lanes first; 0 = max_batch_size +
    # prefill_chunk_tokens
    window_token_budget: int = 0
    # disaggregated pool role: which half of the serving work this engine's
    # pool runs. "unified" (default) is the single-pool scheduler. "prefill"
    # runs admission only and hands each request's pool blocks to a
    # decode-role engine once its first token is sampled (the same [L, N, K,
    # bs, hd] arena layout on both sides, so the hand-off is one gather and
    # one scatter of the owned blocks: ContinuousEngine.export_request /
    # import_request). "decode" takes migrated requests and runs decode
    # windows; its own admission path stays available as the fallback when a
    # migration dies mid-flight (the scheduler re-prefills prompt + emitted
    # there). Roles other than "unified" require kv_paged=True
    # (validate_pool_role). Env: TPU_RAG_POOL_ROLE.
    pool_role: str = "unified"  # "unified" | "prefill" | "decode"
    # speculative decoding in the paged continuous engine: each window may
    # run ONE verify forward instead of decode_sync_steps plain steps. The
    # host drafts up to spec_paged_tokens tokens per row by prompt lookup
    # over the row's own history (assembled prompt + emitted: grounded
    # answers quote their context, so the context is the draft corpus; no
    # draft model), the forward feeds last token + drafts through the block
    # tables, and each row accepts the longest draft prefix equal to the
    # model's own (seed, position)-keyed targets, so greedy and seeded
    # streams equal spec-off by construction. Requires kv_paged=True
    # (checked at engine construction). The one-shot engine's
    # `speculative` knob above is separate.
    spec_paged: bool = False
    # drafted tokens per verify window (K + 1 fed tokens per row); the
    # per-row adaptive controller below shrinks K where acceptance is low
    spec_paged_tokens: int = 7
    # per-row adaptive draft length: each verify window folds the row's
    # acceptance fraction (accepted / offered) into a decayed EMA; below
    # this floor the row drafts 1 token, above it K scales with the EMA
    spec_paged_min_accept: float = 0.3
    # cross-request KV prefix cache (see PrefixCacheConfig)
    prefix_cache: PrefixCacheConfig = field(default_factory=PrefixCacheConfig)
    # hotness-aware KV tiering over the cached chunks (see KVTieringConfig;
    # needs prefix_cache.enabled to have anything to tier)
    kv_tiering: KVTieringConfig = field(default_factory=KVTieringConfig)
    # the goodput ledger both engines keep (see GoodputConfig)
    goodput: GoodputConfig = field(default_factory=GoodputConfig)

    def validate_quant(self) -> None:
        """``weight_quant`` and ``kv_quant`` name a storage the engines
        serve, checked at engine construction."""
        for name in ("weight_quant", "kv_quant"):
            if getattr(self, name) not in ("bf16", "int8"):
                raise ValueError(f"{name}={getattr(self, name)!r}: expected 'bf16' or 'int8'")

    def validate_tp_layout(self, tp: int, num_kv_heads: int) -> None:
        """Paged KV on a ``tp > 1`` mesh serves from a HEAD-sharded arena:
        each device holds ``num_kv_heads / tp`` heads of every physical
        block, so the kv-head count must tile the axis (the JAX package's
        rule and message). The continuous engine calls it at construction,
        as JAX's does."""
        if not self.kv_paged or tp <= 1:
            return
        if num_kv_heads % tp:
            raise ValueError(
                f"kv_paged on a tp={tp} mesh shards the arena's kv-head "
                f"axis: num_kv_heads={num_kv_heads} must be divisible by "
                f"tp — choose a tp that divides the head count, or serve "
                "this model dense on the mesh"
            )

    def validate_interleave(self) -> None:
        """Cross-field rules for interleaved admission (the JAX package's,
        with its messages), checked by ``AppConfig.from_env`` and at
        continuous-engine construction."""
        if not self.interleave_prefill:
            return
        if not self.kv_paged:
            raise ValueError(
                "interleave_prefill=True requires kv_paged=True — chunked "
                "prefill writes through block tables; set "
                "TPU_RAG_KV_PAGED=1 or disable TPU_RAG_INTERLEAVE_PREFILL"
            )
        if self.prefill_chunk_tokens < 1:
            raise ValueError(
                f"prefill_chunk_tokens={self.prefill_chunk_tokens}: the "
                "mixed window must carry at least one prefill token per "
                "scheduled chunk"
            )
        if self.window_token_budget and self.window_token_budget < self.max_batch_size + 1:
            raise ValueError(
                f"window_token_budget={self.window_token_budget} cannot "
                f"cover max_batch_size={self.max_batch_size} decode lanes "
                "plus one prefill token — raise the budget or set 0 for "
                "auto (max_batch_size + prefill_chunk_tokens)"
            )

    def validate_pool_role(self) -> None:
        """Cross-field rules for disaggregated pool roles (the JAX package's,
        with its messages), checked by ``AppConfig.from_env`` and at
        continuous-engine construction."""
        if self.pool_role not in ("unified", "prefill", "decode"):
            raise ValueError(
                f"pool_role={self.pool_role!r}: expected 'unified', "
                "'prefill', or 'decode' (TPU_RAG_POOL_ROLE)"
            )
        if self.pool_role != "unified" and not self.kv_paged:
            raise ValueError(
                f"pool_role={self.pool_role!r} requires kv_paged=True — "
                "the prefill→decode hand-off moves POOL BLOCKS between "
                "same-layout arenas; set TPU_RAG_KV_PAGED=1 or run "
                "TPU_RAG_POOL_ROLE=unified"
            )


SYSTEM_MESSAGE = (
    "You are a helpful assistant. Answer the user's question based ONLY on the "
    "given context.\nIf the context doesn't contain relevant information to the "
    "specific question, say 'I don't have enough information to answer that "
    "specific question.'\nDo not make up information or use general knowledge "
    "outside of the given context."
)


@dataclass(frozen=True)
class ResilienceConfig:
    """Admission control, deadlines, reset recovery and drain
    (``resilience/``), with the JAX package's defaults: concurrency ~2x the
    batch cap, a queue a few seconds deep, a 120 s default deadline."""

    # requests past the gate at once (env TPU_RAG_ADMISSION_MAX_CONCURRENCY)
    admission_max_concurrency: int = 16
    # the bounded wait line above it; request cap + queue + 1 is shed with
    # 429 + Retry-After (env TPU_RAG_ADMISSION_MAX_QUEUE)
    admission_max_queue: int = 64
    # the Retry-After of queue_full sheds, seconds
    # (env TPU_RAG_ADMISSION_RETRY_AFTER_S)
    admission_retry_after_s: float = 1.0
    # end-to-end deadline of a request that names none (body deadline_ms,
    # header x-request-deadline-ms) (env TPU_RAG_DEADLINE_MS)
    deadline_ms: int = 120_000
    # this many engine resets inside breaker_window_s turn /healthz
    # readiness off (env TPU_RAG_BREAKER_RESETS / TPU_RAG_BREAKER_WINDOW_S)
    breaker_reset_threshold: int = 3
    breaker_window_s: float = 300.0
    # resubmissions per in-flight request after an engine reset (0: the
    # first fault fails it), and the jittered backoff before they land
    # (env TPU_RAG_INFLIGHT_RETRIES / TPU_RAG_RETRY_BACKOFF_MS)
    inflight_retries: int = 1
    retry_backoff_ms: float = 50.0
    # how long in-flight work gets after SIGTERM / POST /drain; must fit the
    # pod's terminationGracePeriodSeconds (env TPU_RAG_DRAIN_DEADLINE_S)
    drain_deadline_s: float = 25.0
    # the Retry-After of 503 reason="draining" sheds
    # (env TPU_RAG_DRAIN_RETRY_AFTER_S)
    drain_retry_after_s: float = 2.0


@dataclass(frozen=True)
class FlightConfig:
    """The flight recorder (``obs/flight.py``): its ring, the incident
    spool, the durable WAL with the warm restart it feeds, and the
    read-only debug surface (the JAX package's ``FlightConfig``)."""

    # master switch for the in-process event journal (env TPU_RAG_FLIGHT)
    enabled: bool = True
    # ring capacity in events, the journal's memory bound
    # (env TPU_RAG_FLIGHT_EVENTS)
    capacity: int = 4096
    # incident-bundle spool: directory, file cap (oldest pruned), and the
    # per-trigger cooldown that keeps a reset storm from writing a bundle
    # per reset (env TPU_RAG_FLIGHT_SPOOL / TPU_RAG_FLIGHT_SPOOL_MAX /
    # TPU_RAG_FLIGHT_COOLDOWN_S)
    spool_dir: str = "/tmp/tpu_rag_incidents"
    spool_max: int = 16
    cooldown_s: float = 30.0
    # arm the READ-ONLY debug surface (/debug/traces, /debug/timeline,
    # /debug/incidents, /debug/goodput, /debug/tenants)
    # without arming fault injection: every /debug route is 403 unless the
    # process started with TPU_RAG_DEBUG=1 or TPU_RAG_FAULTS set (the faults
    # endpoint additionally requires TPU_RAG_FAULTS itself) (env TPU_RAG_DEBUG)
    debug_endpoints: bool = False
    # record prompt token ids on each arrival event, so a journal resumes
    # and replays with exact token streams; turn OFF when prompts are
    # sensitive and lengths are enough (env TPU_RAG_FLIGHT_ARRIVAL_IDS)
    arrival_ids: bool = True
    # durable flight WAL (obs/flight.py FlightWAL): tee every journal event
    # onto disk as fsynced JSON lines, so in-flight work survives SIGKILL and
    # a warm restart (server/main.py) can resume it. OFF by default: the
    # fsync per event only buys something where the directory survives the
    # pod (env TPU_RAG_FLIGHT_WAL / TPU_RAG_FLIGHT_WAL_DIR)
    wal: bool = False
    wal_dir: str = "/tmp/tpu_rag_wal"
    # WAL bounds: events per segment file before rotation, and segment files
    # kept across incarnations (oldest pruned)
    # (env TPU_RAG_FLIGHT_WAL_SEGMENT_EVENTS / TPU_RAG_FLIGHT_WAL_SEGMENTS)
    wal_segment_events: int = 256
    wal_segments: int = 64
    # warm restart: scan the previous incarnation's WAL epoch on boot and
    # resubmit its in-flight requests through the scheduler's fold path
    # (env TPU_RAG_FLIGHT_WAL_RESTORE); cap on warmth-manifest entries
    # re-staged into the prefix cache first, 0 skips rehydration
    # (env TPU_RAG_FLIGHT_WAL_RESTORE_CHUNKS)
    wal_restore: bool = True
    wal_restore_chunks: int = 8


@dataclass(frozen=True)
class RouterConfig:
    """The prefix-affinity replica router (``server/router.py``), the JAX
    package's fields, defaults and rules: prefill candidates score
    ``affinity_weight * chunk_affinity + load_weight * free_capacity``
    against each replica's bounded hot-chunk registry, with session
    stickiness."""

    # relative weight of chunk affinity in the prefill-candidate score (0
    # disables affinity) (env TPU_RAG_ROUTER_AFFINITY_WEIGHT)
    affinity_weight: float = 1.0
    # relative weight of free capacity (free rows and blocks), the
    # counterweight that keeps one hot replica from taking the whole fleet
    # (env TPU_RAG_ROUTER_LOAD_WEIGHT)
    load_weight: float = 0.5
    # per-replica hot-chunk registry bound, LRU past it
    # (env TPU_RAG_ROUTER_HOT_CHUNKS)
    hot_chunks: int = 512
    # a session re-routes to its previous replica within this window
    # (env TPU_RAG_ROUTER_SESSION_TTL_S)
    session_ttl_s: float = 600.0

    def validate(self) -> None:
        if self.affinity_weight < 0 or self.load_weight < 0:
            raise ValueError(
                f"RouterConfig weights must be >= 0 (affinity_weight="
                f"{self.affinity_weight}, load_weight={self.load_weight})"
            )
        if self.hot_chunks < 1:
            raise ValueError(
                f"RouterConfig.hot_chunks={self.hot_chunks}: expected >= 1"
            )
        if self.session_ttl_s <= 0:
            raise ValueError(
                f"RouterConfig.session_ttl_s={self.session_ttl_s}: "
                "expected > 0"
            )


@dataclass(frozen=True)
class LookaheadConfig:
    """The retrieval lookahead pipeline (``rag/lookahead.py``; JAX
    ``LookaheadConfig``): a request's retrieval launches as its body is
    parsed, before the admission gate can queue it, and the serving tail
    joins the future; resolved retrievals pre-stage their chunk KV; sessions
    speculate the next turn's retrieval while this turn decodes. Off by
    default."""

    # master switch (env TPU_RAG_LOOKAHEAD)
    enabled: bool = False
    # executor worker threads, each blocking in the retrieve coalescer
    # (env TPU_RAG_LOOKAHEAD_WORKERS)
    max_workers: int = 2
    # launched-but-unresolved retrievals; launches past it are skipped, never
    # queued (env TPU_RAG_LOOKAHEAD_INFLIGHT)
    max_inflight: int = 8
    # unconsumed futures and what they staged expire after this long
    # (env TPU_RAG_LOOKAHEAD_TTL_S)
    ttl_s: float = 30.0
    # pre-stage a resolved retrieval's chunk KV (env TPU_RAG_LOOKAHEAD_PRESTAGE)
    prestage_kv: bool = True
    # speculate a session's next turn while this one decodes
    # (env TPU_RAG_LOOKAHEAD_SESSIONS)
    session_pipelining: bool = True
    # trailing user turns that feed the speculative next-turn query
    # (env TPU_RAG_LOOKAHEAD_SESSION_TURNS)
    session_context_turns: int = 2
    # LRU cap and idle TTL of tracked sessions
    # (env TPU_RAG_LOOKAHEAD_SESSION_MAX, TPU_RAG_LOOKAHEAD_SESSION_TTL_S)
    session_max: int = 256
    session_ttl_s: float = 600.0


@dataclass(frozen=True)
class SloConfig:
    """Burn-rate SLO objectives and thresholds (``obs/slo.py``
    ``default_specs``). Parsing is safe by contract, as in the JAX
    package: these knobs are read on the scrape and ``GET /slo`` path, so a
    malformed or out-of-range env value falls back to the field's default
    instead of raising (objectives must lie strictly inside (0, 1) and
    thresholds above 0, or ``SloSpec`` would reject them at evaluation)."""

    # fraction of requests that must be non-5xx
    # (env TPU_RAG_SLO_AVAILABILITY_OBJECTIVE)
    availability_objective: float = 0.999
    # end-to-end request latency: objective fraction under request_p95_s
    # (env TPU_RAG_SLO_REQUEST_P95_OBJECTIVE / TPU_RAG_SLO_REQUEST_P95_S)
    request_p95_objective: float = 0.95
    request_p95_s: float = 2.0
    # time to first token, continuous serving
    # (env TPU_RAG_SLO_TTFT_P95_OBJECTIVE / TPU_RAG_SLO_TTFT_P95_S)
    ttft_p95_objective: float = 0.95
    ttft_p95_s: float = 1.0
    # answer quality over shadow audits (ROADMAP.md Queue 1 item 9c-ii):
    # the objective fraction of audits whose logit error stays under the
    # tolerance (env TPU_RAG_SLO_QUALITY_OBJECTIVE /
    # TPU_RAG_SLO_QUALITY_LOGIT_ERR)
    quality_objective: float = 0.99
    quality_logit_err: float = 0.15

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "SloConfig":
        env = dict(os.environ if env is None else env)

        def _f(var: str, dflt: float, lo: float, hi: float) -> float:
            raw = env.get(var)
            if raw is None:
                return dflt
            try:
                v = float(raw)
            except (TypeError, ValueError):
                return dflt
            return v if lo < v < hi else dflt

        inf = float("inf")
        return cls(
            availability_objective=_f("TPU_RAG_SLO_AVAILABILITY_OBJECTIVE", 0.999, 0.0, 1.0),
            request_p95_objective=_f("TPU_RAG_SLO_REQUEST_P95_OBJECTIVE", 0.95, 0.0, 1.0),
            request_p95_s=_f("TPU_RAG_SLO_REQUEST_P95_S", 2.0, 0.0, inf),
            ttft_p95_objective=_f("TPU_RAG_SLO_TTFT_P95_OBJECTIVE", 0.95, 0.0, 1.0),
            ttft_p95_s=_f("TPU_RAG_SLO_TTFT_P95_S", 1.0, 0.0, inf),
            quality_objective=_f("TPU_RAG_SLO_QUALITY_OBJECTIVE", 0.99, 0.0, 1.0),
            quality_logit_err=_f("TPU_RAG_SLO_QUALITY_LOGIT_ERR", 0.15, 0.0, inf),
        )


@dataclass(frozen=True)
class TenantConfig:
    """Tenant attribution (``obs/metrics.py`` ``TenantTracker``,
    ``obs/tenants.py``): the HTTP edge reads ``tenant_id`` (body field, then
    the ``x-tenant-id`` header, default ``anon``) and interns it through a
    top-K tracker before it becomes a label or an event attr, so the
    ``rag_tenant_*`` families never hold more than ``top_k`` + 1 tenant
    children. On by default."""

    # master switch (env TPU_RAG_TENANTS)
    enabled: bool = True
    # tenants tracked by name; the rest ride __other__ (env TPU_RAG_TENANT_TOP_K)
    top_k: int = 8

    def validate(self) -> None:
        if self.top_k < 1:
            raise ValueError(f"TenantConfig.top_k={self.top_k}: expected >= 1")

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "TenantConfig":
        env = dict(os.environ if env is None else env)
        out = cls()
        if (v := _flag(env, "TPU_RAG_TENANTS")) is not None:
            out = dataclasses.replace(out, enabled=v)
        if "TPU_RAG_TENANT_TOP_K" in env:
            out = dataclasses.replace(out, top_k=int(env["TPU_RAG_TENANT_TOP_K"]))
        out.validate()
        return out


@dataclass(frozen=True)
class ShadowConfig:
    """The shadow quality auditor (``obs/shadow.py``): a sampled fraction of
    completed requests re-runs on the exact path (no prefix reuse, no
    speculation, the engine's own KV dtype) through
    ``InferenceEngine.score_exact``, and the delivered stream is judged
    against its argmax chain. On by default, as in the JAX package: one
    headroom-gated chunked forward per sampled request on the one-shot
    engine, never the continuous pool."""

    # master switch (env TPU_RAG_SHADOW)
    enabled: bool = True
    # fraction of completed, audit-eligible requests re-run on the exact
    # path (env TPU_RAG_SHADOW_SAMPLE_RATE)
    sample_rate: float = 0.05
    # bounded audit queue: a sampled request arriving while this many audits
    # are pending is skipped, counted, never queued (env TPU_RAG_SHADOW_BACKLOG)
    backlog: int = 8
    # the second diverged audit inside this window spools a
    # quality_divergence incident bundle (env TPU_RAG_SHADOW_BURST_WINDOW_S)
    burst_window_s: float = 300.0

    def validate(self) -> None:
        if not 0.0 <= self.sample_rate <= 1.0:
            raise ValueError(
                f"ShadowConfig.sample_rate={self.sample_rate}: a sampling fraction must lie in [0, 1]"
            )
        if self.backlog < 1:
            raise ValueError(f"ShadowConfig.backlog={self.backlog}: expected >= 1")
        if self.burst_window_s <= 0:
            raise ValueError(f"ShadowConfig.burst_window_s={self.burst_window_s}: expected > 0")

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "ShadowConfig":
        env = dict(os.environ if env is None else env)
        out = cls()
        rep = dataclasses.replace
        if (v := _flag(env, "TPU_RAG_SHADOW")) is not None:
            out = rep(out, enabled=v)
        if "TPU_RAG_SHADOW_SAMPLE_RATE" in env:
            out = rep(out, sample_rate=float(env["TPU_RAG_SHADOW_SAMPLE_RATE"]))
        if "TPU_RAG_SHADOW_BACKLOG" in env:
            out = rep(out, backlog=int(env["TPU_RAG_SHADOW_BACKLOG"]))
        if "TPU_RAG_SHADOW_BURST_WINDOW_S" in env:
            out = rep(out, burst_window_s=float(env["TPU_RAG_SHADOW_BURST_WINDOW_S"]))
        out.validate()
        return out


@dataclass(frozen=True)
class ServerConfig:
    """HTTP surface and storage paths (the reference's rag.py:18-20, 204)."""

    host: str = "0.0.0.0"
    port: int = 5001
    model_path: str = "/models"
    index_path: str = "/models/tpu_index"
    pdf_dir: str = "/pdfs"
    embedder_path: str = "/models/bge-m3"


def parse_mesh(spec: str, mesh: Optional["MeshConfig"] = None) -> "MeshConfig":
    """A ``TPU_RAG_MESH`` spec (``"tp=8"``, ``"dp=2,tp=4"``) applied to
    ``mesh`` (default ``MeshConfig()``), as the JAX ``from_env`` parses it."""
    try:
        kv = dict(p.split("=", 1) for p in spec.split(","))
        overrides = {k: int(v) for k, v in kv.items() if k in ("dp", "sp", "tp")}
    except (ValueError, TypeError) as e:
        raise ValueError(f"TPU_RAG_MESH={spec!r} is not of the form 'dp=N,sp=N,tp=N'") from e
    return dataclasses.replace(mesh or MeshConfig(), **overrides)


# keys that turn on a feature the port does not have: the ROADMAP.md item
# that ports it (none: every key the JAX service reads is ported)
UNPORTED_KEYS: Dict[str, str] = {}

# the keys from_env reads
PORTED_KEYS = frozenset({
    "TPU_RAG_MESH", "TPU_RAG_INDEX_PATH", "TPU_RAG_PDF_DIR", "TPU_RAG_PORT", "TPU_RAG_MAX_NEW_TOKENS",
    "TPU_RAG_BATCHING", "TPU_RAG_WEIGHT_QUANT", "TPU_RAG_KV_QUANT", "TPU_RAG_KV_PAGED",
    "TPU_RAG_KV_BLOCK_SIZE", "TPU_RAG_KV_POOL_BLOCKS", "TPU_RAG_INTERLEAVE_PREFILL",
    "TPU_RAG_PREFILL_CHUNK_TOKENS", "TPU_RAG_WINDOW_TOKEN_BUDGET", "TPU_RAG_DO_SAMPLE", "TPU_RAG_WARM_FULL_LADDER",
    "TPU_RAG_SPEC_PAGED", "TPU_RAG_SPEC_PAGED_TOKENS", "TPU_RAG_SPEC_PAGED_MIN_ACCEPT",
    "TPU_RAG_SPECULATIVE", "TPU_RAG_SYNC_STEPS", "TPU_RAG_FUSED", "TPU_RAG_LOG_LEVEL",
    "TPU_RAG_ADMISSION_MAX_CONCURRENCY", "TPU_RAG_ADMISSION_MAX_QUEUE", "TPU_RAG_ADMISSION_RETRY_AFTER_S",
    "TPU_RAG_DEADLINE_MS", "TPU_RAG_BREAKER_RESETS", "TPU_RAG_BREAKER_WINDOW_S", "TPU_RAG_INFLIGHT_RETRIES",
    "TPU_RAG_RETRY_BACKOFF_MS", "TPU_RAG_DRAIN_DEADLINE_S", "TPU_RAG_DRAIN_RETRY_AFTER_S",
    "TPU_RAG_DEBUG", "TPU_RAG_FLIGHT_EVENTS", "TPU_RAG_FLIGHT", "TPU_RAG_FLIGHT_ARRIVAL_IDS",
    "TPU_RAG_FLIGHT_WAL", "TPU_RAG_FLIGHT_WAL_DIR", "TPU_RAG_FLIGHT_WAL_SEGMENT_EVENTS",
    "TPU_RAG_FLIGHT_WAL_SEGMENTS", "TPU_RAG_FLIGHT_WAL_RESTORE", "TPU_RAG_FLIGHT_WAL_RESTORE_CHUNKS",
    "TPU_RAG_POOL_ROLE", "TPU_RAG_ROUTER_AFFINITY_WEIGHT", "TPU_RAG_ROUTER_LOAD_WEIGHT",
    "TPU_RAG_ROUTER_HOT_CHUNKS", "TPU_RAG_ROUTER_SESSION_TTL_S",
    "TPU_RAG_PREFIX_CACHE", "TPU_RAG_PREFIX_HBM_MB", "TPU_RAG_PREFIX_REUSE", "TPU_RAG_PREFIX_BOUNDARY_TOKENS",
    "TPU_RAG_PREFIX_CHUNK_HOT_MIN", "TPU_RAG_PREFIX_CHUNK_POOL_REGS",
    "TPU_RAG_KV_TIERING", "TPU_RAG_KV_TIERING_WARM_BELOW", "TPU_RAG_KV_TIERING_COLD_BELOW",
    "TPU_RAG_KV_TIERING_HALF_LIFE_S", "TPU_RAG_KV_TIERING_HOST_MB", "TPU_RAG_KV_TIERING_INTERVAL_S",
    "TPU_RAG_LOOKAHEAD", "TPU_RAG_LOOKAHEAD_PRESTAGE", "TPU_RAG_LOOKAHEAD_SESSIONS", "TPU_RAG_LOOKAHEAD_WORKERS",
    "TPU_RAG_LOOKAHEAD_INFLIGHT", "TPU_RAG_LOOKAHEAD_TTL_S", "TPU_RAG_LOOKAHEAD_SESSION_TURNS",
    "TPU_RAG_LOOKAHEAD_SESSION_MAX", "TPU_RAG_LOOKAHEAD_SESSION_TTL_S",
    "TPU_RAG_GOODPUT", "TPU_RAG_CHIP_HOUR_USD", "TPU_RAG_GOODPUT_PEAK_TFLOPS", "TPU_RAG_GOODPUT_HBM_GBS",
    "TPU_RAG_SLO_AVAILABILITY_OBJECTIVE", "TPU_RAG_SLO_REQUEST_P95_OBJECTIVE", "TPU_RAG_SLO_REQUEST_P95_S",
    "TPU_RAG_SLO_TTFT_P95_OBJECTIVE", "TPU_RAG_SLO_TTFT_P95_S", "TPU_RAG_SLO_QUALITY_OBJECTIVE",
    "TPU_RAG_SLO_QUALITY_LOGIT_ERR", "TPU_RAG_TENANTS", "TPU_RAG_TENANT_TOP_K",
    "TPU_RAG_FLIGHT_SPOOL", "TPU_RAG_FLIGHT_SPOOL_MAX", "TPU_RAG_FLIGHT_COOLDOWN_S",
    "TPU_RAG_SHADOW", "TPU_RAG_SHADOW_SAMPLE_RATE", "TPU_RAG_SHADOW_BACKLOG", "TPU_RAG_SHADOW_BURST_WINDOW_S",
    # read by server/main.py (resilience.faults.arm_from_env, the JSON log
    # formatter) and /debug/faults
    "TPU_RAG_FAULTS", "TPU_RAG_JSON_LOGS",
})

# (key, field, type) of KVTieringConfig, in the JAX from_env's order; the
# cross-field rules run once the env is applied (KVTieringConfig.validate)
TIERING_KEYS = (
    ("TPU_RAG_KV_TIERING_WARM_BELOW", "warm_below", float),
    ("TPU_RAG_KV_TIERING_COLD_BELOW", "cold_below", float),
    ("TPU_RAG_KV_TIERING_HALF_LIFE_S", "half_life_s", float),
    ("TPU_RAG_KV_TIERING_HOST_MB", "host_spill_mb", int),
    ("TPU_RAG_KV_TIERING_INTERVAL_S", "retier_interval_s", float),
)

# (key, field, minimum, type) of FlightConfig's WAL bounds, in the JAX
# from_env's order
WAL_KEYS = (
    ("TPU_RAG_FLIGHT_WAL_SEGMENT_EVENTS", "wal_segment_events", 1),
    ("TPU_RAG_FLIGHT_WAL_SEGMENTS", "wal_segments", 2),
    ("TPU_RAG_FLIGHT_WAL_RESTORE_CHUNKS", "wal_restore_chunks", 0),
)

# (key, field, type) of RouterConfig; its rules run once the env is applied
# (RouterConfig.validate)
ROUTER_KEYS = (
    ("TPU_RAG_ROUTER_AFFINITY_WEIGHT", "affinity_weight", float),
    ("TPU_RAG_ROUTER_LOAD_WEIGHT", "load_weight", float),
    ("TPU_RAG_ROUTER_HOT_CHUNKS", "hot_chunks", int),
    ("TPU_RAG_ROUTER_SESSION_TTL_S", "session_ttl_s", float),
)

# LookaheadConfig, in the JAX from_env's order: (key, field) of the flags,
# then (key, field, minimum, type) of the numbers
LOOKAHEAD_FLAGS = (
    ("TPU_RAG_LOOKAHEAD", "enabled"),
    ("TPU_RAG_LOOKAHEAD_PRESTAGE", "prestage_kv"),
    ("TPU_RAG_LOOKAHEAD_SESSIONS", "session_pipelining"),
)
LOOKAHEAD_NUMBERS = (
    ("TPU_RAG_LOOKAHEAD_WORKERS", "max_workers", 1, int),
    ("TPU_RAG_LOOKAHEAD_INFLIGHT", "max_inflight", 1, int),
    ("TPU_RAG_LOOKAHEAD_TTL_S", "ttl_s", 0.1, float),
    ("TPU_RAG_LOOKAHEAD_SESSION_TURNS", "session_context_turns", 1, int),
    ("TPU_RAG_LOOKAHEAD_SESSION_MAX", "session_max", 1, int),
    ("TPU_RAG_LOOKAHEAD_SESSION_TTL_S", "session_ttl_s", 1.0, float),
)

# (key, field, minimum, type) of ResilienceConfig, in the JAX from_env's order
RESILIENCE_KEYS = (
    ("TPU_RAG_ADMISSION_MAX_CONCURRENCY", "admission_max_concurrency", 1, int),
    ("TPU_RAG_ADMISSION_MAX_QUEUE", "admission_max_queue", 0, int),
    ("TPU_RAG_ADMISSION_RETRY_AFTER_S", "admission_retry_after_s", 0.0, float),
    ("TPU_RAG_DEADLINE_MS", "deadline_ms", 1, int),
    ("TPU_RAG_BREAKER_RESETS", "breaker_reset_threshold", 1, int),
    ("TPU_RAG_BREAKER_WINDOW_S", "breaker_window_s", 1.0, float),
    ("TPU_RAG_INFLIGHT_RETRIES", "inflight_retries", 0, int),
    ("TPU_RAG_RETRY_BACKOFF_MS", "retry_backoff_ms", 0.0, float),
    ("TPU_RAG_DRAIN_DEADLINE_S", "drain_deadline_s", 0.1, float),
    ("TPU_RAG_DRAIN_RETRY_AFTER_S", "drain_retry_after_s", 0.0, float),
)


def _flag(env: dict, key: str) -> Optional[bool]:
    if key not in env:
        return None
    flag = env[key]
    if flag not in ("0", "1"):
        raise ValueError(f"{key}={flag!r}: expected '0' or '1'")
    return flag == "1"


def _int(env: dict, key: str, minimum: int, note: str = "") -> Optional[int]:
    if key not in env:
        return None
    v = int(env[key])
    if v < minimum:
        raise ValueError(f"{key}={v}: expected >= {minimum}{note}")
    return v


@dataclass(frozen=True)
class AppConfig:
    dtypes: DTypePolicy = field(default_factory=DTypePolicy)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    model: LlamaConfig = field(default_factory=LlamaConfig.llama_3_1_8b)
    encoder: EncoderConfig = field(default_factory=EncoderConfig.bge_m3)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    server: ServerConfig = field(default_factory=ServerConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    lookahead: LookaheadConfig = field(default_factory=LookaheadConfig)
    flight: FlightConfig = field(default_factory=FlightConfig)
    router: RouterConfig = field(default_factory=RouterConfig)
    slo: SloConfig = field(default_factory=SloConfig)
    tenants: TenantConfig = field(default_factory=TenantConfig)
    shadow: ShadowConfig = field(default_factory=ShadowConfig)
    system_message: str = SYSTEM_MESSAGE

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "AppConfig":
        """The config with the deployment's environment applied (JAX
        ``AppConfig.from_env`` for the ported fields; see the module
        docstring for the keys it refuses or ignores)."""
        env = dict(os.environ if env is None else env)
        for key, item in UNPORTED_KEYS.items():
            if key in env:
                raise ValueError(f"{key}={env[key]!r} turns on a feature the PyTorch port does not "
                                 f"have yet: ROADMAP.md {item}")
        ignored = sorted(k for k in env if k.startswith("TPU_RAG_") and k not in PORTED_KEYS)
        if ignored:
            logging.getLogger(__name__).warning(
                "ignoring %s: the PyTorch port has no such feature yet (ROADMAP.md Queue 3 item A)",
                ", ".join(ignored),
            )
        cfg = cls()
        rep = dataclasses.replace
        server = cfg.server
        if "MODEL_PATH" in env:
            mp = env["MODEL_PATH"]
            server = rep(server, model_path=mp, index_path=os.path.join(mp, "tpu_index"),
                         embedder_path=os.path.join(mp, "bge-m3"))
        if "TPU_RAG_INDEX_PATH" in env:
            server = rep(server, index_path=env["TPU_RAG_INDEX_PATH"])
        if "TPU_RAG_PDF_DIR" in env:
            server = rep(server, pdf_dir=env["TPU_RAG_PDF_DIR"])
        if "TPU_RAG_PORT" in env:
            server = rep(server, port=int(env["TPU_RAG_PORT"]))
        mesh = cfg.mesh
        if "TPU_RAG_MESH" in env:
            # e.g. "dp=2,tp=4" or "tp=8"
            mesh = parse_mesh(env["TPU_RAG_MESH"], mesh)
        sampling = cfg.sampling
        if "TPU_RAG_MAX_NEW_TOKENS" in env:
            sampling = rep(sampling, max_new_tokens=int(env["TPU_RAG_MAX_NEW_TOKENS"]))
        engine = cfg.engine
        if "TPU_RAG_BATCHING" in env:
            mode = env["TPU_RAG_BATCHING"]
            if mode not in ("continuous", "coalesce"):
                raise ValueError(f"TPU_RAG_BATCHING={mode!r}: expected 'continuous' or 'coalesce'")
            engine = rep(engine, batching=mode)
        for key, name in (("TPU_RAG_WEIGHT_QUANT", "weight_quant"), ("TPU_RAG_KV_QUANT", "kv_quant")):
            if key in env:
                if env[key] not in ("bf16", "int8"):
                    raise ValueError(f"{key}={env[key]!r}: expected 'bf16' or 'int8'")
                engine = rep(engine, **{name: env[key]})
        if (v := _flag(env, "TPU_RAG_KV_PAGED")) is not None:
            engine = rep(engine, kv_paged=v)
        if (v := _int(env, "TPU_RAG_KV_BLOCK_SIZE", 1)) is not None:
            engine = rep(engine, kv_block_size=v)
        if (v := _int(env, "TPU_RAG_KV_POOL_BLOCKS", 0, " (0 = dense parity)")) is not None:
            engine = rep(engine, kv_pool_blocks=v)
        if (v := _flag(env, "TPU_RAG_SPEC_PAGED")) is not None:
            engine = rep(engine, spec_paged=v)
        if (v := _int(env, "TPU_RAG_SPEC_PAGED_TOKENS", 1)) is not None:
            engine = rep(engine, spec_paged_tokens=v)
        if "TPU_RAG_SPEC_PAGED_MIN_ACCEPT" in env:
            ma = float(env["TPU_RAG_SPEC_PAGED_MIN_ACCEPT"])
            if not 0.0 <= ma <= 1.0:
                raise ValueError(
                    f"TPU_RAG_SPEC_PAGED_MIN_ACCEPT={ma}: an acceptance-rate floor must lie in [0, 1]"
                )
            engine = rep(engine, spec_paged_min_accept=ma)
        if (v := _flag(env, "TPU_RAG_INTERLEAVE_PREFILL")) is not None:
            engine = rep(engine, interleave_prefill=v)
        if (v := _int(env, "TPU_RAG_PREFILL_CHUNK_TOKENS", 1)) is not None:
            engine = rep(engine, prefill_chunk_tokens=v)
        if (v := _int(env, "TPU_RAG_WINDOW_TOKEN_BUDGET", 0, " (0 = auto)")) is not None:
            engine = rep(engine, window_token_budget=v)
        if (v := _flag(env, "TPU_RAG_DO_SAMPLE")) is not None:
            sampling = rep(sampling, do_sample=v)
        if "TPU_RAG_SPECULATIVE" in env:
            spec = env["TPU_RAG_SPECULATIVE"]
            if spec not in ("off", "prompt_lookup", "auto"):
                raise ValueError(
                    f"TPU_RAG_SPECULATIVE={spec!r}: expected 'off', 'prompt_lookup' or 'auto'"
                )
            engine = rep(engine, speculative=spec)
        if (v := _int(env, "TPU_RAG_SYNC_STEPS", 1)) is not None:
            engine = rep(engine, decode_sync_steps=v)
        if (v := _flag(env, "TPU_RAG_WARM_FULL_LADDER")) is not None:
            engine = rep(engine, warm_full_ladder=v)
        if (v := _flag(env, "TPU_RAG_FUSED")) is not None:
            engine = rep(engine, rag_fused=v)
        pc = engine.prefix_cache
        if (v := _flag(env, "TPU_RAG_PREFIX_CACHE")) is not None:
            pc = rep(pc, enabled=v)
        if (v := _int(env, "TPU_RAG_PREFIX_HBM_MB", 1)) is not None:
            pc = rep(pc, hbm_budget_mb=v)
        if "TPU_RAG_PREFIX_REUSE" in env:
            policy = env["TPU_RAG_PREFIX_REUSE"]
            if policy not in ("exact", "slot", "chunk"):
                raise ValueError(f"TPU_RAG_PREFIX_REUSE={policy!r}: expected 'exact', 'slot' or 'chunk'")
            pc = rep(pc, reuse=policy)
        if (v := _int(env, "TPU_RAG_PREFIX_BOUNDARY_TOKENS", 0)) is not None:
            pc = rep(pc, boundary_tokens=v)
        if "TPU_RAG_PREFIX_CHUNK_HOT_MIN" in env:
            hm = float(env["TPU_RAG_PREFIX_CHUNK_HOT_MIN"])
            if hm < 0:
                raise ValueError(f"TPU_RAG_PREFIX_CHUNK_HOT_MIN={hm}: expected >= 0")
            pc = rep(pc, chunk_hot_min=hm)
        if (v := _int(env, "TPU_RAG_PREFIX_CHUNK_POOL_REGS", 1)) is not None:
            pc = rep(pc, chunk_pool_regs=v)
        tiering = engine.kv_tiering
        if (v := _flag(env, "TPU_RAG_KV_TIERING")) is not None:
            tiering = rep(tiering, enabled=v)
        for key, name, cast in TIERING_KEYS:
            if key in env:
                tiering = rep(tiering, **{name: cast(env[key])})
        tiering.validate()  # cross-field rules once, with the env applied
        engine = rep(engine, prefix_cache=pc, kv_tiering=tiering)
        goodput = engine.goodput
        if (v := _flag(env, "TPU_RAG_GOODPUT")) is not None:
            goodput = rep(goodput, enabled=v)
        for key, name in (("TPU_RAG_CHIP_HOUR_USD", "chip_hour_usd"), ("TPU_RAG_GOODPUT_PEAK_TFLOPS", "peak_tflops"),
                          ("TPU_RAG_GOODPUT_HBM_GBS", "hbm_gbs")):
            if key in env:
                goodput = rep(goodput, **{name: float(env[key])})
        goodput.validate()  # range rules once, with the env applied
        engine = rep(engine, goodput=goodput)
        if "TPU_RAG_POOL_ROLE" in env:
            role = env["TPU_RAG_POOL_ROLE"]
            if role not in ("unified", "prefill", "decode"):
                raise ValueError(f"TPU_RAG_POOL_ROLE={role!r}: expected 'unified', 'prefill', or 'decode'")
            engine = rep(engine, pool_role=role)
        engine.validate_interleave()  # cross-field rules, with the env applied
        engine.validate_pool_role()
        resilience = cfg.resilience
        for key, name, minimum, cast in RESILIENCE_KEYS:
            if key in env:
                v = cast(env[key])
                if v < minimum:
                    raise ValueError(f"{key}={v}: expected >= {minimum}")
                resilience = rep(resilience, **{name: v})
        lookahead = cfg.lookahead
        for key, name in LOOKAHEAD_FLAGS:
            if (v := _flag(env, key)) is not None:
                lookahead = rep(lookahead, **{name: v})
        for key, name, minimum, cast in LOOKAHEAD_NUMBERS:
            if key in env:
                v = cast(env[key])
                if v < minimum:
                    raise ValueError(f"{key}={v}: expected >= {minimum}")
                lookahead = rep(lookahead, **{name: v})
        flight = cfg.flight
        for key, name in (("TPU_RAG_FLIGHT", "enabled"), ("TPU_RAG_DEBUG", "debug_endpoints"),
                          ("TPU_RAG_FLIGHT_ARRIVAL_IDS", "arrival_ids")):
            if (v := _flag(env, key)) is not None:
                flight = rep(flight, **{name: v})
        if (v := _int(env, "TPU_RAG_FLIGHT_EVENTS", 1)) is not None:
            flight = rep(flight, capacity=v)
        if "TPU_RAG_FLIGHT_SPOOL" in env:
            flight = rep(flight, spool_dir=env["TPU_RAG_FLIGHT_SPOOL"])
        if (v := _int(env, "TPU_RAG_FLIGHT_SPOOL_MAX", 1)) is not None:
            flight = rep(flight, spool_max=v)
        if "TPU_RAG_FLIGHT_COOLDOWN_S" in env:
            v = float(env["TPU_RAG_FLIGHT_COOLDOWN_S"])
            if v < 0:
                raise ValueError(f"TPU_RAG_FLIGHT_COOLDOWN_S={v}: expected >= 0")
            flight = rep(flight, cooldown_s=v)
        for key, name in (("TPU_RAG_FLIGHT_WAL", "wal"), ("TPU_RAG_FLIGHT_WAL_RESTORE", "wal_restore")):
            if (v := _flag(env, key)) is not None:
                flight = rep(flight, **{name: v})
        if "TPU_RAG_FLIGHT_WAL_DIR" in env:
            flight = rep(flight, wal_dir=env["TPU_RAG_FLIGHT_WAL_DIR"])
        for key, name, minimum in WAL_KEYS:
            if (v := _int(env, key, minimum)) is not None:
                flight = rep(flight, **{name: v})
        router = cfg.router
        for key, name, cast in ROUTER_KEYS:
            if key in env:
                router = rep(router, **{name: cast(env[key])})
        router.validate()
        return rep(cfg, mesh=mesh, server=server, sampling=sampling, engine=engine, resilience=resilience,
                   lookahead=lookahead, flight=flight, router=router, slo=SloConfig.from_env(env),
                   tenants=TenantConfig.from_env(env), shadow=ShadowConfig.from_env(env))

