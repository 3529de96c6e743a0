"""Typed configuration: the main-path subset of the JAX package's config tree.

Same fields and the same defaults as ``rag_llm_k8s_tpu/core/config.py``, so a
deployment reads one table for both packages. Only ``DTypePolicy`` differs:
it names torch dtypes. Knobs that only the JAX package's other paths read
(mesh, prefix cache, tiering, speculative continuous decode, pool roles,
observability) are not here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

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


@dataclass(frozen=True)
class SamplingConfig:
    """150 new tokens, temperature 0.7, top-p 0.9, sampling on."""

    max_new_tokens: int = 150
    temperature: float = 0.7
    top_p: float = 0.9
    do_sample: bool = True
    seed: int = 0


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
    # request scheduling: "coalesce" (the JAX package's default; its
    # coalescing scheduler is not ported, so the port's service then
    # serves each request through the one-shot engine) or "continuous"
    # (requests join a running batch: engine/continuous.py)
    batching: str = "coalesce"
    # continuous engine: decode steps run per host sync (one token fetch
    # per window)
    decode_sync_steps: int = 1
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

    def validate_quant(self) -> None:
        """``weight_quant`` and ``kv_quant`` name a storage the engines
        serve, checked at engine construction."""
        for name in ("weight_quant", "kv_quant"):
            if getattr(self, name) not in ("bf16", "int8"):
                raise ValueError(f"{name}={getattr(self, name)!r}: expected 'bf16' or 'int8'")

    def validate_interleave(self) -> None:
        """Cross-field rules for interleaved admission, checked at
        continuous-engine construction."""
        if not self.interleave_prefill:
            return
        if not self.kv_paged:
            raise ValueError(
                "interleave_prefill=True requires kv_paged=True: chunked "
                "admission writes through block tables"
            )
        if self.prefill_chunk_tokens < 1:
            raise ValueError(
                f"prefill_chunk_tokens={self.prefill_chunk_tokens}: a mixed "
                "window must carry at least one prefill token per chunk"
            )
        if self.window_token_budget and self.window_token_budget < self.max_batch_size + 1:
            raise ValueError(
                f"window_token_budget={self.window_token_budget} cannot cover "
                f"max_batch_size={self.max_batch_size} decode lanes plus one "
                "prefill token (0 means max_batch_size + prefill_chunk_tokens)"
            )


SYSTEM_MESSAGE = (
    "You are a helpful assistant. Answer the user's question based ONLY on the "
    "given context.\nIf the context doesn't contain relevant information to the "
    "specific question, say 'I don't have enough information to answer that "
    "specific question.'\nDo not make up information or use general knowledge "
    "outside of the given context."
)


@dataclass(frozen=True)
class AppConfig:
    dtypes: DTypePolicy = field(default_factory=DTypePolicy)
    model: LlamaConfig = field(default_factory=LlamaConfig.llama_3_1_8b)
    encoder: EncoderConfig = field(default_factory=EncoderConfig.bge_m3)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    system_message: str = SYSTEM_MESSAGE
