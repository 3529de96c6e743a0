"""Parallelism: TP sharding rules, the launcher and command stream of the
one-process-per-rank mesh, ring attention (SP)."""

from rag_llm_k8s_tpu_torch.parallel.sharding import (
    llama_param_specs,
    shard_llama_params,
    shard_params,
)

__all__ = ["llama_param_specs", "shard_llama_params", "shard_params"]
