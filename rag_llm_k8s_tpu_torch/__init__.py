"""rag_llm_k8s_tpu_torch — the RAG serving system in PyTorch on an NVIDIA H100.

A port of the JAX package ``rag_llm_k8s_tpu`` (which stays the reference),
slice by slice, main path first. Plain tensor code is PyTorch; every kernel
the JAX package wrote in Pallas for the TPU is a hand-written CUDA kernel for
Hopper (``ops/csrc``), built with ``nvcc`` at first use. The layout mirrors
the JAX package:

    core/    config (same defaults), device resolution, numerics switches,
             the device mesh over torch.distributed (one process per rank)
    parallel/ tensor-parallel sharding rules, ring attention (sp), the
             launcher of a world of ranks and rank 0's command stream
    ops/     kNN and attention kernels with their plain PyTorch versions
    models/  Llama-3.1 decoder, bge-m3 encoder, weights bridge
    engine/  one-shot engine (bucketed/chunked prefill, decode, speculation,
             the prefixed generate), the KV prefix cache and its hotness
             tiering, paged continuous engine and its scheduler, KV block
             pool, sampling, batched embedding
    sim/     the continuous scheduler's decision core (pure functions)
    index/   in-memory vector store with device snapshots
    rag/     chunking, PDF text, prompt assembly
    server/  the HTTP routes over WSGI

The package imports torch, numpy and the standard library only.
"""

from rag_llm_k8s_tpu_torch.core import device as _device  # noqa: F401  (sets the TF32 switches)

__version__ = "0.1.0"
