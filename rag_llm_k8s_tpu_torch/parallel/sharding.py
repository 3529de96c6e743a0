"""Tensor-parallel sharding rules for the Llama parameters, counterpart of
``rag_llm_k8s_tpu/parallel/sharding.py``.

The JAX package expresses the Megatron layout as PartitionSpecs over the
``tp`` axis and lets XLA insert the collectives. Here each rank holds its
slice of every sharded parameter, and ``models/llama.py`` runs the
collectives explicitly (``core/mesh.py``):

    embedding  [V, D]     vocab rows          (masked lookup + all-reduce)
    wq/wk/wv   [out, D]   output features     (column parallel: heads split)
    wo         [D, in]    input features      (row parallel: all-reduce after)
    w_gate/up  [I, D]     output features     (column parallel)
    w_down     [D, I]     input features      (row parallel: all-reduce after)
    lm_head    [V, D]     vocab rows          (logits all-gathered)
    norms      [D]        replicated

``_RULES`` is the JAX package's table over its own parameter paths (Dense
kernels ``[L, in, out]``), copied with ``_fit_spec``: a dim that does not
divide the axis degrades to replicated. ``llama_param_specs`` maps each of
the port's parameters (PyTorch ``[out, in]``, one module per layer) onto
its JAX path, so the one table decides both layouts. int8 weights shard as
the bf16 ones; per-output-channel scales shard with the output axis of a
column-parallel weight and are replicated on a row-parallel one. Head
counts that do not tile ``tp`` leave the attention projections replicated
(JAX ``replicate_undividable_heads``), so the attention kernels always run
on whole heads.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, LlamaConfig

# rules keyed by (path suffix); value = spec template over array dims.
# Weight-only int8 trees (models.llama.quantize_llama_params) shard their
# "kernel_q" exactly like the bf16 "kernel"; per-output-channel "qscale"
# vectors shard with the kernel's OUTPUT axis (column-parallel projections)
# and replicate where the kernel is row-parallel (output axis unsharded).
_RULES: Tuple[Tuple[Tuple[str, ...], Tuple[object, ...]], ...] = (
    (("embedding",), ("tp", None)),
    (("embedding_q",), ("tp", None)),
    (("embedding_scale",), ("tp",)),
    (("lm_head",), (None, "tp")),
    (("lm_head_q",), (None, "tp")),
    (("lm_head_scale",), ("tp",)),
    (("attn", "wq", "kernel"), (None, None, "tp")),
    (("attn", "wk", "kernel"), (None, None, "tp")),
    (("attn", "wv", "kernel"), (None, None, "tp")),
    (("attn", "wo", "kernel"), (None, "tp", None)),
    (("mlp", "w_gate", "kernel"), (None, None, "tp")),
    (("mlp", "w_up", "kernel"), (None, None, "tp")),
    (("mlp", "w_down", "kernel"), (None, "tp", None)),
    (("attn", "wq", "kernel_q"), (None, None, "tp")),
    (("attn", "wk", "kernel_q"), (None, None, "tp")),
    (("attn", "wv", "kernel_q"), (None, None, "tp")),
    (("attn", "wo", "kernel_q"), (None, "tp", None)),
    (("mlp", "w_gate", "kernel_q"), (None, None, "tp")),
    (("mlp", "w_up", "kernel_q"), (None, None, "tp")),
    (("mlp", "w_down", "kernel_q"), (None, "tp", None)),
    (("attn", "wq", "qscale"), (None, "tp")),
    (("attn", "wk", "qscale"), (None, "tp")),
    (("attn", "wv", "qscale"), (None, "tp")),
    (("mlp", "w_gate", "qscale"), (None, "tp")),
    (("mlp", "w_up", "qscale"), (None, "tp")),
    # wo/w_down scales: output axis is the unsharded hidden dim -> replicated
    # (default rule), matching the psum XLA inserts after row-parallel matmuls
)


# leaf names of the weight-only int8 layout (models.llama.QuantDense /
# quantize_llama_params). "qscale" is distinct from RMSNorm's "scale" by
# construction, so name alone identifies a quantized artifact.
_QUANT_LEAVES = frozenset(
    {"kernel_q", "qscale", "lm_head_q", "lm_head_scale", "embedding_q", "embedding_scale"}
)


def is_quant_leaf(path: Tuple[str, ...]) -> bool:
    """True for int8 kernels and their fp32 scale vectors — leaves whose
    dtype must survive placement untouched (never cast to the bf16 policy)."""
    return path[-1] in _QUANT_LEAVES


def _spec_for_path(path: Tuple[str, ...], ndim: int) -> Tuple[object, ...]:
    for suffix, template in _RULES:
        if path[-len(suffix):] == suffix:
            return template
    return (None,) * ndim  # norms, biases: replicated


def _fit_spec(template: Tuple[object, ...], shape, ctx) -> Tuple[object, ...]:
    """Drop shardings whose dim doesn't divide the axis size."""
    fitted = []
    for dim, ax in zip(shape, template):
        if ax is None:
            fitted.append(None)
        else:
            fitted.append(ax if dim % ctx.axis_size(ax) == 0 else None)
    return tuple(fitted)


def heads_shardable(config: LlamaConfig, tp: int) -> bool:
    """Whether the attention heads tile ``tp`` (query and kv heads both;
    JAX's ``heads_shardable`` checks)."""
    return tp > 1 and config.num_heads % tp == 0 and config.num_kv_heads % tp == 0


@dataclass(frozen=True)
class TPLayout:
    """What a rank holds at ``tp``: which parts are sharded and the shapes
    of its slice (``local``: the model config at those shapes)."""

    attn: bool
    mlp: bool
    vocab: bool
    local: LlamaConfig


def tp_layout(config: LlamaConfig, tp: int) -> TPLayout:
    """The layout ``_fit_spec`` gives ``config`` over ``tp`` ranks, with
    the heads rule applied."""
    attn = heads_shardable(config, tp)
    mlp = tp > 1 and config.intermediate_size % tp == 0
    vocab = tp > 1 and config.vocab_size % tp == 0
    local = dataclasses.replace(
        config,
        num_heads=config.num_heads // tp if attn else config.num_heads,
        num_kv_heads=config.num_kv_heads // tp if attn else config.num_kv_heads,
        intermediate_size=config.intermediate_size // tp if mlp else config.intermediate_size,
        vocab_size=config.vocab_size // tp if vocab else config.vocab_size,
    )
    return TPLayout(attn, mlp, vocab, local)


def _jax_path(name: str, quantized: bool) -> Tuple[Tuple[str, ...], bool, bool]:
    """A port parameter's JAX path, whether the JAX leaf stacks layers
    (``[L, ...]``) and whether it is the transpose of the port's."""
    parts = name.split(".")
    leaf = parts[-1]
    if parts[0] == "embed":
        return ((("embedding_scale",) if leaf == "scale" else
                 ("embedding_q",) if quantized else ("embedding",)), False, False)
    if parts[0] == "lm_head":
        return ((("lm_head_scale",) if leaf == "scale" else
                 ("lm_head_q",) if quantized else ("lm_head",)), False, leaf == "weight")
    if parts[0] == "final_norm":
        return ("final_norm", "scale"), False, False
    mod = parts[2:-1]  # ("attn", "wq") or ("input_norm",)
    if len(mod) == 1:
        return ("layers", mod[0], "scale"), True, False
    if leaf == "scale":
        return ("layers", *mod, "qscale"), True, False
    return ("layers", *mod, "kernel_q" if quantized else "kernel"), True, True


def param_shard_dim(name: str, shape, config: LlamaConfig, ctx, quantized: bool = False) -> Optional[int]:
    """The dim of the port parameter ``name`` (of full shape ``shape``)
    that is sharded over ``tp``, or None when it is replicated."""
    if ctx.tp == 1:
        return None
    path, stacked, transposed = _jax_path(name, quantized)
    template = _spec_for_path(path, len(shape) + stacked)
    if stacked:
        template = template[1:]
    if transposed:
        template = template[::-1]
    spec = _fit_spec(template, shape, ctx)
    if "tp" not in spec:
        return None
    if ".attn." in name and not heads_shardable(config, ctx.tp):
        return None
    return spec.index("tp")


def llama_param_specs(config: LlamaConfig, ctx, quantized: bool = False) -> Dict[str, Optional[int]]:
    """``{parameter name: sharded dim or None}`` of the unfused port model
    (``models.llama.LlamaModel``; int8 layout with ``quantized``)."""
    from rag_llm_k8s_tpu_torch.models.llama import LlamaModel

    with torch.device("meta"):
        model = LlamaModel(config, DTypePolicy(), quantized=quantized)
    return {n: param_shard_dim(n, tuple(p.shape), config, ctx, quantized) for n, p in model.named_parameters()}


def shard_tensor(t, dim: Optional[int], ctx):
    """This rank's slice of ``t`` (a torch tensor or numpy array) along
    ``dim`` over tp; ``t`` itself when ``dim`` is None."""
    if dim is None:
        return t
    n, i = ctx.tp, ctx.axis_index("tp")
    size = t.shape[dim] // n
    idx = [slice(None)] * t.ndim
    idx[dim] = slice(i * size, (i + 1) * size)
    part = t[tuple(idx)]
    return np.ascontiguousarray(part) if isinstance(part, np.ndarray) else part.contiguous()


def shard_params(state_dict: Mapping, specs: Mapping[str, Optional[int]], ctx) -> Dict:
    """Each entry of a full state dict sliced for this rank per ``specs``."""
    return {name: shard_tensor(arr, specs[name], ctx) for name, arr in state_dict.items()}


def shard_llama_params(params, ctx, config: LlamaConfig, dtypes: DTypePolicy = DTypePolicy(), device=None,
                       **build):
    """One-call TP placement: the JAX package's flat (or nested) Llama
    parameter tree, unfused, bf16 or int8, as this rank's shard of the port
    model on ``device`` (default ``ctx.device``), through the weights bridge
    (``models/convert.py``). The full tree stays on the host. ``build``:
    ``build_llama``'s ``attn_impl`` and ``trainable``."""
    from rag_llm_k8s_tpu_torch.models import convert
    from rag_llm_k8s_tpu_torch.models.llama import build_llama

    flat = convert.flatten_tree(params)
    if convert.llama_is_fused(flat):
        raise ValueError("a fused q|k|v / gate|up tree cannot shard over tp: pass the unfused layout")
    quantized = convert.llama_is_quantized(flat)
    sd = convert.llama_state_dict(flat, config.num_layers)
    local = shard_params(sd, llama_param_specs(config, ctx, quantized), ctx)
    model = build_llama(config, dtypes, device if device is not None else ctx.device, quantized=quantized, mesh=ctx,
                        **build)
    convert.load_state_dict(model, local)
    return model


def make_streaming_put(ctx, config: LlamaConfig, dtype: Optional[torch.dtype] = None,
                       quantized: bool = False) -> Callable[[str, torch.Tensor], torch.Tensor]:
    """A ``put(name, tensor)`` for the loaders: each host tensor is sliced
    to this rank's shard and, unless it is an int8 payload or an fp32
    scale, cast to ``dtype``, both on the host before the transfer, so no
    rank ever holds the whole model on its device."""

    def put(name: str, t: torch.Tensor) -> torch.Tensor:
        part = shard_tensor(t, param_shard_dim(name, tuple(t.shape), config, ctx, quantized), ctx)
        quant_leaf = part.dtype == torch.int8 or name.endswith(".scale")
        if dtype is not None and part.dtype != dtype and not quant_leaf:
            part = part.to(dtype)
        return part

    return put
