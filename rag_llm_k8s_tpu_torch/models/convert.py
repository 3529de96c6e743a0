"""Weights bridge: the JAX package's parameter trees → the port's models,
and the port's own seeded random init at any width.

The JAX trees arrive flattened as ``{"a/b/c": np.ndarray}`` (``flatten_tree``
walks nested mappings, so a Flax param dict flattens without JAX). Its
decoder layers are ``nn.scan``-stacked, so every per-layer leaf carries a
leading ``[L, ...]`` axis, and its Dense kernels are ``[in, out]``; the port
keeps one module per layer and PyTorch's ``[out, in]`` layout. A tree from
``quantize_llama_params`` (``kernel_q``/``qscale`` per projection,
``lm_head_q``/``lm_head_scale`` or ``embedding_q``/``embedding_scale``) maps
onto the quantized layout: int8 ``weight [out, in]`` and fp32 ``scale [out]``.

``init_random_sharded`` makes a rank's shard of ``init_random_``'s model on
a mesh, drawing the same values one whole tensor at a time and keeping its
slice (the streaming put), so no rank holds the whole model.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from rag_llm_k8s_tpu_torch.models.bge_m3 import BgeM3Encoder
from rag_llm_k8s_tpu_torch.models.llama import LlamaModel

INIT_STD = 0.02


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping of array leaves → ``{"a/b/c": np.ndarray}``."""
    flat: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(flatten_tree(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def llama_is_fused(flat: Mapping[str, np.ndarray]) -> bool:
    return "layers/attn/wqkv/kernel" in flat or "layers/attn/wqkv/kernel_q" in flat


def llama_is_quantized(flat: Mapping[str, np.ndarray]) -> bool:
    return any(path.endswith("/kernel_q") for path in flat)


# JAX leaf suffix of a per-layer projection -> (port parameter, transpose?)
_PROJ_LEAVES = {"/kernel": ("weight", True), "/kernel_q": ("weight", True), "/qscale": ("scale", False)}


def llama_state_dict(flat: Mapping[str, np.ndarray], num_layers: int) -> Dict[str, np.ndarray]:
    """Flat JAX Llama params (unfused, or fused by ``fuse_llama_params``;
    bf16 or quantized by ``quantize_llama_params``) → the port's state
    dict, as numpy arrays."""
    sd = {"final_norm.weight": flat["final_norm/scale"]}
    if "embedding_q" in flat:  # tied and quantized
        sd["embed.weight"], sd["embed.scale"] = flat["embedding_q"], flat["embedding_scale"]
    else:
        sd["embed.weight"] = flat["embedding"]
    if "lm_head" in flat:
        sd["lm_head.weight"] = flat["lm_head"].T
    if "lm_head_q" in flat:
        sd["lm_head.weight"], sd["lm_head.scale"] = flat["lm_head_q"].T, flat["lm_head_scale"]
    for i in range(num_layers):
        p = f"layers.{i}."
        sd[p + "input_norm.weight"] = flat["layers/input_norm/scale"][i]
        sd[p + "post_attn_norm.weight"] = flat["layers/post_attn_norm/scale"][i]
        for group in ("attn", "mlp"):
            prefix = f"layers/{group}/"
            for path, leaf in flat.items():
                if not path.startswith(prefix):
                    continue
                for suffix, (param, transpose) in _PROJ_LEAVES.items():
                    if path.endswith(suffix):
                        name = path[len(prefix):-len(suffix)]
                        sd[f"{p}{group}.{name}.{param}"] = leaf[i].T if transpose else leaf[i]
    return sd


def encoder_state_dict(flat: Mapping[str, np.ndarray], num_layers: int) -> Dict[str, np.ndarray]:
    """Flat JAX bge-m3 params (``init_encoder_params`` layout) → the port's
    state dict."""
    sd = {
        "word_embeddings.weight": flat["word_embeddings"],
        "position_embeddings.weight": flat["position_embeddings"],
        "token_type_embeddings.weight": flat["token_type_embeddings"],
        "embed_ln.weight": flat["embed_ln/scale"],
        "embed_ln.bias": flat["embed_ln/bias"],
    }
    for i in range(num_layers):
        p = f"layers.{i}."
        for name in ("wq", "wk", "wv", "wo", "w_in", "w_out"):
            sd[f"{p}{name}.weight"] = flat[f"layers/{name}/kernel"][i].T
            sd[f"{p}{name}.bias"] = flat[f"layers/{name}/bias"][i]
        for ln in ("attn_ln", "ffn_ln"):
            sd[f"{p}{ln}.weight"] = flat[f"layers/{ln}/scale"][i]
            sd[f"{p}{ln}.bias"] = flat[f"layers/{ln}/bias"][i]
    return sd


@torch.no_grad()
def _load(model: torch.nn.Module, sd: Mapping[str, np.ndarray]) -> None:
    params = dict(model.named_parameters())
    missing = set(params) - set(sd)
    extra = set(sd) - set(params)
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)}, unexpected {sorted(extra)}")
    for name, arr in sd.items():
        p = params[name]
        t = arr.detach().cpu() if isinstance(arr, torch.Tensor) else torch.tensor(np.asarray(arr))
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(p.shape)}")
        p.copy_(t.to(dtype=p.dtype))


def load_state_dict(model: torch.nn.Module, sd: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy a port-named state dict of numpy arrays or tensors into
    ``model``, every parameter exactly once (shapes must match)."""
    _load(model, sd)
    return model


def load_llama(model: LlamaModel, flat: Mapping[str, np.ndarray]) -> LlamaModel:
    """Copy flat JAX Llama params into ``model`` (its fused and quantized
    flags must match the tree's)."""
    if llama_is_fused(flat) != model.fused:
        raise ValueError("fused layout of the params and the model differ")
    if llama_is_quantized(flat) != model.quantized:
        raise ValueError("the params and the model differ in weight quantization")
    _load(model, llama_state_dict(flat, model.config.num_layers))
    return model


def load_encoder(model: BgeM3Encoder, flat: Mapping[str, np.ndarray]) -> BgeM3Encoder:
    _load(model, encoder_state_dict(flat, model.config.num_layers))
    return model


def _init_param_(name: str, p: torch.Tensor, generator: torch.Generator) -> None:
    leaf = name.rsplit(".", 1)[-1]
    if "norm" in name or "_ln" in name:
        p.fill_(1.0 if leaf == "weight" else 0.0)
    elif leaf == "bias":
        p.zero_()
    else:
        p.normal_(0.0, INIT_STD, generator=generator)


@torch.no_grad()
def init_random_(model: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Seeded random weights in place, for either model at any width:
    norm weights 1 and biases 0, every other weight N(0, 0.02). The
    generator must live on the model's device."""
    for name, p in model.named_parameters():
        _init_param_(name, p, generator)
    return model


def _unfused(name: str, t: torch.Tensor, config) -> list:
    """A parameter of the fused layout as ``(name, tensor)`` parts of the
    unfused one (``fuse_projections_`` in reverse)."""
    if name.endswith("attn.wqkv.weight"):
        H, K, hd = config.num_heads, config.num_kv_heads, config.head_dim
        base = name[: -len("wqkv.weight")]
        return list(zip((base + "wq.weight", base + "wk.weight", base + "wv.weight"),
                        t.split([H * hd, K * hd, K * hd], dim=0)))
    if name.endswith("mlp.w_gateup.weight"):
        base = name[: -len("w_gateup.weight")]
        return list(zip((base + "w_gate.weight", base + "w_up.weight"), t.chunk(2, dim=0)))
    return [(name, t)]


@torch.no_grad()
def init_random_sharded(config, dtypes, mesh, generator: torch.Generator, fused_source: bool = False,
                        **build) -> LlamaModel:
    """This rank's shard (unfused) of ``init_random_(build_llama(config,
    dtypes, fused=fused_source), generator)``: the same draws in the same
    order, each whole tensor drawn on ``mesh.device``, split when the
    source layout is fused, sliced by the streaming put
    (``parallel.sharding.make_streaming_put``) and dropped. ``build``:
    ``build_llama``'s ``attn_impl`` and ``trainable``."""
    from rag_llm_k8s_tpu_torch.models.llama import build_llama
    from rag_llm_k8s_tpu_torch.parallel.sharding import make_streaming_put

    with torch.device("meta"):
        full = LlamaModel(config, dtypes, fused=fused_source)
    model = build_llama(config, dtypes, mesh.device, mesh=mesh, **build)
    params = dict(model.named_parameters())
    put = make_streaming_put(mesh, config) if mesh.tp > 1 else (lambda n, t: t)
    done = set()
    for name, p in full.named_parameters():
        t = torch.empty(p.shape, dtype=p.dtype, device=mesh.device)
        _init_param_(name, t, generator)
        for part_name, part in _unfused(name, t, config):
            params[part_name].copy_(put(part_name, part))
            done.add(part_name)
        del t
    if done != set(params):
        raise RuntimeError(f"init_random_sharded left {sorted(set(params) - done)[:3]} unfilled")
    return model


