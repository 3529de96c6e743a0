"""Synthetic HF-layout checkpoints, the counterpart of
``rag_llm_k8s_tpu/utils/synth.py``, written with the port's own safetensors
writer (``utils/safetensors_io``).

``write_synth_checkpoint`` writes a ``model-0000X-of-0000N.safetensors``
shard set with the tensor names, dtypes and shapes of an HF Llama checkpoint
(the layout the product stages), ``write_synth_encoder`` an XLM-R / bge-m3
one, and ``write_hf_config`` the Llama ``config.json``. Unlike the JAX
writer's zeros, tensors hold **seeded random values** (norm weights near 1,
everything else N(0, 0.02)), drawn per tensor from ``(seed, tensor index)``,
so a load can be checked by value; a seed and a device give the same values
whatever the shard split.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import torch

from rag_llm_k8s_tpu_torch.core.config import EncoderConfig, LlamaConfig
from rag_llm_k8s_tpu_torch.utils.safetensors_io import save_file

INIT_STD = 0.02
Spec = Tuple[str, Tuple[int, ...]]


def llama_tensor_specs(config: LlamaConfig) -> List[Spec]:
    """(hf_name, shape) for every tensor of a Llama checkpoint, in the
    embed → layers → norm/lm_head order real shard indexes follow."""
    D, I = config.hidden_size, config.intermediate_size
    H, K, hd, V = config.num_heads, config.num_kv_heads, config.head_dim, config.vocab_size
    specs: List[Spec] = [("model.embed_tokens.weight", (V, D))]
    for i in range(config.num_layers):
        p = f"model.layers.{i}."
        specs += [
            (p + "self_attn.q_proj.weight", (H * hd, D)),
            (p + "self_attn.k_proj.weight", (K * hd, D)),
            (p + "self_attn.v_proj.weight", (K * hd, D)),
            (p + "self_attn.o_proj.weight", (D, H * hd)),
            (p + "mlp.gate_proj.weight", (I, D)),
            (p + "mlp.up_proj.weight", (I, D)),
            (p + "mlp.down_proj.weight", (D, I)),
            (p + "input_layernorm.weight", (D,)),
            (p + "post_attention_layernorm.weight", (D,)),
        ]
    specs.append(("model.norm.weight", (D,)))
    if not config.tie_word_embeddings:
        specs.append(("lm_head.weight", (V, D)))
    return specs


def xlmr_tensor_specs(config: EncoderConfig, prefix: str = "") -> List[Spec]:
    """(hf_name, shape) for an ``XLMRobertaModel`` checkpoint (bge-m3's
    layout), pooler included; ``prefix`` is ``""`` or ``"roberta."``."""
    D, I = config.hidden_size, config.intermediate_size
    e = prefix + "embeddings."
    specs: List[Spec] = [
        (e + "word_embeddings.weight", (config.vocab_size, D)),
        (e + "position_embeddings.weight", (config.max_position_embeddings, D)),
        (e + "token_type_embeddings.weight", (config.type_vocab_size, D)),
        (e + "LayerNorm.weight", (D,)),
        (e + "LayerNorm.bias", (D,)),
    ]
    for i in range(config.num_layers):
        p = f"{prefix}encoder.layer.{i}."
        for mod, (o, n) in (("attention.self.query", (D, D)), ("attention.self.key", (D, D)),
                            ("attention.self.value", (D, D)), ("attention.output.dense", (D, D)),
                            ("intermediate.dense", (I, D)), ("output.dense", (D, I))):
            specs += [(p + mod + ".weight", (o, n)), (p + mod + ".bias", (o,))]
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            specs += [(p + ln + ".weight", (D,)), (p + ln + ".bias", (D,))]
    specs += [(prefix + "pooler.dense.weight", (D, D)), (prefix + "pooler.dense.bias", (D,))]
    return specs


def synth_tensor(name: str, shape, index: int, seed: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """Tensor ``index`` of a synthetic checkpoint: norm weights 1 + N(0,
    0.02), everything else N(0, 0.02), drawn from ``(seed, index)`` in fp32
    and rounded to ``dtype``."""
    g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + index)
    t = torch.randn(shape, generator=g, device=device, dtype=torch.float32) * INIT_STD
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and ("norm" in name.lower() or "layernorm" in name.lower()):
        t += 1.0
    return t.to(dtype)


def _write_shards(out_dir: str, stem: str, specs: List[Spec], n_shards: int, seed: int,
                  dtype: torch.dtype, device) -> List[str]:
    """Write ``specs`` over ``n_shards`` files split by cumulative byte
    budget, as real HF shard indexes split a model; one shard is held in
    host memory at a time. Returns the shard paths."""
    device = torch.device(device)
    itemsize = torch.empty((), dtype=dtype).element_size()
    sizes = [itemsize * int(torch.Size(s).numel()) for _, s in specs]
    budget = -(-sum(sizes) // n_shards)
    os.makedirs(out_dir, exist_ok=True)
    paths: List[str] = []
    shard: Dict[str, torch.Tensor] = {}
    used = 0

    def flush():
        nonlocal shard, used
        if not shard:
            return
        name = (f"{stem}.safetensors" if n_shards == 1
                else f"{stem}-{len(paths) + 1:05d}-of-{n_shards:05d}.safetensors")
        path = os.path.join(out_dir, name)
        save_file(shard, path)
        paths.append(path)
        shard, used = {}, 0

    for index, ((name, shape), nbytes) in enumerate(zip(specs, sizes)):
        if shard and used + nbytes > budget and len(paths) + 1 < n_shards:
            flush()
        shard[name] = synth_tensor(name, shape, index, seed, dtype, device).cpu()
        used += nbytes
    flush()
    return paths


def write_synth_checkpoint(out_dir: str, config: LlamaConfig, n_shards: int = 4,
                           dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                           device="cpu") -> List[str]:
    """A seeded-random Llama checkpoint for ``config`` in ``n_shards``
    safetensors files (bf16 by default, like the staged Meta weights);
    ``device`` is where the values are drawn (``"cuda"`` is much faster at
    full width). Returns the shard paths."""
    return _write_shards(out_dir, "model", llama_tensor_specs(config), n_shards, seed, dtype, device)


def write_synth_encoder(out_dir: str, config: EncoderConfig, n_shards: int = 1,
                        dtype: torch.dtype = torch.float32, seed: int = 1, prefix: str = "",
                        device="cpu") -> List[str]:
    """A seeded-random XLM-R / bge-m3 checkpoint (``model.safetensors``, fp32
    by default as bge-m3 ships) for ``config``. Returns the shard paths."""
    return _write_shards(out_dir, "model", xlmr_tensor_specs(config, prefix), n_shards, seed, dtype, device)


def write_hf_config(out_dir: str, config: LlamaConfig) -> str:
    """The HF ``config.json`` for ``config`` (what ``models.loader.
    config_from_hf_json`` reads back)."""
    rs = config.rope_scaling
    hf = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads,
        "num_key_value_heads": config.num_kv_heads,
        "head_dim": config.head_dim,
        "rms_norm_eps": config.rms_norm_eps,
        "rope_theta": config.rope_theta,
        "rope_scaling": None if rs is None else {
            "rope_type": "llama3", "factor": rs.factor, "low_freq_factor": rs.low_freq_factor,
            "high_freq_factor": rs.high_freq_factor,
            "original_max_position_embeddings": rs.original_max_position_embeddings,
        },
        "max_position_embeddings": config.max_seq_len,
        "tie_word_embeddings": config.tie_word_embeddings,
        "bos_token_id": config.bos_token_id,
        "eos_token_id": list(config.eos_token_ids),
        "torch_dtype": "bfloat16",
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "config.json")
    with open(path, "w") as f:
        json.dump(hf, f, indent=2)
    return path
