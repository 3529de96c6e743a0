"""The benchmark's weights and index vectors, defined by the seed alone.

Every tensor has a name, and its values are a pure function of ``(seed,
name, shape, dtype)``: norm weights 1, biases 0, every other weight
N(0, 0.02), drawn on the card by a ``torch.Generator`` seeded from a hash of
the seed and the name, one call per tensor, in the dtype it is served in.
So the harness fills the program's model from the definition, and the
reference, which never sees the program's tensors, draws the same values
again one layer at a time.

The decoder's names are those of the fused layout: ``attn.wqkv`` holds the
rows of q, k and v in that order, ``mlp.w_gateup`` those of gate and up.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

INIT_STD = 0.02


def tensor_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for one named tensor of one run."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()[:8], "little") >> 1


def draw_(t: torch.Tensor, seed: int, name: str) -> torch.Tensor:
    """Fill ``t`` in place with the values the definition gives ``name``."""
    leaf = name.rsplit(".", 1)[-1]
    if "norm" in name or "_ln" in name:
        t.fill_(1.0 if leaf == "weight" else 0.0)
    elif leaf == "bias":
        t.zero_()
    else:
        g = torch.Generator(device=t.device)
        g.manual_seed(tensor_seed(seed, name))
        t.normal_(0.0, INIT_STD, generator=g)
    return t


def draw(seed: int, name: str, shape, dtype: torch.dtype, device) -> torch.Tensor:
    return draw_(torch.empty(tuple(shape), dtype=dtype, device=device), seed, name)


def decoder_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every decoder tensor (``cfg``: the configuration's
    ``model`` numbers under their published keys)."""
    D, I, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or D // H
    out = {"embed.weight": (V, D), "final_norm.weight": (D,), "lm_head.weight": (V, D)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out[p + "input_norm.weight"] = (D,)
        out[p + "post_attn_norm.weight"] = (D,)
        out[p + "attn.wqkv.weight"] = ((H + 2 * K) * hd, D)
        out[p + "attn.wo.weight"] = (D, H * hd)
        out[p + "mlp.w_gateup.weight"] = (2 * I, D)
        out[p + "mlp.w_down.weight"] = (D, I)
    return out


def encoder_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every bge-m3 tensor (``cfg``: the encoder's
    published numbers)."""
    D, I = cfg["hidden_size"], cfg["intermediate_size"]
    out = {
        "word_embeddings.weight": (cfg["vocab_size"], D),
        "position_embeddings.weight": (cfg["max_position_embeddings"], D),
        "token_type_embeddings.weight": (cfg["type_vocab_size"], D),
        "embed_ln.weight": (D,), "embed_ln.bias": (D,),
    }
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        for n, (o, k) in {"wq": (D, D), "wk": (D, D), "wv": (D, D), "wo": (D, D), "w_in": (I, D),
                          "w_out": (D, I)}.items():
            out[p + n + ".weight"] = (o, k)
            out[p + n + ".bias"] = (o,)
        for n in ("attn_ln", "ffn_ln"):
            out[p + n + ".weight"] = (D,)
            out[p + n + ".bias"] = (D,)
    return out


@torch.no_grad()
def fill_model_(model: torch.nn.Module, shapes: Dict[str, Tuple[int, ...]], seed: int) -> None:
    """Fill every parameter of the program's ``model`` from the definition;
    a parameter the definition lacks, or one of another shape, raises."""
    params = dict(model.named_parameters())
    if set(params) != set(shapes):
        raise KeyError(f"model parameters differ from the definition: {sorted(set(params) ^ set(shapes))[:4]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(shapes[name]):
            raise ValueError(f"{name}: shape {tuple(p.shape)} != {shapes[name]}")
        draw_(p.data, seed, name)


def layer_names(shapes: Dict[str, Tuple[int, ...]], i: int) -> List[str]:
    p = f"layers.{i}."
    return [n for n in shapes if n.startswith(p)]


def index_vectors(seed: int, n: int, dim: int, device) -> torch.Tensor:
    """``[n, dim]`` fp32 unit vectors, the index."""
    g = torch.Generator(device=device)
    g.manual_seed(tensor_seed(seed, "index"))
    v = torch.randn((n, dim), generator=g, device=device, dtype=torch.float32)
    return v / v.norm(dim=1, keepdim=True)
