"""Weight loading: HF safetensors → the port's modules, the counterpart of
``rag_llm_k8s_tpu/models/loader.py``.

The product stages ``model-0000x-of-0000n.safetensors`` plus ``config.json``
and ``tokenizer.json`` (the reference's ``download_model.py``) and bge-m3
under ``bge-m3/``. Tensors are read one at a time (``utils/safetensors_io``)
and copied into an unfilled model on the device, so the host holds one
tensor, never the checkpoint.

HF names map onto the port's parameters one to one. PyTorch keeps HF's
``[out, in]`` layout, so nothing is transposed, and nothing is permuted (the
JAX loader only transposes):

    model.embed_tokens.weight                     -> embed.weight
    model.layers.{i}.self_attn.{q,k,v,o}_proj.weight -> layers.{i}.attn.w{q,k,v,o}.weight
    model.layers.{i}.mlp.{gate,up,down}_proj.weight  -> layers.{i}.mlp.w_{gate,up,down}.weight
    model.layers.{i}.input_layernorm.weight       -> layers.{i}.input_norm.weight
    model.layers.{i}.post_attention_layernorm.weight -> layers.{i}.post_attn_norm.weight
    model.norm.weight                             -> final_norm.weight
    lm_head.weight                                -> lm_head.weight (absent when tied)

The model comes back unfused; ``InferenceEngine`` fuses q|k|v and gate|up
(``models.llama.fuse_projections_``).

``quant="int8"`` quantizes each projection and the logit head (untied
``lm_head``, or the tied embedding) on the host as it streams, with
``quantize_np``, the twin of the JAX loader's ``_quantize_np``: the int8
weights and fp32 scales equal the JAX loader's bit for bit, and bf16
projection weights never exist on the card. (They differ from
``models.llama.quantize_weight``, which copies the compiled JAX quantizer.)

On a mesh (``mesh``) each tensor goes through the streaming put
(``parallel.sharding.make_streaming_put``): read, quantized when int8
(whole, so a row-parallel weight's scales are its whole rows'), sliced to
this rank's shard and cast on the host, then copied to the card, so no
rank holds the whole model on its device.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Mapping, Set, Tuple

import numpy as np
import torch

from rag_llm_k8s_tpu_torch.core.config import (
    DTypePolicy,
    EncoderConfig,
    LlamaConfig,
    RopeScalingConfig,
)
from rag_llm_k8s_tpu_torch.core.device import DeviceLike, resolve_device
from rag_llm_k8s_tpu_torch.models.bge_m3 import BgeM3Encoder, build_encoder
from rag_llm_k8s_tpu_torch.models.llama import LlamaModel, build_llama
from rag_llm_k8s_tpu_torch.utils.safetensors_io import LazyStateDict

# HF suffix under model.layers.{i}. -> (port name under layers.{i}., int8 when quantized?)
_LAYER_MAP = {
    "self_attn.q_proj.weight": ("attn.wq", True),
    "self_attn.k_proj.weight": ("attn.wk", True),
    "self_attn.v_proj.weight": ("attn.wv", True),
    "self_attn.o_proj.weight": ("attn.wo", True),
    "mlp.gate_proj.weight": ("mlp.w_gate", True),
    "mlp.up_proj.weight": ("mlp.w_up", True),
    "mlp.down_proj.weight": ("mlp.w_down", True),
    "input_layernorm.weight": ("input_norm", False),
    "post_attention_layernorm.weight": ("post_attn_norm", False),
}

_TOP_MAP = {
    "model.embed_tokens.weight": "embed",
    "model.norm.weight": "final_norm",
    "lm_head.weight": "lm_head",
}


def _as_tensor(value) -> torch.Tensor:
    """A CPU tensor from a torch tensor or a numpy array (an ml_dtypes
    bfloat16 array is taken by its bits)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu")
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def quantize_np(w: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side symmetric per-output-channel int8 of ``w [out, in]``: the
    JAX loader's ``_quantize_np`` (``s = max(max|w| / 127.0, 1e-8)``, then
    ``np.round(w / s)`` in fp32), on ``w``'s rows. Chunked as there, so the
    fp32 transient stays near 64 MB whatever the tensor's size. Returns
    ``(int8 [out, in], fp32 [out])``."""
    out_n, in_n = w.shape
    out_q = np.empty((out_n, in_n), np.int8)
    scales = np.empty(out_n, np.float32)
    step = max(1, (64 << 20) // max(in_n * 4, 1))
    for c0 in range(0, out_n, step):
        c1 = min(c0 + step, out_n)
        wf = w[c0:c1].to(torch.float32).numpy()
        s = np.maximum(np.abs(wf).max(axis=1) / 127.0, 1e-8)
        out_q[c0:c1] = np.round(wf / np.expand_dims(s, 1))
        scales[c0:c1] = s
    return out_q, scales


def _check_names(names: Set[str], expected: Set[str], tied: bool) -> None:
    """The JAX loader's key-surface checks, with its messages."""
    unknown = {n for n in names - expected if not n.endswith("rotary_emb.inv_freq")}
    if unknown:
        raise KeyError(f"unrecognized HF params: {sorted(unknown)[:5]} ...")
    missing = expected - names
    if tied:
        missing.discard("lm_head.weight")
    if missing:
        raise ValueError(f"missing HF params: {sorted(missing)[:5]} ...")


class _Filler:
    """Copies host tensors into an unfilled model's parameters by name and
    checks at the end that every parameter was written."""

    def __init__(self, model: torch.nn.Module):
        self.params = dict(model.named_parameters())
        self.done: Set[str] = set()

    @torch.no_grad()
    def put(self, name: str, value) -> None:
        p = self.params[name]
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(value)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != model shape {tuple(p.shape)}")
        p.copy_(t.to(dtype=p.dtype) if t.dtype != p.dtype else t)
        self.done.add(name)

    def check(self) -> None:
        left = sorted(set(self.params) - self.done)
        if left:
            raise RuntimeError(f"parameters left unfilled by the checkpoint: {left[:5]}")


def convert_hf_state_dict(
    state_dict: Mapping,
    config: LlamaConfig,
    dtypes: DTypePolicy = DTypePolicy(),
    device: DeviceLike = None,
    quant: str = "bf16",
    mesh=None,
) -> LlamaModel:
    """A flat HF Llama state dict → an unfused ``LlamaModel`` on ``device``
    (this rank's shard of it with ``mesh``).

    ``state_dict`` is any mapping with ``keys()`` and ``__getitem__`` whose
    values are torch tensors or numpy arrays: a plain dict, or
    ``LazyStateDict`` over safetensors shards. Each tensor is read, placed
    and dropped in turn. ``quant="int8"`` builds the int8 layout
    (``QuantLinear`` projections and head; ``QuantEmbedding`` when tied) from
    ``quantize_np``; the norms and an untied embedding stay in
    ``dtypes.param_dtype``.
    """
    if quant not in ("bf16", "int8"):
        raise ValueError(f"quant={quant!r}: expected 'bf16' or 'int8'")
    dev = resolve_device(device)
    L = config.num_layers
    tied = config.tie_word_embeddings

    expected = set(_TOP_MAP)
    if tied:
        expected.discard("lm_head.weight")
    for i in range(L):
        for suffix in _LAYER_MAP:
            expected.add(f"model.layers.{i}.{suffix}")
    _check_names(set(state_dict.keys()), expected, tied)

    int8 = quant == "int8"
    model = build_llama(config, dtypes, dev, fused=False, quantized=int8, mesh=mesh)
    fill = _Filler(model)
    if mesh is not None and mesh.tp > 1:
        from rag_llm_k8s_tpu_torch.parallel.sharding import make_streaming_put

        put = make_streaming_put(mesh, config, dtypes.param_dtype, quantized=int8)
    else:
        put = lambda name, t: t  # noqa: E731

    def place(module: str, hf_name: str, quantized: bool) -> None:
        w = _as_tensor(state_dict[hf_name])
        if quantized:
            q, s = quantize_np(w)
            del w
            for name, t in ((f"{module}.weight", q), (f"{module}.scale", s)):
                fill.put(name, put(name, torch.from_numpy(t)))
        else:
            fill.put(f"{module}.weight", put(f"{module}.weight", w))

    for hf_name, module in _TOP_MAP.items():
        if hf_name == "lm_head.weight" and tied:
            continue
        # the head's rows are logit channels: the untied lm_head, or the
        # tied embedding, is int8; an untied embedding (gather-only) is not
        head = module == "lm_head" or (module == "embed" and tied)
        place(module, hf_name, int8 and head)
    for i in range(L):
        for suffix, (module, is_proj) in _LAYER_MAP.items():
            place(f"layers.{i}.{module}", f"model.layers.{i}.{suffix}", int8 and is_proj)
    fill.check()
    return model


def _shards(model_dir: str):
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {model_dir}")
    return files


def load_safetensors_params(
    model_dir: str,
    config: LlamaConfig,
    dtypes: DTypePolicy = DTypePolicy(),
    device: DeviceLike = None,
    quant: str = "bf16",
    mesh=None,
) -> LlamaModel:
    """Every ``*.safetensors`` shard under ``model_dir`` → ``LlamaModel``
    (this rank's shard with ``mesh``), streamed tensor by tensor (see
    :func:`convert_hf_state_dict`)."""
    return convert_hf_state_dict(LazyStateDict(_shards(model_dir)), config, dtypes, device, quant, mesh)


# ---------------------------------------------------------------------------
# XLM-R / bge-m3 encoder
# ---------------------------------------------------------------------------

# HF module under encoder.layer.{i}. -> port module under layers.{i}.
_XLMR_LAYER_MAP = {
    "attention.self.query": "wq",
    "attention.self.key": "wk",
    "attention.self.value": "wv",
    "attention.output.dense": "wo",
    "intermediate.dense": "w_in",
    "output.dense": "w_out",
    "attention.output.LayerNorm": "attn_ln",
    "output.LayerNorm": "ffn_ln",
}
_XLMR_TOP_MAP = {
    "embeddings.word_embeddings.weight": "word_embeddings.weight",
    "embeddings.position_embeddings.weight": "position_embeddings.weight",
    "embeddings.token_type_embeddings.weight": "token_type_embeddings.weight",
    "embeddings.LayerNorm.weight": "embed_ln.weight",
    "embeddings.LayerNorm.bias": "embed_ln.bias",
}


def convert_xlmr_state_dict(
    state_dict: Mapping,
    config: EncoderConfig,
    dtypes: DTypePolicy = DTypePolicy(),
    device: DeviceLike = None,
) -> BgeM3Encoder:
    """HF ``XLMRobertaModel`` state dict → ``BgeM3Encoder``. Keys may carry
    a ``roberta.`` prefix; the pooler (and anything else unused) is
    skipped."""
    names: Dict[str, str] = {n.removeprefix("roberta."): n for n in state_dict.keys()}
    model = build_encoder(config, dtypes, resolve_device(device))
    fill = _Filler(model)

    def get(name: str) -> torch.Tensor:
        return _as_tensor(state_dict[names[name]])

    for hf_name, port_name in _XLMR_TOP_MAP.items():
        fill.put(port_name, get(hf_name))
    for i in range(config.num_layers):
        for hf_mod, port_mod in _XLMR_LAYER_MAP.items():
            for leaf in ("weight", "bias"):
                fill.put(f"layers.{i}.{port_mod}.{leaf}", get(f"encoder.layer.{i}.{hf_mod}.{leaf}"))
    fill.check()
    return model


def load_encoder_safetensors(
    model_dir: str,
    config: EncoderConfig,
    dtypes: DTypePolicy = DTypePolicy(),
    device: DeviceLike = None,
) -> BgeM3Encoder:
    """A staged bge-m3 / XLM-R checkpoint directory → ``BgeM3Encoder``."""
    return convert_xlmr_state_dict(LazyStateDict(_shards(model_dir)), config, dtypes, device)


def config_from_hf_json(model_dir: str) -> LlamaConfig:
    """``LlamaConfig`` from the staged ``config.json`` (JAX
    ``config_from_hf_json``, field by field)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    rs = hf.get("rope_scaling") or None
    rope_scaling = None
    if rs and rs.get("rope_type", rs.get("type")) == "llama3":
        rope_scaling = RopeScalingConfig(
            factor=rs["factor"],
            low_freq_factor=rs["low_freq_factor"],
            high_freq_factor=rs["high_freq_factor"],
            original_max_position_embeddings=rs["original_max_position_embeddings"],
        )
    eos = hf.get("eos_token_id", 128009)
    eos = tuple(eos) if isinstance(eos, (list, tuple)) else (eos,)
    return LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim", hf["hidden_size"] // hf["num_attention_heads"]),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 500000.0),
        rope_scaling=rope_scaling,
        max_seq_len=hf.get("max_position_embeddings", 131072),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        bos_token_id=hf.get("bos_token_id", 128000),
        eos_token_ids=eos,
    )
