"""bge-m3 embedding encoder (XLM-RoBERTa-large backbone) in PyTorch,
counterpart of ``rag_llm_k8s_tpu/models/bge_m3.py``.

Post-LN BERT blocks; learned positions with the XLM-R pad offset (position
id = cumsum(non-pad) + pad_id); one token type; attention through the
port's ``flash_attention(causal=False, kv_len=...)`` over right-padded rows;
CLS pooling, then L2 normalisation. The GELU depends on the dtype as in the
JAX package: bf16 uses the tanh approximation, fp32 the exact erf form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rag_llm_k8s_tpu_torch.core.config import DTypePolicy, EncoderConfig
from rag_llm_k8s_tpu_torch.ops.attention import flash_attention


def xlmr_position_ids(tokens: torch.Tensor, pad_id: int) -> torch.Tensor:
    """Pads get ``pad_id``; token ``t`` gets its cumulative non-pad count + pad_id."""
    mask = (tokens != pad_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_id


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtypes: DTypePolicy):
        super().__init__()
        self.eps = eps
        self.out_dtype = dtypes.compute_dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtypes.param_dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtypes.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(self.out_dtype)


class EncoderBlock(nn.Module):
    def __init__(self, config: EncoderConfig, dtypes: DTypePolicy):
        super().__init__()
        D, I = config.hidden_size, config.intermediate_size
        self.config, self.dtypes = config, dtypes
        lin = lambda i, o: nn.Linear(i, o, bias=True, dtype=dtypes.param_dtype)  # noqa: E731
        self.wq, self.wk, self.wv, self.wo = lin(D, D), lin(D, D), lin(D, D), lin(D, D)
        self.attn_ln = LayerNorm(D, config.layer_norm_eps, dtypes)
        self.w_in, self.w_out = lin(D, I), lin(I, D)
        self.ffn_ln = LayerNorm(D, config.layer_norm_eps, dtypes)

    def forward(self, h: torch.Tensor, kv_len: torch.Tensor) -> torch.Tensor:
        c, dt = self.config, self.dtypes
        B, S, D = h.shape
        H = c.num_heads
        hd = D // H
        q = self.wq(h).reshape(B, S, H, hd)
        k = self.wk(h).reshape(B, S, H, hd)
        v = self.wv(h).reshape(B, S, H, hd)
        # right-padded rows window via kv_len; padded query rows compute
        # values that CLS pooling never reads
        ctx = flash_attention(q, k, v, kv_len=kv_len, causal=False)
        h = self.attn_ln(h + self.wo(ctx.to(dt.compute_dtype).reshape(B, S, D)))
        inner = self.w_in(h)
        if dt.compute_dtype == torch.bfloat16:
            inner = F.gelu(inner, approximate="tanh")
        else:
            inner = F.gelu(inner.float()).to(dt.compute_dtype)
        return self.ffn_ln(h + self.w_out(inner))


class BgeM3Encoder(nn.Module):
    """``(tokens [B,S], mask [B,S]) -> [B, embed_dim]`` fp32 unit vectors."""

    def __init__(self, config: EncoderConfig, dtypes: DTypePolicy = DTypePolicy()):
        super().__init__()
        c = config
        self.config, self.dtypes = c, dtypes
        pd = dtypes.param_dtype
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size, dtype=pd)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size, dtype=pd)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size, dtype=pd)
        self.embed_ln = LayerNorm(c.hidden_size, c.layer_norm_eps, dtypes)
        self.layers = nn.ModuleList(EncoderBlock(c, dtypes) for _ in range(c.num_layers))

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c = self.config
        pos_ids = xlmr_position_ids(tokens, c.pad_token_id)
        h = (
            self.word_embeddings(tokens)
            + self.position_embeddings(pos_ids)
            + self.token_type_embeddings.weight[0][None, None, :]
        ).to(self.dtypes.compute_dtype)
        h = self.embed_ln(h)
        kv_len = mask.sum(dim=-1).to(torch.int32)
        for blk in self.layers:
            h = blk(h, kv_len)
        cls = h[:, 0, :].float()
        return cls / cls.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def build_encoder(config: EncoderConfig, dtypes: DTypePolicy, device: torch.device) -> BgeM3Encoder:
    """An uninitialized encoder on ``device``; fill it with
    ``convert.load_encoder`` or ``convert.init_random_``."""
    with torch.device("meta"):
        model = BgeM3Encoder(config, dtypes)
    return model.to_empty(device=device).requires_grad_(False).eval()
