"""The plain reference models, in float32 with TF32 off: bge-m3 (XLM-R
large: post-LN blocks, exact GELU, CLS pooling, L2 norm) and the Mistral
decoder (pre-norm RMSNorm, RoPE by halves without scaling, grouped-query
attention, SwiGLU, untied head), as the published configurations describe
them.

The weights are drawn again from the seed (``benchmark/weights.py``) one
layer at a time, in bf16 as they are served, and widened to float32, so
nothing of the program is read. The decoder runs every sequence through a
layer before it draws the next, and attends in blocks of queries, so it
fits beside nothing else on the card once the program is gone.

``quant="fp8"`` is the control, the nearest precision below the bf16 the
configurations state: the same computation with both operands of every
projection and of the head, and the decoder's keys and values, rounded to
fp8 (e4m3) with one scale per row (a weight's output channel, a token's
activations, a token and head's key or value).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from benchmark import weights as W


def exact_fp32() -> None:
    """Plain float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 (e4m3) per row: its last axis shares one scale
    that maps the row's largest magnitude to e4m3's largest, 448."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _act(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """A matmul's activation operand, in the control's precision."""
    return _fp8_rows(x) if quant == "fp8" else x


def _weight(seed: int, name: str, shape, device, quant: Optional[str]) -> torch.Tensor:
    w = W.draw(seed, name, shape, torch.bfloat16, device).float()
    if quant == "fp8" and len(shape) == 2 and "embed" not in name and "embeddings" not in name:
        w = _fp8_rows(w)
    return w


# --------------------------------------------------------------------------
# bge-m3
# --------------------------------------------------------------------------
def _layer_norm(x, w, b, eps):
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), w, b, eps)


@torch.no_grad()
def embed(cfg: Dict, seed: int, token_lists: Sequence[Sequence[int]], device, block: int = 1024,
          quant: Optional[str] = None) -> torch.Tensor:
    """``[N, hidden]`` float64 unit vectors, one per token list (each whole,
    unpadded)."""
    exact_fp32()
    shapes = W.encoder_shapes(cfg)
    p = {n: _weight(seed, n, s, device, quant) for n, s in shapes.items()}
    D, H, eps = cfg["hidden_size"], cfg["num_attention_heads"], cfg["layer_norm_eps"]
    hd, pad = D // H, cfg["pad_token_id"]
    out = []
    for ids in token_lists:
        t = torch.tensor(list(ids), device=device)
        n = t.shape[0]
        pos = torch.arange(n, device=device) + pad + 1
        h = p["word_embeddings.weight"][t] + p["position_embeddings.weight"][pos] + p["token_type_embeddings.weight"][0]
        h = _layer_norm(h, p["embed_ln.weight"], p["embed_ln.bias"], eps)
        for i in range(cfg["num_hidden_layers"]):
            g = lambda k: p[f"layers.{i}.{k}"]  # noqa: E731
            x = _act(h, quant)
            q = (x @ g("wq.weight").T + g("wq.bias")).view(n, H, hd).transpose(0, 1)
            k = (x @ g("wk.weight").T + g("wk.bias")).view(n, H, hd).transpose(0, 1)
            v = (x @ g("wv.weight").T + g("wv.bias")).view(n, H, hd).transpose(0, 1)
            ctx = torch.empty_like(q)
            for a in range(0, n, block):
                s = (q[:, a : a + block] @ k.transpose(1, 2)) / math.sqrt(hd)
                ctx[:, a : a + block] = torch.softmax(s, dim=-1) @ v
            attn = _act(ctx.transpose(0, 1).reshape(n, D), quant) @ g("wo.weight").T + g("wo.bias")
            h = _layer_norm(h + attn, g("attn_ln.weight"), g("attn_ln.bias"), eps)
            inner = torch.nn.functional.gelu(_act(h, quant) @ g("w_in.weight").T + g("w_in.bias"))
            ffn = _act(inner, quant) @ g("w_out.weight").T + g("w_out.bias")
            h = _layer_norm(h + ffn, g("ffn_ln.weight"), g("ffn_ln.bias"), eps)
        cls = h[0].double()
        out.append(cls / cls.norm())
    return torch.stack(out)


# --------------------------------------------------------------------------
# the decoder
# --------------------------------------------------------------------------
def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w


def _rope_tables(n: int, hd: int, theta: float, device):
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=device) / hd))
    ph = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv[None, :]
    return torch.cos(ph).float(), torch.sin(ph).float()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x [n, heads, hd]`` rotated by halves (dim ``i`` with ``i + hd/2``)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _causal_gqa(q, k, v, block: int) -> torch.Tensor:
    """``q [n, H, hd]``, ``k, v [n, K, hd]`` -> ``[n, H * hd]``, causal."""
    n, H, hd = q.shape
    K = k.shape[1]
    G = H // K
    qg = q.view(n, K, G, hd).permute(1, 2, 0, 3)  # [K, G, n, hd]
    kt, vt = k.permute(1, 2, 0), v.permute(1, 0, 2)  # [K, hd, n], [K, n, hd]
    out = torch.empty_like(qg)
    for a in range(0, n, block):
        b = min(n, a + block)
        s = (qg[:, :, a:b] @ kt[:, None, :, :b]) / math.sqrt(hd)  # [K, G, b-a, b]
        i = torch.arange(a, b, device=q.device)[:, None]
        j = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(j > i, float("-inf"))
        out[:, :, a:b] = torch.softmax(s, dim=-1) @ vt[:, None, :b]
    return out.permute(2, 0, 1, 3).reshape(n, H * hd)


@torch.no_grad()
def decoder_logits(cfg: Dict, seed: int, seqs: Sequence[Sequence[int]], want: Sequence[Sequence[int]],
                   device, quant: Optional[str] = None, block: int = 512, rows: int = 2048) -> List[torch.Tensor]:
    """Logits ``[len(want[i]), vocab]`` (float32) at positions ``want[i]`` of
    sequence ``seqs[i]``, each sequence read from its position 0."""
    exact_fp32()
    shapes = W.decoder_shapes(cfg)
    D, I = cfg["hidden_size"], cfg["intermediate_size"]
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or D // H
    eps = cfg["rms_norm_eps"]
    emb = W.draw(seed, "embed.weight", shapes["embed.weight"], torch.bfloat16, device)
    hs = [emb[torch.tensor(list(s), device=device)].float() for s in seqs]
    del emb
    n_max = max(len(s) for s in seqs)
    cos, sin = _rope_tables(n_max, hd, float(cfg["rope_theta"]), device)
    for li in range(cfg["num_hidden_layers"]):
        pre = f"layers.{li}."
        w = {n[len(pre):]: _weight(seed, n, shapes[n], device, quant) for n in W.layer_names(shapes, li)}
        for si, h in enumerate(hs):
            n = h.shape[0]
            x = _act(_rms(h, w["input_norm.weight"], eps), quant)
            qkv = x @ w["attn.wqkv.weight"].T
            q, k, v = qkv.split([H * hd, K * hd, K * hd], dim=-1)
            q = _rope(q.reshape(n, H, hd), cos[:n], sin[:n])
            k = _rope(k.reshape(n, K, hd), cos[:n], sin[:n])
            v = v.reshape(n, K, hd)
            if quant == "fp8":
                k, v = _fp8_rows(k), _fp8_rows(v)
            h = h + _act(_causal_gqa(q, k, v, block), quant) @ w["attn.wo.weight"].T
            for a in range(0, n, rows):
                x = _act(_rms(h[a : a + rows], w["post_attn_norm.weight"], eps), quant)
                gate, up = (x @ w["mlp.w_gateup.weight"].T).split([I, I], dim=-1)
                h[a : a + rows] += _act(torch.nn.functional.silu(gate) * up, quant) @ w["mlp.w_down.weight"].T
            hs[si] = h
        del w
    fnorm = W.draw(seed, "final_norm.weight", shapes["final_norm.weight"], torch.bfloat16, device).float()
    head = _weight(seed, "lm_head.weight", shapes["lm_head.weight"], device, quant)
    out = []
    for h, pos in zip(hs, want):
        x = _rms(h[torch.tensor(list(pos), device=device, dtype=torch.long)], fnorm, eps)
        out.append(_act(x, quant) @ head.T)
    return out
