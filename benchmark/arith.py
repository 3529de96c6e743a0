"""Operations, bytes and peaks: what the benchmark counts from shapes.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit (dense,
no sparsity): 989 TFLOP/s in bf16, 3.35 TB/s of HBM. A run prints the
card's own power limit beside every share of them.

A decoder token's model FLOPs are two per weight it multiplies (the q, k,
v, o, gate, up and down projections of every layer), plus the attention
over its context (``4 * heads * head_dim`` per key it attends to: QK and
PV), plus the head for a token whose logits are computed. Attention bytes
count each input byte once: the query and output rows and the K and V rows
of the window each row attends over, in bf16.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def dims(cfg: Dict) -> Dict[str, int]:
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"L": cfg["num_hidden_layers"], "D": D, "I": cfg["intermediate_size"], "H": H,
            "K": cfg["num_key_value_heads"], "hd": cfg.get("head_dim") or D // H, "V": cfg["vocab_size"]}


def layer_matmul_flops_per_token(cfg: Dict) -> int:
    d = dims(cfg)
    D, I, H, K, hd = d["D"], d["I"], d["H"], d["K"], d["hd"]
    return 2 * (D * (H + 2 * K) * hd + H * hd * D + 3 * D * I)


def attention_flops(cfg: Dict, keys: int) -> int:
    """One query row over ``keys`` keys, all heads of one layer."""
    d = dims(cfg)
    return 4 * d["H"] * d["hd"] * keys


def sequence_flops(cfg: Dict, prompt: int, answer: int) -> int:
    """Model FLOPs of one request: its ``prompt`` tokens prefilled (causal)
    and its ``answer`` tokens, each of which also takes the head."""
    d = dims(cfg)
    n = prompt + answer
    per_tok = d["L"] * layer_matmul_flops_per_token(cfg)
    attn = d["L"] * attention_flops(cfg, 1) * (n * (n + 1) // 2)
    head = 2 * d["D"] * d["V"] * answer
    return n * per_tok + attn + head


def decode_attention_cost(cfg: Dict, keys_per_row: Sequence[int]):
    """``(flops, bytes)`` of one ``decode_attention`` call (one layer, one
    query per row) with ``keys_per_row[b]`` keys in row ``b``'s window."""
    d = dims(cfg)
    B, H, K, hd = len(keys_per_row), d["H"], d["K"], d["hd"]
    keys = sum(keys_per_row)
    flops = 4 * H * hd * keys
    nbytes = BF16 * (2 * B * H * hd + 2 * K * hd * keys)
    return flops, nbytes


def chunk_attention_cost(cfg: Dict, starts: Sequence[int], wi: int, chunk: int,
                         lens: Optional[Sequence[int]] = None):
    """``(flops, bytes)`` of one ``chunk_prefill_attention`` call (one
    layer): queries ``[wi, wi + chunk)`` of each row, causal over that row's
    real keys ``[starts[b], min(q + 1, lens[b]))`` (``lens`` defaults to
    ``wi + chunk``); query rows before ``starts[b]`` are padding and need
    nothing."""
    d = dims(cfg)
    H, K, hd = d["H"], d["K"], d["hd"]
    flops = nbytes = 0
    for b, ks in enumerate(starts):
        q0 = max(wi, ks)
        q1 = wi + chunk
        if q1 <= q0:
            continue
        kl = q1 if lens is None else min(q1, int(lens[b]))
        nq = q1 - q0
        # keys of query q: min(q + 1, kl) - ks; causal up to kl, flat after
        cut = min(max(kl - 1, q0), q1)  # queries [q0, cut) see q + 1 - ks keys
        keys = (q0 - ks + 1 + cut - ks) * (cut - q0) // 2 + (q1 - cut) * max(0, kl - ks)
        flops += 4 * H * hd * keys
        nbytes += BF16 * (2 * nq * H * hd + 2 * K * hd * max(0, kl - ks))
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
