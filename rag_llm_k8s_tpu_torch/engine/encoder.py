"""Batched embedding runner over the bge-m3 encoder, counterpart of
``rag_llm_k8s_tpu/engine/encoder.py``: right-padded, mask-aware batches in
length buckets; one host fetch per ``encode`` call. On a mesh it runs on
rank 0 alone: the JAX package keeps the encoder replicated on every device,
so computing it once gives the same vectors; ``mesh`` is kept for that
reading only."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from rag_llm_k8s_tpu_torch.core.config import EncoderConfig
from rag_llm_k8s_tpu_torch.core.device import DeviceLike, resolve_device
from rag_llm_k8s_tpu_torch.models.bge_m3 import BgeM3Encoder
from rag_llm_k8s_tpu_torch.resilience import faults
from rag_llm_k8s_tpu_torch.utils.buckets import bucket_len, next_pow2
from rag_llm_k8s_tpu_torch.utils.tokens import truncate_keep_eos


class EncoderRunner:
    def __init__(
        self,
        config: EncoderConfig,
        model: BgeM3Encoder,
        device: DeviceLike = None,
        length_buckets: Sequence[int] = (64, 128, 256, 512, 1024, 1536, 2048, 3072, 4096, 8192),
        max_batch: int = 32,
        eos_id: Optional[int] = None,
        mesh=None,
    ):
        self.config = config
        self.model = model
        self.device = resolve_device(device)
        self.mesh = mesh
        # sequences clamped to the largest bucket keep a trailing EOS
        self.eos_id = eos_id
        self.length_buckets = tuple(
            b for b in length_buckets if b <= config.max_encode_len
        ) or (config.max_encode_len,)
        self.max_batch = max_batch

    def prepare_batch(self, ids: Sequence[int]):
        """One bucketed, padded, EOS-preserving ``[1, S]`` (tokens, mask)
        pair — the same rules ``encode`` applies to chunks."""
        S = bucket_len(max(len(ids), 1), self.length_buckets)
        ids = truncate_keep_eos(ids, S, self.eos_id)
        tokens = np.full((1, S), self.config.pad_token_id, np.int64)
        mask = np.zeros((1, S), np.int64)
        tokens[0, : len(ids)] = ids
        mask[0, : len(ids)] = 1
        return tokens, mask

    @torch.inference_mode()
    def embed(self, tokens: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """``[B, S]`` host arrays → ``[B, hidden]`` fp32 unit vectors, left on
        the device."""
        return self.model(
            torch.from_numpy(tokens).to(self.device), torch.from_numpy(mask).to(self.device)
        )

    def encode(self, token_lists: Sequence[Sequence[int]]) -> np.ndarray:
        """Token-id sequences → ``[N, hidden]`` fp32 unit vectors (the
        ``embed`` fault site comes first)."""
        if not token_lists:
            return np.zeros((0, self.config.hidden_size), np.float32)
        faults.maybe_fail("embed")
        order = sorted(range(len(token_lists)), key=lambda i: len(token_lists[i]))
        pad = self.config.pad_token_id
        groups, embs = [], []
        for start in range(0, len(order), self.max_batch):
            group = order[start : start + self.max_batch]
            S = bucket_len(max(len(token_lists[i]) for i in group), self.length_buckets)
            B = next_pow2(len(group))
            tokens = np.full((B, S), pad, np.int64)
            mask = np.zeros((B, S), np.int64)
            for row, i in enumerate(group):
                ids = truncate_keep_eos(token_lists[i], S, self.eos_id)
                tokens[row, : len(ids)] = ids
                mask[row, : len(ids)] = 1
            groups.append(group)
            embs.append(self.embed(tokens, mask)[: len(group)])
        stacked = torch.cat(embs).cpu().numpy()  # one fetch for the whole call
        out = np.zeros((len(token_lists), self.config.hidden_size), np.float32)
        off = 0
        for group in groups:
            out[group] = stacked[off : off + len(group)]
            off += len(group)
        return out
