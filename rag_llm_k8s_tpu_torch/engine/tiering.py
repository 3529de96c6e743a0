"""Hotness-aware KV tiering primitives, counterpart of
``rag_llm_k8s_tpu/engine/tiering.py``.

- :class:`HotnessTracker`: an exponentially decayed hit score per chunk
  key, fed by prefix-cache resolves. Every tier decision reads it: hot
  chunks keep their native dtype, warm ones are quantized to int8 in place,
  cold ones spill to host memory.
- :class:`HostSpillStore`: a byte-budgeted host store of spilled chunk
  planes. The JAX store holds numpy copies; a bf16 tensor has no numpy
  dtype, so this one holds CPU tensors (pinned when they came from the
  card, so the swap-in is one DMA) and counts the same bytes, so its budget
  evicts the same entries.
- ``quantize_planes`` / ``dequantize_planes``: the warm tier's conversion of
  a ``(k, v)`` plane pair to int8 payloads with one fp32 scale per (token,
  kv head) vector, the layout the ``_q8`` kernels read (``quantize_kv``).

The tier policy lives with the cache that owns the entries
(``engine/prefix_cache.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

import torch

from rag_llm_k8s_tpu_torch.obs import flight
from rag_llm_k8s_tpu_torch.ops.attention import quantize_kv

__all__ = [
    "TIERS",
    "HotnessTracker",
    "HostSpillStore",
    "quantize_planes",
    "dequantize_planes",
    "host_copy",
]

TIERS = ("hot", "warm", "cold")


class HotnessTracker:
    """Decayed hit frequency per chunk key: ``touch(key, w)`` adds ``w``;
    a score is ``raw * 2^(-age / half_life)``, evaluated when read.
    Thread-safe; the clock is injectable."""

    def __init__(self, half_life_s: float = 60.0, clock=time.monotonic):
        if half_life_s <= 0:
            raise ValueError(f"half_life_s={half_life_s}: expected > 0")
        self.half_life_s = float(half_life_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._scores: Dict[object, Tuple[float, float]] = {}  # key -> (raw, t)

    def _decayed(self, raw: float, t: float, now: float) -> float:
        return raw * 2.0 ** (-(now - t) / self.half_life_s)

    def touch(self, key, weight: float = 1.0) -> float:
        """Record a use; returns the key's new (decayed) score."""
        now = self._clock()
        with self._lock:
            raw, t = self._scores.get(key, (0.0, now))
            score = self._decayed(raw, t, now) + float(weight)
            self._scores[key] = (score, now)
            return score

    def score(self, key) -> float:
        now = self._clock()
        with self._lock:
            entry = self._scores.get(key)
            if entry is None:
                return 0.0
            return self._decayed(entry[0], entry[1], now)

    def forget(self, key) -> None:
        with self._lock:
            self._scores.pop(key, None)

    def prune(self, floor: float = 1e-3) -> int:
        """Drop keys whose decayed score fell under ``floor``; returns how
        many."""
        now = self._clock()
        with self._lock:
            dead = [k for k, (raw, t) in self._scores.items() if self._decayed(raw, t, now) < floor]
            for k in dead:
                del self._scores[k]
            return len(dead)

    def __len__(self) -> int:
        with self._lock:
            return len(self._scores)


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` that nothing else holds: pinned when ``t`` lives
    on the card, a clone when it is already on the CPU."""
    if t.device.type == "cpu":
        return t.detach().clone()
    out = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=True)
    out.copy_(t.detach())
    return out


class HostSpillStore:
    """Byte-budgeted host store of cold-spilled chunk planes, with opaque
    metadata the owning cache round-trips. Inserts past the budget evict
    oldest first (the entry being inserted is never its own victim).
    Thread-safe."""

    def __init__(self, budget_mb: int = 1024):
        if budget_mb < 1:
            raise ValueError(f"budget_mb={budget_mb}: expected >= 1")
        self.budget_bytes = int(budget_mb) * (1 << 20)
        self._lock = threading.Lock()
        self._data: Dict[object, Tuple[Tuple[torch.Tensor, ...], dict, int]] = {}
        self._order: list = []  # insertion order, oldest first
        self.bytes = 0
        self.spills = 0
        self.evictions = 0

    def put(self, key, planes: Tuple, meta: Optional[dict] = None) -> int:
        """Store host copies of ``planes`` (tensors already on the host are
        kept as given); returns the bytes now held for the key."""
        host = tuple(p if p.device.type == "cpu" else host_copy(p) for p in planes)
        nbytes = int(sum(p.nbytes for p in host))
        evicted = 0
        with self._lock:
            self._drop_locked(key)
            self._data[key] = (host, dict(meta or {}), nbytes)
            self._order.append(key)
            self.bytes += nbytes
            self.spills += 1
            while self.bytes > self.budget_bytes and len(self._order) > 1:
                victim = self._order[0]
                if victim == key:
                    break
                self._drop_locked(victim)
                self.evictions += 1
                evicted += 1
        if evicted:
            flight.emit("host_spill_evict", evicted=evicted, bytes=self.bytes)
        return nbytes

    def get(self, key) -> Optional[Tuple[Tuple[torch.Tensor, ...], dict]]:
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                return None
            return entry[0], dict(entry[1])

    def _drop_locked(self, key) -> bool:
        entry = self._data.pop(key, None)
        if entry is None:
            return False
        try:
            self._order.remove(key)
        except ValueError:
            pass
        self.bytes -= entry[2]
        return True

    def drop(self, key) -> bool:
        """Release one spilled entry's host buffer."""
        with self._lock:
            return self._drop_locked(key)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._order.clear()
            self.bytes = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._data

    def manifest(self) -> list:
        """``{key, nbytes, meta}`` per spilled entry, oldest first."""
        with self._lock:
            return [
                {"key": key, "nbytes": self._data[key][2], "meta": dict(self._data[key][1])}
                for key in self._order
            ]


def quantize_planes(planes: Tuple) -> Optional[Tuple]:
    """Warm-tier conversion of ``(k, v)`` to ``(k_q, v_q, k_scale, v_scale)``
    (int8 payloads, one fp32 scale per vector), with no re-prefill. None when
    the tuple is already int8 (an int8-KV engine's entries: warm is a label
    there)."""
    if len(planes) != 2:
        return None
    k, v = planes
    if k.dtype == torch.int8:
        return None
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return kq, vq, ks, vs


def dequantize_planes(planes: Tuple, dtype: torch.dtype) -> Tuple:
    """Inverse of :func:`quantize_planes`: ``(k, v)`` in ``dtype`` from a
    warm entry's payloads and scales (a native pair passes through)."""
    if len(planes) == 2:
        return planes
    kq, vq, ks, vs = planes
    return (
        (kq.float() * ks[..., None]).to(dtype),
        (vq.float() * vs[..., None]).to(dtype),
    )
