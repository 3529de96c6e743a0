"""Per-device telemetry on ``torch.cuda``, the port's counterpart of
``rag_llm_k8s_tpu/obs/devices.py``: allocator occupancy and prefix-cache
residency gauges, each family labeled by device index.

- ``rag_device_hbm_bytes_in_use`` — the caching allocator's live bytes,
  ``torch.cuda.memory_stats(d)["allocated_bytes.all.current"]`` (what
  ``torch.cuda.memory_allocated(d)`` reads), at collect time;
- ``rag_device_hbm_bytes_limit`` — the card's memory,
  ``torch.cuda.get_device_properties(d).total_memory``. PyTorch's
  allocator has no byte limit of its own unless one is set
  (``torch.cuda.set_per_process_memory_fraction``), so the card's total is
  the limit an allocation runs into;
- ``rag_prefix_cache_device_bytes`` — the prefix cache's resident KV per
  device (``PrefixCache.bytes_by_device``).

Neither read syncs the card: ``memory_stats`` reads the allocator's host
counters and the device properties are cached. A service on the CPU (the
tests) exports one ``device="0"`` child per family reading 0, as the JAX
service's CPU device does, so the label sets match.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from rag_llm_k8s_tpu_torch.obs import metrics as obs_metrics

__all__ = ["register_device_gauges", "local_devices"]


def local_devices(device: Optional[torch.device] = None) -> List[int]:
    """The indices of the cards the service runs on: every visible CUDA
    device when ``device`` is a CUDA device, else ``[0]`` (the one CPU
    device, whose gauges read 0)."""
    if device is not None and device.type == "cuda" and torch.cuda.is_available():
        return list(range(torch.cuda.device_count()))
    return [0]


def _memory_stat(device: Optional[torch.device], index: int, key: str) -> float:
    """One allocator figure, 0.0 on the CPU or when the read fails (a probe
    must not fail a scrape)."""
    if device is None or device.type != "cuda":
        return 0.0
    try:
        if key == "bytes_limit":
            return float(torch.cuda.get_device_properties(index).total_memory)
        return float(torch.cuda.memory_stats(index).get("allocated_bytes.all.current", 0))
    except Exception:  # noqa: BLE001 — a probe must not 500 /metrics
        return 0.0


def register_device_gauges(
    registry: obs_metrics.MetricsRegistry,
    prefix_bytes_fn: Optional[Callable[[], Dict[int, int]]] = None,
    device: Optional[torch.device] = None,
) -> int:
    """Register the per-device families on ``registry`` for the service
    running on ``device``; returns the device count. ``prefix_bytes_fn``
    returns ``{device_index: bytes}`` for the prefix cache (None or empty
    reads zeros, keeping the family present)."""
    indices = local_devices(device)
    use_fam = registry.labeled_gauge(
        "rag_device_hbm_bytes_in_use",
        "allocator bytes in use per device (0 on CPU/backends without "
        "memory_stats)",
    )
    lim_fam = registry.labeled_gauge(
        "rag_device_hbm_bytes_limit", "allocator byte limit per device"
    )
    pc_fam = registry.labeled_gauge(
        "rag_prefix_cache_device_bytes",
        "KV prefix-cache bytes resident per device",
    )
    fn = prefix_bytes_fn or (lambda: {})
    for i in indices:
        use_fam.labels_callback(lambda i=i: _memory_stat(device, i, "bytes_in_use"), device=str(i))
        lim_fam.labels_callback(lambda i=i: _memory_stat(device, i, "bytes_limit"), device=str(i))
        pc_fam.labels_callback(lambda i=i, fn=fn: float(fn().get(i, 0)), device=str(i))
    return len(indices)
