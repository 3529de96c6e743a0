"""The decoder's dense-cache attention calls of a traced slice, recorded as
they are issued, and what the trace says of them: each kernel's share of
its roofline, and the decode step's period while the profiler runs.

``Recorder`` wraps the names ``decode_attention`` and
``chunk_prefill_attention`` in ``models/llama.py``, where the layers look
them up, for a traced run only. From the first layer-0 call after
``start()`` until ``stop()`` it records every call in issue order: the
wrapper, the layer, the generate call it belongs to, its query length, and
its window (``kv_start``, ``kv_len``, the write slot). The window lives on
the card and the loops advance it in place, so a forward's layer 0 copies
it there (a few small copies a step, no wait on the card); the host reads
the copies once the window has closed. Before the first recorded call the
recorder puts a marker kernel (``torch.cuda._sleep``) on the same stream.
Device runs are serialized by the engine's run lock, so the trace's
dense-cache kernels after the marker are the recorded calls, one for one;
the trace ends first (calls issued but not yet run when it stopped are
recorded and not traced).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Optional

from benchmark import arith

WRAPPERS = ("decode_attention", "chunk_prefill_attention")


@dataclass
class AttnCall:
    wrapper: str
    layer: int
    call_no: int  # which generate call (``Capture.started``) issued it
    S: int  # query rows per batch row
    window: list  # [kv_start, kv_len, write slot]: copies on the card, then lists

    def bound_s(self, model) -> float:
        """The least time the call's FLOPs and bytes need at the peaks."""
        ks, kl, wi = self.window
        if self.wrapper == "decode_attention":
            return arith.bound_s(*arith.decode_attention_cost(model, [max(0, b - a) for a, b in zip(ks, kl)]))
        return arith.bound_s(*arith.chunk_attention_cost(model, ks, wi, self.S, lens=kl))


def _copy(x):
    import torch

    if torch.is_tensor(x):
        return x.detach().reshape(-1).clone()
    return x


def _host(x, B: int) -> List[int]:
    import torch

    if x is None:
        return None
    if torch.is_tensor(x):
        v = [int(t) for t in x.cpu().tolist()]
        return v * B if len(v) == 1 and B > 1 else v
    return [int(x)] * B


class Recorder:
    """The wrapper on the model's dense-cache attention (module docstring)."""

    def __init__(self, capture):
        from rag_llm_k8s_tpu_torch.models import llama

        self.llama, self.capture = llama, capture
        self.calls: List[AttnCall] = []
        self.want = self.on = False
        self.inner = {w: getattr(llama, w) for w in WRAPPERS}
        self._window = None
        for w in WRAPPERS:
            setattr(llama, w, self._wrap(w, self.inner[w]))

    def _wrap(self, wrapper: str, inner):
        def call(q, k_cache, v_cache, kv_start, kv_len, layer, *rest, **kw):
            if self.want and not self.on and int(layer) == 0:
                self.on = True
                if q.device.type == "cuda":
                    import torch

                    torch.cuda._sleep(1)
            if self.on:
                if int(layer) == 0:
                    wi = rest[0] if rest else kw.get("write_index", 0)
                    self._window = [_copy(kv_start), _copy(kv_len), _copy(wi)]
                self.calls.append(AttnCall(wrapper, int(layer), self.capture.started, int(q.shape[1]),
                                           self._window))
            return inner(q, k_cache, v_cache, kv_start, kv_len, layer, *rest, **kw)

        return call

    def start(self) -> None:
        """Record from the next forward's first layer on."""
        self.want = True

    def stop(self) -> None:
        self.want = self.on = False

    def uninstall(self) -> None:
        for w in WRAPPERS:
            setattr(self.llama, w, self.inner[w])

    def fetch(self) -> None:
        """Move the recorded windows to the host (after the window)."""
        done = {}
        for c in self.calls:
            key = id(c.window)
            if key not in done:
                ks, kl, wi = c.window
                B = int(ks.numel())
                done[key] = [_host(ks, B), _host(kl, B), _host(wi, 1)[0]]
            c.window = done[key]


def paired(run) -> Optional[list]:
    """``[(recorded call, device start, device seconds)]``: the traced
    dense-cache kernels after the marker zipped with the recorded calls;
    None without a trace or a marker, or where a kernel's wrapper differs
    from the recorded call's (then the pairing would be wrong)."""
    if run.trace is None or run.attn is None:
        return None
    seen = run.trace.kv_calls("DenseKV", after_marker=True)
    if seen is None:
        return None
    out = []
    for (w, t0, dt), c in zip(seen, run.attn):
        if w != c.wrapper:
            print(f"attn_calls: traced kernel {len(out)} is {w}, the recorded call {c.wrapper}", file=sys.stderr)
            return None
        out.append((c, t0, dt))
    return out


def roofline(run, wrapper: str) -> Optional[float]:
    """Percent of the least time over the device time, summed over the
    traced calls of ``wrapper``; None when the trace holds none."""
    pairs = paired(run)
    if pairs is None:
        return None
    bound = dev = 0.0
    for c, _, dt in pairs:
        if c.wrapper == wrapper:
            bound += c.bound_s(run.model)
            dev += dt
    return 100.0 * bound / dev if dev > 0 else None


def traced_step_ms(run) -> Optional[float]:
    """The decode step's period while the profiler runs: the device start
    of each step's layer-0 ``decode_attention`` after the one before it in
    the same generate call, averaged over the traced steps, in ms."""
    pairs = paired(run)
    if pairs is None:
        return None
    firsts = [(c.call_no, t0) for c, t0, _ in pairs if c.wrapper == "decode_attention" and c.layer == 0]
    gaps = [b[1] - a[1] for a, b in zip(firsts, firsts[1:]) if a[0] == b[0]]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
