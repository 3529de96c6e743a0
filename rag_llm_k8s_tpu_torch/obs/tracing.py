"""Request-scoped tracing: the port's copy of ``rag_llm_k8s_tpu/obs/tracing.py``.

Every ``/generate`` request gets a trace id and a tree of stage spans
(retrieve with its tokenize and embed+kNN share, assemble, generate,
detokenize). Spans are recorded in the request thread at the same boundaries
the response's ``timings`` block is measured at, so the span durations and
the timings agree by construction (top-level spans sum to within 5% of
``timings.total_ms``).

Every span body also runs inside ``torch.profiler.record_function(name)``,
so a ``/profile`` capture shows the named stages as ranges over the kernels
they launched. With no profiler running the range is a few microseconds of
host work.

Finished traces are emitted as structured JSON logs (logger
``rag_llm_k8s_tpu_torch.trace``, DEBUG) and kept in an in-memory ring buffer
served by ``GET /debug/traces``; a client posting ``{"trace": true}`` gets
its own tree inline in the response.
"""

from __future__ import annotations

import contextvars
import json
import logging
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from torch.profiler import record_function

logger = logging.getLogger("rag_llm_k8s_tpu_torch.trace")


@dataclass
class Span:
    name: str
    start_s: float  # monotonic
    end_s: Optional[float] = None
    parent: Optional[int] = None  # index into Trace.spans
    attrs: Dict[str, float] = field(default_factory=dict)

    def duration_ms(self) -> float:
        return ((self.end_s if self.end_s is not None else self.start_s)
                - self.start_s) * 1e3


class Trace:
    """One request's span tree. NOT thread-safe on purpose: a trace belongs
    to the request thread that started it (contextvar propagation); stages
    that run on worker threads are accounted for by the request-thread span
    that waits on them (e.g. retrieve-coalesce wait)."""

    def __init__(self, trace_id: Optional[str] = None,
                 parent_span_id: Optional[str] = None):
        # W3C trace-context width (32 lowercase hex — uuid4().hex exactly):
        # the id round-trips through a ``traceparent`` header unchanged, so
        # a UI-originated trace and the server's span tree correlate. The
        # server-side span id identifies THIS hop (obs/logging.py emits it
        # on every structured log line and in the response traceparent).
        self.trace_id = trace_id or uuid.uuid4().hex
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_span_id = parent_span_id
        self.started_at = time.time()
        self.t0 = time.monotonic()
        self.end_s: Optional[float] = None
        self.spans: List[Span] = []
        self._stack: List[int] = []  # open span indices (nesting)
        self.attrs: Dict[str, object] = {}

    # -- recording -------------------------------------------------------
    def begin(self, name: str) -> int:
        parent = self._stack[-1] if self._stack else None
        self.spans.append(Span(name, time.monotonic(), parent=parent))
        idx = len(self.spans) - 1
        self._stack.append(idx)
        return idx

    def end(self, idx: int) -> None:
        self.spans[idx].end_s = time.monotonic()
        if self._stack and self._stack[-1] == idx:
            self._stack.pop()

    def add_span(self, name: str, start_s: float, duration_s: float,
                 parent: Optional[int] = None, **attrs) -> int:
        """Record an already-measured interval (e.g. the tokenize share a
        coalesced worker measured and returned as a number) as a span."""
        if parent is None and self._stack:
            parent = self._stack[-1]
        sp = Span(name, start_s, start_s + duration_s, parent=parent)
        sp.attrs.update({k: float(v) for k, v in attrs.items()})
        self.spans.append(sp)
        return len(self.spans) - 1

    # -- export ----------------------------------------------------------
    def total_ms(self) -> float:
        end = self.end_s if self.end_s is not None else time.monotonic()
        return (end - self.t0) * 1e3

    def to_dict(self) -> Dict:
        children: Dict[Optional[int], List[int]] = {}
        for i, sp in enumerate(self.spans):
            children.setdefault(sp.parent, []).append(i)

        def node(i: int) -> Dict:
            sp = self.spans[i]
            d = {
                "name": sp.name,
                "start_ms": round((sp.start_s - self.t0) * 1e3, 3),
                "duration_ms": round(sp.duration_ms(), 3),
            }
            if sp.attrs:
                d["attrs"] = {k: round(v, 3) for k, v in sp.attrs.items()}
            kids = [node(j) for j in children.get(i, [])]
            if kids:
                d["spans"] = kids
            return d

        out = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "started_at": self.started_at,
            "total_ms": round(self.total_ms(), 3),
            "spans": [node(i) for i in children.get(None, [])],
        }
        if self.parent_span_id:
            out["parent_span_id"] = self.parent_span_id
        if self.attrs:
            out["attrs"] = self.attrs
        return out


_current: "contextvars.ContextVar[Optional[Trace]]" = contextvars.ContextVar(
    "rag_trace", default=None
)


def current_trace() -> Optional[Trace]:
    return _current.get()


def start_trace(trace_id: Optional[str] = None,
                parent_span_id: Optional[str] = None) -> Trace:
    """Open a trace on this thread; pair with ``finish_trace``.
    ``trace_id``/``parent_span_id`` come from an incoming W3C
    ``traceparent`` header when the request carried one
    (obs/logging.py:parse_traceparent)."""
    tr = Trace(trace_id, parent_span_id=parent_span_id)
    _current.set(tr)
    return tr


def finish_trace(tr: Trace, buffer: "Optional[TraceBuffer]" = None) -> Dict:
    """Close the trace: close dangling spans, emit the structured JSON log,
    push into the ring buffer, clear the contextvar. Returns the tree."""
    now = time.monotonic()
    tr.end_s = now
    for idx in reversed(tr._stack):  # an exception can leave spans open
        if tr.spans[idx].end_s is None:
            tr.spans[idx].end_s = now
    tr._stack.clear()
    if _current.get() is tr:
        _current.set(None)
    tree = tr.to_dict()
    if logger.isEnabledFor(logging.DEBUG):
        logger.debug("%s", json.dumps(tree, separators=(",", ":")))
    if buffer is not None:
        buffer.add(tree)
    return tree


@contextmanager
def span(name: str, **attrs):
    """Record a stage span on the current trace (a no-op beyond the profiler
    range when no trace is active), and name the wrapped work as a
    ``record_function`` range on a ``torch.profiler`` timeline either way."""
    tr = _current.get()
    idx = None
    if tr is not None:
        idx = tr.begin(name)
        if attrs:
            tr.spans[idx].attrs.update({k: float(v) for k, v in attrs.items()})
    try:
        with record_function(name):
            yield tr.spans[idx] if idx is not None else None
    finally:
        if tr is not None and idx is not None:
            tr.end(idx)


class TraceBuffer:
    """Fixed-capacity ring of finished trace trees (``/debug/traces``)."""

    def __init__(self, capacity: int = 128):
        self._lock = threading.Lock()
        self._buf: "deque[Dict]" = deque(maxlen=capacity)

    def add(self, tree: Dict) -> None:
        with self._lock:
            self._buf.append(tree)

    def list(self, limit: Optional[int] = None) -> List[Dict]:
        """Newest-last. ``limit`` trims to the newest N; non-positive
        limits mean "no trim" (a negative slice would silently DROP the
        oldest entry instead)."""
        with self._lock:
            items = list(self._buf)
        return items[-limit:] if limit is not None and limit > 0 else items

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)
