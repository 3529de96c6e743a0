"""W3C trace propagation and trace-correlated JSON logs: the port's copy of
``rag_llm_k8s_tpu/obs/logging.py``.

- **traceparent** (https://www.w3.org/TR/trace-context/): the server parses
  the header on every request and adopts its ``trace-id`` (a malformed or
  absent header starts a fresh trace, never an error); the response carries
  ``x-trace-id`` plus a ``traceparent`` naming the server's own span, so one
  id follows a UI click through web, server, span tree and logs.
- **structured logs**: :class:`JsonLogFormatter` renders every log record as
  one JSON object and adds ``trace_id``/``span_id`` from the contextvar trace
  (``obs/tracing.py``) when the record is emitted inside a traced request.
  ``configure_json_logging()`` installs it process-wide
  (``TPU_RAG_JSON_LOGS=1`` in ``server/main.py``).

Standard library only, apart from the tracing module it reads.
"""

from __future__ import annotations

import json
import logging
import os
import uuid
from typing import NamedTuple, Optional

from rag_llm_k8s_tpu_torch.obs import tracing

__all__ = [
    "TraceContext",
    "parse_traceparent",
    "format_traceparent",
    "new_traceparent",
    "JsonLogFormatter",
    "configure_json_logging",
]

_HEX = set("0123456789abcdef")


class TraceContext(NamedTuple):
    trace_id: str  # 32 lowercase hex
    span_id: str  # 16 lowercase hex (the CALLER's span — our parent)
    sampled: bool


def _is_hex(s: str, width: int) -> bool:
    return len(s) == width and all(c in _HEX for c in s)


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """Strict W3C ``traceparent`` parse; None on ANY malformation.

    ``version-traceid-spanid-flags`` = ``2-32-16-2`` lowercase hex fields.
    Per spec: version ``ff`` is invalid, all-zero trace/span ids are
    invalid, and uppercase hex is invalid. Unknown (valid) versions are
    accepted on the 00 layout — forward compatibility. The caller treats
    None as "no inbound context": a fresh trace, never a 500.
    """
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if not _is_hex(version, 2) or version == "ff":
        return None
    if version == "00" and len(parts) != 4:
        return None
    if not _is_hex(trace_id, 32) or trace_id == "0" * 32:
        return None
    if not _is_hex(span_id, 16) or span_id == "0" * 16:
        return None
    if not _is_hex(flags, 2):
        return None
    return TraceContext(trace_id, span_id, bool(int(flags, 16) & 0x01))


def format_traceparent(trace_id: str, span_id: str, sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def new_traceparent() -> str:
    """Originate a fresh context (the web UI's side of the correlation)."""
    return format_traceparent(uuid.uuid4().hex, uuid.uuid4().hex[:16])


# ---------------------------------------------------------------------------
# structured logs
# ---------------------------------------------------------------------------

# LogRecord attributes that are plumbing, not payload — anything ELSE on the
# record (``extra={...}`` fields) is carried into the JSON object verbatim
_RECORD_INTERNAL = frozenset(
    (
        "name", "msg", "args", "levelname", "levelno", "pathname", "filename",
        "module", "exc_info", "exc_text", "stack_info", "lineno", "funcName",
        "created", "msecs", "relativeCreated", "thread", "threadName",
        "processName", "process", "taskName", "message", "asctime",
    )
)


class JsonLogFormatter(logging.Formatter):
    """One JSON object per log line, trace-correlated via the contextvar.

    A record emitted inside a traced request carries that request's
    ``trace_id`` and the server span id — the SAME ids the response's
    ``x-trace-id`` header and the inline ``{"trace": true}`` tree report.
    ``extra={...}`` fields ride along as top-level keys (reserved names are
    dropped rather than collided).
    """

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        tr = tracing.current_trace()
        if tr is not None:
            out["trace_id"] = tr.trace_id
            out["span_id"] = tr.span_id
        for key, val in record.__dict__.items():
            if key in _RECORD_INTERNAL or key.startswith("_") or key in out:
                continue
            try:
                json.dumps(val)
            except (TypeError, ValueError):
                val = repr(val)
            out[key] = val
        if record.exc_info and record.exc_info[0] is not None:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, separators=(",", ":"), default=repr)


def configure_json_logging(level: Optional[str] = None) -> None:
    """Swap the root handlers for ONE stderr handler with the JSON
    formatter. Honors ``TPU_RAG_LOG_LEVEL`` (same env server/main.py reads
    for the plain format). Idempotent."""
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler()
    handler.setFormatter(JsonLogFormatter())
    root.addHandler(handler)
    root.setLevel(level or os.environ.get("TPU_RAG_LOG_LEVEL", "INFO"))
