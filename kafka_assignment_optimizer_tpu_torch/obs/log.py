"""Structured logging: one line per event, ``key=value`` pairs.

Replaces the ad-hoc ``print(..., file=sys.stderr)`` call sites in the
serving path with a single greppable format::

    ts=2026-08-03T12:00:00Z level=info event=solve trace_id=ab12... \
        solver=tpu wall_s=0.42 feasible=True

The active trace ID (``obs.trace``) is appended automatically when a
trace is live on the calling context, so serve/engine log lines join to
their ``/debug/solves`` report without any plumbing. Values containing
spaces, quotes, ``=`` or newlines are double-quoted with backslash
escapes; everything stays on one line.
"""

from __future__ import annotations

import sys
import threading
import time

_LOCK = threading.Lock()


def _fmt(v) -> str:
    if isinstance(v, float):
        v = round(v, 6)
    s = str(v)
    if s == "" or any(ch in s for ch in ' "=\n\t'):
        s = (
            '"'
            + s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
            + '"'
        )
    return s


def log(event: str, _level: str = "info", _stream=None, **fields) -> None:
    """Emit one structured line to ``_stream`` (default stderr). None
    values are dropped so call sites can pass optional fields blindly."""
    from .trace import current_trace_id

    parts = [
        "ts=" + time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        f"level={_level}",
        f"event={_fmt(event)}",
    ]
    tid = current_trace_id()
    if tid and "trace_id" not in fields:
        parts.append(f"trace_id={tid}")
    parts += [f"{k}={_fmt(v)}" for k, v in fields.items() if v is not None]
    line = " ".join(parts)
    stream = _stream if _stream is not None else sys.stderr
    with _LOCK:
        print(line, file=stream)


def info(event: str, **fields) -> None:
    log(event, **fields)


def warn(event: str, **fields) -> None:
    log(event, _level="warn", **fields)


def error(event: str, **fields) -> None:
    log(event, _level="error", **fields)
