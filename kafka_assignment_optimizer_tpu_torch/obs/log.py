"""Structured logging: one line per event, ``key=value`` pairs.

A copy of ``kafka_assignment_optimizer_tpu.obs.log``::

    ts=2026-08-03T12:00:00Z level=info event=degradation rung=sweep_to_chain

Values containing spaces, quotes, ``=`` or newlines are double-quoted
with backslash escapes; everything stays on one line. The reference
appends the active solve trace's ID; this package has no solve tracer
yet, so its lines carry none unless the caller passes ``trace_id``.
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
    parts = [
        "ts=" + time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        f"level={_level}",
        f"event={_fmt(event)}",
    ]
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
