"""Engine logging.

The reference logs through glog with VLOG levels at every engine state
transition (scanner/util/glog.h; master.cpp/worker.cpp throughout).  Here
the stdlib `logging` hierarchy plays that role:

    scanner_tpu.master    control-plane transitions (admission, assignment,
                          revocation, blacklisting, worker liveness)
    scanner_tpu.worker    worker lifecycle + task outcomes
    scanner_tpu.engine    local executor pipeline

Like glog, warnings and errors are visible on stderr by DEFAULT — a
cluster worker retrying a failing pipeline must never be silent.
SCANNER_TPU_LOG (debug|info|warning|error) changes the level — the
operator-facing switch for debugging a wedged 16-host job.  Records also
propagate normally, so applications can route them through their own
logging configuration.

SCANNER_TPU_LOG_FORMAT=json switches the default handler to structured
output: one JSON object per line carrying ts/level/logger/msg plus the
active tracing context's trace_id/span_id (util/tracing.py), so logs
join traces in post-mortems — grep a task's trace_id from the straggler
summary and every log line that task's code path emitted lines up.
"""

from __future__ import annotations

import json
import logging
import os
import sys

_ROOT = "scanner_tpu_torch"
_configured = False


class JsonFormatter(logging.Formatter):
    """One JSON object per record; trace_id/span_id pulled from the
    active tracing context so log lines join the assembled traces."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        try:
            # lazy: the formatter must not force tracing (and its
            # metrics registry) into processes that never trace
            from . import tracing
            ctx = tracing.current_context()
            if ctx is not None:
                out["trace_id"] = ctx.trace_id
                out["span_id"] = ctx.span_id
        except Exception:  # noqa: BLE001 — logging must never raise
            pass
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def _configure_once() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    root = logging.getLogger(_ROOT)
    if root.handlers or logging.getLogger().handlers:
        # the application already configured logging (own handler on our
        # tree, or a root handler records propagate to) — don't add a
        # second stderr pipe that would double-print every record
        return
    level = logging.WARNING
    level_name = os.environ.get("SCANNER_TPU_LOG", "").strip()
    if level_name:
        parsed = getattr(logging, level_name.upper(), None)
        if isinstance(parsed, int):
            level = parsed
        else:
            print(f"scanner_tpu: SCANNER_TPU_LOG={level_name!r} is not a "
                  f"valid level", file=sys.stderr)
    handler = logging.StreamHandler(sys.stderr)
    if os.environ.get("SCANNER_TPU_LOG_FORMAT", "").strip().lower() \
            == "json":
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s %(message)s",
            datefmt="%H:%M:%S"))
    root.addHandler(handler)
    root.setLevel(level)


def get_logger(name: str) -> logging.Logger:
    """Logger under the scanner_tpu tree (e.g. get_logger('master'))."""
    _configure_once()
    return logging.getLogger(f"{_ROOT}.{name}")
