"""JSON log records of the training child and the serving replica.

Own copy of the subset of ``tony_tpu/obs/logging.py`` the child writes:
under ``tony submit`` the executor exports ``TONY_LOG_DIR`` and
``TONY_LOG_LEVEL``, and each record at or above the level is appended as
one JSON object to ``<TONY_LOG_DIR>/<job>_<index>_<role>.log.jsonl`` (with
the gang ``epoch`` and the span open on the thread), where ``tony logs``
merges it with the AM's and the executors'. Every record at ``info`` or
above is also echoed, to stdout (stderr from ``warning``), as the
``print`` it replaces; outside a container only the echo happens.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Mapping

from tony_tpu_torch import constants
from tony_tpu_torch.obs import trace as _trace

DEBUG, INFO, WARNING, ERROR = 10, 20, 30, 40
OFF = 100
_LEVELS = {"debug": DEBUG, "info": INFO, "warning": WARNING, "error": ERROR, "off": OFF}
_NAMES = {v: k for k, v in _LEVELS.items()}
#: keys the logger owns; a field never shadows them
_RESERVED = frozenset({"ts_ms", "level", "identity", "msg", "epoch", "span"})

_logger: "JsonLogger | None" = None


class JsonLogger:
    """Line-buffered JSONL sink of one process identity."""

    def __init__(self, identity: str, log_dir: str, level: int = INFO, epoch: int = 0):
        self.identity, self.level, self.epoch = identity, level, epoch
        self._lock = threading.Lock()
        os.makedirs(log_dir, exist_ok=True)
        safe = identity.replace(":", "_").replace(os.sep, "_")
        self._file = open(os.path.join(log_dir, safe + ".log.jsonl"), "a", buffering=1)

    def emit(self, level: int, msg: str, fields: Mapping[str, Any]) -> None:
        rec: dict[str, Any] = {"ts_ms": round(time.time() * 1000.0, 3), "level": _NAMES[level],
                               "identity": self.identity, "msg": str(msg)}
        if self.epoch:
            rec["epoch"] = self.epoch
        span = _trace.current_span()
        if span is not None:
            rec["span"] = span.span_id
        rec.update((k, v) for k, v in fields.items() if k not in _RESERVED)
        line = json.dumps(rec, default=str)
        with self._lock:
            try:
                self._file.write(line + "\n")
            except (OSError, ValueError):
                pass  # a full disk or a closed sink must not take the process down

    def close(self) -> None:
        with self._lock:
            self._file.close()


def _log(level: int, msg: str, fields: dict[str, Any]) -> None:
    lg = _logger
    if lg is not None and level >= lg.level:
        lg.emit(level, msg, fields)
    if level >= INFO:
        # one write a line: the checkpoint writer thread logs too, and
        # print's separate write of the newline could split a line
        stream = sys.stdout if level < WARNING else sys.stderr
        stream.write(f"{msg}\n")
        stream.flush()


def info(msg: str, **fields: Any) -> None:
    _log(INFO, msg, fields)


def warning(msg: str, **fields: Any) -> None:
    _log(WARNING, msg, fields)


def error(msg: str, **fields: Any) -> None:
    _log(ERROR, msg, fields)


def init_from_env(env: Mapping[str, str] | None = None, role: str = "train") -> "JsonLogger | None":
    """Install the process logger when the executor exported a log dir
    (and the level is not ``off``); None otherwise (echo only). ``role`` is
    the identity's suffix: the training loop keeps "train", a serving
    replica passes "serve"."""
    global _logger
    env = os.environ if env is None else env
    log_dir = env.get(constants.ENV_LOG_DIR, "")
    level = _LEVELS.get((env.get(constants.ENV_LOG_LEVEL) or "").strip().lower(), INFO)
    if not log_dir or level >= OFF:
        return None
    job, idx = env.get(constants.ENV_JOB_NAME), env.get(constants.ENV_TASK_INDEX)
    identity = f"{job}:{idx}:{role}" if job and idx is not None else "proc"
    shutdown()
    _logger = JsonLogger(identity, log_dir, level=level,
                         epoch=int(env.get(constants.ENV_RESTART_ATTEMPT, "0") or 0))
    return _logger


def shutdown() -> None:
    """Close and uninstall the process logger (idempotent)."""
    global _logger
    if _logger is not None:
        _logger.close()
        _logger = None
