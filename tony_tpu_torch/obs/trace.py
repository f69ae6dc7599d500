"""Spans of the training child and the serving replica, in the control
plane's span JSONL.

Own copy of the subset of ``tony_tpu/obs/trace.py`` the child writes: one
job is one trace (``trace_id`` is the application id); the child's tracer
appends finished spans to ``<TONY_TRACE_DIR>/<job>_<index>_train.spans.jsonl``
with its root span under the executor's (``TONY_TRACE_PARENT``), so ``tony
trace`` and the goodput ledger (``train.first_step``, ``train.input_wait``,
``ckpt.save`` spans; a replica's ``serve.request`` chain) read a port job as
a JAX one. Off by default: ``get()`` is None, ``maybe_span`` hands out a
shared no-op context and ``start_manual`` returns None.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator, Mapping

from tony_tpu_torch import constants

_CURRENT: contextvars.ContextVar["Span | None"] = contextvars.ContextVar("tony_span", default=None)
_tracer: "Tracer | None" = None


def get() -> "Tracer | None":
    """The process-global tracer, or None (tracing off, the default)."""
    return _tracer


def current_span() -> "Span | None":
    return _CURRENT.get() if _tracer is not None else None


class _NoopCtx:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> bool:
        return False


_NOOP = _NoopCtx()


def maybe_span(name: str, **attrs: Any):
    """A real span when tracing is on, else the shared no-op context."""
    tr = _tracer
    return _NOOP if tr is None else tr.span(name, **attrs)


def start_manual(name: str, parent_id: str | None = None, **attrs: Any) -> "Span | None":
    """A span not bound to the thread's context, for a lifecycle that
    crosses engine-loop iterations (one serve request's queue → prefill →
    decode chain). None when tracing is off, so the disabled path is one
    None check. Pair with ``end_manual``."""
    tr = _tracer
    if tr is None:
        return None
    if parent_id is None:
        cur = _CURRENT.get()
        parent_id = cur.span_id if cur is not None else tr.root_parent
    span = Span(name, tr.trace_id, os.urandom(8).hex(), parent_id, "internal", tr.identity)
    span.attrs.update(attrs)
    return span


def end_manual(span: "Span | None", status: str = "ok", **attrs: Any) -> None:
    """Finish and write a ``start_manual`` span (no-op on None)."""
    tr = _tracer
    if tr is None or span is None:
        return
    span.attrs.update(attrs)
    span.end_ms = time.time() * 1000.0
    span.status = status
    tr.write(span)


class Span:
    """One timed operation: name, causal links and attributes."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "kind", "identity", "thread_id",
                 "start_ms", "end_ms", "status", "attrs")

    def __init__(self, name: str, trace_id: str, span_id: str, parent_id: str | None, kind: str,
                 identity: str):
        self.name, self.trace_id, self.span_id = name, trace_id, span_id
        self.parent_id, self.kind, self.identity = parent_id, kind, identity
        self.thread_id = threading.get_ident()
        self.start_ms = time.time() * 1000.0
        self.end_ms = 0.0
        self.status = "ok"
        self.attrs: dict[str, Any] = {}

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "name": self.name, "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "kind": self.kind, "identity": self.identity,
            "thread": self.thread_id, "start_ms": round(self.start_ms, 3),
            "end_ms": round(self.end_ms, 3), "status": self.status,
        }
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class Tracer:
    """Span factory and line-buffered JSONL sink of one process identity."""

    def __init__(self, trace_id: str, identity: str, trace_dir: str, parent_id: str | None = None):
        self.trace_id = trace_id
        self.identity = identity
        #: parent of spans opened with no current span (the process root)
        self.root_parent = parent_id
        self._lock = threading.Lock()
        os.makedirs(trace_dir, exist_ok=True)
        safe = identity.replace(":", "_").replace(os.sep, "_")
        self._file = open(os.path.join(trace_dir, safe + ".spans.jsonl"), "a", buffering=1)

    def start_span(self, name: str) -> tuple[Span, contextvars.Token]:
        """Open a span under the thread's current one (else the process root)
        and make it current; pair with ``end_span``."""
        cur = _CURRENT.get()
        parent_id = cur.span_id if cur is not None else self.root_parent
        span = Span(name, self.trace_id, os.urandom(8).hex(), parent_id, "internal", self.identity)
        return span, _CURRENT.set(span)

    def end_span(self, span: Span, token: contextvars.Token, status: str = "ok") -> None:
        span.end_ms = time.time() * 1000.0
        span.status = status
        try:
            _CURRENT.reset(token)
        except ValueError:
            pass  # ended from another context than it started in
        self.write(span)

    def write(self, span: Span) -> None:
        """Append one finished span to the sink."""
        line = json.dumps(span.to_dict())
        with self._lock:
            try:
                self._file.write(line + "\n")
            except ValueError:
                pass  # closed mid-teardown: spans are best-effort

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Span]:
        sp, token = self.start_span(name)
        sp.attrs.update(attrs)
        try:
            yield sp
        except BaseException:
            self.end_span(sp, token, status="error")
            raise
        self.end_span(sp, token)

    def close(self) -> None:
        with self._lock:
            self._file.close()


def init_from_env(env: Mapping[str, str] | None = None) -> "Tracer | None":
    """Install the process tracer when the executor turned tracing on
    (``TONY_TRACE_ENABLED=1`` and ``TONY_TRACE_DIR``); None otherwise."""
    global _tracer
    env = os.environ if env is None else env
    trace_dir = env.get(constants.ENV_TRACE_DIR, "")
    if env.get(constants.ENV_TRACE_ENABLED) != "1" or not trace_dir:
        return None
    job, idx = env.get(constants.ENV_JOB_NAME), env.get(constants.ENV_TASK_INDEX)
    identity = f"{job}:{idx}:train" if job and idx is not None else "proc"
    shutdown()
    _tracer = Tracer(env.get(constants.ENV_APP_ID, "trace"), identity, trace_dir,
                     parent_id=env.get(constants.ENV_TRACE_PARENT) or None)
    return _tracer


def shutdown() -> None:
    """Close and uninstall the process tracer (idempotent)."""
    global _tracer
    if _tracer is not None:
        _tracer.close()
        _tracer = None
