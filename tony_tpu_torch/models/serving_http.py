"""HTTP front end for the port's continuous-batching engine.

Counterpart of ``tony_tpu/models/serving_http.py``. It boots a
``ContinuousBatcher`` over a model preset with seeded random weights, or
over a Hugging Face checkpoint directory (``--hf``), optionally int8, on
``--device`` (``cuda`` unless asked otherwise) and serves, on the stdlib
``ThreadingHTTPServer``:

    POST /v1/completions   {"prompt_tokens": [...], "max_tokens": N,
                            "stream": true|false, "temperature": ..,
                            "top_k": .., "top_p": .., "timeout_s": ..}
                           → JSON, or an SSE token stream
    POST /v1/prefill        disaggregated prefill leg: one token, then the
                            prompt's KV pages shipped to ``decode_url``
    POST /v1/kv/adopt       adopt shipped KV pages into the paged pool
    GET  /healthz           liveness
    GET  /stats             engine counters, incl. kernel launch counts

As a replica of ``tony serve`` (``tony_tpu_torch_launch.serve``; the
executor exports ``TONY_AM_*``) it keeps the JAX replica's contract: it
registers its URL with the AM (``register_task_url``), writes its stats
and its obs-registry snapshot next to ``TONY_TRAIN_METRICS_FILE`` for the
executor's metrics push, writes the ``serve.request`` span chain when
tracing is on, and drains on a cooperative-preemption notice
(``<metrics-file>.drain``, answered with ``.drain.done``) as on SIGTERM:
admission stops, in-flight requests finish, exit 0. HTTP handler threads
touch only thread-safe queues; ONE engine thread owns the batcher and the
page pool.

``--hf <dir>`` reads a Llama or Mixtral checkpoint directory (``config.json``
and ``model.safetensors``, sharded safetensors with their index, or
``pytorch_model.bin``) through ``convert.load_hf_dir``, in its own dtype
(float32 stays float32, anything else is served as bfloat16); ``--preset``
is then ignored, and a Mixtral directory serves through the engine's MoE
branch. Prompts are token ids: text prompts need a tokenizer (the
``tokenizers`` package), which the port does not use, so ``--tokenizer`` is
refused by name.

Run: ``python -m tony_tpu_torch.models.serving_http --preset llama3-8b``, or
``--hf <checkpoint dir> [--int8]``. ``--tp N`` serves a Llama or Mixtral
preset (``--preset mixtral-8x7b``) or ``--hf`` directory from N shards.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import signal
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import torch

from tony_tpu_torch import constants
from tony_tpu_torch.cluster.rpc import RpcClient, RpcError, own_host
from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.models import llama, mixtral
from tony_tpu_torch.models.convert import load_hf_dir
from tony_tpu_torch.models.serving import ContinuousBatcher, tp_devices
from tony_tpu_torch.obs import introspect
from tony_tpu_torch.obs import logging as obs_logging
from tony_tpu_torch.obs import metrics as obs_metrics
from tony_tpu_torch.obs import trace as obs_trace
from tony_tpu_torch.ops import decode_attention, quant
from tony_tpu_torch.serve import disagg

#: ``--preset``'s choices: Llama's presets, and Mixtral's under a
#: ``mixtral-`` name (served through the engine's MoE branch, at ``--tp``
#: too)
PRESETS = {**llama.PRESETS, "mixtral-8x7b": mixtral.MIXTRAL_8X7B, "mixtral-tiny": mixtral.MIXTRAL_TINY}

# the JAX replica's instruments, names and shapes unchanged: snapshots drop
# at <train-metrics-file>.obs and ride the executor's metrics push to the
# AM's get_metrics and the portal's /metrics (tony_serve_kv_handoff_total
# is registered by serve/disagg.py, which counts it)
_QUEUE_DEPTH = obs_metrics.gauge(
    "tony_serve_queue_depth",
    "engine admission + staging queue depth (requests waiting for a slot)")
_TTFT = obs_metrics.histogram(
    "tony_serve_ttft_seconds",
    "time from request submission to its first generated-token fanout")
_TOKEN_LATENCY = obs_metrics.histogram(
    "tony_serve_token_latency_seconds",
    "per-token decode latency (chunk interval / tokens in the chunk)")
_DELIVERED = obs_metrics.counter(
    "tony_serve_tokens_delivered_total", "tokens actually written to client sockets")
_REQUESTS_DONE = obs_metrics.counter(
    "tony_serve_requests_total", "finished engine requests by outcome",
    labelnames=("outcome",))
_PREFIX_HITS = obs_metrics.counter(
    "tony_serve_prefix_hit_tokens_total",
    "prompt tokens whose prefill was skipped via paged prefix-cache hits")
_HANDOFF_LATENCY = obs_metrics.histogram(
    "tony_serve_kv_handoff_seconds",
    "disaggregated handoff wall time on the prefill replica: prompt done → "
    "pages exported, shipped, and acked by the decode replica")


def kernel_launches() -> dict[str, int]:
    """Launch counts of every kernel wrapper on the serving path."""
    return {**decode_attention.launches, **quant.launches}


class RequestStream:
    """The per-request event channel ``submit()`` returns: ``get`` the
    events; ``cancel()`` is the client-disconnect/deadline path (the engine
    thread picks the flag up within one decode chunk)."""

    __slots__ = ("q", "cancelled", "submitted_s", "last_fanout_s",
                 "request_id", "span", "stage", "defer_finish")

    def __init__(self, maxsize: int = 0, request_id: str = ""):
        self.q: queue.Queue = queue.Queue(maxsize)
        self.cancelled = threading.Event()
        # TTFT counts from submission, admission-queue wait included
        self.submitted_s = time.time()
        self.last_fanout_s = 0.0
        #: router-propagated id (X-Tony-Request-Id): exemplar and span key
        self.request_id = request_id
        #: disagg handoff: on "done" the engine opens a serve.handoff stage
        #: instead of closing the span; the /v1/prefill handler finishes it
        #: after the pages ship
        self.defer_finish = False
        # span chain (queue → prefill → decode [→ handoff]) under one
        # serve.request; both None with tracing off
        self.span = None
        self.stage = None

    def get(self, timeout: float | None = None):
        return self.q.get(timeout=timeout)

    def put(self, item) -> None:
        self.q.put(item)

    def cancel(self) -> None:
        self.cancelled.set()

    def open_trace(self) -> None:
        """Start the serve.request span and its queue stage (no-op, and no
        allocation, with tracing off)."""
        self.span = obs_trace.start_manual("serve.request", rid=self.request_id)
        if self.span is not None:
            self.stage = obs_trace.start_manual("serve.queue", parent_id=self.span.span_id)

    def begin_stage(self, name: str, **attrs: Any) -> None:
        """End the current stage span and open the next one in the chain."""
        if self.span is not None:
            obs_trace.end_manual(self.stage)
            self.stage = obs_trace.start_manual(name, parent_id=self.span.span_id, **attrs)

    def finish_trace(self, status: str = "ok") -> None:
        if self.span is not None:
            obs_trace.end_manual(self.stage, status)
            obs_trace.end_manual(self.span, status)
            self.span = self.stage = None


class EngineServer:
    """Thread-safe facade over one ContinuousBatcher.

    HTTP threads call ``submit()``; the engine thread drains the inbox,
    steps the batcher, fans tokens out, runs queued control ops (the KV
    export and adopt) and processes cancellations and deadlines between
    chunks. ``stop()`` drains. The admission inbox is bounded (a full inbox
    answers "overloaded", 429), and so is each stream's queue (a consumer
    that stops draining is cancelled)."""

    STREAM_QUEUE_CHUNKS = 1024

    def __init__(self, engine: ContinuousBatcher, on_fatal=None,
                 max_queue: int = 256, request_timeout_s: float = 0.0, role: str = "serve"):
        self.engine = engine
        #: the tier this replica serves in ("serve" decodes and adopts
        #: pages, "prefill" takes /v1/prefill legs); /stats carries it for
        #: the per-tier health monitors. Both answer the whole API.
        self.role = role
        self._inbox: "queue.Queue[tuple]" = queue.Queue(maxsize=max_queue)
        #: closures that must run where the allocator and the pools live
        #: (run_on_engine), answered (ok, value) on a per-op box
        self._control: "queue.Queue[tuple]" = queue.Queue()
        self._streams: dict[int, RequestStream] = {}
        self._deadlines: dict[int, float] = {}
        self.request_timeout_s = request_timeout_s
        self._draining = threading.Event()
        self._stopped = threading.Event()
        # serializes the draining-check+enqueue in submit() against the
        # loop's final refuse-sweep
        self._admit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, name="engine", daemon=True)
        self.error: BaseException | None = None
        self._on_fatal = on_fatal
        self.started_s = time.time()
        self.tokens_out = 0
        self.tokens_delivered = 0
        self.requests_done = 0
        self.requests_cancelled = 0
        self._prefix_hits_exported = 0  # engine-thread watermark → registry delta
        # handoff pages (engine thread only: export and adopt are control ops)
        self.kv_handoff_exported = 0
        self.kv_handoff_adopted = 0
        self._delivered_lock = threading.Lock()

    def add_delivered(self, n: int) -> None:
        with self._delivered_lock:
            self.tokens_delivered += n
        _DELIVERED.inc(n)

    def run_on_engine(self, fn, timeout_s: float = 30.0):
        """Run ``fn()`` on the engine thread, between decode chunks, and
        return its result: the page allocator and the pools have one owner.
        Raises what ``fn`` raised; TimeoutError when the engine never picked
        the op up (draining or wedged)."""
        box: "queue.Queue[tuple]" = queue.Queue(1)
        self._control.put((fn, box))
        try:
            ok, val = box.get(timeout=timeout_s)
        except queue.Empty:
            raise TimeoutError(f"engine did not service the control op within {timeout_s:.0f}s") from None
        if not ok:
            raise val
        return val

    def _drain_control(self) -> None:
        """Run queued control ops (engine thread only). A failing op answers
        its caller and never takes the loop down."""
        while True:
            try:
                fn, box = self._control.get_nowait()
            except queue.Empty:
                return
            try:
                box.put((True, fn()))
            except Exception as e:  # noqa: BLE001 — answered to the caller
                box.put((False, e))

    def start(self) -> "EngineServer":
        self._thread.start()
        return self

    def submit(self, prompt_tokens: list[int], max_tokens: int, sampling: dict | None = None,
               timeout_s: float | None = None, request_id: str = "") -> RequestStream:
        """Enqueue a request; its stream yields ("tokens", [..]) zero or more
        times, then ("done", all_tokens) — or ("error", message)."""
        out = RequestStream(self.STREAM_QUEUE_CHUNKS, request_id=request_id)
        # the span chain opens before the inbox put: once the engine thread
        # can see the stream, only it touches the spans
        out.open_trace()
        with self._admit_lock:
            if self._draining.is_set() or self.error is not None:
                out.put(("error", "server is draining" if self.error is None
                         else f"engine failed: {self.error}"))
                out.finish_trace("error")
                return out
            timeout = timeout_s if timeout_s is not None else self.request_timeout_s
            deadline_abs = time.time() + timeout if timeout and timeout > 0 else 0.0
            try:
                self._inbox.put_nowait((prompt_tokens, max_tokens, sampling or {}, deadline_abs, out))
            except queue.Full:
                out.put(("error", "overloaded: admission queue full"))
                out.finish_trace("error")
        return out

    def _queue_depth(self) -> int:
        """Requests waiting for a slot; /stats and tony_serve_queue_depth
        both read this one definition."""
        eng = self.engine
        return len(eng.pending) + len(eng._staged) + self._inbox.qsize()

    def stats(self) -> dict[str, Any]:
        eng = self.engine
        up = max(time.time() - self.started_s, 1e-9)
        return {
            "slots_total": eng.S,
            "slots_active": len(eng.running),
            "queue_depth": self._queue_depth(),
            "requests_done": self.requests_done,
            "requests_cancelled": self.requests_cancelled,
            "tokens_out": self.tokens_out,
            "tokens_delivered": self.tokens_delivered,
            "tokens_per_s": round(self.tokens_out / up, 2),
            "uptime_s": round(up, 1),
            "draining": self._draining.is_set(),
            "healthy": self.error is None,
            "role": self.role,
            "device": str(eng.device),
            "kv": eng.kv,
            "attn": eng.attn,
            "kernel_launches": kernel_launches(),
            **(
                {
                    "pages_live": eng.allocator.live_pages(),
                    "pages_total": eng.num_pages - 1,
                    "prefix_hit_tokens": eng.prefix_hit_tokens,
                    "kv_handoff_exported": self.kv_handoff_exported,
                    "kv_handoff_adopted": self.kv_handoff_adopted,
                }
                if eng.kv == "paged" else {}
            ),
        }

    def stop(self, timeout_s: float = 10.0) -> bool:
        """Drain: no new admissions; in-flight requests finish. True if the
        drain completed inside ``timeout_s``."""
        self._draining.set()
        return self._stopped.wait(timeout_s)

    def _loop(self) -> None:
        try:
            self._loop_inner()
        except BaseException as e:  # noqa: BLE001 — a silently dead engine thread would hang every stream
            self.error = e
            traceback.print_exc()
            if self._streams:
                _REQUESTS_DONE.inc(len(self._streams), outcome="error")
            for out in self._streams.values():
                self._finish_stream(out, ("error", f"engine failed: {e}"))
                out.finish_trace("error")
            self._streams.clear()
            if self._on_fatal is not None:
                self._on_fatal()
        finally:
            with self._admit_lock:
                self._draining.set()
                while True:
                    try:
                        self._inbox.get_nowait()[-1].put(("error", "server is draining"))
                    except queue.Empty:
                        break
                while True:  # a control op must not leave its caller waiting
                    try:
                        _, box = self._control.get_nowait()
                        box.put((False, RuntimeError("engine stopped")))
                    except queue.Empty:
                        break
                self._stopped.set()

    @staticmethod
    def _finish_stream(stream: RequestStream, event: tuple) -> None:
        """Deliver a TERMINAL event without blocking the engine thread: a
        full stream queue (slow consumer) loses one buffered chunk instead."""
        try:
            stream.q.put_nowait(event)
        except queue.Full:
            try:
                stream.q.get_nowait()
            except queue.Empty:
                pass
            try:
                stream.q.put_nowait(event)
            except queue.Full:
                pass

    def _sweep_cancellations(self) -> None:
        eng = self.engine
        now = time.time()
        for rid, stream in list(self._streams.items()):
            expired = rid in self._deadlines and now > self._deadlines[rid]
            if stream.cancelled.is_set() or expired:
                eng.cancel(rid)
                self._finish_stream(stream, ("error", "deadline exceeded" if expired
                                             else "cancelled: consumer stopped draining"))
                self.requests_cancelled += 1
                _REQUESTS_DONE.inc(outcome="cancelled")
                stream.finish_trace("error")
                del self._streams[rid]
                self._deadlines.pop(rid, None)

    def _loop_inner(self) -> None:
        eng = self.engine
        carry = None  # item pulled by the idle wait — admitted FIRST (FIFO)
        while True:
            while True:
                if carry is not None:
                    prompt, max_tokens, sampling, deadline, out = carry
                    carry = None
                else:
                    try:
                        prompt, max_tokens, sampling, deadline, out = self._inbox.get_nowait()
                    except queue.Empty:
                        break
                if out.cancelled.is_set():
                    out.finish_trace("error")
                    continue
                if deadline and time.time() > deadline:
                    out.put(("error", "deadline exceeded"))
                    self.requests_cancelled += 1
                    _REQUESTS_DONE.inc(outcome="cancelled")
                    out.finish_trace("error")
                    continue
                try:
                    rid = eng.submit(prompt, max_tokens, **sampling)
                except (ValueError, TypeError) as e:
                    out.put(("error", str(e)))
                    out.finish_trace("error")
                    continue
                self._streams[rid] = out
                out.begin_stage("serve.prefill")
                if deadline:
                    self._deadlines[rid] = deadline
            self._sweep_cancellations()
            self._drain_control()
            _QUEUE_DEPTH.set(self._queue_depth())
            had_work = eng.step()
            hits = getattr(eng, "prefix_hit_tokens", 0)
            if hits > self._prefix_hits_exported:
                _PREFIX_HITS.inc(hits - self._prefix_hits_exported)
                self._prefix_hits_exported = hits
            now_s = time.time()
            for rid, (toks, done) in eng.drain_stream().items():
                out = self._streams.get(rid)
                final = eng.done.pop(rid, None) if done else None
                if out is None:
                    continue
                if toks:
                    if out.last_fanout_s:
                        _TOKEN_LATENCY.observe((now_s - out.last_fanout_s) / len(toks))
                    else:
                        ttft = now_s - out.submitted_s
                        _TTFT.observe(ttft, exemplar=out.request_id or None)
                        out.begin_stage("serve.decode", ttft_s=round(ttft, 6))
                    out.last_fanout_s = now_s
                self.tokens_out += len(toks)
                if done:
                    self.requests_done += 1
                    _REQUESTS_DONE.inc(outcome="done")
                    self._finish_stream(out, ("done", final if final is not None else toks))
                    if out.defer_finish:
                        out.begin_stage("serve.handoff")
                    else:
                        out.finish_trace("ok")
                    del self._streams[rid]
                    self._deadlines.pop(rid, None)
                else:
                    try:
                        out.q.put_nowait(("tokens", toks))
                    except queue.Full:
                        out.cancel()  # dead-slow consumer: treated as a disconnect
            if not had_work:
                if self._draining.is_set():
                    return
                try:
                    carry = self._inbox.get(timeout=0.2)
                except queue.Empty:
                    pass


def _json_body(handler: BaseHTTPRequestHandler) -> dict:
    n = int(handler.headers.get("Content-Length") or 0)
    return json.loads(handler.rfile.read(n) or b"{}")


class _Handler(BaseHTTPRequestHandler):
    server_ref: EngineServer = None  # set by main()

    def log_message(self, *a) -> None:  # quiet
        pass

    def _reply(self, code: int, obj: Any, headers: dict | None = None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802
        if self.path == "/healthz":
            err = self.server_ref.error
            if err is None:
                self._reply(200, {"ok": True})
            else:
                self._reply(503, {"ok": False, "error": str(err)})
        elif self.path == "/stats":
            self._reply(200, self.server_ref.stats())
        else:
            self._reply(404, {"error": "not found"})

    def do_POST(self) -> None:  # noqa: N802
        if self.path == "/v1/prefill":
            self._handle_prefill()
            return
        if self.path == "/v1/kv/adopt":
            self._handle_adopt()
            return
        if self.path != "/v1/completions":
            self._reply(404, {"error": "not found"})
            return
        try:
            req = _json_body(self)
            if not isinstance(req, dict):
                raise ValueError("request body must be a JSON object")
            prompt = req.get("prompt_tokens")
            if prompt is None and "prompt" in req:
                raise ValueError("text prompts need a tokenizer (the tokenizers package), which the "
                                 "port does not use; send prompt_tokens")
            if not prompt:
                raise ValueError("empty prompt")
            max_tokens = int(req.get("max_tokens", 16))
            stream = bool(req.get("stream", False))
            sampling = {
                k: (float(req[k]) if k != "top_k" else int(req[k]))
                for k in ("temperature", "top_k", "top_p")
                if req.get(k) is not None
            }
            timeout_s = float(req["timeout_s"]) if req.get("timeout_s") is not None else None
            if timeout_s is not None and timeout_s <= 0:
                raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
            prompt = [int(t) for t in prompt]
        except (TypeError, ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        request_id = (self.headers.get("X-Tony-Request-Id") or "").strip()
        out = self.server_ref.submit(prompt, max_tokens, sampling, timeout_s=timeout_s,
                                     request_id=request_id)
        if stream:
            self._stream_response(out)
        else:
            self._block_response(out)

    def _handle_prefill(self) -> None:
        """Disagg prefill leg: run the prompt for ONE generated token,
        export its finished full-prompt KV pages, POST them to the named
        decode replica's ``/v1/kv/adopt``, and reply with the first token
        and the handoff's accounting. Past the first token the handoff is
        best-effort: a failed ship degrades to a decode-side recompute
        (``ship_error`` in a 200 reply), never to a client-visible error."""
        srv = self.server_ref
        try:
            req = _json_body(self)
            if not isinstance(req, dict):
                raise ValueError("request body must be a JSON object")
            prompt = [int(t) for t in (req.get("prompt_tokens") or [])]
            if not prompt:
                raise ValueError("empty prompt")
            decode_url = str(req.get("decode_url") or "").rstrip("/")
            sampling = {
                k: (float(req[k]) if k != "top_k" else int(req[k]))
                for k in ("temperature", "top_k", "top_p")
                if req.get(k) is not None
            }
            ship_timeout_s = float(req.get("timeout_s") or 30.0)
        except (TypeError, ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        if srv.engine.kv != "paged":
            self._reply(409, {"error": "kv handoff needs a paged engine (--kv paged)"})
            return
        request_id = (self.headers.get("X-Tony-Request-Id") or "").strip()
        t0 = time.perf_counter()
        out = srv.submit(prompt, 1, sampling, request_id=request_id)
        out.defer_finish = True
        while True:
            kind, payload = out.get()
            if kind in ("done", "error"):
                break
        if kind == "error":
            self._error_reply(payload)
            return
        first = list(payload)
        shipped = have = pages = 0
        ship_error = ""
        try:
            exported = srv.run_on_engine(lambda: disagg.export_prefix_pages(srv, prompt))
            if exported is not None:
                pages = len(exported["keys"])
                if decode_url:
                    shipped, have = disagg.ship_pages(decode_url, exported, timeout_s=ship_timeout_s)
        except Exception as e:  # noqa: BLE001 — degrade to a decode-side recompute
            ship_error = str(e)[:200]
        took = time.perf_counter() - t0
        _HANDOFF_LATENCY.observe(took, exemplar=request_id or None)
        out.finish_trace("ok" if not ship_error else "error")
        resp = {
            "first_token": first[-1] if first else None,
            "pages": pages,
            "adopted": shipped,
            "already_resident": have,
            "handoff_ms": round(took * 1000, 3),
        }
        if ship_error:
            resp["ship_error"] = ship_error
        self._reply(200, resp)

    def _handle_adopt(self) -> None:
        """Decode half of the handoff: adopt shipped pages into the paged
        pool (400 on a page_len, geometry, dtype or size mismatch; 503 when
        the engine does not take the op)."""
        srv = self.server_ref
        if srv.engine.kv != "paged":
            self._reply(409, {"error": "kv adopt needs a paged engine"})
            return
        try:
            payload = _json_body(self)
            if not isinstance(payload, dict):
                raise ValueError("adopt body must be a JSON object")
            adopted, have = srv.run_on_engine(lambda: disagg.adopt_pages(srv, payload))
        except (TypeError, ValueError, KeyError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        except (TimeoutError, RuntimeError) as e:
            self._reply(503, {"error": str(e)})
            return
        self._reply(200, {"adopted": adopted, "already_resident": have})

    def _error_reply(self, payload: str) -> None:
        if "overloaded" in payload:
            self._reply(429, {"error": payload}, {"Retry-After": "1"})
        elif "deadline" in payload:
            self._reply(504, {"error": payload})
        else:
            self._reply(503 if "draining" in payload or "engine failed" in payload else 400,
                        {"error": payload})

    def _block_response(self, out: RequestStream) -> None:
        while True:
            kind, payload = out.get()
            if kind == "error":
                self._error_reply(payload)
                return
            if kind == "done":  # payload is the authoritative full list
                self._reply(200, {"tokens": list(payload), "finished": True})
                self.server_ref.add_delivered(len(payload))
                return

    def _stream_response(self, out: RequestStream) -> None:
        """SSE: one ``data: {"tokens": [...]}`` event per decode chunk, then
        ``data: {"finished": true, "tokens": [all]}``. A write failure
        cancels the engine request."""
        kind, payload = out.get()
        if kind == "error":
            self._error_reply(payload)
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()

        def emit(obj: Any) -> None:
            self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
            self.wfile.flush()

        delivered = 0
        try:
            while True:
                if kind == "tokens":
                    emit({"tokens": payload})
                    delivered += len(payload)
                    self.server_ref.add_delivered(len(payload))
                elif kind == "done":
                    emit({"finished": True, "tokens": list(payload)})
                    self.server_ref.add_delivered(max(len(payload) - delivered, 0))
                    return
                else:
                    emit({"error": payload})
                    return
                kind, payload = out.get()
        except OSError:
            out.cancel()  # dropped client: free the slot mid-decode


def _register_with_am(url: str) -> None:
    """Inside a tony container, publish the endpoint through the AM's
    ``register_task_url``. No-op standalone; an unreachable AM leaves the
    replica serving, unadvertised."""
    host = os.environ.get(constants.ENV_AM_HOST)
    if not host:
        return
    try:
        cli = RpcClient(host, int(os.environ[constants.ENV_AM_PORT]),
                        secret=os.environ.get(constants.ENV_AM_SECRET, ""))
        try:
            cli.call("register_task_url",
                     job_name=os.environ.get(constants.ENV_JOB_NAME, "serve"),
                     index=int(os.environ.get(constants.ENV_TASK_INDEX, "0")),
                     url=url,
                     attempt=int(os.environ.get(constants.ENV_RESTART_ATTEMPT, "0")))
        finally:
            cli.close()
    except (RpcError, OSError, ValueError, KeyError) as e:
        obs_logging.warning(f"[tony-serve] AM registration failed: {e}")


def _metrics_pump(srv: EngineServer, stop: threading.Event, interval_s: float = 2.0) -> None:
    """Write the engine's stats to ``TONY_TRAIN_METRICS_FILE`` and the obs
    registry's snapshot to ``<file>.obs`` (each by atomic rename), the files
    the executor's metrics loop pushes to the AM: the portal charts serving
    as it charts training."""
    path = os.environ.get(constants.ENV_TRAIN_METRICS_FILE)
    if not path:
        return
    step = 0
    last_tokens, last_t = 0, time.time()
    while not stop.wait(interval_s):
        step += 1
        now, toks = time.time(), srv.tokens_out
        rate = (toks - last_tokens) / max(now - last_t, 1e-9)
        last_tokens, last_t = toks, now
        st = srv.stats()
        line = {"step": step, "tokens_per_s": round(rate, 2), "slots_active": st["slots_active"],
                "queue_depth": st["queue_depth"], "requests_done": st["requests_done"]}
        snap = [m for m in obs_metrics.REGISTRY.snapshot() if m["samples"]]
        try:
            introspect.write_json_atomic(path, line)
            if snap:
                introspect.write_json_atomic(path + ".obs", snap)
        except OSError:
            pass  # exposition is best-effort


def _drain_watch(srv: EngineServer, stop: threading.Event, budget_s: float = 10.0) -> None:
    """Replica half of the cooperative-preemption drain: poll
    ``<TONY_TRAIN_METRICS_FILE>.drain`` (dropped by the executor's courier
    when the pool asks the gang to drain). On a notice: stop admitting
    (``/stats`` says ``draining``, so the fleet's health monitor sheds the
    replica), finish in-flight streams, acknowledge with ``.drain.done``
    (the completed-request count as the step), then park: the AM yields,
    and its SIGTERM finds a drained server. A later notice is answered at
    once."""
    path = os.environ.get(constants.ENV_TRAIN_METRICS_FILE)
    if not path:
        return
    try:
        poll_ms = int(os.environ.get(constants.ENV_PROFILE_POLL_MS, "500") or 500)
    except ValueError:
        poll_ms = 500
    acked: set[str] = set()
    while not stop.wait(max(poll_ms, 50) / 1000.0):
        ctl = introspect.read_json(path + introspect.DRAIN_CONTROL_SUFFIX)
        req_id = str((ctl or {}).get("req_id") or "")
        if not req_id or req_id in acked:
            continue
        if not acked:
            obs_logging.warning(f"[tony-serve] drain notice {req_id} (cooperative preemption) "
                                "— refusing new admissions, finishing in-flight streams")
            if not srv.stop(timeout_s=budget_s):
                obs_logging.warning(f"[tony-serve] drain {req_id} timed out with "
                                    f"{len(srv._streams)} request(s) in flight — truncating")
        _ack_drain(path, req_id, step=srv.requests_done)
        acked.add(req_id)
        obs_logging.info(f"[tony-serve] drain {req_id} acknowledged ({srv.requests_done} "
                         "request(s) completed) — parked, awaiting the AM's yield")


def _ack_drain(path: str, req_id: str, step: int) -> None:
    """Publish ``<metrics-file>.drain.done`` (atomic) for the courier."""
    try:
        introspect.write_json_atomic(path + introspect.DRAIN_DONE_SUFFIX,
                                     {"req_id": req_id, "step": int(step)})
    except OSError:
        pass  # the AM's yield margin covers a lost ack


def _resolve_kv(args) -> str:
    """``--kv`` when set; else dense under ``--tp > 1`` (the paged pool's
    page indirection is per-device, as in JAX), paged wherever the page
    geometry fits (``max_len`` a positive multiple of ``page_len``), dense
    otherwise."""
    if args.kv is not None:
        return args.kv
    if getattr(args, "tp", 1) > 1:
        return "dense"
    if args.page_len <= 0 or args.max_len % args.page_len:
        obs_logging.warning(f"[tony-serve] kv defaulting to dense: max_len {args.max_len} is not a "
                            f"positive multiple of page_len {args.page_len}")
        return "dense"
    return "paged"


def build_engine(args) -> ContinuousBatcher:
    """The engine ``args`` describe: a preset's seeded weights or ``--hf``'s
    checkpoint, int8 where asked. ``--tp N > 1`` places the shards on the
    first N visible CUDA devices (the CPU N times under ``--device cpu``)
    and raises when fewer are visible, as JAX's does; ``--int8`` with it
    raises (JAX's engine cannot place int8 weights on a model axis)."""
    device = resolve_device(args.device)
    devices = None
    if args.tp > 1:
        if args.int8:
            raise ValueError(f"--int8 with --tp {args.tp}: int8 weights under model-axis TP are not "
                             "served (JAX's TP engine cannot place them either); use --tp 1")
        devices = tp_devices(args.tp, device)
    if args.hf:
        t0 = time.perf_counter()
        params, cfg = load_hf_dir(args.hf, device)
        obs_logging.info(f"[tony-serve] loaded {args.hf} ({type(cfg).__name__}, {cfg.n_layers} layers, "
                         f"{cfg.dtype}) in {time.perf_counter() - t0:.1f}s; --preset is ignored")
    else:
        cfg = PRESETS[args.preset]
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        params = (mixtral if isinstance(cfg, mixtral.MixtralConfig) else llama).init(gen, cfg, device)
    if args.int8:
        params, _, _ = quant.quantize_tree(params)
    return engine_for(params, cfg, args, device, devices)


def engine_for(params: dict, cfg, args, device, devices=None) -> ContinuousBatcher:
    """The ``ContinuousBatcher`` of ``args``'s settings over ``params`` (as
    given: ``--int8`` is ``build_engine``'s)."""
    args.kv = _resolve_kv(args)
    sample_gen = torch.Generator(device=device)
    sample_gen.manual_seed(args.seed + 1)
    return ContinuousBatcher(
        params, cfg,
        num_slots=args.slots, max_len=args.max_len, eos_id=args.eos_id,
        temperature=args.temperature, top_k=args.top_k, generator=sample_gen,
        decode_chunk=args.decode_chunk, attn=args.attn, prefill_chunk=args.prefill_chunk,
        kv=args.kv, page_len=args.page_len,
        num_pages=args.num_pages if args.num_pages > 0 else None, tp=args.tp, devices=devices,
    )


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="tony-serve-torch",
                                description="continuous-batching HTTP inference server (PyTorch/CUDA)")
    p.add_argument("--preset", default="tiny", choices=sorted(PRESETS),
                   help="model preset (seeded random init unless --hf)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--hf", default="",
                   help="HuggingFace checkpoint dir to load (Llama or Mixtral: config.json and "
                        "model.safetensors, sharded safetensors with their index, or "
                        "pytorch_model.bin); served in its dtype, float32 or else bfloat16")
    p.add_argument("--tokenizer", default="",
                   help="refused: text prompts need the tokenizers package, which the port does "
                        "not use; send prompt_tokens")
    p.add_argument("--int8", action="store_true", help="int8 weight-only quantization")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--decode-chunk", type=int, default=8)
    p.add_argument("--prefill-chunk", type=int, default=0)
    p.add_argument("--attn", default="auto", choices=["auto", "ragged", "bucketed"])
    p.add_argument("--kv", default=None, choices=["dense", "paged"],
                   help="paged: block-paged KV pool + shared-prefix reuse. Default: paged "
                        "where max_len is a multiple of page_len, else dense")
    p.add_argument("--page-len", type=int, default=256)
    p.add_argument("--num-pages", type=int, default=0,
                   help="page pool size (0 = dense-equivalent: slots x max_len)")
    p.add_argument("--tp", type=int, default=1,
                   help="model-axis tensor parallelism for the engine: its shards on the first N "
                        "CUDA devices, the projections and KV heads split over them; dense kv, "
                        "bucketed attention, no --int8")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--eos-id", type=int, default=-1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--host", default="",
                   help="bind AND advertise this host; default: bind all interfaces, advertise "
                        "the container's reachable address (loopback deployments stay on loopback)")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--url-file", default="", help="write the bound URL here once serving")
    p.add_argument("--admission-queue", type=int, default=256,
                   help="bounded admission inbox; a full inbox returns 429")
    p.add_argument("--request-timeout-s", type=float, default=0.0,
                   help="default per-request deadline (0 = none)")
    p.add_argument("--role", default="serve", choices=["serve", "prefill"],
                   help="disagg tier: 'prefill' replicas take /v1/prefill legs and ship KV "
                        "pages; 'serve' replicas decode and adopt shipped pages. Both answer "
                        "the whole API; routing is the router's job")
    p.add_argument("--slo-ttft-ms", type=float,
                   default=float(os.environ.get(constants.ENV_SLO_TTFT_MS, "0") or 0),
                   help="align a TTFT histogram bucket edge to this SLO threshold "
                        "(default from TONY_SLO_TTFT_MS, 0 = off)")
    args = p.parse_args(argv)
    if args.tokenizer:
        p.error("--tokenizer: text prompts need the tokenizers package, which the PyTorch server "
                "does not use; send prompt_tokens (token ids)")
    return args


def main(argv: list[str] | None = None) -> int:
    # under a tony container the executor exports the logging and tracing
    # contracts; outside one both only echo / stay off
    obs_logging.init_from_env(role="serve")
    args = parse_args(argv)
    if os.environ.get(constants.ENV_METRICS_ENABLED) == "0":
        obs_metrics.set_enabled(False)  # the job opted out (tony.metrics.enabled)
    if args.slo_ttft_ms > 0:
        _TTFT.ensure_bucket(args.slo_ttft_ms / 1000.0)
    obs_trace.init_from_env()
    done = threading.Event()
    srv = EngineServer(build_engine(args), on_fatal=done.set, max_queue=args.admission_queue,
                       request_timeout_s=args.request_timeout_s, role=args.role).start()
    handler = type("Handler", (_Handler,), {"server_ref": srv})
    if args.host:
        bind_host, adv_host = args.host, args.host
    else:
        bind_host = "0.0.0.0"
        adv_host = own_host(os.environ.get(constants.ENV_AM_HOST, "127.0.0.1"))
    httpd = ThreadingHTTPServer((bind_host, args.port), handler)
    url = f"http://{adv_host}:{httpd.server_address[1]}"
    if args.url_file:
        tmp = args.url_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(url)
        os.replace(tmp, args.url_file)
    _register_with_am(url)
    stop_threads = threading.Event()
    threading.Thread(target=_metrics_pump, args=(srv, stop_threads), daemon=True).start()

    def _drain(*_):
        done.set()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    # the drain budget of SIGTERM and of a preemption notice: the container's
    # SIGTERM→SIGKILL window less a teardown margin
    grace_ms = float(os.environ.get(constants.ENV_KILL_GRACE_MS, "0") or 0)
    budget_s = max(grace_ms / 1000 - 1.0, 2.0) if grace_ms else 10.0
    threading.Thread(target=_drain_watch, args=(srv, stop_threads, budget_s), daemon=True).start()
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    obs_logging.info(f"[tony-serve] {url} role={args.role} preset={args.preset} device={srv.engine.device} "
                     f"kv={args.kv} int8={args.int8} slots={args.slots} max_len={args.max_len}")
    # poll rather than block: a SIGTERM delivered while the main thread sits
    # in an untimed wait would only run its Python handler much later
    while not done.wait(0.5):
        pass
    if srv.error is not None:
        obs_logging.error(f"[tony-serve] engine failed: {srv.error}")
        stop_threads.set()
        httpd.shutdown()
        return 1
    obs_logging.info(f"[tony-serve] draining (budget {budget_s:.0f}s)")
    if srv.stop(timeout_s=budget_s):
        obs_logging.info(f"[tony-serve] drained: {srv.requests_done} request(s) completed, exit 0")
    else:
        obs_logging.warning(f"[tony-serve] drain timed out with {len(srv._streams)} request(s) in flight "
                            "— truncating")
    stop_threads.set()
    httpd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
