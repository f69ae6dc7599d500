"""HTTP front end for the port's continuous-batching engine.

Counterpart of ``tony_tpu/models/serving_http.py``. It boots a
``ContinuousBatcher`` over a model preset with seeded random weights
(optionally int8) on ``--device`` (``cuda`` unless asked otherwise) and
serves, on the stdlib ``ThreadingHTTPServer``:

    POST /v1/completions   {"prompt_tokens": [...], "max_tokens": N,
                            "stream": true|false, "temperature": ..,
                            "top_k": .., "top_p": .., "timeout_s": ..}
                           → JSON, or an SSE token stream
    GET  /healthz           liveness
    GET  /stats             engine counters, incl. kernel launch counts

SIGTERM drains: admission stops, in-flight requests finish, exit 0.
HTTP handler threads touch only thread-safe queues; ONE engine thread owns
the batcher. Not ported yet (later slices): AM registration, the metrics
pump, the cooperative-preemption drain watcher, SLO spans and the obs
registry, HF checkpoints and tokenizers, and the disaggregated
``/v1/prefill`` and ``/v1/kv/adopt`` routes, which answer 501.

Run: ``python -m tony_tpu_torch.models.serving_http --preset llama3-8b``.
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
from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.models.llama import PRESETS, init
from tony_tpu_torch.models.serving import ContinuousBatcher
from tony_tpu_torch.ops import decode_attention, quant


def kernel_launches() -> dict[str, int]:
    """Launch counts of every kernel wrapper on the serving path."""
    return {**decode_attention.launches, **quant.launches}


class RequestStream:
    """The per-request event channel ``submit()`` returns: ``get`` the
    events; ``cancel()`` is the client-disconnect/deadline path (the engine
    thread picks the flag up within one decode chunk)."""

    __slots__ = ("q", "cancelled", "submitted_s")

    def __init__(self, maxsize: int = 0):
        self.q: queue.Queue = queue.Queue(maxsize)
        self.cancelled = threading.Event()
        self.submitted_s = time.time()

    def get(self, timeout: float | None = None):
        return self.q.get(timeout=timeout)

    def put(self, item) -> None:
        self.q.put(item)

    def cancel(self) -> None:
        self.cancelled.set()


class EngineServer:
    """Thread-safe facade over one ContinuousBatcher.

    HTTP threads call ``submit()``; the engine thread drains the inbox,
    steps the batcher, fans tokens out, and processes cancellations and
    deadlines between chunks. ``stop()`` drains. The admission inbox is
    bounded (a full inbox answers "overloaded", 429), and so is each
    stream's queue (a consumer that stops draining is cancelled)."""

    STREAM_QUEUE_CHUNKS = 1024

    def __init__(self, engine: ContinuousBatcher, on_fatal=None,
                 max_queue: int = 256, request_timeout_s: float = 0.0):
        self.engine = engine
        self._inbox: "queue.Queue[tuple]" = queue.Queue(maxsize=max_queue)
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
        self._delivered_lock = threading.Lock()

    def add_delivered(self, n: int) -> None:
        with self._delivered_lock:
            self.tokens_delivered += n

    def start(self) -> "EngineServer":
        self._thread.start()
        return self

    def submit(self, prompt_tokens: list[int], max_tokens: int,
               sampling: dict | None = None, timeout_s: float | None = None) -> RequestStream:
        """Enqueue a request; its stream yields ("tokens", [..]) zero or more
        times, then ("done", all_tokens) — or ("error", message)."""
        out = RequestStream(self.STREAM_QUEUE_CHUNKS)
        with self._admit_lock:
            if self._draining.is_set() or self.error is not None:
                out.put(("error", "server is draining" if self.error is None
                         else f"engine failed: {self.error}"))
                return out
            timeout = timeout_s if timeout_s is not None else self.request_timeout_s
            deadline_abs = time.time() + timeout if timeout and timeout > 0 else 0.0
            try:
                self._inbox.put_nowait((prompt_tokens, max_tokens, sampling or {}, deadline_abs, out))
            except queue.Full:
                out.put(("error", "overloaded: admission queue full"))
        return out

    def _queue_depth(self) -> int:
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
            "device": str(eng.device),
            "kv": eng.kv,
            "attn": eng.attn,
            "kernel_launches": kernel_launches(),
            **(
                {
                    "pages_live": eng.allocator.live_pages(),
                    "pages_total": eng.num_pages - 1,
                    "prefix_hit_tokens": eng.prefix_hit_tokens,
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
            for out in self._streams.values():
                self._finish_stream(out, ("error", f"engine failed: {e}"))
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
                    continue
                if deadline and time.time() > deadline:
                    out.put(("error", "deadline exceeded"))
                    self.requests_cancelled += 1
                    continue
                try:
                    rid = eng.submit(prompt, max_tokens, **sampling)
                except (ValueError, TypeError) as e:
                    out.put(("error", str(e)))
                    continue
                self._streams[rid] = out
                if deadline:
                    self._deadlines[rid] = deadline
            self._sweep_cancellations()
            had_work = eng.step()
            for rid, (toks, done) in eng.drain_stream().items():
                out = self._streams.get(rid)
                final = eng.done.pop(rid, None) if done else None
                if out is None:
                    continue
                self.tokens_out += len(toks)
                if done:
                    self.requests_done += 1
                    self._finish_stream(out, ("done", final if final is not None else toks))
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
        if self.path in ("/v1/prefill", "/v1/kv/adopt"):
            self._reply(501, {"error": f"{self.path} (disaggregated KV handoff) is not "
                                       "ported yet: it comes with the port's disaggregated-serving slice"})
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
                raise ValueError("text prompts are not supported yet; send prompt_tokens")
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
        out = self.server_ref.submit(prompt, max_tokens, sampling, timeout_s=timeout_s)
        if stream:
            self._stream_response(out)
        else:
            self._block_response(out)

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


def _resolve_kv(args) -> str:
    """``--kv`` when set; else paged wherever the page geometry fits
    (``max_len`` a positive multiple of ``page_len``), dense otherwise."""
    if args.kv is not None:
        return args.kv
    if args.page_len <= 0 or args.max_len % args.page_len:
        print(f"[tony-serve] kv defaulting to dense: max_len {args.max_len} is not a "
              f"positive multiple of page_len {args.page_len}", file=sys.stderr, flush=True)
        return "dense"
    return "paged"


def build_engine(args) -> ContinuousBatcher:
    args.kv = _resolve_kv(args)
    device = resolve_device(args.device)
    cfg = PRESETS[args.preset]
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init(gen, cfg, device)
    if args.int8:
        from tony_tpu_torch.ops.quant import quantize_tree

        params, _, _ = quantize_tree(params)
    sample_gen = torch.Generator(device=device)
    sample_gen.manual_seed(args.seed + 1)
    return ContinuousBatcher(
        params, cfg,
        num_slots=args.slots, max_len=args.max_len, eos_id=args.eos_id,
        temperature=args.temperature, top_k=args.top_k, generator=sample_gen,
        decode_chunk=args.decode_chunk, attn=args.attn, prefill_chunk=args.prefill_chunk,
        kv=args.kv, page_len=args.page_len,
        num_pages=args.num_pages if args.num_pages > 0 else None, tp=args.tp,
    )


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="tony-serve-torch",
                                description="continuous-batching HTTP inference server (PyTorch/CUDA)")
    p.add_argument("--preset", default="tiny", choices=sorted(PRESETS),
                   help="model preset (seeded random init)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
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
    p.add_argument("--tp", type=int, default=1, help="tensor parallelism (only 1 is ported)")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--eos-id", type=int, default=-1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--host", default="", help="bind AND advertise this host (default: bind all, "
                                              "advertise 127.0.0.1)")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--url-file", default="", help="write the bound URL here once serving")
    p.add_argument("--admission-queue", type=int, default=256,
                   help="bounded admission inbox; a full inbox returns 429")
    p.add_argument("--request-timeout-s", type=float, default=0.0,
                   help="default per-request deadline (0 = none)")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    done = threading.Event()
    srv = EngineServer(build_engine(args), on_fatal=done.set,
                       max_queue=args.admission_queue,
                       request_timeout_s=args.request_timeout_s).start()
    handler = type("Handler", (_Handler,), {"server_ref": srv})
    bind_host, adv_host = (args.host, args.host) if args.host else ("0.0.0.0", "127.0.0.1")
    httpd = ThreadingHTTPServer((bind_host, args.port), handler)
    url = f"http://{adv_host}:{httpd.server_address[1]}"
    if args.url_file:
        tmp = args.url_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(url)
        os.replace(tmp, args.url_file)

    def _drain(*_):
        done.set()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    grace_ms = float(os.environ.get(constants.ENV_KILL_GRACE_MS, "0") or 0)
    budget_s = max(grace_ms / 1000 - 1.0, 2.0) if grace_ms else 10.0
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    print(f"[tony-serve] {url} preset={args.preset} device={srv.engine.device} kv={args.kv} "
          f"int8={args.int8} slots={args.slots} max_len={args.max_len}", flush=True)
    # poll rather than block: a SIGTERM delivered while the main thread sits
    # in an untimed wait would only run its Python handler much later
    while not done.wait(0.5):
        pass
    if srv.error is not None:
        print(f"[tony-serve] engine failed: {srv.error}", file=sys.stderr, flush=True)
        httpd.shutdown()
        return 1
    print(f"[tony-serve] draining (budget {budget_s:.0f}s)", flush=True)
    if not srv.stop(timeout_s=budget_s):
        print(f"[tony-serve] drain timed out with {len(srv._streams)} request(s) in flight",
              file=sys.stderr, flush=True)
    httpd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
