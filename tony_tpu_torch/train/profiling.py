"""Per-worker profiler capture through ``torch.profiler``.

Counterpart of ``tony_tpu/train/profiling.py``, with ``torch.profiler`` in
place of ``jax.profiler``, two ways:

- **Static window** (``tony.task.profile=true``): the executor exports
  ``TONY_PROFILE_DIR``; the capture starts when ``step()`` reaches
  ``TONY_PROFILE_START_STEP`` (3: past the first-use warm-up) and stops
  ``TONY_PROFILE_NUM_STEPS`` (5) steps later.
- **On demand** (``tony profile <app_id>``): the executor writes
  ``<train-metrics-file>.profile``; ``step()`` polls it at most once per
  ``TONY_PROFILE_POLL_MS``, captures the requested steps with their wall
  times, and answers with ``<train-metrics-file>.profile.done``.

A capture writes a Chrome trace (``<identity>.pt.trace.json``, the CPU ops
and, on a card, the CUDA kernels) that ``chrome://tracing``, Perfetto and
TensorBoard's profile plugin open; an on-demand request with ``memory``
adds ``memory_stats.json`` (``torch.cuda.memory_stats``). ``stop()``, from
the loop's ``finally``, ends a capture the run ended inside of.
"""

from __future__ import annotations

import json
import os
import time

import torch

from tony_tpu_torch import constants
from tony_tpu_torch.obs import introspect
from tony_tpu_torch.obs import trace as obs_trace


def _start_capture() -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_capture(prof: torch.profiler.profile, out_dir: str, memory: bool = False) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    job, idx = os.environ.get(constants.ENV_JOB_NAME), os.environ.get(constants.ENV_TASK_INDEX)
    name = f"{job}_{idx}" if job and idx is not None else f"pid{os.getpid()}"
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}.pt.trace.json"))
    if memory and torch.cuda.is_available():
        with open(os.path.join(out_dir, "memory_stats.json"), "w") as f:
            json.dump(torch.cuda.memory_stats(), f)


class StepProfiler:
    """Captures ``torch.profiler`` traces over windows of training steps,
    driven from the env the executor exports; the loop calls ``step()``
    once per step and ``stop()`` at the end."""

    def __init__(self, env: dict[str, str] | None = None):
        env = dict(os.environ if env is None else env)
        self.trace_dir = env.get(constants.ENV_PROFILE_DIR) or ""
        self.start_step = int(env.get(constants.ENV_PROFILE_START_STEP, "3"))
        self.num_steps = int(env.get(constants.ENV_PROFILE_NUM_STEPS, "5"))
        self.done = False
        metrics_path = env.get(constants.ENV_TRAIN_METRICS_FILE) or ""
        self.control_path = metrics_path + introspect.CONTROL_SUFFIX if metrics_path else ""
        self.done_path = metrics_path + introspect.DONE_SUFFIX if metrics_path else ""
        try:
            poll_ms = float(env.get(constants.ENV_PROFILE_POLL_MS, "500") or "500")
        except ValueError:
            poll_ms = 500.0
        self._poll_s = max(poll_ms, 1.0) / 1000.0
        self._next_poll = 0.0
        self._static = None                 # the static window's live capture
        self._request: dict | None = None   # the armed on-demand capture
        self._handled: set[str] = set()
        self._step_times_ms: list[float] = []
        self._last_step_t = 0.0
        self._span = None                   # (Span, token) while capturing on demand

    def step(self, step: int) -> None:
        """Call once per training step, before the step body."""
        if self._request is not None:
            self._on_demand_step(step)
        elif self.control_path:
            now = time.monotonic()
            if now >= self._next_poll:
                self._next_poll = now + self._poll_s
                self._maybe_arm(step)
        if not self.trace_dir or self.done:
            return
        if self._static is None and self._request is None and step >= self.start_step:
            self._static = _start_capture()
        elif self._static is not None and step >= self.start_step + self.num_steps:
            self.stop()

    def stop(self) -> None:
        """End whatever capture is live (idempotent)."""
        if self._request is not None:
            self._finalize_on_demand(truncated=True)
        if self._static is not None:
            prof, self._static = self._static, None
            _stop_capture(prof, self.trace_dir)
            self.done = True

    def _maybe_arm(self, step: int) -> None:
        req = introspect.read_json(self.control_path)
        req_id = str((req or {}).get("req_id") or "")
        if not req_id or req_id in self._handled or self._static is not None:
            return  # nothing new, or a static window is live: retry once it closes
        self._handled.add(req_id)
        out_dir = req.get("dir") or os.path.join(os.path.dirname(self.control_path), "profile", req_id)
        try:
            prof = _start_capture()
        except RuntimeError as e:  # a capture failure must not stop training
            self._write_done(req_id, out_dir, ok=False, error=f"{type(e).__name__}: {e}")
            return
        num_steps = max(int(req.get("num_steps", 5) or 5), 1)
        self._request = {"req_id": req_id, "dir": out_dir, "num_steps": num_steps,
                         "memory": bool(req.get("memory")), "start_step": step, "prof": prof}
        self._step_times_ms = []
        self._last_step_t = time.perf_counter()
        tracer = obs_trace.get()
        if tracer is not None:
            span, token = tracer.start_span("profile.capture")
            span.set(req_id=req_id, num_steps=num_steps)
            self._span = (span, token)

    def _on_demand_step(self, step: int) -> None:
        now = time.perf_counter()
        self._step_times_ms.append((now - self._last_step_t) * 1000.0)
        self._last_step_t = now
        if step >= self._request["start_step"] + self._request["num_steps"]:
            self._finalize_on_demand(truncated=False)

    def _finalize_on_demand(self, truncated: bool) -> None:
        req, self._request = self._request, None
        error = ""
        try:
            _stop_capture(req["prof"], req["dir"], memory=req["memory"])
        except (OSError, RuntimeError) as e:  # a capture failure must not stop training
            error = f"{type(e).__name__}: {e}"
        self._write_done(req["req_id"], req["dir"], ok=not error, error=error,
                         steps_captured=len(self._step_times_ms),
                         step_times_ms=[round(t, 3) for t in self._step_times_ms],
                         truncated=truncated)
        if self._span is not None:
            (span, token), self._span = self._span, None
            span.set(truncated=truncated)
            tracer = obs_trace.get()
            if tracer is not None:
                tracer.end_span(span, token, status="error" if error else "ok")

    def _write_done(self, req_id: str, out_dir: str, ok: bool, error: str = "", **extra) -> None:
        artifacts = sorted(os.path.relpath(os.path.join(root, fn), out_dir)
                           for root, _, files in os.walk(out_dir) for fn in files)
        try:
            introspect.write_json_atomic(self.done_path, {
                "req_id": req_id, "ok": ok, "dir": out_dir, "artifacts": artifacts,
                "error": error, **extra})
        except OSError:
            pass  # reporting is best-effort; the artifacts are on disk
