"""Overlapped input pipeline: assemble batch N+1 while the device runs step N.

Counterpart of ``tony_tpu/train/input_pipeline.py``. A background thread
calls ``make_batch(step)`` for ``start_step, start_step+1, …`` in order,
once each, at most ``depth`` batches ahead; ``next`` is a queue pop. With
``depth <= 0`` there is no thread and
``next`` calls ``make_batch`` inline, so both paths feed the same batches.
A producer failure is re-raised from ``next`` with the original as
``__cause__``; ``close`` is idempotent and joins the thread. Every
blocking ``next`` feeds the ``tony_train_input_wait_seconds`` histogram, and
a wait of at least ``span_min_ms`` (``TONY_INPUT_WAIT_SPAN_MS``, 25 by
default) emits a backdated ``train.input_wait`` span, which the goodput
ledger charges to its ``input_wait`` phase. The producer issues no
collective: ``make_batch`` only reads and draws.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Callable

from tony_tpu_torch import constants
from tony_tpu_torch.obs import metrics as obs_metrics

_INPUT_WAIT_SECONDS = obs_metrics.histogram(
    "tony_train_input_wait_seconds",
    "time the step loop blocked waiting on the input pipeline, per step")

#: queue entries: ("batch", step, value) | ("error", step, exc) | ("end",)
_BATCH, _ERROR, _END = "batch", "error", "end"


def depth_from_env(env: dict[str, str] | None = None) -> int:
    """``TONY_PREFETCH_DEPTH`` (tony.train.prefetch-depth); 2 outside a container."""
    env = os.environ if env is None else env
    try:
        return int(env.get(constants.ENV_PREFETCH_DEPTH, "2") or "2")
    except ValueError:
        return 2


def span_min_ms_from_env(env: dict[str, str] | None = None) -> float:
    env = os.environ if env is None else env
    try:
        return float(env.get(constants.ENV_INPUT_WAIT_SPAN_MS, "25") or "25")
    except ValueError:
        return 25.0


class InputPipelineError(RuntimeError):
    """A batch producer failure, re-raised on the step loop's thread."""


class InputPipeline:
    """Bounded-lookahead batch prefetcher over a ``make_batch(step)`` callable."""

    def __init__(self, make_batch: Callable[[int], Any], start_step: int, end_step: int,
                 depth: int | None = None, tracer=None):
        self.make_batch = make_batch
        self.start_step = start_step
        self.end_step = end_step
        self.depth = depth_from_env() if depth is None else depth
        self.tracer = tracer
        self.span_min_ms = span_min_ms_from_env()
        self._next_step = start_step
        self._closed = False
        self._thread: threading.Thread | None = None
        if self.depth > 0 and end_step > start_step:
            self._queue: queue.Queue = queue.Queue(maxsize=self.depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._produce, name="tony-input-pipeline",
                                            daemon=True)
            self._thread.start()

    def _put(self, item) -> None:
        # re-check stop while the consumer is busy, so close() never strands us
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _produce(self) -> None:
        step = self.start_step
        try:
            while step < self.end_step and not self._stop.is_set():
                item = (_BATCH, step, self.make_batch(step))
                step += 1
                self._put(item)
            if not self._stop.is_set():
                self._queue.put((_END,))
        except BaseException as e:  # noqa: BLE001 — ship it to the consumer
            self._put((_ERROR, step, e))

    def next(self, step: int) -> Any:
        """The batch for ``step`` (consecutive steps from ``start_step``)."""
        if self._closed:
            raise RuntimeError("InputPipeline.next() after close()")
        if step != self._next_step:
            raise ValueError(f"out-of-order batch request: step {step}, expected {self._next_step}")
        if step >= self.end_step:
            raise StopIteration(step)
        self._next_step = step + 1
        if self._thread is None:
            return self.make_batch(step)
        t0 = time.perf_counter()
        item = self._queue.get()
        wait = time.perf_counter() - t0
        _INPUT_WAIT_SECONDS.observe(wait)
        if self.tracer is not None and wait * 1000.0 >= self.span_min_ms:
            with self.tracer.span("train.input_wait", step=step) as sp:
                sp.start_ms -= wait * 1000.0  # backdated: the span covers the stall
        if item[0] == _ERROR:
            raise InputPipelineError(f"input pipeline failed assembling batch {item[1]}") from item[2]
        if item[0] == _END:
            raise StopIteration(step)
        return item[2]

    def close(self) -> bool:
        """Stop and join the producer; True when it is known dead."""
        if self._closed:
            return self._thread is None or not self._thread.is_alive()
        self._closed = True
        if self._thread is None:
            return True
        self._stop.set()
        while True:  # drain: a producer parked on put() wakes and sees _stop
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
        return not self._thread.is_alive()
