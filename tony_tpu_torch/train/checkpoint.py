"""Checkpointing, resume and the urgent save of the training loop.

Counterpart of ``tony_tpu/train/checkpoint.py`` on ``torch.save``: a step
is written to a private temporary directory and published by renaming it
to ``<dir>/<step>``, so a reader never sees a half-written step under its
final name; ``max_to_keep`` prunes the oldest steps.

Saves are asynchronous by default (``use_async``, as the JAX manager's
through Orbax): ``save`` copies the state into host buffers (pinned for a
CUDA state, allocated once per manager and reused: the optimizer updates
the state in place, so the copy is complete before ``save`` returns) and
hands the write, the rename and the pruning to one background thread; at
most one write is in flight, and the next ``save`` first joins it. ``wait``
joins the write and raises any error it hit, and ``close`` does the same at
the end. Only the main thread calls collectives. ``use_async=False`` writes
in ``save`` itself.

In a gang every rank holds the whole state (the data axis replicates it),
so rank 0 writes. ``wait`` ends in a barrier, so once it has returned on
every rank the step is on the shared directory; a synchronous ``save``
ends in ``wait``.
``restore_or_init`` keeps the JAX function's corruption tolerance: a step
that fails to load is quarantined as ``.corrupt-<step>`` and the
next-newest step is tried, down to a fresh init; every rank of a gang hits
a torn step at once, and the quarantine is safe against that race. The
chaos hook ``maybe_corrupt_checkpoint`` runs first, on rank 0 alone, and the
ranks check that they restored the same step.

``UrgentSaveSignal`` is the child's half of the checkpoint-then-yield
drain: the loop polls it each step, force-saves on a new request and
acknowledges with the saved step.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from tony_tpu_torch import constants
from tony_tpu_torch.chaos.inject import maybe_corrupt_checkpoint
from tony_tpu_torch.obs import introspect
from tony_tpu_torch.obs import logging as obs_logging
from tony_tpu_torch.obs import metrics as obs_metrics
from tony_tpu_torch.obs import trace as obs_trace

STATE_FILE = "state.pt"

_SAVE_SECONDS = obs_metrics.histogram(
    "tony_checkpoint_save_seconds",
    "checkpoint save-dispatch latency (async saves exclude background writes)")
_RESTORE_SECONDS = obs_metrics.histogram(
    "tony_checkpoint_restore_seconds", "checkpoint restore latency")
_WRITE_SECONDS = obs_metrics.histogram(
    "tony_checkpoint_write_seconds",
    "checkpoint write latency (torch.save, publishing rename and pruning; in the background when async)")


class CheckpointManager:
    """Numbered step directories under ``directory``. ``group``: the gang's
    process group (None for one process); its rank 0 writes.
    ``use_async``: write in a background thread (the default, as JAX's).

    ``saved_step`` is the newest step this manager saved or restored. Every
    rank keeps it in memory and decides from it alone whether a save
    writes: a rank that looked at the directory instead could find rank
    0's write of the very step it asks about and skip the barrier the
    others wait in."""

    def __init__(self, directory: str, *, max_to_keep: int = 3, group=None, use_async: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.group = group
        self.use_async = use_async
        self.writer = group is None or dist.get_rank(group) == 0
        self.saved_step: int | None = None
        self._host: dict[str, torch.Tensor] = {}  # leaf name → host buffer of the snapshot
        self._thread: threading.Thread | None = None
        self._error: tuple[int, Exception] | None = None
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict, *, force: bool = False) -> bool:
        """Save ``state`` (a nested dict of tensors and ints) as step
        ``step``, unless ``step`` is not past ``saved_step`` and ``force``
        is not set. Returns whether it saved. Async: once the state is
        copied to the host and its write handed to the writer thread (after
        joining the previous write and raising its error); the step is on
        disk after ``wait``. Sync: once the step is on disk on every rank."""
        if not force and self.saved_step is not None and step <= self.saved_step:
            return False
        t0 = time.perf_counter()
        with obs_trace.maybe_span("ckpt.save", step=step):
            if not self.use_async:
                if self.writer:
                    self._write(step, state)
                self.wait()
            else:
                self.join()
                self._raise_write_error()
                if self.writer:
                    snapshot = self._snapshot(state)
                    self._thread = threading.Thread(target=self._write_in_background,
                                                    args=(step, snapshot), name=f"ckpt-write-{step}")
                    self._thread.start()
        _SAVE_SECONDS.observe(time.perf_counter() - t0)
        self.saved_step = step
        return True

    def _snapshot(self, state: dict) -> dict:
        """``state`` with every tensor copied into this manager's host
        buffer for its leaf (made at the first save, or when a leaf's shape
        or dtype changes); the copies are complete on return."""
        devices = set()

        def copy(tree: dict, prefix: str) -> dict:
            out = {}
            for key, val in tree.items():
                name = f"{prefix}{key}"
                if isinstance(val, dict):
                    out[key] = copy(val, name + "/")
                elif torch.is_tensor(val):
                    buf = self._host.get(name)
                    if buf is None or buf.shape != val.shape or buf.dtype != val.dtype:
                        buf = self._host[name] = torch.empty(val.shape, dtype=val.dtype,
                                                             pin_memory=val.is_cuda)
                    buf.copy_(val.detach(), non_blocking=val.is_cuda)
                    if val.is_cuda:
                        devices.add(val.device)
                    out[key] = buf
                else:
                    out[key] = val
            return out

        snapshot = copy(state, "")
        for device in devices:
            torch.cuda.current_stream(device).synchronize()
        return snapshot

    def _write_in_background(self, step: int, snapshot: dict) -> None:
        try:
            self._write(step, snapshot)
        except Exception as e:  # noqa: BLE001 — raised on the main thread by the next save or wait
            self._error = (step, e)

    def _write(self, step: int, state: dict) -> None:
        t0 = time.perf_counter()
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)  # a forced re-save of the same step
        os.rename(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        _WRITE_SECONDS.observe(time.perf_counter() - t0)
        obs_logging.info(f"[ckpt] step {step} published", step=step)

    def _raise_write_error(self) -> None:
        if self._error is not None:
            step, err = self._error
            self._error = None
            raise RuntimeError(f"the checkpoint write of step {step} failed: {err}") from err

    def join(self) -> None:
        """Return once the write in flight (if any) has ended; no barrier,
        and its error stays for the next ``save`` or ``wait`` to raise."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def wait(self) -> None:
        """Return once every rank's saves are on disk: join the write in
        flight, raise the error it hit, then a barrier over the gang."""
        self.join()
        self._raise_write_error()
        if self.group is not None:
            dist.barrier(group=self.group)

    def close(self) -> None:
        """``wait``, then release the host buffers."""
        self.wait()
        self._host.clear()

    def restore(self, step: int | None = None) -> dict:
        """The saved state of ``step`` (default: the newest), memory-mapped on
        the host; the caller copies it into its own tensors."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        path = os.path.join(self.directory, str(step), STATE_FILE)
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def _quarantine_step(ckpt_dir: str, step: int) -> None:
    """Move a corrupt step out of sight (a non-numeric name), kept on disk
    for post-mortem. The gang's ranks share the directory and all hit the
    torn step at once: losing the rename to a peer is success, and a peer's
    quarantined copy is never removed."""
    src = os.path.join(ckpt_dir, str(step))
    dst = os.path.join(ckpt_dir, f".corrupt-{step}")
    try:
        os.rename(src, dst)
    except FileNotFoundError:
        return  # a peer quarantined it
    except OSError:
        # a quarantine left from an earlier incident: replace it
        shutil.rmtree(dst, ignore_errors=True)
        try:
            os.rename(src, dst)
        except FileNotFoundError:
            return


def restore_or_init(
    ckpt_dir: str | None,
    init_fn: Callable[[], Any],
    load_fn: Callable[[Any, dict], Any],
    *,
    max_to_keep: int = 3,
    group=None,
    use_async: bool = True,
) -> tuple[Any, CheckpointManager | None, int]:
    """The resume path: (state, manager, start_step).

    No ``ckpt_dir`` → (init_fn(), None, 0). Otherwise the newest step that
    loads is restored into the freshly initialised state with
    ``load_fn(state, saved)``, which checks every leaf before it copies any,
    so a torn step leaves the fresh state intact; a step that fails to load
    or to apply is quarantined and the previous one is tried. In a gang
    (``group``) every rank restores, then the ranks gather their steps and
    check that they agree; the gather is also the barrier that keeps a rank
    from pruning a step a peer still reads. The manager saves in the
    background unless ``use_async`` is False. Steps still being written
    (``.tmp-*``) are never read."""
    state = init_fn()
    if not ckpt_dir:
        return state, None, 0
    mgr = CheckpointManager(ckpt_dir, max_to_keep=max_to_keep, group=group, use_async=use_async)
    if mgr.writer:
        maybe_corrupt_checkpoint(mgr.directory)  # no-op unless a chaos fault is armed
    mgr.wait()
    while True:
        step = mgr.latest_step()
        if step is None:
            step = 0
            break
        try:
            t0 = time.perf_counter()
            with obs_trace.maybe_span("ckpt.restore", step=step):
                state = load_fn(state, mgr.restore(step))
            _RESTORE_SECONDS.observe(time.perf_counter() - t0)
            break
        except Exception as e:  # noqa: BLE001 — any torn artifact must fall back, not crash
            obs_logging.warning(
                f"[ckpt] restore of step {step} failed ({type(e).__name__}: {e}); "
                "quarantining it and falling back to the previous step", step=step)
            _quarantine_step(mgr.directory, step)
    if group is not None:
        steps = [None] * dist.get_world_size(group)
        dist.all_gather_object(steps, step, group=group)
        if len(set(steps)) != 1:
            raise RuntimeError(f"the gang's ranks restored different checkpoint steps {steps}")
    mgr.saved_step = step or None
    return state, mgr, step


class UrgentSaveSignal:
    """Polls ``<TONY_TRAIN_METRICS_FILE>.drain``, the request the executor
    drops when the pool asks the job to drain, at most once per
    ``TONY_PROFILE_POLL_MS`` (500 ms by default; one clock read otherwise).
    The loop force-saves on a new request and calls ``acknowledge`` with
    the saved step; it keeps stepping after that, since yielding is the
    AM's move."""

    def __init__(self) -> None:
        env = os.environ
        self._path = env.get(constants.ENV_TRAIN_METRICS_FILE, "")
        try:
            poll_ms = int(env.get(constants.ENV_PROFILE_POLL_MS, "500") or 500)
        except ValueError:
            poll_ms = 500
        self._interval_s = max(poll_ms, 50) / 1000.0
        self._next_poll = 0.0
        self._handled: set[str] = set()

    def poll(self) -> str | None:
        """The pending request id, once per request; None when idle."""
        if not self._path:
            return None
        now = time.monotonic()
        if now < self._next_poll:
            return None
        self._next_poll = now + self._interval_s
        ctl = introspect.read_json(self._path + introspect.DRAIN_CONTROL_SUFFIX)
        req_id = str((ctl or {}).get("req_id") or "")
        if not req_id or req_id in self._handled:
            return None
        self._handled.add(req_id)
        return req_id

    def acknowledge(self, req_id: str, step: int) -> None:
        """Publish the done file the executor reports back."""
        if not self._path:
            return
        try:
            introspect.write_json_atomic(self._path + introspect.DRAIN_DONE_SUFFIX,
                                         {"req_id": req_id, "step": int(step)})
        except OSError:
            pass  # best-effort: the AM's yield deadline covers a lost answer
