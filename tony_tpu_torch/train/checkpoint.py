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

The manager knows no state's schema: it writes the nested dict it is
handed. Where every leaf is whole (one process, a data axis, an fsdp axis
of 1) rank 0 writes it with ``torch.save``. Where some leaves are this
rank's blocks of a whole leaf (``DTensor``s: the state's layout splits
them over an fsdp axis above 1), every rank writes its own blocks through
``torch.distributed.checkpoint`` (DCP) into one shared temporary
directory; DCP's collectives run on a gloo group of the manager's own, in
the writer thread, and rank 0 publishes the step once DCP has written
every rank's files and the metadata. ``wait`` ends in a barrier, so once
it has returned on every rank the step is on the shared directory; a
synchronous ``save`` ends in ``wait``.

Restore imposes the caller's state, as JAX's does (the elastic contract,
``tony_tpu/train/checkpoint.py:9-16``): ``restore(step, like)`` reads a DCP
step as the caller's ``state_dict()`` holds it (its blocks where that
holds a ``DTensor``, whole leaves elsewhere), whatever gang wrote it, so a
step written on ``{fsdp: 4}`` restores onto ``{fsdp: 2}``, ``{data: 2}``
or one process; a ``state.pt`` step comes back whole, and the caller cuts
its blocks. DCP and ``DTensor`` are imported only where a sharded step is
written or read.

A stage gang's ranks hold different leaves (``parallel/sharding.py``
``stage_owner``): each saves only its own, so DCP's metadata holds each leaf
once, the embedding from the first stage's ranks and the head from the
last's, with ``Replicate`` on the stage dim where one stage holds a leaf.
A restore reads the leaves the caller holds and names the others as None,
for the caller to check (``TrainState.load``).
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
import sys
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
    process group (None for one process); its rank 0 publishes each step
    (``writer``); every rank writes its blocks of a state that holds some.
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
        # DCP's collectives (a sharded state's saves) run in the writer
        # thread: a group of their own, made by every rank here, keeps them
        # apart from the step's
        self._dcp_group = dist.new_group(backend="gloo") if group is not None else None
        self._host_meshes: dict = {}  # a block's DeviceMesh → its twin on the host
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
        writes = self.writer or any(_is_block(v) for _, v in _flat(state))
        with obs_trace.maybe_span("ckpt.save", step=step):
            if not self.use_async:
                if writes:
                    self._write(step, state)
                self.wait()
            else:
                self.join()
                self._raise_write_error()
                if writes:
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
        or dtype changes), a block rewrapped on the host twin of its mesh;
        the copies are complete on return."""
        devices = set()

        def copy(tree: dict, prefix: str) -> dict:
            out = {}
            for key, val in tree.items():
                name = f"{prefix}{key}"
                if isinstance(val, dict):
                    out[key] = copy(val, name + "/")
                elif torch.is_tensor(val):
                    local = val.to_local() if _is_block(val) else val
                    buf = self._host.get(name)
                    if buf is None or buf.shape != local.shape or buf.dtype != local.dtype:
                        buf = self._host[name] = torch.empty(local.shape, dtype=local.dtype,
                                                             pin_memory=local.is_cuda)
                    buf.copy_(local.detach(), non_blocking=local.is_cuda)
                    if local.is_cuda:
                        devices.add(local.device)
                    out[key] = _rewrap(buf, val, self._host_mesh(val.device_mesh)) if _is_block(val) else buf
                else:
                    out[key] = val
            return out

        snapshot = copy(state, "")
        for device in devices:
            torch.cuda.current_stream(device).synchronize()
        return snapshot

    def _host_mesh(self, device_mesh):
        """``device_mesh``'s twin on the host (itself on a CPU gang), made
        once: a block on a CUDA mesh would move a host buffer to the card.
        It holds the same process groups, and DCP reads only the rank's
        coordinates of it; DCP's collectives run on the manager's group."""
        if device_mesh.device_type == "cpu":
            return device_mesh
        key = id(device_mesh)
        if key not in self._host_meshes:
            from torch.distributed.device_mesh import DeviceMesh

            names = device_mesh.mesh_dim_names
            self._host_meshes[key] = (device_mesh, DeviceMesh.from_group(
                [device_mesh.get_group(n) for n in names], "cpu", mesh=device_mesh.mesh, mesh_dim_names=names))
        return self._host_meshes[key][1]

    def _write_in_background(self, step: int, snapshot: dict) -> None:
        try:
            self._write(step, snapshot)
        except Exception as e:  # noqa: BLE001 — raised on the main thread by the next save or wait
            self._error = (step, e)

    def _write(self, step: int, state: dict) -> None:
        t0 = time.perf_counter()
        final = os.path.join(self.directory, str(step))
        if not any(_is_block(v) for _, v in _flat(state)):
            tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(state, os.path.join(tmp, STATE_FILE))
        else:
            # one directory for the gang's ranks: rank 0 clears a stale one
            # first, and DCP writes no file before its first collective,
            # which waits for rank 0
            import torch.distributed.checkpoint as dcp

            tmp = os.path.join(self.directory, f".tmp-{step}")
            if self.writer:
                shutil.rmtree(tmp, ignore_errors=True)
            dcp.save(dict(_flat(state)), storage_writer=dcp.FileSystemWriter(tmp),
                     process_group=self._dcp_group)  # returns once every rank's files and the metadata are written
        if self.writer:
            shutil.rmtree(final, ignore_errors=True)  # a forced re-save of the same step
            os.rename(tmp, final)
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
            obs_logging.info(f"[ckpt] step {step} published", step=step)
        _WRITE_SECONDS.observe(time.perf_counter() - t0)

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

    def restore(self, step: int | None = None, like: dict | None = None) -> dict:
        """The saved state of ``step`` (default: the newest) on the host, for
        the caller to copy into its own tensors: a ``state.pt`` step's dict,
        memory-mapped, every leaf whole; a DCP step read as ``like`` (the
        caller's ``state_dict()``) holds it (``read_sharded``)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        path = os.path.join(self.directory, str(step))
        if not os.path.exists(os.path.join(path, STATE_FILE)):
            return read_sharded(path, like, self._host_mesh)
        return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True, mmap=True)


def _is_block(v) -> bool:
    """Whether ``v`` is a rank's block of a whole leaf (a ``DTensor``); no
    value is one where ``torch.distributed.tensor`` was never imported."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(v, mod.DTensor)


def _flat(tree: dict, prefix: str = "") -> list:
    """(name, value) of a nested dict's leaves, named 'a/b/c' as DCP stores them."""
    out = []
    for k, v in tree.items():
        out += _flat(v, f"{prefix}{k}/") if isinstance(v, dict) else [(f"{prefix}{k}", v)]
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        *parents, leaf = name.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _rewrap(local: torch.Tensor, like, mesh):
    """``local`` as a block placed as ``like`` is, on ``mesh``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, like.placements, run_check=False, shape=like.shape, stride=like.stride())


def read_sharded(path: str, like: dict | None = None, host_mesh=lambda m: m) -> dict:
    """A DCP step on the host: each leaf read as ``like`` holds it (this
    rank's block where ``like`` holds a ``DTensor``, whole where it holds a
    tensor), or every leaf whole without ``like``. With ``like``, every
    leaf's name, whole shape and dtype is checked against the step's
    metadata before anything is read; a leaf of the step that ``like``
    lacks (another stage's) comes back None, unread. No collective: each
    rank reads its own."""
    import torch.distributed.checkpoint as dcp

    reader = dcp.FileSystemReader(path)
    saved = reader.read_metadata().state_dict_metadata
    others = {}
    if like is None:
        targets = {name: torch.empty(tuple(m.size), dtype=m.properties.dtype) if hasattr(m, "size") else None
                   for name, m in saved.items()}
    else:
        mine = dict(_flat(like))
        if mine.keys() - saved.keys():
            raise ValueError(f"checkpoint leaves differ: {sorted(mine.keys() - saved.keys())}")
        others = dict.fromkeys(saved.keys() - mine.keys())
        targets = {}
        for name, v in mine.items():
            if not torch.is_tensor(v):
                targets[name] = v
                continue
            meta = saved[name]
            if tuple(meta.size) != tuple(v.shape) or meta.properties.dtype != v.dtype:
                raise ValueError(f"checkpoint {name}: {meta.properties.dtype}{list(meta.size)}, "
                                 f"want {v.dtype}{list(v.shape)}")
            if _is_block(v):
                targets[name] = _rewrap(torch.empty(v.to_local().shape, dtype=v.dtype), v, host_mesh(v.device_mesh))
            else:
                targets[name] = torch.empty(v.shape, dtype=v.dtype)
    dcp.load(targets, storage_reader=reader, no_dist=True)
    return _nest({**others, **{k: v.to_local() if _is_block(v) else v for k, v in targets.items()}})


def read_whole(step_dir: str) -> dict:
    """The state saved in ``step_dir`` with every leaf whole, on the host,
    whichever gang wrote it."""
    if os.path.exists(os.path.join(step_dir, STATE_FILE)):
        return torch.load(os.path.join(step_dir, STATE_FILE), map_location="cpu", weights_only=True)
    return read_sharded(str(step_dir))


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
    ``load_fn(state, saved)``, which checks every leaf before it copies any
    (``saved`` read as the state's ``state_dict()`` holds it, where the
    state has one: ``restore``'s ``like``),
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
                like = state.state_dict() if hasattr(state, "state_dict") else None
                state = load_fn(state, mgr.restore(step, like))
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
