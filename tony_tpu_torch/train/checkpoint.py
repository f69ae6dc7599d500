"""Checkpointing + resume for the training loop.

Counterpart of ``tony_tpu/train/checkpoint.py`` on ``torch.save``: a step
is written to a private temporary directory and published by renaming it
to ``<dir>/<step>``, so a reader never sees a half-written step under its
final name; ``max_to_keep`` prunes the oldest steps. ``restore_or_init``
keeps the JAX function's corruption tolerance: a step that fails to load is
quarantined as ``.corrupt-<step>`` and the next-newest step is tried, down
to a fresh init. Saves are synchronous (the JAX manager's are async through
Orbax). The chaos hook and ``UrgentSaveSignal`` are not ported yet (ROADMAP
queue A6).
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Any, Callable

import torch

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict) -> None:
        """Write ``state`` (a nested dict of tensors and ints) as step ``step``."""
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)  # a forced re-save of the same step
        os.rename(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

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
    for post-mortem; a peer that already moved it is success."""
    src = os.path.join(ckpt_dir, str(step))
    dst = os.path.join(ckpt_dir, f".corrupt-{step}")
    shutil.rmtree(dst, ignore_errors=True)
    try:
        os.rename(src, dst)
    except FileNotFoundError:
        pass


def restore_or_init(
    ckpt_dir: str | None,
    init_fn: Callable[[], Any],
    load_fn: Callable[[Any, dict], Any],
    *,
    max_to_keep: int = 3,
) -> tuple[Any, CheckpointManager | None, int]:
    """The resume path: (state, manager, start_step).

    No ``ckpt_dir`` → (init_fn(), None, 0). Otherwise the newest step that
    loads is restored into the freshly initialised state with
    ``load_fn(state, saved)``, which checks every leaf before it copies any,
    so a torn step leaves the fresh state intact; a step that fails to load
    or to apply is quarantined and the previous one is tried."""
    state = init_fn()
    if not ckpt_dir:
        return state, None, 0
    mgr = CheckpointManager(ckpt_dir, max_to_keep=max_to_keep)
    while True:
        step = mgr.latest_step()
        if step is None:
            return state, mgr, 0
        try:
            return load_fn(state, mgr.restore(step)), mgr, step
        except Exception as e:  # noqa: BLE001 — any torn artifact must fall back, not crash
            log.warning("[ckpt] restore of step %d failed (%s: %s); quarantining it and "
                        "falling back to the previous step", step, type(e).__name__, e)
            _quarantine_step(mgr.directory, step)
