"""Checkpoint corruption (own copy of ``tony_tpu/chaos/inject.py`` on the
port's checkpoint layout, ``<dir>/<step>/state.pt`` or a sharded step's
DCP files).

``corrupt_latest_checkpoint`` tears the newest step as a crash mid-write
would (every file truncated to zero, or garbled with ``mode="garbage"``);
``maybe_corrupt_checkpoint`` is the hook ``restore_or_init`` calls before
its first restore: a no-op unless the process carries a ``ckpt-corrupt``
fault, which then fires once per job.
"""

from __future__ import annotations

import os

from tony_tpu_torch.chaos.context import ChaosContext


def _step_dirs(directory: str) -> list[int]:
    try:
        return sorted(int(n) for n in os.listdir(directory) if n.isdigit())
    except OSError:
        return []


def corrupt_latest_checkpoint(directory: str, mode: str = "truncate") -> int | None:
    """Tear every file of the newest step; the step, or None if there is none."""
    steps = _step_dirs(directory)
    if not steps:
        return None
    for dirpath, _, files in os.walk(os.path.join(directory, str(steps[-1]))):
        for fn in files:
            try:
                with open(os.path.join(dirpath, fn), "wb") as fh:
                    if mode == "garbage":
                        fh.write(b"\xde\xad\xbe\xef")
            except OSError:
                continue
    return steps[-1]


def maybe_corrupt_checkpoint(directory: str) -> int | None:
    """Fire the armed ``ckpt-corrupt`` fault against ``directory`` when it
    holds a step to tear; the torn step, or None."""
    ctx = ChaosContext.from_env()
    if ctx is None or not _step_dirs(directory):
        return None  # nothing to corrupt yet: the once-per-job latch stays unspent
    f = ctx.take("ckpt-corrupt", detail={"directory": directory})
    if f is None:
        return None
    return corrupt_latest_checkpoint(directory, mode=f.args[1] if len(f.args) > 1 else "truncate")
