"""The file contract between the executor and the training child (own copy
of the subset of ``tony_tpu/obs/introspect.py`` the child needs).

Next to ``<train-metrics-file>`` (``TONY_TRAIN_METRICS_FILE``):

========================  ====================================================
``<metrics>.profile``      on-demand profile request the executor writes:
                           ``{"req_id", "num_steps", "memory", "dir"}``
``<metrics>.profile.done`` the child's result: ``{"req_id", "ok", "dir",
                           "artifacts", "steps_captured", "step_times_ms",
                           "truncated", "error"}``
``<metrics>.drain``        urgent-checkpoint request (cooperative preemption)
``<metrics>.drain.done``   the child's answer: ``{"req_id", "step"}``
========================  ====================================================
"""

from __future__ import annotations

import json
import os
from typing import Any

CONTROL_SUFFIX = ".profile"
DONE_SUFFIX = ".profile.done"
DRAIN_CONTROL_SUFFIX = ".drain"
DRAIN_DONE_SUFFIX = ".drain.done"


def write_json_atomic(path: str, obj: Any) -> None:
    """tmp + rename, so a reader never sees a torn file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def read_json(path: str) -> dict[str, Any] | None:
    """The JSON object at ``path``, or None (missing, torn or not a dict)."""
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return None
    return d if isinstance(d, dict) else None
