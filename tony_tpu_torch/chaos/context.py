"""Per-process chaos decisions (own copy of the subset of
``tony_tpu/chaos/context.py`` the training child uses).

``ChaosContext.from_env`` builds from ``TONY_CHAOS_SPEC``/``TONY_CHAOS_SEED``
and is None without a schedule, so the production path pays one ``is
None``. Each (seed, identity, kind) derives its own PRNG for probability
faults; every other fault fires once per job, latched by a marker under
``<staging>/chaos/fired/`` that every process and every gang attempt of the
job shares (the same marker the JAX package's processes take). Each
injection is appended to ``<staging>/chaos/injections-<identity>.jsonl``,
which ``tony chaos`` reads.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import threading
import time
from typing import Any, Mapping

from tony_tpu_torch import constants
from tony_tpu_torch.chaos.schedule import CONTAINER_FAULTS, FaultSchedule, FaultSpec
from tony_tpu_torch.obs import metrics as obs_metrics

_INJECTIONS = obs_metrics.counter(
    "tony_chaos_injections_total", "chaos faults actually injected", labelnames=("kind",))


class ChaosContext:
    def __init__(self, schedule: FaultSchedule, identity: str, staging_dir: str | None = None):
        self.schedule = schedule
        self.identity = identity
        job, _, idx = identity.partition(":")
        self.task = (job, int(idx)) if job and idx.isdigit() else None
        self._staging = staging_dir
        self._started = time.monotonic()
        self._lock = threading.Lock()
        self._rngs: dict[str, random.Random] = {}
        self._latched: set[str] = set()

    @classmethod
    def from_env(cls, env: Mapping[str, str] | None = None) -> "ChaosContext | None":
        """From the child's env contract; None when no schedule is set."""
        env = os.environ if env is None else env
        spec = env.get(constants.ENV_CHAOS_SPEC, "")
        if not spec.strip():
            return None
        try:
            seed = int(env.get(constants.ENV_CHAOS_SEED, "0") or 0)
        except ValueError:
            seed = 0
        job, idx = env.get(constants.ENV_JOB_NAME), env.get(constants.ENV_TASK_INDEX)
        identity = f"{job}:{idx}" if job and idx is not None else "proc"
        return cls(FaultSchedule.parse(spec, seed), identity,
                   staging_dir=env.get(constants.ENV_STAGING_DIR) or None)

    def take(self, kind: str, trigger: str | None = None,
             detail: dict[str, Any] | None = None) -> FaultSpec | None:
        """The first armed fault of ``kind`` at this point, recorded and (but
        for probability faults) latched; or None."""
        for f in self.schedule.faults:
            if f.kind == kind and f.trigger == trigger and self._take_spec(f, detail):
                return f
        return None

    def _take_spec(self, f: FaultSpec, detail: dict[str, Any] | None) -> bool:
        if f.kind not in CONTAINER_FAULTS and f.target is not None and f.target != self.task:
            return False
        with self._lock:
            if f.delay_ms and (time.monotonic() - self._started) * 1000 < f.delay_ms:
                return False
            if f.step_gate:
                return False  # armed by the job's reported step, which only the AM sees
            p = f.params.get("p")
            if p is not None:
                if self._rng(f.kind).random() >= p:
                    return False
            elif f.key in self._latched or not self._latch_once_per_job(f):
                return False
            else:
                self._latched.add(f.key)
            self._record(f, detail)
            return True

    def _rng(self, kind: str) -> random.Random:
        r = self._rngs.get(kind)
        if r is None:
            h = hashlib.sha256(f"{self.schedule.seed}:{self.identity}:{kind}".encode()).digest()
            r = self._rngs[kind] = random.Random(int.from_bytes(h[:8], "big"))
        return r

    def _latch_once_per_job(self, f: FaultSpec) -> bool:
        """True exactly once per job: the creator of the marker file wins."""
        if not self._staging:
            return True  # no shared dir: the in-process latch only
        path = os.path.join(self._staging, "chaos", "fired", hashlib.sha1(f.key.encode()).hexdigest())
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        except OSError:
            return True  # unwritable staging: the in-process latch only
        with os.fdopen(fd, "w") as fh:
            fh.write(f"{self.identity} {int(time.time() * 1000)}\n")
        return True

    def _record(self, f: FaultSpec, detail: dict[str, Any] | None) -> None:
        rec = {"ts_ms": int(time.time() * 1000), "identity": self.identity, "kind": f.kind,
               "fault": f.key, **(detail or {})}
        _INJECTIONS.inc(kind=f.kind)
        if self._staging:
            safe = self.identity.replace(":", "_").replace(os.sep, "_")
            try:
                os.makedirs(os.path.join(self._staging, "chaos"), exist_ok=True)
                with open(os.path.join(self._staging, "chaos", f"injections-{safe}.jsonl"), "a") as fh:
                    fh.write(json.dumps(rec) + "\n")
            except OSError:
                pass  # the injection log is best-effort
