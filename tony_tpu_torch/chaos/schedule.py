"""The ``tony.chaos.spec`` grammar (own copy of ``tony_tpu/chaos/schedule.py``).

A schedule is a ``;``-separated list of entries
``kind[:<job>:<index>][:k=v ...][:arg ...][@trigger]``: ``<job>:<index>``
targets one task, ``k=v`` are numeric parameters (``p`` a probability,
``ms`` a duration), bare tokens are arguments, and the trigger is ``t+5s``
(armed that long after the process starts), ``step+N`` (AM-decided faults,
armed once the job reports step N) or a lifecycle point. The child parses
the whole schedule the AM parses, so a spec one accepts the other accepts.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

FAULT_KINDS = frozenset({
    "rpc-drop", "rpc-delay", "rpc-blackhole", "rpc-sever",
    "exec-crash", "exec-hang", "hb-stall", "reg-slow",
    "node-loss", "preempt", "preempt-drain", "capacity-flap",
    "am-crash", "pool-crash",
    "ckpt-corrupt",  # the newest checkpoint is torn before restore (this package)
})
#: kinds whose target names the victim container, not the injecting process
CONTAINER_FAULTS = frozenset({"node-loss", "preempt"})
STEP_GATED_FAULTS = CONTAINER_FAULTS | frozenset({"am-crash", "preempt-drain"})

_TARGET_JOB = re.compile(r"^[A-Za-z][A-Za-z0-9_\-]*$")
_TIME_RE = re.compile(r"^(\d+)(ms|s|m|h|d)?$")
_TIME_MULT = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000, "d": 86_400_000, None: 1}


def parse_time_ms(val: str) -> int:
    """'500', '500ms', '5s', '2m' → milliseconds."""
    m = _TIME_RE.match(str(val).strip())
    if not m:
        raise ValueError(f"unparseable time string: {val!r}")
    return int(m.group(1)) * _TIME_MULT[m.group(2)]


@dataclass
class FaultSpec:
    kind: str
    target: tuple[str, int] | None = None  # (job_type, index); None = any
    trigger: str | None = None             # lifecycle point
    delay_ms: int = 0                      # "@t+5s"
    step_gate: int = 0                     # "@step+4"
    args: tuple[str, ...] = ()
    params: dict[str, float] = field(default_factory=dict)
    entry: str = ""                        # the entry's text: its latch key

    @property
    def key(self) -> str:
        return self.entry or self.kind


def _parse_entry(entry: str) -> FaultSpec:
    text = entry.strip()
    body, trigger, delay_ms, step_gate = text, None, 0, 0
    at = text.rfind("@")
    if at != -1:
        body, trig = text[:at], text[at + 1:].strip()
        if trig.startswith("t+"):
            delay_ms = parse_time_ms(trig[2:])
        elif trig.startswith("step+"):
            try:
                step_gate = int(trig[5:])
            except ValueError:
                raise ValueError(f"non-integer step gate in fault entry {text!r}") from None
            if step_gate < 1:
                raise ValueError(f"step gate must be >= 1 in fault entry {text!r}")
        elif trig:
            trigger = trig
        else:
            raise ValueError(f"empty trigger in fault entry {text!r}")
    tokens = [t.strip() for t in body.split(":")]
    kind = tokens[0]
    if kind not in FAULT_KINDS:
        raise ValueError(f"unknown fault kind {kind!r} in {text!r} "
                         f"(known: {', '.join(sorted(FAULT_KINDS))})")
    target: tuple[str, int] | None = None
    args: list[str] = []
    params: dict[str, float] = {}
    rest = tokens[1:]
    i = 0
    while i < len(rest):
        tok = rest[i]
        if "=" in tok:
            k, _, v = tok.partition("=")
            try:
                params[k] = float(v)
            except ValueError:
                raise ValueError(f"non-numeric parameter {tok!r} in fault entry {text!r}") from None
        elif target is None and i + 1 < len(rest) and rest[i + 1].isdigit() and _TARGET_JOB.match(tok):
            target = (tok, int(rest[i + 1]))
            i += 1
        elif tok:
            args.append(tok)
        i += 1
    p = params.get("p")
    if p is not None and not 0 <= p <= 1:
        raise ValueError(f"probability p={p} out of [0, 1] in fault entry {text!r}")
    if step_gate and kind not in STEP_GATED_FAULTS:
        raise ValueError(f"@step+N gates are AM-decided faults only "
                         f"({', '.join(sorted(STEP_GATED_FAULTS))}) in fault entry {text!r}")
    return FaultSpec(kind, target, trigger, delay_ms, step_gate, tuple(args), params, entry=text)


@dataclass
class FaultSchedule:
    faults: tuple[FaultSpec, ...]
    seed: int = 0

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultSchedule":
        return cls(tuple(_parse_entry(e) for e in (spec or "").split(";") if e.strip()), seed)
