"""Mesh construction over the canonical parallelism axes.

Counterpart of ``tony_tpu/parallel/mesh.py``: the same six axes
(``stage``, ``data``, ``fsdp``, ``expert``, ``context``, ``model``) and the
same ``MeshSpec``. The port runs the ``context`` axis only: ``build`` gives
a ``Mesh`` whose ``shape`` is the JAX mesh's dict, whose ``device`` is the
one card (or the CPU, when asked for) and whose ``ring`` is a
``DeviceRing`` holding every context shard there, as the JAX package's
single-process mesh over virtual devices does. Any other axis above 1
raises until it is ported (FSDP/TP: ROADMAP A8; experts: A11; stages: A13).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.parallel.collectives import DeviceRing

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_MODEL = "model"
AXIS_CONTEXT = "context"
AXIS_EXPERT = "expert"
AXIS_STAGE = "stage"

ALL_AXES = (AXIS_STAGE, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_CONTEXT, AXIS_MODEL)
_UNPORTED = {AXIS_DATA: "A8", AXIS_FSDP: "A8", AXIS_MODEL: "A8", AXIS_EXPERT: "A11",
             AXIS_STAGE: "A13"}


@dataclass(frozen=True)
class Mesh:
    """What the port's model code reads of a mesh: ``shape`` (axis → size,
    all six axes), the device the shards live on, and the context ring."""

    shape: dict
    device: torch.device
    ring: DeviceRing


@dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape over the canonical axes."""

    stage: int = 1
    data: int = 1
    fsdp: int = 1
    expert: int = 1
    context: int = 1
    model: int = 1

    @property
    def axis_sizes(self) -> dict[str, int]:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def active_axes(self) -> tuple[str, ...]:
        """Axes with size > 1, canonical order."""
        return tuple(a for a in ALL_AXES if self.axis_sizes[a] > 1)

    def build(self, device: torch.device | str | None = None) -> Mesh:
        """A ``Mesh`` on ``device`` (CUDA unless the CPU is asked for) whose
        context ring holds all ``context`` shards there."""
        unported = {a: self.axis_sizes[a] for a in self.active_axes() if a != AXIS_CONTEXT}
        if unported:
            items = sorted(set(_UNPORTED[a] for a in unported))
            raise NotImplementedError(
                f"mesh axes {unported} are not ported yet (ROADMAP queue {', '.join(items)}); "
                "the port runs a context axis only")
        dev = resolve_device(device)
        return Mesh(shape={a: self.axis_sizes[a] for a in ALL_AXES}, device=dev,
                    ring=DeviceRing(self.context, dev))


def context_degree(mesh) -> int:
    """The context degree of ``mesh`` (1 for None); raises for a mesh the
    port does not run (any other axis above 1, or not a mesh of the port)."""
    if mesh is None:
        return 1
    shape = mesh.shape if isinstance(mesh, Mesh) else None
    if shape is None or any(v > 1 for a, v in shape.items() if a != AXIS_CONTEXT):
        raise NotImplementedError(
            "a device mesh with FSDP/TP, expert or pipeline axes is not ported yet "
            "(ROADMAP queue A8, A11, A13); the port runs a context axis only")
    return shape[AXIS_CONTEXT]
