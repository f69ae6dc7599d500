"""Mesh construction over the canonical parallelism axes.

Counterpart of ``tony_tpu/parallel/mesh.py``: the same six axes
(``stage``, ``data``, ``fsdp``, ``expert``, ``context``, ``model``) and the
same ``MeshSpec``. The port runs two axes:

- ``context``: every context shard on this process's one device, in the
  ``Mesh``'s ``ring`` (a ``DeviceRing``), as the JAX package's
  single-process mesh over virtual devices holds them;
- ``data``: the gang, one device a process; the trainer all-reduces the
  gradients over the ``Mesh``'s ``group``. ``MeshSpec.auto`` fills the gang
  into it, which is the math of JAX's fill into ``fsdp`` while parameters
  are not sharded (ROADMAP A8).

``build`` gives a ``Mesh`` whose ``shape`` is the JAX mesh's dict and whose
``device`` is the card (or the CPU, when asked for). Both axes above 1 at
once (a context axis across a gang, A12), and any other axis above 1, raise
until they are ported (FSDP/TP: A8; experts: A11; stages: A13).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch
import torch.distributed as dist

from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.parallel.collectives import DeviceRing
from tony_tpu_torch.runtime import process_count

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_MODEL = "model"
AXIS_CONTEXT = "context"
AXIS_EXPERT = "expert"
AXIS_STAGE = "stage"

ALL_AXES = (AXIS_STAGE, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_CONTEXT, AXIS_MODEL)
_UNPORTED = {AXIS_FSDP: "A8", AXIS_MODEL: "A8", AXIS_EXPERT: "A11", AXIS_STAGE: "A13"}
#: the axes a port model sees through ``context_degree``; the data axis is
#: the trainer's (gradients reduced over ``Mesh.group``)
_MODEL_AXES = (AXIS_CONTEXT, AXIS_DATA)


@dataclass(frozen=True)
class Mesh:
    """What the port reads of a mesh: ``shape`` (axis → size, all six axes),
    the device the shards live on, the context ring, and the data axis's
    process group (None for one process)."""

    shape: dict
    device: torch.device
    ring: DeviceRing
    group: object = None


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

    @classmethod
    def auto(cls, *, model: int = 1, context: int = 1, expert: int = 1,
             stage: int = 1) -> "MeshSpec":
        """The gang's processes fill the data axis; the other axes are as asked."""
        return cls(stage=stage, data=process_count(), expert=expert, context=context, model=model)

    def build(self, device: torch.device | str | None = None) -> Mesh:
        """A ``Mesh`` on ``device`` (CUDA unless the CPU is asked for) whose
        context ring holds all ``context`` shards there and whose data axis
        is the gang this process joined."""
        unported = {a: self.axis_sizes[a] for a in self.active_axes() if a in _UNPORTED}
        if unported:
            items = sorted(set(_UNPORTED[a] for a in unported))
            raise NotImplementedError(
                f"mesh axes {unported} are not ported yet (ROADMAP queue {', '.join(items)}); "
                "the port runs a data axis (the gang) and a context axis")
        if self.data > 1 and self.context > 1:
            raise NotImplementedError(
                f"a context axis ({self.context}) across a gang of {self.data} processes is not "
                "ported yet (ROADMAP queue A12); the port holds every context shard in one process")
        if self.data != process_count():
            raise ValueError(f"data axis {self.data} needs a gang of as many processes, one device "
                             f"a process; this gang has {process_count()}")
        dev = resolve_device(device)
        return Mesh(shape={a: self.axis_sizes[a] for a in ALL_AXES}, device=dev,
                    ring=DeviceRing(self.context, dev),
                    group=dist.group.WORLD if self.data > 1 else None)


def context_degree(mesh) -> int:
    """The context degree of ``mesh`` (1 for None); raises for a mesh the
    port does not run (FSDP/TP, expert or stage axes above 1, or not a mesh
    of the port). A data axis is invisible to the model."""
    if mesh is None:
        return 1
    shape = mesh.shape if isinstance(mesh, Mesh) else None
    if shape is None or any(v > 1 for a, v in shape.items() if a not in _MODEL_AXES):
        raise NotImplementedError(
            "a device mesh with FSDP/TP, expert or pipeline axes is not ported yet "
            "(ROADMAP queue A8, A11, A13); the port runs a data and a context axis")
    return shape[AXIS_CONTEXT]
