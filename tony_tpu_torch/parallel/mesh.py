"""Mesh construction over the canonical parallelism axes.

Counterpart of ``tony_tpu/parallel/mesh.py``: the same six axes
(``stage``, ``data``, ``fsdp``, ``expert``, ``context``, ``model``) and the
same ``MeshSpec``. The port runs five axes:

- ``context``: every context shard on this process's one device, in the
  ``Mesh``'s ``ring`` (a ``DeviceRing``), as the JAX package's
  single-process mesh over virtual devices holds them;
- ``data`` and ``fsdp``: the gang, one device a process, rank r at
  (data r // fsdp, fsdp r % fsdp). The batch splits over both (JAX's
  ``batch_spec(("data", "fsdp"))``), and the trainer reduces the gradients
  over the ``Mesh``'s ``group`` (all of them); ``fsdp`` also splits the
  parameters and their optimizer state (``parallel/sharding.py``), which
  the ``device_mesh``'s (a torch ``DeviceMesh`` over (data, fsdp)) groups
  gather and reduce-scatter. ``MeshSpec.auto`` fills the gang into
  ``fsdp``, as JAX's does; a data axis is asked for by name
  (``MeshSpec(data=2)``);
- ``model``: Megatron's tensor parallelism (Llama and Mixtral), one device a
  process: the gang's ranks are laid out row-major over (data, fsdp,
  model), ``model`` varying fastest as in JAX's ``ALL_AXES`` order. The
  ranks of one model line hold the other blocks of the same leaves and
  take the same rows, so the ``Mesh``'s ``group`` is then the data × fsdp
  ranks of this rank's model index, and ``model_group(mesh)`` the model
  line;
- ``expert``: expert parallelism (Mixtral), one device a process, laid out
  between fsdp and model as in ``ALL_AXES``: the ranks of one expert line
  take the same rows and hold the other experts of the same leaves (rank
  ``ei`` the contiguous span ``[ei·E/ep, (ei+1)·E/ep)``), so the ``group``
  is the data × fsdp ranks of this rank's expert index and
  ``expert_group(mesh)`` the expert line.

``build`` gives a ``Mesh`` whose ``shape`` is the JAX mesh's dict and whose
``device`` is the card (or the CPU, when asked for). A context axis across
a gang or beside a model axis (A12), an expert axis beside a model or
context axis (A11's rest: JAX's GSPMD gather fallback) and a stage axis
above 1 (A13) raise until they are ported.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields

import torch
import torch.distributed as dist

from tony_tpu_torch import constants
from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.parallel.collectives import DeviceRing
from tony_tpu_torch.runtime import gang_device_mesh, process_count

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_MODEL = "model"
AXIS_CONTEXT = "context"
AXIS_EXPERT = "expert"
AXIS_STAGE = "stage"

# canonical order: slowest-varying (DCN-friendly) first
ALL_AXES = (AXIS_STAGE, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_CONTEXT, AXIS_MODEL)
DCN_SAFE_AXES = frozenset({AXIS_DATA, AXIS_FSDP, AXIS_STAGE})
_UNPORTED = {AXIS_STAGE: "A13"}
#: the axes every port model runs under (``context_degree``): the context
#: ring, and the gang's data, fsdp and expert axes (a family without
#: experts is refused an expert axis by the training loop); a model that
#: runs tensor parallelism also runs the model axis
_MODEL_AXES = (AXIS_CONTEXT, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT)
#: the gang's axes, in ``ALL_AXES`` order: the ``DeviceMesh``'s dimensions
GANG_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_MODEL)


@dataclass(frozen=True)
class Mesh:
    """What the port reads of a mesh: ``shape`` (axis → size, all six axes),
    the device the shards live on, the context ring, the process group the
    batch splits over (the data × fsdp ranks of this rank's expert and
    model index: the whole gang without either axis; None for one
    process), the gang's ``DeviceMesh`` over (data, fsdp, expert, model)
    and the whole gang's group, which
    saves and restores checkpoints together (both None for one process)."""

    shape: dict
    device: torch.device
    ring: DeviceRing
    group: object = None
    device_mesh: object = None
    gang: object = None

    def axis_group(self, axis: str):
        """The process group of this rank's line along a gang axis."""
        return self.device_mesh.get_group(axis)

    def axis_index(self, axis: str) -> int:
        """This rank's position along a gang axis."""
        return self.device_mesh.get_local_rank(axis) if self.device_mesh is not None else 0


def axis_size(mesh: Mesh | None, axis: str) -> int:
    """The size of ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape[axis]


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
    def auto(cls, n_devices: int | None = None, *, model: int = 1, context: int = 1,
             expert: int = 1, stage: int = 1) -> "MeshSpec":
        """Fill the devices left after the asked axes into fsdp, as JAX's
        launch-time path does. The devices default to the gang's: each
        process holds every context shard on its one device, as JAX's
        single-process mesh does over virtual devices."""
        n = n_devices if n_devices is not None else process_count() * context
        used = model * context * expert * stage
        if n % used:
            raise ValueError(f"{n} devices not divisible by model*context*expert*stage={used}")
        rest = n // used
        return cls(stage=stage, fsdp=rest, expert=expert, context=context, model=model)

    def build(self, device: torch.device | str | None = None) -> Mesh:
        """A ``Mesh`` on ``device`` (CUDA unless the CPU is asked for) whose
        context ring holds all ``context`` shards there and whose data, fsdp,
        expert and model axes are the gang this process joined (``data ×
        fsdp × expert × model`` its processes). A gang over ``TPU_NUM_SLICES`` slices (the env; 1 when
        unset) puts a slice boundary on one axis, which a data, fsdp or
        stage axis must absorb, as in JAX; the gang's axes are outermost."""
        unported = {a: self.axis_sizes[a] for a in self.active_axes() if a in _UNPORTED}
        if unported:
            items = sorted(set(_UNPORTED[a] for a in unported))
            raise NotImplementedError(
                f"mesh axes {unported} are not ported yet (ROADMAP queue {', '.join(items)}; experts "
                "with pipeline stages come with A13); "
                "the port runs the data, fsdp, expert and model axes (the gang) and a context axis")
        if self.expert > 1 and (self.model > 1 or self.context > 1):
            raise NotImplementedError(
                f"an expert axis ({self.expert}) beside a model ({self.model}) or context ({self.context}) "
                "axis is not ported yet (ROADMAP queue A11, the rest: JAX runs that layout through its GSPMD "
                "gather dispatch); the port runs the expert axis with the data and fsdp axes")
        if self.model > 1 and self.context > 1:
            raise NotImplementedError(
                f"a model axis ({self.model}) beside a context axis ({self.context}) is not ported yet "
                "(ROADMAP queue A12): the port runs the model axis (A8b) across a gang and holds every "
                "context shard in one process")
        procs = self.data * self.fsdp * self.expert * self.model
        if procs > 1 and self.context > 1:
            raise NotImplementedError(
                f"a context axis ({self.context}) across a gang of {procs} processes is not "
                "ported yet (ROADMAP queue A12); the port holds every context shard in one process")
        if procs != process_count():
            raise ValueError(f"data {self.data} x fsdp {self.fsdp} x expert {self.expert} x model {self.model} "
                             f"needs a gang of as many processes, one device a process; this gang has "
                             f"{process_count()}")
        num_slices = int(os.environ.get(constants.ENV_TPU_NUM_SLICES, "1") or "1")
        if num_slices > 1 and not any(self.axis_sizes[a] % num_slices == 0 and self.axis_sizes[a] > 1
                                      for a in ALL_AXES if a in DCN_SAFE_AXES):
            raise ValueError(f"cannot place {num_slices} slices: no DCN-safe axis "
                             f"(one of {sorted(DCN_SAFE_AXES)}) is divisible by the slice count")
        dev = resolve_device(device)
        if procs == 1:
            return Mesh(shape={a: self.axis_sizes[a] for a in ALL_AXES}, device=dev,
                        ring=DeviceRing(self.context, dev))
        device_mesh = gang_device_mesh(dev.type, (self.data, self.fsdp, self.expert, self.model), GANG_AXES)
        group = dist.group.WORLD
        inner = self.expert * self.model
        if inner > 1:
            # one group an (expert, model) index, every rank making all of them in order
            group, _ = dist.new_subgroups_by_enumeration(
                [list(range(m, procs, inner)) for m in range(inner)])
        return Mesh(shape={a: self.axis_sizes[a] for a in ALL_AXES}, device=dev,
                    ring=DeviceRing(self.context, dev), group=group, device_mesh=device_mesh,
                    gang=dist.group.WORLD)


def context_degree(mesh, tensor_parallel: bool = False) -> int:
    """The context degree of ``mesh`` (1 for None); raises for a mesh the
    port does not run (a stage axis above 1, a model axis where the caller
    does not run ``tensor_parallel``, or not a mesh of the port). The data,
    fsdp, expert and model axes are the gang's."""
    if mesh is None:
        return 1
    shape = mesh.shape if isinstance(mesh, Mesh) else None
    runs = _MODEL_AXES + ((AXIS_MODEL,) if tensor_parallel else ())
    if shape is None or any(v > 1 for a, v in shape.items() if a not in runs):
        raise NotImplementedError(
            "a device mesh with TP or pipeline axes is not ported yet for this model "
            "(ROADMAP queue A8b's second part: BERT on the model axis; A13); "
            "the port runs the data, fsdp, expert and context axes, and the model axis for Llama and Mixtral")
    return shape[AXIS_CONTEXT]


def model_group(mesh):
    """The process group of this rank's model line (None for no mesh or a
    model axis of 1): Megatron's pair and the vocab-parallel loss reduce
    over it."""
    return mesh.axis_group(AXIS_MODEL) if axis_size(mesh, AXIS_MODEL) > 1 else None


def expert_group(mesh):
    """The process group of this rank's expert line (None for no mesh or an
    expert axis of 1): the expert-parallel MoE sums its output over it."""
    return mesh.axis_group(AXIS_EXPERT) if axis_size(mesh, AXIS_EXPERT) > 1 else None
