"""Mesh construction over the canonical parallelism axes.

Counterpart of ``tony_tpu/parallel/mesh.py``: the same six axes
(``stage``, ``data``, ``fsdp``, ``expert``, ``context``, ``model``) and the
same ``MeshSpec``. The port runs five axes:

- ``context``: the sequence split into ring shards (``Mesh.ring``). In one
  process every shard sits on its one device, in a ``DeviceRing``, as the
  JAX package's single-process mesh over virtual devices holds them. In a
  gang each process holds one shard, and the ring is a ``ProcessRing`` over
  its context line: the ranks of one context line take the same rows, each
  its window of the sequence (``context_window``), and hold the same
  blocks of every leaf (no rule splits a parameter on ``context``);
- ``data`` and ``fsdp``: the gang, one device a process, rank r at
  (data r // fsdp, fsdp r % fsdp). The batch splits over both (JAX's
  ``batch_spec(("data", "fsdp"))``), and the trainer reduces the gradients
  over the ``Mesh``'s ``group`` (all of them); ``fsdp`` also splits the
  parameters and their optimizer state (``parallel/sharding.py``), which
  the ``device_mesh``'s (a torch ``DeviceMesh`` over the gang's axes)
  groups gather and reduce-scatter. ``MeshSpec.auto`` fills the gang into
  ``fsdp``, as JAX's does; a data axis is asked for by name
  (``MeshSpec(data=2)``);
- ``model``: Megatron's tensor parallelism (Llama and Mixtral), one device a
  process: the gang's ranks are laid out row-major over (data, fsdp,
  expert, context, model), ``model`` varying fastest as in JAX's
  ``ALL_AXES`` order. The ranks of one model line hold the other blocks of
  the same leaves and take the same rows, so the ``Mesh``'s ``group`` is
  then the data × fsdp ranks of this rank's model index, and
  ``model_group(mesh)`` the model line;
- ``expert``: expert parallelism (Mixtral), one device a process, laid out
  between fsdp and context as in ``ALL_AXES``: the ranks of one expert line
  take the same rows and hold the other experts of the same leaves (rank
  ``ei`` the contiguous span ``[ei·E/ep, (ei+1)·E/ep)``), so the ``group``
  is the data × fsdp ranks of this rank's expert index and
  ``expert_group(mesh)`` the expert line.

With a context axis in a gang the ``group`` spans data × fsdp × context
(every rank: their losses are over disjoint targets, so their token counts,
gradients and router statistics are summed), and ``replicas`` is the data ×
context line that holds this rank's fsdp blocks, over which the trainer
averages them.

A model axis beside a context axis runs Megatron's pair inside each
window and the context ring on each model line, as JAX's ``shard_map`` over
``P(BATCH_AXES, "model", "context", None)`` does: the ``ProcessRing`` of a
rank is its context line, the ranks of its (data, fsdp, model) index, so KV
moves only between the ranks that hold the same ``Hkv/model`` heads; the
``group`` is the data × fsdp × context ranks of its model index, and
``replicas`` the data × context ranks of its (fsdp, model) index.

- ``stage``: pipeline parallelism (Llama and Mixtral, the 1F1B schedule of
  ``parallel/pipeline.py``), one stage a process, laid out outermost as in
  ``ALL_AXES``: the ranks of one stage line (``Mesh.stage_line``, the ranks
  of one (data, fsdp) index) take the same rows, as JAX replicates the
  batch over ``stage``, and hold the other stages' layers; the ``group`` is
  the data × fsdp ranks of this rank's stage index. Beside it the port runs
  the data and fsdp axes; a context axis is refused in JAX's words, and a
  model axis, or an expert axis for Llama, waits for A13c (JAX refuses
  Mixtral's expert axis with stages, in the words the loop repeats).

``build`` gives a ``Mesh`` whose ``shape`` is the JAX mesh's dict and whose
``device`` is the card (or the CPU, when asked for). An expert axis beside a
model or context axis (A11's rest: JAX's GSPMD gather fallback) raises until
it is ported.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields

import torch
import torch.distributed as dist

from tony_tpu_torch import constants
from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.parallel.collectives import DeviceRing, ProcessRing
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
#: the axes every port model runs under (``context_degree``): the context
#: ring, and the gang's data, fsdp and expert axes (a family without
#: experts is refused an expert axis by the training loop); a model that
#: runs tensor parallelism also runs the model axis
_MODEL_AXES = (AXIS_CONTEXT, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT)
#: the gang's axes, in ``ALL_AXES`` order: the ``DeviceMesh``'s dimensions
GANG_AXES = (AXIS_STAGE, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_CONTEXT, AXIS_MODEL)
#: JAX's refusal of a stage axis beside a context axis (``llama.py:431``)
STAGE_CONTEXT = "pipeline parallelism does not compose with a context axis"


@dataclass(frozen=True)
class Mesh:
    """What the port reads of a mesh: ``shape`` (axis → size, all six axes),
    the device the shards live on, the context ring (a ``DeviceRing`` in
    one process, a ``ProcessRing`` over the context line in a gang), the
    process group the batch splits over (the data × fsdp × context ranks of
    this rank's stage, expert and model index: the whole gang without those
    axes; None for one process), the gang's ``DeviceMesh`` over (stage,
    data, fsdp, expert, context, model), the whole gang's group, which saves
    and restores checkpoints together, and ``replicas``, the group of the data
    × context ranks that hold this rank's fsdp blocks (None where both axes
    are 1; all but ``shape``, ``device`` and ``ring`` None for one
    process)."""

    shape: dict
    device: torch.device
    ring: DeviceRing | ProcessRing
    group: object = None
    device_mesh: object = None
    gang: object = None
    replicas: object = None

    @property
    def context_line(self):
        """The process group of this rank's context line where the context
        axis spans processes, one shard a process (its ranks share their
        rows, each a window of them); None where this process holds every
        shard of the ring."""
        return self.ring.group if len(self.ring.positions) < self.ring.n else None

    @property
    def stage_line(self):
        """The process group of this rank's stage line, the ranks of its
        (data, fsdp) index, one a stage (None without a stage axis)."""
        return self.axis_group(AXIS_STAGE) if self.shape[AXIS_STAGE] > 1 else None

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
        launch-time path does. The devices default to the gang's, one a
        process; one process holds every context shard on its one device,
        as JAX's single-process mesh does over virtual devices."""
        procs = process_count()
        n = n_devices if n_devices is not None else procs if procs > 1 else context
        used = model * context * expert * stage
        if n % used:
            raise ValueError(f"{n} devices not divisible by model*context*expert*stage={used}")
        rest = n // used
        return cls(stage=stage, fsdp=rest, expert=expert, context=context, model=model)

    def build(self, device: torch.device | str | None = None) -> Mesh:
        """A ``Mesh`` on ``device`` (CUDA unless the CPU is asked for) over
        the gang this process joined, one process a device: ``stage × data ×
        fsdp × expert × context × model`` processes, each holding one
        context shard (its context line's ``ProcessRing``); a single process
        holds all ``context`` shards in a ``DeviceRing`` instead. A gang over
        ``TPU_NUM_SLICES`` slices (the env; 1 when unset) puts a slice
        boundary on one axis, which a data, fsdp or stage axis must absorb,
        as in JAX; the gang's axes are outermost."""
        if self.stage > 1:
            check_stage_layout(self.axis_sizes)
        if self.expert > 1 and (self.model > 1 or self.context > 1):
            raise NotImplementedError(
                f"an expert axis ({self.expert}) beside a model ({self.model}) or context ({self.context}) "
                "axis is not ported yet (ROADMAP queue A11, the rest: JAX runs that layout through its GSPMD "
                "gather dispatch); the port runs the expert axis with the data and fsdp axes")
        procs = self.stage * self.data * self.fsdp * self.expert * self.context * self.model
        one_process = process_count() == 1 and procs == self.context
        if procs != process_count() and not one_process:
            raise ValueError(f"stage {self.stage} x data {self.data} x fsdp {self.fsdp} x expert {self.expert} "
                             f"x context {self.context} x model {self.model} needs a gang of as many processes, "
                             f"one device a process (one process holds a context axis alone); this gang has "
                             f"{process_count()}")
        num_slices = int(os.environ.get(constants.ENV_TPU_NUM_SLICES, "1") or "1")
        if num_slices > 1 and not any(self.axis_sizes[a] % num_slices == 0 and self.axis_sizes[a] > 1
                                      for a in ALL_AXES if a in DCN_SAFE_AXES):
            raise ValueError(f"cannot place {num_slices} slices: no DCN-safe axis "
                             f"(one of {sorted(DCN_SAFE_AXES)}) is divisible by the slice count")
        dev = resolve_device(device)
        shape = {a: self.axis_sizes[a] for a in ALL_AXES}
        if one_process:
            return Mesh(shape=shape, device=dev, ring=DeviceRing(self.context, dev))
        device_mesh = gang_device_mesh(dev.type, tuple(self.axis_sizes[a] for a in GANG_AXES), GANG_AXES)
        # the ranks over (stage, data, fsdp, expert, context, model)
        ranks = torch.arange(procs).reshape([self.axis_sizes[a] for a in GANG_AXES])
        group = dist.group.WORLD
        if self.stage * self.expert * self.model > 1:
            # one group a (stage, expert, model) index, every rank making all of them in order
            group, _ = dist.new_subgroups_by_enumeration(
                ranks.permute(0, 3, 5, 1, 2, 4).reshape(-1, self.data * self.fsdp * self.context).tolist())
        replicas = None
        if self.data * self.context > 1:
            # one group a (stage, fsdp, expert, model) index: the data × context ranks that hold its blocks
            replicas, _ = dist.new_subgroups_by_enumeration(
                ranks.permute(0, 2, 3, 5, 1, 4).reshape(-1, self.data * self.context).tolist())
        ring = ProcessRing(device_mesh.get_group(AXIS_CONTEXT)) if self.context > 1 else DeviceRing(1, dev)
        return Mesh(shape=shape, device=dev, ring=ring, group=group, device_mesh=device_mesh,
                    gang=dist.group.WORLD, replicas=replicas)


def check_stage_layout(sizes: dict, moe: bool = False) -> None:
    """Refuse, before anything is built, the axes a stage axis does not
    run beside: an expert axis (with ``moe``, Mixtral's, in JAX's words: its
    1F1B keeps the experts stage-local; A13c for Llama), a model axis
    (A13c), and a context axis (JAX's words; a layout with a model axis too
    waits for A13c first)."""
    if moe and sizes.get(AXIS_EXPERT, 1) > 1:
        raise ValueError(
            "stage_axis > 1 keeps experts stage-local (ragged dispatch inside "
            "each stage) — use an expert axis of 1 with pipeline parallelism")
    beside = {a: sizes[a] for a in (AXIS_MODEL, AXIS_EXPERT) if sizes.get(a, 1) > 1}
    if beside:
        raise NotImplementedError(
            f"a stage axis ({sizes[AXIS_STAGE]}) beside {beside} is not ported yet (ROADMAP queue A13c: JAX's "
            "pipeline leaves those axes automatic; Mixtral's experts stay stage-local, as JAX's); the port "
            "runs the stage axis with the data and fsdp axes")
    if sizes.get(AXIS_CONTEXT, 1) > 1:
        raise ValueError(STAGE_CONTEXT)


def context_degree(mesh, tensor_parallel: bool = False) -> int:
    """The context degree of ``mesh`` (1 for None); raises for a mesh the
    port does not run (a stage axis above 1, whose models train through
    ``pp_value_and_grad``, a model axis where the caller does not run
    ``tensor_parallel``, or not a mesh of the port). The data, fsdp,
    expert and model axes are the gang's."""
    if mesh is None:
        return 1
    shape = mesh.shape if isinstance(mesh, Mesh) else None
    runs = _MODEL_AXES + ((AXIS_MODEL,) if tensor_parallel else ())
    if shape is None or any(v > 1 for a, v in shape.items() if a not in runs):
        raise NotImplementedError(
            "a device mesh with TP or pipeline axes is not ported yet for this model "
            "(ROADMAP queue A8b's second part: BERT on the model axis); a stage axis trains through "
            "pp_value_and_grad (Llama and Mixtral); the port runs the data, fsdp, expert and context axes, and the model axis for Llama and Mixtral")
    return shape[AXIS_CONTEXT]


def context_window(mesh, T: int) -> tuple[int, int]:
    """The positions ``[lo, hi)`` of a length-``T`` sequence that this
    process's context shards cover: the whole of it without a mesh or with
    every shard in this process, ``[r·T/c, (r+1)·T/c)`` at ring position r
    of a ``ProcessRing`` of c."""
    if mesh is None or mesh.context_line is None:
        return 0, T
    n = mesh.ring.n
    if T % n:
        raise ValueError(f"sequence {T} does not split into {n} context shards")
    Tl = T // n
    return mesh.ring.positions[0] * Tl, (mesh.ring.positions[-1] + 1) * Tl


def model_group(mesh):
    """The process group of this rank's model line (None for no mesh or a
    model axis of 1): Megatron's pair and the vocab-parallel loss reduce
    over it."""
    return mesh.axis_group(AXIS_MODEL) if axis_size(mesh, AXIS_MODEL) > 1 else None


def expert_group(mesh):
    """The process group of this rank's expert line (None for no mesh or an
    expert axis of 1): the expert-parallel MoE sums its output over it."""
    return mesh.axis_group(AXIS_EXPERT) if axis_size(mesh, AXIS_EXPERT) > 1 else None
