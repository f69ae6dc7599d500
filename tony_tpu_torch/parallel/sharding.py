"""Sharding rules: which mesh axis splits which dimension of each parameter.

Counterpart of ``tony_tpu/parallel/sharding.py``. A spec is a tuple with
one entry per dimension of a leaf, each None or a mesh axis name (or a
tuple of names), as JAX's ``PartitionSpec`` reads: ``P(None, "fsdp",
"model")``. Models ship their rules (``sharding_rules(cfg)``), the first
matching pattern wins and an unmatched leaf is replicated; ``fsdp_spec_tree``
is the generic rule for a model that ships none.

JAX places a leaf with ``NamedSharding`` and lets XLA insert the
collectives; eager torch has no propagation, so the port moves shards
itself, and ``constrain`` (a sharding constraint on an activation) has no
counterpart. ``split_dim`` reads a spec on a mesh: the dim a gang axis
(``fsdp``, ``expert`` or ``model``) splits, where the spec names that axis and the
axis is above 1 (``shard_dim``: the fsdp axis's). An axis of size 1
splits nothing, so a one-process run and a one-rank gang hold every leaf
whole and move nothing, as ``stop_transfer_if_single`` keeps a size-1
axis off the collective path in JAX. ``placements`` turns that into torch
placements on the gang's (data, fsdp, expert, model) ``DeviceMesh``
(``Shard(d)`` on the axis that splits dim d, ``Replicate()`` elsewhere),
the one place that builds them, for the checkpoint's ``DTensor`` blocks
(``Layout.block``); it imports ``torch.distributed.tensor`` when first
called, which a process that never writes a split leaf skips.

Each rank keeps its block of a leaf (``shard``): ``1/fsdp`` of the dim the
fsdp axis splits, ``1/expert`` of the dim the expert axis splits and
``1/model`` of the dim the model axis splits (a spec that names two on one
dim nests the later axis's block in the earlier's, as ``DTensor`` does; no
model's rules do). The model gathers the fsdp axis only, where it uses a
leaf (``gather``, ``gather_layer``): the all-gather's backward
reduce-scatters the gradient, so the gradient arrives sharded as the leaf
is. The model and expert axes' blocks stay split: that is tensor and
expert parallelism, and the model computes on them (``models/llama.py``,
``parallel/expert.py``: a rank's experts, their fsdp blocks gathered a
layer at a time, as JAX's ``shard_map`` ``in_specs`` gather them).
``Layout`` is what a train state keeps of this: the rules and the mesh, by
leaf name.

On a ``stage`` axis (the 1F1B pipeline, ``parallel/pipeline.py``) a rank
holds only its stage's part of a decoder's tree (``stage_owner``): its
``L/S`` layers, a ``Shard(0)`` block of every stacked ``layers/*`` leaf
(``Layout.spec`` names ``stage`` on their leading dim), the embedding on
the first stage, and the final norm and the head on the last; within the
stage the rules split them as they would. JAX keeps every leaf on every
stage, and its ``psum`` over ``stage`` makes the copies equal, so holding
each once gives the same bits without a whole-model gradient sum. A leaf
this rank does not hold is left out of its tree (``Layout.place`` gives
None, ``prune`` drops it).
"""

from __future__ import annotations

import re
from typing import Callable, Iterable

import torch

from tony_tpu_torch.parallel.collectives import all_gather
from tony_tpu_torch.parallel.mesh import (AXIS_EXPERT, AXIS_FSDP, AXIS_MODEL, AXIS_STAGE, GANG_AXES, Mesh,
                                          axis_size)

#: the axes that split parameters within a stage, in the order their blocks nest
SPLIT_AXES = (AXIS_FSDP, AXIS_EXPERT, AXIS_MODEL)
#: every axis that cuts a rank's block: the stage's layers first
PLACED_AXES = (AXIS_STAGE, *SPLIT_AXES)
#: the leaves a stage axis splits on their leading (layer) dim
STAGE_SPLIT = "layers/"

#: ``init``'s hook: (leaf name, whole leaf as drawn) → the tensor to keep
Place = Callable[[str, torch.Tensor], torch.Tensor]


def P(*axes) -> tuple:
    """A spec as JAX writes it: ``P("model", "fsdp")``; ``P()`` replicates.
    An entry of one axis in a tuple is that axis, as in JAX."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in axes)


def path_str(path: tuple) -> str:
    """A key path (``("layers", "wq")``) as the 'a/b/c' string rules match."""
    return "/".join(str(k) for k in path)


class ShardingRules:
    """Ordered (regex → spec) rules; first match wins."""

    def __init__(self, rules: Iterable[tuple[str, tuple]]):
        self.rules = [(re.compile(pat), tuple(spec)) for pat, spec in rules]

    def spec_for(self, path: str) -> tuple:
        for pat, spec in self.rules:
            if pat.search(path):
                return spec
        return P()  # replicate by default

    def spec_tree(self, params: dict, prefix: str = "") -> dict:
        """A spec for every leaf, in a tree mirroring ``params``."""
        return {k: self.spec_tree(v, f"{prefix}{k}/") if isinstance(v, dict) else self.spec_for(prefix + k)
                for k, v in params.items()}


def batch_spec(data_axes: tuple[str, ...] = ("data", "fsdp")) -> tuple:
    """The input batch's spec: the batch dim over the data axes."""
    return P(data_axes)


def fsdp_spec_tree(params: dict, axis: str = AXIS_FSDP, min_size: int = 2**12) -> dict:
    """Generic FSDP rule: each leaf of at least ``min_size`` elements split
    on its largest dim (ties → the first), the rest replicated."""
    def spec_of(x) -> tuple:
        if not torch.is_tensor(x) or x.numel() < min_size or x.ndim == 0:
            return P()
        dim = max(range(x.ndim), key=lambda d: x.shape[d])
        return P(*[axis if d == dim else None for d in range(x.ndim)])

    return {k: fsdp_spec_tree(v, axis, min_size) if isinstance(v, dict) else spec_of(v)
            for k, v in params.items()}


def _names(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def split_dim(spec: tuple, mesh: Mesh | None, axis: str) -> int | None:
    """The dim of a leaf with ``spec`` that the gang axis ``axis`` splits:
    the entry that names it, when that axis is above 1 (None: the axis
    leaves the leaf whole). Parameters never split over data."""
    if axis_size(mesh, axis) == 1:
        return None
    return next((d for d, entry in enumerate(spec) if axis in _names(entry)), None)


def shard_dim(spec: tuple, mesh: Mesh | None) -> int | None:
    """The dim the fsdp axis splits (``split_dim``'s)."""
    return split_dim(spec, mesh, AXIS_FSDP)


def placements(spec: tuple, mesh: Mesh | None) -> list:
    """The torch placements of a leaf with ``spec`` on the gang's (stage,
    data, fsdp, expert, context, model) dimensions: ``Shard(d)`` on an axis
    that splits dim d, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    dims = [split_dim(spec, mesh, a) for a in GANG_AXES]
    return [Replicate() if d is None else Shard(d) for d in dims]


def shard(full: torch.Tensor, spec: tuple, mesh: Mesh | None) -> torch.Tensor:
    """This rank's block of ``full`` (a copy, so ``full`` can be freed), or
    ``full`` itself when the mesh does not split it: its stage block (a
    ``Layout``'s spec of a stacked leaf), its fsdp block, then the expert
    and model blocks of that, as ``DTensor`` nests two shards of one dim."""
    out = full
    for axis in PLACED_AXES:
        dim = split_dim(spec, mesh, axis)
        if dim is None:
            continue
        n = axis_size(mesh, axis)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {list(full.shape)} leaf does not split into {axis} {n} shards")
        out = out.chunk(n, dim)[mesh.axis_index(axis)]
    return full if out is full else out.clone()


def gather(local: torch.Tensor, spec: tuple, mesh: Mesh | None) -> torch.Tensor:
    """The whole leaf from every fsdp rank's block (differentiable: the
    gradient is reduce-scattered back to the blocks), or ``local`` itself
    when the mesh does not split it."""
    dim = shard_dim(spec, mesh)
    if dim is None:
        return local
    return all_gather(local, mesh.axis_group(AXIS_FSDP), dim)


def gather_layer(lp: dict, rules: ShardingRules, mesh: Mesh | None, prefix: str = "layers") -> dict:
    """One layer's slices of the stacked ``prefix`` leaves (the leading L
    dim dropped, so each spec's first entry too), each gathered."""
    if axis_size(mesh, AXIS_FSDP) == 1:
        return lp
    return {k: gather_layer(v, rules, mesh, f"{prefix}/{k}") if isinstance(v, dict)
            else gather(v, rules.spec_for(f"{prefix}/{k}")[1:], mesh) for k, v in lp.items()}


def gathering(block, rules: ShardingRules, mesh: Mesh | None, prefix: str = "layers"):
    """``block(x, lp, ...)`` run on one layer's slices gathered first. Wrap
    the block before remat: the gather is then inside the recomputed region,
    so the backward gathers the layer again (JAX's schedule under remat) and
    the whole weights of a layer live only while it runs. Without remat
    autograd keeps each layer's gathered weights for the backward."""
    if axis_size(mesh, AXIS_FSDP) == 1:
        return block

    def run(x, lp, *args, **kwargs):
        return block(x, gather_layer(lp, rules, mesh, prefix), *args, **kwargs)

    return run


def shard_params(params: dict, rules: ShardingRules, mesh: Mesh | None, prefix: str = "") -> dict:
    """Each leaf of ``params`` placed per the rules: this rank's block (the
    bridge that hands the same weights to a gang's ranks)."""
    return {k: shard_params(v, rules, mesh, f"{prefix}{k}/") if isinstance(v, dict)
            else shard(v, rules.spec_for(prefix + k), mesh) for k, v in params.items()}


def model_shards(params: dict, rules: ShardingRules, n: int, prefix: str = "") -> list[dict]:
    """``params`` cut into the ``n`` blocks of a model axis held in one
    process (the serving engine's shards): tree s holds block s of each
    leaf on the dim its spec names ``model`` (views of ``params``), the
    whole leaf elsewhere."""
    trees: list[dict] = [{} for _ in range(n)]
    for k, v in params.items():
        if isinstance(v, dict):
            for tree, sub in zip(trees, model_shards(v, rules, n, f"{prefix}{k}/")):
                tree[k] = sub
            continue
        spec = rules.spec_for(prefix + k)
        dim = next((d for d, entry in enumerate(spec) if AXIS_MODEL in _names(entry)), None) if n > 1 else None
        if dim is not None and v.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {list(v.shape)} leaf does not split into {AXIS_MODEL} {n} shards")
        for tree, block in zip(trees, [v] * n if dim is None else v.chunk(n, dim)):
            tree[k] = block
    return trees


class Layout:
    """Where a train state's leaves live: ``rules`` over ``mesh``, by leaf
    name ('layers/wq'). ``sharded`` is whether any leaf is split, or held
    by one stage, at all."""

    def __init__(self, rules: ShardingRules, mesh: Mesh | None):
        self.rules, self.mesh = rules, mesh
        self.stages = axis_size(mesh, AXIS_STAGE)
        self.sharded = self.stages > 1 or any(axis_size(mesh, a) > 1 for a in SPLIT_AXES)

    def spec(self, name: str) -> tuple:
        """The rules' spec; on a stage axis a stacked leaf's leading dim
        names ``stage``."""
        spec = self.rules.spec_for(name)
        if self.stages > 1 and name.startswith(STAGE_SPLIT):
            return (AXIS_STAGE, *spec[1:])
        return spec

    def owns(self, name: str) -> bool:
        """Whether this rank holds (a block of) the leaf: every leaf but
        another stage's (``stage_owner``)."""
        owner = stage_owner(name, self.stages)
        return owner is None or owner == self.mesh.axis_index(AXIS_STAGE)

    def dim(self, name: str) -> int | None:
        """The dim the fsdp axis splits (None: whole on that axis)."""
        return shard_dim(self.spec(name), self.mesh)

    def model_dim(self, name: str) -> int | None:
        """The dim the model axis splits (None: whole on that axis)."""
        return split_dim(self.spec(name), self.mesh, AXIS_MODEL)

    def split(self, name: str) -> bool:
        """Whether this rank holds a block of the leaf on any axis."""
        return any(split_dim(self.spec(name), self.mesh, a) is not None for a in SPLIT_AXES)

    def place(self, name: str, full: torch.Tensor) -> torch.Tensor | None:
        """``init``'s hook: keep this rank's block of a freshly drawn leaf
        (None for another stage's leaf)."""
        return shard(full, self.spec(name), self.mesh) if self.owns(name) else None

    def full_shape(self, name: str, local: torch.Tensor) -> tuple:
        shape = list(local.shape)
        for axis in PLACED_AXES:
            if (dim := split_dim(self.spec(name), self.mesh, axis)) is not None:
                shape[dim] *= axis_size(self.mesh, axis)
        return tuple(shape)

    def block(self, name: str, local: torch.Tensor):
        """``local`` as the checkpoint sees it: where the leaf is split, a
        ``DTensor`` over the gang's ``DeviceMesh`` on the same storage, its
        placements and whole shape the leaf's (``Replicate`` on the stage
        dim for a leaf one stage holds, which only that stage's ranks save);
        else ``local`` itself."""
        if not self.split(name) and split_dim(self.spec(name), self.mesh, AXIS_STAGE) is None:
            return local
        from torch.distributed.tensor import DTensor

        shape = torch.Size(self.full_shape(name, local))
        return DTensor.from_local(local.detach(), self.mesh.device_mesh, placements(self.spec(name), self.mesh),
                                  run_check=False, shape=shape, stride=torch.empty(shape, device="meta").stride())


def stage_owner(name: str, stages: int) -> int | None:
    """The stage that holds a decoder leaf whole on a stage axis of
    ``stages``: None for the stacked layers (split over the stages) and
    without a stage axis; the first stage for the embedding; the last for
    the rest (the final norm and the head), as the 1F1B schedule runs them."""
    if stages == 1 or name.startswith(STAGE_SPLIT):
        return None
    return 0 if name == "embed" else stages - 1


def prune(tree: dict) -> dict:
    """``tree`` without its None leaves (those another stage holds)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = prune(v)
        elif v is not None:
            out[k] = v
    return out


def keep_whole(name: str, full: torch.Tensor) -> torch.Tensor:
    """``init``'s default hook: every leaf whole."""
    return full

