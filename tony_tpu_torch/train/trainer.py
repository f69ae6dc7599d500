"""Train-step builder: loss → gradients → clipped AdamW update, in place.

Counterpart of ``tony_tpu/train/trainer.py``. The optimizer is the optax
chain the JAX trainer builds, written out per tensor so its numbers are
optax's and not ``torch.optim.AdamW``'s:

1. ``clip_by_global_norm(grad_clip)``: g ← g / ‖g‖ · grad_clip only when
   ‖g‖ ≥ grad_clip (no epsilon, unlike ``clip_grad_norm_``);
2. ``adamw(schedule, b1, b2, eps=1e-8, weight_decay)``: μ ← b1·μ + (1−b1)·g,
   ν ← b2·ν + (1−b2)·g², u = μ̂ / (√ν̂ + eps) + wd·p with bias corrections at
   the incremented count, decay on every leaf (norms included);
3. p ← p − lr(count)·u with ``warmup_cosine_decay_schedule(0, lr, warmup,
   total)`` read at the count BEFORE the increment (the first update uses
   lr 0 when warmup > 0).

Moments keep the parameter dtype (optax's default) unless ``mu_dtype``
names one for μ; the arithmetic runs in f32 one tensor at a time, so the
temporaries are one tensor's size. JAX updates a donated state; the port
updates the state's tensors in place.

In a gang (``group`` of more than one process) each rank computes the
gradients of its rows of the global batch, and the gang reduces them
before the global norm and the clip to the gradients of the JAX step,
which takes one token mean over the global arrays: rank r, whose loss is
the mean over its ``n_r`` valid targets, weighs its loss by ``n_r · world
/ Σn`` before its backward (one collective of the scalars, between the
forward and the backward, gives Σn), and the gang's mean of the weighed
gradients is Σ n_r·g_r / Σn. With equal counts (every Llama and Mixtral
batch) the weight is exactly 1.0. ``tokens`` is summed and the ``moe_*``
metrics are averaged, so every rank reports the global values.

A state made by ``sharded_init`` on a mesh with an ``fsdp`` axis above 1
(its ``layout``) holds this rank's block of each leaf the model's rules
split, and the moments of that block: the AdamW update is elementwise, so
it runs on the blocks as they are. The model gathers a leaf where it uses
it, and the gather's backward sums the gradients of the fsdp ranks into
each block (the weighed gradients, so no averaging applies there); the
data axis then takes the mean over its ranks, divided by ``fsdp``, and a
leaf the rules keep whole takes the mean over the whole gang. The global
norm sums the squares of the blocks over the fsdp axis (one scalar
collective) and adds those of the whole leaves once.

On a ``model`` or ``expert`` axis the ranks of a line take the same rows
and hold the other blocks of the same leaves (F columns of each expert on
a model line, whole experts on an expert line): ``group`` is then the
data × fsdp ranks of this rank's model and expert index (``Mesh.group``),
over which the weighing and the means run; a leaf split on the model or
expert axis alone is averaged over that group as a whole leaf is.
Megatron's pair (``copy_to_model``'s backward) already sums the
activations' gradients over the line, so a leaf the rules keep whole (the
norms, Mixtral's router: ``moe_ffn`` sums the gates' gradients over the
line) has the same gradient on every rank of it, and the global norm sums
the squares of a leaf split on any axis over fsdp, expert and model, each
counted once (a block one axis leaves whole is divided by that axis's size
first). Mixtral's router losses on an expert axis are JAX's per-shard
means under its ``pmean``; ``parallel/expert.py`` says how each shard's
ends with weight 1/R under this weighing.

On a ``context`` axis across the gang the ranks of a context line take the
same rows, each a window of the sequence, so their losses are over
disjoint targets: ``group`` then spans data × fsdp × context (every rank
of this rank's model index, the whole gang without a model axis), the
weighing counts each rank's own targets (``n_r`` of its window), and
the mean of the weighed gradients over the group sums the context line's
partial gradients (the ring's backward sends each window's dk/dv home, so
a rank's gradient is its part of the line's). Every leaf is whole on the
context axis: an fsdp block's gradient is averaged over ``Mesh.replicas``
(the data × context ranks that hold it), and the global norm counts it
once, as it counts a model block once a model rank (the norm sums over
the split axes only, never over the context line, whose ranks hold the
same reduced gradients). Only the ranks that hold their own rows count as
slots below (``Mesh.context_line`` names the line's group).

With ``accum_steps`` A > 1 the gang computes JAX's scan over the global
batch: microbatch i is global rows i·mb … (i+1)·mb, one token mean each,
and the loss and gradients are the mean over the A microbatches. Rank r
holds a contiguous block of the global rows, so with W ranks either each
rank holds A / W whole microbatches (A % W == 0: it accumulates them, and
the ranks weigh the same) or each microbatch spans W / A whole ranks
(W % A == 0: rank r weighs ``n_r / N_i``, N_i its microbatch's count, from
the same one collective). A layout that straddles a microbatch boundary
raises. W counts the ranks that hold rows of their own: a context line
shares its microbatch, so a rank that accumulates whole microbatches
weighs each by ``n_r / N_i`` over its line (one collective of two scalars
a microbatch on the line's group).

On a ``stage`` axis the step is ``make_pp_train_step``'s: the model's
``pp_value_and_grad`` (the 1F1B schedule, ``parallel/pipeline.py``) gives
each rank the whole step's gradients of the leaves it holds (its stage's
layers, the embedding on the first stage, the head on the last; its fsdp
blocks of them), already summed over the data × fsdp ranks, and no leaf's
gradient crosses the stage line: the global norm sums each rank's squares
(over fsdp as above) and then the stage line's, one scalar, and AdamW
updates the rank's own leaves, so the clip is JAX's.

A loss that takes a ``group`` keyword pools statistics over the rows of a
whole microbatch (Mixtral's router losses). ``make_train_step`` hands it
the ranks that share the microbatch: the whole group without accumulation,
none where each rank holds whole microbatches, else the rank's slot (a
subgroup; on a model or expert axis, of the ranks of its line index). Its ranks are weighed by ``n_r / N_i`` as above, so such a loss
scales the gradient of its pooled terms by ``N_i / n_r``.
"""

from __future__ import annotations

import functools
import inspect
import math
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

from tony_tpu_torch.parallel.collectives import all_reduce_mean
from tony_tpu_torch.parallel.mesh import AXIS_FSDP
from tony_tpu_torch.parallel.sharding import SPLIT_AXES, Layout, ShardingRules, prune, split_dim


def _leaves(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    out = []
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out += _leaves(v, name + "/")
        else:
            out.append((name, v))
    return out


def global_norm(tensors) -> torch.Tensor:
    """‖g‖ over every tensor, summed in f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def sharded_global_norm(grads: dict[str, torch.Tensor], layout: Layout) -> torch.Tensor:
    """‖g‖ of the whole leaves' gradients from this rank's blocks: the
    squares of the leaves split on the fsdp, expert or model axis summed
    over each of them (a block replicated on one of them divided by its
    size, so each counts once), plus the whole leaves' once."""
    return torch.sqrt(_sharded_square_sum(grads, layout))


def _sharded_square_sum(grads: dict[str, torch.Tensor], layout: Layout) -> torch.Tensor:
    mesh = layout.mesh
    zero = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
    split = zero
    for n, g in grads.items():
        if layout.split(n):
            copies = math.prod(mesh.shape[a] for a in SPLIT_AXES if split_dim(layout.spec(n), mesh, a) is None)
            split = split + g.float().square().sum() / copies
    for axis in SPLIT_AXES:
        if mesh.shape[axis] > 1:
            dist.all_reduce(split, group=mesh.axis_group(axis))
    whole = sum((g.float().square().sum() for n, g in grads.items() if not layout.split(n)), zero)
    return split + whole


def tree_bytes(tree: dict) -> int:
    """The bytes this process holds of a tree's tensors."""
    return sum(t.numel() * t.element_size() for _, t in _leaves(tree) if torch.is_tensor(t))


@dataclass
class TrainState:
    params: dict     # nested dict of tensors (requires_grad)
    opt_state: dict  # {"mu": {name: t}, "nu": {name: t}, "count": int}
    step: int
    #: where the leaves live (``sharded_init``): this rank's blocks of the
    #: leaves an fsdp axis splits; None: every leaf whole
    layout: Layout | None = None

    @classmethod
    def create(cls, params: dict, optimizer: "AdamW", layout: Layout | None = None) -> "TrainState":
        """The state of ``params`` (its None leaves, another stage's, left
        out) with fresh moments."""
        params = prune(params)
        for _, p in _leaves(params):
            p.requires_grad_(True)
        return cls(params=params, opt_state=optimizer.init(params), step=0, layout=layout)

    def _trees(self) -> dict:
        """The state's tensors by part, each tree keyed by parameter name."""
        return {"params": self.params, "opt_state/mu": self.opt_state["mu"], "opt_state/nu": self.opt_state["nu"]}

    def state_dict(self) -> dict:
        """The state as a checkpoint holds it: where the layout splits a
        leaf, this rank's block of it and of its moments as a ``DTensor``
        (the same storage; ``Layout.block``), else the tensors themselves."""
        if self.layout is None or not self.layout.sharded:
            return {"params": self.params, "opt_state": self.opt_state, "step": self.step}
        placed = {part: {n: self.layout.block(n, t) for n, t in _leaves(tree)} for part, tree in self._trees().items()}
        return {"params": placed["params"], "step": self.step,
                "opt_state": {"mu": placed["opt_state/mu"], "nu": placed["opt_state/nu"],
                              "count": self.opt_state["count"]}}

    def load(self, saved: dict) -> "TrainState":
        """Copy a saved state into this state's tensors (in place): each leaf
        this rank's block of it, or the whole leaf, which is cut to the
        block. Every leaf's name, shape and dtype is checked before any is
        copied. On a stage axis the saved state also holds the leaves of
        the other stages (whole, or None where a restore left them unread),
        which this rank skips; any other leaf it lacks raises."""
        pairs = []
        theirs_by_part = {"params": saved["params"], "opt_state/mu": saved["opt_state"]["mu"],
                          "opt_state/nu": saved["opt_state"]["nu"]}
        for part, tree in self._trees().items():
            mine, theirs = dict(_leaves(tree)), dict(_leaves(theirs_by_part[part]))
            others = {n for n in theirs.keys() - mine.keys() if self.layout is not None and not self.layout.owns(n)}
            if mine.keys() != theirs.keys() - others:
                raise ValueError(f"checkpoint {part} leaves differ: "
                                 f"{sorted(mine.keys() ^ (theirs.keys() - others))}")
            for name, t in mine.items():
                s = theirs[name]
                whole = t.shape if self.layout is None else self.layout.full_shape(name, t)
                if s.dtype != t.dtype or s.shape not in (t.shape, whole):
                    raise ValueError(f"checkpoint {part}/{name}: {s.dtype}{list(s.shape)}, "
                                     f"want {t.dtype}{list(whole)}")
                if s.shape != t.shape:  # a whole leaf: this rank's block of it
                    s = self.layout.place(name, s)
                pairs.append((t, s))
        with torch.no_grad():
            for t, s in pairs:
                t.copy_(s)
        self.opt_state["count"] = int(saved["opt_state"]["count"])
        self.step = int(saved["step"])
        return self


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    # dtype of Adam's first moment; "" keeps the parameter dtype (optax's default)
    mu_dtype: str = ""

    def build(self) -> "AdamW":
        return AdamW(self)


class AdamW:
    """clip_by_global_norm → adamw over a nested dict of tensors."""

    eps = 1e-8

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        self.decay_steps = max(cfg.total_steps, cfg.warmup_steps + 1)

    def learning_rate(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay_steps)(count)."""
        lr, warm = self.cfg.learning_rate, self.cfg.warmup_steps
        if count < warm:
            return lr * count / warm
        span = self.decay_steps - warm
        t = min(count - warm, span)
        return lr * 0.5 * (1.0 + math.cos(math.pi * t / span))

    def init(self, params: dict) -> dict:
        mu_dt = getattr(torch, self.cfg.mu_dtype) if self.cfg.mu_dtype else None
        leaves = _leaves(params)
        return {
            "mu": {n: torch.zeros_like(p, dtype=mu_dt or p.dtype) for n, p in leaves},
            "nu": {n: torch.zeros_like(p) for n, p in leaves},
            "count": 0,
        }

    @torch.no_grad()
    def update(self, params: dict, grads: dict[str, torch.Tensor], state: dict,
               norm: torch.Tensor) -> None:
        """Apply one update in place. ``grads`` maps leaf names to gradients;
        ``norm`` is their global norm (before clipping)."""
        c = self.cfg
        count = state["count"]
        lr = self.learning_rate(count)
        t = count + 1
        bc1, bc2 = 1.0 - c.b1 ** t, 1.0 - c.b2 ** t
        clip = bool(norm >= c.grad_clip)
        for name, p in _leaves(params):
            g = grads[name].float()
            if clip:
                g = g / norm * c.grad_clip
            mu, nu = state["mu"][name], state["nu"][name]
            mu32 = mu.float() * c.b1 + (1.0 - c.b1) * g
            nu32 = nu.float() * c.b2 + (1.0 - c.b2) * (g * g)
            upd = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + self.eps)
            p32 = p.float()
            upd += c.weight_decay * p32
            p.copy_(p32 - lr * upd)
            mu.copy_(mu32)
            nu.copy_(nu32)
        state["count"] = t


def sharded_init(init_fn: Callable[..., dict], rules: ShardingRules, mesh, optimizer: AdamW) -> TrainState:
    """Counterpart of JAX's ``sharded_init``: ``init_fn(place)`` draws the
    parameter tree, handing each leaf to ``place(name, leaf)`` as it is
    drawn, which keeps this rank's block of it per ``rules`` on ``mesh``.
    Every rank draws every whole leaf from the same seeded generator, so the
    blocks are those of the one-process init, and the peak is one whole
    leaf; the moments are made from the blocks, so they are split alike. On
    a stage axis a rank keeps only its stage's leaves (``Layout.place``)."""
    layout = Layout(rules, mesh)
    return TrainState.create(init_fn(layout.place), optimizer, layout)


class SGD:
    """``optax.sgd(lr, momentum)``: the trace t ← g + momentum·t, kept in the
    parameter dtype (optax's ``accumulator_dtype=None``), and p ← p − lr·t,
    cast back to the parameter dtype; no clip and no schedule."""

    def __init__(self, learning_rate: float, momentum: float = 0.0):
        self.learning_rate, self.momentum = learning_rate, momentum

    def init(self, params: dict) -> dict:
        return {"trace": {n: torch.zeros_like(p) for n, p in _leaves(params)}}

    @torch.no_grad()
    def update(self, params: dict, grads: dict[str, torch.Tensor], state: dict) -> None:
        """Apply one update in place; ``grads`` maps leaf names to gradients."""
        for name, p in _leaves(params):
            t = state["trace"][name]
            t.mul_(self.momentum).add_(grads[name])
            p.copy_(p + t * -self.learning_rate)


def gang_slots(accum_steps: int, world: int) -> tuple[int, int]:
    """How a gang of ``world`` ranks, each holding a contiguous block of the
    global rows, covers ``accum_steps`` global microbatches: (microbatches
    each rank accumulates, slots), where a slot is a group of ranks whose
    rows form whole microbatches and rank r is in slot ``r·slots // world``.
    Any other layout would straddle a microbatch boundary: ValueError."""
    if accum_steps % world == 0:
        return accum_steps // world, world
    if world % accum_steps == 0:
        return 1, accum_steps
    raise ValueError(
        f"C3: accum_steps {accum_steps} over a gang of {world} ranks puts a microbatch boundary "
        "inside a rank's rows; JAX's microbatch i is global rows i·mb…(i+1)·mb, so use an "
        "accum_steps that divides the gang's size or is a multiple of it")


def _microbatch_group(group, slots: int, slot: int):
    """The ranks of ``group`` that share this rank's microbatch: all of them
    (one slot), none (a slot of one rank), or this rank's slot, a subgroup.
    ``dist.new_group`` is collective over the whole gang, so every rank
    makes the slot groups of every group like ``group`` (on a model or
    expert axis, one an index of the lines: their groups, gathered), all in
    one order, and keeps its own."""
    world = dist.get_world_size(group)
    per = world // slots
    if slots == 1:
        return group
    if per == 1:
        return None
    lines = [None] * dist.get_world_size()
    dist.all_gather_object(lines, dist.get_process_group_ranks(group))
    slot_ranks = [list(line[i * per:(i + 1) * per]) for line in sorted({tuple(x) for x in lines})
                  for i in range(slots)]
    mine, _ = dist.new_subgroups_by_enumeration(slot_ranks)
    return mine


def make_train_step(
    loss_fn: Callable[[Any, Any], tuple[torch.Tensor, dict]],
    optimizer: AdamW,
    accum_steps: int = 1,
    group=None,
    mesh=None,
) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """loss_fn(params, batch) -> (loss, aux). Returns a step that updates the
    state in place and returns it with its metrics.

    With accum_steps > 1 the batch's leading dim is ``accum_steps ·
    microbatch``; gradients are summed in f32 over the microbatches and then
    averaged, as the JAX scan does. ``group``: the ranks the batch splits
    over (``Mesh.group``: the gang's data × fsdp ranks); their gradients and
    metrics are reduced to those of the global batch, a state's blocks as
    its ``layout`` splits them (the module docstring), ``accum_steps``
    counting the global batch's microbatches. A ``loss_fn`` with a
    ``group`` keyword is given the ranks that share its microbatch (the
    module docstring). ``mesh``: the loss's mesh, whose ``context_line``
    (a context axis across the gang) names the ranks that share their
    rows."""
    context = mesh.context_line if mesh is not None else None
    world = dist.get_world_size(group) if group is not None else 1
    line = dist.get_world_size(context) if context is not None else 1
    local_steps, slots = gang_slots(accum_steps, world // line) if group is not None else (accum_steps, 1)
    slot = dist.get_rank(group) * slots // world if group is not None else 0
    if group is not None and "group" in inspect.signature(loss_fn).parameters:
        loss_fn = functools.partial(loss_fn, group=_microbatch_group(group, slots, slot))

    def weigh(loss, aux):
        """The gang's loss, metrics and this rank's weight, from one
        collective of the scalars (per slot: the counts and the losses times
        the counts, this rank's in its own slot; the ``moe_*`` metrics) that
        gives each slot's count N_i: rank r weighs ``n_r · world / (slots ·
        N_i)``. A rank that holds whole microbatches counts 1: its loss is
        already their mean. A rank with no targets weighs 0, and a
        microbatch with none adds 0 to the loss."""
        def f32(v):
            return torch.as_tensor(v, dtype=torch.float32, device=loss.device).detach()

        n = f32(1 if local_steps > 1 or (accum_steps > 1 and slots == world) else aux.get("tokens", 1))
        names = [k for k in aux if k.startswith("moe_")]
        counts = torch.zeros(slots, dtype=torch.float32, device=loss.device)
        sums = torch.zeros_like(counts)
        counts[slot], sums[slot] = n, f32(loss) * n
        scalars = torch.cat([counts, sums, *(f32(aux[k]).reshape(1) for k in names)])
        all_reduce_mean([scalars], group)
        counts = scalars[:slots]
        # N_i, exact: the counts are integers; at least 1, as JAX's token count
        totals = torch.round(counts * world).clamp_min(1.0)
        aux = {**aux, **{k: scalars[2 * slots + i] for i, k in enumerate(names)}}
        if "tokens" in aux:
            aux["tokens"] = totals.sum()
        mean = (scalars[slots:2 * slots] / torch.where(counts > 0, counts, 1.0)).mean()
        return mean, aux, n * world / (totals[slot] * slots)

    def compute_grads(params, batch):
        """(loss, aux, {leaf: gradient}) of this rank's batch; in a gang the
        loss and aux are the gang's and the gradients this rank's weighed
        ones (the weight is 1 where each rank holds whole microbatches)."""
        leaves = _leaves(params)
        tensors = [p for _, p in leaves]
        if accum_steps > 1:
            nested = [k for k, v in batch.items() if isinstance(v, dict)]
            if nested:
                raise ValueError(
                    f"accum_steps={accum_steps} splits every batch value along its leading dim, and "
                    f"{nested} hold a tree (ResNet's BatchNorm state rides in the batch as 'bn_state'): "
                    "neither package splits it; train such a model with accum_steps=1")
        if local_steps == 1:
            loss, aux = loss_fn(params, batch)
            reported = loss.detach()
            if group is not None:
                reported, aux, weight = weigh(loss, aux)
                loss = loss * weight
            grads = torch.autograd.grad(loss, tensors)
            return reported, aux, dict(zip((n for n, _ in leaves), grads))
        micro = {k: v.reshape(local_steps, v.shape[0] // local_steps, *v.shape[1:])
                 for k, v in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
        sums = [torch.zeros_like(p, dtype=torch.float32) for p in tensors]
        for i in range(local_steps):
            loss, aux = loss_fn(params, {k: v[i] for k, v in micro.items()})
            if context is not None:
                loss, reported = _line_weighed(loss, aux["tokens"], context, line)
            else:
                reported = loss.detach().float()
            for s, g in zip(sums, torch.autograd.grad(loss, tensors)):
                s += g
            loss_sum += reported
        inv = 1.0 / local_steps
        loss, aux = loss_sum * inv, {}
        if group is not None:
            loss, aux, _ = weigh(loss, aux)  # each rank weighs 1
        return loss, aux, {n: s * inv for (n, _), s in zip(leaves, sums)}

    def reduce_grads(grads: dict, layout: Layout | None) -> None:
        """The gang's mean of the weighed gradients, in place: over
        ``group`` (the data × fsdp (× context) ranks of this rank's line
        index, which hold the same block of a leaf the model or expert axis
        splits) for a leaf the fsdp axis leaves whole; for a block of the
        fsdp axis (already summed over it by the gather's backward) over
        the data × context ranks that hold it (``Mesh.replicas``), divided
        by fsdp."""
        split = [g for n, g in grads.items() if layout is not None and layout.dim(n) is not None]
        whole = [g for n, g in grads.items() if layout is None or layout.dim(n) is None]
        if whole:
            all_reduce_mean(whole, group)
        if split:
            mesh = layout.mesh
            inv = torch.tensor(1.0 / mesh.shape[AXIS_FSDP], device=split[0].device)
            if mesh.replicas is not None:
                all_reduce_mean(split, mesh.replicas, scale=inv)
            else:
                for g in split:
                    g.mul_(inv)

    def train_step(state: TrainState, batch: Any) -> tuple[TrainState, dict]:
        loss, aux, grads = compute_grads(state.params, batch)
        layout = state.layout if state.layout is not None and state.layout.sharded else None
        if group is not None:
            reduce_grads(grads, layout)
        if accum_steps > 1:
            aux = {}  # the scan's metrics carry no aux, as in JAX
        norm = global_norm(grads.values()) if layout is None else sharded_global_norm(grads, layout)
        return _apply(state, optimizer, grads, norm, loss, aux)

    return train_step


def _apply(state: TrainState, optimizer: AdamW, grads: dict, norm: torch.Tensor, loss: torch.Tensor,
           aux: dict) -> tuple[TrainState, dict]:
    """What both step builders do after the gradients: the update with the
    clip's norm, the step count, the metrics (the loss, the norm, the step
    and the loss's aux)."""
    optimizer.update(state.params, grads, state.opt_state, norm)
    state.step += 1
    metrics = {
        "loss": loss.float().detach(),
        "grad_norm": norm,
        "step": state.step,
        **{k: v.detach() if torch.is_tensor(v) else v for k, v in aux.items() if k != "loss"},
    }
    return state, metrics


def make_pp_train_step(
    value_and_grad_fn: Callable[[Any, Any], tuple[torch.Tensor, dict, dict]],
    optimizer: AdamW,
    mesh,
) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """Counterpart of JAX's ``make_pp_train_step``: a step from a function
    that produces the gradients itself, ``value_and_grad_fn(params, batch)
    -> (loss, aux, grads)`` (the model's ``pp_value_and_grad``: the 1F1B
    schedule runs its backward inside the pipeline loop), whose ``grads``
    mirror this rank's ``params`` and are the whole step's, summed over the
    data × fsdp ranks; the state is ``sharded_init``'s (its ``layout`` on
    the stage mesh). The global norm counts every leaf once across the
    stages (the module docstring); everything after the gradients is
    ``make_train_step``'s."""
    stage_line = mesh.stage_line if mesh is not None else None

    def train_step(state: TrainState, batch: Any) -> tuple[TrainState, dict]:
        loss, aux, grads = value_and_grad_fn(state.params, batch)
        grads = dict(_leaves(grads))
        sq = _sharded_square_sum(grads, state.layout)
        if stage_line is not None:
            dist.all_reduce(sq, group=stage_line)
        return _apply(state, optimizer, grads, torch.sqrt(sq), loss, aux)

    return train_step


def _line_weighed(loss: torch.Tensor, n, context, line: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A microbatch's loss on a context line, whose ranks hold windows of
    its rows: (this rank's loss weighed by ``n · line / N``, so the line's
    summed gradients are ``line`` times the microbatch's token mean's; that
    mean itself), N the line's count from one collective of two scalars."""
    n = torch.as_tensor(n, dtype=torch.float32, device=loss.device).detach()
    both = torch.stack([n, loss.detach().float() * n])
    dist.all_reduce(both, group=context)
    total = both[0].clamp_min(1.0)
    return loss * (n * line / total), both[1] / total


class Throughput:
    """Wall-clock tokens/s + MFU meter around the step (host side; the
    caller synchronises the device before ``report``)."""

    def __init__(self, tokens_per_step: int, flops_per_token: int, n_chips: int, peak_flops: float):
        self.tokens_per_step = tokens_per_step
        self.flops_per_token = flops_per_token
        self.n_chips = max(n_chips, 1)
        self.peak_flops = peak_flops
        self._t0: float | None = None
        self.steps = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self.steps = 0

    def step(self) -> None:
        self.steps += 1

    def report(self) -> dict:
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        if dt <= 0 or self.steps == 0:
            return {"tokens_per_sec": 0.0, "mfu": 0.0, "step_time_ms": 0.0}
        tps = self.tokens_per_step * self.steps / dt
        flops = tps * self.flops_per_token
        return {
            "tokens_per_sec": tps,
            "tokens_per_sec_per_chip": tps / self.n_chips,
            "step_time_ms": 1000 * dt / self.steps,
            "mfu": flops / (self.peak_flops * self.n_chips),
        }
