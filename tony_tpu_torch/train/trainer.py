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
the mean over its ``n_r`` valid targets, weighs its loss and gradients by
``n_r · world / Σn`` before the mean over the ranks, so the result is
Σ n_r·loss_r / Σn. With equal counts (every Llama and Mixtral batch) the
weight is exactly 1.0. ``tokens`` is summed and the ``moe_*`` metrics are
averaged, so every rank reports the global values.

With ``accum_steps`` A > 1 the gang computes JAX's scan over the global
batch: microbatch i is global rows i·mb … (i+1)·mb, one token mean each,
and the loss and gradients are the mean over the A microbatches. Rank r
holds a contiguous block of the global rows, so with W ranks either each
rank holds A / W whole microbatches (A % W == 0: it accumulates them, and
the ranks weigh the same) or each microbatch spans W / A whole ranks
(W % A == 0: rank r weighs ``n_r / N_i``, N_i its microbatch's count, from
the same one collective). A layout that straddles a microbatch boundary
raises.

A loss that takes a ``group`` keyword pools statistics over the rows of a
whole microbatch (Mixtral's router losses). ``make_train_step`` hands it
the ranks that share the microbatch: the whole group without accumulation,
none where each rank holds whole microbatches, else the rank's slot (a
subgroup). Its ranks are weighed by ``n_r / N_i`` as above, so such a loss
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


@dataclass
class TrainState:
    params: dict     # nested dict of tensors (requires_grad)
    opt_state: dict  # {"mu": {name: t}, "nu": {name: t}, "count": int}
    step: int

    @classmethod
    def create(cls, params: dict, optimizer: "AdamW") -> "TrainState":
        for _, p in _leaves(params):
            p.requires_grad_(True)
        return cls(params=params, opt_state=optimizer.init(params), step=0)

    def state_dict(self) -> dict:
        return {"params": self.params, "opt_state": self.opt_state, "step": self.step}

    def load(self, saved: dict) -> "TrainState":
        """Copy a saved ``state_dict`` into this state's tensors (in place).
        Every leaf's name, shape and dtype is checked before any is copied."""
        pairs = []
        for part in ("params", "opt_state"):
            mine, theirs = dict(_leaves(getattr(self, part))), dict(_leaves(saved[part]))
            if mine.keys() != theirs.keys():
                raise ValueError(f"checkpoint {part} leaves differ: {sorted(mine.keys() ^ theirs.keys())}")
            for name, t in mine.items():
                s = theirs[name]
                if not torch.is_tensor(t):
                    continue
                if s.shape != t.shape or s.dtype != t.dtype:
                    raise ValueError(f"checkpoint {part}/{name}: {s.dtype}{list(s.shape)}, "
                                     f"want {t.dtype}{list(t.shape)}")
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
    (one slot), none (a slot of one rank), or this rank's slot, a subgroup
    that every rank makes, all slots in the same order."""
    world = dist.get_world_size(group)
    if slots == 1:
        return group
    if slots == world:
        return None
    ranks, per = dist.get_process_group_ranks(group), world // slots
    return [dist.new_group(ranks[i * per:(i + 1) * per]) for i in range(slots)][slot]


def make_train_step(
    loss_fn: Callable[[Any, Any], tuple[torch.Tensor, dict]],
    optimizer: AdamW,
    accum_steps: int = 1,
    group=None,
) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """loss_fn(params, batch) -> (loss, aux). Returns a step that updates the
    state in place and returns it with its metrics.

    With accum_steps > 1 the batch's leading dim is ``accum_steps ·
    microbatch``; gradients are summed in f32 over the microbatches and then
    averaged, as the JAX scan does. ``group``: the data axis's process group
    (``Mesh.group``); its ranks' gradients and metrics are reduced to those
    of the global batch (the module docstring), ``accum_steps`` counting
    the global batch's microbatches. A ``loss_fn`` with a ``group`` keyword
    is given the ranks that share its microbatch (the module docstring)."""
    world = dist.get_world_size(group) if group is not None else 1
    local_steps, slots = gang_slots(accum_steps, world) if group is not None else (accum_steps, 1)
    slot = dist.get_rank(group) * slots // world if group is not None else 0
    if group is not None and "group" in inspect.signature(loss_fn).parameters:
        loss_fn = functools.partial(loss_fn, group=_microbatch_group(group, slots, slot))

    def compute_grads(params, batch):
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
            grads = torch.autograd.grad(loss, tensors)
            return loss.detach(), aux, dict(zip((n for n, _ in leaves), grads))
        micro = {k: v.reshape(local_steps, v.shape[0] // local_steps, *v.shape[1:])
                 for k, v in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
        sums = [torch.zeros_like(p, dtype=torch.float32) for p in tensors]
        for i in range(local_steps):
            loss, _ = loss_fn(params, {k: v[i] for k, v in micro.items()})
            for s, g in zip(sums, torch.autograd.grad(loss, tensors)):
                s += g
            loss_sum += loss.detach().float()
        inv = 1.0 / local_steps
        return loss_sum * inv, {}, {n: s * inv for (n, _), s in zip(leaves, sums)}

    def reduce_over_gang(loss, aux, grads):
        """The weighted mean over the gang: one collective of the scalars
        (per slot: the counts and the losses times the counts, this rank's
        in its own slot; the ``moe_*`` metrics) gives each slot's count
        N_i, and rank r's weight ``n_r · world / (slots · N_i)`` scales its
        gradients in the f32 buckets of their mean. A rank that holds whole
        microbatches counts 1: its loss is already their mean. A rank with
        no targets weighs 0, and a microbatch with none adds 0 to the loss."""
        def f32(v):
            return torch.as_tensor(v, dtype=torch.float32, device=loss.device).detach()

        n = f32(1 if accum_steps > 1 and slots == world else aux.get("tokens", 1))
        names = [k for k in aux if k.startswith("moe_")]
        counts = torch.zeros(slots, dtype=torch.float32, device=loss.device)
        sums = torch.zeros_like(counts)
        counts[slot], sums[slot] = n, f32(loss) * n
        scalars = torch.cat([counts, sums, *(f32(aux[k]).reshape(1) for k in names)])
        all_reduce_mean([scalars], group)
        counts = scalars[:slots]
        # N_i, exact: the counts are integers; at least 1, as JAX's token count
        totals = torch.round(counts * world).clamp_min(1.0)
        all_reduce_mean(list(grads.values()), group, scale=n * world / (totals[slot] * slots))
        aux = {**aux, **{k: scalars[2 * slots + i] for i, k in enumerate(names)}}
        if "tokens" in aux:
            aux["tokens"] = totals.sum()
        return (scalars[slots:2 * slots] / torch.where(counts > 0, counts, 1.0)).mean(), aux

    def train_step(state: TrainState, batch: Any) -> tuple[TrainState, dict]:
        loss, aux, grads = compute_grads(state.params, batch)
        if group is not None:
            loss, aux = reduce_over_gang(loss, aux, grads)
        if accum_steps > 1:
            aux = {}  # the scan's metrics carry no aux, as in JAX
        norm = global_norm(grads.values())
        optimizer.update(state.params, grads, state.opt_state, norm)
        state.step += 1
        metrics = {
            "loss": loss.float(),
            "grad_norm": norm,
            "step": state.step,
            **{k: v.detach() if torch.is_tensor(v) else v for k, v in aux.items() if k != "loss"},
        }
        return state, metrics

    return train_step


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
