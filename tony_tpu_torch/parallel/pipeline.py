"""Pipeline parallelism over the ``stage`` axis: the 1F1B schedule across the gang.

Counterpart of ``tony_tpu/parallel/pipeline.py``'s production path,
``spmd_pipeline_1f1b`` (:146) and ``split_layers_into_stages`` (:650). JAX
runs one SPMD program a device inside ``shard_map``, with ``lax.cond`` on
the owning stage and two ``ppermute`` rings a tick; the port runs one
process a stage (``Mesh.stage_line``, the ranks of one data × fsdp index),
each the tick loop of its own stage index, and hands the tensors over with
``ProcessRing.exchange`` over the stage line.

On tick t stage s runs the forward unit of microbatch ``t - s`` and the
backward unit of microbatch ``t - 2S + 1 + s`` (``Schedule``), for ``t = 0
… M + 2S - 2``:

- the forward unit embeds (stage 0) or takes the ring's input, runs the
  stage without autograd in the compute dtype and keeps its input in
  residual slot ``m % 2S``; the last stage only keeps its input and sends
  zeros (its output would go to stage 0, which embeds its own, and its
  backward unit recomputes the stage anyway);
- the backward unit recomputes the stage from that input with autograd,
  runs the head's value and gradient on the last stage (its ``dy`` cast to
  the wire dtype before it seeds the stage's VJP, as JAX's ``:291``), or
  seeds it with the ring's gradient, and adds the microbatch's parameter
  gradients, in the parameters' dtype as JAX's ``dp_m``, into f32
  accumulators (``torch.autograd.grad`` a microbatch: ``.grad`` would sum
  in the parameters' dtype); stage 0 adds the embedding's VJP of ``dx``
  the same way;
- both rings run on every tick, bubbles included, so no rank of the line
  waits on a peer that skipped one.

After the loop the per-stage leaves' gradients are summed over the data ×
fsdp ranks (the caller's ``reduce_grads``: an fsdp block's gradient is
already summed over fsdp by its gather's backward) and the scalars over the
whole gang; JAX's extra sum over ``stage`` only adds zeros, so no leaf's
gradient crosses the stage line. The schedule also returns its ticks and
two host clocks a step (``Ticks``): the wait for this rank's queued units
before each exchange, and the exchanges themselves, which hold the transfer
and the wait for the peer's units.

``pp_step`` is what the decoders' ``pp_value_and_grad`` share: the rank's
tree cut into the stage's layers, the embedding (first stage) and the head
(last stage), the schedule, and the gradients divided by the token count.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

from tony_tpu_torch.parallel.collectives import ProcessRing, all_reduce_sum
from tony_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_FSDP, AXIS_STAGE
from tony_tpu_torch.parallel.sharding import Layout


def split_layers_into_stages(stacked: dict, num_stages: int) -> dict:
    """Stacked layer leaves ``[L, ...]`` → ``[S, L/S, ...]`` (views): stage s
    holds block s of every leaf, as JAX's."""
    def reshape(p):
        L = p.shape[0]
        if L % num_stages:
            raise ValueError(f"{L} layers not divisible by {num_stages} stages")
        return p.reshape(num_stages, L // num_stages, *p.shape[1:])

    return {k: split_layers_into_stages(v, num_stages) if isinstance(v, dict) else reshape(v)
            for k, v in stacked.items()}


def microbatch_rows(batch: dict, num_microbatches: int, shards: int, index: int) -> dict:
    """The rows of a global batch that data × fsdp shard ``index`` of
    ``shards`` takes: block ``index`` of each microbatch's rows (JAX splits
    microbatch m, global rows ``m·B/M … (m+1)·B/M``, over the batch axes),
    so its microbatch m is theirs."""
    def rows(v):
        B = v.shape[0]
        if B % (num_microbatches * shards):
            raise ValueError(f"batch {B} does not split into {num_microbatches} microbatches of {shards} shards")
        per = v.reshape(num_microbatches, shards, B // (num_microbatches * shards), *v.shape[1:])
        return per[:, index].reshape(-1, *v.shape[1:])

    return {k: rows(v) for k, v in batch.items()}


@dataclass(frozen=True)
class Schedule:
    """The 1F1B ticks of stage ``stage`` of ``stages`` over ``microbatches``."""

    stages: int
    microbatches: int
    stage: int

    def ticks(self) -> int:
        return self.microbatches + 2 * self.stages - 1

    def forward(self, t: int) -> int | None:
        """The microbatch whose forward unit runs on tick ``t`` (None: a bubble)."""
        m = t - self.stage
        return m if 0 <= m < self.microbatches else None

    def backward(self, t: int) -> int | None:
        """The microbatch whose backward unit runs on tick ``t`` (None: a bubble)."""
        m = t - 2 * self.stages + 1 + self.stage
        return m if 0 <= m < self.microbatches else None

    def write_slot(self, m: int) -> int:
        """The residual slot the forward unit of microbatch ``m`` fills."""
        return m % (2 * self.stages)

    def read_slot(self, m: int) -> int:
        """The residual slot the backward unit of microbatch ``m`` reads:
        the one its forward unit filled, which no forward overwrites before
        (their microbatches differ by ``2S - 1 - 2s``, odd)."""
        return m % (2 * self.stages)


@dataclass
class Ticks:
    """A schedule's ticks and host seconds: ``sync_s`` waiting for this
    rank's queued units before each tick's exchange (0 off the card),
    ``exchange_s`` in the exchanges (the transfer and the wait for the
    peer's units), ``fastest_s`` the fastest tick's exchange (the least that
    a tick's transfer takes)."""

    ticks: int = 0
    sync_s: float = 0.0
    exchange_s: float = 0.0
    fastest_s: float = float("inf")

    def tick(self, sync_s: float, exchange_s: float) -> None:
        self.ticks += 1
        self.sync_s += sync_s
        self.exchange_s += exchange_s
        self.fastest_s = min(self.fastest_s, exchange_s)


def _f32_zeros_like(tree: dict) -> dict:
    return {k: torch.zeros_like(v, dtype=torch.float32) for k, v in tree.items()}


def _add(acc: dict, grads) -> None:
    for a, g in zip(acc.values(), grads):
        a += g


def spmd_pipeline_1f1b(
    stage_fn: Callable[..., Any],
    stage_params: dict,
    batch: dict,
    embed_params: torch.Tensor | None,
    head_params: dict | None,
    embed_fn: Callable[[torch.Tensor, dict], torch.Tensor],
    loss_head_fn: Callable[[dict, torch.Tensor, dict], tuple[torch.Tensor, torch.Tensor]],
    *,
    mesh,
    num_microbatches: int,
    act_shape: tuple,
    reduce_grads: Callable[[dict], None],
    wire_dtype: torch.dtype = torch.bfloat16,
    compute_dtype: torch.dtype = torch.bfloat16,
    stage_has_aux: bool = False,
    aux_seed_scale: torch.Tensor | float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, tuple[dict, torch.Tensor | None, dict | None], Ticks]:
    """The 1F1B train-step core of this rank's stage: ``(nll_sum, n_tokens,
    aux_total, (d_stage, d_embed, d_head), ticks)``, the scalars the gang's
    and the gradients (f32) the whole step's of the leaves this rank holds
    (None for the embedding and head it does not), ``ticks`` the schedule's
    ``Ticks``.

    ``batch``: this rank's rows (its data × fsdp shard of each microbatch,
    microbatch m its rows ``m·B/M …``); ``stage_fn(stage_params, x, mb) ->
    y`` (or ``(y, aux)`` with ``stage_has_aux``); ``embed_fn(embed_params,
    mb) -> x0`` (first stage); ``loss_head_fn(head_params, y, mb) ->
    (nll_sum, n_valid)`` (last stage); ``act_shape`` one microbatch's
    activation; ``reduce_grads({name: f32 gradient})`` sums the named
    gradients (``layers/<k>``, ``embed``, the head's keys) over the data ×
    fsdp ranks in place. The gradients differentiate ``nll_sum +
    aux_seed_scale · aux_total``, where ``aux_total = Σ aux / (M · data ·
    fsdp)`` over microbatches, stages and batch shards (JAX's)."""
    S = mesh.shape[AXIS_STAGE]
    s = mesh.axis_index(AXIS_STAGE)
    M = num_microbatches
    B = next(iter(batch.values())).shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    first, last = s == 0, s == S - 1
    aux_scale = 1.0 / (M * mesh.shape[AXIS_DATA] * mesh.shape[AXIS_FSDP])
    mbs = {k: v.reshape(M, B // M, *v.shape[1:]) for k, v in batch.items()}
    device = next(iter(stage_params.values())).device
    sched = Schedule(S, M, s)
    ring = ProcessRing(mesh.stage_line)
    aux_seed = torch.as_tensor(aux_seed_scale, dtype=torch.float32, device=device) * aux_scale
    leaves = list(stage_params.values())
    head_leaves = list(head_params.values()) if last else []
    d_stage = _f32_zeros_like(stage_params)
    d_embed = torch.zeros_like(embed_params, dtype=torch.float32) if first else None
    d_head = _f32_zeros_like(head_params) if last else None
    sums = torch.zeros(3, dtype=torch.float32, device=device)  # nll, tokens, aux
    resid = torch.zeros((2 * S, *act_shape), dtype=compute_dtype, device=device)
    zeros = torch.zeros(act_shape, dtype=compute_dtype, device=device)
    fwd_in = bwd_in = torch.zeros(act_shape, dtype=wire_dtype, device=device)

    def microbatch(m: int) -> dict:
        return {k: v[m] for k, v in mbs.items()}

    def backward_unit(m: int) -> torch.Tensor:
        mb = microbatch(m)
        x = resid[sched.read_slot(m)].clone().requires_grad_()
        with torch.enable_grad():
            out = stage_fn(stage_params, x, mb)
            y, aux = out if stage_has_aux else (out, None)
            if last:
                y_head = y.detach().requires_grad_()
                nll, n = loss_head_fn(head_params, y_head, mb)
                *dh, dy = torch.autograd.grad(nll, [*head_leaves, y_head])
                _add(d_head, dh)
                sums[0] += nll.detach().float()
                sums[1] += n.float()
                g = dy.to(wire_dtype).to(y.dtype)
            else:
                g = bwd_in.to(y.dtype)
            outs, seeds = [y], [g]
            if stage_has_aux:
                outs.append(aux)
                seeds.append(aux_seed.to(aux.dtype))
                sums[2] += aux.detach().float() * aux_scale
            *dp, dx = torch.autograd.grad(outs, [*leaves, x], seeds, materialize_grads=True)
        _add(d_stage, dp)
        if first:
            with torch.enable_grad():
                x0 = embed_fn(embed_params, mb)
                (de,) = torch.autograd.grad(x0, [embed_params], dx.to(x0.dtype))
            d_embed.add_(de)
        return dx

    ticks = Ticks()
    for t in range(sched.ticks()):
        mf = sched.forward(t)
        y = zeros
        if mf is not None:
            mb = microbatch(mf)
            with torch.no_grad():
                x = (embed_fn(embed_params, mb) if first else fwd_in).to(compute_dtype)
                if not last:
                    out = stage_fn(stage_params, x, mb)
                    y = (out[0] if stage_has_aux else out).to(compute_dtype)
            resid[sched.write_slot(mf)] = x
        mb_b = sched.backward(t)
        dx = backward_unit(mb_b) if mb_b is not None else zeros
        sync_s = 0.0
        if device.type == "cuda":  # gloo waits for the stream anyway
            t0 = time.perf_counter()
            torch.cuda.synchronize(device)
            sync_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fwd_in, bwd_in = ring.exchange(y.to(wire_dtype), dx.to(wire_dtype))
        ticks.tick(sync_s, time.perf_counter() - t0)

    named = {f"layers/{k}": v for k, v in d_stage.items()}
    if first:
        named["embed"] = d_embed
    if last:
        named.update(d_head)
    reduce_grads(named)
    dist.all_reduce(sums, group=mesh.gang)
    return sums[0], sums[1], sums[2], (d_stage, d_embed, d_head), ticks


def batch_reducer(layout: Layout) -> Callable[[dict], None]:
    """``reduce_grads`` for ``spmd_pipeline_1f1b`` on ``layout``'s mesh: a
    gradient of an fsdp block (summed over fsdp by its gather's backward)
    summed over the data ranks that hold the block (``Mesh.replicas``), a
    whole leaf's over the data × fsdp ranks of the stage (``Mesh.group``)."""
    mesh = layout.mesh

    def reduce(grads: dict) -> None:
        split = [g for n, g in grads.items() if layout.dim(n) is not None]
        whole = [g for n, g in grads.items() if layout.dim(n) is None]
        if split and mesh.replicas is not None:
            all_reduce_sum(split, mesh.replicas)
        if whole and dist.get_world_size(mesh.group) > 1:
            all_reduce_sum(whole, mesh.group)

    return reduce


def pp_step(params: dict, batch: dict, *, rules, mesh, num_microbatches: int, act_shape: tuple,
            compute_dtype: torch.dtype, wire_dtype: torch.dtype, stage_fn, embed_fn, loss_head_fn,
            stage_has_aux: bool = False, aux_seed_scale: torch.Tensor | float = 1.0):
    """A decoder's 1F1B step on this rank's tree (its stage's ``layers``,
    ``embed`` on the first stage, ``final_norm`` and ``lm_head`` on the
    last): ``(nll, ntok, aux_total, grads)``, ``grads`` mirroring ``params``
    and divided by the gang's token count (at least 1), each cast to its
    leaf's dtype, as JAX's ``pp_value_and_grad`` returns them."""
    head = {k: params[k] for k in ("final_norm", "lm_head") if k in params}
    nll, ntok, aux, (d_stage, d_embed, d_head), _ = spmd_pipeline_1f1b(
        stage_fn, params["layers"], batch, params.get("embed"), head or None, embed_fn, loss_head_fn,
        mesh=mesh, num_microbatches=num_microbatches, act_shape=act_shape,
        reduce_grads=batch_reducer(Layout(rules, mesh)), wire_dtype=wire_dtype, compute_dtype=compute_dtype,
        stage_has_aux=stage_has_aux, aux_seed_scale=aux_seed_scale)
    inv = 1.0 / ntok.clamp_min(1.0)
    grads = {"layers": {k: (g * inv).to(params["layers"][k].dtype) for k, g in d_stage.items()}}
    if d_embed is not None:
        grads["embed"] = (d_embed * inv).to(params["embed"].dtype)
    for k, g in (d_head or {}).items():
        grads[k] = (g * inv).to(params[k].dtype)
    return nll, ntok, aux, grads
