"""Mixture-of-experts routing and the ragged (grouped-GEMM) expert FFN.

Counterpart of ``tony_tpu/parallel/expert.py`` on one device: ``MoEConfig``,
the top-k gating with its aux losses, the capacity-free ``route_ragged``
counting sort, the gather-form dispatch and combine, and ``moe_ffn``, which
is JAX's ``dispatch="ragged"`` path. The expert MLP always runs through
``ops/moe_gemm.moe_swiglu_grouped`` (B7/B8 on the card, their plain versions
on the CPU) with spans padded to ``moe_gemm.TILE``. ``MoEConfig`` has no
``dispatch`` or ``capacity_factor``: the capacity dispatches (``"gather"``,
``"dense"``) and ``"ragged_xla"`` are not ported, and an expert mesh axis
raises (ROADMAP queue A11); the experts run on the rows of this rank, with
the whole weights the caller gathered on an fsdp axis.

On a ``model`` axis (Megatron's tensor parallelism, JAX's rules split each
expert's F) the ranks of a model line hold the same rows and this rank's
``F/tp`` columns of ``w_gate|w_up`` and rows of ``w_down``. The gating,
``route_ragged`` and the dispatch run on every rank of the line on the same
bits, so they agree; B7/B8 run on this rank's blocks and give a partial of
each expert's output. ``copy_to_model`` sits on the dispatched rows and on
the gates that enter the combine (each rank differentiates its own
columns, so their gradients are summed over the line there), and
``reduce_from_model`` on the combined ``y`` (the combine is linear in the
partials, and ``y`` is ``1/(K·pad)`` of their bytes). The router reads the
normed rows itself, so its gradient and the balance and z losses', which
every rank computes whole, are counted once: the router's gradient is the
same on every rank of a line, as the trainer's norm assumes of a leaf the
rules keep whole.

JAX takes the router's statistics over the global arrays of a data-parallel
mesh. In a gang each process holds a slice of the batch, so with a data
``group`` the gating sums its statistics over the group's ranks inside the
forward (``_GangSum``): the balance and z losses are those of the whole
batch, on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tony_tpu_torch.ops import moe_gemm
from tony_tpu_torch.ops.attention import checkpoint_name
from tony_tpu_torch.parallel.collectives import copy_to_model, reduce_from_model
from tony_tpu_torch.parallel.mesh import context_degree, model_group


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    router_z_coef: float = 1e-3      # router z-loss (stability)
    aux_loss_coef: float = 1e-2      # load-balance loss


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, ties broken
    toward the lower index (a stable descending sort; ``torch.topk``
    promises no order among equal values)."""
    idx = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices[..., :k]
    return probs.gather(-1, idx), idx


class _GangSum(torch.autograd.Function):
    """The sum of ``x`` over ``group``'s ranks. The gradient goes to this
    rank's own summand unchanged: each rank's loss holds the sum, and the
    caller scales the gradient of the terms built on it so that the gang's
    reduction counts them once (``mixtral.loss_fn``)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gating(x: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig,
            token_mask: torch.Tensor | None = None, group=None):
    """Router softmax, top-k gates renormalised over the k (Mixtral
    convention), and the aux losses over valid tokens. ``token_mask`` [B, T]
    zeroes the gates of padding and leaves it out of the losses.

    The router is cast to x's dtype before the product and the product
    summed in f32, as JAX does (``preferred_element_type=f32``).

    ``group`` (a process group of more than one rank, each holding a slice
    of the batch): ``me``, ``ce`` and the z loss come from the sums over the
    group's valid tokens, one all-reduce of ``2E + 2`` f32 values.

    Returns (gate_vals [B,T,K] mask-zeroed, gate_idx [B,T,K], choice_onehot
    [B,T,K,E] f32, aux)."""
    E = cfg.num_experts
    logits = x.float() @ router_w.to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, cfg.top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    choice_onehot = F.one_hot(gate_idx, E).float()
    lse_sq = torch.logsumexp(logits, dim=-1) ** 2
    if token_mask is None and group is None:
        B, T, _ = x.shape
        n_valid = torch.tensor(float(B * T), device=x.device)
        me = probs.mean(dim=(0, 1))
        z = lse_sq.mean()
        ce = choice_onehot.sum(dim=2).sum(dim=(0, 1)) / n_valid
    else:
        m = torch.ones(x.shape[:2], device=x.device) if token_mask is None else token_mask.float()
        gate_vals = gate_vals * m[:, :, None]
        choice_onehot = choice_onehot * m[:, :, None, None]
        sums = torch.cat([(probs * m[:, :, None]).sum(dim=(0, 1)),
                          choice_onehot.sum(dim=2).sum(dim=(0, 1)),
                          (lse_sq * m).sum()[None], m.sum()[None]])
        if group is not None:
            sums = _GangSum.apply(sums, group)
        n_valid = torch.clamp(sums[-1], min=1.0)
        me, ce, z = sums[:E] / n_valid, sums[E:2 * E] / n_valid, sums[2 * E] / n_valid
    aux = {
        "moe_balance_loss": cfg.aux_loss_coef * E * (me * ce).sum() * (1.0 / cfg.top_k),
        "moe_z_loss": cfg.router_z_coef * z,
        "moe_n_valid": n_valid,
    }
    return gate_vals, gate_idx, choice_onehot, aux


def route_ragged(x, router_w, cfg: MoEConfig, token_mask: torch.Tensor | None = None,
                 tile: int | None = None, group=None):
    """Capacity-free routing for the grouped-GEMM dispatch: a counting sort
    of all N = B·T·K choices by expert (rank within (batch row, expert) by
    cumsum over t·K + k, then earlier rows, then earlier experts), so the
    order is b-major inside each expert's span. With ``tile`` every span is
    padded up to a multiple of it (at least one tile) and the row count is
    the static bound ``PN = (ceil(N/tile) + E)·tile``; pad rows keep token 0
    and gate 0. ``group``: as ``_gating``'s.

    Returns (sort_tok [N or PN] int32, dest [N] int64, gate_vals [B,T,K],
    gate_sorted [N or PN] f32, group_sizes [E] int64, aux)."""
    B, T, _ = x.shape
    E, K = cfg.num_experts, cfg.top_k
    N = B * T * K
    gate_vals, gate_idx, _, aux = _gating(x, router_w, cfg, token_mask, group)
    oh = F.one_hot(gate_idx.reshape(B, T * K), E)                       # [B, TK, E] int64
    pos_b = torch.cumsum(oh, dim=1) - oh
    counts_b = oh.sum(dim=1)                                            # [B, E]
    prefix_b = torch.cumsum(counts_b, dim=0) - counts_b
    group_sizes = counts_b.sum(dim=0)
    rows = N
    if tile is not None:
        group_sizes = torch.clamp(-(-group_sizes // tile), min=1) * tile
        rows = (-(-N // tile) + E) * tile
    offsets = torch.cumsum(group_sizes, 0) - group_sizes
    dest = ((pos_b + (offsets[None, :] + prefix_b)[:, None, :]) * oh).sum(dim=-1).reshape(N)
    tok = torch.arange(N, device=x.device, dtype=torch.int32) // K
    sort_tok = torch.zeros(rows, dtype=torch.int32, device=x.device)
    sort_tok[dest] = tok
    # the combine's gather-form backward gives gate_sorted no gradient
    gate_sorted = torch.zeros(rows, dtype=torch.float32, device=x.device)
    gate_sorted[dest] = gate_vals.detach().reshape(N).float()
    aux = dict(aux)
    aux.pop("moe_n_valid")
    aux["moe_dropped_frac"] = torch.zeros((), dtype=torch.float32, device=x.device)
    return sort_tok, dest, gate_vals, gate_sorted, group_sizes, aux


class _DispatchGather(torch.autograd.Function):
    """xs = x_flat[sort_tok] with a GATHER-form backward: every token appears
    exactly top_k times and ``dest`` lists those appearances, so
    ``dx[t] = Σ_k dxs[dest[t, k]]``: no scatter (whose atomics on the card
    would sum in a different order from run to run)."""

    @staticmethod
    def forward(ctx, x_flat, sort_tok, dest):
        ctx.save_for_backward(dest)
        ctx.bt = x_flat.shape[0]
        return x_flat[sort_tok.long()]

    @staticmethod
    def backward(ctx, dxs):
        (dest,) = ctx.saved_tensors
        K = dest.shape[0] // ctx.bt
        return dxs[dest].reshape(ctx.bt, K, dxs.shape[-1]).sum(dim=1), None, None


class _CombineGather(torch.autograd.Function):
    """y[t] = Σ_k gate[t,k] · ys[dest[t,k]] with a GATHER-form backward:
    sorted row j belongs to token ``sort_tok[j]`` with weight
    ``gate_sorted[j]`` (0 on pad rows), so ``dys[j] = gate_sorted[j] ·
    dy[sort_tok[j]]``, and ``dgate[t,k] = (ys ⊙ dy[sort_tok]).sum(-1)[dest[t,k]]``."""

    @staticmethod
    def forward(ctx, ys, dest, sort_tok, gate_vals, gate_sorted):
        ctx.save_for_backward(ys, dest, sort_tok, gate_vals, gate_sorted)
        BT, K = gate_vals.shape
        yc = ys[dest].reshape(BT, K, ys.shape[-1])
        return torch.einsum("tkd,tk->td", yc, gate_vals.to(ys.dtype))

    @staticmethod
    def backward(ctx, dy):
        ys, dest, sort_tok, gate_vals, gate_sorted = ctx.saved_tensors
        dys_raw = dy[sort_tok.long()]
        dys = dys_raw * gate_sorted[:, None].to(dy.dtype)
        dgate_sorted = (ys.float() * dys_raw.float()).sum(dim=-1)
        dgate = dgate_sorted[dest].reshape(gate_vals.shape)
        return dys.to(ys.dtype), None, None, dgate.to(gate_vals.dtype), None


def _expert_swiglu(xs, w_gate, w_up, w_down, group_sizes, tile: int):
    """Grouped expert SwiGLU on sorted rows through ``moe_swiglu_grouped``."""
    tg = moe_gemm.tile_group_map(group_sizes, xs.shape[0] // tile, tile)
    return moe_gemm.moe_swiglu_grouped(xs, w_gate, w_up, w_down, tg, tile)


def _ragged_expert_ffn(x, router_w, w_gate, w_up, w_down, cfg: MoEConfig, token_mask, group=None,
                       model=None):
    """Grouped-GEMM MoE on one device: route, gather the rows, run the expert
    MLP over expert-sorted spans, gather back to choice order and sum with
    the gates. ``model``: the model line's group, whose ranks each hold
    ``F/tp`` columns of every expert (the module docstring)."""
    B, T, D = x.shape
    K = cfg.top_k
    tile = moe_gemm.TILE
    sort_tok, dest, gate_vals, gate_sorted, group_sizes, aux = route_ragged(
        x, router_w, cfg, token_mask, tile=tile, group=group)
    # named as JAX names them: the "flash" remat policy keeps the routing;
    # moe_disp and moe_combine only when TONY_REMAT_EXTRA_NAMES lists them
    sort_tok, dest, gate_vals, gate_sorted, group_sizes = (
        checkpoint_name(t, "moe_route") for t in (sort_tok, dest, gate_vals, gate_sorted, group_sizes))
    rows = copy_to_model(x.reshape(B * T, D), model)
    xs = checkpoint_name(_DispatchGather.apply(rows, sort_tok, dest), "moe_disp")
    ys = _expert_swiglu(xs, w_gate, w_up, w_down, group_sizes, tile)
    gates = copy_to_model(gate_vals.reshape(B * T, K), model)
    y = reduce_from_model(_CombineGather.apply(ys, dest, sort_tok, gates, gate_sorted), model)
    y = checkpoint_name(y, "moe_combine")
    return y.reshape(B, T, D).to(x.dtype), aux


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, cfg: MoEConfig, mesh=None,
            token_mask: torch.Tensor | None = None, group=None) -> tuple[torch.Tensor, dict]:
    """SwiGLU mixture-of-experts FFN: the capacity-free ragged dispatch on one device.

    x [B, T, D]; router_w [D, E]; w_gate/w_up [E, D, F]; w_down [E, F, D]
    (``F/tp`` of F on a model axis) → (y [B, T, D], aux losses). ``group``:
    the data × fsdp ranks that share the batch (``_gating``), never a model
    line, whose ranks hold the same rows; the experts run on this rank's
    rows and, on a model axis, its columns of them."""
    context_degree(mesh, tensor_parallel=True)  # an expert axis (A11) or stages (A13) raise
    return _ragged_expert_ffn(x, router_w, w_gate, w_up, w_down, cfg, token_mask, group, model_group(mesh))
