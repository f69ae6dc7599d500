"""Mixture-of-experts routing and the expert FFN, on one device and over an expert line.

Counterpart of ``tony_tpu/parallel/expert.py``: ``MoEConfig``, the top-k
gating with its aux losses, the capacity-bounded dispatches (``route``:
GShard's dense ``[B, T, E, C]`` dispatch and combine, ``route_indices``: the
same slots as gather indices), the capacity-free ``route_ragged`` counting
sort with its gather-form dispatch and combine, and ``moe_ffn`` with JAX's
four dispatches (``cfg.dispatch``):

- ``"ragged"``: the grouped expert MLP through ``ops/moe_gemm``'s B7/B8 when
  ``kernel_eligible`` (JAX's ``_kernel_eligible``, decided from the dispatch,
  dtype and shape before any launch: bf16 with D and F multiples of 128 on
  the card; every shape on the CPU, where the wrapper runs the kernels'
  plain versions), each expert's span padded to ``moe_gemm.TILE`` rows;
  otherwise the ``"ragged_xla"`` product;
- ``"ragged_xla"``: JAX's ``jax.lax.ragged_dot`` path, three grouped
  products over the expert-sorted spans (``_ragged_swiglu``, one
  ``torch.matmul`` a group: XLA work in JAX, not a Pallas kernel);
- ``"gather"`` and ``"dense"``: the capacity dispatches, plain products
  (``_expert_mlp``) on the dispatched ``[E, B, C, D]`` bank, with
  ``moe_dropped_frac`` the share of choices past an expert's capacity. In a
  context gang, whose ranks hold windows of the rows, the capacity and each
  choice's slot are the whole row's, as JAX's GSPMD run on whole rows takes
  them (``_route_common``).

The experts run on this rank's rows. A mesh's axes change who computes what:

- ``model`` (Megatron's tensor parallelism, JAX's rules split each expert's
  F): the ranks of a model line hold the same rows and this rank's ``F/tp``
  columns of ``w_gate|w_up`` and rows of ``w_down``. The gating, the routing
  and the dispatch run on every rank of the line on the same bits; the
  expert MLP gives a partial of each expert's output.
- ``expert``: the ranks of an expert line hold the same rows and the
  contiguous span of ``E/ep`` whole experts JAX's ``P(None, "expert", …)``
  gives rank ``ei``: ``[ei·E/ep, (ei+1)·E/ep)``. The ragged dispatches run
  JAX's ``_ragged_expert_ffn_ep``: the routing on every rank, then the span
  of sorted rows from ``offsets[ei·E/ep]`` (``_span_rows``), B7/B8 (or the
  grouped product) on it with ``E/ep`` groups, and a partial combine of the
  choices that fall in it. The capacity dispatches compute this rank's
  experts' part of the bank and of the combine.

On either line ``copy_to_model`` sits on the dispatched rows and on the
gates that enter the combine (each rank differentiates its own columns or
experts, so their gradients are summed over the line there), and
``reduce_from_model`` on the combined ``y``. The router reads the normed
rows itself, so its gradient and the aux losses', which every rank
computes whole, are counted once: the router's gradient is the same on
every rank of a line, as the trainer's norm assumes of a leaf the rules
keep whole. An expert axis beside a model or context axis raises (the mesh
refuses it: JAX's GSPMD gather fallback is not ported).

The router's statistics follow JAX. In a gang each process holds a slice of
the batch (``group``: the data × fsdp ranks that share it, and in a context
gang the context line's too, each rank a window of the same rows):

- everywhere but the ragged dispatches on an expert axis, JAX takes them
  over the global arrays, and ``_gating`` sums them over the group inside
  the forward (``_GangSum``): the balance and z losses, and the capacity
  dispatches' dropped fraction, are those of the whole batch;
- the ragged dispatches on an expert axis run under JAX's ``shard_map``,
  whose router losses are per-shard means ``pmean``-ed over the data ×
  fsdp shards (its docstring calls this an approximation: pad-heavy shards'
  tokens weigh more). ``_gating(shards=R)`` computes each of the R shards'
  losses (a call holds ``R / |group|`` of them) and sums their ``1/R``
  shares over the group (``_GangSum``). ``mixtral.loss_fn`` scales the
  gradient of the router losses by ``Σn / n_r`` and the trainer weighs
  rank r by ``n_r / Σn``, so each shard's loss ends with weight ``1/R``,
  the gradient of JAX's ``pmean``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tony_tpu_torch.ops import moe_gemm
from tony_tpu_torch.ops.attention import checkpoint_name
from tony_tpu_torch.parallel.collectives import copy_to_model, reduce_from_model
from tony_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT, AXIS_FSDP, axis_size, context_degree,
                                          expert_group, model_group)

#: ``cfg.dispatch``'s values, as JAX's ``MoEConfig`` names them
DISPATCHES = ("ragged", "ragged_xla", "gather", "dense")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3      # router z-loss (stability)
    aux_loss_coef: float = 1e-2      # load-balance loss
    # ragged (grouped GEMM: B7/B8 when eligible) | ragged_xla (the grouped
    # product) | gather (indexed, capacity) | dense (GShard einsum)
    dispatch: str = "ragged"


def capacity(tokens_per_batch: int, cfg: MoEConfig) -> int:
    """Slots an expert has in one batch row of ``tokens_per_batch`` tokens
    (at least top_k)."""
    c = int(cfg.top_k * tokens_per_batch * cfg.capacity_factor / cfg.num_experts)
    return max(c, cfg.top_k)


def check_dispatch(dispatch: str) -> None:
    """JAX's refusal of a dispatch it does not know."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch must be 'gather' or 'dense', got {dispatch!r}")


def check_expert_axis(num_experts: int, ep: int) -> None:
    """JAX's refusal of an expert axis that does not divide the experts."""
    if num_experts % ep:
        raise ValueError(f"num_experts {num_experts} must divide the expert axis {ep}")


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


def _group_size(group) -> int:
    return dist.get_world_size(group) if group is not None else 1


def _shard_aux(probs, choice_onehot, lse_sq, m, cfg: MoEConfig, group, shards: int):
    """JAX's per-shard router losses under its ``pmean``: this call's rows
    are ``shards / |group|`` contiguous shards of the R = ``shards`` data ×
    fsdp shards, each shard's balance and z losses over its own valid
    tokens, their ``1/R`` shares summed over the group."""
    held, rem = divmod(shards, _group_size(group))
    B = probs.shape[0]
    if rem or B % held:
        raise ValueError(f"{B} rows on a group of {_group_size(group)} ranks do not hold whole shards of "
                         f"the {shards} data x fsdp shards")
    E = cfg.num_experts

    def per(t):
        return t.reshape(held, B // held, *t.shape[1:])

    mp = per(m)
    n = torch.clamp(mp.sum(dim=(1, 2)), min=1.0)                                  # [held]
    me = (per(probs) * mp[..., None]).sum(dim=(1, 2)) / n[:, None]
    ce = per(choice_onehot).sum(dim=3).sum(dim=(1, 2)) / n[:, None]
    z = (per(lse_sq) * mp).sum(dim=(1, 2)) / n
    balance = cfg.aux_loss_coef * E * (me * ce).sum(dim=-1) * (1.0 / cfg.top_k)
    losses = torch.stack([balance.sum(), cfg.router_z_coef * z.sum()]) / shards
    if group is not None:
        losses = _GangSum.apply(losses, group)
    return {"moe_balance_loss": losses[0], "moe_z_loss": losses[1], "moe_n_valid": n.sum()}


def _gating(x: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig,
            token_mask: torch.Tensor | None = None, group=None, shards: int = 0):
    """Router softmax, top-k gates renormalised over the k (Mixtral
    convention), and the aux losses over valid tokens. ``token_mask`` [B, T]
    zeroes the gates of padding and leaves it out of the losses.

    The router is cast to x's dtype before the product and the product
    summed in f32, as JAX does (``preferred_element_type=f32``).

    ``group`` (a process group of more than one rank, each holding a slice
    of the batch): ``me``, ``ce`` and the z loss come from the sums over the
    group's valid tokens, one all-reduce of ``2E + 2`` f32 values, and
    ``moe_n_valid`` is the group's count. ``shards`` > 0: JAX's per-shard
    losses under its ``pmean`` over that many data × fsdp shards instead
    (``_shard_aux``).

    Returns (gate_vals [B,T,K] mask-zeroed, gate_idx [B,T,K], choice_onehot
    [B,T,K,E] f32, aux)."""
    E = cfg.num_experts
    logits = x.float() @ router_w.to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, cfg.top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    choice_onehot = F.one_hot(gate_idx, E).float()
    lse_sq = torch.logsumexp(logits, dim=-1) ** 2
    if token_mask is None and group is None and not shards:
        B, T, _ = x.shape
        n_valid = torch.tensor(float(B * T), device=x.device)
        me = probs.mean(dim=(0, 1))
        z = lse_sq.mean()
        ce = choice_onehot.sum(dim=2).sum(dim=(0, 1)) / n_valid
    else:
        m = torch.ones(x.shape[:2], device=x.device) if token_mask is None else token_mask.float()
        gate_vals = gate_vals * m[:, :, None]
        choice_onehot = choice_onehot * m[:, :, None, None]
        if shards:
            return gate_vals, gate_idx, choice_onehot, _shard_aux(probs, choice_onehot, lse_sq, m, cfg,
                                                                  group, shards)
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


def _route_common(x, router_w, cfg: MoEConfig, token_mask=None, group=None, ring=None):
    """The capacity dispatches' routing prefix: the gating and each choice's
    capacity slot, counted over the row's choices k-major (``[B, T, K, E]``
    positions; JAX's ``_route_common``).

    ``ring``: the ``ProcessRing`` of a context gang, whose ranks hold the
    windows of these rows in ring order. A choice's slot is still its place
    among the whole row's choices: after every window's choices at k' < k,
    then the earlier windows' at k, then this window's before it at k. One
    all-gather of the windows' ``[B, K, E]`` counts gives both prefixes."""
    B, T, _ = x.shape
    E, K = cfg.num_experts, cfg.top_k
    gate_vals, gate_idx, onehot, aux = _gating(x, router_w, cfg, token_mask, group)
    if ring is None:
        flat = onehot.transpose(1, 2).reshape(B, K * T, E)
        pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, K, T, E).transpose(1, 2)
        return gate_vals, gate_idx, onehot, pos, aux
    every = ring.all_gather([onehot.sum(dim=1)[None]], 0)                 # [windows, B, K, E]
    total = every.sum(dim=0)
    before = torch.cumsum(total, dim=1) - total + every[:ring.positions[0]].sum(dim=0)
    pos = torch.cumsum(onehot, dim=1) - onehot + before[:, None]
    return gate_vals, gate_idx, onehot, pos, aux


def _row_capacity(T: int, cfg: MoEConfig, ring) -> int:
    """``capacity`` of a whole row, of which a context gang's rank holds a
    window of ``T`` tokens."""
    return capacity(T * (ring.n if ring is not None else 1), cfg)


def _dropped_frac(kept: torch.Tensor, aux: dict, cfg: MoEConfig, group) -> dict:
    """``aux`` with ``moe_n_valid`` replaced by ``moe_dropped_frac``: the
    share of the valid choices that found no slot (``kept`` of them did,
    summed over ``group`` as the count was)."""
    kept = kept.detach().float()
    if group is not None:
        kept = kept.clone()
        dist.all_reduce(kept, group=group)
    aux = dict(aux)
    n_valid = aux.pop("moe_n_valid").detach()
    aux["moe_dropped_frac"] = 1.0 - kept / (n_valid * cfg.top_k)
    return aux


def route(x, router_w, cfg: MoEConfig, token_mask: torch.Tensor | None = None, group=None, ring=None):
    """Top-k routing with capacity, GShard's dense representation: x [B, T,
    D] → (dispatch [B, T, E, C] 0/1, combine [B, T, E, C] f32, aux). A
    choice past ``capacity(T)`` of its expert's slots in its row is dropped.
    ``ring``: x holds a window of the rows (``_route_common``); C and the
    slots are the whole row's, and this window's tokens fill its slots."""
    C = _row_capacity(x.shape[1], cfg, ring)
    gate_vals, _, onehot, pos, aux = _route_common(x, router_w, cfg, token_mask, group, ring)
    within = (pos < C).float()
    # one_hot of a position >= C is all zeros, as jax.nn.one_hot makes it
    slot = F.one_hot(pos.long().clamp(max=C), C + 1)[..., :C].float()        # [B,T,K,E,C]
    dispatch = (onehot * within)[..., None] * slot
    combine = (dispatch * gate_vals[..., None, None]).sum(dim=2)
    dispatch = dispatch.sum(dim=2)
    return dispatch, combine, _dropped_frac(dispatch.sum(), aux, cfg, group)


def route_indices(x, router_w, cfg: MoEConfig, token_mask: torch.Tensor | None = None, group=None, ring=None):
    """``route``'s slots as gather indices: (src [B, E, C] int64 token of
    each slot, valid [B, E, C] bool, gate [B, E, C] f32 combine weight,
    aux). Masked tokens claim no slot. ``ring``: as ``route``'s; a slot of
    another window's token is not valid here."""
    B, T, _ = x.shape
    E, C, K = cfg.num_experts, _row_capacity(T, cfg, ring), cfg.top_k
    gate_vals, gate_idx, onehot, pos, aux = _route_common(x, router_w, cfg, token_mask, group, ring)
    pos_of_choice = (pos * onehot).sum(dim=-1).long()                         # [B,T,K]
    within = pos_of_choice < C
    if token_mask is not None:
        within = within & token_mask.bool()[:, :, None]
    b = torch.arange(B, device=x.device)[:, None, None]
    t = torch.arange(T, device=x.device)[None, :, None].expand(B, T, K)
    ok = within.reshape(-1)
    cells = ((b * E + gate_idx) * C + pos_of_choice).reshape(-1)[ok]         # slots are unique
    src = torch.zeros(B * E * C, dtype=torch.long, device=x.device).index_put((cells,), t.reshape(-1)[ok])
    valid = torch.zeros(B * E * C, dtype=torch.bool, device=x.device).index_put(
        (cells,), torch.ones((), dtype=torch.bool, device=x.device))
    gate = torch.zeros(B * E * C, dtype=torch.float32, device=x.device).index_put(
        (cells,), gate_vals.reshape(-1)[ok].float())
    shape = (B, E, C)
    return src.view(shape), valid.view(shape), gate.view(shape), _dropped_frac(valid.sum(), aux, cfg, group)


def route_ragged(x, router_w, cfg: MoEConfig, token_mask: torch.Tensor | None = None,
                 tile: int | None = None, group=None, shards: int = 0):
    """Capacity-free routing for the grouped-GEMM dispatch: a counting sort
    of all N = B·T·K choices by expert (rank within (batch row, expert) by
    cumsum over t·K + k, then earlier rows, then earlier experts), so the
    order is b-major inside each expert's span. With ``tile`` every span is
    padded up to a multiple of it (at least one tile) and the row count is
    the static bound ``PN = (ceil(N/tile) + E)·tile``; pad rows keep token 0
    and gate 0. ``group``, ``shards``: as ``_gating``'s.

    Returns (sort_tok [N or PN] int32, dest [N] int64, gate_vals [B,T,K],
    gate_sorted [N or PN] f32, group_sizes [E] int64, aux)."""
    B, T, _ = x.shape
    E, K = cfg.num_experts, cfg.top_k
    N = B * T * K
    gate_vals, gate_idx, _, aux = _gating(x, router_w, cfg, token_mask, group, shards)
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


class _SpanDispatchGather(torch.autograd.Function):
    """A span's rows, ``x_flat[tok_span]``, with a GATHER-form backward:
    ``dx[t] = Σ_k dxs[idx[t, k]]`` over the choices in the span, which are
    those whose ``gates`` are not 0 (JAX's ``_span_dispatch_gather``; a
    choice with a zero gate gets a zero row cotangent from the combine
    anyway). ``gates`` is a mask here: its gradient flows through the
    combine."""

    @staticmethod
    def forward(ctx, x_flat, tok_span, idx, gates):
        ctx.save_for_backward(idx, gates)
        ctx.bt = x_flat.shape[0]
        return x_flat[tok_span.long()]

    @staticmethod
    def backward(ctx, dxs):
        idx, gates = ctx.saved_tensors
        K = idx.shape[0] // ctx.bt
        picked = dxs[idx].reshape(ctx.bt, K, dxs.shape[-1])
        dx = torch.where((gates != 0).reshape(ctx.bt, K, 1), picked, torch.zeros((), dtype=dxs.dtype,
                                                                                  device=dxs.device))
        return dx.sum(dim=1), None, None, None


class _CombineGather(torch.autograd.Function):
    """y[t] = Σ_k gate[t,k] · ys[dest[t,k]] with a GATHER-form backward:
    sorted row j belongs to token ``sort_tok[j]`` with weight
    ``gate_sorted[j]`` (0 on pad rows), so ``dys[j] = gate_sorted[j] ·
    dy[sort_tok[j]]``, and ``dgate[t,k] = (ys ⊙ dy[sort_tok]).sum(-1)[dest[t,k]]``.
    ``f32``: y in f32, not rounded to ys' dtype (a partial that a line
    sums before its one rounding). ``keep`` [BT, K]: the choices whose rows
    are read; the others' rows are 0 (JAX's ``row_ok``), so a pad row's
    unspecified values, which a clamped index may point at, never reach
    y."""

    @staticmethod
    def forward(ctx, ys, dest, sort_tok, gate_vals, gate_sorted, f32=False, keep=None):
        ctx.save_for_backward(ys, dest, sort_tok, gate_vals, gate_sorted, keep)
        BT, K = gate_vals.shape
        yc = ys[dest].reshape(BT, K, ys.shape[-1])
        if keep is not None:
            yc = torch.where(keep[..., None], yc, torch.zeros((), dtype=yc.dtype, device=yc.device))
        gates = gate_vals.to(ys.dtype)
        if f32:
            yc, gates = yc.float(), gates.float()
        return torch.einsum("tkd,tk->td", yc, gates)

    @staticmethod
    def backward(ctx, dy):
        ys, dest, sort_tok, gate_vals, gate_sorted, keep = ctx.saved_tensors
        dy = dy.to(ys.dtype)  # an f32 y's cotangent holds ys-dtype values: the same sums as a ys-dtype y's
        dys_raw = dy[sort_tok.long()]
        dys = dys_raw * gate_sorted[:, None].to(dy.dtype)
        dgate_sorted = (ys.float() * dys_raw.float()).sum(dim=-1)
        dgate = dgate_sorted[dest].reshape(gate_vals.shape)
        if keep is not None:
            dgate = torch.where(keep, dgate, 0.0)
        return dys.to(ys.dtype), None, None, dgate.to(gate_vals.dtype), None, None, None


def kernel_eligible(cfg: MoEConfig, D: int, F: int, dtype: torch.dtype, device: torch.device) -> bool:
    """JAX's ``_kernel_eligible``, decided before any launch: the ragged
    dispatch in bf16 with D and F multiples of 128 goes to B7/B8 on the
    card. On the CPU the wrappers run the kernels' plain versions, which
    take every dtype and shape, so the CPU's ragged dispatch keeps them.
    Every other case is the ``ragged_xla`` product."""
    if cfg.dispatch != "ragged":
        return False
    return device.type != "cuda" or (D % 128 == 0 and F % 128 == 0 and dtype == torch.bfloat16)


def _expert_swiglu(xs, w_gate, w_up, w_down, group_sizes, tile: int):
    """Grouped expert SwiGLU on sorted rows through ``moe_swiglu_grouped``."""
    tg = moe_gemm.tile_group_map(group_sizes, xs.shape[0] // tile, tile)
    return moe_gemm.moe_swiglu_grouped(xs, w_gate, w_up, w_down, tg, tile)


def _ragged_swiglu(xs, w_gate, w_up, w_down, group_sizes):
    """JAX's three ``jax.lax.ragged_dot`` grouped products: group e's rows
    are the next ``group_sizes[e]`` of ``xs`` (read to the host), each
    through expert e's SwiGLU in xs' dtype; rows past the groups are 0."""
    outs, start = [], 0
    for e, n in enumerate(group_sizes.tolist()):  # an empty group too: its weights get a zero gradient
        rows = xs[start:start + n]
        h = (F.silu(rows @ w_gate[e]) * (rows @ w_up[e])).to(xs.dtype)
        outs.append(h @ w_down[e])
        start += n
    if start < xs.shape[0]:
        outs.append(xs.new_zeros(xs.shape[0] - start, w_down.shape[-1]))
    return torch.cat(outs)


def _grouped(xs, w_gate, w_up, w_down, group_sizes, tile):
    """B7/B8 on tile-padded spans (``tile``), else the grouped product."""
    if tile is not None:
        return _expert_swiglu(xs, w_gate, w_up, w_down, group_sizes, tile)
    return _ragged_swiglu(xs, w_gate, w_up, w_down, group_sizes)


def _route_named(x, router_w, cfg, token_mask, tile, group, shards):
    """``route_ragged``'s outputs, named as JAX names them: the "flash" remat
    policy keeps the routing; moe_disp and moe_combine only when
    TONY_REMAT_EXTRA_NAMES lists them."""
    *routed, aux = route_ragged(x, router_w, cfg, token_mask, tile=tile, group=group, shards=shards)
    return (*(checkpoint_name(t, "moe_route") for t in routed), aux)


def _ragged_expert_ffn(x, router_w, w_gate, w_up, w_down, cfg: MoEConfig, token_mask, group=None,
                       model=None):
    """Grouped-GEMM MoE on this rank's rows: route, gather the rows, run the
    expert MLP over expert-sorted spans, gather back to choice order and sum
    with the gates. ``model``: the model line's group, whose ranks each hold
    ``F/tp`` columns of every expert (the module docstring)."""
    B, T, D = x.shape
    K = cfg.top_k
    tile = moe_gemm.TILE if kernel_eligible(cfg, D, w_gate.shape[-1], x.dtype, x.device) else None
    sort_tok, dest, gate_vals, gate_sorted, group_sizes, aux = _route_named(
        x, router_w, cfg, token_mask, tile, group, 0)
    rows = copy_to_model(x.reshape(B * T, D), model)
    xs = checkpoint_name(_DispatchGather.apply(rows, sort_tok, dest), "moe_disp")
    ys = _grouped(xs, w_gate, w_up, w_down, group_sizes, tile)
    gates = copy_to_model(gate_vals.reshape(B * T, K), model)
    y = reduce_from_model(_CombineGather.apply(ys, dest, sort_tok, gates, gate_sorted), model)
    y = checkpoint_name(y, "moe_combine")
    return y.reshape(B, T, D).to(x.dtype), aux


def _expert_span(mesh, num_experts: int) -> tuple[int, int]:
    """(first expert, experts) of this rank's contiguous span on the expert
    axis (all of them without one)."""
    ep = axis_size(mesh, AXIS_EXPERT)
    n = num_experts // ep
    return (mesh.axis_index(AXIS_EXPERT) * n if ep > 1 else 0), n


def _span_rows(sort_tok, gate_sorted, group_sizes, lo: int, n_local: int):
    """This rank's span of the sorted rows: (start, rows, token and gate of
    each row, the span's group sizes). The span holds the experts' padded
    rows exactly: its start and length are read to the host, one
    synchronisation a call (JAX slices a static bound of every row that
    could land there instead, ``(ceil(N/tile) + E/ep)·tile``, which B7/B8
    would compute whole). An empty span (the grouped product, no row
    routed here) is one zero row."""
    offsets = torch.cumsum(group_sizes, 0) - group_sizes
    gs_local = group_sizes[lo:lo + n_local]
    start, total = torch.stack([offsets[lo], gs_local.sum()]).tolist()
    span = max(total, 1)
    tok_span = F.pad(sort_tok, (0, 1))[start:start + span]
    gate_span = F.pad(gate_sorted, (0, 1))[start:start + span]
    return start, total, span, tok_span, gate_span, gs_local


def _ragged_expert_ffn_ep(x, router_w, w_gate, w_up, w_down, cfg: MoEConfig, mesh, token_mask, group):
    """JAX's ``_ragged_expert_ffn_ep`` on this rank of an expert line: the
    routing of the line's shared rows, the span of this rank's ``E/ep``
    experts (``_span_rows``), B7/B8 or the grouped product on it with that
    many groups, the choices in the span combined, and ``y`` summed over
    the line. The partials stay in f32 until that sum, which the line
    takes in f32 anyway: bf16 gate·ys products are exact in f32, so ``y``
    is rounded once, from the sum one process rounds. The router losses
    are JAX's per-shard means over the data × fsdp shards (``_gating``'s
    ``shards``)."""
    B, T, D = x.shape
    K = cfg.top_k
    line = expert_group(mesh)
    lo, n_local = _expert_span(mesh, cfg.num_experts)
    tile = moe_gemm.TILE if kernel_eligible(cfg, D, w_gate.shape[-1], x.dtype, x.device) else None
    shards = axis_size(mesh, AXIS_DATA) * axis_size(mesh, AXIS_FSDP)
    sort_tok, dest, gate_vals, gate_sorted, group_sizes, aux = _route_named(
        x, router_w, cfg, token_mask, tile, group, shards)
    start, total, span, tok_span, gate_span, gs_local = _span_rows(sort_tok, gate_sorted, group_sizes, lo,
                                                                   n_local)
    rel = dest - start
    in_span = ((rel >= 0) & (rel < total)).reshape(B * T, K)
    idx = rel.clamp(0, span - 1)
    gates = torch.where(in_span, copy_to_model(gate_vals.reshape(B * T, K), line), 0.0)
    rows = copy_to_model(x.reshape(B * T, D), line)
    xs = checkpoint_name(_SpanDispatchGather.apply(rows, tok_span, idx, gates), "moe_disp")
    ys = _grouped(xs, w_gate, w_up, w_down, gs_local, tile)
    y = reduce_from_model(_CombineGather.apply(ys, idx, tok_span, gates, gate_span, True, in_span), line)
    y = checkpoint_name(y.to(x.dtype), "moe_combine")
    return y.reshape(B, T, D), aux


def _expert_mlp(xe, w_gate, w_up, w_down):
    """xe [E, B, C, D] → [E, B, C, D] through each expert's SwiGLU (plain
    batched products over the experts, as JAX's einsums)."""
    E, B, C, D = xe.shape
    flat = xe.reshape(E, B * C, D)
    h = F.silu(torch.matmul(flat, w_gate)) * torch.matmul(flat, w_up)
    return torch.matmul(h, w_down).reshape(E, B, C, -1)


def _capacity_ffn(x, router_w, w_gate, w_up, w_down, cfg: MoEConfig, mesh, token_mask, group):
    """The ``"gather"`` and ``"dense"`` dispatches: the routing on every rank
    of a line, this rank's experts' part of the dispatched bank and of the
    combine (all of them on a model line, whose ranks hold F columns), and
    ``y`` summed over the line. In a context gang the slots are the whole
    row's (``_route_common``'s ``ring``): each window fills the bank's slots
    of its own tokens, runs the experts on it and combines its tokens."""
    B, T, D = x.shape
    dtype = x.dtype
    line = expert_group(mesh) or model_group(mesh)
    ring = mesh.ring if mesh is not None and mesh.context_line is not None else None
    lo, n_local = _expert_span(mesh, cfg.num_experts)
    mine = slice(lo, lo + n_local)
    rows = copy_to_model(x, line)
    if cfg.dispatch == "dense":
        dispatch, combine, aux = route(x, router_w, cfg, token_mask, group, ring)
        combine = copy_to_model(combine, line)[:, :, mine]
        xe = torch.einsum("btec,btd->ebcd", dispatch[:, :, mine].to(dtype), rows)
        ye = _expert_mlp(xe, w_gate, w_up, w_down)
        y = torch.einsum("ebcd,btec->btd", ye, combine.to(dtype))
        return reduce_from_model(y, line).to(dtype), aux
    src, valid, gate, aux = route_indices(x, router_w, cfg, token_mask, group, ring)
    src, valid = checkpoint_name(src, "moe_route")[:, mine], checkpoint_name(valid, "moe_route")[:, mine]
    gate = copy_to_model(checkpoint_name(gate, "moe_route"), line)[:, mine]
    C = src.shape[-1]
    # no valid mask on the dispatch: an empty slot gathers some row, which the
    # zero combine weight keeps out of y
    xe = rows[torch.arange(B, device=x.device)[:, None, None], src].transpose(0, 1)      # [E_l, B, C, D]
    ye = _expert_mlp(xe, w_gate, w_up, w_down).transpose(0, 1)                            # [B, E_l, C, D]
    w = torch.where(valid, gate, 0.0).to(dtype)
    flat = (ye * w[..., None]).reshape(B, n_local * C, D)
    y = torch.zeros((B, T, D), dtype=flat.dtype, device=x.device).scatter_add(
        1, src.reshape(B, n_local * C, 1).expand(-1, -1, D), flat)
    return reduce_from_model(y, line).to(dtype), aux


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, cfg: MoEConfig, mesh=None,
            token_mask: torch.Tensor | None = None, group=None) -> tuple[torch.Tensor, dict]:
    """SwiGLU mixture-of-experts FFN through ``cfg.dispatch`` (the module docstring).

    x [B, T, D]; router_w [D, E]; w_gate/w_up [E, D, F]; w_down [E, F, D]
    (``F/tp`` of F on a model axis, this rank's ``E/ep`` experts on an
    expert axis) → (y [B, T, D], aux losses). ``group``: the data × fsdp
    (× context) ranks that share the batch (``_gating``), never a model or
    expert line, whose ranks hold the same rows."""
    context_degree(mesh, tensor_parallel=True)  # stages (A13) raise
    check_dispatch(cfg.dispatch)
    ep = axis_size(mesh, AXIS_EXPERT)
    check_expert_axis(cfg.num_experts, ep)
    if cfg.dispatch in ("gather", "dense"):
        return _capacity_ffn(x, router_w, w_gate, w_up, w_down, cfg, mesh, token_mask, group)
    if ep > 1:
        return _ragged_expert_ffn_ep(x, router_w, w_gate, w_up, w_down, cfg, mesh, token_mask, group)
    return _ragged_expert_ffn(x, router_w, w_gate, w_up, w_down, cfg, token_mask, group, model_group(mesh))
