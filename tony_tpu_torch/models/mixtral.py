"""Mixtral-style sparse-MoE decoder: config, random init, forward and training loss.

Counterpart of ``tony_tpu/models/mixtral.py``: the Llama backbone
(RMSNorm, RoPE, GQA attention, stacked layers) with the dense FFN replaced
by a top-k-of-E SwiGLU mixture routed per token (``parallel/expert.py``).
The parameter tree is the JAX one: per layer ``router`` [D, E] in f32 and
``we_gate``/``we_up`` [E, D, F], ``we_down`` [E, F, D] in the model dtype,
stacked over layers. On an ``fsdp`` axis the params hold this rank's blocks
per ``sharding_rules`` (JAX's) and each leaf is gathered where it is used,
as in Llama: B7/B8 receive each layer's expert weights, gathered and
contiguous.

On a ``model`` axis (Megatron's tensor parallelism, JAX's rules) the
attention half is Llama's (``llama.attention_residual``: ``H/tp`` query
heads, ``Hkv/tp`` kv heads a rank), the embedding and the head are
vocab-parallel and the loss the vocab-parallel CE, as Llama's; each rank
holds ``F/tp`` columns of every expert and runs B7/B8 on them
(``moe_ffn``), while the router stays whole on every rank. On an
``expert`` axis (JAX's ``P(None, "expert", …)`` on the expert leaves) each
rank holds the contiguous span of ``E/ep`` whole experts, their fsdp blocks
gathered a layer at a time, and runs them on the expert line's shared rows
(``moe_ffn``); the rest of the model is replicated over the line. A context
axis runs Llama's context-parallel attention (``llama._attention``, each
layer's ``attention_residual``): in one process on whole rows, in a gang on
each process's window of them (``llama.context_inputs``), whose ``B·T/c``
tokens the ragged dispatch routes through B7/B8, with the router losses
over the whole batch (``group``: the data × fsdp × context ranks), as JAX's
GSPMD run of ``_ragged_expert_ffn`` takes them. Beside a model axis the
window runs on the rank's heads and ``F/tp`` expert columns, and ``group``
is the data × fsdp × context ranks of its model index. An expert axis
beside a model or context axis (A11's rest) waits.

On a ``stage`` axis ``pp_value_and_grad`` runs the 1F1B schedule
(``parallel/pipeline.py``) with the experts stage-local, the ragged
dispatch (B7/B8) inside each stage, as JAX's "PP×EP deployment shape of an
8×7B"; the router losses thread through the hand-scheduled backward as the
stage's aux scalar, a per-microbatch and per-shard mean as JAX's.

``moe_dispatch`` and ``capacity_factor`` are JAX's: the ragged dispatch
(B7/B8 where eligible), ``ragged_xla``, and the capacity dispatches
``gather`` and ``dense``; ``config_from_dict`` refuses an unknown dispatch
with JAX's ``ValueError``. In a gang, ``loss_fn(..., group=)`` takes the
router losses over the whole group's batch, as JAX does over a
data-parallel mesh's global arrays (the data × fsdp ranks of this rank's
model or expert index, whose rows differ), or as its per-shard means on an
expert axis (``parallel/expert.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import torch
import torch.distributed as dist

from tony_tpu_torch.models import llama as llama_mod
from tony_tpu_torch.ops import attention as attn_ops
from tony_tpu_torch.ops import layers as L
from tony_tpu_torch.parallel.collectives import copy_to_model
from tony_tpu_torch.parallel.expert import MoEConfig, check_dispatch, check_expert_axis, moe_ffn
from tony_tpu_torch.parallel import pipeline
from tony_tpu_torch.parallel.mesh import (AXIS_EXPERT, AXIS_MODEL, AXIS_STAGE, axis_size, check_stage_layout,
                                          context_degree, context_window, model_group)
from tony_tpu_torch.parallel.sharding import P, Place, ShardingRules, gather, gathering, keep_whole

_AUX = ("moe_balance_loss", "moe_z_loss", "moe_dropped_frac")


@dataclass(frozen=True)
class MixtralConfig(llama_mod.LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    aux_loss_coef: float = 1e-2   # load-balance loss weight
    router_z_coef: float = 1e-3   # router z-loss weight
    capacity_factor: float = 1.25
    moe_dispatch: str = "ragged"  # ragged (B7/B8 where eligible) | ragged_xla | gather | dense

    @property
    def moe(self) -> MoEConfig:
        return MoEConfig(self.num_experts, self.top_k, self.capacity_factor,
                         router_z_coef=self.router_z_coef, aux_loss_coef=self.aux_loss_coef,
                         dispatch=self.moe_dispatch)

    def num_params(self) -> int:
        base = super().num_params()
        D, F = self.d_model, self.d_ff
        dense_ffn = self.n_layers * 3 * D * F
        moe_ffn_params = self.n_layers * (self.num_experts * 3 * D * F + D * self.num_experts)
        return base - dense_ffn + moe_ffn_params

    def active_params(self) -> int:
        """Params touched per token (top-k of E experts) — the MFU basis."""
        D, F = self.d_model, self.d_ff
        dense_ffn = self.n_layers * 3 * D * F
        active_ffn = self.n_layers * (self.top_k * 3 * D * F + D * self.num_experts)
        return super().num_params() - dense_ffn + active_ffn

    def flops_per_token(self) -> int:
        from tony_tpu_torch.train.metrics import transformer_flops_per_token

        return transformer_flops_per_token(
            self.active_params(), self.n_layers, self.d_model, self.max_seq, training=True
        )


MIXTRAL_8X7B = MixtralConfig(
    vocab_size=32_000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    d_ff=14_336, max_seq=8192, rope_theta=1e6, num_experts=8, top_k=2,
    # released Mixtral-8x7B checkpoints set sliding_window=null
    sliding_window=0,
)
MIXTRAL_TINY = MixtralConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
    max_seq=128, num_experts=4, top_k=2, remat=False, attn_impl="reference",
)
PRESETS = {"mixtral-8x7b": MIXTRAL_8X7B, "tiny": MIXTRAL_TINY}


def init(gen: torch.Generator, cfg: MixtralConfig, device: torch.device | str,
         place: Place = keep_whole) -> dict:
    """Random parameter tree: the Llama init for the backbone, the router in
    f32 and the experts drawn one [D, F] slab at a time (truncated normal in
    [-2, 2] · fan_in^-0.5), so the f32 temporaries stay one slab's size.
    Each leaf goes to ``place(name, leaf)`` as it is drawn (``llama.init``).
    Its bits differ from the JAX init."""
    D, F, E, Lyr = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.n_layers
    dt = cfg.tdtype

    def draw(shape, fan_in, dtype):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (t * fan_in ** -0.5).to(dtype)

    def experts(rows, cols, fan_in):
        out = torch.empty((Lyr, E, rows, cols), dtype=dt, device=device)
        for i in range(Lyr):
            for e in range(E):
                out[i, e] = draw((rows, cols), fan_in, dt)
        return out

    base = llama_mod.init(gen, dataclasses.replace(cfg, d_ff=1), device, place)  # no dense FFN to draw
    layers = {k: v for k, v in base["layers"].items() if k not in ("w_gate", "w_up", "w_down")}
    layers.update(
        router=place("layers/router", draw((Lyr, D, E), D, torch.float32)),
        we_gate=place("layers/we_gate", experts(D, F, D)),
        we_up=place("layers/we_up", experts(D, F, D)),
        we_down=place("layers/we_down", experts(F, D, F)),
    )
    base["layers"] = layers
    return base


def sharding_rules(cfg: MixtralConfig) -> ShardingRules:
    """JAX's rules."""
    return ShardingRules([
        (r"embed", P("model", "fsdp")),
        (r"layers/(wq|wk|wv)", P(None, "fsdp", "model")),
        (r"layers/wo", P(None, "model", "fsdp")),
        (r"layers/router", P(None, None, None)),
        (r"layers/(we_gate|we_up)", P(None, "expert", "fsdp", "model")),
        (r"layers/we_down", P(None, "expert", "model", "fsdp")),
        (r"layers/.*norm", P(None, None)),
        (r"final_norm", P(None)),
        (r"lm_head", P("fsdp", "model")),
    ])


def _layer(x, lp: dict, cos, sin, cfg: MixtralConfig, mesh, segment_ids=None, positions=None,
           token_mask=None, group=None):
    """One Mixtral decoder layer (pre-norm GQA attention + MoE FFN) on this
    rank's heads and expert columns → (x, moe_balance_loss, moe_z_loss,
    moe_dropped_frac)."""
    x = llama_mod.attention_residual(x, lp, cos, sin, cfg, mesh, segment_ids=segment_ids, positions=positions)
    h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    y, aux = moe_ffn(h, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"], cfg.moe,
                     mesh, token_mask=token_mask, group=group)
    return (x + y, *(aux[k] for k in _AUX))


def hidden_states(params: dict, tokens: torch.Tensor, cfg: MixtralConfig, mesh=None,
                  segment_ids=None, group=None) -> tuple[torch.Tensor, dict]:
    """tokens [B, T] → (final-norm hidden states [B, T_w, D] of this
    process's window of the rows (``llama.hidden_states``), moe aux losses:
    balance and z summed over layers, dropped fraction averaged).
    ``segment_ids`` [B, T] (packed sequences): segment-confined attention,
    per-segment RoPE positions, and padding (segment 0) routed with zero
    gates and left out of the router losses. ``group``: the ranks sharing
    the batch, over which the router losses are taken (``moe_ffn``)."""
    context_degree(mesh, tensor_parallel=True)  # a mesh the port does not run raises
    llama_mod.check_model_axis(cfg, axis_size(mesh, AXIS_MODEL), mesh)
    check_expert_axis(cfg.num_experts, axis_size(mesh, AXIS_EXPERT))
    T = tokens.shape[1]
    cos, sin = L.rope_frequencies(cfg.head_dim, T, cfg.rope_theta, cfg.rope_scaling,
                                  device=tokens.device)
    tokens, segment_ids, positions = llama_mod.context_inputs(tokens, mesh, segment_ids)
    token_mask = (segment_ids != 0) if segment_ids is not None else None
    rules = sharding_rules(cfg)
    x = llama_mod.embed_lookup(gather(params["embed"], rules.spec_for("embed"), mesh), tokens, mesh)
    block_fn = attn_ops.remat_block(
        gathering(partial(_layer, cos=cos, sin=sin, cfg=cfg, mesh=mesh, segment_ids=segment_ids,
                          positions=positions, token_mask=token_mask, group=group), rules, mesh),
        cfg.remat, cfg.remat_policy,
    )
    aux = {k: torch.zeros((), dtype=torch.float32, device=tokens.device) for k in _AUX}
    per_layer = {name: w.unbind(0) for name, w in params["layers"].items()}
    for i in range(cfg.n_layers):
        x, balance, z, dropped = block_fn(x, {name: ws[i] for name, ws in per_layer.items()})
        aux = {"moe_balance_loss": aux["moe_balance_loss"] + balance,
               "moe_z_loss": aux["moe_z_loss"] + z,
               "moe_dropped_frac": aux["moe_dropped_frac"] + dropped / cfg.n_layers}
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def forward(params: dict, tokens: torch.Tensor, cfg: MixtralConfig, mesh=None,
            segment_ids=None, group=None) -> tuple[torch.Tensor, dict]:
    """tokens [B, T] → (logits [B, T_w, V] of this process's window (on a model axis this rank's
    ``V/tp`` columns of them), moe aux losses)."""
    x, aux = hidden_states(params, tokens, cfg, mesh, segment_ids=segment_ids, group=group)
    return copy_to_model(x, model_group(mesh)) @ lm_head(params, cfg, mesh), aux


def lm_head(params: dict, cfg: MixtralConfig, mesh=None) -> torch.Tensor:
    """The head gathered on an fsdp axis: whole, or this rank's ``V/tp``
    columns on a model axis."""
    return gather(params["lm_head"], sharding_rules(cfg).spec_for("lm_head"), mesh)


def _scale_grad(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``t``'s value, bit for bit, with its gradient multiplied by ``s``."""
    return t.detach() + s * (t - t.detach())


def loss_fn(params: dict, batch: dict, cfg: MixtralConfig, mesh=None,
            group=None) -> tuple[torch.Tensor, dict]:
    """batch: {"tokens": [B, T+1], optional "segment_ids"} → (ce + balance +
    z loss, {"loss", "ce_loss", "tokens", moe aux}). ``cfg.ce_chunk > 0``
    fuses the lm head and CE per chunk so the [B, T, V] logits never exist.

    ``group``: the ranks that each hold a contiguous slice of this batch
    (``make_train_step`` passes those that share one microbatch). The
    balance and z losses are then JAX's over the whole batch, the same value
    on every rank, while CE stays this rank's token mean over its ``n``
    targets. The trainer weighs rank r's gradient by ``n_r / Σn``, so the
    router losses' gradients are scaled here by ``Σn / n_r``: the gang's
    reduction then counts each rank's share of them once. A rank with no
    targets weighs 0 and scales them by 0: exact when its rows are all
    padding, while a rank whose rows hold only one-token segments loses its
    share of the router gradient. One process (or a group of one) keeps the
    single-process path.

    On a model axis the CE is vocab-parallel over the model line (Llama's),
    every rank of a line gets the same loss and ``n``, and ``group`` is the
    data × fsdp ranks of this rank's model index, so ``Σn`` counts each row
    slice once; an expert line's ranks likewise share their rows and
    ``n``. There the router losses are JAX's per-shard means, each shard's
    ``1/R`` share summed over ``group`` (``parallel/expert.py``), and the
    same scale leaves each shard's with weight ``1/R`` in the gang's
    gradient, as JAX's ``pmean`` gives it.

    In a context gang ``group`` also spans the context line, whose ranks
    each hold a window of the same rows: CE and ``n`` are over this
    process's window of the targets, and the router losses over every
    window's tokens, so ``Σn`` counts each target once."""
    if group is not None and dist.get_world_size(group) == 1:
        group = None
    tokens = batch["tokens"]
    targets, seg_in = llama_mod.mask_packed_targets(tokens, batch.get("segment_ids"))
    lo, hi = context_window(mesh, targets.shape[1])
    targets = targets[:, lo:hi]
    line = model_group(mesh)
    if cfg.ce_chunk > 0:
        x, aux = hidden_states(params, tokens[:, :-1], cfg, mesh, segment_ids=seg_in, group=group)
        ce, n = L.chunked_cross_entropy_loss(copy_to_model(x, line), lm_head(params, cfg, mesh), targets,
                                             chunk=cfg.ce_chunk, group=line)
    else:
        logits, aux = forward(params, tokens[:, :-1], cfg, mesh, segment_ids=seg_in, group=group)
        ce, n = L.cross_entropy_loss(logits, targets, group=line)
    balance, z = aux["moe_balance_loss"], aux["moe_z_loss"]
    if group is not None:
        total = n.detach().clone()
        dist.all_reduce(total, group=group)
        s = torch.where(n > 0, total.float() / n.float().clamp_min(1.0), 0.0)
        balance, z = _scale_grad(balance, s), _scale_grad(z, s)
    loss = ce + balance + z
    return loss, {"loss": loss, "ce_loss": ce, "tokens": n, **aux}


def pp_value_and_grad(params: dict, batch: dict, cfg: MixtralConfig, mesh, num_microbatches: int = 2,
                      wire_dtype: torch.dtype = torch.bfloat16) -> tuple[torch.Tensor, dict, dict]:
    """1F1B pipeline train-step core for the MoE model (JAX's
    ``pp_value_and_grad``): ``(loss, {"loss", "ce_loss", "tokens",
    "moe_aux_loss"}, grads)``, the grads mirroring this rank's ``params``
    (``llama.pp_value_and_grad``'s contract). The objective is ``CE mean +
    aux``, the balance and z losses summed over a stage's layers and averaged
    over microbatches and batch shards; their cotangent is seeded with the
    global batch's valid-target count, counted before the schedule (one
    scalar sum over the data × fsdp ranks), so the division by the count
    after it leaves them at unit scale. A bf16 wire may flip near-tie
    routing against an unpipelined f32 run, as JAX's docstring says."""
    if axis_size(mesh, AXIS_STAGE) <= 1:
        return llama_mod.flat_value_and_grad(loss_fn, params, batch, cfg, mesh)
    check_stage_layout(mesh.shape, moe=True)
    tokens = batch["tokens"]
    B, T = tokens.shape[0], tokens.shape[1] - 1
    cos, sin = L.rope_frequencies(cfg.head_dim, T, cfg.rope_theta, cfg.rope_scaling, device=tokens.device)
    rules = sharding_rules(cfg)

    def stage_fn(stage_lp, h, mb):
        seg_in, positions = llama_mod.stage_inputs(mb)
        token_mask = (seg_in != 0) if seg_in is not None else None

        def block(x_aux, lp):
            x, aux = x_aux
            x, balance, z, _ = _layer(x, lp, cos, sin, cfg, None, segment_ids=seg_in, positions=positions,
                                      token_mask=token_mask)
            return x, aux + balance + z

        block_fn = attn_ops.remat_block(gathering(block, rules, mesh), cfg.remat, cfg.remat_policy)
        return llama_mod.run_layers(block_fn, stage_lp, (h, torch.zeros((), dtype=torch.float32, device=h.device)))

    # the valid-target count, known before the schedule, seeds the aux cotangent
    targets_all, _ = llama_mod.mask_packed_targets(tokens, batch.get("segment_ids"))
    ntok_pre = (targets_all != -100).sum().float()
    if dist.get_world_size(mesh.group) > 1:
        dist.all_reduce(ntok_pre, group=mesh.group)
    nll, ntok, aux, grads = pipeline.pp_step(
        params, batch, rules=rules, mesh=mesh, num_microbatches=num_microbatches,
        act_shape=(B // num_microbatches, T, cfg.d_model), compute_dtype=cfg.tdtype, wire_dtype=wire_dtype,
        stage_fn=stage_fn, embed_fn=partial(llama_mod.pp_embed, rules=rules, mesh=mesh),
        loss_head_fn=partial(llama_mod.pp_loss_head, cfg=cfg, rules=rules, mesh=mesh),
        stage_has_aux=True, aux_seed_scale=ntok_pre)
    ce = nll / ntok.clamp_min(1.0)
    loss = ce + aux
    return loss, {"loss": loss, "ce_loss": ce, "tokens": ntok, "moe_aux_loss": aux}, grads


synthetic_batch = llama_mod.synthetic_batch


def config_from_dict(d) -> MixtralConfig:
    if isinstance(d, str):
        return PRESETS[d]
    check_dispatch(d.get("moe_dispatch", "ragged"))
    fields = {f.name for f in dataclasses.fields(MixtralConfig)}
    return dataclasses.replace(
        PRESETS.get(d.get("preset", ""), MixtralConfig()),
        **{k: v for k, v in d.items() if k in fields},
    )
