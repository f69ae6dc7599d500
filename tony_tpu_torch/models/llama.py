"""Llama-family decoder: config, random init, forward and training loss.

Counterpart of ``tony_tpu/models/llama.py``: the same ``LlamaConfig``
fields, the same presets and the same parameter tree — a nested dict with
stacked layers (leading dim L on every block weight), weights ``[K, N]``
used as ``x @ w``. The layer scan is a Python loop over the stacked dim
(each stacked weight is unbound once per forward, so its gradient is
stacked once in the backward). A mesh may carry a context axis
(``parallel/mesh.py``): only attention splits T into the mesh ring's
shards (``cp_impl``: "xla" ring, "pallas" ring kernels, "ulysses"). In one
process the model runs on whole ``[B, T, ...]`` tensors, with the JAX
package's single-process semantics; in a gang each process takes its
window of every row (``context_window``): ``hidden_states`` and
``loss_fn`` take whole rows, run on the window's tokens at their global
positions (RoPE, packed positions and the segment table from the whole
row) and return the window's hidden states and its targets' loss, the
target at a window's edge being the next window's first token. On an
``fsdp`` axis the params hold this rank's blocks
per ``sharding_rules`` (JAX's) and each leaf is gathered where it is used:
the embedding before the take, layer i's weights inside its (remat) block,
the head before the product or the chunked CE.

On a ``model`` axis (Megatron's tensor parallelism, JAX's rules) each rank
holds its column blocks of ``wq|wk|wv|w_gate|w_up`` (``H/tp`` whole query
heads, ``Hkv/tp`` kv heads, ``F/tp`` FFN columns), the row blocks of
``wo|w_down``, ``V/tp`` rows of the embedding and ``V/tp`` columns of the
head. A block runs on its local heads (B1-B3 per rank): ``copy_to_model``
at the input of the column products, ``reduce_from_model`` after the row
products; the embedding takes its local rows and sums over the line; the
loss is the vocab-parallel CE (``ops/layers.py``). Beside a context axis
in a gang each rank does this on its window of the rows, and its context
ring (the ranks of its model index) moves the ``Hkv/tp`` kv heads it holds,
as JAX's ring runs on each model line's heads.

On a ``stage`` axis the model trains through ``pp_value_and_grad``, the
1F1B schedule (``parallel/pipeline.py``): each rank holds its stage's
``L/S`` layers (the embedding on the first stage, the final norm and head
on the last) and runs them per microbatch through the same ``_block``
under ``remat_block``, each layer's fsdp blocks gathered as
``hidden_states`` gathers them; no model or context axis reaches a stage,
as JAX's stage passes ``mesh=None`` to ``_block``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import torch

from tony_tpu_torch.ops import attention as attn_ops
from tony_tpu_torch.ops import layers as L
from tony_tpu_torch.ops.ring import ring_attention_pallas, ring_attention_pallas_seg
from tony_tpu_torch.parallel.collectives import all_gather, copy_to_model, reduce_from_model
from tony_tpu_torch.parallel.context import ring_attention, ulysses_attention
from tony_tpu_torch.parallel import pipeline
from tony_tpu_torch.parallel.mesh import (AXIS_CONTEXT, AXIS_MODEL, AXIS_STAGE, axis_size, check_stage_layout,
                                          context_degree, context_window, model_group)
from tony_tpu_torch.parallel.sharding import P, Place, ShardingRules, gather, gathering, keep_whole


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14_336
    max_seq: int = 8192
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"
    attn_impl: str = "auto"
    cp_impl: str = "xla"
    ce_chunk: int = 512
    sliding_window: int = 0
    rope_scaling: tuple = ()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def tdtype(self) -> torch.dtype:
        """The torch dtype named by ``dtype`` (the JAX config's ``jdtype``)."""
        return getattr(torch, self.dtype)

    def num_params(self) -> int:
        D, F, V, Dh = self.d_model, self.d_ff, self.vocab_size, self.head_dim
        per_layer = (
            D * self.n_heads * Dh
            + 2 * D * self.n_kv_heads * Dh
            + self.n_heads * Dh * D
            + 3 * D * F
            + 2 * D
        )
        return V * D + self.n_layers * per_layer + D + D * V

    def flops_per_token(self) -> int:
        """Training FLOPs/token: 6N + causal-attention term 12·L·D·T/2."""
        from tony_tpu_torch.train.metrics import transformer_flops_per_token

        return transformer_flops_per_token(
            self.num_params(), self.n_layers, self.d_model, self.max_seq, training=True
        )


LLAMA3_8B = LlamaConfig()
LLAMA_1B = LlamaConfig(
    vocab_size=32_000, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=8,
    d_ff=5504, max_seq=2048,
)
LLAMA_TINY = LlamaConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=128, remat=False, attn_impl="reference",
)

PRESETS = {"llama3-8b": LLAMA3_8B, "llama-1b": LLAMA_1B, "tiny": LLAMA_TINY}


def init(gen: torch.Generator, cfg: LlamaConfig, device: torch.device | str,
         place: Place = keep_whole) -> dict:
    """Random parameter tree (truncated normal in [-2, 2] · fan_in^-0.5),
    drawn on ``device`` from ``gen`` (a generator on that device). Stacked
    weights are drawn one layer at a time so the f32 temporaries stay one
    layer's size at full width. Each leaf goes to ``place(name, leaf)`` as
    it is drawn, which keeps it whole or keeps a rank's block of it
    (``train.trainer.sharded_init``). Its bits differ from the JAX init."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    Dh, H, Hkv, Lyr = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    dt = cfg.tdtype

    def norm_init(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def draw(shape, fan_in):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (t * fan_in ** -0.5).to(dt)

    def dense(*shape, fan_in):
        if len(shape) == 3:
            out = torch.empty(shape, dtype=dt, device=device)
            for i in range(shape[0]):
                out[i] = draw(shape[1:], fan_in)
            return out
        return draw(shape, fan_in)

    return {
        "embed": place("embed", dense(V, D, fan_in=1.0)),
        "layers": {
            "attn_norm": place("layers/attn_norm", norm_init(Lyr, D)),
            "wq": place("layers/wq", dense(Lyr, D, H * Dh, fan_in=D)),
            "wk": place("layers/wk", dense(Lyr, D, Hkv * Dh, fan_in=D)),
            "wv": place("layers/wv", dense(Lyr, D, Hkv * Dh, fan_in=D)),
            "wo": place("layers/wo", dense(Lyr, H * Dh, D, fan_in=H * Dh)),
            "mlp_norm": place("layers/mlp_norm", norm_init(Lyr, D)),
            "w_gate": place("layers/w_gate", dense(Lyr, D, F, fan_in=D)),
            "w_up": place("layers/w_up", dense(Lyr, D, F, fan_in=D)),
            "w_down": place("layers/w_down", dense(Lyr, F, D, fan_in=F)),
        },
        "final_norm": place("final_norm", norm_init(D)),
        "lm_head": place("lm_head", dense(D, V, fan_in=D)),
    }


def sharding_rules(cfg: LlamaConfig) -> ShardingRules:
    """FSDP × TP rules, JAX's (the stacked leading layer dim never split)."""
    return ShardingRules([
        (r"embed", P("model", "fsdp")),                  # vocab-parallel
        (r"layers/(wq|wk|wv|w_gate|w_up)", P(None, "fsdp", "model")),
        (r"layers/(wo|w_down)", P(None, "model", "fsdp")),
        (r"layers/.*norm", P(None, None)),
        (r"final_norm", P(None)),
        (r"lm_head", P("fsdp", "model")),
    ])


def check_model_axis(cfg: LlamaConfig, tp: int, mesh=None) -> None:
    """Refuse a model axis of ``tp`` that does not split whole heads, kv
    heads, vocabulary rows and FFN columns; beside a context axis of
    ``mesh``, the ring kernels' refusal first, in JAX's words."""
    if tp > 1 and cfg.cp_impl == "pallas" and axis_size(mesh, AXIS_CONTEXT) > 1 and cfg.n_kv_heads % tp:
        raise ValueError(
            "cp_impl='pallas' shards kv heads over 'model' and batch over data×fsdp explicitly: "
            f"n_kv_heads {cfg.n_kv_heads} must divide by model={tp} (cp_impl='xla' has no such constraint)")
    if tp > 1 and (cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.vocab_size % tp or cfg.d_ff % tp):
        raise ValueError(f"n_heads {cfg.n_heads}, n_kv_heads {cfg.n_kv_heads}, vocab_size {cfg.vocab_size} "
                         f"and d_ff {cfg.d_ff} must divide the model axis ({tp})")


def _attention(q, k, v, cfg: LlamaConfig, mesh, segment_ids=None) -> torch.Tensor:
    """Dispatch: context-parallel attention (``cfg.cp_impl``: the plain
    PyTorch ring, the ring kernels, or Ulysses' all-to-all) when the mesh's
    context axis is real, else single-device ``mha``.

    q: [B, H, T, Dh]; k/v: [B, Hkv, T, Dh] (on a model axis this rank's
    ``H/tp`` and ``Hkv/tp`` heads); segment_ids [B, T] (packing). Every
    head is its own attention, so each route runs on the local heads, but
    for Ulysses where its all-to-all does not split them over the context
    degree while it splits all ``H`` (JAX's check, on the global heads):
    the model line's heads are then gathered, all of them attended on every
    rank of the line, and this rank's taken back."""
    if cfg.cp_impl not in ("xla", "pallas", "ulysses"):
        raise ValueError(f"cp_impl must be 'xla', 'pallas', or 'ulysses', got {cfg.cp_impl!r}")
    cp = context_degree(mesh, tensor_parallel=True)
    if cp > 1:
        if cfg.cp_impl != "pallas":
            if segment_ids is not None:
                raise ValueError(
                    "sequence packing (segment_ids) composes with a context axis only via "
                    "cp_impl='pallas' (the ring kernel carries the global segment table); "
                    "xla/ulysses do not")
            if cfg.sliding_window > 0:
                raise ValueError("sliding_window composes with a context axis only via "
                                 "cp_impl='pallas' (in-kernel band skipping)")
        ring = mesh.ring
        if cfg.cp_impl == "pallas":
            # the ring kernels: GQA-native, KV stays at Hkv width on the ring
            if segment_ids is not None:
                return ring_attention_pallas_seg(q, k, v, segment_ids, ring, causal=True,
                                                 window=cfg.sliding_window)
            return ring_attention_pallas(q, k, v, ring, causal=True, window=cfg.sliding_window)
        n_rep = cfg.n_heads // cfg.n_kv_heads
        if cfg.cp_impl == "ulysses":
            # all-to-all seq↔head reshard; KV stays at Hkv width when the
            # context degree divides it (mha's GQA aliasing then applies)
            if cfg.n_heads % cp:
                raise ValueError(f"cp_impl='ulysses' needs n_heads {cfg.n_heads} divisible by the "
                                 f"context degree {cp} (use 'xla'/'pallas' ring)")
            group = model_group(mesh)
            if group is not None and q.shape[1] % cp:
                # the line's heads whole (the gather's backward sums each
                # rank's gradient into its own block)
                H = q.shape[1]
                q, k, v = (all_gather(t, group, 1) for t in (q, k, v))
                o = _attention(q, k, v, cfg, dataclasses.replace(mesh, shape={**mesh.shape, AXIS_MODEL: 1}))
                m = mesh.axis_index(AXIS_MODEL)
                return o[:, m * H:(m + 1) * H]
            if k.shape[1] % cp:
                k, v = attn_ops.repeat_kv(k, n_rep), attn_ops.repeat_kv(v, n_rep)
            return ulysses_attention(q, k, v, ring=ring, attn_fn=partial(
                attn_ops.mha, causal=True, impl=cfg.attn_impl))
        return ring_attention(q, attn_ops.repeat_kv(k, n_rep), attn_ops.repeat_kv(v, n_rep),
                              ring=ring, causal=True)
    return attn_ops.mha(q, k, v, causal=True, impl=cfg.attn_impl, segment_ids=segment_ids,
                        window=cfg.sliding_window)


def mask_packed_targets(tokens: torch.Tensor, seg: torch.Tensor | None):
    """Next-token pairs stay within one segment and segment 0 (padding)
    never contributes loss. Returns (targets [B, T], seg_in [B, T] or None)."""
    targets = tokens[:, 1:]
    if seg is None:
        return targets, None
    ok = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] != 0)
    return torch.where(ok, targets, torch.full_like(targets, -100)), seg[:, :-1]


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """Embedding rows for ``tokens`` from the (fsdp-gathered) table. On a
    model axis ``embed`` is this rank's ``V/tp`` rows: each rank takes the
    rows it holds, zeros elsewhere, and the line sums them
    (``reduce_from_model``), so every rank has each token's row exactly.
    On a mesh with two or more axes above 1 JAX takes a one-hot product
    instead, a GSPMD layout device whose value is the take's exactly; eager
    torch has no layout to serve, so the port takes."""
    context_degree(mesh, tensor_parallel=True)
    group = model_group(mesh)
    if group is None:
        return embed[tokens.long()]
    return reduce_from_model(vocab_rows(embed, tokens, mesh.axis_index(AXIS_MODEL) * embed.shape[0]), group)


def vocab_rows(embed: torch.Tensor, tokens: torch.Tensor, start: int) -> torch.Tensor:
    """The rows of ``tokens`` in ``embed``, the vocabulary's block from row
    ``start``; zeros for the tokens it does not hold."""
    local = tokens.long() - start
    own = (local >= 0) & (local < embed.shape[0])
    rows = embed[torch.where(own, local, 0)]
    return torch.where(own[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))


def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """[B, T] per-segment positions (0-based, restarting at each segment
    boundary) for RoPE on packed batches."""
    B, T = segment_ids.shape
    idx = torch.arange(T, device=segment_ids.device).expand(B, T)
    is_start = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=segment_ids.device),
                          segment_ids[:, 1:] != segment_ids[:, :-1]], dim=1)
    start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    return idx - start


def attention_residual(x, lp: dict, cos, sin, cfg: LlamaConfig, mesh, segment_ids=None, positions=None):
    """x plus its pre-norm GQA attention on this rank's heads (all of them
    without a model axis): Megatron's column-parallel ``wq|wk|wv`` and
    row-parallel ``wo``. Llama's and Mixtral's blocks share it."""
    B, T = x.shape[0], x.shape[1]
    Dh = cfg.head_dim
    group = model_group(mesh)
    h = copy_to_model(L.rms_norm(x, lp["attn_norm"], cfg.norm_eps), group)
    q = (h @ lp["wq"]).reshape(B, T, -1, Dh).transpose(1, 2)
    k = (h @ lp["wk"]).reshape(B, T, -1, Dh).transpose(1, 2)
    v = (h @ lp["wv"]).reshape(B, T, -1, Dh).transpose(1, 2)
    q = L.apply_rope(q, cos, sin, positions=positions)
    k = L.apply_rope(k, cos, sin, positions=positions)
    o = _attention(q, k, v, cfg, mesh, segment_ids=segment_ids)
    o = o.transpose(1, 2).reshape(B, T, -1)
    return x + reduce_from_model(o @ lp["wo"], group)


def _block(x, lp: dict, cos, sin, cfg: LlamaConfig, mesh, segment_ids=None, positions=None):
    """One decoder block (pre-norm attention + SwiGLU) on this rank's heads
    and FFN columns (all of them without a model axis)."""
    group = model_group(mesh)
    x = attention_residual(x, lp, cos, sin, cfg, mesh, segment_ids=segment_ids, positions=positions)
    h = copy_to_model(L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps), group)
    return x + reduce_from_model(L.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]), group)


def context_inputs(tokens: torch.Tensor, mesh, segment_ids=None):
    """This process's window of whole rows (``context_window``): (tokens,
    segment ids, RoPE positions), the positions global along the row —
    per segment from the whole row's ids when packed, ``lo…hi`` for a
    window that does not start the row, None (``0…T``) for one that is the
    whole row."""
    T = tokens.shape[1]
    lo, hi = context_window(mesh, T)
    if segment_ids is not None:
        return tokens[:, lo:hi], segment_ids[:, lo:hi], segment_positions(segment_ids)[:, lo:hi]
    positions = None if (lo, hi) == (0, T) else torch.arange(lo, hi, device=tokens.device)
    return tokens[:, lo:hi], None, positions


def hidden_states(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, mesh=None,
                  segment_ids=None) -> torch.Tensor:
    """tokens [B, T] → final-norm hidden states [B, T_w, D] of this
    process's window of the rows (all T but in a context gang).
    ``segment_ids`` [B, T] confines attention within packed segments and
    restarts RoPE positions at every boundary."""
    T = tokens.shape[1]
    check_model_axis(cfg, axis_size(mesh, AXIS_MODEL), mesh)
    cos, sin = L.rope_frequencies(cfg.head_dim, T, cfg.rope_theta, cfg.rope_scaling,
                                  device=tokens.device)
    tokens, segment_ids, positions = context_inputs(tokens, mesh, segment_ids)
    rules = sharding_rules(cfg)
    x = embed_lookup(gather(params["embed"], rules.spec_for("embed"), mesh), tokens, mesh)
    block_fn = attn_ops.remat_block(
        gathering(partial(_block, cos=cos, sin=sin, cfg=cfg, mesh=mesh, segment_ids=segment_ids,
                          positions=positions), rules, mesh),
        cfg.remat, cfg.remat_policy,
    )
    per_layer = {name: w.unbind(0) for name, w in params["layers"].items()}
    for i in range(cfg.n_layers):
        x = block_fn(x, {name: ws[i] for name, ws in per_layer.items()})
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, mesh=None,
            segment_ids=None) -> torch.Tensor:
    """tokens [B, T] → logits [B, T_w, V] of this process's window (on a
    model axis this rank's ``V/tp`` columns of them)."""
    x = hidden_states(params, tokens, cfg, mesh, segment_ids=segment_ids)
    return copy_to_model(x, model_group(mesh)) @ lm_head(params, cfg, mesh)


def lm_head(params: dict, cfg: LlamaConfig, mesh=None) -> torch.Tensor:
    """The head gathered on an fsdp axis: whole, or this rank's ``V/tp``
    columns on a model axis."""
    return gather(params["lm_head"], sharding_rules(cfg).spec_for("lm_head"), mesh)


def loss_fn(params: dict, batch: dict, cfg: LlamaConfig, mesh=None) -> tuple[torch.Tensor, dict]:
    """batch: {"tokens": [B, T+1], optional "segment_ids": [B, T+1]} →
    (next-token CE loss, {"loss", "tokens"}). ``cfg.ce_chunk > 0`` fuses the
    lm head and CE per chunk so the [B, T, V] logits never exist. On a
    model axis the CE is vocab-parallel, and every rank of a model line
    gets the same loss and count. In a context gang the loss and count are
    over this process's window of the targets (the trainer weighs the
    ranks by their counts)."""
    tokens = batch["tokens"]
    targets, seg_in = mask_packed_targets(tokens, batch.get("segment_ids"))
    lo, hi = context_window(mesh, targets.shape[1])
    targets = targets[:, lo:hi]
    group = model_group(mesh)
    if cfg.ce_chunk > 0:
        x = copy_to_model(hidden_states(params, tokens[:, :-1], cfg, mesh, segment_ids=seg_in), group)
        loss, n = L.chunked_cross_entropy_loss(x, lm_head(params, cfg, mesh), targets, chunk=cfg.ce_chunk,
                                               group=group)
    else:
        logits = forward(params, tokens[:, :-1], cfg, mesh, segment_ids=seg_in)
        loss, n = L.cross_entropy_loss(logits, targets, group=group)
    return loss, {"loss": loss, "tokens": n}


def flat_value_and_grad(loss_fn, params: dict, batch: dict, cfg, mesh) -> tuple[torch.Tensor, dict, dict]:
    """``(loss, metrics, grads)`` of ``loss_fn`` on this rank's batch, the
    grads mirroring ``params`` (``pp_value_and_grad`` without stages)."""
    loss, metrics = loss_fn(params, batch, cfg, mesh)

    def leaves(tree):
        return [x for v in tree.values() for x in (leaves(v) if isinstance(v, dict) else [v])]

    grads = iter(torch.autograd.grad(loss, leaves(params)))

    def like(tree):
        return {k: like(v) if isinstance(v, dict) else next(grads) for k, v in tree.items()}

    return loss.detach(), metrics, like(params)


def pp_value_and_grad(params: dict, batch: dict, cfg: LlamaConfig, mesh, num_microbatches: int = 2,
                      wire_dtype: torch.dtype = torch.bfloat16) -> tuple[torch.Tensor, dict, dict]:
    """1F1B pipeline train-step core (JAX's ``pp_value_and_grad``, its 1F1B
    branch): ``(loss, {"loss", "tokens"}, grads)``, the grads mirroring this
    rank's ``params`` (its stage's part of the tree) and the whole step's:
    the gang's token mean over the global batch. ``batch``: this rank's rows
    of each microbatch (its data × fsdp shard of them, ``pipeline.microbatch_rows``).
    Packed batches (segment ids) apply per microbatch: confinement,
    per-segment RoPE and boundary target masking. A stage axis of 1 runs the
    flat loss and its gradients, as JAX's."""
    if axis_size(mesh, AXIS_STAGE) <= 1:
        return flat_value_and_grad(loss_fn, params, batch, cfg, mesh)
    check_stage_layout(mesh.shape)
    tokens = batch["tokens"]
    B, T = tokens.shape[0], tokens.shape[1] - 1
    cos, sin = L.rope_frequencies(cfg.head_dim, T, cfg.rope_theta, cfg.rope_scaling, device=tokens.device)
    rules = sharding_rules(cfg)

    def stage_fn(stage_lp, h, mb):
        seg_in, positions = stage_inputs(mb)
        block_fn = attn_ops.remat_block(
            gathering(partial(_block, cos=cos, sin=sin, cfg=cfg, mesh=None, segment_ids=seg_in,
                              positions=positions), rules, mesh),
            cfg.remat, cfg.remat_policy)
        return run_layers(block_fn, stage_lp, h)

    nll, ntok, _, grads = pipeline.pp_step(
        params, batch, rules=rules, mesh=mesh, num_microbatches=num_microbatches,
        act_shape=(B // num_microbatches, T, cfg.d_model), compute_dtype=cfg.tdtype, wire_dtype=wire_dtype,
        stage_fn=stage_fn, embed_fn=partial(pp_embed, rules=rules, mesh=mesh),
        loss_head_fn=partial(pp_loss_head, cfg=cfg, rules=rules, mesh=mesh))
    loss = nll / ntok.clamp_min(1.0)
    return loss, {"loss": loss, "tokens": ntok}, grads


def stage_inputs(mb: dict):
    """A microbatch's (input segment ids, RoPE positions): None, None unpacked."""
    seg = mb.get("segment_ids")
    seg_in = seg[:, :-1] if seg is not None else None
    return seg_in, segment_positions(seg_in) if seg_in is not None else None


def run_layers(block_fn, stacked: dict, h):
    """``h`` through each layer of ``stacked`` in turn."""
    per_layer = {name: w.unbind(0) for name, w in stacked.items()}
    for i in range(next(iter(stacked.values())).shape[0]):
        h = block_fn(h, {name: ws[i] for name, ws in per_layer.items()})
    return h


def pp_embed(embed: torch.Tensor, mb: dict, rules, mesh) -> torch.Tensor:
    """The first stage's embedding of a microbatch's input tokens (its fsdp
    blocks gathered)."""
    return embed_lookup(gather(embed, rules.spec_for("embed"), mesh), mb["tokens"][:, :-1])


def pp_loss_head(head: dict, y: torch.Tensor, mb: dict, cfg, rules, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """The last stage's head: ``(nll sum, true count)`` of a microbatch's
    targets, the fused CE always (one chunk for ``ce_chunk <= 0``). The count
    is the true one, not the CE's clamp of 1, so an all-pad microbatch adds
    no tokens; ``mean · n`` is the exact sum even then."""
    targets, _ = mask_packed_targets(mb["tokens"], mb.get("segment_ids"))
    x = L.rms_norm(y, head["final_norm"], cfg.norm_eps)
    mean, n = L.chunked_cross_entropy_loss(x, gather(head["lm_head"], rules.spec_for("lm_head"), mesh), targets,
                                           chunk=cfg.ce_chunk)
    return mean * n, (targets != -100).sum()


def synthetic_batch(gen: torch.Generator, batch_size: int, seq_len: int, cfg: LlamaConfig) -> dict:
    """Uniform random tokens [B, T+1] drawn from ``gen`` on its device."""
    return {"tokens": torch.randint(0, cfg.vocab_size, (batch_size, seq_len + 1), generator=gen,
                                    device=gen.device)}


def config_from_dict(d) -> LlamaConfig:
    if isinstance(d, str):
        return PRESETS[d]
    fields = {f.name for f in dataclasses.fields(LlamaConfig)}
    return dataclasses.replace(
        PRESETS.get(d.get("preset", ""), LlamaConfig()),
        **{k: v for k, v in d.items() if k in fields},
    )
