"""Mixtral-style sparse-MoE decoder: config, random init, forward and training loss.

Counterpart of ``tony_tpu/models/mixtral.py``: the Llama backbone
(RMSNorm, RoPE, GQA attention, stacked layers) with the dense FFN replaced
by a top-k-of-E SwiGLU mixture routed per token (``parallel/expert.py``).
The parameter tree is the JAX one: per layer ``router`` [D, E] in f32 and
``we_gate``/``we_up`` [E, D, F], ``we_down`` [E, F, D] in the model dtype,
stacked over layers. Single device only: a mesh raises (a context axis
waits for a later slice); ``sharding_rules`` and ``pp_value_and_grad`` wait for
ROADMAP A8 and A13. The MoE is JAX's default ragged dispatch, so the config
has no ``moe_dispatch`` or ``capacity_factor``; ``config_from_dict`` refuses
a dict that asks for another dispatch (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import torch

from tony_tpu_torch.models import llama as llama_mod
from tony_tpu_torch.ops import attention as attn_ops
from tony_tpu_torch.ops import layers as L
from tony_tpu_torch.parallel.expert import MoEConfig, moe_ffn

_AUX = ("moe_balance_loss", "moe_z_loss", "moe_dropped_frac")


@dataclass(frozen=True)
class MixtralConfig(llama_mod.LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    aux_loss_coef: float = 1e-2   # load-balance loss weight
    router_z_coef: float = 1e-3   # router z-loss weight

    @property
    def moe(self) -> MoEConfig:
        return MoEConfig(self.num_experts, self.top_k, router_z_coef=self.router_z_coef,
                         aux_loss_coef=self.aux_loss_coef)

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


def init(gen: torch.Generator, cfg: MixtralConfig, device: torch.device | str) -> dict:
    """Random parameter tree: the Llama init for the backbone, the router in
    f32 and the experts drawn one [D, F] slab at a time (truncated normal in
    [-2, 2] · fan_in^-0.5), so the f32 temporaries stay one slab's size.
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

    base = llama_mod.init(gen, dataclasses.replace(cfg, d_ff=1), device)  # no dense FFN to draw
    layers = {k: v for k, v in base["layers"].items() if k not in ("w_gate", "w_up", "w_down")}
    layers.update(
        router=draw((Lyr, D, E), D, torch.float32),
        we_gate=experts(D, F, D),
        we_up=experts(D, F, D),
        we_down=experts(F, D, F),
    )
    base["layers"] = layers
    return base


def _layer(x, lp: dict, cos, sin, cfg: MixtralConfig, mesh, segment_ids=None, positions=None,
           token_mask=None):
    """One Mixtral decoder layer (pre-norm GQA attention + MoE FFN) →
    (x, moe_balance_loss, moe_z_loss, moe_dropped_frac)."""
    B, T = x.shape[0], x.shape[1]
    Dh, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, T, H, Dh).transpose(1, 2)
    k = (h @ lp["wk"]).reshape(B, T, Hkv, Dh).transpose(1, 2)
    v = (h @ lp["wv"]).reshape(B, T, Hkv, Dh).transpose(1, 2)
    q = L.apply_rope(q, cos, sin, positions=positions)
    k = L.apply_rope(k, cos, sin, positions=positions)
    o = llama_mod._attention(q, k, v, cfg, mesh, segment_ids=segment_ids)
    x = x + o.transpose(1, 2).reshape(B, T, H * Dh) @ lp["wo"]
    h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    y, aux = moe_ffn(h, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"], cfg.moe,
                     mesh, token_mask=token_mask)
    return (x + y, *(aux[k] for k in _AUX))


def hidden_states(params: dict, tokens: torch.Tensor, cfg: MixtralConfig, mesh=None,
                  segment_ids=None) -> tuple[torch.Tensor, dict]:
    """tokens [B, T] → (final-norm hidden states [B, T, D], moe aux losses:
    balance and z summed over layers, dropped fraction averaged).
    ``segment_ids`` [B, T] (packed sequences): segment-confined attention,
    per-segment RoPE positions, and padding (segment 0) routed with zero
    gates and left out of the router losses."""
    if mesh is not None:
        raise NotImplementedError(
            "Mixtral under a device mesh is not ported yet (a context axis: ROADMAP queue A12, "
            "Mixtral CP; FSDP/TP/expert axes: A8, A11); the port trains it on one device")
    T = tokens.shape[1]
    cos, sin = L.rope_frequencies(cfg.head_dim, T, cfg.rope_theta, cfg.rope_scaling,
                                  device=tokens.device)
    positions = llama_mod.segment_positions(segment_ids) if segment_ids is not None else None
    token_mask = (segment_ids != 0) if segment_ids is not None else None
    x = llama_mod.embed_lookup(params["embed"], tokens, mesh)
    block_fn = attn_ops.remat_block(
        partial(_layer, cos=cos, sin=sin, cfg=cfg, mesh=mesh, segment_ids=segment_ids,
                positions=positions, token_mask=token_mask),
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
            segment_ids=None) -> tuple[torch.Tensor, dict]:
    """tokens [B, T] → (logits [B, T, V], moe aux losses)."""
    x, aux = hidden_states(params, tokens, cfg, mesh, segment_ids=segment_ids)
    return x @ params["lm_head"], aux


def loss_fn(params: dict, batch: dict, cfg: MixtralConfig, mesh=None) -> tuple[torch.Tensor, dict]:
    """batch: {"tokens": [B, T+1], optional "segment_ids"} → (ce + balance +
    z loss, {"loss", "ce_loss", "tokens", moe aux}). ``cfg.ce_chunk > 0``
    fuses the lm head and CE per chunk so the [B, T, V] logits never exist."""
    tokens = batch["tokens"]
    targets, seg_in = llama_mod.mask_packed_targets(tokens, batch.get("segment_ids"))
    if cfg.ce_chunk > 0:
        x, aux = hidden_states(params, tokens[:, :-1], cfg, mesh, segment_ids=seg_in)
        ce, n = L.chunked_cross_entropy_loss(x, params["lm_head"], targets, chunk=cfg.ce_chunk)
    else:
        logits, aux = forward(params, tokens[:, :-1], cfg, mesh, segment_ids=seg_in)
        ce, n = L.cross_entropy_loss(logits, targets)
    loss = ce + aux["moe_balance_loss"] + aux["moe_z_loss"]
    return loss, {"loss": loss, "ce_loss": ce, "tokens": n, **aux}


synthetic_batch = llama_mod.synthetic_batch


def config_from_dict(d) -> MixtralConfig:
    if isinstance(d, str):
        return PRESETS[d]
    if d.get("moe_dispatch", "ragged") != "ragged":
        raise NotImplementedError(
            f"MoE dispatch {d['moe_dispatch']!r} is not ported yet (ROADMAP queue A11); "
            "the port runs the ragged dispatch")
    fields = {f.name for f in dataclasses.fields(MixtralConfig)}
    return dataclasses.replace(
        PRESETS.get(d.get("preset", ""), MixtralConfig()),
        **{k: v for k, v in d.items() if k in fields},
    )
