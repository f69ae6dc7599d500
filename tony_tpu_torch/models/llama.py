"""Llama-family decoder: config, random init, forward and training loss.

Counterpart of ``tony_tpu/models/llama.py``: the same ``LlamaConfig``
fields, the same presets and the same parameter tree — a nested dict with
stacked layers (leading dim L on every block weight), weights ``[K, N]``
used as ``x @ w``. The layer scan is a Python loop over the stacked dim
(each stacked weight is unbound once per forward, so its gradient is
stacked once in the backward). A mesh may carry a context axis
(``parallel/mesh.py``): with the JAX package's single-process semantics the
model runs on whole ``[B, T, ...]`` tensors and only attention splits T
into the mesh ring's shards (``cp_impl``: "xla" ring, "pallas" ring
kernels, "ulysses"). FSDP/TP (A8) and pipeline stages (A13) raise until
they are ported.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import torch

from tony_tpu_torch.ops import attention as attn_ops
from tony_tpu_torch.ops import layers as L
from tony_tpu_torch.ops.ring import ring_attention_pallas, ring_attention_pallas_seg
from tony_tpu_torch.parallel.context import ring_attention, ulysses_attention
from tony_tpu_torch.parallel.mesh import context_degree


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


def init(gen: torch.Generator, cfg: LlamaConfig, device: torch.device | str) -> dict:
    """Random parameter tree (truncated normal in [-2, 2] · fan_in^-0.5),
    drawn on ``device`` from ``gen`` (a generator on that device). Stacked
    weights are drawn one layer at a time so the f32 temporaries stay one
    layer's size at full width. Its bits differ from the JAX init."""
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
        "embed": dense(V, D, fan_in=1.0),
        "layers": {
            "attn_norm": norm_init(Lyr, D),
            "wq": dense(Lyr, D, H * Dh, fan_in=D),
            "wk": dense(Lyr, D, Hkv * Dh, fan_in=D),
            "wv": dense(Lyr, D, Hkv * Dh, fan_in=D),
            "wo": dense(Lyr, H * Dh, D, fan_in=H * Dh),
            "mlp_norm": norm_init(Lyr, D),
            "w_gate": dense(Lyr, D, F, fan_in=D),
            "w_up": dense(Lyr, D, F, fan_in=D),
            "w_down": dense(Lyr, F, D, fan_in=F),
        },
        "final_norm": norm_init(D),
        "lm_head": dense(D, V, fan_in=D),
    }


def _attention(q, k, v, cfg: LlamaConfig, mesh, segment_ids=None) -> torch.Tensor:
    """Dispatch: context-parallel attention (``cfg.cp_impl``: the plain
    PyTorch ring, the ring kernels, or Ulysses' all-to-all) when the mesh's
    context axis is real, else single-device ``mha``.

    q: [B, H, T, Dh]; k/v: [B, Hkv, T, Dh]; segment_ids [B, T] (packing)."""
    if cfg.cp_impl not in ("xla", "pallas", "ulysses"):
        raise ValueError(f"cp_impl must be 'xla', 'pallas', or 'ulysses', got {cfg.cp_impl!r}")
    cp = context_degree(mesh)
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
            if cfg.n_kv_heads % cp:
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
    """Embedding rows for ``tokens``. The JAX function's one-hot product is
    for meshes with two or more active axes; the port's mesh has at most
    the context axis, where JAX keeps the plain take too."""
    context_degree(mesh)
    return embed[tokens.long()]


def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """[B, T] per-segment positions (0-based, restarting at each segment
    boundary) for RoPE on packed batches."""
    B, T = segment_ids.shape
    idx = torch.arange(T, device=segment_ids.device).expand(B, T)
    is_start = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=segment_ids.device),
                          segment_ids[:, 1:] != segment_ids[:, :-1]], dim=1)
    start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    return idx - start


def _block(x, lp: dict, cos, sin, cfg: LlamaConfig, mesh, segment_ids=None, positions=None):
    """One decoder block (pre-norm attention + SwiGLU)."""
    B, T = x.shape[0], x.shape[1]
    Dh, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, T, H, Dh).transpose(1, 2)
    k = (h @ lp["wk"]).reshape(B, T, Hkv, Dh).transpose(1, 2)
    v = (h @ lp["wv"]).reshape(B, T, Hkv, Dh).transpose(1, 2)
    q = L.apply_rope(q, cos, sin, positions=positions)
    k = L.apply_rope(k, cos, sin, positions=positions)
    o = _attention(q, k, v, cfg, mesh, segment_ids=segment_ids)
    o = o.transpose(1, 2).reshape(B, T, H * Dh)
    x = x + o @ lp["wo"]
    h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + L.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


def hidden_states(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, mesh=None,
                  segment_ids=None) -> torch.Tensor:
    """tokens [B, T] → final-norm hidden states [B, T, D]. ``segment_ids``
    [B, T] confines attention within packed segments and restarts RoPE
    positions at every boundary."""
    T = tokens.shape[1]
    cos, sin = L.rope_frequencies(cfg.head_dim, T, cfg.rope_theta, cfg.rope_scaling,
                                  device=tokens.device)
    positions = segment_positions(segment_ids) if segment_ids is not None else None
    x = embed_lookup(params["embed"], tokens, mesh)
    block_fn = attn_ops.remat_block(
        partial(_block, cos=cos, sin=sin, cfg=cfg, mesh=mesh, segment_ids=segment_ids,
                positions=positions),
        cfg.remat, cfg.remat_policy,
    )
    per_layer = {name: w.unbind(0) for name, w in params["layers"].items()}
    for i in range(cfg.n_layers):
        x = block_fn(x, {name: ws[i] for name, ws in per_layer.items()})
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, mesh=None,
            segment_ids=None) -> torch.Tensor:
    """tokens [B, T] → logits [B, T, V]."""
    return hidden_states(params, tokens, cfg, mesh, segment_ids=segment_ids) @ params["lm_head"]


def loss_fn(params: dict, batch: dict, cfg: LlamaConfig, mesh=None) -> tuple[torch.Tensor, dict]:
    """batch: {"tokens": [B, T+1], optional "segment_ids": [B, T+1]} →
    (next-token CE loss, {"loss", "tokens"}). ``cfg.ce_chunk > 0`` fuses the
    lm head and CE per chunk so the [B, T, V] logits never exist."""
    tokens = batch["tokens"]
    targets, seg_in = mask_packed_targets(tokens, batch.get("segment_ids"))
    if cfg.ce_chunk > 0:
        x = hidden_states(params, tokens[:, :-1], cfg, mesh, segment_ids=seg_in)
        loss, n = L.chunked_cross_entropy_loss(x, params["lm_head"], targets, chunk=cfg.ce_chunk)
    else:
        logits = forward(params, tokens[:, :-1], cfg, mesh, segment_ids=seg_in)
        loss, n = L.cross_entropy_loss(logits, targets)
    return loss, {"loss": loss, "tokens": n}


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
