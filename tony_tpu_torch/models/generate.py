"""Autoregressive generation with a KV cache for the Llama family (Mixtral included).

Counterpart of ``tony_tpu/models/generate.py``. The cache is a static
``[L, B, Hkv, max_len, Dh]`` pair of tensors written IN PLACE (the JAX
functions return updated copies; here the write saves a cache-sized copy per
call). Prefill attention (``_cached_attention``) is plain tensor code, as it
is plain XLA in the JAX package; decode attention over per-slot caches
(``_masked_slot_attention``) is the plain masked path the serving engine's
bucketed mode shares. ``QTensor`` weights dispatch to the int8 kernel
through ``_mm``. Randomness comes from an explicit ``torch.Generator``
(its draws differ from ``jax.random``'s; greedy decoding does not draw).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tony_tpu_torch.models.llama import LlamaConfig
from tony_tpu_torch.ops import layers as L
from tony_tpu_torch.ops import quant as Q
from tony_tpu_torch.parallel.expert import _gating, moe_ffn


def _mm(x, w):
    """x @ w where w may be an int8 QTensor (weight-only quantized serving)."""
    if isinstance(w, Q.QTensor):
        return Q.int8_matmul(x, w).to(x.dtype)
    return x @ w


def _embed_lookup(embed, tokens, dtype):
    if isinstance(embed, Q.QTensor):
        rows = embed.q[tokens].float()
        return (rows * embed.scale).to(dtype)
    return embed[tokens]


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked layer tree (QTensor leaves too)."""
    return {
        k: Q.QTensor(v.q[i], v.scale[i]) if isinstance(v, Q.QTensor) else v[i]
        for k, v in layers.items()
    }


@dataclass
class KVCache:
    """Static-shape decode state. k/v: [L, B, Hkv, max_len, Dh]; ``length``:
    tokens already in the cache (a host int)."""

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, device) -> KVCache:
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.tdtype, device=device),
        v=torch.zeros(shape, dtype=cfg.tdtype, device=device),
    )


def _cached_attention(q, ck, cv, length: int, n_rep: int, window: int = 0):
    """q [B, H, Tq, Dh]; ck/cv [B, Hkv, maxT, Dh] already holding the new
    tokens at [length, length+Tq). Row i attends positions <= length+i (and
    > length+i-window when windowed). Scores and softmax in f32; p @ V in
    the cache dtype, as the JAX function does."""
    B, H, Tq, Dh = q.shape
    Hkv, maxT = ck.shape[1], ck.shape[2]
    qg = q.float().reshape(B, Hkv, n_rep * Tq, Dh)
    s = (qg @ ck.float().transpose(-1, -2)).reshape(B, Hkv, n_rep, Tq, maxT) * (Dh ** -0.5)
    slot = torch.arange(maxT, device=q.device)[None, :]
    row_end = length + torch.arange(Tq, device=q.device)[:, None]
    ok = slot <= row_end
    if window > 0:
        ok = ok & (slot > row_end - window)
    s = s.masked_fill(~ok, -1e30)
    p = torch.softmax(s, dim=-1).to(cv.dtype).reshape(B, Hkv, n_rep * Tq, maxT)
    return (p @ cv).reshape(B, H, Tq, Dh)


def _masked_slot_attention(q1, ck, cv, lengths, n_rep: int, window: int = 0, *, cur_k, cur_v):
    """Single-token decode attention over read-only per-slot caches.

    q1 [S, H, Dh] vs ck/cv [S, Hkv, maxT, Dh]; ``lengths`` [S] counts cache
    positions only; the current token's K/V (``cur_k``/``cur_v`` [S, Hkv, Dh])
    are appended as the self term. Slot s attends [max(0, len+1-window), len)
    plus itself."""
    S, H, Dh = q1.shape
    Hkv, maxT = ck.shape[1], ck.shape[2]
    qf = q1.float().reshape(S, Hkv, n_rep, Dh)
    s = torch.einsum("sgrd,sgtd->sgrt", qf, ck.float()) * (Dh ** -0.5)
    idx = torch.arange(maxT, device=q1.device)[None, :]
    hi = lengths.to(torch.int64)[:, None]
    ok = idx < hi
    if window > 0:
        ok = ok & (idx >= hi + 1 - window)
    s = s.masked_fill(~ok[:, None, None, :], -1e30)
    s_self = torch.einsum("sgrd,sgd->sgr", qf, cur_k.float())[..., None] * (Dh ** -0.5)
    p = torch.softmax(torch.cat([s, s_self], dim=-1), dim=-1)
    o = torch.einsum("sgrt,sgtd->sgrd", p[..., :maxT].to(cv.dtype), cv)
    o = o + p[..., maxT:].to(cur_v.dtype) * cur_v[:, :, None, :]
    return o.reshape(S, H, Dh)


def _ffn_with_cache(h, lp, cfg: LlamaConfig):
    """Dense SwiGLU FFN, or the MoE mixture when the layer carries a router
    (Mixtral family). More than 16 new tokens (prefill) route through the
    training dispatch ``moe_ffn`` (the B7 kernel on the card); fewer
    (decode) compute every expert with plain products and combine them with
    the top-k gates of the same ``_gating``, as the JAX function does."""
    if "router" not in lp:
        g = torch.nn.functional.silu(_mm(h, lp["w_gate"]))
        u = _mm(h, lp["w_up"])
        return _mm(g * u, lp["w_down"])
    if h.shape[1] > 16:
        y, _ = moe_ffn(h, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"], cfg.moe, None)
        return y
    B, T, D = h.shape
    E = lp["router"].shape[-1]
    gate_vals, gate_idx, _, _ = _gating(h, lp["router"], cfg.moe, None)
    w = (torch.nn.functional.one_hot(gate_idx, E).float() * gate_vals[..., None]).sum(dim=-2)
    # batched products over the experts ([E, B·T, ·]): torch.einsum would
    # first copy each [E, D, F] weight into a [D, E·F] operand
    x = h.reshape(B * T, D)
    g = torch.nn.functional.silu(torch.matmul(x, lp["we_gate"]))
    ye = torch.matmul(g * torch.matmul(x, lp["we_up"]), lp["we_down"])
    return torch.einsum("end,ne->nd", ye, w.reshape(B * T, E).to(ye.dtype)).reshape(B, T, D)


def _block_with_cache(x, lp, ck, cv, length: int, cos, sin, cfg: LlamaConfig):
    """One decoder block over Tq new tokens at positions [length, length+Tq);
    writes their K/V into ``ck``/``cv`` ([B, Hkv, maxT, Dh] views) in place."""
    B, Tq = x.shape[0], x.shape[1]
    Dh, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    positions = length + torch.arange(Tq, device=x.device)

    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = _mm(h, lp["wq"]).reshape(B, Tq, H, Dh).transpose(1, 2)
    k = _mm(h, lp["wk"]).reshape(B, Tq, Hkv, Dh).transpose(1, 2)
    v = _mm(h, lp["wv"]).reshape(B, Tq, Hkv, Dh).transpose(1, 2)
    q = L.apply_rope(q, cos, sin, positions=positions)
    k = L.apply_rope(k, cos, sin, positions=positions)
    if Tq == 1:
        o = _masked_slot_attention(
            q[:, :, 0], ck, cv, torch.full((B,), length, device=x.device), H // Hkv,
            window=cfg.sliding_window,
            cur_k=k[:, :, 0].to(ck.dtype), cur_v=v[:, :, 0].to(cv.dtype),
        )[:, :, None]
        ck[:, :, length] = k[:, :, 0].to(ck.dtype)
        cv[:, :, length] = v[:, :, 0].to(cv.dtype)
    else:
        ck[:, :, length:length + Tq] = k.to(ck.dtype)
        cv[:, :, length:length + Tq] = v.to(cv.dtype)
        o = _cached_attention(q, ck, cv, length, H // Hkv, window=cfg.sliding_window)
    o = o.transpose(1, 2).reshape(B, Tq, H * Dh)
    x = x + _mm(o, lp["wo"])
    h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + _ffn_with_cache(h, lp, cfg)


def _forward_with_cache(params, tokens, cache: KVCache, cfg: LlamaConfig):
    """tokens [B, Tq] (new tokens only) → (logits [B, Tq, V] f32, cache')."""
    maxT = cache.k.shape[3]
    if cache.length + tokens.shape[1] > maxT:
        raise ValueError(f"cache holds {maxT} positions; {cache.length} + {tokens.shape[1]} overflows")
    cos, sin = L.rope_frequencies(cfg.head_dim, maxT, cfg.rope_theta, cfg.rope_scaling,
                                  device=tokens.device)
    x = _embed_lookup(params["embed"], tokens, cfg.tdtype)
    for i in range(cfg.n_layers):
        x = _block_with_cache(x, layer_params(params["layers"], i), cache.k[i], cache.v[i],
                              cache.length, cos, sin, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _mm(x, params["lm_head"]).float()
    return logits, KVCache(cache.k, cache.v, cache.length + tokens.shape[1])


def prefill(params, tokens, cache: KVCache, cfg: LlamaConfig):
    """Run the prompt, filling the cache: (last-position logits [B, V], cache')."""
    logits, cache = _forward_with_cache(params, tokens, cache, cfg)
    return logits[:, -1], cache


def _sample(logits, gen: torch.Generator | None, temperature: float, top_k: int):
    if temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, -1e30)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def sample_keep(logits, temperature, top_k, top_p):
    """Per-row (scaled logits, keep mask) of ``sample_logits``: top-k then
    nucleus over ONE descending sort; top_k <= 0 and top_p outside (0, 1)
    disable their cut."""
    V = logits.shape[-1]
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = (top_k.to(torch.int64) - 1).clamp(0, V - 1)
    kth = desc.gather(1, k_idx[:, None])
    keep_k = (top_k[:, None] <= 0) | (scaled >= kth)
    probs = torch.softmax(desc, dim=-1)
    cum = probs.cumsum(dim=-1)
    p = top_p[:, None]
    nucleus = (cum - probs) < p
    last_rank = (nucleus.sum(dim=-1) - 1).clamp_min(0)
    pth = desc.gather(1, last_rank[:, None])
    keep_p = (p <= 0) | (p >= 1) | (scaled >= pth)
    return scaled, keep_k & keep_p


def sample_logits(logits, gen: torch.Generator | None, temperature, top_k, top_p):
    """Per-row sampling; temperature/top_k/top_p are [B] tensors. Row
    temperature 0 → greedy (argmax)."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    scaled, keep = sample_keep(logits, temperature, top_k, top_p)
    masked = scaled.masked_fill(~keep, -1e30)
    sampled = torch.multinomial(torch.softmax(masked, dim=-1), 1, generator=gen)[:, 0].to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, sampled)


@torch.inference_mode()
def generate(
    params, prompt: torch.Tensor, cfg: LlamaConfig, *, max_new_tokens: int,
    temperature: float = 0.0, top_k: int = 0, generator: torch.Generator | None = None,
    max_len: int | None = None,
) -> torch.Tensor:
    """prompt [B, Tp] → generated tokens [B, max_new_tokens] (greedy when
    temperature == 0, else top-k/temperature sampling)."""
    B, Tp = prompt.shape
    max_len = max_len or (Tp + max_new_tokens)
    if max_len < Tp + max_new_tokens:
        raise ValueError("cache too small for requested tokens")
    cache = init_cache(cfg, B, max_len, prompt.device)
    logits, cache = prefill(params, prompt, cache, cfg)
    tok = _sample(logits, generator, temperature, top_k)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = _forward_with_cache(params, tok[:, None].long(), cache, cfg)
        tok = _sample(logits[:, -1], generator, temperature, top_k)
        out.append(tok)
    return torch.stack(out, dim=1)
