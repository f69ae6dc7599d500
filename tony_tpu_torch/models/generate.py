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

Tensor-parallel serving holds a model's ``tp`` shards in one process
(``ModelShards``, as JAX's engine holds a model-axis mesh's devices):
shard s has its ``H/tp`` query heads, ``Hkv/tp`` kv heads and ``F/tp`` FFN
columns, ``V/tp`` embedding rows and head columns (the training rules'
blocks), on its own device, and a cache (``KVCache``, the serving
engine's ``SlotCache``) then holds one k/v tensor of ``Hkv/tp`` heads a
shard (lists). Each shard computes its heads and columns from a copy of
the normed residual stream (``DeviceModel.copy_to_model``), the
row-parallel partials are summed on the first device
(``reduce_from_model``), the embedding sums the shards' masked takes, and
the head's logits are joined whole before sampling, so the host loop and
the samplers never see the shards. A plain tree is one shard. A Mixtral
shard holds ``F/tp`` columns of every expert and the whole router:
``_ffn_with_cache`` runs on it as on a whole tree, and its output is a
partial of the mixture, summed as the dense FFN's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tony_tpu_torch.models.llama import LlamaConfig, vocab_rows
from tony_tpu_torch.ops import layers as L
from tony_tpu_torch.ops import quant as Q
from tony_tpu_torch.parallel.collectives import DeviceModel
from tony_tpu_torch.parallel.expert import _gating, moe_ffn
from tony_tpu_torch.parallel.sharding import ShardingRules, model_shards


@dataclass
class ModelShards:
    """A model's shards of a model axis held in one process: ``trees[s]``
    (shard s's blocks, on ``axis.devices[s]``)."""

    trees: list[dict]
    axis: DeviceModel

    @classmethod
    def place(cls, params: dict, rules: ShardingRules, devices) -> "ModelShards":
        """``params`` (a whole tree) cut by ``rules``' model entries into
        ``len(devices)`` shards, shard s copied to ``devices[s]``. Each
        block is made contiguous here, once: a block that splits an inner
        dim (an expert's F columns) is a strided view, which ``.to`` keeps
        on its own device, and B7 takes contiguous blocks."""
        axis = DeviceModel(devices)
        trees = model_shards(params, rules, axis.n)
        return cls([_to(tree, d) for tree, d in zip(trees, axis.devices)], axis)


def _to(tree: dict, device) -> dict:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device).contiguous() for k, v in tree.items()}


def params_device(params) -> torch.device:
    """The device of a tree's leaves (a ``ModelShards``: its first shard's)."""
    if isinstance(params, ModelShards):
        return params.axis.devices[0]
    e = params["embed"]
    return (e.q if hasattr(e, "q") else e).device


def _shards(params) -> tuple[list[dict], DeviceModel]:
    """(the shards' trees, their axis): a plain tree is one shard."""
    if isinstance(params, ModelShards):
        return params.trees, params.axis
    return [params], DeviceModel([params_device(params)])


def each(t) -> list:
    """A cache's per-shard k (or v) tensors: the list, or the one tensor."""
    return t if isinstance(t, list) else [t]


def embed_shards(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Embedding rows of ``tokens`` on the first device: each shard takes
    the rows it holds (zeros elsewhere), summed exactly."""
    trees, axis = _shards(params)
    if axis.n == 1:
        return _embed_lookup(trees[0]["embed"], tokens, dtype)
    return axis.reduce_from_model([vocab_rows(t["embed"], tokens.to(d), s * t["embed"].shape[0])
                                   for s, (t, d) in enumerate(zip(trees, axis.devices))])


def head_logits(params, x: torch.Tensor) -> torch.Tensor:
    """f32 logits over the whole vocabulary: each shard's columns, joined."""
    trees, axis = _shards(params)
    return axis.join([_mm(xs, t["lm_head"]).float() for xs, t in zip(axis.copy_to_model(x), trees)])


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


def cache_tensors(cfg: LlamaConfig, batch: int, max_len: int, device) -> tuple:
    """Zeroed k and v ``[L, batch, Hkv, max_len, Dh]`` on ``device``, or on
    each of a list of shard devices (lists of ``Hkv/tp`` heads each)."""
    def zeros(d, heads):
        return torch.zeros((cfg.n_layers, batch, heads, max_len, cfg.head_dim), dtype=cfg.tdtype, device=d)

    if not isinstance(device, (list, tuple)):
        return zeros(device, cfg.n_kv_heads), zeros(device, cfg.n_kv_heads)
    heads = cfg.n_kv_heads // len(device)
    return [zeros(d, heads) for d in device], [zeros(d, heads) for d in device]


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, device) -> KVCache:
    return KVCache(*cache_tensors(cfg, batch, max_len, device))


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


def _attn_with_cache(h, lp, ck, cv, length: int, rope, cfg: LlamaConfig):
    """One shard's attention over Tq new tokens at positions [length,
    length+Tq) (its heads: all of them for a plain tree), writing their K/V
    into ``ck``/``cv`` ([B, Hkv, maxT, Dh] views) in place; returns its
    output projection (a row-parallel partial under tp)."""
    B, Tq = h.shape[0], h.shape[1]
    Dh = cfg.head_dim
    cos, sin = rope
    positions = length + torch.arange(Tq, device=h.device)
    q = _mm(h, lp["wq"]).reshape(B, Tq, -1, Dh).transpose(1, 2)
    k = _mm(h, lp["wk"]).reshape(B, Tq, -1, Dh).transpose(1, 2)
    v = _mm(h, lp["wv"]).reshape(B, Tq, -1, Dh).transpose(1, 2)
    q = L.apply_rope(q, cos, sin, positions=positions)
    k = L.apply_rope(k, cos, sin, positions=positions)
    n_rep = q.shape[1] // k.shape[1]
    if Tq == 1:
        o = _masked_slot_attention(
            q[:, :, 0], ck, cv, torch.full((B,), length, device=h.device), n_rep,
            window=cfg.sliding_window,
            cur_k=k[:, :, 0].to(ck.dtype), cur_v=v[:, :, 0].to(cv.dtype),
        )[:, :, None]
        ck[:, :, length] = k[:, :, 0].to(ck.dtype)
        cv[:, :, length] = v[:, :, 0].to(cv.dtype)
    else:
        ck[:, :, length:length + Tq] = k.to(ck.dtype)
        cv[:, :, length:length + Tq] = v.to(cv.dtype)
        o = _cached_attention(q, ck, cv, length, n_rep, window=cfg.sliding_window)
    return _mm(o.transpose(1, 2).reshape(B, Tq, -1), lp["wo"])


def _block_with_cache(x, lps: list[dict], cks: list, cvs: list, length: int, ropes: list, cfg: LlamaConfig,
                      axis: DeviceModel):
    """One decoder block over Tq new tokens on every shard (``lps``: each
    shard's layer params, ``cks``/``cvs`` its cache views, ``ropes`` the cos
    and sin tables on its device); the partials are summed on ``x``'s
    device."""
    h = L.rms_norm(x, lps[0]["attn_norm"], cfg.norm_eps)
    x = x + axis.reduce_from_model([_attn_with_cache(hs, lp, ck, cv, length, rope, cfg) for hs, lp, ck, cv, rope
                                    in zip(axis.copy_to_model(h), lps, cks, cvs, ropes)])
    h = L.rms_norm(x, lps[0]["mlp_norm"], cfg.norm_eps)
    return x + axis.reduce_from_model([_ffn_with_cache(hs, lp, cfg) for hs, lp in zip(axis.copy_to_model(h), lps)])


def _forward_with_cache(params, tokens, cache: KVCache, cfg: LlamaConfig):
    """tokens [B, Tq] (new tokens only) → (logits [B, Tq, V] f32, cache').
    ``params`` a tree or ``ModelShards`` (``cache`` then holds their lists)."""
    trees, axis = _shards(params)
    cks, cvs = each(cache.k), each(cache.v)
    maxT = cks[0].shape[3]
    if cache.length + tokens.shape[1] > maxT:
        raise ValueError(f"cache holds {maxT} positions; {cache.length} + {tokens.shape[1]} overflows")
    tables = {str(k.device): L.rope_frequencies(cfg.head_dim, maxT, cfg.rope_theta, cfg.rope_scaling,
                                                 device=k.device) for k in cks}
    ropes = [tables[str(k.device)] for k in cks]
    x = embed_shards(params, tokens, cfg.tdtype)
    for i in range(cfg.n_layers):
        x = _block_with_cache(x, [layer_params(t["layers"], i) for t in trees], [k[i] for k in cks],
                              [v[i] for v in cvs], cache.length, ropes, cfg, axis)
    x = L.rms_norm(x, trees[0]["final_norm"], cfg.norm_eps)
    return head_logits(params, x), KVCache(cache.k, cache.v, cache.length + tokens.shape[1])


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
