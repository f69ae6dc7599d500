"""Continuous-batching decode engine (Llama family).

Counterpart of ``tony_tpu/models/serving.py``: one decode step runs every
slot's token through batched projections and FFN against a fixed-size KV
cache, each slot at its own position; requests are admitted into free slots
(prefill padded to power-of-two buckets), retire independently on EOS or
budget, and their overshoot tokens within a decode chunk are discarded.

Decode attention is one of:

- ``kv="paged"``: the paged decode kernel (``ops/decode_attention``) over a
  page pool with shared-prefix reuse; a decode chunk defers its pool writes
  to ONE write per chunk, the kernel folding the chunk's staged columns;
- ``kv="dense"``, ``attn="ragged"``: the same kernel over per-slot caches,
  each slot reading only its own band;
- ``kv="dense"``, ``attn="bucketed"``: plain masked attention over the
  shortest power-of-two cache prefix covering every active slot (``auto``
  picks it while that bucket is <= 512, the kernel beyond; always on the CPU).

The JAX engine's jit-stability helpers become plain in-place tensor updates:
PyTorch runs eagerly and the cache tensors are updated where they live.
A Mixtral config serves through the MoE branch of ``_ffn_with_cache``.

``tp > 1`` is the TP engine (JAX's ``mesh=`` with a model axis): the
training rules cut the weights into ``tp`` shards held in this process
(``generate.ModelShards``) on the first ``tp`` CUDA devices (or the
``devices`` given, which may repeat one), the dense cache splits over its
kv heads (JAX's ``P(None, None, "model")``), and the host loop stays as it
is. JAX's refusals hold: ``kv="paged"``, heads that do not divide the
axis, and an explicit ``attn="ragged"`` raise, and ``"auto"`` is
``"bucketed"``: no attention kernel runs under tp, as none is partitioned
in JAX. int8 weights under tp raise too (JAX's engine fails to place
them). A Mixtral config is cut by Mixtral's rules (JAX's choice): each
shard holds ``F/tp`` columns of every expert and the whole router, runs
the router on its own copy (the same gates on every shard), and its
expert partials are summed as the dense FFN's are; a prefill's MoE is
B7 on the shard's blocks.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from tony_tpu_torch.models.generate import (
    KVCache,
    ModelShards,
    _ffn_with_cache,
    _forward_with_cache,
    _masked_slot_attention,
    _mm,
    _sample,
    _shards,
    cache_tensors,
    each,
    embed_shards,
    head_logits,
    init_cache,
    layer_params,
    params_device,
    sample_logits,
)
from tony_tpu_torch.models import llama, mixtral
from tony_tpu_torch.models.llama import LlamaConfig, check_model_axis
from tony_tpu_torch.models.paged_cache import (
    PageAllocator,
    PagedCache,
    gather_prefix_into_staging,
    init_paged_cache,
    insert_paged_prefill,
    prefix_keys,
)
from tony_tpu_torch.ops import layers as L
from tony_tpu_torch.ops import quant as Q
from tony_tpu_torch.ops.decode_attention import paged_decode_attention, ragged_decode_attention


@dataclass
class SlotCache:
    """Decode state for S slots. k/v: [L, S, Hkv, maxT, Dh] (under tp a list
    of one ``Hkv/tp``-head tensor a shard, on its device); lengths: [S]
    int32 (on the first device)."""

    k: torch.Tensor | list
    v: torch.Tensor | list
    lengths: torch.Tensor


def init_slot_cache(cfg: LlamaConfig, num_slots: int, max_len: int, device) -> SlotCache:
    """``device``: one device, or the tp shards' devices (a list)."""
    k, v = cache_tensors(cfg, num_slots, max_len, device)
    home = device[0] if isinstance(device, (list, tuple)) else device
    return SlotCache(k=k, v=v, lengths=torch.zeros((num_slots,), dtype=torch.int32, device=home))


@functools.lru_cache(maxsize=32)
def _rope_table(dim: int, max_seq: int, theta: float, scaling: tuple, device: str):
    return L.rope_frequencies(dim, max_seq, theta, scaling, device=device)


def _decode_one(
    params, cache, tokens: torch.Tensor, gen, cfg: LlamaConfig,
    temperature: float = 0.0, top_k: int = 0, attn: str = "bucketed",
    samp=None, staged=None,
):
    """One token for every slot: (next tokens [S], cache') — plus this
    step's K/V columns [L, S, Hkv, Dh] in deferred-write mode (``staged``).

    Each slot runs at position ``cache.lengths[s]`` clamped at maxT-1; idle
    slots (length 0) decode garbage the host ignores. ``cache`` is a
    SlotCache or a PagedCache; the branch picks the attention read and the
    cache write, everything else is shared. ``params``: a tree, or the TP
    engine's ``ModelShards`` (with a SlotCache of their lists)."""
    paged = isinstance(cache, PagedCache)
    trees, axis = _shards(params)
    cks, cvs = each(cache.k), each(cache.v)
    S = tokens.shape[0]
    Dh = cfg.head_dim
    maxT = cache.page_table.shape[1] * cache.k.shape[3] if paged else cks[0].shape[3]
    # KERNEL PRECONDITION: active slots have lengths < maxT (submit() checks
    # prompt + budget <= max_len); only retired-not-yet-flushed slots reach
    # the clamp, and their output is never read
    pos = torch.clamp(cache.lengths, max=maxT - 1).to(torch.int32)
    ropes = [_rope_table(Dh, maxT, cfg.rope_theta, cfg.rope_scaling, str(k.device)) for k in cks]
    poss = [pos.to(k.device) for k in cks]
    x = embed_shards(params, tokens[:, None], cfg.tdtype)                # [S, 1, D]
    ks_new, vs_new = [[] for _ in cks], [[] for _ in cks]
    for i in range(cfg.n_layers):
        lps = [layer_params(t["layers"], i) for t in trees]
        h = L.rms_norm(x, lps[0]["attn_norm"], cfg.norm_eps)
        parts = []
        for s_, (hs, lp) in enumerate(zip(axis.copy_to_model(h), lps)):
            ck, cv = cks[s_][i], cvs[s_][i]
            (cos, sin), p_ = ropes[s_], poss[s_]
            q = _mm(hs, lp["wq"]).reshape(S, 1, -1, Dh).transpose(1, 2)
            k = _mm(hs, lp["wk"]).reshape(S, 1, -1, Dh).transpose(1, 2)
            v = _mm(hs, lp["wv"]).reshape(S, 1, -1, Dh).transpose(1, 2)
            q = L.apply_rope(q, cos, sin, positions=p_[:, None])
            k = L.apply_rope(k, cos, sin, positions=p_[:, None])
            q1 = q[:, :, 0].contiguous()
            k1 = k[:, :, 0].to(ck.dtype).contiguous()                   # [S, Hkv, Dh]
            v1 = v[:, :, 0].to(cv.dtype).contiguous()
            if paged:
                extra = {}
                if staged is not None:
                    extra = dict(staged_k=staged[0][i], staged_v=staged[1][i], staged_count=staged[2])
                o = paged_decode_attention(
                    q1, ck, cv, p_, cache.page_table, cur_k=k1, cur_v=v1,
                    window=cfg.sliding_window, **extra,
                )
            elif attn == "ragged":
                o = ragged_decode_attention(q1, ck, cv, p_, cur_k=k1, cur_v=v1,
                                            window=cfg.sliding_window)
            else:
                o = _masked_slot_attention(q1, ck, cv, p_, q1.shape[1] // k1.shape[1],
                                           window=cfg.sliding_window, cur_k=k1, cur_v=v1)
            parts.append(_mm(o.reshape(S, 1, -1), lp["wo"]))
            ks_new[s_].append(k1)
            vs_new[s_].append(v1)
        x = x + axis.reduce_from_model(parts)
        h = L.rms_norm(x, lps[0]["mlp_norm"], cfg.norm_eps)
        x = x + axis.reduce_from_model([_ffn_with_cache(hs, lp, cfg) for hs, lp in zip(axis.copy_to_model(h), lps)])
    x = L.rms_norm(x, trees[0]["final_norm"], cfg.norm_eps)
    logits = head_logits(params, x[:, 0])                                # [S, V]
    if samp is not None:
        nxt = sample_logits(logits, gen, *samp)
    else:
        nxt = _sample(logits, gen, temperature, top_k)
    # idle slots (length 0) stay at 0 instead of regrowing +1 per step
    new_len = torch.where(
        cache.lengths > 0, torch.clamp(cache.lengths + 1, max=maxT), 0
    ).to(torch.int32)
    ks_new = [torch.stack(t) for t in ks_new]                            # [L, S, Hkv, Dh] a shard
    vs_new = [torch.stack(t) for t in vs_new]
    if staged is not None:
        # deferred-write mode: the columns go to the chunk staging, not the pool
        return nxt, PagedCache(cache.k, cache.v, new_len, cache.page_table), ks_new[0], vs_new[0]
    slots = torch.arange(S, device=tokens.device)
    if paged:
        page_len = cache.k.shape[3]
        pages = cache.page_table[slots, (pos // page_len).long()].long()
        offs = (pos % page_len).long()
        # two advanced indices split by a slice: indexed dims go first → [S, L, Hkv, Dh]
        cache.k[:, pages, :, offs, :] = ks_new[0].transpose(0, 1)
        cache.v[:, pages, :, offs, :] = vs_new[0].transpose(0, 1)
        return nxt, PagedCache(cache.k, cache.v, new_len, cache.page_table)
    for ck, cv, kn, vn, p_ in zip(cks, cvs, ks_new, vs_new, poss):
        sl = slots.to(ck.device)
        ck[:, sl, :, p_.long(), :] = kn.transpose(0, 1)
        cv[:, sl, :, p_.long(), :] = vn.transpose(0, 1)
    return nxt, SlotCache(cache.k, cache.v, new_len)


def decode_steps(
    params, cache, tokens: torch.Tensor, gen, cfg: LlamaConfig, n: int,
    temperature: float = 0.0, top_k: int = 0, attn: str = "ragged", samp=None,
):
    """``n`` decode steps: (tokens [S], all tokens [n, S], cache').

    PAGED caches decode in DEFERRED-WRITE mode: each step's K/V columns land
    in a chunk staging buffer, the kernel folds the staged window, and the
    page pool is written ONCE per chunk."""
    if not isinstance(cache, PagedCache):
        seq = []
        for _ in range(n):
            tokens, cache = _decode_one(params, cache, tokens, gen, cfg, temperature, top_k, attn, samp)
            seq.append(tokens)
        return tokens, torch.stack(seq), cache

    Lc, _, Hkv, page_len, Dh = cache.k.shape
    S = tokens.shape[0]
    dev = tokens.device
    maxT = cache.page_table.shape[1] * page_len
    len0 = cache.lengths.clone()
    stage_k = torch.zeros((Lc, S, n, Hkv, Dh), dtype=cache.k.dtype, device=dev)
    stage_v = torch.zeros((Lc, S, n, Hkv, Dh), dtype=cache.v.dtype, device=dev)
    seq = []
    for i in range(n):
        count = torch.full((S,), i, dtype=torch.int32, device=dev)
        tokens, cache, cols_k, cols_v = _decode_one(
            params, cache, tokens, gen, cfg, temperature, top_k, attn, samp,
            staged=(stage_k, stage_v, count),
        )
        stage_k[:, :, i] = cols_k
        stage_v[:, :, i] = cols_v
        seq.append(tokens)
    # ONE pool write for the whole chunk: (slot s, step j) sits at position
    # len0[s]+j (idle slots pin to the sacrificial page 0; overshoot clamps
    # to maxT-1 — duplicate targets there hold garbage nothing reads, and
    # index_put_ may keep any one of them)
    steps = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    pos = torch.where(len0[:, None] > 0, torch.clamp(len0[:, None] + steps, max=maxT - 1), 0)
    pages = cache.page_table.gather(1, (pos // page_len).long()).reshape(-1).long()
    offs = (pos % page_len).reshape(-1).long()
    cache.k[:, pages, :, offs, :] = stage_k.permute(1, 2, 0, 3, 4).reshape(S * n, Lc, Hkv, Dh)
    cache.v[:, pages, :, offs, :] = stage_v.permute(1, 2, 0, 3, 4).reshape(S * n, Lc, Hkv, Dh)
    return tokens, torch.stack(seq), cache


def decode_steps_bucketed(
    params, cache: SlotCache, tokens: torch.Tensor, gen, cfg: LlamaConfig, n: int,
    bucket: int, temperature: float = 0.0, top_k: int = 0, samp=None,
):
    """``decode_steps`` over a LENGTH-BUCKETED cache view: attention reads
    only the first ``bucket`` positions; the view's writes land in the full
    cache directly (it is a view)."""
    def view(t):
        return [x[:, :, :, :bucket] for x in t] if isinstance(t, list) else t[:, :, :, :bucket]

    sub = SlotCache(view(cache.k), view(cache.v), cache.lengths)
    seq = []
    for _ in range(n):
        tokens, sub = _decode_one(params, sub, tokens, gen, cfg, temperature, top_k, "bucketed", samp)
        seq.append(tokens)
    return tokens, torch.stack(seq), SlotCache(cache.k, cache.v, sub.lengths)


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _insert_prefill(cache: SlotCache, pre: KVCache, slot: int, true_len: int) -> SlotCache:
    """Copy a 1-request prefill cache [L, 1, Hkv, maxT, Dh] (a shard's each)
    into ``slot``."""
    for ck, pk in zip(each(cache.k), each(pre.k)):
        ck[:, slot] = pk[:, 0]
    for cv, pv in zip(each(cache.v), each(pre.v)):
        cv[:, slot] = pv[:, 0]
    cache.lengths[slot] = true_len
    return cache


def _leaf_values(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaf_values(v)
        else:
            yield v


@dataclass
class _Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    out: list[int] = field(default_factory=list)
    slot: int = -1
    temperature: float | None = None
    top_k: int | None = None
    top_p: float | None = None
    cancelled: bool = False

    def is_done(self, eos_id: int) -> bool:
        """THE termination predicate — budget spent, EOS emitted, or cancelled."""
        return self.cancelled or len(self.out) >= self.max_new_tokens or (
            eos_id >= 0 and bool(self.out) and self.out[-1] == eos_id
        )


@dataclass
class _Staged:
    """A request mid-prefill, staged ahead of slot availability."""

    req: _Request
    pre: KVCache
    pos: int = 0
    first: torch.Tensor | None = None
    matched: list[int] = field(default_factory=list)
    keys: list[tuple] = field(default_factory=list)


def tp_devices(tp: int, like: torch.device) -> list[torch.device]:
    """The first ``tp`` visible CUDA devices (for a model on a card), or
    the CPU ``tp`` times."""
    if like.type != "cuda":
        return [like] * tp
    n = torch.cuda.device_count()
    if n < tp:
        raise ValueError(f"--tp {tp} needs {tp} devices but only {n} are visible")
    return [torch.device("cuda", i) for i in range(tp)]


class ContinuousBatcher:
    """Slot-based continuous batching: admit → decode → retire, every step.

    ``attn``: "auto" (CPU: always bucketed; CUDA: bucketed while every
    active slot fits a bucket <= ``RAGGED_THRESHOLD``, the ragged kernel
    beyond), or "ragged"/"bucketed". ``kv="paged"`` always decodes through
    the paged kernel. The device is the parameters' device; ``generator``
    draws the sampled tokens (greedy decoding never draws)."""

    RAGGED_THRESHOLD = 512

    def __init__(
        self, params, cfg: LlamaConfig, *, num_slots: int = 8, max_len: int = 512,
        eos_id: int = -1, temperature: float = 0.0, top_k: int = 0,
        generator: torch.Generator | None = None, decode_chunk: int = 8, attn: str = "auto",
        prefill_chunk: int = 0, kv: str = "dense", page_len: int = 256,
        num_pages: int | None = None, tp: int = 1, devices=None,
    ):
        if num_slots < 1 or max_len < 1:
            raise ValueError(f"need num_slots>=1 and max_len>=1, got {num_slots}/{max_len}")
        if kv not in ("dense", "paged"):
            raise ValueError(f"kv must be dense|paged, got {kv!r}")
        self.kv = kv
        if kv == "paged":
            if page_len < 8 or page_len % 8:
                raise ValueError(f"page_len must be a multiple of 8 >= 8, got {page_len}")
            if max_len % page_len:
                raise ValueError(f"max_len {max_len} must be a multiple of page_len {page_len}")
        self.device = params_device(params)
        self.tp = tp
        if tp > 1:
            if kv == "paged":
                raise ValueError("model-axis TP serving currently requires kv='dense' "
                                 "(the paged pool's page indirection is per-device)")
            if cfg.n_kv_heads % tp or cfg.n_heads % tp:
                raise ValueError(f"n_heads {cfg.n_heads} and n_kv_heads {cfg.n_kv_heads} "
                                 f"must divide the model axis ({tp})")
            if attn == "ragged":
                raise ValueError("attn='ragged' is incompatible with model-axis TP (the decode kernel "
                                 "is not partitioned over heads); use attn='auto'")
            if any(isinstance(v, Q.QTensor) for v in _leaf_values(params)):
                raise ValueError("int8 weights under model-axis TP (tp > 1) are not served: JAX's TP "
                                 "engine cannot place them either; serve --int8 at --tp 1")
            check_model_axis(cfg, tp)
            attn = "bucketed"
            rules = (mixtral if isinstance(cfg, mixtral.MixtralConfig) else llama).sharding_rules(cfg)
            params = ModelShards.place(params, rules, devices or tp_devices(tp, self.device))
            self.device = params_device(params)
        if attn not in ("auto", "ragged", "bucketed"):
            raise ValueError(f"attn must be auto|ragged|bucketed, got {attn!r}")
        if attn == "auto" and (self.device.type == "cpu" or max_len <= self.RAGGED_THRESHOLD):
            attn = "bucketed"
        self.params, self.cfg = params, cfg
        self.S, self.max_len, self.eos_id = num_slots, max_len, eos_id
        self.temperature, self.top_k = temperature, top_k
        self.attn = attn
        self._samp_temp = np.full((num_slots,), temperature, np.float32)
        self._samp_topk = np.full((num_slots,), top_k, np.int32)
        self._samp_topp = np.zeros((num_slots,), np.float32)
        self._per_slot = False
        self._samp_dev = None
        self._samp_dirty = True
        self.decode_chunk = max(1, decode_chunk)
        self.prefill_chunk = prefill_chunk
        if kv == "paged":
            self.page_len = page_len
            self.max_pages = max_len // page_len
            self.num_pages = num_pages if num_pages is not None else num_slots * self.max_pages + 1
            self.allocator = PageAllocator(self.num_pages)
            self.cache = init_paged_cache(cfg, num_slots, max_len, page_len, self.num_pages, self.device)
            self._slot_pages: dict[int, list[int]] = {}
            #: prompt tokens whose prefill was skipped via prefix-cache hits
            self.prefix_hit_tokens = 0
        else:
            self.cache = init_slot_cache(cfg, num_slots, max_len, self._kv_devices())
        self.tokens = torch.zeros((num_slots,), dtype=torch.int32, device=self.device)
        self.gen = generator
        self.pending: list[_Request] = []
        self.running: dict[int, _Request] = {}
        self.done: dict[int, list[int]] = {}
        self._retired_slots: list[int] = []
        self._next_rid = 0
        self._stream_pos: dict[int, int] = {}
        self._stream_done: set[int] = set()
        self._staged: list[_Staged] = []
        self._slot_len = [0] * num_slots  # host mirror of cache.lengths

    def submit(
        self, prompt, max_new_tokens: int, *,
        temperature: float | None = None, top_k: int | None = None, top_p: float | None = None,
    ) -> int:
        """``temperature``/``top_k``/``top_p`` override the engine defaults
        for THIS request only; None keeps the default."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if temperature is not None and temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k is not None and top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if top_p is not None and not 0 < top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {top_p} (for greedy decoding use temperature=0)")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} "
                f"exceeds engine max_len {self.max_len}"
            )
        if any(t < 0 or t >= self.cfg.vocab_size for t in prompt):
            raise ValueError(f"prompt tokens must lie in [0, {self.cfg.vocab_size})")
        if self.kv == "paged":
            need = self._pages_needed(len(prompt), max_new_tokens)
            if need > self.num_pages - 1:
                raise ValueError(
                    f"request needs {need} pages but the pool holds "
                    f"{self.num_pages - 1}: raise num_pages or shrink the request"
                )
        rid = self._next_rid
        self._next_rid += 1
        if temperature is not None or top_k is not None or top_p is not None:
            self._per_slot = True
        self.pending.append(_Request(rid, prompt, max_new_tokens,
                                     temperature=temperature, top_k=top_k, top_p=top_p))
        return rid

    def cancel(self, rid: int) -> bool:
        """Drop a request wherever it is: pending → removed; staged → removed
        with its prefix pins released; running → retires at the next chunk
        boundary. False for unknown/already-finished rids."""
        for i, req in enumerate(self.pending):
            if req.rid == rid:
                self.pending.pop(i)
                self._stream_pos.pop(rid, None)
                return True
        for i, entry in enumerate(self._staged):
            if entry.req.rid == rid:
                if self.kv == "paged":
                    for p in entry.matched:
                        self.allocator.release(p)
                self._staged.pop(i)
                self._stream_pos.pop(rid, None)
                return True
        for req in self.running.values():
            if req.rid == rid:
                req.cancelled = True
                return True
        return False

    # -- engine internals ---------------------------------------------------

    def _kv_devices(self):
        """Where a cache lives: the device, or each TP shard's."""
        return self.params.axis.devices if isinstance(self.params, ModelShards) else self.device

    def _free_slots(self) -> list[int]:
        return [s for s in range(self.S) if s not in self.running]

    def _pages_needed(self, Tp: int, max_new: int) -> int:
        """Worst-case page reservation: prompt + budget rounded up to whole
        decode chunks (a request retiring mid-chunk keeps writing discarded
        tokens until the chunk ends, inside its own pages)."""
        h = self.decode_chunk
        hi = min(Tp + -(-max_new // h) * h, self.max_len)
        return -(-hi // self.page_len)

    def _stage_prefills(self, budget: int, advance: bool = True):
        """Stage up to ``budget`` pending requests and (when ``advance``) run
        prefill work for every staged entry, with burst dedup: an entry whose
        first full page matches an earlier still-staged entry waits for that
        leader to register its pages, then re-matches instead of recomputing."""
        while self.pending and len(self._staged) < budget:
            req = self.pending.pop(0)
            entry = _Staged(req, init_cache(self.cfg, 1, self.max_len, self._kv_devices()))
            if self.kv == "paged":
                entry.keys = prefix_keys(req.prompt, self.page_len)
                self._match_prefix_into(entry)
            self._staged.append(entry)
        if advance:
            seen_first: set[tuple] = set()
            for entry in self._staged:
                fk = entry.keys[0] if entry.keys else None
                defer = (
                    fk is not None and fk in seen_first
                    and entry.first is None and entry.pos == 0 and not entry.matched
                    and not self.allocator.has_key(fk)
                )
                if fk is not None:
                    seen_first.add(fk)
                if not defer:
                    self._advance_prefill(entry)

    def _match_prefix_into(self, entry: _Staged) -> bool:
        """Pin the longest resident chain of FULL prompt pages, copy it into
        the entry's staging cache, and start prefill after it. Capped at
        (Tp-1)//page_len: the LAST prompt token is always prefilled."""
        cap = (len(entry.req.prompt) - 1) // self.page_len
        matched = self.allocator.match_prefix(entry.keys[:cap])
        if not matched:
            return False
        entry.pre = gather_prefix_into_staging(entry.pre, self.cache.k, self.cache.v, matched)
        entry.pos = len(matched) * self.page_len
        entry.matched = matched
        self.prefix_hit_tokens += entry.pos
        return True

    def _advance_prefill(self, entry: _Staged) -> None:
        """Run one prefill chunk (or the whole prompt when unchunked)."""
        req, pre, pos, first = entry.req, entry.pre, entry.pos, entry.first
        if first is not None:
            return
        Tp = len(req.prompt)
        if self.kv == "paged" and pos == 0 and not entry.matched:
            # the prefix chain may have grown since this entry was staged
            if self._match_prefix_into(entry):
                pre, pos = entry.pre, entry.pos
        step = self.prefill_chunk if self.prefill_chunk > 0 else Tp
        while first is None:
            take = min(step, Tp - pos)
            last = pos + take >= Tp
            # the last chunk pads to a bucket, capped so the padded write
            # never runs past max_len; middle chunks are exact
            pad = min(_bucket(take), self.max_len - pos) - take if last else 0
            toks = torch.tensor(req.prompt[pos:pos + take] + [0] * pad,
                                dtype=torch.int32, device=self.device)[None, :]
            # padded positions write garbage K/V past Tp; decode masks them
            # out via lengths[slot] = Tp, and causality protects the prefix
            logits, pre = _forward_with_cache(self.params, toks, pre, self.cfg)
            pre.length = pos + take
            pos += take
            if last:
                last_logits = logits[:, take - 1].float()
                if req.temperature is not None or req.top_k is not None or req.top_p is not None:
                    dev = self.device
                    first = sample_logits(
                        last_logits, self.gen,
                        torch.full((1,), req.temperature if req.temperature is not None
                                   else self.temperature, dtype=torch.float32, device=dev),
                        torch.full((1,), req.top_k if req.top_k is not None else self.top_k,
                                   dtype=torch.int32, device=dev),
                        torch.full((1,), req.top_p if req.top_p is not None else 0.0,
                                   dtype=torch.float32, device=dev),
                    )
                else:
                    first = _sample(last_logits, self.gen, self.temperature, self.top_k)
            entry.pre, entry.pos, entry.first = pre, pos, first
            if self.prefill_chunk > 0:
                break  # one chunk per engine step — decode interleaves

    def _admit(self):
        free = self._free_slots()
        self._stage_prefills(len(free), advance=not self.running)
        while self._staged and free and self._staged[0].first is not None:
            head = self._staged[0]
            req, pre, first = head.req, head.pre, head.first
            slot = free[0]
            Tp = len(req.prompt)
            if self.kv == "paged":
                if not self._admit_paged(req, pre, head.matched, head.keys, slot, Tp):
                    break  # pages short: admission waits for retirements
            else:
                self.cache = _insert_prefill(self.cache, pre, slot, Tp)
            self._staged.pop(0)
            free.pop(0)
            self.tokens[slot] = first[0]
            self._samp_temp[slot] = req.temperature if req.temperature is not None else self.temperature
            self._samp_topk[slot] = req.top_k if req.top_k is not None else self.top_k
            self._samp_topp[slot] = req.top_p if req.top_p is not None else 0.0
            self._samp_dirty = True
            self._slot_len[slot] = Tp
            req.slot = slot
            req.out.append(int(first[0]))
            self.running[slot] = req
            self._retire_if_done(req)  # 1-token requests finish at admission

    def _admit_paged(self, req, pre, matched: list[int], keys: list[tuple], slot: int, Tp: int) -> bool:
        """Reserve pages, attach the shared prefix, copy the prefilled span,
        install the page-table row. False → pool short, caller waits."""
        # a retired-but-unflushed slot still holds its old reservation:
        # release it BEFORE the availability check
        for p in self._slot_pages.pop(slot, []):
            self.allocator.release(p)
        n_covered = self._pages_needed(Tp, req.max_new_tokens)
        n_fresh = n_covered - len(matched)
        if n_fresh > self.allocator.available():
            # nothing running → nothing will retire; the only reclaimable
            # capacity is other staged entries' prefix pins (their content
            # is already copied into their staging caches)
            if self.running:
                return False
            for entry in self._staged:
                if entry.req is not req and entry.matched:
                    for p in entry.matched:
                        self.allocator.release(p)
                    entry.matched = []
            if n_fresh > self.allocator.available():
                return False
        fresh = self.allocator.alloc(n_fresh)
        row = list(matched) + fresh                      # logical page order
        n_prefill = -(-Tp // self.page_len)              # pages holding prompt K/V
        nc = n_prefill - len(matched)                    # pages to copy from staging
        pt_row = [0] * self.max_pages
        pt_row[:n_covered] = row
        self.cache = insert_paged_prefill(
            self.cache, pre.k, pre.v, fresh[:nc], pt_row, slot, Tp, len(matched),
        )
        for j in range(len(matched), Tp // self.page_len):
            self.allocator.register(row[j], keys[j])
        self._slot_pages[slot] = row
        return True

    def _retire_if_done(self, req: _Request):
        if req.slot in self.running and req.is_done(self.eos_id):
            del self.running[req.slot]
            if req.cancelled:
                self._stream_pos.pop(req.rid, None)
            else:
                self.done[req.rid] = req.out
            self._retired_slots.append(req.slot)
            self._slot_len[req.slot] = 0

    def _flush_retired(self):
        """Zero retired slots' device-side lengths (and, paged, release their
        pages and reset their page-table rows to the sacrificial page 0).
        Slots re-admitted since retirement are skipped."""
        idle = [s for s in self._retired_slots if s not in self.running]
        self._retired_slots = []
        if not idle:
            return
        idx = torch.tensor(idle, dtype=torch.long, device=self.device)
        self.cache.lengths[idx] = 0
        if self.kv == "paged":
            for s in idle:
                for p in self._slot_pages.pop(s, []):
                    self.allocator.release(p)
            self.cache.page_table[idx] = 0

    def step(self) -> bool:
        """Admit + one decode chunk. Returns True while work remains."""
        self._admit()
        self._flush_retired()
        if not self.running:
            return bool(self.pending or self._staged)
        h = self.decode_chunk
        if self.kv == "paged":
            use_ragged, bucket = True, 0
        else:
            needed = max(self._slot_len[s] for s in self.running) + h
            bucket = min(_bucket(max(needed, 1)), self.max_len)
            use_ragged = self.attn == "ragged" or (
                self.attn == "auto" and bucket > self.RAGGED_THRESHOLD
            )
        samp = None
        if self._per_slot:
            if self._samp_dirty or self._samp_dev is None:
                self._samp_dev = (
                    torch.from_numpy(self._samp_temp).to(self.device),
                    torch.from_numpy(self._samp_topk).to(self.device),
                    torch.from_numpy(self._samp_topp).to(self.device),
                )
                self._samp_dirty = False
            samp = self._samp_dev
        if use_ragged:
            toks, seq, self.cache = decode_steps(
                self.params, self.cache, self.tokens, self.gen, self.cfg, h,
                self.temperature, self.top_k, "ragged", samp,
            )
        else:
            toks, seq, self.cache = decode_steps_bucketed(
                self.params, self.cache, self.tokens, self.gen, self.cfg, h,
                bucket, self.temperature, self.top_k, samp,
            )
        self.tokens = toks
        # queue prefills for the next admissions behind the in-flight chunk
        self._stage_prefills(max(len(self._free_slots()), 1))
        seq_host = seq.cpu().numpy()  # [h, S]: ONE device→host transfer
        for slot in self.running:
            self._slot_len[slot] = min(self._slot_len[slot] + h, self.max_len)
        for req in list(self.running.values()):
            for i in range(h):
                req.out.append(int(seq_host[i, req.slot]))
                if req.is_done(self.eos_id):
                    break  # post-budget/post-EOS chunk tokens are discarded
            self._retire_if_done(req)
        more = bool(self.running or self.pending or self._staged)
        if not more:
            self._flush_retired()
        return more

    def drain_stream(self) -> dict[int, tuple[list[int], bool]]:
        """Tokens appended per request since the last drain:
        {rid: (new_tokens, finished)}; a finished request is reported once."""
        out: dict[int, tuple[list[int], bool]] = {}
        self._stream_done &= self.done.keys()
        for rid, toks in self.done.items():
            if rid not in self._stream_done:
                pos = self._stream_pos.pop(rid, 0)
                out[rid] = (list(toks[pos:]), True)
                self._stream_done.add(rid)
        live = [e.req for e in self._staged] + list(self.pending) + list(self.running.values())
        for req in live:
            if req.rid in self._stream_done or req.rid in out:
                continue
            pos = self._stream_pos.get(req.rid, 0)
            if len(req.out) > pos:
                out[req.rid] = (list(req.out[pos:]), False)
                self._stream_pos[req.rid] = len(req.out)
        return out

    def run(self) -> dict[int, list[int]]:
        """Drain all submitted requests; returns {request_id: tokens}."""
        while self.step():
            pass
        return dict(self.done)
