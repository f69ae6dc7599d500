"""Ragged / paged one-token decode attention for the serving engine.

Counterpart of ``tony_tpu/ops/decode_attention.py``. Both entry points run
one CUDA kernel (``csrc/decode_attention.cu``, which replaces the Pallas
``_kernel`` at ``tony_tpu/ops/decode_attention.py:49``) for CUDA tensors and
the plain PyTorch ``decode_attention_ref`` for CPU tensors — never the
plain version for a CUDA tensor. A call is one device launch of split
blocks (flash-decoding: each block one run of cache positions of one slot
and kv head); the last split of a (slot, kv head) to finish merges them in
split order. The split count comes from the cache's shape, so a call reads
nothing on the host and can be captured in a CUDA graph once a first call
has made the device's ticket buffer (``_build.tickets``).

Slot s attends its cache band ``[max(0, len_s + 1 - window), len_s - count_s)``
(``window`` 0 → from 0), then the ``count_s`` staged entries (paged chunked
decode: this chunk's columns not yet written to the pool), then the current
token ``cur_k/cur_v``, which is always in the band. ``lengths`` counts cache
positions only; the cache is never written here.

Bound on the H100: bytes, Σ_s band_s · Hkv · Dh · 2 (K and V) · itemsize.
"""

from __future__ import annotations

import ctypes

import torch

from tony_tpu_torch.ops import _build

#: kernel launches per wrapper (the chip check reads these to show the
#: serving path went through the kernel; only a launch adds to a count)
launches = {"ragged_decode_attention": 0, "paged_decode_attention": 0}

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_NREP_MAX = 8


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """[P, Hkv, page_len, Dh] pool → per-slot logical cache [S, Hkv, maxT, Dh]."""
    S, max_pages = page_table.shape
    _, Hkv, page_len, Dh = pool.shape
    g = pool[page_table.long()]                      # [S, max_pages, Hkv, page_len, Dh]
    return g.permute(0, 2, 1, 3, 4).reshape(S, Hkv, max_pages * page_len, Dh)


def decode_attention_ref(
    q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, lengths: torch.Tensor, *,
    cur_k: torch.Tensor, cur_v: torch.Tensor, window: int = 0,
    page_table: torch.Tensor | None = None,
    staged_k: torch.Tensor | None = None, staged_v: torch.Tensor | None = None,
    staged_count: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of the kernel: masked softmax over the gathered band,
    the staged window and the self term, all in f32; o in q's dtype.

    Dense: ck/cv [S, Hkv, maxT, Dh]. Paged (``page_table`` set): ck/cv are
    the pool [P, Hkv, page_len, Dh]."""
    S, H, Dh = q.shape
    if page_table is not None:
        ck, cv = _gather_pages(ck, page_table), _gather_pages(cv, page_table)
    Hkv, maxT = ck.shape[1], ck.shape[2]
    n_rep = H // Hkv
    dev = q.device
    lengths = lengths.to(torch.int64)
    count = (staged_count.to(torch.int64) if staged_k is not None
             else torch.zeros_like(lengths))
    pool_len = (lengths - count).clamp_min(0)[:, None]           # [S, 1]
    lo = (lengths + 1 - window).clamp_min(0)[:, None] if window > 0 else torch.zeros_like(pool_len)

    qf = q.float().reshape(S, Hkv, n_rep, Dh) * (Dh ** -0.5)
    keys, vals, ok = [ck.float()], [cv.float()], []
    pos = torch.arange(maxT, device=dev)[None, :]
    ok.append((pos >= lo) & (pos < pool_len))                    # [S, maxT]
    if staged_k is not None:
        W = staged_k.shape[1]
        keys.append(staged_k.float().permute(0, 2, 1, 3))        # [S, Hkv, W, Dh]
        vals.append(staged_v.float().permute(0, 2, 1, 3))
        j = torch.arange(W, device=dev)[None, :]
        ok.append((j < count[:, None]) & (pool_len + j >= lo))
    keys.append(cur_k.float()[:, :, None])
    vals.append(cur_v.float()[:, :, None])
    ok.append(torch.ones((S, 1), dtype=torch.bool, device=dev))
    k_all, v_all, ok_all = torch.cat(keys, 2), torch.cat(vals, 2), torch.cat(ok, 1)
    s = torch.einsum("sgrd,sgtd->sgrt", qf, k_all)
    s = torch.where(ok_all[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("sgrt,sgtd->sgrd", p, v_all)
    return o.reshape(S, H, Dh).to(q.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
# q k v lengths page_table | max_pages | cur_k cur_v staged_k staged_v
# staged_count | W | o workspace tickets | n_splits S H Hkv Dh T_len window dtype | stream
_ARGTYPES = [_P] * 5 + [_I] + [_P] * 5 + [_I] + [_P] * 3 + [_I] * 8 + [_P]


_bound: dict = {}


def _entry():
    """(the C entry, the split length), bound once per process."""
    if not _bound:
        lib = _build.library("decode_attention")
        fn = lib.tt_decode_attention
        fn.restype, fn.argtypes = ctypes.c_int, _ARGTYPES
        lib.tt_decode_split_rows.restype, lib.tt_decode_split_rows.argtypes = ctypes.c_int, []
        _bound["entry"] = (fn, lib.tt_decode_split_rows())
    return _bound["entry"]


def _launch(q, k, v, lengths, *, cur_k, cur_v, window, T_len, page_table=None,
            staged_k=None, staged_v=None, staged_count=None) -> torch.Tensor:
    S, H, Dh = q.shape
    Hkv = k.shape[1]
    dtype = q.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"decode attention kernel takes bfloat16 or float32, got {dtype}")
    if Dh not in (64, 128):
        raise ValueError(f"decode attention kernel takes head_dim 64 or 128, got {Dh}")
    if H % Hkv or H // Hkv > _NREP_MAX:
        raise ValueError(f"n_heads {H} must be a multiple of n_kv_heads {Hkv}, "
                         f"at most {_NREP_MAX}x")
    tensors = {"q": q, "k": k, "v": v, "cur_k": cur_k, "cur_v": cur_v}
    if staged_k is not None:
        tensors.update(staged_k=staged_k, staged_v=staged_v)
    for name, t in tensors.items():
        if t.device != q.device or t.dtype != dtype:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, want {dtype} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    ints = {"lengths": lengths}
    if page_table is not None:
        ints["page_table"] = page_table
    if staged_count is not None:
        ints["staged_count"] = staged_count
    for name, t in ints.items():
        if t.device != q.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous int32 on {q.device}")
    fn, split_rows = _entry()
    W = staged_k.shape[1] if staged_k is not None else 0
    max_pages = page_table.shape[1] if page_table is not None else 0
    # splits a (slot, kv head): from the cache's shape, never from the lengths
    ns = -(-(max_pages * T_len if page_table is not None else T_len) // split_rows)
    o = torch.empty_like(q)
    # each split's unnormalised f32 partial: o [S, Hkv, ns, n_rep, Dh], then (m, l)
    ws = torch.empty(S * H * ns * (Dh + 2), dtype=torch.float32, device=q.device)
    tickets = _build.tickets(q.device, S * Hkv, "decode attention")
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(lengths),
            _build.ptr(page_table), max_pages, _build.ptr(cur_k), _build.ptr(cur_v),
            _build.ptr(staged_k), _build.ptr(staged_v), _build.ptr(staged_count), W,
            _build.ptr(o), _build.ptr(ws), _build.ptr(tickets), ns, S, H, Hkv, Dh, T_len, int(window),
            _DTYPES[dtype], _build.stream(q.device))
    _build.check(rc, "decode_attention")
    return o


def ragged_decode_attention(
    q: torch.Tensor,        # [S, H, Dh] — one new token per slot
    ck: torch.Tensor,       # [S, Hkv, maxT, Dh] — read-only cache
    cv: torch.Tensor,
    lengths: torch.Tensor,  # [S] int32 — CACHE positions (excluding current token)
    *,
    cur_k: torch.Tensor,    # [S, Hkv, Dh]
    cur_v: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """Per-slot ragged attention over a dense cache; o [S, H, Dh].

    PRECONDITION (as in the JAX kernel): ``lengths[s] < maxT`` for every slot
    whose output is consumed."""
    if not q.is_cuda:
        return decode_attention_ref(q, ck, cv, lengths, cur_k=cur_k, cur_v=cur_v, window=window)
    o = _launch(q, ck, cv, lengths, cur_k=cur_k, cur_v=cur_v, window=window, T_len=ck.shape[2])
    launches["ragged_decode_attention"] += 1
    return o


def paged_decode_attention(
    q: torch.Tensor,           # [S, H, Dh]
    kp: torch.Tensor,          # [P, Hkv, page_len, Dh] — page pool (read-only)
    vp: torch.Tensor,
    lengths: torch.Tensor,     # [S] int32 — CACHE positions (excluding current)
    page_table: torch.Tensor,  # [S, max_pages] int32 — logical page j → physical
    *,
    cur_k: torch.Tensor,       # [S, Hkv, Dh]
    cur_v: torch.Tensor,
    window: int = 0,
    staged_k: torch.Tensor | None = None,  # [S, W, Hkv, Dh] — chunk staging
    staged_v: torch.Tensor | None = None,
    staged_count: torch.Tensor | None = None,  # [S] int32 — live staged entries
) -> torch.Tensor:
    """Ragged decode attention over a page pool; o [S, H, Dh]. The most
    recent ``staged_count[s]`` of the ``lengths[s]`` positions come from the
    staged window, not the pool."""
    page_len = kp.shape[2]
    if page_len < 8 or page_len % 8:
        raise ValueError(f"page_len {page_len} must be a multiple of 8 (>= 8)")
    if staged_k is not None and (staged_v is None or staged_count is None):
        raise ValueError("staged_k needs staged_v and staged_count")
    kw = dict(cur_k=cur_k, cur_v=cur_v, window=window, page_table=page_table,
              staged_k=staged_k, staged_v=staged_v, staged_count=staged_count)
    if not q.is_cuda:
        return decode_attention_ref(q, kp, vp, lengths, **kw)
    o = _launch(q, kp, vp, lengths, T_len=page_len, **kw)
    launches["paged_decode_attention"] += 1
    return o
