"""Block-paged KV cache + shared-prefix reuse for the serving engine.

Counterpart of ``tony_tpu/models/paged_cache.py``. Storage is a page pool
``[L, P, Hkv, page_len, Dh]`` shared by all slots; slot s's logical page j
lives in physical page ``page_table[s, j]``. Full prompt pages are
content-addressed by their exact token prefix and shared, refcounted, by
later requests with the same prefix. ``PageAllocator`` and ``prefix_keys``
are host code, copied as they are. The device updates write the pool in
place (the JAX versions donate the pool and alias it). ``gather_pages`` and
``scatter_pages`` are the two device halves of the disaggregated KV handoff
(``serve/disagg.py``); in JAX they are plain jitted XLA, not Pallas, so
plain tensor indexing is their counterpart.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass

import torch

from tony_tpu_torch.models.generate import KVCache
from tony_tpu_torch.models.llama import LlamaConfig


@dataclass
class PagedCache:
    """k/v: [L, P, Hkv, page_len, Dh]; lengths: [S] int32 cache positions;
    page_table: [S, max_pages] int32. Entries beyond a slot's live pages are
    never read (the kernel's loop bounds come from lengths)."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    page_table: torch.Tensor


def init_paged_cache(
    cfg: LlamaConfig, num_slots: int, max_len: int, page_len: int, num_pages: int, device,
) -> PagedCache:
    if max_len % page_len:
        raise ValueError(f"max_len {max_len} must be a multiple of page_len {page_len}")
    max_pages = max_len // page_len
    shape = (cfg.n_layers, num_pages, cfg.n_kv_heads, page_len, cfg.head_dim)
    return PagedCache(
        k=torch.zeros(shape, dtype=cfg.tdtype, device=device),
        v=torch.zeros(shape, dtype=cfg.tdtype, device=device),
        lengths=torch.zeros((num_slots,), dtype=torch.int32, device=device),
        page_table=torch.zeros((num_slots, max_pages), dtype=torch.int32, device=device),
    )


class PageAllocator:
    """Host-side page accounting: free list, refcounts, prefix chain.

    Pages move free → live (ref ≥ 1) → on release either back to free
    (unregistered) or into the REUSE POOL (registered full prompt pages,
    ref 0 but content valid — future prefix hits resurrect them; the pool
    is evicted LRU when fresh allocations outrun the free list)."""

    #: physical page 0 is SACRIFICIAL — never allocated. Idle slots still
    #: run the decode step and write one garbage column per step; it must
    #: land somewhere that can never be another slot's live page.
    GARBAGE_PAGE = 0

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (page 0 is sacrificial), got {num_pages}")
        self.num_pages = num_pages
        self._free: list[int] = list(range(num_pages - 1, 0, -1))
        self._ref = [0] * num_pages
        self._chain: dict[tuple, int] = {}       # prefix key → page
        self._key_of: dict[int, tuple] = {}      # page → its chain key
        self._reusable: "OrderedDict[int, None]" = OrderedDict()  # ref==0, keyed

    def available(self) -> int:
        return len(self._free) + len(self._reusable)

    def free_pages(self) -> int:
        """Pages that an alloc() takes without evicting the reuse pool."""
        return len(self._free)

    def live_pages(self) -> int:
        return self.num_pages - 1 - self.available()  # page 0 never counts

    def alloc(self, n: int) -> list[int]:
        """n fresh pages (ref 1 each), evicting LRU reuse-pool pages as
        needed. Raises if the pool cannot supply them — callers check
        available() first (admission waits instead)."""
        if n > self.available():
            raise RuntimeError(f"page pool exhausted: want {n}, have {self.available()}")
        out = []
        for _ in range(n):
            if self._free:
                p = self._free.pop()
            else:
                p, _ = self._reusable.popitem(last=False)  # LRU eviction
                del self._chain[self._key_of.pop(p)]
            self._ref[p] = 1
            out.append(p)
        return out

    def release(self, page: int) -> None:
        self._ref[page] -= 1
        if self._ref[page] > 0:
            return
        if page in self._key_of:
            self._reusable[page] = None      # content stays valid for reuse
            self._reusable.move_to_end(page)
        else:
            self._free.append(page)

    def match_prefix(self, keys: list[tuple]) -> list[int]:
        """Longest chain of resident pages for cumulative prefix ``keys``;
        each matched page's refcount is taken (pinned) before returning."""
        got: list[int] = []
        for key in keys:
            p = self._chain.get(key)
            if p is None:
                break
            if self._ref[p] == 0:
                self._reusable.pop(p, None)  # resurrect from the reuse pool
            self._ref[p] += 1
            got.append(p)
        return got

    def has_key(self, key: tuple) -> bool:
        return key in self._chain

    def register(self, page: int, key: tuple) -> None:
        """Content-address a LIVE full prompt page. First writer wins."""
        if key not in self._chain and page not in self._key_of:
            self._chain[key] = page
            self._key_of[page] = key


def prefix_keys(prompt: list[int], page_len: int) -> list[tuple]:
    """Cumulative content keys for the prompt's FULL pages; page j's key
    covers tokens [0, (j+1)·page_len): (page_index, sha256-of-prefix), built
    incrementally in one O(Tp) pass."""
    h = hashlib.sha256()
    out: list[tuple] = []
    for j in range(len(prompt) // page_len):
        page = prompt[j * page_len:(j + 1) * page_len]
        h.update(b"".join(t.to_bytes(8, "little", signed=True) for t in page))
        out.append((j, h.digest()))
    return out


def gather_prefix_into_staging(staging: KVCache, pk: torch.Tensor, pv: torch.Tensor,
                               pages: list[int]) -> KVCache:
    """Copy matched prefix pages into a request's dense staging cache
    ([L, 1, Hkv, maxT, Dh], in place) and set its length, so the remainder
    prefill writes at the right positions and attends the shared prefix."""
    L, _, Hkv, page_len, Dh = pk.shape
    n = len(pages)
    idx = torch.tensor(pages, dtype=torch.long, device=pk.device)
    for src, dst in ((pk, staging.k), (pv, staging.v)):
        flat = src[:, idx].permute(0, 2, 1, 3, 4).reshape(L, Hkv, n * page_len, Dh)
        dst[:, 0, :, :n * page_len] = flat
    staging.length = n * page_len
    return staging


def insert_paged_prefill(
    cache: PagedCache, sk: torch.Tensor, sv: torch.Tensor, fresh_pages: list[int],
    pt_row: list[int], slot: int, true_len: int, j0: int,
) -> PagedCache:
    """Admission commit, in place: copy logical pages j0 .. j0+len(fresh_pages)
    of the staging cache (sk/sv [L, 1, Hkv, maxT, Dh]) into their fresh
    physical pages, and install the slot's page-table row and length. Shared
    prefix pages (j < j0) are already resident."""
    L, _, Hkv, page_len, Dh = cache.k.shape
    n = len(fresh_pages)
    if n:
        idx = torch.tensor(fresh_pages, dtype=torch.long, device=cache.k.device)
        for src, dst in ((sk, cache.k), (sv, cache.v)):
            span = src[:, 0, :, j0 * page_len:(j0 + n) * page_len]       # [L, Hkv, n*pl, Dh]
            dst[:, idx] = span.reshape(L, Hkv, n, page_len, Dh).permute(0, 2, 1, 3, 4)
    cache.lengths[slot] = true_len
    cache.page_table[slot] = torch.tensor(pt_row, dtype=torch.int32, device=cache.page_table.device)
    return cache


def gather_pages(pk: torch.Tensor, pv: torch.Tensor, pages: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Read physical ``pages`` out of the pools ([L, P, Hkv, page_len, Dh])
    into one [L, n, Hkv, page_len, Dh] pair, on the pools' device: the
    export half of the handoff. The caller copies them to the host."""
    idx = torch.tensor(pages, dtype=torch.long, device=pk.device)
    return pk.index_select(1, idx), pv.index_select(1, idx)


def scatter_pages(cache: PagedCache, pages: list[int], vals_k: torch.Tensor,
                  vals_v: torch.Tensor) -> PagedCache:
    """Write received pages ([L, n, Hkv, page_len, Dh], any device) into
    physical ``pages`` of the pools, in place: the adopt half of the
    handoff. The caller has alloc()'d the pages, so nothing live is hit."""
    idx = torch.tensor(pages, dtype=torch.long, device=cache.k.device)
    cache.k.index_copy_(1, idx, vals_k.to(cache.k.device, cache.k.dtype))
    cache.v.index_copy_(1, idx, vals_v.to(cache.v.device, cache.v.dtype))
    return cache
