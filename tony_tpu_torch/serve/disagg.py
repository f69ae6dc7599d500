"""Disaggregated serving, engine side: the paged-KV handoff.

Counterpart of the engine half of ``tony_tpu/serve/disagg.py``
(``export_prefix_pages``, ``adopt_pages``, ``ship_pages``). A prefill
replica runs a prompt for one token, exports its finished full-prompt pages
and POSTs them to a decode replica's ``/v1/kv/adopt``; the decode replica
writes them into free pages of its pool, registers them under the same
incremental prefix keys its engine computes at admission, and parks them in
the reuse pool, where the prompt's admission-time ``match_prefix`` finds
them instead of recomputing the prefill.

The wire payload is the JAX package's, byte for byte::

    {"page_len": int, "dtype": "float32" | "bfloat16" | ...,
     "shape": [L, n, Hkv, page_len, Dh], "keys": [[j, sha256-hex], ...],
     "k": base64 of the C-order bytes, "v": the same}

torch has no bf16 ``numpy()`` and the port may not have ``ml_dtypes``, so
bf16 travels as its raw bits through an ``int16`` view. Export and
adopt touch the allocator and the pools, so they run on the engine thread
only (``EngineServer.run_on_engine``).
"""

from __future__ import annotations

import base64
import http.client
import json
from urllib.parse import urlsplit

import numpy as np
import torch

from tony_tpu_torch.models.paged_cache import gather_pages, prefix_keys, scatter_pages
from tony_tpu_torch.obs import metrics as obs_metrics

# the JAX name and shape; serving_http's /stats counts the same pages
_KV_HANDOFF = obs_metrics.counter(
    "tony_serve_kv_handoff_total",
    "KV pages moved through the disaggregated prefill→decode handoff "
    "(exported by the prefill tier / adopted into the decode tier's pool)",
    labelnames=("side",))

#: wire dtype name → (torch dtype, numpy dtype of its bytes); bf16 travels
#: as int16 bits: numpy has no bfloat16 without ml_dtypes
_WIRE_DTYPES = {
    "float32": (torch.float32, np.float32),
    "bfloat16": (torch.bfloat16, np.int16),
}
_WIRE_NAMES = {t: name for name, (t, _) in _WIRE_DTYPES.items()}


def tensor_bytes(t: torch.Tensor) -> bytes:
    """C-order bytes of a host tensor, bf16 through an int16 view."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _tensor_from_bytes(raw: bytes, name: str, shape: tuple[int, ...]) -> torch.Tensor:
    tdtype, ndtype = _WIRE_DTYPES[name]
    arr = np.frombuffer(raw, dtype=ndtype).reshape(shape)
    return torch.from_numpy(arr.copy()).view(tdtype)


def export_prefix_pages(srv, prompt: list[int]) -> dict | None:
    """ENGINE THREAD ONLY. The full-prompt pages this engine holds for
    ``prompt`` as a wire payload, or None when none is resident (the prompt
    spans less than a page, or its pages were evicted since: the decode side
    recomputes). The pages are pinned (``match_prefix``) across the device
    read and the copy to the host, then released."""
    eng = srv.engine
    keys = prefix_keys(prompt, eng.page_len)
    if not keys:
        return None
    pages = eng.allocator.match_prefix(keys)  # pins every matched page
    if not pages:
        return None
    try:
        pk, pv = gather_pages(eng.cache.k, eng.cache.v, pages)
        pk, pv = pk.cpu(), pv.cpu()  # waits for the device read
    finally:
        for p in pages:
            eng.allocator.release(p)
    srv.kv_handoff_exported += len(pages)
    _KV_HANDOFF.inc(len(pages), side="exported")
    return {
        "page_len": int(eng.page_len),
        "dtype": _WIRE_NAMES[pk.dtype],
        "shape": list(pk.shape),                       # [L, n, Hkv, page_len, Dh]
        "keys": [[int(j), d.hex()] for j, d in keys[:len(pages)]],
        "k": base64.b64encode(tensor_bytes(pk)).decode("ascii"),
        "v": base64.b64encode(tensor_bytes(pv)).decode("ascii"),
    }


def adopt_pages(srv, payload: dict) -> tuple[int, int]:
    """ENGINE THREAD ONLY. Adopt shipped pages into this engine's pool:
    alloc free pages, scatter the values in, register them under their
    content keys and release them into the reuse pool. Returns ``(adopted,
    already_resident)``. Adoption takes only free pages, never evicting
    this replica's warm reuse pool. Raises ValueError on a page_len,
    geometry, dtype or size mismatch (serving_http answers 400)."""
    eng = srv.engine
    page_len = int(payload["page_len"])
    if page_len != eng.page_len:
        raise ValueError(f"page_len mismatch: shipped {page_len}, pool {eng.page_len}")
    keys = [(int(j), bytes.fromhex(d)) for j, d in payload["keys"]]
    L, _, Hkv, _, Dh = eng.cache.k.shape
    shape = tuple(int(x) for x in payload["shape"])
    want = (L, len(keys), Hkv, page_len, Dh)
    if shape != want:
        raise ValueError(f"page geometry mismatch: shipped {shape}, want {want}")
    name = str(payload["dtype"])
    pool = _WIRE_NAMES.get(eng.cache.k.dtype, str(eng.cache.k.dtype))
    if name != pool:
        raise ValueError(f"dtype mismatch: shipped {name}, pool {pool}")
    raw_k = base64.b64decode(payload["k"])
    raw_v = base64.b64decode(payload["v"])
    nbytes = int(np.prod(shape)) * eng.cache.k.element_size()
    if len(raw_k) != nbytes or len(raw_v) != nbytes:
        raise ValueError("payload size does not match declared shape")
    alloc = eng.allocator
    fresh = [i for i, key in enumerate(keys) if not alloc.has_key(key)]
    have = len(keys) - len(fresh)
    fresh = fresh[:alloc.free_pages()]
    if not fresh:
        return 0, have
    idx = torch.tensor(fresh, dtype=torch.long)
    vk = _tensor_from_bytes(raw_k, name, shape).index_select(1, idx)
    vv = _tensor_from_bytes(raw_v, name, shape).index_select(1, idx)
    pages = alloc.alloc(len(fresh))
    eng.cache = scatter_pages(eng.cache, pages, vk, vv)
    for p, i in zip(pages, fresh):
        alloc.register(p, keys[i])
        alloc.release(p)  # ref 0 + registered → reusable and matchable
    srv.kv_handoff_adopted += len(fresh)
    _KV_HANDOFF.inc(len(fresh), side="adopted")
    return len(fresh), have


def ship_pages(decode_url: str, exported: dict, timeout_s: float = 30.0) -> tuple[int, int]:
    """POST an export payload to a decode replica's ``/v1/kv/adopt``.
    Returns ``(adopted, already_resident)``; raises on a transport or HTTP
    failure (the caller degrades to a decode-side recompute)."""
    parts = urlsplit(decode_url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=timeout_s)
    try:
        conn.request("POST", "/v1/kv/adopt", json.dumps(exported).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"adopt refused: HTTP {resp.status}: {data[:200]!r}")
        obj = json.loads(data or b"{}")
        return int(obj.get("adopted") or 0), int(obj.get("already_resident") or 0)
    finally:
        conn.close()
