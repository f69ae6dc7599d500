"""Ring attention over the context ring: the hand-written step kernels and their ring.

Counterpart of ``tony_tpu/ops/ring.py``. On the TPU one Pallas kernel per
device runs the whole ring, moving KV shards by remote DMA between
double-buffered slots while it computes on the slot it holds. A CUDA kernel
cannot issue that exchange itself, so the port splits the work: a **step
kernel** (``csrc/ring_attention.cu``) runs once per (held shard, ring
step), and the **transport** (``parallel/collectives``: ``DeviceRing`` or
``ProcessRing``) moves the slots between launches:

- B9 ``ring_fwd_step`` (for ``_ring_fwd_kernel`` :83): folds one KV shard
  into a query shard's online-softmax state, and on the last step writes
  o and lse;
- B10 ``ring_bwd_dq_step`` and ``ring_bwd_dkv_step`` (for
  ``_ring_bwd_kernel`` :380): add one KV shard's contribution to the local
  dq, and the local queries' contribution to the dk/dv accumulators that
  ride the ring with their KV shard. One final rotation brings every
  shard's finished dk/dv home (:642-660).

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (``*_plain``, f32, one (batch, kv head) group at a time)
for CPU tensors, never the plain version for a CUDA tensor. ``RingAttention``
is the one ``torch.autograd.Function`` in place of the JAX custom VJPs of
``ring_attention_pallas`` and ``ring_attention_pallas_seg``, which keep
their names because ``cp_impl`` keeps the value ``"pallas"``.

Tensors hold this process's shards side by side along the sequence (the
whole sequence for a ``DeviceRing``, one shard for a ``ProcessRing``): q
``[B, H, T_held, D]``, k/v ``[B, Hkv, T_held, D]``, segment ids
``[B, T_held]``. The kernels take bf16 or f32, head_dim 64 or 128, n_rep
<= 8 and any per-shard length (the TPU block caps ``TONY_RING_BQ/BK`` and
``_pick_block`` have no counterpart); any other shape raises.
"""

from __future__ import annotations

import ctypes

import torch

from tony_tpu_torch.ops import _build
from tony_tpu_torch.ops.attention import _DTYPES, _NREP_MAX, NEG_INF

#: kernel launches per wrapper (only a launch adds to a count)
launches = {"ring_fwd": 0, "ring_bwd_dq": 0, "ring_bwd_dkv": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# -- the schedule ----------------------------------------------------------------

def _needed(my: int, src: int, Tl: int, window: int) -> bool:
    """Shard ``src``'s keys reach some query of shard ``my`` under the causal
    mask (and the window's lower edge)."""
    ok = src <= my
    if window > 0:
        ok = ok and src * Tl + Tl - 1 >= my * Tl - window + 1
    return ok


def fwd_step_runs(my: int, s: int, n: int, Tl: int, causal: bool, window: int) -> bool:
    """Whether the forward launches step ``s`` for shard ``my`` (``ring.py:260-272``):
    a causal ring skips a shard wholly in the future or below the window,
    but always runs the first step (its own shard) and the last (it writes o)."""
    if not causal or s == 0 or s == n - 1:
        return True
    return _needed(my, (my - s) % n, Tl, window)


def bwd_step_runs(my: int, s: int, n: int, Tl: int, causal: bool, window: int) -> bool:
    """Whether the backward launches step ``s`` for shard ``my`` (``ring.py:599-610``);
    a skipped step's accumulators still ride the ring."""
    if not causal or s == 0:
        return True
    return _needed(my, (my - s) % n, Tl, window)


# -- plain versions of the kernels ----------------------------------------------------
# The step of shard ``my`` holding KV shard ``src``: queries at global positions
# q_pos0 + i, keys at k_pos0 + j. One (batch, kv head) group at a time, all in f32,
# p = 0 exactly where masked.

def _visible(Tl, q_pos0, k_pos0, causal, window, segq_b, segk_b, device):
    """[Tl, Tl] bool: which keys of the held shard each query row sees."""
    i = q_pos0 + torch.arange(Tl, device=device)[:, None]
    j = k_pos0 + torch.arange(Tl, device=device)[None, :]
    ok = torch.ones(Tl, Tl, dtype=torch.bool, device=device)
    if causal:
        ok &= i >= j
    if window > 0:
        ok &= j > i - window
    if segq_b is not None:
        ok &= segq_b[:, None] == segk_b[None, k_pos0:k_pos0 + Tl]
    return ok


def _groups(q, k, q_pos0, k_pos0, causal, window, segq, segk):
    """Yield (b, g, heads slice, mask) per (batch, kv head) group."""
    B, H, Tl, _ = q.shape
    Hkv = k.shape[1]
    n_rep = H // Hkv
    for b in range(B):
        ok = _visible(Tl, q_pos0, k_pos0, causal, window, None if segq is None else segq[b],
                      None if segk is None else segk[b], q.device)
        for g in range(Hkv):
            yield b, g, slice(g * n_rep, (g + 1) * n_rep), ok


def ring_fwd_step_plain(q, k, v, acc, m, l, o, lse, *, q_pos0, k_pos0, causal=True, window=0,
                        segq=None, segk=None, first=False, last=False):
    """Plain B9: fold KV shard (k, v) into the state (acc, m, l) of query
    shard q, in place; ``first`` starts the state, ``last`` writes o and lse."""
    scale = q.shape[-1] ** -0.5
    for b, g, hs, ok in _groups(q, k, q_pos0, k_pos0, causal, window, segq, segk):
        s = (q[b, hs].float() @ k[b, g].float().T) * scale            # [n_rep, Tl, Tl]
        s = s.masked_fill(~ok, NEG_INF)
        if first:
            m_old = torch.full(s.shape[:2], NEG_INF, device=q.device)
            l_old = torch.zeros(s.shape[:2], device=q.device)
            a_old = torch.zeros(q[b, hs].shape, device=q.device)
        else:
            m_old, l_old, a_old = m[b, hs], l[b, hs], acc[b, hs]
        m_new = torch.maximum(m_old, s.amax(-1))
        alpha = torch.exp(m_old - m_new)
        p = torch.exp(s - m_new[..., None]).masked_fill(~ok, 0.0)
        l_new = l_old * alpha + p.sum(-1)
        a_new = a_old * alpha[..., None] + p @ v[b, g].float()
        if last:
            lc = l_new.clamp_min(1e-20)
            o[b, hs] = (a_new / lc[..., None]).to(o.dtype)
            lse[b, hs] = m_new + torch.log(lc)
        else:
            acc[b, hs], m[b, hs], l[b, hs] = a_new, m_new, l_new


def _bwd_group(q, k, v, do, lse, delta, b, g, hs, ok, scale):
    kb, vb = k[b, g].float(), v[b, g].float()
    qb, dob = q[b, hs].float(), do[b, hs].float()
    p = torch.exp((qb @ kb.T) * scale - lse[b, hs][..., None]).masked_fill(~ok, 0.0)
    ds = p * (dob @ vb.T - delta[b, hs][..., None])
    return qb, dob, kb, p, ds


def ring_bwd_dq_step_plain(q, k, v, do, lse, delta, dq, *, q_pos0, k_pos0, causal=True, window=0,
                           segq=None, segk=None):
    """Plain B10 (dq): dq (f32, in place) += scale · Σ_k ds·k over the held KV shard."""
    scale = q.shape[-1] ** -0.5
    for b, g, hs, ok in _groups(q, k, q_pos0, k_pos0, causal, window, segq, segk):
        _, _, kb, _, ds = _bwd_group(q, k, v, do, lse, delta, b, g, hs, ok, scale)
        dq[b, hs] += scale * (ds @ kb)


def ring_bwd_dkv_step_plain(q, k, v, do, lse, delta, dk, dv, *, q_pos0, k_pos0, causal=True,
                            window=0, segq=None, segk=None):
    """Plain B10 (dk/dv): the riding accumulators (f32, in place) += scale ·
    Σ dsᵀ·q and Σ pᵀ·do over the local queries of the group's heads."""
    scale = q.shape[-1] ** -0.5
    for b, g, hs, ok in _groups(q, k, q_pos0, k_pos0, causal, window, segq, segk):
        qb, dob, _, p, ds = _bwd_group(q, k, v, do, lse, delta, b, g, hs, ok, scale)
        dv[b, g] += (p.transpose(-1, -2) @ dob).sum(0)
        dk[b, g] += scale * (ds.transpose(-1, -2) @ qb).sum(0)


# -- kernel wrappers -------------------------------------------------------------------

def _layout(name, t, dtype, device, shape, P):
    """Check one tensor: its type, device and shape, and its rows at the
    layout of a [B, h, P(, D)] tensor (strides of size-1 dims are free).
    Rows of D are read 16 bytes at a time and must be 16-byte aligned; the
    per-row vectors are read one element at a time."""
    if t.device != device or t.dtype != dtype:
        raise TypeError(f"{name}: {t.dtype} on {t.device}, want {dtype} on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
    want = ((shape[1] * P * shape[3], P * shape[3], shape[3], 1) if len(shape) == 4
            else (shape[1] * P, P, 1) if len(shape) == 3 else (P, 1))
    if any(n > 1 and st != w for n, st, w in zip(t.shape, t.stride(), want)):
        raise ValueError(f"{name}: strides {t.stride()}, want {want}")
    if len(shape) == 4 and t.data_ptr() % 16:
        raise ValueError(f"{name}: rows not 16-byte aligned")


def _check(q, k, rows: dict, shards: dict, segq, segk):
    """Shapes and layouts the kernels take. ``rows``: name → (tensor, dtype,
    with_D) of this shard's rows in [B, H, P(, D)]; ``shards``: name →
    (tensor, dtype) of one contiguous [B, Hkv, Tl, D] shard. Returns (P, Tseg)."""
    B, H, Tl, D = q.shape
    Hkv = k.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"ring attention kernels take bfloat16 or float32, got {q.dtype}")
    if D not in (64, 128):
        raise ValueError(f"ring attention kernels take head_dim 64 or 128, got {D}")
    if H % Hkv or H // Hkv > _NREP_MAX:
        raise ValueError(f"n_heads {H} must be a multiple of n_kv_heads {Hkv}, at most {_NREP_MAX}x")
    P = q.stride(1) // D if H > 1 else q.stride(0) // (H * D) if B > 1 else Tl
    if P < Tl:
        raise ValueError(f"q: strides {q.stride()} overlap its {Tl} rows")
    for name, (t, dtype, with_d) in {"q": (q, q.dtype, True), **rows}.items():
        _layout(name, t, dtype, q.device, (B, H, Tl, D) if with_d else (B, H, Tl), P)
    for name, (t, dtype) in shards.items():
        _layout(name, t, dtype, q.device, (B, Hkv, Tl, D), Tl)
    if (segq is None) != (segk is None):
        raise ValueError("segq and segk come together")
    if segq is None:
        return P, 0
    _layout("segq", segq, torch.int32, q.device, (B, Tl), P)
    _layout("segk", segk, torch.int32, q.device, (B, segk.shape[1]), segk.shape[1])
    return P, segk.shape[1]


def _fn(name: str, n_ptr: int, n_int: int):
    fn = getattr(_build.library("ring_attention"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _ints(q, k, P, Tseg, q_pos0, k_pos0, causal, window):
    B, H, Tl, _ = q.shape
    return [B, H, k.shape[1], Tl, P, Tseg, int(q_pos0), int(k_pos0), int(bool(causal)), int(window)]


def _tail(q):
    D = q.shape[-1]
    return [D, D ** -0.5, _DTYPES[q.dtype], _build.stream(q.device)]


def ring_fwd_step(q, k, v, acc, m, l, o, lse, *, q_pos0, k_pos0, causal=True, window=0,
                  segq=None, segk=None, first=False, last=False):
    """B9: one forward step, in place on (acc, m, l), or (o, lse) when
    ``last``. Kernel for CUDA tensors, plain on the CPU."""
    kw = dict(q_pos0=q_pos0, k_pos0=k_pos0, causal=causal, window=window, segq=segq, segk=segk)
    if not q.is_cuda:
        return ring_fwd_step_plain(q, k, v, acc, m, l, o, lse, first=first, last=last, **kw)
    f32 = torch.float32
    P, Tseg = _check(q, k, {"acc": (acc, f32, True), "m": (m, f32, False), "l": (l, f32, False),
                            "o": (o, q.dtype, True), "lse": (lse, f32, False)},
                     {"k": (k, q.dtype), "v": (v, q.dtype)}, segq, segk)
    P_ = _build.ptr
    rc = _fn("tt_ring_fwd_step", 10, 12)(
        P_(q), P_(k), P_(v), P_(segq), P_(segk), P_(acc), P_(m), P_(l), P_(o), P_(lse),
        *_ints(q, k, P, Tseg, q_pos0, k_pos0, causal, window), int(first), int(last), *_tail(q))
    _build.check(rc, "ring_fwd_step")
    launches["ring_fwd"] += 1


def _bwd_check(q, k, v, do, lse, delta, segq, segk, dq=None, dk=None, dv=None):
    f32 = torch.float32
    rows = {"do": (do, q.dtype, True), "lse": (lse, f32, False), "delta": (delta, f32, False)}
    shards = {"k": (k, q.dtype), "v": (v, q.dtype)}
    if dq is not None:
        rows["dq"] = (dq, f32, True)
    else:
        shards.update(dk=(dk, f32), dv=(dv, f32))
    return _check(q, k, rows, shards, segq, segk)


def ring_bwd_dq_step(q, k, v, do, lse, delta, dq, *, q_pos0, k_pos0, causal=True, window=0,
                     segq=None, segk=None):
    """B10 (dq): dq (f32) += this step's contribution. Kernel for CUDA tensors."""
    kw = dict(q_pos0=q_pos0, k_pos0=k_pos0, causal=causal, window=window, segq=segq, segk=segk)
    if not q.is_cuda:
        return ring_bwd_dq_step_plain(q, k, v, do, lse, delta, dq, **kw)
    P, Tseg = _bwd_check(q, k, v, do, lse, delta, segq, segk, dq=dq)
    P_ = _build.ptr
    rc = _fn("tt_ring_bwd_dq_step", 9, 10)(
        P_(q), P_(k), P_(v), P_(do), P_(lse), P_(delta), P_(segq), P_(segk), P_(dq),
        *_ints(q, k, P, Tseg, q_pos0, k_pos0, causal, window), *_tail(q))
    _build.check(rc, "ring_bwd_dq_step")
    launches["ring_bwd_dq"] += 1


def ring_bwd_dkv_step(q, k, v, do, lse, delta, dk, dv, *, q_pos0, k_pos0, causal=True, window=0,
                      segq=None, segk=None):
    """B10 (dk/dv): the riding accumulators (f32) += this step's
    contribution. Kernel for CUDA tensors."""
    kw = dict(q_pos0=q_pos0, k_pos0=k_pos0, causal=causal, window=window, segq=segq, segk=segk)
    if not q.is_cuda:
        return ring_bwd_dkv_step_plain(q, k, v, do, lse, delta, dk, dv, **kw)
    P, Tseg = _bwd_check(q, k, v, do, lse, delta, segq, segk, dk=dk, dv=dv)
    P_ = _build.ptr
    rc = _fn("tt_ring_bwd_dkv_step", 10, 10)(
        P_(q), P_(k), P_(v), P_(do), P_(lse), P_(delta), P_(segq), P_(segk), P_(dk), P_(dv),
        *_ints(q, k, P, Tseg, q_pos0, k_pos0, causal, window), *_tail(q))
    _build.check(rc, "ring_bwd_dkv_step")
    launches["ring_bwd_dkv"] += 1


# -- the ring --------------------------------------------------------------------------

def _stage(x, held, Tl):
    """[B, h, held·Tl, D] → a slot pair [2, held, B, h, Tl, D], this process's
    shards in slot 0 (each shard contiguous, as the kernels read them)."""
    B, h, _, D = x.shape
    slots = torch.empty((2, held, B, h, Tl, D), dtype=x.dtype, device=x.device)
    slots[0].copy_(x.view(B, h, held, Tl, D).permute(2, 0, 1, 3, 4))
    return slots


def _unstage(x):
    """[held, B, h, Tl, D] → [B, h, held·Tl, D]."""
    held, B, h, Tl, D = x.shape
    return x.permute(1, 2, 0, 3, 4).reshape(B, h, held * Tl, D)


def _segments(ring, segment_ids):
    """(this process's ids [B, T_held] int32, the global table [B, T]):
    gathered once over the transport (``_seg_layouts`` :294), no ring traffic."""
    if segment_ids is None:
        return None, None
    segq = segment_ids.to(torch.int32).contiguous()
    return segq, ring.all_gather(ring.split(segq, 1), 1).contiguous()


def _geometry(q, k, ring):
    B, H, T_held, D = q.shape
    held = len(ring.positions)
    if H % k.shape[1]:
        raise ValueError(f"n_heads {H} must be divisible by n_kv_heads {k.shape[1]}")
    if T_held % held:
        raise ValueError(f"sequence {T_held} does not split into {held} context shards")
    return held, T_held // held


def _ring_fwd(q, k, v, ring, causal, window, segq, segk):
    held, Tl = _geometry(q, k, ring)
    n = ring.n
    kb, vb = _stage(k, held, Tl), _stage(v, held, Tl)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty(q.shape, **f32)
    m, l, lse = (torch.empty(q.shape[:3], **f32) for _ in range(3))
    o = torch.empty_like(q)
    for s in range(n):
        cur, nxt = s % 2, (s + 1) % 2
        # the rotation of slot `cur` into the neighbour's slot `nxt` runs beside this step
        moving = ring.send_recv([kb[cur], vb[cur]], [kb[nxt], vb[nxt]]) if s < n - 1 else None
        for i, my in enumerate(ring.positions):
            if not fwd_step_runs(my, s, n, Tl, causal, window):
                continue
            sl = slice(i * Tl, (i + 1) * Tl)
            ring_fwd_step(q[:, :, sl], kb[cur, i], vb[cur, i], acc[:, :, sl], m[:, :, sl], l[:, :, sl],
                          o[:, :, sl], lse[:, :, sl], q_pos0=my * Tl, k_pos0=((my - s) % n) * Tl,
                          causal=causal, window=window,
                          segq=None if segq is None else segq[:, sl], segk=segk,
                          first=s == 0, last=s == n - 1)
        if moving is not None:
            moving.wait()
    return o, lse


def _deliver_home(ring, dk_acc, dv_acc):
    """The final rotation: the slot each shard holds after the last step is
    its right neighbour's finished dk/dv, sent home (``ring.py:642-660``)."""
    if ring.n == 1:
        return dk_acc, dv_acc
    dk, dv = torch.empty_like(dk_acc), torch.empty_like(dv_acc)
    ring.send_recv([dk_acc, dv_acc], [dk, dv]).wait()
    return dk, dv


def _ring_bwd(q, k, v, o, lse, do, ring, causal, window, segq, segk):
    held, Tl = _geometry(q, k, ring)
    n = ring.n
    delta = (do.float() * o.float()).sum(-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kb, vb = _stage(k, held, Tl), _stage(v, held, Tl)
    dkb = torch.empty(kb.shape, dtype=torch.float32, device=q.device)
    dvb = torch.empty_like(dkb)
    dkb[0].zero_()
    dvb[0].zero_()
    for s in range(n):
        cur, nxt = s % 2, (s + 1) % 2
        # kv is read-only: its rotation runs beside this step; dk/dv ship after it
        moving = ring.send_recv([kb[cur], vb[cur]], [kb[nxt], vb[nxt]]) if s < n - 1 else None
        for i, my in enumerate(ring.positions):
            if not bwd_step_runs(my, s, n, Tl, causal, window):
                continue
            sl = slice(i * Tl, (i + 1) * Tl)
            args = (q[:, :, sl], kb[cur, i], vb[cur, i], do[:, :, sl], lse[:, :, sl], delta[:, :, sl])
            kw = dict(q_pos0=my * Tl, k_pos0=((my - s) % n) * Tl, causal=causal, window=window,
                      segq=None if segq is None else segq[:, sl], segk=segk)
            ring_bwd_dq_step(*args, dq[:, :, sl], **kw)
            ring_bwd_dkv_step(*args, dkb[cur, i], dvb[cur, i], **kw)
        if moving is not None:
            shipped = ring.send_recv([dkb[cur], dvb[cur]], [dkb[nxt], dvb[nxt]])
            moving.wait()
            shipped.wait()
    dk, dv = _deliver_home(ring, dkb[(n - 1) % 2], dvb[(n - 1) % 2])
    return dq.to(q.dtype), _unstage(dk).to(k.dtype), _unstage(dv).to(v.dtype)


class RingAttention(torch.autograd.Function):
    """Trainable ring attention: B9 forward, B10 backward, over ``ring``.

    The forward saves q, k, v, o and lse; the backward forms
    ``delta = rowsum(do ⊙ o)`` outside the kernels (as JAX does, :682-685)
    and runs the backward ring. ``segment_ids`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, ring, causal: bool, window: int):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        segq, segk = _segments(ring, segment_ids)
        o, lse = _ring_fwd(q, k, v, ring, causal, window, segq, segk)
        ctx.save_for_backward(q, k, v, o, lse, segq, segk)
        ctx.ring, ctx.causal, ctx.window = ring, causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segq, segk = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, o, lse, do.contiguous(), ctx.ring, ctx.causal, ctx.window,
                               segq, segk)
        return dq, dk, dv, None, None, None, None


def ring_attention_pallas(q, k, v, ring, causal: bool = True, window: int = 0) -> torch.Tensor:
    """Ring attention through the step kernels, q [B, H, T_held, D], k/v
    [B, Hkv, T_held, D] (this process's shards of the sequence), GQA-native.
    ``window`` > 0 adds the sliding-window band: below-band tiles and whole
    shards are skipped in the forward and the backward."""
    return RingAttention.apply(q, k, v, None, ring, causal, window)


def ring_attention_pallas_seg(q, k, v, segment_ids, ring, causal: bool = True,
                              window: int = 0) -> torch.Tensor:
    """Packed-sequence ring attention: ``segment_ids`` [B, T_held] are this
    process's slice of the packed layout (ids global per row); the global
    table is gathered once over the transport."""
    return RingAttention.apply(q, k, v, segment_ids, ring, causal, window)
