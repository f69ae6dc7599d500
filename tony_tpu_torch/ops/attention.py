"""Attention for training: plain reference, flash kernels, the ``mha`` dispatcher.

Counterpart of ``tony_tpu/ops/attention.py``. Three CUDA kernels
(``csrc/flash_attention.cu``) replace the Pallas TPU kernels of the JAX
module: the forward ``_flash_kernel`` (B1), the dq backward
``_flash_bwd_dq_kernel`` (B2), and both dk/dv backward variants
``_flash_bwd_dkv_kernel_resident`` / ``_flash_bwd_dkv_kernel`` (B3, one
kernel). Each wrapper (``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``)
launches its kernel for CUDA tensors and runs its plain PyTorch version
(``*_plain``) for CPU tensors, never the plain version for a CUDA tensor.
``FlashAttention`` is the one ``torch.autograd.Function`` in place of the
JAX custom VJPs ``_flash_trainable`` and ``_flash_trainable_seg``; its
forward calls B1 through the dispatcher op ``tony::flash_fwd``, so that a
remat policy can see the launch and keep its outputs (the ctypes launch
alone is invisible to ``torch.utils.checkpoint``'s selective mode).

``remat_block`` wraps a decoder block in JAX's three remat policies:
"full", "dots" (keep the products with no batch dimension) and "flash"
(keep the outputs of B1, of the MoE kernel B7 and the values named with
``checkpoint_name``, JAX's ``checkpoint_name`` counterpart).

Layouts follow the JAX package: q ``[B, H, Tq, D]``, k/v ``[B, Hkv, Tk, D]``
(query head h reads kv head h // n_rep, never broadcast on the kernel path),
``segment_ids [B, T]``, lse ``[B, H, Tq]`` f32. The kernels take bf16 or f32,
head_dim 64 or 128, n_rep <= 8 and any lengths (the last tile is ragged);
they choose their own tiles, so the TPU block sizes and tuning knobs
(``block_q``/``block_k``, ``TONY_FLASH_BQ/BK``, the ``ops/tune.py`` cache)
have no counterpart here, and neither have the JAX gates that send
lengths with small blocks to the plain reference: on the card every shape
the kernels take goes to them, and any other raises.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
                                    noop_context_fn)

from tony_tpu_torch.ops import _build

NEG_INF = -1e30

#: kernel launches per wrapper (the chip check reads these to show the
#: training path went through the kernels; only a launch adds to a count)
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_NREP_MAX = 8


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, Hkv, T, D] → [B, Hkv*n_rep, T, D] (GQA head broadcast)."""
    if n_rep == 1:
        return k
    B, H, T, D = k.shape
    return k[:, :, None].expand(B, H, n_rep, T, D).reshape(B, H * n_rep, T, D)


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: float | None = None, segment_ids: torch.Tensor | None = None, window: int = 0,
) -> torch.Tensor:
    """Plain attention; q/k/v [B, H, T, D] (KV already head-broadcast).

    Scores in f32; query i sits at position i + (Tk - Tq). ``segment_ids``
    [B, T] confines attention within each segment; ``window`` > 0 keeps the
    last ``window`` positions (i-window, i]."""
    D = q.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    Tq, Tk = s.shape[-2], s.shape[-1]
    q_pos = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
    k_pos = torch.arange(Tk, device=q.device)[None, :]
    if causal:
        s = s.masked_fill(q_pos < k_pos, NEG_INF)
    if window > 0:
        s = s.masked_fill(q_pos - k_pos >= window, NEG_INF)
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        s = s.masked_fill(~same, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


# -- plain versions of the kernels -------------------------------------------
# One (batch, kv head) group at a time: its n_rep query heads against its K/V,
# all in f32, with the kernels' mask (no Tk - Tq offset, as in the TPU kernels)
# and p = 0 exactly where masked.

def _visible(Tq, Tk, causal, window, seg_b, device):
    """[Tq, Tk] bool: which keys each query row sees."""
    i = torch.arange(Tq, device=device)[:, None]
    j = torch.arange(Tk, device=device)[None, :]
    ok = torch.ones(Tq, Tk, dtype=torch.bool, device=device)
    if causal:
        ok &= i >= j
    if window > 0:
        ok &= i - j < window
    if seg_b is not None:
        ok &= seg_b[:Tq, None] == seg_b[None, :Tk]
    return ok


def _groups(q, k, segment_ids, causal, window):
    """Yield (b, g, heads slice, mask) per (batch, kv head) group."""
    B, H, Tq, _ = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    n_rep = H // Hkv
    for b in range(B):
        ok = _visible(Tq, Tk, causal, window,
                      None if segment_ids is None else segment_ids[b], q.device)
        for g in range(Hkv):
            yield b, g, slice(g * n_rep, (g + 1) * n_rep), ok


def flash_fwd_plain(q, k, v, *, causal=True, segment_ids=None, window=0):
    """Plain B1: (o in q's dtype, lse [B, H, Tq] f32)."""
    scale = q.shape[-1] ** -0.5
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    for b, g, hs, ok in _groups(q, k, segment_ids, causal, window):
        s = (q[b, hs].float() @ k[b, g].float().T) * scale            # [n_rep, Tq, Tk]
        s = s.masked_fill(~ok, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m).masked_fill(~ok, 0.0)
        l = p.sum(-1, keepdim=True).clamp_min(1e-20)
        o[b, hs] = ((p @ v[b, g].float()) / l).to(q.dtype)
        lse[b, hs] = (m + torch.log(l))[..., 0]
    return o, lse


def _probs(qb, kb, lse_b, ok, scale):
    p = torch.exp((qb @ kb.T) * scale - lse_b[..., None])
    return p.masked_fill(~ok, 0.0)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal=True, segment_ids=None, window=0):
    """Plain B2: dq = scale · Σ_k [p ⊙ (do·vᵀ − delta)]·k, in q's dtype."""
    scale = q.shape[-1] ** -0.5
    dq = torch.empty_like(q)
    for b, g, hs, ok in _groups(q, k, segment_ids, causal, window):
        kb, vb = k[b, g].float(), v[b, g].float()
        p = _probs(q[b, hs].float(), kb, lse[b, hs], ok, scale)
        ds = p * (do[b, hs].float() @ vb.T - delta[b, hs][..., None])
        dq[b, hs] = (scale * (ds @ kb)).to(q.dtype)
    return dq


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal=True, segment_ids=None, window=0):
    """Plain B3: dk = scale · Σ dsᵀ·q, dv = Σ pᵀ·do over the group's heads."""
    scale = q.shape[-1] ** -0.5
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for b, g, hs, ok in _groups(q, k, segment_ids, causal, window):
        qb, dob = q[b, hs].float(), do[b, hs].float()
        kb, vb = k[b, g].float(), v[b, g].float()
        p = _probs(qb, kb, lse[b, hs], ok, scale)                    # [n_rep, Tq, Tk]
        ds = p * (dob @ vb.T - delta[b, hs][..., None])
        dv[b, g] = (p.transpose(-1, -2) @ dob).sum(0).to(v.dtype)
        dk[b, g] = (scale * (ds.transpose(-1, -2) @ qb).sum(0)).to(k.dtype)
    return dk, dv


# -- kernel wrappers -----------------------------------------------------------

def _check(tensors: dict, *, dtype, device, segment_ids, H, Hkv, Tq, Tk, D):
    if dtype not in _DTYPES:
        raise TypeError(f"flash attention kernels take bfloat16 or float32, got {dtype}")
    if D not in (64, 128):
        raise ValueError(f"flash attention kernels take head_dim 64 or 128, got {D}")
    if H % Hkv or H // Hkv > _NREP_MAX:
        raise ValueError(f"n_heads {H} must be a multiple of n_kv_heads {Hkv}, at most {_NREP_MAX}x")
    for name, (t, want) in tensors.items():
        if t.device != device or t.dtype != want:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, want {want} on {device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if segment_ids is not None:
        if (segment_ids.device != device or segment_ids.dtype != torch.int32
                or not segment_ids.is_contiguous() or Tq != Tk):
            raise TypeError("segment_ids must be contiguous int32 on the q device, with Tq == Tk")


def _fn(name: str, n_ptr: int):
    fn = getattr(_build.library("flash_attention"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                                                    ctypes.c_void_p]
    return fn


def _ints(q, k, causal, window):
    B, H, Tq, D = q.shape
    return [B, H, k.shape[1], Tq, k.shape[2], D, int(bool(causal)), int(window)]


def flash_fwd(q, k, v, *, causal=True, segment_ids=None, window=0):
    """B1: (o, lse [B, H, Tq] f32). Kernel for CUDA tensors, plain on the CPU."""
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, causal=causal, segment_ids=segment_ids, window=window)
    B, H, Tq, D = q.shape
    _check({"q": (q, q.dtype), "k": (k, q.dtype), "v": (v, q.dtype)}, dtype=q.dtype,
           device=q.device, segment_ids=segment_ids, H=H, Hkv=k.shape[1], Tq=Tq, Tk=k.shape[2], D=D)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    P = _build.ptr
    rc = _fn("tt_flash_fwd", 6)(P(q), P(k), P(v), P(segment_ids), P(o), P(lse),
                                *_ints(q, k, causal, window), D ** -0.5, _DTYPES[q.dtype],
                                _build.stream(q.device))
    _build.check(rc, "flash_fwd")
    launches["flash_fwd"] += 1
    return o, lse


def _bwd_check(q, k, v, do, lse, delta, segment_ids):
    B, H, Tq, D = q.shape
    f32 = torch.float32
    _check({"q": (q, q.dtype), "k": (k, q.dtype), "v": (v, q.dtype), "do": (do, q.dtype),
            "lse": (lse, f32), "delta": (delta, f32)}, dtype=q.dtype, device=q.device,
           segment_ids=segment_ids, H=H, Hkv=k.shape[1], Tq=Tq, Tk=k.shape[2], D=D)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal=True, segment_ids=None, window=0):
    """B2: dq in q's dtype. Kernel for CUDA tensors, plain on the CPU."""
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal,
                                  segment_ids=segment_ids, window=window)
    _bwd_check(q, k, v, do, lse, delta, segment_ids)
    dq = torch.empty_like(q)
    P = _build.ptr
    rc = _fn("tt_flash_bwd_dq", 8)(P(q), P(k), P(v), P(do), P(lse), P(delta), P(segment_ids),
                                   P(dq), *_ints(q, k, causal, window), q.shape[-1] ** -0.5,
                                   _DTYPES[q.dtype], _build.stream(q.device))
    _build.check(rc, "flash_bwd_dq")
    launches["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal=True, segment_ids=None, window=0):
    """B3: (dk, dv) in k's dtype. Kernel for CUDA tensors, plain on the CPU."""
    if not q.is_cuda:
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal,
                                   segment_ids=segment_ids, window=window)
    _bwd_check(q, k, v, do, lse, delta, segment_ids)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    P = _build.ptr
    rc = _fn("tt_flash_bwd_dkv", 9)(P(q), P(k), P(v), P(do), P(lse), P(delta), P(segment_ids),
                                    P(dk), P(dv), *_ints(q, k, causal, window),
                                    q.shape[-1] ** -0.5, _DTYPES[q.dtype], _build.stream(q.device))
    _build.check(rc, "flash_bwd_dkv")
    launches["flash_bwd_dkv"] += 1
    return dk, dv


@torch.library.custom_op("tony::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, segment_ids: torch.Tensor | None,
                 causal: bool, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """B1 as a dispatcher op, so that selective checkpointing sees it: the
    "flash" policy keeps its (o, lse), JAX's ``flash_o`` and ``flash_lse``.
    It calls ``flash_fwd`` (the kernel for CUDA tensors, the plain version
    for CPU tensors)."""
    return flash_fwd(q, k, v, causal=causal, segment_ids=segment_ids, window=window)


@flash_fwd_op.register_fake
def _(q, k, v, segment_ids, causal, window):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


class FlashAttention(torch.autograd.Function):
    """Trainable flash attention: B1 forward, B2 + B3 backward.

    The forward saves q, k, v, o and lse; the backward forms
    ``delta = rowsum(do ⊙ o)`` (outside the kernels, as JAX does) and
    launches dq and dk/dv. ``segment_ids`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal: bool, window: int):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if segment_ids is not None:
            segment_ids = segment_ids.to(torch.int32).contiguous()
        o, lse = flash_fwd_op(q, k, v, segment_ids, causal, window)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        kw = dict(causal=ctx.causal, segment_ids=seg, window=ctx.window)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, segment_ids=None, window: int = 0) -> torch.Tensor:
    """Trainable flash attention, q [B, H, Tq, D], k/v [B, Hkv, Tk, D]: the
    B1-B3 kernels for CUDA tensors (shapes they do not take raise), their
    plain versions for CPU tensors. As in the TPU kernels, query i sits at
    position i whatever Tk is."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"n_heads {H} must be divisible by n_kv_heads {Hkv}")
    if segment_ids is not None and Tq != Tk:
        raise ValueError(f"segment_ids requires Tq == Tk, got {Tq} vs {Tk}")
    return FlashAttention.apply(q, k, v, segment_ids, causal, window)


@torch.library.custom_op("tony::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``jax.ad_checkpoint.checkpoint_name``: ``x`` under ``name``, which the
    "flash" remat policy reads. The value is a copy of ``x`` (a dispatcher
    op may not return its input) and passes the gradient through."""
    return x.clone()


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))


#: the values the "flash" policy keeps, as JAX names them: B1's outputs, the
#: routing and B7's output (the kernel ops stand for their names)
FLASH_SAVE_NAMES = ("flash_o", "flash_lse", "moe_route", "moe_gemm")
_KERNEL_OPS = {"tony::flash_fwd": "flash_o", "tony::moe_fwd": "moe_gemm"}
_DOTS_OPS = {"aten::mm", "aten::addmm"}


def _dots_policy(ctx, func, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: a ``[B, T, D] @ [D, F]``
    reaches the dispatcher as ``mm``; ``bmm``, ``baddbmm``, the kernels and
    every other op are recomputed."""
    if func._schema.name in _DOTS_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _names_policy(names: frozenset, ctx, func, *args, **kwargs):
    """JAX's ``save_only_these_names(*names)``."""
    op = func._schema.name
    name = args[1] if op == "tony::checkpoint_name" else _KERNEL_OPS.get(op)
    return CheckpointPolicy.MUST_SAVE if name in names else CheckpointPolicy.PREFER_RECOMPUTE


def remat_block(block_fn, remat: bool, policy: str = "full"):
    """Wrap a decoder block in the configured remat policy (non-reentrant
    ``torch.utils.checkpoint``).

    "full" recomputes the whole block in the backward, so B1 and B7 run
    twice per layer per step. "dots" keeps the outputs of the products with
    no batch dimension (``_dots_policy``) and recomputes the rest, B1 and B7
    among it. "flash" keeps only B1's (o, lse), B7's output and the routing
    (``FLASH_SAVE_NAMES``), plus the names listed in
    ``TONY_REMAT_EXTRA_NAMES`` ("a,b", for example ``moe_disp,moe_combine``):
    the backward never replays B1 or B7. A name the block does not produce
    keeps nothing."""
    if not remat:
        return block_fn
    if policy == "full":
        context_fn = noop_context_fn
    elif policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    elif policy == "flash":
        extra = os.environ.get("TONY_REMAT_EXTRA_NAMES", "")
        names = frozenset(FLASH_SAVE_NAMES) | {n.strip() for n in extra.split(",") if n.strip()}
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       functools.partial(_names_policy, names))
    else:
        raise ValueError(f"remat_policy must be full|dots|flash, got {policy!r}")

    def wrapped(*args, **kwargs):
        return checkpoint(block_fn, *args, use_reentrant=False, context_fn=context_fn, **kwargs)

    return wrapped


def mha(
    q, k, v, *, causal: bool = True, impl: str = "auto", segment_ids=None, window: int = 0,
) -> torch.Tensor:
    """Dispatcher: ``impl="auto"`` takes the flash kernels for CUDA tensors
    and the plain reference for CPU tensors; ``impl="flash"`` on CPU tensors
    runs the kernels' plain versions through the same autograd function."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"n_heads {q.shape[1]} must be divisible by n_kv_heads {k.shape[1]}")
    if impl == "auto":
        impl = "flash" if q.is_cuda else "reference"
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal, segment_ids=segment_ids, window=window)
    n_rep = q.shape[1] // k.shape[1]
    return attention_reference(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                               causal=causal, segment_ids=segment_ids, window=window)
