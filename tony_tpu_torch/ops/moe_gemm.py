"""Grouped SwiGLU expert MLP for MoE: ``ys = silu(xs·Wg[g]) ⊙ (xs·Wu[g]) · Wd[g]``.

Counterpart of ``tony_tpu/ops/moe_gemm.py``. Two CUDA kernels
(``csrc/moe_gemm.cu``) replace the Pallas TPU kernels of the JAX module: the
forward ``_fwd_kernel`` (B7, ``moe_fwd``) and the backward ``_bwd_kernel``
(B8, ``moe_bwd``). Each wrapper launches its kernel for CUDA tensors and runs
its plain PyTorch version (``moe_fwd_plain`` / ``moe_bwd_plain``) for CPU
tensors, never the plain version for a CUDA tensor. ``MoESwiGLU`` is the
``torch.autograd.Function`` in place of the JAX custom VJP; its forward calls
B7 through the dispatcher op ``tony::moe_fwd``, which the "flash" remat
policy keeps (JAX's ``moe_gemm`` name).

Rows arrive sorted by expert with every expert's span padded to whole row
tiles of ``TILE`` = 128 rows (``parallel/expert.route_ragged``), and
``tile_group`` [PN/128] (non-decreasing) names each tile's expert. The
kernels take bfloat16 with D and F multiples of 128; anything else on the
card raises. The TPU tuning knobs (``TONY_MOE_TILE``/``_BWD``/``_FCHUNK``,
the ``ops/tune.py`` cache) and the JAX eligibility gate have no counterpart:
on the card every shape the kernels take goes to them.

Bound on the H100: operations, ``2·N·D·F·3`` (B7) and ``2·N·D·F·8`` (B8)
over 989 TFLOP/s for N routed rows, against ~3·E·D·F·2 bytes of weights.
"""

from __future__ import annotations

import ctypes

import torch

from tony_tpu_torch.ops import _build

#: routing row tile: every expert's span is padded to a multiple of it
TILE = 128

#: kernel launches per wrapper (only a launch adds to a count)
launches = {"moe_fwd": 0, "moe_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def tile_group_map(group_sizes_padded: torch.Tensor, num_tiles: int, tile: int) -> torch.Tensor:
    """[E] padded group sizes → [num_tiles] int32 expert id per row tile.

    Tiles beyond ``sum(group_sizes_padded)`` clamp to the last expert: they
    compute garbage on pad rows that nothing reads and add zero to every
    gradient (their upstream cotangent rows are zero)."""
    bounds = torch.cumsum(group_sizes_padded.to(torch.int64), 0)
    starts = torch.arange(num_tiles, device=bounds.device, dtype=torch.int64) * tile
    idx = torch.searchsorted(bounds, starts, right=True)
    return torch.clamp(idx, max=group_sizes_padded.shape[0] - 1).to(torch.int32)


# -- plain versions of the kernels ----------------------------------------------
# One expert at a time over the rows of its tiles, in f32 maths, rounding h, dg
# and du to the activation dtype where the TPU kernels do.

def _expert_rows(tile_group: torch.Tensor, tile: int, E: int):
    """Yield (expert, row indices) for every expert that owns a row tile."""
    row_group = tile_group.repeat_interleave(tile)
    for e in range(E):
        rows = (row_group == e).nonzero()[:, 0]
        if rows.numel():
            yield e, rows


def _silu_parts(g: torch.Tensor):
    s = torch.sigmoid(g)
    return s, g * s


def moe_fwd_plain(xs, wg, wu, wd, tile_group, tile: int = TILE):
    """Plain B7: ys [PN, D] in xs' dtype, h rounded to xs' dtype before Wd."""
    ys = torch.empty_like(xs)
    for e, rows in _expert_rows(tile_group, tile, wg.shape[0]):
        x = xs[rows].float()
        _, silu_g = _silu_parts(x @ wg[e].float())
        h = (silu_g * (x @ wu[e].float())).to(xs.dtype)
        ys[rows] = (h.float() @ wd[e].float()).to(xs.dtype)
    return ys


def moe_bwd_plain(xs, dy, wg, wu, wd, tile_group, tile: int = TILE):
    """Plain B8: (dxs in xs' dtype, dWg, dWu, dWd summed in f32 per expert and
    cast to the weights' dtype; 0 for an expert that owns no tile)."""
    dt = xs.dtype
    dxs = torch.empty_like(xs)
    dw = [torch.zeros(w.shape, dtype=torch.float32, device=w.device) for w in (wg, wu, wd)]
    for e, rows in _expert_rows(tile_group, tile, wg.shape[0]):
        x, d = xs[rows].float(), dy[rows].float()
        wge, wue, wde = wg[e].float(), wu[e].float(), wd[e].float()
        g, u = x @ wge, x @ wue
        s, silu_g = _silu_parts(g)
        h = (silu_g * u).to(dt).float()
        dh = d @ wde.T
        du = (dh * silu_g).to(dt).float()
        dg = (dh * u * (s * (1.0 + g * (1.0 - s)))).to(dt).float()
        dxs[rows] = (dg @ wge.T + du @ wue.T).to(dt)
        dw[0][e] = x.T @ dg
        dw[1][e] = x.T @ du
        dw[2][e] = h.T @ d
    return (dxs, *(a.to(w.dtype) for a, w in zip(dw, (wg, wu, wd))))


# -- kernel wrappers -----------------------------------------------------------

def _check(xs, wg, wu, wd, tile_group, tile, dy=None):
    PN, D = xs.shape
    E, _, F = wg.shape
    if tile != TILE:
        raise ValueError(f"the MoE kernels take row tiles of {TILE}, got {tile}")
    if PN % TILE or D % 128 or F % 128:
        raise ValueError(f"the MoE kernels need PN ({PN}) a multiple of {TILE} and D ({D}), "
                         f"F ({F}) multiples of 128")
    if wu.shape != (E, D, F) or wd.shape != (E, F, D):
        raise ValueError(f"expert weights {tuple(wg.shape)}, {tuple(wu.shape)}, {tuple(wd.shape)} "
                         f"do not match xs [{PN}, {D}]")
    tensors = {"xs": xs, "wg": wg, "wu": wu, "wd": wd}
    if dy is not None:
        tensors["dy"] = dy
        if dy.shape != xs.shape:
            raise ValueError(f"dy {tuple(dy.shape)} does not match xs {tuple(xs.shape)}")
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the MoE kernels take bfloat16, got {name} {t.dtype}")
        if t.device != xs.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned, on {xs.device}")
    if (tile_group.dtype != torch.int32 or tile_group.device != xs.device
            or tile_group.shape != (PN // TILE,) or not tile_group.is_contiguous()):
        raise TypeError(f"tile_group must be contiguous int32 [{PN // TILE}] on {xs.device}")


def _fn(name: str, n_ptr: int):
    fn = getattr(_build.library("moe_gemm"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def moe_fwd(xs, wg, wu, wd, tile_group, tile: int = TILE):
    """B7: ys [PN, D]. Kernel for CUDA tensors, plain on the CPU."""
    if not xs.is_cuda:
        return moe_fwd_plain(xs, wg, wu, wd, tile_group, tile)
    _check(xs, wg, wu, wd, tile_group, tile)
    PN, D = xs.shape
    E, _, F = wg.shape
    h = torch.empty((PN, F), dtype=xs.dtype, device=xs.device)
    ys = torch.empty_like(xs)
    P = _build.ptr
    rc = _fn("tt_moe_fwd", 7)(P(xs), P(wg), P(wu), P(wd), P(tile_group), P(h), P(ys),
                              PN, D, F, E, _build.stream(xs.device))
    _build.check(rc, "moe_fwd")
    launches["moe_fwd"] += 1
    return ys


def moe_bwd(xs, dy, wg, wu, wd, tile_group, tile: int = TILE):
    """B8: (dxs, dWg, dWu, dWd) in bf16. Kernel for CUDA tensors, plain on the CPU."""
    if not xs.is_cuda:
        return moe_bwd_plain(xs, dy, wg, wu, wd, tile_group, tile)
    _check(xs, wg, wu, wd, tile_group, tile, dy=dy)
    PN, D = xs.shape
    E, _, F = wg.shape
    h, dg, du = (torch.empty((PN, F), dtype=xs.dtype, device=xs.device) for _ in range(3))
    dxs = torch.empty_like(xs)
    dwg, dwu, dwd = torch.empty_like(wg), torch.empty_like(wu), torch.empty_like(wd)
    P = _build.ptr
    rc = _fn("tt_moe_bwd", 13)(P(xs), P(dy), P(wg), P(wu), P(wd), P(tile_group), P(h), P(dg),
                               P(du), P(dxs), P(dwg), P(dwu), P(dwd), PN, D, F, E,
                               _build.stream(xs.device))
    _build.check(rc, "moe_bwd")
    launches["moe_bwd"] += 1
    return dxs, dwg, dwu, dwd


@torch.library.custom_op("tony::moe_fwd", mutates_args=())
def moe_fwd_op(xs: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
               tile_group: torch.Tensor, tile: int) -> torch.Tensor:
    """B7 as a dispatcher op, so that selective checkpointing sees it. It
    calls ``moe_fwd`` (the kernel for CUDA tensors, the plain version for
    CPU tensors)."""
    return moe_fwd(xs, wg, wu, wd, tile_group, tile)


@moe_fwd_op.register_fake
def _(xs, wg, wu, wd, tile_group, tile):
    return torch.empty_like(xs)


class MoESwiGLU(torch.autograd.Function):
    """Trainable grouped SwiGLU: B7 forward, B8 backward (which recomputes
    g and u from the saved inputs, as the TPU kernel does)."""

    @staticmethod
    def forward(ctx, xs, wg, wu, wd, tile_group, tile: int):
        xs, wg, wu, wd = xs.contiguous(), wg.contiguous(), wu.contiguous(), wd.contiguous()
        ys = moe_fwd_op(xs, wg, wu, wd, tile_group, tile)
        ctx.save_for_backward(xs, wg, wu, wd, tile_group)
        ctx.tile = tile
        return ys

    @staticmethod
    def backward(ctx, dy):
        xs, wg, wu, wd, tile_group = ctx.saved_tensors
        dxs, dwg, dwu, dwd = moe_bwd(xs, dy.to(xs.dtype).contiguous(), wg, wu, wd, tile_group,
                                     ctx.tile)
        return dxs, dwg, dwu, dwd, None, None


def moe_swiglu_grouped(xs, wg, wu, wd, tile_group, tile: int = TILE) -> torch.Tensor:
    """``ys[i] = silu(xs[i]·Wg[g]) ⊙ (xs[i]·Wu[g]) · Wd[g]``, ``g = tile_group[i // tile]``.

    xs [PN, D] rows sorted by expert, each span padded to a multiple of
    ``tile``; wg/wu [E, D, F]; wd [E, F, D]; tile_group [PN/tile] int32,
    non-decreasing. Rows inside a span's padding compute garbage the caller
    never reads, and their upstream cotangent must be zero."""
    return MoESwiGLU.apply(xs, wg, wu, wd, tile_group, tile)
