"""Weight-only int8 quantization: absmax per output channel + fused dequant matmul.

Counterpart of ``tony_tpu/ops/quant.py``. ``int8_matmul`` runs the CUDA
kernel ``csrc/int8_matmul.cu`` (which replaces the Pallas
``_quant_matmul_kernel`` at ``tony_tpu/ops/quant.py:54``) for every CUDA
tensor, at every M, in one launch: its decode path (M <= 64, streaming the
weight through ``mma.sync``) or its prefill path (TMA + ``wgmma``) —
decode-sized M is where a weight-only kernel earns its bytes, so nothing
routes small shapes elsewhere — and the plain ``int8_matmul_plain`` (the JAX
``int8_matmul_ref``: f32 maths, no bf16 cast of x) for CPU tensors.

Bound on the H100: max((K·N + 2·M·K + 2·M·N) B / 3.35 TB/s, 2·M·K·N / 989 TFLOP/s).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tony_tpu_torch.ops import _build

#: kernel launches of ``int8_matmul`` (only a launch adds to the count)
launches = {"int8_matmul": 0}

#: the largest M the kernel's decode path takes (``DECODE_MAX_M`` in ``csrc/int8_matmul.cu``)
DECODE_MAX_M = 64


def reset_launches() -> None:
    launches["int8_matmul"] = 0


class QTensor(NamedTuple):
    """Per-output-channel absmax int8 quantization of a [..., K, N] weight."""

    q: torch.Tensor      # int8 [..., K, N]
    scale: torch.Tensor  # f32  [..., N] (absmax over the K/contraction dim)


def quantize_int8(w: torch.Tensor) -> QTensor:
    """[..., K, N] float → QTensor; leading dims quantize independently
    (one slice at a time, so the f32 temporaries stay one layer's size)."""
    if w.dim() > 2:
        parts = [quantize_int8(wi) for wi in w]
        return QTensor(torch.stack([p.q for p in parts]), torch.stack([p.scale for p in parts]))
    wf = w.float()
    scale = (wf.abs().amax(dim=-2) / 127.0).clamp_min(1e-8)
    q = torch.round(wf / scale[..., None, :]).clamp(-127, 127).to(torch.int8)
    return QTensor(q, scale)


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (qt.q.float() * qt.scale[..., None, :]).to(dtype)


def int8_matmul_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Plain version: x [.., K] @ dequant [K, N] → [.., N] in x.dtype, f32 maths."""
    return ((x.float() @ qt.q.float()) * qt.scale).to(x.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
# x q scale out ws tickets | M N K splits path | stream
_ARGTYPES = [_P] * 6 + [_I] * 5 + [_P]


@functools.lru_cache(maxsize=None)
def _entry():
    """(the C entry, the C function that plans its K splits), bound once per process."""
    lib = _build.library("int8_matmul")
    fn, plan = lib.tt_int8_matmul, lib.tt_int8_matmul_splits
    fn.restype, fn.argtypes = _I, _ARGTYPES
    plan.restype, plan.argtypes = _I, [_I] * 5
    return fn, plan


@functools.lru_cache(maxsize=None)
def _splits(M: int, N: int, K: int, index: int, path: int) -> int:
    """K splits of a call, from the shapes and the card alone (nothing read on the device)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return _entry()[1](M, N, K, sms, path)


def _launch(x: torch.Tensor, qt: QTensor, path: int = -1) -> torch.Tensor:
    """One launch of the kernel; ``path`` -1 chooses by M (0 forces the decode path,
    M <= 64; 1 the prefill path: for measuring the crossover)."""
    K, N = qt.q.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int8_matmul kernel takes bfloat16 x (the serving dtype), got {x.dtype}")
    if x.shape[-1] != K:
        raise ValueError(f"x [..., {x.shape[-1]}] does not match q [{K}, {N}]")
    if K % 16 or N % 16:
        raise ValueError(f"int8_matmul kernel needs K and N multiples of 16, got {K}, {N}")
    q, scale = qt.q, qt.scale
    if q.dtype != torch.int8 or scale.dtype != torch.float32 or scale.shape != (N,):
        raise TypeError("QTensor must hold int8 q [K, N] and float32 scale [N]")
    xm = x.reshape(-1, K)
    for name, t in (("x", xm), ("q", q), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned, on {x.device}")
    M = xm.shape[0]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out.reshape(*x.shape[:-1], N)
    fn = _entry()[0]
    splits = _splits(M, N, K, x.device.index or 0, path)
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
    tickets = _build.tickets(x.device, -(-M // 128) * -(-N // 128), "int8_matmul") if splits > 1 else None
    rc = fn(_build.ptr(xm), _build.ptr(q), _build.ptr(scale), _build.ptr(out), _build.ptr(ws),
            _build.ptr(tickets), M, N, K, splits, path, _build.stream(x.device))
    _build.check(rc, "int8_matmul")
    return out.reshape(*x.shape[:-1], N)


def int8_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x [..., K] @ QTensor[K, N] → [..., N]: the kernel for CUDA tensors
    (bf16 x; raises on anything it does not take), the plain version for CPU ones."""
    if not x.is_cuda:
        return int8_matmul_plain(x, qt)
    out = _launch(x, qt)
    launches["int8_matmul"] += 1
    return out


_SKIP_SUFFIXES = ("norm", "bias", "scale", "ln")


def quantize_tree(params, min_size: int = 1 << 16):
    """Quantize every >=2-D float leaf with >= min_size elements to QTensor
    (stacked-layer leading dims quantize per layer); norms, biases and small
    leaves stay float. Same two guards as the JAX function: a path segment
    ending in norm/bias/scale/ln, and both trailing dims >= 64.

    Returns (tree-with-QTensor-leaves, bytes_before, bytes_after)."""
    before = after = 0

    def visit(path, leaf):
        nonlocal before, after
        if isinstance(leaf, dict):
            return {k: visit(path + (k,), v) for k, v in leaf.items()}
        sz = leaf.numel() * leaf.element_size()
        before += sz
        segments = [str(k).lower() for k in path]
        named_skip = any(seg.endswith(s) for seg in segments for s in _SKIP_SUFFIXES)
        is_matmul_like = leaf.dim() >= 2 and leaf.shape[-1] >= 64 and leaf.shape[-2] >= 64
        if not named_skip and is_matmul_like and leaf.numel() >= min_size and leaf.is_floating_point():
            qt = quantize_int8(leaf)
            after += qt.q.numel() + qt.scale.numel() * 4
            return qt
        after += sz
        return leaf

    return visit((), params), before, after
