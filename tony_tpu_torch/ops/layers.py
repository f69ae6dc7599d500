"""Normalisation / RoPE / SwiGLU building blocks, plain PyTorch.

Counterpart of ``tony_tpu/ops/layers.py`` (the serving subset). These have
no TPU kernel behind them in the JAX package (XLA fuses them), so they stay
plain tensor code here. Rounding order follows the JAX functions exactly.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: normalise in f32, cast to x's dtype, then scale by weight."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rope_frequencies(
    dim: int, max_seq: int, theta: float = 10000.0, scaling: tuple = (),
    device: torch.device | str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [max_seq, dim//2] in f32.

    ``scaling``: () | ("linear", factor) | ("llama3", factor, low_freq_factor,
    high_freq_factor, original_max) — Llama-3.1 frequency-band scaling."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    if scaling:
        kind = scaling[0]
        if kind == "linear":
            t = t / float(scaling[1])
        elif kind == "llama3":
            factor, lo, hi, orig = (float(s) for s in scaling[1:])
            wavelen = 2.0 * math.pi / inv_freq
            smooth = (orig / wavelen - lo) / (hi - lo)
            inv_freq = torch.where(
                wavelen > orig / lo,                       # low-frequency band
                inv_freq / factor,
                torch.where(
                    wavelen < orig / hi,                   # high-frequency band
                    inv_freq,
                    (1.0 - smooth) * inv_freq / factor + smooth * inv_freq,
                ),
            )
        else:
            raise ValueError(f"unknown rope scaling kind {kind!r} (linear|llama3)")
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor | None = None
) -> torch.Tensor:
    """Rotary embedding over split halves; x [B, H, T, D], tables [>=T, D//2].

    ``positions``: [T] shared, or [B, T] per batch row."""
    T = x.shape[-2]
    if positions is None:
        c, s = cos[:T], sin[:T]
    else:
        c, s = cos[positions], sin[positions]
        if positions.dim() == 2:  # [B, T, D/2] → broadcast over heads
            c, s = c[:, None], s[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (silu(x@Wg) * (x@Wu)) @ Wd."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
