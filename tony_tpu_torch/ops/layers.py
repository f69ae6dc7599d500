"""Normalisation / RoPE / MLP / cross-entropy building blocks, plain PyTorch.

Counterpart of ``tony_tpu/ops/layers.py``. These have no TPU kernel behind
them in the JAX package (XLA fuses them), so they stay plain tensor code
here. Rounding order follows the JAX functions exactly.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: normalise in f32, cast to x's dtype, then scale by weight."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm: statistics in f32, cast to x's dtype, then scale and shift."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * weight + bias


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


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor, w_out: torch.Tensor,
             b_out: torch.Tensor) -> torch.Tensor:
    """gelu(x@Wi + bi) @ Wo + bo, with the tanh approximation (jax.nn.gelu's default)."""
    return F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out + b_out


def cross_entropy_loss(
    logits: torch.Tensor, targets: torch.Tensor, ignore_index: int = -100
) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-mean CE in f32; returns (loss, n_valid_tokens)."""
    mask = targets != ignore_index
    safe = torch.where(mask, targets, 0)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    n = mask.sum().clamp_min(1)
    return nll.sum() / n, n


def _chunk_nll(xc: torch.Tensor, tc: torch.Tensor, lm_head: torch.Tensor, ignore_index: int) -> torch.Tensor:
    logits = (xc @ lm_head).float()
    mask = tc != ignore_index
    safe = torch.where(mask, tc, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    return ((logz - gold) * mask).sum()


def chunked_cross_entropy_loss(
    x: torch.Tensor, lm_head: torch.Tensor, targets: torch.Tensor,
    ignore_index: int = -100, chunk: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused lm-head + CE that never holds the [B, T, V] logits.

    Each sequence chunk's logits, logsumexp and gold logit are computed
    under ``torch.utils.checkpoint``, so only one chunk's [B, chunk, V]
    logits live at a time in the forward and the backward recomputes them.
    The sequence is padded to a chunk multiple with ignored targets.
    x: [B, T, D]; lm_head: [D, V]; targets: [B, T]. The logits are the
    matmul's output in x's dtype, widened to f32 (JAX asks XLA for an f32
    product; the two agree exactly in f32)."""
    B, T, D = x.shape
    chunk = T if chunk <= 0 else min(chunk, T)
    pad = (-T) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=ignore_index)
        T += pad
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, T, chunk):
        total = total + checkpoint(_chunk_nll, x[:, c0:c0 + chunk], targets[:, c0:c0 + chunk],
                                   lm_head, ignore_index, use_reentrant=False)
    n = (targets != ignore_index).sum().clamp_min(1)
    return total / n, n
