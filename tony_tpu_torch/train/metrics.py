"""Throughput/MFU accounting.

Counterpart of ``tony_tpu/train/metrics.py`` with the port's own peak
table: MFU = model_flops_per_token * tokens_per_sec / (peak * devices).
"""

from __future__ import annotations

import torch

# bf16 dense tensor-core peak FLOP/s per card (NVIDIA data sheets, SXM parts)
PEAK_FLOPS = {
    "h100": 989e12,
    "h200": 989e12,
    "cpu": 1e12,  # nominal; keeps MFU finite in CPU runs (not a device metric)
}


def detect_peak_flops(device: torch.device | str | None = None) -> float:
    """The peak of the card ``device`` names (``torch.cuda.get_device_name``),
    or the nominal CPU entry for the CPU."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type != "cuda":
        return PEAK_FLOPS["cpu"]
    kind = torch.cuda.get_device_name(dev).lower()
    for name, peak in PEAK_FLOPS.items():
        if name in kind:
            return peak
    raise ValueError(f"no peak FLOP/s entry for {kind!r}; add it to PEAK_FLOPS")


def flops_per_token_for_batch(model_cfg, batch: dict, seq_len: int) -> int:
    """The model's flops/token on this batch layout (gathered-MLM batches
    project only the masked fraction through the vocab head)."""
    if "masked_pos" in batch:
        return model_cfg.flops_per_token(batch["masked_pos"].shape[1] / seq_len)
    return model_cfg.flops_per_token()


def transformer_flops_per_token(
    n_params: int, n_layers: int, d_model: int, seq_len: int, *, training: bool = True
) -> int:
    """6N (fwd+bwd) + causal-attention term 12·L·D·T (PaLM appendix formula)."""
    mult = 6 if training else 2
    attn = (12 if training else 4) * n_layers * d_model * seq_len // 2  # causal halves it
    return mult * n_params + attn
