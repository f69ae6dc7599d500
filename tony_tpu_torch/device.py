"""Device resolution: ``cuda`` by default, the CPU only when asked for."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None``/``"cuda"`` → the current CUDA device; ``"cpu"`` → the CPU.

    Raises when a CUDA device is wanted and none is visible: the port never
    falls back to the CPU quietly (a CPU run is a different measurement)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' (or --device cpu) "
            "to run the port's plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda|cpu)")
    return dev
