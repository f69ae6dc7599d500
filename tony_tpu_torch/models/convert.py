"""Weight bridge: the JAX package's parameter tree → the port's tensors.

``params_from_numpy(tree, device)`` takes the nested dict that
``jax.tree.map(np.asarray, params)`` gives (``QTensor(q, scale)`` leaves
included, as any ``(q, scale)`` named tuple) and returns the same tree of
torch tensors, layouts unchanged. bf16 arrays arrive with ``ml_dtypes``'
``bfloat16`` dtype, which ``torch.from_numpy`` refuses: they are viewed as
uint16 and reinterpreted as ``torch.bfloat16`` bit for bit, with neither
``ml_dtypes`` nor ``jax`` imported. HF checkpoint loading is a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from tony_tpu_torch.ops.quant import QTensor


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_numpy(tree, device):
    """Nested dict of numpy arrays / (q, scale) pairs → the same of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields") and set(tree._fields) == {"q", "scale"}:
        return QTensor(tensor_from_numpy(tree.q, device), tensor_from_numpy(tree.scale, device))
    return tensor_from_numpy(tree, device)
