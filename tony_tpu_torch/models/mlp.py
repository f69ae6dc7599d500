"""MNIST-scale MLP classifier (BASELINE config #1: the smallest end-to-end
workload ``tony submit`` runs).

Counterpart of ``tony_tpu/models/mlp.py``: the same ``MLPConfig`` and
parameter tree (``layer_{i}/{w,b}``, ``w`` ``[d_in, d_out]`` used as
``x @ w``), so ``models/convert.py`` carries the JAX package's weights
across unchanged. ``sharding_rules`` are JAX's; the forward refuses a
mesh beyond the data axis (no entry point of the MLP builds one: ROADMAP
queue A8c).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tony_tpu_torch.parallel.mesh import AXIS_FSDP, axis_size, context_degree
from tony_tpu_torch.parallel.sharding import P, ShardingRules


@dataclass(frozen=True)
class MLPConfig:
    input_dim: int = 784
    hidden_dim: int = 512
    num_classes: int = 10
    n_layers: int = 2
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def num_params(self) -> int:
        dims = [self.input_dim] + [self.hidden_dim] * self.n_layers + [self.num_classes]
        return sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))


def init(gen: torch.Generator, cfg: MLPConfig, device: torch.device | str) -> dict:
    """Random tree (``w`` normal · d_in^-0.5, ``b`` 0), drawn on ``device``
    from ``gen``. Its bits differ from the JAX init."""
    dims = [cfg.input_dim] + [cfg.hidden_dim] * cfg.n_layers + [cfg.num_classes]
    params = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn(d_in, d_out, generator=gen, device=device) * d_in ** -0.5
        params[f"layer_{i}"] = {"w": w.to(cfg.tdtype),
                                "b": torch.zeros(d_out, dtype=cfg.tdtype, device=device)}
    return params


def sharding_rules(cfg: MLPConfig) -> ShardingRules:
    """JAX's rules."""
    return ShardingRules([(r"layer_\d+/w", P("fsdp", "model")), (r".*", P())])


def _refuse_mesh(mesh) -> None:
    if context_degree(mesh) > 1 or axis_size(mesh, AXIS_FSDP) > 1:
        raise NotImplementedError(
            "the MLP runs on a data axis only: its forward over the fsdp and model axes of the "
            "JAX model's rules is not ported (ROADMAP queue A8c), and it has no context axis")


def forward(params: dict, x: torch.Tensor, cfg: MLPConfig, mesh=None) -> torch.Tensor:
    _refuse_mesh(mesh)
    n = cfg.n_layers + 1
    for i in range(n):
        lp = params[f"layer_{i}"]
        x = x @ lp["w"] + lp["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def classification_loss(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean of the f32 log-softmax at the labels, negated, and the accuracy
    (JAX's ``argmax == label`` mean)."""
    labels = labels.long()
    logp = F.log_softmax(logits.float(), dim=-1)
    loss = -torch.gather(logp, 1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc


def loss_fn(params: dict, batch: dict, cfg: MLPConfig, mesh=None) -> tuple[torch.Tensor, dict]:
    loss, acc = classification_loss(forward(params, batch["image"], cfg, mesh), batch["label"])
    return loss, {"loss": loss, "accuracy": acc}


def synthetic_batch(gen: torch.Generator, batch_size: int, cfg: MLPConfig) -> dict:
    """``image`` [B, input_dim] f32 uniform in [0, 1), ``label`` uniform over
    the classes, drawn from ``gen`` on its device."""
    dev = gen.device
    return {
        "image": torch.rand(batch_size, cfg.input_dim, generator=gen, device=dev),
        "label": torch.randint(0, cfg.num_classes, (batch_size,), generator=gen, device=dev),
    }
