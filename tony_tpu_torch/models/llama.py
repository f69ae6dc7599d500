"""Llama-family decoder config and random init (serving subset).

Counterpart of ``tony_tpu/models/llama.py``: the same ``LlamaConfig``
fields, the same presets and the same parameter tree — a nested dict with
stacked layers (leading dim L on every block weight), weights ``[K, N]``
used as ``x @ w``. ``forward``/``loss_fn``, sharding rules and the CP/PP
branches belong to the training slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14_336
    max_seq: int = 8192
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"
    attn_impl: str = "auto"
    cp_impl: str = "xla"
    ce_chunk: int = 512
    sliding_window: int = 0
    rope_scaling: tuple = ()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def tdtype(self) -> torch.dtype:
        """The torch dtype named by ``dtype`` (the JAX config's ``jdtype``)."""
        return getattr(torch, self.dtype)

    def num_params(self) -> int:
        D, F, V, Dh = self.d_model, self.d_ff, self.vocab_size, self.head_dim
        per_layer = (
            D * self.n_heads * Dh
            + 2 * D * self.n_kv_heads * Dh
            + self.n_heads * Dh * D
            + 3 * D * F
            + 2 * D
        )
        return V * D + self.n_layers * per_layer + D + D * V


LLAMA3_8B = LlamaConfig()
LLAMA_1B = LlamaConfig(
    vocab_size=32_000, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=8,
    d_ff=5504, max_seq=2048,
)
LLAMA_TINY = LlamaConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=128, remat=False, attn_impl="reference",
)

PRESETS = {"llama3-8b": LLAMA3_8B, "llama-1b": LLAMA_1B, "tiny": LLAMA_TINY}


def init(gen: torch.Generator, cfg: LlamaConfig, device: torch.device | str) -> dict:
    """Random parameter tree (truncated normal in [-2, 2] · fan_in^-0.5),
    drawn on ``device`` from ``gen`` (a generator on that device). Stacked
    weights are drawn one layer at a time so the f32 temporaries stay one
    layer's size at full width. Its bits differ from the JAX init."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    Dh, H, Hkv, Lyr = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    dt = cfg.tdtype

    def norm_init(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def draw(shape, fan_in):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (t * fan_in ** -0.5).to(dt)

    def dense(*shape, fan_in):
        if len(shape) == 3:
            out = torch.empty(shape, dtype=dt, device=device)
            for i in range(shape[0]):
                out[i] = draw(shape[1:], fan_in)
            return out
        return draw(shape, fan_in)

    return {
        "embed": dense(V, D, fan_in=1.0),
        "layers": {
            "attn_norm": norm_init(Lyr, D),
            "wq": dense(Lyr, D, H * Dh, fan_in=D),
            "wk": dense(Lyr, D, Hkv * Dh, fan_in=D),
            "wv": dense(Lyr, D, Hkv * Dh, fan_in=D),
            "wo": dense(Lyr, H * Dh, D, fan_in=H * Dh),
            "mlp_norm": norm_init(Lyr, D),
            "w_gate": dense(Lyr, D, F, fan_in=D),
            "w_up": dense(Lyr, D, F, fan_in=D),
            "w_down": dense(Lyr, F, D, fan_in=F),
        },
        "final_norm": norm_init(D),
        "lm_head": dense(D, V, fan_in=D),
    }


def config_from_dict(d) -> LlamaConfig:
    if isinstance(d, str):
        return PRESETS[d]
    fields = {f.name for f in dataclasses.fields(LlamaConfig)}
    return dataclasses.replace(
        PRESETS.get(d.get("preset", ""), LlamaConfig()),
        **{k: v for k, v in d.items() if k in fields},
    )
