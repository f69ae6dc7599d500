"""BERT-style bidirectional encoder with an MLM head (BASELINE config #2).

Counterpart of ``tony_tpu/models/bert.py``: the same ``BertConfig`` fields,
presets and parameter tree (stacked ``layers`` leaves with a leading L,
weights ``[K, N]`` used as ``x @ w``), so ``models/convert.py`` carries the
JAX package's weights across unchanged. Post-norm blocks: fused qkv with
bias, non-causal ``mha`` (B1-B3 on the card, confined within packed
segments), the ``wo`` residual and LayerNorm, then the tanh-GELU MLP and
LayerNorm. ``cfg.remat`` checkpoints each block whole (JAX's plain
``jax.checkpoint``), so B1 runs twice a layer a step. On an ``fsdp`` axis
the params hold this rank's blocks per ``sharding_rules`` (JAX's: the
biases and norms whole) and each leaf is gathered where it is used, as in
Llama. TP (A8b) and a context axis raise.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import torch
from torch.nn.functional import embedding

from tony_tpu_torch.models.llama import segment_positions
from tony_tpu_torch.ops import attention as attn_ops
from tony_tpu_torch.ops import layers as L
from tony_tpu_torch.parallel.mesh import context_degree
from tony_tpu_torch.parallel.sharding import P, Place, ShardingRules, gather, gathering, keep_whole


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30_522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq: int = 512
    type_vocab: int = 2
    norm_eps: float = 1e-12
    dtype: str = "bfloat16"
    remat: bool = False
    attn_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def num_params(self) -> int:
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        per_layer = 4 * D * D + 4 * D + 2 * D * F + D + F + 4 * D
        return (V + self.max_seq + self.type_vocab) * D + 2 * D + self.n_layers * per_layer + D * V + V

    def flops_per_token(self, masked_frac: float | None = None) -> int:
        """Training FLOPs/token: 6N + the bidirectional attention term
        12·L·D·T (not halved: no causal mask). With ``masked_frac`` the MLM
        head's product counts only at the masked positions (the gathered
        layout)."""
        attn = 12 * self.n_layers * self.d_model * self.max_seq
        flops = 6 * self.num_params() + attn
        if masked_frac is not None:
            head = self.d_model * self.vocab_size
            flops -= int(6 * head * (1.0 - masked_frac))
        return flops


BERT_BASE = BertConfig()
BERT_TINY = BertConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=64,
    attn_impl="reference",
)
PRESETS = {"bert-base": BERT_BASE, "tiny": BERT_TINY}


def init(gen: torch.Generator, cfg: BertConfig, device: torch.device | str,
         place: Place = keep_whole) -> dict:
    """Random parameter tree (truncated normal in [-2, 2] · fan_in^-0.5,
    biases 0, norms 1), drawn on ``device`` from ``gen``, one layer at a
    time; each leaf goes to ``place(name, leaf)`` as it is drawn
    (``llama.init``). Its bits differ from the JAX init."""
    D, F, V, Lyr = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    dt = cfg.tdtype

    def draw(shape, fan_in):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (t * fan_in ** -0.5).to(dt)

    def dense(*shape, fan_in):
        if len(shape) == 3:
            return torch.stack([draw(shape[1:], fan_in) for _ in range(shape[0])])
        return draw(shape, fan_in)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dt, device=device)

    def norm(name, *shape):
        return {"w": place(f"{name}/w", const(1.0, *shape)), "b": place(f"{name}/b", const(0.0, *shape))}

    return {
        "tok_embed": place("tok_embed", dense(V, D, fan_in=1.0)),
        "pos_embed": place("pos_embed", dense(cfg.max_seq, D, fan_in=1.0)),
        "type_embed": place("type_embed", dense(cfg.type_vocab, D, fan_in=1.0)),
        "embed_norm": norm("embed_norm", D),
        "layers": {
            "wqkv": place("layers/wqkv", dense(Lyr, D, 3 * D, fan_in=D)),
            "bqkv": place("layers/bqkv", const(0.0, Lyr, 3 * D)),
            "wo": place("layers/wo", dense(Lyr, D, D, fan_in=D)),
            "bo": place("layers/bo", const(0.0, Lyr, D)),
            "attn_norm": norm("layers/attn_norm", Lyr, D),
            "w_in": place("layers/w_in", dense(Lyr, D, F, fan_in=D)),
            "b_in": place("layers/b_in", const(0.0, Lyr, F)),
            "w_out": place("layers/w_out", dense(Lyr, F, D, fan_in=F)),
            "b_out": place("layers/b_out", const(0.0, Lyr, D)),
            "mlp_norm": norm("layers/mlp_norm", Lyr, D),
        },
        "mlm_head": place("mlm_head", dense(D, V, fan_in=D)),
        "mlm_bias": place("mlm_bias", const(0.0, V)),
    }


def sharding_rules(cfg: BertConfig) -> ShardingRules:
    """JAX's rules: the biases and norms whole."""
    return ShardingRules([
        (r"tok_embed", P("model", "fsdp")),
        (r"(pos|type)_embed", P(None, "fsdp")),
        (r"layers/(wqkv|w_in)", P(None, "fsdp", "model")),
        (r"layers/(bqkv|b_in)", P(None, "model")),
        (r"layers/(wo|w_out)", P(None, "model", "fsdp")),
        (r"mlm_head", P("fsdp", "model")),
        (r".*", P()),
    ])


def _refuse_mesh(mesh) -> None:
    if context_degree(mesh) > 1:
        raise NotImplementedError(
            "BERT runs on the data and fsdp axes: the JAX model shards over data, fsdp and model "
            "(the model axis: ROADMAP queue A8b), and has no context axis")


def _block(x, lp: dict, cfg: BertConfig, segment_ids=None):
    """One post-norm encoder block."""
    B, T = x.shape[0], x.shape[1]
    H, Dh = cfg.n_heads, cfg.head_dim
    qkv = x @ lp["wqkv"] + lp["bqkv"]
    q, k, v = (t.reshape(B, T, H, Dh).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    o = attn_ops.mha(q, k, v, causal=False, impl=cfg.attn_impl, segment_ids=segment_ids)
    o = o.transpose(1, 2).reshape(B, T, H * Dh)
    x = L.layer_norm(x + o @ lp["wo"] + lp["bo"], lp["attn_norm"]["w"], lp["attn_norm"]["b"],
                     cfg.norm_eps)
    return L.layer_norm(x + L.gelu_mlp(x, lp["w_in"], lp["b_in"], lp["w_out"], lp["b_out"]),
                        lp["mlp_norm"]["w"], lp["mlp_norm"]["b"], cfg.norm_eps)


def _unbind(tree: dict) -> dict:
    """Each stacked leaf unbound once along L (so its gradient is stacked
    once in the backward)."""
    return {k: _unbind(v) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}


def _layer(unbound: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in unbound.items()}


def hidden_states(params: dict, tokens: torch.Tensor, cfg: BertConfig, mesh=None,
                  type_ids: torch.Tensor | None = None,
                  segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Encoder output [B, T, D] without the MLM head.

    ``segment_ids`` [B, T] (``data.dataset.pack_sequences``' layout): attention
    stays within segments and the learned positions restart at every
    boundary; padding (segment 0) attends only among itself."""
    _refuse_mesh(mesh)
    T = tokens.shape[1]
    tokens = tokens.long()
    rules = sharding_rules(cfg)
    tok_embed, pos_embed, type_embed = (gather(params[k], rules.spec_for(k), mesh)
                                        for k in ("tok_embed", "pos_embed", "type_embed"))
    if segment_ids is not None:
        pos_e = embedding(segment_positions(segment_ids), pos_embed)
    else:
        pos_e = pos_embed[:T]
    types = type_ids.long() if type_ids is not None else torch.zeros_like(tokens)
    # ``embedding``, not tensor indexing: its backward reduces sorted runs of
    # equal ids, where indexing's accumulating scatter serialises on them
    # (every type id is 0)
    x = embedding(tokens, tok_embed) + pos_e + embedding(types, type_embed)
    x = L.layer_norm(x, params["embed_norm"]["w"], params["embed_norm"]["b"], cfg.norm_eps)
    block_fn = attn_ops.remat_block(gathering(partial(_block, cfg=cfg, segment_ids=segment_ids), rules, mesh),
                                    cfg.remat, "full")
    layers = _unbind(params["layers"])
    for i in range(cfg.n_layers):
        x = block_fn(x, _layer(layers, i))
    return x


def forward(params: dict, tokens: torch.Tensor, cfg: BertConfig, mesh=None,
            type_ids: torch.Tensor | None = None,
            segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Full-vocabulary MLM logits [B, T, V] at every position."""
    x = hidden_states(params, tokens, cfg, mesh, type_ids, segment_ids=segment_ids)
    return x @ mlm_head(params, cfg, mesh) + params["mlm_bias"]


def mlm_head(params: dict, cfg: BertConfig, mesh=None) -> torch.Tensor:
    """The whole MLM head (gathered on an fsdp axis)."""
    return gather(params["mlm_head"], sharding_rules(cfg).spec_for("mlm_head"), mesh)


def loss_fn(params: dict, batch: dict, cfg: BertConfig, mesh=None) -> tuple[torch.Tensor, dict]:
    """MLM loss, with either layout:

    - gathered: ``masked_pos`` [B, M] and ``masked_targets`` [B, M]; the head
      projects only the masked rows, never holding the [B, T, V] logits;
    - dense: ``targets`` [B, T] with -100 where unmasked; with
      ``segment_ids`` the padding (segment 0) is never scored.
    """
    seg = batch.get("segment_ids")
    if "masked_pos" in batch:
        x = hidden_states(params, batch["tokens"], cfg, mesh, segment_ids=seg)
        pos = batch["masked_pos"].long()
        xm = torch.gather(x, 1, pos[..., None].expand(-1, -1, x.shape[-1]))
        logits = xm @ mlm_head(params, cfg, mesh) + params["mlm_bias"]
        loss, n = L.cross_entropy_loss(logits, batch["masked_targets"])
        return loss, {"loss": loss, "tokens": n}
    logits = forward(params, batch["tokens"], cfg, mesh, segment_ids=seg)
    targets = batch["targets"]
    if seg is not None:
        targets = torch.where(seg != 0, targets, torch.full_like(targets, -100))
    loss, n = L.cross_entropy_loss(logits, targets)
    return loss, {"loss": loss, "tokens": n}


def synthetic_batch(gen: torch.Generator, batch_size: int, seq_len: int, cfg: BertConfig,
                    mask_frac: float = 0.15) -> dict:
    """Gathered layout, drawn from ``gen`` on its device: exactly M =
    round(mask_frac·T) distinct masked positions a row, sorted."""
    dev = gen.device
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq_len), generator=gen, device=dev)
    M = max(1, round(seq_len * mask_frac))
    noise = torch.rand(batch_size, seq_len, generator=gen, device=dev)
    pos = noise.argsort(dim=-1)[:, :M].sort(dim=-1).values
    return {"tokens": tokens, "masked_pos": pos, "masked_targets": torch.gather(tokens, 1, pos)}


def dense_synthetic_batch(gen: torch.Generator, batch_size: int, seq_len: int, cfg: BertConfig,
                          mask_frac: float = 0.15) -> dict:
    """Dense layout: ``targets`` [B, T], -100 where unmasked (each position
    masked with probability ``mask_frac``, so rows differ in count)."""
    dev = gen.device
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq_len), generator=gen, device=dev)
    masked = torch.rand(batch_size, seq_len, generator=gen, device=dev) < mask_frac
    return {"tokens": tokens, "targets": torch.where(masked, tokens, torch.full_like(tokens, -100))}


def config_from_dict(d) -> BertConfig:
    if isinstance(d, str):
        return PRESETS[d]
    fields = {f.name for f in dataclasses.fields(BertConfig)}
    return dataclasses.replace(
        PRESETS.get(d.get("preset", ""), BertConfig()),
        **{k: v for k, v in d.items() if k in fields},
    )
