"""Context parallelism in plain PyTorch: the ring (``cp_impl="xla"``) and Ulysses.

Counterpart of ``tony_tpu/parallel/context.py``. The sequence dimension is
split into the ring's shards; the ring keeps each shard's queries in place
and rotates KV around the ring, merging partial results with the
flash-attention log-sum-exp recurrence; Ulysses turns sequence shards into
head shards with an all-to-all, runs full-sequence attention on 1/n of the
heads and turns back. Both take the transport (``parallel/collectives``)
and tensors that hold this process's shards concatenated along the
sequence (the whole sequence for a ``DeviceRing``, one shard for a
``ProcessRing``); both are differentiable through autograd. The
hand-written ring kernels are ``ops/ring.py`` (``cp_impl="pallas"``).
"""

from __future__ import annotations

from functools import partial

import torch

from tony_tpu_torch.ops.attention import attention_reference

NEG_INF = -1e30


def _block_attn(q, k, v, mask, scale):
    """One KV-block attention step → (unnormalised out, row max, row sum).

    q: [B, H, Tq, D]; k/v: [B, H, Tk, D]; mask broadcastable to [B, H, Tq, Tk]."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    s = s.masked_fill(~mask, NEG_INF)
    # max is >= NEG_INF even for fully masked rows, keeping exp() finite
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.to(p.dtype))
    return o, m, l


def _merge(o1, m1, l1, o2, m2, l2):
    """Flash-attention merge of two partial softmax accumulations."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return o1 * a1 + o2 * a2, m, l1 * a1 + l2 * a2


def ring_attention(q, k, v, *, ring, causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Ring attention on the held shards of q/k/v [B, H, T_held, D] (KV heads
    already broadcast to H). Returns [B, H, T_held, D] in q's dtype."""
    n = ring.n
    qs, ks, vs = ring.split(q, 2), ring.split(k, 2), ring.split(v, 2)
    B, H, Tl, D = qs[0].shape
    scale = scale if scale is not None else D ** -0.5
    ar = torch.arange(Tl, device=q.device)

    def mask_for(my, src):
        if not causal:
            return torch.ones(1, 1, Tl, Tl, dtype=torch.bool, device=q.device)
        return ((my * Tl + ar)[:, None] >= (src * Tl + ar)[None, :])[None, None]

    state = [(torch.zeros(B, H, Tl, D, device=q.device),
              torch.full((B, H, Tl, 1), NEG_INF, device=q.device),
              torch.zeros(B, H, Tl, 1, device=q.device)) for _ in qs]
    for s in range(n):
        for i, my in enumerate(ring.positions):
            src = (my - s) % n  # whose KV block shard i holds at step s
            blk = _block_attn(qs[i].float(), ks[i].float(), vs[i], mask_for(my, src), scale)
            state[i] = _merge(*state[i], *blk)
        # rotate KV to the next position for the following step (the last
        # rotate is redundant but keeps the loop uniform, as in JAX)
        ks, vs = ring.rotate(ks), ring.rotate(vs)
    outs = [(o / l.clamp_min(1e-20)).to(q.dtype) for o, _, l in state]
    return ring.join(outs, 2)


def ulysses_attention(q, k, v, *, ring, causal: bool = True, attn_fn=None) -> torch.Tensor:
    """Ulysses (DeepSpeed) sequence parallelism: all-to-all turns sequence
    shards into head shards [B, H/n, T, D], ``attn_fn`` runs full-sequence
    attention on each, and the inverse all-to-all turns back. Needs
    H % n == 0. Shapes: held shards [B, H, T_held, D] → the same."""
    if attn_fn is None:
        attn_fn = partial(attention_reference, causal=causal)

    def seq_to_heads(x):  # held [B, H, Tl, D] shards → [B, H/n, T, D] head shards
        return ring.all_to_all(ring.split(x, 2), split_dim=1, concat_dim=2)

    def heads_to_seq(xs):
        return ring.join(ring.all_to_all(xs, split_dim=2, concat_dim=1), 2)

    outs = [attn_fn(qh, kh, vh) for qh, kh, vh in zip(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v))]
    return heads_to_seq(outs)
