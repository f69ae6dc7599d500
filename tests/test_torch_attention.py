"""Port parity: tony_tpu_torch.ops.attention against tony_tpu.ops.attention.

The JAX side runs its Pallas flash kernels (B1 forward, B2 dq, both B3 dk/dv
variants) in interpret mode (the conftest sets TONY_PALLAS_INTERPRET=1); the
port runs the plain versions of its CUDA kernels through the same
``FlashAttention`` autograd function the card uses. Inputs come from numpy
with a seed, in f32.

Tolerances: 2e-5 absolute on the forward (f32 on both sides, only the order
of f32 sums differs, as in the JAX suite's own flash tests); 2e-4 relative
to the largest gradient entry on the backward (the JAX suite's bound for its
kernels against the reference: sums over whole rows of p in another order).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tony_tpu.ops import attention as A  # noqa: E402
from tony_tpu_torch.ops import attention as TA  # noqa: E402

FWD_ATOL = 2e-5
GRAD_REL = 2e-4


def _qkv(B=1, H=4, Hkv=2, T=768, D=64, seed=31):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32) * 0.5
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32) * 0.5
    return q, k, v


def _segments(B, T, n_seg=3, seed=23):
    rng = np.random.default_rng(seed)
    bounds = np.sort(rng.choice(np.arange(1, T), n_seg - 1, replace=False))
    return np.broadcast_to(np.searchsorted(bounds, np.arange(T), side="right")[None], (B, T)).astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# (T, window, segments): the shapes of the JAX suite's flash tests
CASES = {
    "causal": (512, 0, False),
    "segments": (512, 0, True),
    "window300": (768, 300, False),
    "window256": (768, 256, False),
    "window512": (768, 512, False),
    "window128_segments": (512, 128, True),
}


def _lse_report(got: np.ndarray, want: np.ndarray) -> str:
    """Both sides' lse extremes and the first entries over ``FWD_ATOL``: the
    evidence ROADMAP's C1 asks for when the causal case fails."""
    over = np.argwhere(np.abs(got - want) > FWD_ATOL)[:8]
    return (f"port lse min {got.min():.7g} max {got.max():.7g}; pallas lse min {want.min():.7g} "
            f"max {want.max():.7g}; {int((np.abs(got - want) > FWD_ATOL).sum())} entries over "
            f"{FWD_ATOL}, first at {[tuple(int(i) for i in ix) for ix in over]}: port "
            f"{[float(got[tuple(ix)]) for ix in over]}, pallas {[float(want[tuple(ix)]) for ix in over]}")


@pytest.mark.parametrize("case", list(CASES))
def test_flash_forward_and_lse_match_pallas(case):
    T, window, has_seg = CASES[case]
    q, k, v = _qkv(T=T)
    seg = _segments(1, T) if has_seg else None
    jo, jl = A._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, 256, 256,
                               None if seg is None else jnp.asarray(seg), window)
    tq, tk, tv = _t(q, k, v)
    to, tl = TA.flash_fwd(tq, tk, tv, causal=True, window=window,
                          segment_ids=None if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FWD_ATOL, rtol=0,
                               err_msg=_lse_report(tl.numpy(), np.asarray(jl)))


def _jax_grads(q, k, v, seg, window):
    w = jnp.arange(q.shape[-1], dtype=jnp.float32)

    def loss(q, k, v):
        if seg is None:
            o = A._flash_trainable(q, k, v, True, window)
        else:
            o = A._flash_trainable_seg(q, k, v, jnp.asarray(seg), True, window)
        return (o * w).sum()

    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _port_grads(q, k, v, seg, window):
    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    o = TA.FlashAttention.apply(tq, tk, tv, None if seg is None else torch.from_numpy(seg),
                                True, window)
    (o * torch.arange(q.shape[-1], dtype=torch.float32)).sum().backward()
    return tq.grad, tk.grad, tv.grad


@pytest.mark.parametrize("dkv", ["resident", "streaming"])
@pytest.mark.parametrize("case", ["segments", "window300", "window512", "window128_segments"])
def test_flash_gradients_match_pallas(case, dkv, monkeypatch):
    """dq (B2) and dk/dv (B3) of the port's one autograd function against
    both JAX dk/dv variants: the resident kernel and the streaming one."""
    if dkv == "streaming":
        monkeypatch.setattr(A, "_DKV_RESIDENT_MAX_QROWS", 0)
    T, window, has_seg = CASES[case]
    q, k, v = _qkv(T=T)
    seg = _segments(1, T) if has_seg else None
    want = _jax_grads(q, k, v, seg, window)
    got = _port_grads(q, k, v, seg, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / (np.abs(w).max() + 1e-9)
        assert err < GRAD_REL, f"{case}/{dkv} {name}: rel err {err}"


def test_ragged_tiles_and_unequal_lengths_match_reference():
    """Lengths that are no multiple of any tile (the kernels' ragged edge)
    and Tq < Tk (no offset, as in the TPU kernels): the plain versions
    against a direct masked softmax."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 4, 200, 64)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 1, 328, 64)).astype(np.float32))
    o, lse = TA.flash_fwd(q, kv, kv, causal=True, window=70)
    s = torch.einsum("bhqd,bhkd->bhqk", q, TA.repeat_kv(kv, 4)) * 64 ** -0.5
    i, j = torch.arange(200)[:, None], torch.arange(328)[None, :]
    s = s.masked_fill(~((i >= j) & (i - j < 70)), float("-inf"))
    torch.testing.assert_close(o, torch.softmax(s, -1) @ TA.repeat_kv(kv, 4), atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=2e-5, rtol=0)


@pytest.mark.parametrize("T,routed", [(128, "flash"), (256, "flash"), (200, "flash"), (64, "reference"),
                                      (132, "reference")])
def test_mha_routes_like_jax_and_matches(T, routed, monkeypatch):
    """On CPU tensors ``mha(impl="flash")`` always takes the port's autograd
    function (the kernels' plain versions) and ``impl="auto"`` never does.
    ``routed`` is where JAX's own gate (blocks >= 128, Tq >= 128) sends the
    shape: its Pallas kernels or its reference. The outputs agree either way."""
    q, k, v = _qkv(B=2, H=4, Hkv=2, T=T, D=64, seed=T)
    seg = _segments(2, T, seed=T)
    jax_calls = []
    jax_orig = A._flash_trainable_seg
    monkeypatch.setattr(A, "_flash_trainable_seg", lambda *a: jax_calls.append(1) or jax_orig(*a))
    want = A.mha(*(jnp.asarray(a) for a in (q, k, v)), impl="flash", segment_ids=jnp.asarray(seg))
    assert ("flash" if jax_calls else "reference") == routed
    tq, tk, tv = _t(q, k, v)
    calls = []
    orig = TA.FlashAttention.apply
    monkeypatch.setattr(TA.FlashAttention, "apply", lambda *a: calls.append(1) or orig(*a))
    got = TA.mha(tq, tk, tv, impl="flash", segment_ids=torch.from_numpy(seg))
    assert len(calls) == 1
    auto = TA.mha(tq, tk, tv, impl="auto", segment_ids=torch.from_numpy(seg))
    assert len(calls) == 1  # auto on the CPU never takes it
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(auto.numpy(), np.asarray(want), atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("Tq,block_q,block_k", [(256, None, None), (257, None, None), (256, 96, None),
                                                (256, None, 64)])
def test_flash_attention_gates_match_jax(Tq, block_q, block_k):
    """JAX's ``flash_attention`` sends degenerate or ragged blocks to its
    reference; the port has no block sizes and runs its kernels (their
    plain versions here) on every shape. The outputs agree."""
    q, k, v = _qkv(B=1, H=4, Hkv=1, T=Tq, D=64, seed=7)
    want = A.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True, block_q=block_q,
                             block_k=block_k)
    got = TA.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL, rtol=0)


def test_reference_offset_and_repeat_kv_match_jax():
    """attention_reference with Tq < Tk puts query i at i + (Tk - Tq)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 5, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, 9, 16)).astype(np.float32)
    for window in (0, 3):
        want = A.attention_reference(jnp.asarray(q), A.repeat_kv(jnp.asarray(k), 2),
                                     A.repeat_kv(jnp.asarray(k), 2), causal=True, window=window)
        tk = TA.repeat_kv(torch.from_numpy(k), 2)
        got = TA.attention_reference(torch.from_numpy(q), tk, tk, causal=True, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_remat_block_full_recomputes_and_other_policies_raise():
    calls = []

    def block(x, w):
        calls.append(1)
        return torch.tanh(x @ w)

    x = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(4, 4, requires_grad=True)
    TA.remat_block(block, True, "full")(x, w).sum().backward()
    assert len(calls) == 2  # forward, then the replay in the backward
    ref = torch.autograd.grad(block(x, w).sum(), w)[0]
    torch.testing.assert_close(w.grad, ref)
    assert TA.remat_block(block, False) is block
    for policy in ("dots", "flash"):  # ported: the block replays, keeping what the policy names
        calls.clear()
        x.grad = w.grad = None
        TA.remat_block(block, True, policy)(x, w).sum().backward()
        assert len(calls) == 2
        torch.testing.assert_close(w.grad, ref)
    with pytest.raises(ValueError, match="full\\|dots\\|flash"):  # any other policy raises
        TA.remat_block(block, True, "nope")
