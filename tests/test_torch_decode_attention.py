"""Port parity: tony_tpu_torch.ops.decode_attention (plain path on the CPU)
against the JAX Pallas kernels run in interpret mode (tests/conftest.py)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tony_tpu.ops import decode_attention as JD  # noqa: E402
from tony_tpu_torch.ops import decode_attention as TD  # noqa: E402

ATOL = 2e-5  # f32 on both sides; online vs one-shot softmax differ in sum order
Dh, PLEN, MAXT = 128, 32, 128
LENGTHS = [0, 1, PLEN, MAXT - 1]  # empty, one, a page edge, the last position


def _inputs(H, Hkv, seed=0, lengths=LENGTHS, maxT=MAXT):
    rng = np.random.default_rng(seed)
    S = len(lengths)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f(S, H, Dh), ck=f(S, Hkv, maxT, Dh), cv=f(S, Hkv, maxT, Dh),
                cur_k=f(S, Hkv, Dh), cur_v=f(S, Hkv, Dh),
                lengths=np.array(lengths, np.int32))


def _pool(ck, cv, seed=1):
    """Scatter dense caches into a SHUFFLED page pool (proves the indirection)."""
    S, Hkv, maxT = ck.shape[:3]
    max_pages = maxT // PLEN
    P = S * max_pages + 3
    pt = np.random.default_rng(seed).permutation(P)[: S * max_pages].reshape(S, max_pages).astype(np.int32)
    kp = np.zeros((P, Hkv, PLEN, Dh), np.float32)
    vp = np.zeros_like(kp)
    for s in range(S):
        for j in range(max_pages):
            kp[pt[s, j]] = ck[s, :, j * PLEN:(j + 1) * PLEN]
            vp[pt[s, j]] = cv[s, :, j * PLEN:(j + 1) * PLEN]
    return kp, vp, pt


T = torch.from_numpy


@pytest.mark.parametrize("n_rep", [1, 2])
@pytest.mark.parametrize("window", [0, 40])
def test_ragged_matches_jax(n_rep, window):
    a = _inputs(2 * n_rep, 2)
    want = JD.ragged_decode_attention(
        jnp.asarray(a["q"]), jnp.asarray(a["ck"]), jnp.asarray(a["cv"]), jnp.asarray(a["lengths"]),
        cur_k=jnp.asarray(a["cur_k"]), cur_v=jnp.asarray(a["cur_v"]), window=window, chunk=PLEN)
    got = TD.ragged_decode_attention(T(a["q"]), T(a["ck"]), T(a["cv"]), T(a["lengths"]),
                                     cur_k=T(a["cur_k"]), cur_v=T(a["cur_v"]), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_rep", [1, 2])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("staged", [False, True])
def test_paged_matches_jax(n_rep, window, staged):
    a = _inputs(2 * n_rep, 2, seed=3)
    kp, vp, pt = _pool(a["ck"], a["cv"])
    extra_j, extra_t = {}, {}
    if staged:
        rng = np.random.default_rng(4)
        W = 4
        sk = rng.standard_normal((len(LENGTHS), W, 2, Dh)).astype(np.float32)
        sv = rng.standard_normal((len(LENGTHS), W, 2, Dh)).astype(np.float32)
        cnt = np.array([0, 1, 3, 4], np.int32)  # count > 0, and > length for the idle slot
        extra_j = dict(staged_k=jnp.asarray(sk), staged_v=jnp.asarray(sv), staged_count=jnp.asarray(cnt))
        extra_t = dict(staged_k=T(sk), staged_v=T(sv), staged_count=T(cnt))
    want = JD.paged_decode_attention(
        jnp.asarray(a["q"]), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(a["lengths"]),
        jnp.asarray(pt), cur_k=jnp.asarray(a["cur_k"]), cur_v=jnp.asarray(a["cur_v"]),
        window=window, **extra_j)
    got = TD.paged_decode_attention(
        T(a["q"]), T(kp), T(vp), T(a["lengths"]), T(pt), cur_k=T(a["cur_k"]),
        cur_v=T(a["cur_v"]), window=window, **extra_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_cpu_path_counts_no_launch_and_rejects_unaligned_pages():
    TD.reset_launches()
    a = _inputs(2, 2)
    TD.ragged_decode_attention(T(a["q"]), T(a["ck"]), T(a["cv"]), T(a["lengths"]),
                               cur_k=T(a["cur_k"]), cur_v=T(a["cur_v"]))
    assert TD.launches == {"ragged_decode_attention": 0, "paged_decode_attention": 0}
    kp = torch.zeros((2, 2, 12, Dh))
    with pytest.raises(ValueError, match="multiple of 8"):
        TD.paged_decode_attention(T(a["q"]), kp, kp, T(a["lengths"]),
                                  torch.zeros((4, 1), dtype=torch.int32),
                                  cur_k=T(a["cur_k"]), cur_v=T(a["cur_v"]))


# a cache of 256 positions:
# the longest slot at maxT - 1, every slot empty, and bands whose window edge
# (window 40) and length fall on either side of page (32) and split (128) edges
LONG_MAXT = 256
LONG_LENGTHS = {
    "long": [255, 1, 128, 129],
    "zero": [0, 0, 0, 0],
    "window_edges": [100, 160, 167, 200],
}


@pytest.mark.parametrize("lengths", list(LONG_LENGTHS))
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("kind", ["ragged", "paged_staged"])
def test_long_zero_and_window_edge_lengths_match_jax(lengths, window, kind):
    a = _inputs(4, 2, seed=5, lengths=LONG_LENGTHS[lengths], maxT=LONG_MAXT)
    cur = dict(cur_k=a["cur_k"], cur_v=a["cur_v"])
    if kind == "ragged":
        want = JD.ragged_decode_attention(
            jnp.asarray(a["q"]), jnp.asarray(a["ck"]), jnp.asarray(a["cv"]), jnp.asarray(a["lengths"]),
            window=window, chunk=PLEN, **{k: jnp.asarray(v) for k, v in cur.items()})
        got = TD.ragged_decode_attention(T(a["q"]), T(a["ck"]), T(a["cv"]), T(a["lengths"]), window=window,
                                         **{k: T(v) for k, v in cur.items()})
    else:
        kp, vp, pt = _pool(a["ck"], a["cv"], seed=6)
        rng = np.random.default_rng(7)
        W = 4
        staged = dict(staged_k=rng.standard_normal((4, W, 2, Dh)).astype(np.float32),
                      staged_v=rng.standard_normal((4, W, 2, Dh)).astype(np.float32),
                      staged_count=np.array([4, 0, 3, 1], np.int32), **cur)
        want = JD.paged_decode_attention(
            jnp.asarray(a["q"]), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(a["lengths"]), jnp.asarray(pt),
            window=window, **{k: jnp.asarray(v) for k, v in staged.items()})
        got = TD.paged_decode_attention(T(a["q"]), T(kp), T(vp), T(a["lengths"]), T(pt), window=window,
                                        **{k: T(v) for k, v in staged.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    if lengths == "zero" and kind == "ragged":  # every slot empty: o is the current token's v
        np.testing.assert_allclose(got.numpy(), np.repeat(a["cur_v"], 2, axis=1), atol=ATOL, rtol=0)

