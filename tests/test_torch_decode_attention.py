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


def _inputs(H, Hkv, seed=0):
    rng = np.random.default_rng(seed)
    S = len(LENGTHS)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f(S, H, Dh), ck=f(S, Hkv, MAXT, Dh), cv=f(S, Hkv, MAXT, Dh),
                cur_k=f(S, Hkv, Dh), cur_v=f(S, Hkv, Dh),
                lengths=np.array(LENGTHS, np.int32))


def _pool(ck, cv, seed=1):
    """Scatter dense caches into a SHUFFLED page pool (proves the indirection)."""
    S, Hkv = ck.shape[:2]
    max_pages = MAXT // PLEN
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
