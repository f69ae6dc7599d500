"""Port parity: tony_tpu_torch.ops.layers against tony_tpu.ops.layers (f32, CPU),
values and, for the losses, gradients."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tony_tpu.ops import layers as JL  # noqa: E402
from tony_tpu_torch.ops import layers as TL  # noqa: E402

ATOL = 1e-5  # f32 on both sides; only the order of f32 sums differs


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("scaling", [(), ("linear", 4.0), ("llama3", 8.0, 1.0, 4.0, 64)])
def test_rope_frequencies_match_jax(scaling):
    tc, ts = TL.rope_frequencies(128, 96, 500_000.0, scaling)
    jc, js = JL.rope_frequencies(128, 96, 500_000.0, scaling)
    _close(tc, jc)
    _close(ts, js)


@pytest.mark.parametrize("per_batch", [False, True])
def test_apply_rope_matches_jax(per_batch):
    rng = np.random.default_rng(1)
    B, H, T, D = 2, 3, 7, 16
    x = rng.standard_normal((B, H, T, D)).astype(np.float32)
    cos, sin = JL.rope_frequencies(D, 32, 10_000.0)
    pos = (rng.integers(0, 32, (B, T)) if per_batch else rng.integers(0, 32, (T,))).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), cos, sin, positions=jnp.asarray(pos))
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(cos)),
                        torch.from_numpy(np.array(sin)), positions=torch.from_numpy(pos).long())
    _close(got, want)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    wg, wu = (rng.standard_normal((32, 48)).astype(np.float32) * 0.2 for _ in range(2))
    wd = rng.standard_normal((48, 32)).astype(np.float32) * 0.2
    got = TL.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    _close(got, JL.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd))))


def test_layer_norm_and_gelu_mlp_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w, b = rng.standard_normal(32).astype(np.float32), rng.standard_normal(32).astype(np.float32)
    _close(TL.layer_norm(*(torch.from_numpy(a) for a in (x, w, b)), 1e-5),
           JL.layer_norm(*(jnp.asarray(a) for a in (x, w, b)), 1e-5))
    wi, wo = (rng.standard_normal(s).astype(np.float32) * 0.2 for s in ((32, 48), (48, 32)))
    bi, bo = rng.standard_normal(48).astype(np.float32), rng.standard_normal(32).astype(np.float32)
    _close(TL.gelu_mlp(*(torch.from_numpy(a) for a in (x, wi, bi, wo, bo))),
           JL.gelu_mlp(*(jnp.asarray(a) for a in (x, wi, bi, wo, bo))))


def _targets(rng, shape, V):
    t = rng.integers(0, V, shape).astype(np.int32)
    t[0, :3] = -100  # ignored positions
    return t


def test_cross_entropy_value_and_gradient_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 7, 50)).astype(np.float32) * 3
    tgt = _targets(rng, (2, 7), 50)
    jl, jn = JL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(tgt))
    jg = jax.grad(lambda z: JL.cross_entropy_loss(z, jnp.asarray(tgt))[0])(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    tl, tn = TL.cross_entropy_loss(z, torch.from_numpy(tgt))
    tl.backward()
    assert int(tn) == int(jn) == 14 - 3
    _close(tl.detach(), jl)
    _close(z.grad, jg)


def test_cross_entropy_with_no_targets_is_zero_and_counts_none():
    """Every target ignored: both losses are 0, as JAX's, and the count is
    0 where JAX reports max(n, 1), so a gang rank with no targets weighs 0."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    head = rng.standard_normal((16, 40)).astype(np.float32)
    tgt = np.full((2, 6), -100, np.int32)
    jl, jn = JL.cross_entropy_loss(jnp.asarray(x @ head), jnp.asarray(tgt))
    assert float(jl) == 0.0 and int(jn) == 1
    for loss, n in (TL.cross_entropy_loss(torch.from_numpy(x @ head), torch.from_numpy(tgt)),
                    TL.chunked_cross_entropy_loss(torch.from_numpy(x), torch.from_numpy(head),
                                                  torch.from_numpy(tgt), chunk=4)):
        assert float(loss) == 0.0 and int(n) == 0


@pytest.mark.parametrize("T,chunk", [(12, 4), (13, 4), (12, 0), (5, 8)],
                         ids=["even", "padded", "one-chunk", "chunk-over-T"])
def test_chunked_cross_entropy_value_and_gradients_match_jax(T, chunk):
    """The fused lm-head + CE, values and both gradients, including a
    length that pads to a chunk multiple (f32: sums in another order only)."""
    rng = np.random.default_rng(T + chunk)
    x = rng.standard_normal((2, T, 16)).astype(np.float32)
    head = rng.standard_normal((16, 40)).astype(np.float32) * 0.5
    tgt = _targets(rng, (2, T), 40)

    def jloss(x, head):
        return JL.chunked_cross_entropy_loss(x, head, jnp.asarray(tgt), chunk=chunk)[0]

    jl = jloss(jnp.asarray(x), jnp.asarray(head))
    jgx, jgh = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    tx, th = (torch.from_numpy(a).requires_grad_(True) for a in (x, head))
    tl, tn = TL.chunked_cross_entropy_loss(tx, th, torch.from_numpy(tgt), chunk=chunk)
    tl.backward()
    assert int(tn) == 2 * T - 3
    _close(tl.detach(), jl)
    _close(tx.grad, jgx)
    _close(th.grad, jgh)
    # the unfused loss on the full logits gives the same value
    full, _ = TL.cross_entropy_loss(torch.from_numpy(x) @ torch.from_numpy(head), torch.from_numpy(tgt))
    _close(full, jl)
