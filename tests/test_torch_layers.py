"""Port parity: tony_tpu_torch.ops.layers against tony_tpu.ops.layers (f32, CPU)."""

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
