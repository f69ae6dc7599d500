"""Port parity: tony_tpu_torch.ops.quant against tony_tpu.ops.quant (CPU)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tony_tpu.models.llama import LLAMA_TINY  # noqa: E402
from tony_tpu.models.llama import init as jax_init  # noqa: E402
from tony_tpu.ops import quant as JQ  # noqa: E402
from tony_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from tony_tpu_torch.ops import quant as TQ  # noqa: E402


def _weight(K, N, seed):
    return (np.random.default_rng(seed).standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)


def test_bf16_matches_jax_pallas_kernel():
    """bf16 x with explicit blocks: JAX runs its Pallas kernel (interpret
    mode); the port's plain path agrees within bf16 output rounding."""
    rng = np.random.default_rng(0)
    M, K, N = 64, 256, 256
    x = rng.standard_normal((M, K)).astype(np.float32)
    jqt = JQ.quantize_int8(jnp.asarray(_weight(K, N, 1)))
    want = JQ.int8_matmul(jnp.asarray(x, jnp.bfloat16), jqt, block_m=64, block_n=128, block_k=128)
    tqt = TQ.QTensor(torch.from_numpy(np.array(jqt.q)), torch.from_numpy(np.array(jqt.scale)))
    got = TQ.int8_matmul(torch.from_numpy(x).to(torch.bfloat16), tqt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("M,route", [(8, "xla_reference"), (256, "pallas")])
def test_port_matches_both_jax_routes(M, route, monkeypatch):
    """The port against JAX's ``int8_matmul`` with its default blocks, on the same
    numpy inputs (bf16 x): at M 8 JAX takes its XLA reference (M < 64), at M 256 x K
    512 x N 256 its Pallas kernel (interpret mode; the default blocks 256/256/512
    tile it). The JAX function runs unjitted, so its route is decided on this call
    and checked. Tolerance 1e-2 absolute and relative: both sides sum in f32 and
    round once to bf16 (2^-8 relative), in another order."""
    K, N = 512, 256
    x = np.random.default_rng(5).standard_normal((M, K)).astype(np.float32)
    jqt = JQ.quantize_int8(jnp.asarray(_weight(K, N, 6)))
    refs = []
    real_ref = JQ.int8_matmul_ref
    monkeypatch.setattr(JQ, "int8_matmul_ref", lambda *a: refs.append(1) or real_ref(*a))
    want = JQ.int8_matmul.__wrapped__(jnp.asarray(x, jnp.bfloat16), jqt)
    assert bool(refs) == (route == "xla_reference")
    tqt = TQ.QTensor(torch.from_numpy(np.array(jqt.q)), torch.from_numpy(np.array(jqt.scale)))
    got = TQ.int8_matmul(torch.from_numpy(x).to(torch.bfloat16), tqt)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=1e-2, rtol=1e-2)


def test_f32_matches_jax_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    jqt = JQ.quantize_int8(jnp.asarray(_weight(128, 96, 3)))
    want = JQ.int8_matmul_ref(jnp.asarray(x), jqt)
    tqt = TQ.QTensor(torch.from_numpy(np.array(jqt.q)), torch.from_numpy(np.array(jqt.scale)))
    got = TQ.int8_matmul(torch.from_numpy(x), tqt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert TQ.launches["int8_matmul"] == 0  # CPU tensors never launch the kernel


@pytest.mark.parametrize("shape", [(96, 80), (3, 64, 72)])
def test_quantize_int8_matches_jax(shape):
    w = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    jqt = JQ.quantize_int8(jnp.asarray(w))
    tqt = TQ.quantize_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(tqt.q.numpy(), np.asarray(jqt.q))
    np.testing.assert_allclose(tqt.scale.numpy(), np.asarray(jqt.scale), atol=1e-7, rtol=0)
    np.testing.assert_allclose(TQ.dequantize(tqt, torch.float32).numpy(),
                               np.asarray(JQ.dequantize(jqt, jnp.float32)), atol=1e-7, rtol=0)


def test_quantize_tree_matches_jax():
    import dataclasses

    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32")
    jparams = jax_init(jax.random.PRNGKey(0), cfg)
    jtree, jb, ja = JQ.quantize_tree(jparams, min_size=1)
    ttree, tb, ta = TQ.quantize_tree(params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
                                     min_size=1)
    assert (tb, ta) == (jb, ja)
    jflat = jax.tree_util.tree_flatten_with_path(jtree, is_leaf=lambda x: isinstance(x, JQ.QTensor))[0]
    for path, jleaf in jflat:
        node = ttree
        for k in path:
            node = node[k.key]
        if isinstance(jleaf, JQ.QTensor):
            assert isinstance(node, TQ.QTensor), path
            np.testing.assert_array_equal(node.q.numpy(), np.asarray(jleaf.q))
            np.testing.assert_allclose(node.scale.numpy(), np.asarray(jleaf.scale), atol=1e-7, rtol=0)
        else:
            assert not isinstance(node, TQ.QTensor), path
