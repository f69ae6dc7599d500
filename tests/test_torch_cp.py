"""Port parity for context-parallel (CP) training on the CPU, in f32.

The port's plain PyTorch ring and Ulysses (``parallel/context.py``) against
the JAX functions in ``shard_map`` over the conftest's virtual CPU devices;
the Llama ``loss_fn`` and every gradient leaf with a context axis of 4 for
each ``cp_impl`` against JAX ``llama.loss_fn`` over a JAX mesh with a
context axis of 4 on 4 of the 8 virtual devices ("pallas" runs JAX's ring
kernels in TPU-interpret mode, whose emulation can wedge for want of
executor threads when a collective kernel occupies every device of the
process: ``tests/test_ring_pallas.py:255-265``) and against the port's
mesh-free loss; a short ``run_lm_training`` with ``context_axis=4``
against ``context_axis=1``; and what the CP path refuses. Weights cross with
``params_from_numpy``; inputs are numpy arrays from a seed.

Tolerances: both sides are f32 and differ only in the order of their sums
(the ring merges per-shard partial softmaxes): attention outputs 2e-5
absolute and gradients 2e-4 of max |ref| (``tests/test_parallel.py``,
``tests/test_ring_pallas.py``); the loss 1e-5 relative and every gradient
leaf 2e-4 in relative norm.
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from tony_tpu.compat import shard_map  # noqa: E402
from tony_tpu.models import llama as JM  # noqa: E402
from tony_tpu.parallel import MeshSpec as JMeshSpec  # noqa: E402
from tony_tpu.parallel import context as JC  # noqa: E402
from tony_tpu_torch.models import llama as TM  # noqa: E402
from tony_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from tony_tpu_torch.parallel import context as TC  # noqa: E402
from tony_tpu_torch.parallel.collectives import DeviceRing  # noqa: E402
from tony_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402
from tony_tpu_torch.train import loop as TLp  # noqa: E402

ATTN_ATOL = 2e-5
GRAD_REL = 2e-4
LOSS_REL = 1e-5
LEAF_REL = 2e-4
SPEC = P(None, None, "context", None)


def _rel_max(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _rel_norm(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# -- the plain PyTorch ring and Ulysses against JAX's -----------------------------

def _qkvw(seed, B, H, T, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(4))


def _jax_attn(fn, mesh, q, k, v, w):
    ring = jax.jit(shard_map(fn, mesh=mesh, in_specs=(SPEC, SPEC, SPEC), out_specs=SPEC,
                             axis_names={"context"}, check_vma=False))
    o, vjp = jax.vjp(ring, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(w))]


def _port_attn(fn, q, k, v, w):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = fn(*leaves)
    (o * torch.from_numpy(w)).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in leaves]


def _assert_attn(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=ATTN_ATOL, rtol=0)
    for name, g, ref in zip(("dq", "dk", "dv"), got[1], want[1]):
        assert _rel_max(g, ref) < GRAD_REL, name


@pytest.mark.parametrize("causal,context,data", [(True, 8, 1), (False, 8, 1), (True, 4, 2)],
                         ids=["causal", "noncausal", "context4-data2"])
def test_ring_attention_matches_jax(causal, context, data):
    """``context.ring_attention`` (the ``cp_impl="xla"`` ring) on a
    DeviceRing against JAX's ring over a mesh with the same context axis,
    output and gradients (``tests/test_parallel.py:68-94``)."""
    q, k, v, w = _qkvw(0, 2, 4, 64 if data == 1 else 32, 16)
    mesh = JMeshSpec(context=context, data=data).build()
    want = _jax_attn(functools.partial(JC.ring_attention, axis_name="context", causal=causal),
                     mesh, q, k, v, w)
    ring = DeviceRing(context, "cpu")
    got = _port_attn(lambda a, b, c: TC.ring_attention(a, b, c, ring=ring, causal=causal), q, k, v, w)
    _assert_attn(got, want)


def test_ulysses_attention_matches_jax():
    """``context.ulysses_attention`` against JAX's (``tests/test_parallel.py:97-109``)."""
    q, k, v, w = _qkvw(2, 2, 8, 64, 16)
    mesh = JMeshSpec(context=8).build()
    want = _jax_attn(functools.partial(JC.ulysses_attention, axis_name="context", causal=True),
                     mesh, q, k, v, w)
    ring = DeviceRing(8, "cpu")
    got = _port_attn(lambda a, b, c: TC.ulysses_attention(a, b, c, ring=ring, causal=True), q, k, v, w)
    _assert_attn(got, want)


# -- the Llama loss with a context axis --------------------------------------------

JCFG = dataclasses.replace(JM.LLAMA_TINY, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                           d_ff=256, max_seq=128, remat=False, dtype="float32")
B, T = 2, 128


def _tcfg(**kw):
    fields = {f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)}
    return dataclasses.replace(TM.LlamaConfig(**{**fields, "rope_scaling": tuple(JCFG.rope_scaling)}),
                               **kw)


@pytest.fixture(scope="module")
def llama_case():
    jp = JM.init(jax.random.PRNGKey(0), JCFG)
    tokens = np.random.default_rng(1).integers(0, JCFG.vocab_size, (B, T + 1)).astype(np.int32)
    return jp, jax.tree.map(np.asarray, jp), tokens


def _port_loss(npp, batch, cfg, mesh):
    tp = params_from_numpy(npp, "cpu")
    names, tensors = zip(*_leaves(tp))
    for t in tensors:
        t.requires_grad_(True)
    loss, aux = TM.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, mesh)
    return loss.item(), dict(zip(names, (g.numpy() for g in torch.autograd.grad(loss, tensors)))), aux


def _assert_loss(got, want, what):
    (gl, gg), (wl, wg) = got, want
    assert abs(gl - wl) <= LOSS_REL * abs(wl), f"{what}: loss {gl} vs {wl}"
    for name, ref in wg.items():
        assert _rel_norm(gg[name], ref) < LEAF_REL, f"{what}: {name}"


@pytest.mark.parametrize("cp_impl", ["pallas", "xla", "ulysses"])
def test_llama_loss_with_a_context_axis_matches_jax_and_the_mesh_free_loss(llama_case, cp_impl):
    """``loss_fn`` and every gradient leaf with ``MeshSpec(context=4)``
    against JAX's on a context-4 mesh of 4 devices, and against the port's
    loss without a mesh (single-device attention)."""
    jp, npp, tokens = llama_case
    jcfg = dataclasses.replace(JCFG, cp_impl=cp_impl)
    mesh = JMeshSpec(context=4).build(devices=jax.devices()[:4])
    (jl, _), jg = jax.jit(jax.value_and_grad(
        functools.partial(JM.loss_fn, cfg=jcfg, mesh=mesh), has_aux=True))(
        jp, {"tokens": jnp.asarray(tokens)})
    want = (float(jl), dict(_leaves(jax.tree.map(np.asarray, jg))))

    cfg = _tcfg(cp_impl=cp_impl)
    tl, tg, aux = _port_loss(npp, {"tokens": tokens}, cfg, MeshSpec(context=4).build("cpu"))
    assert int(aux["tokens"]) == B * T
    _assert_loss((tl, tg), want, f"{cp_impl} vs JAX")
    fl, fg, _ = _port_loss(npp, {"tokens": tokens}, cfg, None)
    _assert_loss((tl, tg), (fl, fg), f"{cp_impl} vs no mesh")


def test_pallas_ring_with_packing_and_a_window_matches_the_mesh_free_loss(llama_case):
    """Packed segments (boundaries off the shard edges, a padding tail) and a
    sliding window, which only ``cp_impl="pallas"`` composes with a context
    axis: the loss and every leaf as without a mesh."""
    _, npp, tokens = llama_case
    seg = np.zeros((B, T + 1), np.int32)
    seg[:, :45], seg[:, 45:100], seg[:, 100:T - 6] = 1, 2, 3
    batch = {"tokens": tokens, "segment_ids": seg}
    cfg = _tcfg(cp_impl="pallas", sliding_window=24)
    tl, tg, _ = _port_loss(npp, batch, cfg, MeshSpec(context=4).build("cpu"))
    fl, fg, _ = _port_loss(npp, batch, cfg, None)
    _assert_loss((tl, tg), (fl, fg), "pallas packed + window vs no mesh")


# -- the training loop ----------------------------------------------------------------

@pytest.mark.parametrize("cp_impl", ["xla", "pallas"])
def test_run_lm_training_with_a_context_axis_reproduces_one_shard(cp_impl):
    """``run_lm_training`` on the tiny preset, 3 steps: ``context_axis=4``
    gives the ``context_axis=1`` losses and gradient norms (the preset's
    default ``cp_impl`` is "xla")."""
    cfg = dataclasses.replace(TM.LLAMA_TINY, dtype="float32", cp_impl=cp_impl)
    runs = []
    for n in (1, 4):
        loop = TLp.LoopConfig(steps=3, batch_size=2, seq_len=32, log_every=1, learning_rate=1e-3,
                              warmup_steps=1, device="cpu", prefetch_depth=0, context_axis=n)
        runs.append(TLp.run_lm_training(TM, cfg, loop)["log"])
    assert [x["step"] for x in runs[1]] == [1, 2, 3]
    for one, ctx in zip(*runs):
        assert abs(ctx["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"]), (one, ctx)
        assert abs(ctx["grad_norm"] - one["grad_norm"]) <= 1e-4 * abs(one["grad_norm"]), (one, ctx)


# -- the mesh and the refusals --------------------------------------------------------

def test_mesh_spec_builds_a_context_ring_and_refuses_other_axes():
    mesh = MeshSpec(context=4).build("cpu")
    assert mesh.shape == {"stage": 1, "data": 1, "fsdp": 1, "expert": 1, "context": 4, "model": 1}
    assert isinstance(mesh.ring, DeviceRing) and mesh.ring.n == 4 and mesh.device.type == "cpu"
    for kw, item in ((dict(data=2), "A12"), (dict(model=2), "A8"), (dict(expert=2), "A11"),
                     (dict(stage=2), "A13")):
        with pytest.raises(NotImplementedError, match=item):
            MeshSpec(context=2, **kw).build("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MeshSpec(context=2).build()


def test_the_context_path_refuses_what_jax_refuses():
    z = functools.partial(torch.zeros, dtype=torch.float32)
    q, kv = z(1, 4, 8, 16), z(1, 2, 8, 16)
    mesh = MeshSpec(context=2).build("cpu")
    with pytest.raises(ValueError, match="cp_impl"):
        TM._attention(q, kv, kv, _tcfg(cp_impl="ring"), None)
    with pytest.raises(ValueError, match="sliding_window"):
        TM._attention(q, kv, kv, _tcfg(cp_impl="xla", sliding_window=4), mesh)
    with pytest.raises(ValueError, match="packing"):
        TM._attention(q, kv, kv, _tcfg(cp_impl="ulysses"), mesh,
                      segment_ids=torch.ones(1, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="divisible by the context degree"):
        TM._attention(q, kv, kv, _tcfg(cp_impl="ulysses"), MeshSpec(context=8).build("cpu"))
    with pytest.raises(ValueError, match="does not split"):
        TM._attention(z(1, 4, 6, 16), z(1, 2, 6, 16), z(1, 2, 6, 16), _tcfg(cp_impl="pallas"),
                      MeshSpec(context=4).build("cpu"))
    tiny = dataclasses.replace(TM.LLAMA_TINY, dtype="float32")
    with pytest.raises(ValueError, match="does not split into context_axis"):
        TLp.run_lm_training(TM, tiny, TLp.LoopConfig(device="cpu", steps=1, seq_len=30, context_axis=4))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TLp.run_lm_training(TM, tiny, TLp.LoopConfig(device="cpu", steps=1, context_axis=2, model_axis=2))

    from tony_tpu_torch.models import mixtral

    mcfg = dataclasses.replace(mixtral.MIXTRAL_TINY, dtype="float32")
    with pytest.raises(NotImplementedError, match="A12"):
        TLp.run_lm_training(mixtral, mcfg, TLp.LoopConfig(device="cpu", steps=1, seq_len=32,
                                                          batch_size=2, context_axis=2))
