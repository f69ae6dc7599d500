"""Port parity for the remat policies on the CPU, in f32.

``remat_block``'s "full", "dots" and "flash" (and "flash" with
``TONY_REMAT_EXTRA_NAMES``) on the tiny Llama and the tiny Mixtral, both on
the flash attention path: each policy's loss and every gradient leaf equal
"full"'s; the port's "flash" against JAX's "flash" on the same weights (JAX's
Pallas kernels in interpret mode, the port's plain B1-B3 through its
autograd function); and the executions of ``tony::flash_fwd`` (B1) and
``tony::moe_fwd`` (B7) over one forward and backward, 2L / 2L / L for full /
dots / flash. A context axis (the ring path, which names nothing) runs under
each policy too. Weights cross with ``params_from_numpy``; batches are numpy
tokens from a seed.
"""

import collections
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from tony_tpu.models import llama as JL  # noqa: E402
from tony_tpu.models import mixtral as JX  # noqa: E402
from tony_tpu_torch.models import llama as TL  # noqa: E402
from tony_tpu_torch.models import mixtral as TX  # noqa: E402
from tony_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from tony_tpu_torch.ops import attention as A  # noqa: E402
from tony_tpu_torch.ops import moe_gemm as MG  # noqa: E402
from tony_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402

T = 128  # the shortest length JAX's flash gate takes (blocks >= 128)
KW = dict(dtype="float32", attn_impl="flash", remat=True)
MODELS = {"llama": (JL, TL, JL.LLAMA_TINY), "mixtral": (JX, TX, JX.MIXTRAL_TINY)}
POLICIES = {"full": ("full", ""), "dots": ("dots", ""), "flash": ("flash", ""),
            "flash+extra": ("flash", "moe_disp,moe_combine")}
#: executions of B1 and B7 a layer over one forward and backward
PER_LAYER = {"full": 2, "dots": 2, "flash": 1}
# each policy against "full": the same ops on the same values, recomputed or
# kept, so the same bits but for the embedding's index backward, whose CPU
# accumulation order varies from run to run (seen: 1.6e-7 of the leaf)
SAME_REL = 1e-6
# against JAX, f32 both sides, as the flash-path parity of test_torch_train.py:
# only the order of f32 sums differs
LOSS_ATOL = 1e-5
GRAD_REL = 1e-4


class _OpCount(TorchDispatchMode):
    """Counts the ops that run (a selective checkpoint's kept outputs come
    from its cache and never reach this mode)."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func._schema.name] += 1
        return func(*args, **(kwargs or {}))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.fixture(scope="module")
def weights():
    out = {}
    for name, (jmod, _, jbase) in MODELS.items():
        jp = jmod.init(jax.random.PRNGKey(0), dataclasses.replace(jbase, dtype="float32"))
        out[name] = (jp, jax.tree.map(np.asarray, jp))
    return out


def _batch(vocab):
    return {"tokens": np.random.default_rng(1).integers(0, vocab, (2, T + 1)).astype(np.int32)}


def _port(name, npp, policy, extra, monkeypatch, mesh=None, **cfg_kw):
    """(loss, {leaf: grad}, op executions) of one forward and backward."""
    _, tmod, _ = MODELS[name]
    monkeypatch.setenv("TONY_REMAT_EXTRA_NAMES", extra)
    cfg = tmod.config_from_dict({"preset": "tiny", **KW, "remat_policy": policy, **cfg_kw})
    tp = params_from_numpy(npp, "cpu")
    names, tensors = zip(*_leaves(tp))
    for t in tensors:
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size).items()}
    with _OpCount() as count:
        loss, _ = tmod.loss_fn(tp, batch, cfg, mesh)
        grads = torch.autograd.grad(loss, tensors)
    return loss.item(), {n: g.numpy() for n, g in zip(names, grads)}, count.n


@pytest.fixture(scope="module")
def full_runs(weights):
    with pytest.MonkeyPatch.context() as mp:
        return {name: _port(name, weights[name][1], "full", "", mp) for name in MODELS}


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("name", list(MODELS))
def test_each_policy_equals_full_and_runs_the_kernels_as_scheduled(weights, full_runs, monkeypatch,
                                                                   name, policy):
    loss, grads, count = _port(name, weights[name][1], *POLICIES[policy], monkeypatch)
    want_loss, want_grads, _ = full_runs[name]
    assert abs(loss - want_loss) <= SAME_REL * abs(want_loss)
    for leaf, g in want_grads.items():
        assert _rel(grads[leaf], g) <= SAME_REL, leaf
    layers = MODELS[name][2].n_layers
    per = PER_LAYER[POLICIES[policy][0]]
    assert count["tony::flash_fwd"] == per * layers
    assert count["tony::moe_fwd"] == (per * layers if name == "mixtral" else 0)


@pytest.mark.parametrize("name", list(MODELS))
def test_flash_policy_matches_jax_flash(weights, full_runs, monkeypatch, name):
    jmod, _, jbase = MODELS[name]
    jp, npp = weights[name]
    jcfg = dataclasses.replace(jbase, **KW, remat_policy="flash")
    batch = _batch(jcfg.vocab_size)
    (jl, _), jg = jax.value_and_grad(jmod.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, grads, _ = _port(name, npp, "flash", "", monkeypatch)
    assert abs(loss - float(jl)) < LOSS_ATOL
    for leaf, g in _leaves(jax.tree.map(np.asarray, jg)):
        assert _rel(grads[leaf], g) < GRAD_REL, leaf


@pytest.mark.parametrize("policy", ["dots", "flash"])
def test_context_axis_runs_under_each_policy(weights, monkeypatch, policy):
    """The ring kernels' plain versions over a context of 2: B9 replays
    under every policy (nothing in the ring is named), and the loss and
    gradients are "full"'s."""
    mesh = MeshSpec(context=2).build("cpu")
    npp = weights["llama"][1]
    want_loss, want_grads, _ = _port("llama", npp, "full", "", monkeypatch, mesh, cp_impl="pallas")
    loss, grads, count = _port("llama", npp, policy, "", monkeypatch, mesh, cp_impl="pallas")
    assert count["tony::flash_fwd"] == 0
    assert abs(loss - want_loss) <= SAME_REL * abs(want_loss)
    for leaf, g in want_grads.items():
        assert _rel(grads[leaf], g) <= SAME_REL, leaf


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="full|dots|flash"):
        A.remat_block(lambda x: x, True, "offload")
    assert A.remat_block(len, False, "offload") is len  # no remat: the policy is not read


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_dispatcher_ops_fake_shapes_and_dtypes(dtype):
    """The ops' fakes (what a tracer sees instead of a launch): o in q's
    dtype, lse [B, H, Tq] in f32 for either route, ys like xs, a named value
    like its input; the real ops agree on the CPU."""
    q = torch.randn(2, 4, 16, 64, dtype=dtype)
    k = torch.randn(2, 2, 16, 64, dtype=dtype)
    xs, w = torch.randn(256, 128, dtype=dtype), torch.randn(2, 128, 128, dtype=dtype)
    wd, tg = torch.randn(2, 128, 128, dtype=dtype), torch.tensor([0, 1], dtype=torch.int32)
    for device in ("meta", "cpu"):
        o, lse = A.flash_fwd_op(q.to(device), k.to(device), k.to(device), None, True, 0)
        assert (o.shape, o.dtype, o.device.type) == (q.shape, dtype, device)
        assert (lse.shape, lse.dtype) == ((2, 4, 16), torch.float32)
        ys = MG.moe_fwd_op(xs.to(device), w.to(device), w.to(device), wd.to(device), tg.to(device), 128)
        assert (ys.shape, ys.dtype, ys.device.type) == (xs.shape, dtype, device)
        named = A.checkpoint_name(xs.to(device), "moe_disp")
        assert (named.shape, named.dtype, named.device.type) == (xs.shape, dtype, device)
