"""Port parity for the MoE routing and expert kernels on the CPU.

``route_ragged`` layouts against JAX exactly; the plain versions of B7/B8
(``moe_fwd_plain``/``moe_bwd_plain`` through ``MoESwiGLU``) against the JAX
Pallas kernels in interpret mode (the suite's conftest sets
``TONY_PALLAS_INTERPRET``), in f32 and bf16; ``moe_ffn`` values and
gradients against JAX's ragged path in f32. Inputs are numpy arrays from a
seed, handed to both.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tony_tpu.ops import moe_gemm as JMG  # noqa: E402
from tony_tpu.parallel import expert as JE  # noqa: E402
from tony_tpu_torch.ops import moe_gemm as TMG  # noqa: E402
from tony_tpu_torch.parallel import expert as TE  # noqa: E402

E, D, F = 4, 128, 256


def _cfg(**kw):
    return dict(num_experts=E, top_k=2, **kw)


def _inputs(seed, B=2, T=16, D=D, E=E, skew=None):
    """x [B, T, D], router [D, E] (f32); ``skew``: 'one' puts all the router
    weight on expert 0 (the rest tie), 'unpicked' keeps expert E-1 out of
    every top-2."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    if skew == "one":
        router = np.zeros((D, E), np.float32)
        router[:, 0] = 10.0
    elif skew == "unpicked":
        router[:, E - 1] = 0.0
        x[..., 0] = np.abs(x[..., 0]) + 1.0
        router[0, E - 1] = -50.0
    return x, router


def _mask(B, T, seed=3):
    m = np.ones((B, T), bool)
    m[0, T - 5:] = False
    m[1, :3] = False
    return m


@pytest.mark.parametrize("skew", [None, "one", "unpicked"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_route_ragged_layout_matches_jax(skew, masked):
    """sort_tok, dest and the padded group sizes EXACTLY; gates and aux to
    1e-6 (f32 sums in another order). The all-to-one router ties experts
    1..3, so the top-2 tie-break (lower index first) shows here."""
    x, router = _inputs(0, skew=skew)
    B, T, _ = x.shape
    tm = _mask(B, T) if masked else None
    cfg_j = JE.MoEConfig(**_cfg())
    cfg_t = TE.MoEConfig(**_cfg())
    j = JE.route_ragged(jnp.asarray(x), jnp.asarray(router), cfg_j,
                        None if tm is None else jnp.asarray(tm), tile=128)
    t = TE.route_ragged(torch.from_numpy(x), torch.from_numpy(router), cfg_t,
                        None if tm is None else torch.from_numpy(tm), tile=128)
    names = ("sort_tok", "dest", "gate_vals", "gate_sorted", "group_sizes")
    for name, a, b in zip(names, t[:5], j[:5]):
        a, b = a.detach().numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        if name in ("sort_tok", "dest", "group_sizes"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=name)
    assert set(t[5]) == set(j[5])
    for k in j[5]:
        assert abs(float(t[5][k]) - float(j[5][k])) <= 1e-6 * max(1.0, abs(float(j[5][k]))), k
    if skew == "unpicked":
        assert int(np.asarray(j[4])[E - 1]) == 128  # one padded tile, no real row


def test_tile_group_map_matches_jax():
    gs = np.array([256, 128, 384, 128], np.int64)
    for tiles in (7, 10):
        np.testing.assert_array_equal(
            TMG.tile_group_map(torch.from_numpy(gs), tiles, 128).numpy(),
            np.asarray(JMG.tile_group_map(jnp.asarray(gs.astype(np.int32)), tiles, 128)))


def _kernel_inputs(dtype, skew="unpicked"):
    """Expert-sorted rows of 2x16 tokens routed top-2 over 4 experts (expert
    3 picked by no token, so it owns one pad tile), weights and an upstream
    cotangent that is zero on pad rows, as the combine's backward makes it."""
    x, router = _inputs(1, skew=skew)
    cfg = JE.MoEConfig(**_cfg())
    sort_tok, _, _, gate_sorted, gs, _ = JE.route_ragged(jnp.asarray(x), jnp.asarray(router), cfg,
                                                         tile=128)
    sort_tok, gate_sorted, gs = (np.asarray(a) for a in (sort_tok, gate_sorted, gs))
    rng = np.random.default_rng(2)
    xs = x.reshape(-1, D)[sort_tok]
    wg = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    wu = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32)
    wd = (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32)
    dy = rng.standard_normal(xs.shape).astype(np.float32) * (gate_sorted != 0)[:, None]
    tg = np.asarray(JMG.tile_group_map(jnp.asarray(gs), xs.shape[0] // 128, 128))
    arrays = [a.astype(np.float32) for a in (xs, wg, wu, wd, dy)]
    if dtype == "bfloat16":  # round once, so both sides see the same bf16 values
        arrays = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]
    return arrays, tg.copy()


def _row_err(got, want):
    """Largest error of a row over that row's norm, the norm floored at a
    tenth of the RMS row norm (rows whose exact value is 0 hold only noise)."""
    d = np.linalg.norm(got - want, axis=-1)
    n = np.linalg.norm(want, axis=-1)
    return float((d / np.maximum(n, 0.1 * np.sqrt((n ** 2).mean()))).max())


# f32: sums in another order (measured here: <= 1e-7), 1e-5. bf16: both round
# h, dg and du to bf16 (the kernels' rounding points) from f32 values that
# differ in their last bits, so an element can land one bf16 ulp (2^-8
# relative) apart; rows and experts move far less (measured here: <= 4.2e-4),
# 5e-3 per row and per expert.
ROW_TOL = {"float32": 1e-5, "bfloat16": 5e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_kernels_match_jax_pallas_interpret(dtype):
    """ys and the vjp's dxs / dWg / dWu / dWd of the port's autograd function
    (plain B7/B8 on the CPU) against JAX's ``moe_swiglu_grouped`` (Pallas in
    interpret mode); the expert that owns no real row gets dW = 0 exactly."""
    (xs, wg, wu, wd, dy), tg = _kernel_inputs(dtype)
    jd = getattr(jnp, dtype)
    jargs = [jnp.asarray(a, jd) for a in (xs, wg, wu, wd)]
    tg_j = jnp.asarray(tg)
    ys_j, vjp = jax.vjp(lambda a, b, c, d: JMG.moe_swiglu_grouped(a, b, c, d, tg_j, 128), *jargs)
    grads_j = vjp(jnp.asarray(dy, jd))

    td = getattr(torch, dtype)
    targs = [torch.from_numpy(a).to(td).requires_grad_(True) for a in (xs, wg, wu, wd)]
    ys_t = TMG.moe_swiglu_grouped(*targs, torch.from_numpy(tg), 128)
    grads_t = torch.autograd.grad(ys_t, targs, torch.from_numpy(dy).to(td))
    assert TMG.launches == {"moe_fwd": 0, "moe_bwd": 0}  # the CPU never counts a launch

    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    tol = ROW_TOL[dtype]
    assert _row_err(ys_t.detach().float().numpy(), f32(ys_j)) <= tol
    for name, a, b in zip(("dxs", "dwg", "dwu", "dwd"), grads_t, grads_j):
        assert a.dtype == td, name
        a, b = a.float().numpy(), f32(b)
        if name == "dxs":
            assert _row_err(a, b) <= tol, name
            continue
        assert np.all(a[E - 1] == 0) and np.all(b[E - 1] == 0), name
        for e in range(E - 1):  # each expert's dW in relative Frobenius norm
            rel = np.linalg.norm(a[e] - b[e]) / np.linalg.norm(b[e])
            assert rel <= tol, (name, e, rel)


def _ffn_inputs(seed, skew=None):
    x, router = _inputs(seed, skew=skew)
    rng = np.random.default_rng(seed + 10)
    Fs = 32
    wg = (rng.standard_normal((E, D, Fs)) / np.sqrt(D)).astype(np.float32)
    wu = (rng.standard_normal((E, D, Fs)) / np.sqrt(D)).astype(np.float32)
    wd = (rng.standard_normal((E, Fs, D)) / np.sqrt(Fs)).astype(np.float32)
    return x, router, wg, wu, wd


@pytest.mark.parametrize("skew", [None, "one"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_moe_ffn_values_and_gradients_match_jax(skew, masked):
    """y, aux and the gradients of x, the router and the expert weights
    against JAX's ragged path in f32 (its ``ragged_dot`` on the CPU, the
    port's tile-padded plain kernels): 1e-5 relative (f32 sums in another
    order)."""
    x, router, wg, wu, wd = _ffn_inputs(4, skew)
    tm = _mask(*x.shape[:2]) if masked else None
    rng = np.random.default_rng(5)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(x_, r_, g_, u_, d_):
        y, aux = JE.moe_ffn(x_, r_, g_, u_, d_, JE.MoEConfig(**_cfg()),
                            token_mask=None if tm is None else jnp.asarray(tm))
        return (y * cot).sum() + aux["moe_balance_loss"] + aux["moe_z_loss"], (y, aux)

    (jl, (jy, jaux)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in (x, router, wg, wu, wd)))

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, router, wg, wu, wd)]
    ty, taux = TE.moe_ffn(*leaves, TE.MoEConfig(**_cfg()),
                          token_mask=None if tm is None else torch.from_numpy(tm))
    tl = (ty * torch.from_numpy(cot)).sum() + taux["moe_balance_loss"] + taux["moe_z_loss"]
    tg = torch.autograd.grad(tl, leaves)

    def rel(a, b):
        return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))

    assert rel(ty.detach().numpy(), np.asarray(jy)) < 1e-5
    for k in ("moe_balance_loss", "moe_z_loss", "moe_dropped_frac"):
        assert abs(taux[k].item() - float(jaux[k])) <= 1e-6 * max(1.0, abs(float(jaux[k]))), k
    assert abs(tl.item() - float(jl)) <= 1e-5 * abs(float(jl))
    for name, a, b in zip(("x", "router", "w_gate", "w_up", "w_down"), tg, jg):
        assert rel(a.numpy(), np.asarray(b)) < 1e-5, name


# fields of JAX's MoEConfig that only its unported dispatches read
JAX_ONLY = ("capacity_factor", "dispatch")


def test_moe_ffn_refuses_what_is_not_ported():
    """An expert mesh axis raises naming A11; the port's MoEConfig is JAX's
    less the fields of the unported dispatches, and JAX's default dispatch
    is the ragged one the port runs."""
    x, router, wg, wu, wd = (torch.from_numpy(a) for a in _ffn_inputs(6))
    with pytest.raises(NotImplementedError, match="A11"):
        TE.moe_ffn(x, router, wg, wu, wd, TE.MoEConfig(**_cfg()), mesh=object())
    jcfg = dataclasses.asdict(JE.MoEConfig())
    assert jcfg["dispatch"] == "ragged"
    assert dataclasses.asdict(TE.MoEConfig()) == {k: v for k, v in jcfg.items() if k not in JAX_ONLY}
