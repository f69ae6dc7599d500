"""On-card tests of the port's CUDA kernels against their plain PyTorch
versions (marked ``cuda``; they skip without a card — the kernels have no
CPU mode). On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest imports JAX, which these tests do
not need.)
"""

import pytest

torch = pytest.importorskip("torch")

from tony_tpu_torch.ops import attention as A  # noqa: E402
from tony_tpu_torch.ops import decode_attention as DA  # noqa: E402
from tony_tpu_torch.ops import quant as Q  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _attn_inputs(gen, dtype, S, H, Hkv, Dh, maxT, page_len, W):
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    lengths = torch.randint(0, maxT, (S,), generator=gen, device="cuda", dtype=torch.int32)
    lengths[0] = 0
    max_pages = maxT // page_len
    P = S * max_pages + 1
    pt = (torch.randperm(P - 1, generator=gen, device="cuda")[: S * max_pages] + 1).reshape(S, max_pages)
    return dict(
        q=r(S, H, Dh), ck=r(S, Hkv, maxT, Dh), cv=r(S, Hkv, maxT, Dh),
        kp=r(P, Hkv, page_len, Dh), vp=r(P, Hkv, page_len, Dh), pt=pt.to(torch.int32),
        cur_k=r(S, Hkv, Dh), cur_v=r(S, Hkv, Dh), lengths=lengths,
        sk=r(S, W, Hkv, Dh), sv=r(S, W, Hkv, Dh),
        count=torch.randint(0, W + 1, (S,), generator=gen, device="cuda", dtype=torch.int32),
    )


# f32 sums in another order: 1e-4 in f32; bf16 output rounding: 2e-2
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Dh,n_rep", [(128, 4), (64, 1), (64, 8)])
@pytest.mark.parametrize("window", [0, 50])
def test_decode_attention_kernel_matches_plain(gen, dtype, atol, Dh, n_rep, window):
    Hkv = 2
    a = _attn_inputs(gen, dtype, S=5, H=Hkv * n_rep, Hkv=Hkv, Dh=Dh, maxT=192, page_len=24, W=4)
    before = dict(DA.launches)
    got = DA.ragged_decode_attention(a["q"], a["ck"], a["cv"], a["lengths"],
                                     cur_k=a["cur_k"], cur_v=a["cur_v"], window=window)
    want = DA.decode_attention_ref(a["q"], a["ck"], a["cv"], a["lengths"],
                                   cur_k=a["cur_k"], cur_v=a["cur_v"], window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    for staged in (False, True):
        kw = dict(cur_k=a["cur_k"], cur_v=a["cur_v"], window=window)
        if staged:
            kw.update(staged_k=a["sk"], staged_v=a["sv"], staged_count=a["count"])
        got = DA.paged_decode_attention(a["q"], a["kp"], a["vp"], a["lengths"], a["pt"], **kw)
        want = DA.decode_attention_ref(a["q"], a["kp"], a["vp"], a["lengths"], page_table=a["pt"], **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert DA.launches["ragged_decode_attention"] == before["ragged_decode_attention"] + 1
    assert DA.launches["paged_decode_attention"] == before["paged_decode_attention"] + 2


@pytest.mark.parametrize("M,K,N", [(1, 64, 48), (3, 80, 272), (8, 256, 1024), (77, 512, 96), (130, 128, 4096)])
def test_int8_kernel_matches_plain_for_every_m(gen, M, K, N):
    w = torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5
    qt = Q.quantize_int8(w)
    x = torch.randn(2, M, K, generator=gen, device="cuda").to(torch.bfloat16)  # leading dims flatten
    before = Q.launches["int8_matmul"]
    got = Q.int8_matmul(x, qt)
    want = Q.int8_matmul_plain(x, qt)
    assert got.shape == (2, M, N) and got.dtype == torch.bfloat16
    tol = 2e-2 * want.float().abs().max().item()  # ~2.5 bf16 ulps at the top of the range
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert Q.launches["int8_matmul"] == before + 1


def test_kernels_refuse_what_they_do_not_take(gen):
    qt = Q.quantize_int8(torch.randn(64, 64, generator=gen, device="cuda"))
    with pytest.raises(TypeError, match="bfloat16"):
        Q.int8_matmul(torch.randn(4, 64, device="cuda"), qt)
    q = torch.randn(2, 4, 96, device="cuda")
    ck = torch.randn(2, 2, 32, 96, device="cuda")
    cur = torch.randn(2, 2, 96, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        DA.ragged_decode_attention(q, ck, ck, torch.zeros(2, dtype=torch.int32, device="cuda"),
                                   cur_k=cur, cur_v=cur)


def test_engine_on_card_matches_cpu_greedy(gen):
    """A tiny model in f32 with head_dim 64 (the kernel takes 64 or 128):
    the engine on the card (decode attention kernels) gives the CPU
    engine's greedy tokens."""
    import dataclasses

    from tony_tpu_torch.models.llama import LLAMA_TINY, init
    from tony_tpu_torch.models.serving import ContinuousBatcher

    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32", d_model=128, n_heads=2, n_kv_heads=1)
    params = init(torch.Generator().manual_seed(0), cfg, "cpu")
    outs = []
    for dev, kv in (("cpu", "paged"), ("cuda", "paged"), ("cuda", "dense")):
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dev))
             for k, v in params.items()}
        eng = ContinuousBatcher(p, cfg, num_slots=3, max_len=128, decode_chunk=4, kv=kv,
                                page_len=32, attn="ragged")
        for prompt in ([1, 2, 3, 4, 5], list(range(10, 50)), [7] * 33):
            eng.submit(prompt, 9)
        outs.append(eng.run())
    assert outs[0] == outs[1] == outs[2]


# -- flash attention (B1 forward, B2 dq, B3 dk/dv) ------------------------------

def _flash_inputs(gen, dtype, B, H, Hkv, T, D, n_seg):
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    q, k, v, do = r(B, H, T, D), r(B, Hkv, T, D), r(B, Hkv, T, D), r(B, H, T, D)
    seg = None
    if n_seg > 1:
        bounds = torch.randperm(T - 1, generator=gen, device="cuda")[: n_seg - 1].sort().values + 1
        seg = torch.searchsorted(bounds, torch.arange(T, device="cuda"), right=True)
        seg = seg.to(torch.int32)[None].expand(B, T).contiguous()
    return q, k, v, do, seg


# o, dq, dk, dv: the largest row error over the row's norm (``_row_err``).
# f32: sums in another order (H100: at most 5.6e-6 over this grid); bf16: P
# and dS are rounded to bf16 before the tensor-core products (the plain
# version keeps them in f32), a few bf16 ulps of a row (at most 5.3e-3),
# while a skipped 64-key tile reads 2.2e-2 or more (``chip_smoke.py``).
# lse is f32 on both sides.
ROW_TOL = {torch.float32: 5e-5, torch.bfloat16: 1e-2}
LSE_ATOL = 1e-3


def _row_err(got, want):
    """Largest error of a row (a head_dim vector) over that row's norm, the
    norm floored at a tenth of the RMS row norm: a row whose exact value is
    0 (dq of a segment's first query) holds only rounding noise."""
    d = (got.float() - want.float()).norm(dim=-1)
    n = want.float().norm(dim=-1)
    return (d / n.clamp_min(0.1 * n.square().mean().sqrt())).max().item()


def _flash_compare(gen, dtype, B, H, Hkv, T, D, causal, window, n_seg):
    """Every kernel against its plain version on the same inputs; returns
    the errors."""
    q, k, v, do, seg = _flash_inputs(gen, dtype, B, H, Hkv, T, D, n_seg)
    kw = dict(causal=causal, segment_ids=seg, window=window)
    before = dict(A.launches)
    o, lse = A.flash_fwd(q, k, v, **kw)
    o_p, lse_p = A.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * o_p.float()).sum(-1)
    dq = A.flash_bwd_dq(q, k, v, do, lse_p, delta, **kw)
    dk, dv = A.flash_bwd_dkv(q, k, v, do, lse_p, delta, **kw)
    torch.cuda.synchronize()
    want = {"o": o_p, "dq": A.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw)}
    want["dk"], want["dv"] = A.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, **kw)
    got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
    assert lse.shape == lse_p.shape and lse.dtype == torch.float32
    errs = {"lse": (lse - lse_p).abs().max().item()}
    assert errs["lse"] <= LSE_ATOL, f"lse: abs err {errs['lse']} > {LSE_ATOL}"
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert bool(torch.isfinite(g.float()).all()), name
        errs[name] = _row_err(g, w)
        assert errs[name] <= ROW_TOL[dtype], f"{name}: row err {errs[name]} > {ROW_TOL[dtype]}"
    assert A.launches == {k_: before[k_] + 1 for k_ in before}
    return errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,n_rep", [(128, 4), (64, 1), (64, 8), (128, 8)])
@pytest.mark.parametrize("causal,window,n_seg", [(True, 0, 1), (True, 300, 1), (True, 0, 3),
                                                 (True, 256, 3), (False, 0, 1)],
                         ids=["causal", "window", "segments", "window-segments", "full"])
def test_flash_kernels_match_plain(gen, dtype, D, n_rep, causal, window, n_seg):
    _flash_compare(gen, dtype, B=2, H=2 * n_rep, Hkv=2, T=1024, D=D, causal=causal,
                   window=window, n_seg=n_seg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [200, 8192])
def test_flash_kernels_long_and_ragged(gen, dtype, T):
    """T=8192 with GQA (where the JAX package takes its streaming dk/dv
    kernel) and a length that is no multiple of a tile."""
    _flash_compare(gen, dtype, B=1, H=4, Hkv=1, T=T, D=128, causal=True, window=0,
                   n_seg=3 if T == 200 else 1)


def test_flash_autograd_on_card_matches_reference(gen):
    """The one autograd function on the card (B1 + B2 + B3) against autograd
    through the plain reference, in f32 (TF32 off on both)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, seg = _flash_inputs(gen, torch.float32, 2, 8, 2, 384, 64, 3)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = A.mha(*leaves, impl="flash", segment_ids=seg, window=200)
    (o * do).sum().backward()
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o_r = A.attention_reference(ref[0], A.repeat_kv(ref[1], 4), A.repeat_kv(ref[2], 4),
                                segment_ids=seg, window=200)
    (o_r * do).sum().backward()
    torch.testing.assert_close(o, o_r, atol=2e-5, rtol=0)
    for a, b in zip(leaves, ref):
        err = (a.grad - b.grad).abs().max().item() / b.grad.abs().max().item()
        assert err < 2e-4


@pytest.mark.parametrize("T", [100, 200, 1000])
def test_mha_on_card_takes_the_kernels_at_every_length(gen, T):
    """On CUDA tensors ``mha`` (``impl="auto"``) launches B1, B2 and B3 at
    lengths that are no multiple of a tile, as at any other."""
    q, k, v, do, seg = _flash_inputs(gen, torch.bfloat16, 1, 8, 2, T, 128, 3)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(A.launches)
    (A.mha(*leaves, segment_ids=seg) * do).sum().backward()
    assert A.launches == {k_: before[k_] + 1 for k_ in before}


def test_flash_kernels_refuse_what_they_do_not_take(gen):
    """A CUDA tensor outside what the kernels take raises; it never runs the
    plain version."""
    before = dict(A.launches)
    q = torch.randn(1, 4, 256, 96, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        A.flash_fwd(q, q[:, :2], q[:, :2])
    with pytest.raises(ValueError, match="head_dim"):
        A.mha(q, q[:, :2], q[:, :2])  # never the plain reference for a card tensor
    q = torch.randn(1, 16, 256, 64, device="cuda")
    with pytest.raises(ValueError, match="at most 8x"):
        A.flash_fwd(q, q[:, :1], q[:, :1])
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        A.flash_fwd(q.half(), q.half(), q.half())
    assert A.launches == before


# -- MoE grouped SwiGLU (B7 forward, B8 backward) ---------------------------------

def _moe_inputs(gen, E, D, F, N, skew):
    """Routed rows for N tokens, top-2 over E experts, in bf16: 'random'
    (a random router), 'two' (every token to experts 0 and 1, so the rest
    own one pad tile and no real row). The cotangent is zero on pad rows, as
    the combine's backward makes it."""
    from tony_tpu_torch.ops import moe_gemm as MG
    from tony_tpu_torch.parallel.expert import MoEConfig, route_ragged

    bf = torch.bfloat16
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device="cuda") * scale).to(bf)  # noqa: E731
    x = r(1, N, D)
    router = torch.randn(D, E, generator=gen, device="cuda") / D ** 0.5
    if skew == "two":
        router = torch.zeros(D, E, device="cuda")
        router[:, :2] = 1.0
        x = x.abs()
    sort_tok, _, _, gate_sorted, gs, _ = route_ragged(x, router, MoEConfig(E, 2), tile=MG.TILE)
    xs = x.reshape(N, D)[sort_tok.long()].contiguous()
    tg = MG.tile_group_map(gs, xs.shape[0] // MG.TILE, MG.TILE)
    w = (r(E, D, F, scale=D ** -0.5), r(E, D, F, scale=D ** -0.5), r(E, F, D, scale=F ** -0.5))
    dy = (r(*xs.shape) * (gate_sorted != 0)[:, None]).contiguous()
    return xs, w, tg, dy


# ys and dxs held row by row (``_row_err``), each expert's dW in relative
# Frobenius norm: both sides take the same bf16 inputs, sum in f32 and round
# h, dg and du to bf16, so the kernels differ from the plain versions only
# where a sum in another order moves a rounding (a bf16 ulp of a few
# elements). A tile computed with the wrong expert's weights reads ~1
# (chip_smoke.py's planted fault).
MOE_TOL = 1e-2


@pytest.mark.parametrize("E,D,F,N,skew", [
    (4, 128, 256, 32, "random"),
    (8, 256, 384, 300, "two"),
    (8, 512, 1024, 1000, "random"),
    (2, 384, 128, 77, "random"),
])
def test_moe_kernels_match_plain(gen, E, D, F, N, skew):
    from tony_tpu_torch.ops import moe_gemm as MG

    xs, (wg, wu, wd), tg, dy = _moe_inputs(gen, E, D, F, N, skew)
    before = dict(MG.launches)
    ys = MG.moe_fwd(xs, wg, wu, wd, tg)
    grads = MG.moe_bwd(xs, dy, wg, wu, wd, tg)
    torch.cuda.synchronize()
    assert MG.launches == {"moe_fwd": before["moe_fwd"] + 1, "moe_bwd": before["moe_bwd"] + 1}
    want_ys = MG.moe_fwd_plain(xs, wg, wu, wd, tg)
    want = MG.moe_bwd_plain(xs, dy, wg, wu, wd, tg)
    assert _row_err(ys, want_ys) <= MOE_TOL
    assert _row_err(grads[0], want[0]) <= MOE_TOL
    for got, exp in zip(grads[1:], want[1:]):
        assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
        for e in range(E):
            ref = exp[e].float()
            if ref.norm() == 0:  # an expert with no real row: exactly zero
                assert bool((got[e] == 0).all()), e
                continue
            assert ((got[e].float() - ref).norm() / ref.norm()).item() <= MOE_TOL, e
    if skew == "two":
        assert all(bool((g[2:] == 0).all()) for g in grads[1:])


def test_moe_ffn_and_mixtral_step_on_card_launch_the_kernels(gen):
    """``moe_ffn`` on card tensors launches B7 once and B8 once; a Mixtral
    loss and backward under remat "full" launches B7 twice a layer (forward
    and replay) and B8 once a layer."""
    import dataclasses

    from tony_tpu_torch.models import mixtral
    from tony_tpu_torch.ops import moe_gemm as MG

    cfg = dataclasses.replace(mixtral.MIXTRAL_TINY, dtype="bfloat16", d_model=256, n_heads=4,
                              n_kv_heads=2, d_ff=256, remat=True, attn_impl="auto", ce_chunk=32)
    params = mixtral.init(gen, cfg, "cuda")
    names, tensors = zip(*((k, v) for k, v in params["layers"].items()))
    for t in tensors:
        t.requires_grad_(True)
    batch = mixtral.synthetic_batch(gen, 2, 64, cfg)
    MG.reset_launches()
    loss, aux = mixtral.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, tensors)
    torch.cuda.synchronize()
    assert MG.launches == {"moe_fwd": 2 * cfg.n_layers, "moe_bwd": cfg.n_layers}
    assert torch.isfinite(loss) and all(bool(torch.isfinite(g.float()).all()) for g in grads)
    assert aux["moe_balance_loss"].item() > 0


def test_moe_kernels_refuse_what_they_do_not_take(gen):
    from tony_tpu_torch.ops import moe_gemm as MG

    before = dict(MG.launches)
    xs = torch.randn(128, 128, device="cuda")
    w = torch.randn(2, 128, 128, device="cuda")
    tg = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        MG.moe_fwd(xs, w, w, w, tg)
    xs, w = torch.randn(128, 96, device="cuda").bfloat16(), torch.randn(2, 96, 128, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="multiples of 128"):
        MG.moe_fwd(xs, w, w, w.transpose(1, 2).contiguous(), tg)
    assert MG.launches == before
