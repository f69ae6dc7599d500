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


def _long_inputs(gen, dtype, lengths, Dh, n_rep, page_len, maxT=2048, W=8, Hkv=2):
    """A dense cache [S, Hkv, maxT, Dh] and a shuffled page pool holding the
    same cache, a staged window of W with per-slot counts, at the given lengths."""
    S = len(lengths)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    ck, cv = r(S, Hkv, maxT, Dh), r(S, Hkv, maxT, Dh)
    max_pages = -(-maxT // page_len)
    pad = max_pages * page_len - maxT
    P = S * max_pages + 1
    pt = (torch.randperm(P - 1, generator=gen, device="cuda")[: S * max_pages] + 1).reshape(S, max_pages)
    kp = torch.zeros(P, Hkv, page_len, Dh, dtype=dtype, device="cuda")
    vp = torch.zeros_like(kp)
    for src, pool in ((ck, kp), (cv, vp)):
        full = torch.nn.functional.pad(src, (0, 0, 0, pad))
        pool[pt.long()] = full.reshape(S, Hkv, max_pages, page_len, Dh).transpose(1, 2)
    return dict(q=r(S, Hkv * n_rep, Dh), ck=ck, cv=cv, kp=kp, vp=vp, pt=pt.to(torch.int32),
                cur_k=r(S, Hkv, Dh), cur_v=r(S, Hkv, Dh),
                lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"),
                sk=r(S, W, Hkv, Dh), sv=r(S, W, Hkv, Dh),
                count=torch.tensor([(3 * i + 1) % (W + 1) for i in range(S)], dtype=torch.int32, device="cuda"))


# maxT 2048 against the 128-position splits, pages of 256 or 24 and a window
# of 300: "edges" puts split edges (127/128/129), page edges and window edges
# (1023 -> 724, 427 -> 128, 2047 -> 1748) at different places, with a slot at
# maxT - 1; "zero" has every slot empty; "full" most slots at maxT - 1
LONG_LENGTHS = {
    "edges": [1, 127, 128, 129, 427, 600, 1023, 2047],
    "zero": [0] * 8,
    "full": [2047, 2047, 0, 2046, 2047, 1, 2047, 1999],
}


# f32 sums in another order: 1e-4 in f32; bf16 output rounding: 2e-2
@pytest.mark.parametrize("dtype,Dh,n_rep,atol", [(torch.bfloat16, 128, 4, 2e-2), (torch.bfloat16, 64, 8, 2e-2),
                                                 (torch.float32, 128, 4, 1e-4), (torch.float32, 64, 8, 1e-4)])
@pytest.mark.parametrize("page_len", [256, 24])
@pytest.mark.parametrize("lengths", list(LONG_LENGTHS))
@pytest.mark.parametrize("window", [0, 300])
def test_decode_attention_long_cache_matches_plain(gen, dtype, Dh, n_rep, atol, page_len, lengths, window):
    a = _long_inputs(gen, dtype, LONG_LENGTHS[lengths], Dh, n_rep, page_len)
    kw = dict(cur_k=a["cur_k"], cur_v=a["cur_v"], window=window)
    got = DA.ragged_decode_attention(a["q"], a["ck"], a["cv"], a["lengths"], **kw)
    want = DA.decode_attention_ref(a["q"], a["ck"], a["cv"], a["lengths"], **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    for staged in (False, True):
        if staged:
            kw.update(staged_k=a["sk"], staged_v=a["sv"], staged_count=a["count"])
        got = DA.paged_decode_attention(a["q"], a["kp"], a["vp"], a["lengths"], a["pt"], **kw)
        want = DA.decode_attention_ref(a["q"], a["kp"], a["vp"], a["lengths"], page_table=a["pt"], **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    if lengths == "zero" and window == 0:  # every slot empty: o is the current token's v
        want = a["cur_v"].repeat_interleave(n_rep, 1)
        got = DA.ragged_decode_attention(a["q"], a["ck"], a["cv"], a["lengths"], cur_k=a["cur_k"],
                                         cur_v=a["cur_v"])
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def test_paged_decode_attention_replays_in_a_cuda_graph(gen):
    """The launch reads nothing on the host: captured once, the call follows
    lengths (and staged counts) changed in place before each replay."""
    a = _long_inputs(gen, torch.bfloat16, [5, 300, 1000, 2047], 128, 4, 256)
    lengths, count = a["lengths"].clone(), a["count"].clone()
    args = (a["q"], a["kp"], a["vp"], lengths, a["pt"])
    kw = dict(cur_k=a["cur_k"], cur_v=a["cur_v"], window=0, staged_k=a["sk"], staged_v=a["sv"],
              staged_count=count)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        DA.paged_decode_attention(*args, **kw)  # build, bind and warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = DA.paged_decode_attention(*args, **kw)
    for new_len, new_count in (([0, 1, 2047, 129], [0, 1, 8, 4]), ([2000, 0, 17, 1500], [5, 2, 0, 8])):
        lengths.copy_(torch.tensor(new_len, dtype=torch.int32))
        count.copy_(torch.tensor(new_count, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want = DA.decode_attention_ref(a["q"], a["kp"], a["vp"], lengths, page_table=a["pt"], **kw)
        torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=0)


# M 1 .. 1024 across both paths (the crossover Q.DECODE_MAX_M = 64 and 64 +- 1) and both
# prefill tiles (128 tokens to M 128, 256 from 129), the N edges 48, 272 and 400 (no
# multiple of the 128-column tile), K 80, 208 and 2960 (no multiple of the 128-row decode
# stage or the 64-row prefill slab), and a wide N (8208 = 64 tiles + 16 columns) whose K is
# split over blocks, the last split short
INT8_CASES = [(1, 64, 48), (3, 80, 272), (8, 256, 1024), (77, 512, 96), (130, 128, 4096),
              (63, 336, 272), (64, 336, 1040), (65, 336, 272), (1024, 4096, 1024),
              (200, 208, 400), (129, 208, 400), (16, 2960, 8208)]


@pytest.mark.parametrize("M,K,N", INT8_CASES)
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


@pytest.mark.parametrize("M", [8, 64, 65, 1024])
def test_int8_paths_agree_where_both_run(gen, M):
    """Each path forced at M 8 .. 1024 (the decode path takes M <= 64) against the
    plain version, on a K split over blocks."""
    K, N = 1024, 1040
    qt = Q.quantize_int8(torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5)
    x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
    want = Q.int8_matmul_plain(x, qt).float()
    tol = 2e-2 * want.abs().max().item()
    for path in ((0, 1) if M <= Q.DECODE_MAX_M else (1,)):
        torch.testing.assert_close(Q._launch(x, qt, path).float(), want, atol=tol, rtol=0)


def test_int8_matmul_replays_in_a_cuda_graph(gen):
    """Nothing is read on the host and the split merge resets its tickets: captured
    once (decode path with K split, and prefill path), the calls follow new x
    copied in before each replay."""
    K, N = 4096, 1024
    qt = Q.quantize_int8(torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5)
    xs = [torch.zeros(M, K, dtype=torch.bfloat16, device="cuda") for M in (8, 256)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in xs:
            Q.int8_matmul(x, qt)  # build, bind, make the tickets outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [Q.int8_matmul(x, qt) for x in xs]
    for _ in range(3):
        for x in xs:
            x.copy_(torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16))
        graph.replay()
        torch.cuda.synchronize()
        for x, out in zip(xs, outs):
            want = Q.int8_matmul_plain(x, qt).float()
            torch.testing.assert_close(out.float(), want, atol=2e-2 * want.abs().max().item(), rtol=0)


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


def _flash_compare(gen, dtype, B, H, Hkv, T, D, causal, window, n_seg, seg_ids=None):
    """Every kernel against its plain version on the same inputs (segment
    ids ``seg_ids`` [T] when given, else ``n_seg`` random segments); returns
    the errors."""
    q, k, v, do, seg = _flash_inputs(gen, dtype, B, H, Hkv, T, D, n_seg)
    if seg_ids is not None:
        seg = seg_ids.to(device="cuda", dtype=torch.int32)[None].expand(B, T).contiguous()
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
    own one pad tile and no real row); or, for a tuple of E row counts, the
    layout given directly: each expert's rows padded to whole tiles (an
    expert with 0 rows owns no tile), then ``N`` more tiles that
    ``tile_group_map`` clamps to the last expert. The cotangent is zero on
    pad rows, as the combine's backward makes it."""
    from tony_tpu_torch.ops import moe_gemm as MG
    from tony_tpu_torch.parallel.expert import MoEConfig, route_ragged

    bf = torch.bfloat16
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device="cuda") * scale).to(bf)  # noqa: E731
    w = (r(E, D, F, scale=D ** -0.5), r(E, D, F, scale=D ** -0.5), r(E, F, D, scale=F ** -0.5))
    if isinstance(skew, tuple):
        T = MG.TILE
        sizes = torch.tensor(skew, device="cuda")
        gs = -(-sizes // T) * T
        tg = MG.tile_group_map(gs, int(gs.sum()) // T + N, T)
        xs = r(tg.shape[0] * T, D)
        real = torch.cat([torch.arange(g, device="cuda") < n for g, n in zip(gs.tolist(), skew)]
                         + [torch.zeros(N * T, dtype=torch.bool, device="cuda")])
        return xs, w, tg, (r(*xs.shape) * real[:, None]).contiguous()
    x = r(1, N, D)
    router = torch.randn(D, E, generator=gen, device="cuda") / D ** 0.5
    if skew == "two":
        router = torch.zeros(D, E, device="cuda")
        router[:, :2] = 1.0
        x = x.abs()
    sort_tok, _, _, gate_sorted, gs, _ = route_ragged(x, router, MoEConfig(E, 2), tile=MG.TILE)
    xs = x.reshape(N, D)[sort_tok.long()].contiguous()
    tg = MG.tile_group_map(gs, xs.shape[0] // MG.TILE, MG.TILE)
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
    (4, 384, 640, 300, "random"),              # D and F 128 mod 256
    (1, 256, 384, 1, (300,)),                  # one expert, a trailing tile clamped to it
    (4, 256, 512, 0, (0, 0, 700, 0)),          # every row on one expert
    (3, 256, 384, 2, (200, 0, 130)),           # an expert with no tile between two with tiles
    (2, 128, 256, 0, (100, 0)),                # PN of exactly one tile
    (8, 4096, 14336, 1000, "random"),          # a Mixtral-8x7B prefill
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


def test_moe_kernels_at_f_over_tp_match_plain_and_refuse_other_widths(gen):
    """B7/B8 at Mixtral-8x7B's experts on a model axis of 2 (each rank's
    ``[8, 4096, 7168]`` blocks) on 1000 routed tokens equal their plain
    versions within ``MOE_TOL``; a block of 7168 + 64 columns (not a
    multiple of 128) raises, naming the widths."""
    from tony_tpu_torch.ops import moe_gemm as MG

    E, D, F = 8, 4096, 14336 // 2
    xs, (wg, wu, wd), tg, dy = _moe_inputs(gen, E, D, F, 1000, "random")
    ys, grads = MG.moe_fwd(xs, wg, wu, wd, tg), MG.moe_bwd(xs, dy, wg, wu, wd, tg)
    want_ys, want = MG.moe_fwd_plain(xs, wg, wu, wd, tg), MG.moe_bwd_plain(xs, dy, wg, wu, wd, tg)
    assert _row_err(ys, want_ys) <= MOE_TOL and _row_err(grads[0], want[0]) <= MOE_TOL
    for got, exp in zip(grads[1:], want[1:]):
        for e in range(E):
            ref = exp[e].float()
            assert ((got[e].float() - ref).norm() / ref.norm()).item() <= MOE_TOL, e
    wide = torch.zeros(E, D, F + 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match=str(F + 64)):
        MG.moe_fwd(xs, wide, wide, torch.zeros(E, F + 64, D, dtype=torch.bfloat16, device="cuda"), tg)


@pytest.mark.parametrize("layout", ["span", (1100, 0, 640, 300)], ids=["routed", "empty_expert"])
def test_moe_kernels_on_an_expert_axis_span_match_plain(gen, layout):
    """B7/B8 on an expert-axis rank's span at Mixtral-8x7B widths, 4 of the
    8 experts (``[4, 4096, 14336]``): 2048 tokens routed top-2 over 8 with
    the rows of experts 0-3 kept ("routed"), and a layout whose second
    expert has no row ("empty_expert", one trailing tile clamped to the
    last): ys, dxs and each expert's dW within ``MOE_TOL`` of the plain
    versions, the empty expert's dW exactly 0 (JAX's
    ``test_fused_kernel_empty_experts``)."""
    from tony_tpu_torch.ops import moe_gemm as MG
    from tony_tpu_torch.parallel.expert import MoEConfig, route_ragged

    E, D, F = 4, 4096, 14336
    if layout == "span":
        x = torch.randn(1, 2048, D, generator=gen, device="cuda").to(torch.bfloat16)
        router = torch.randn(D, 2 * E, generator=gen, device="cuda") / D ** 0.5
        sort_tok, _, _, gate_sorted, gs, _ = route_ragged(x, router, MoEConfig(2 * E, 2), tile=MG.TILE)
        span = int(gs[:E].sum())
        xs = x.reshape(-1, D)[sort_tok[:span].long()].contiguous()
        tg = MG.tile_group_map(gs[:E], span // MG.TILE, MG.TILE)
        r = lambda *sh, scale=1.0: (torch.randn(*sh, generator=gen, device="cuda") * scale).to(torch.bfloat16)  # noqa: E731
        wg, wu, wd = r(E, D, F, scale=D ** -0.5), r(E, D, F, scale=D ** -0.5), r(E, F, D, scale=F ** -0.5)
        dy = (r(*xs.shape) * (gate_sorted[:span] != 0)[:, None]).contiguous()
    else:
        xs, (wg, wu, wd), tg, dy = _moe_inputs(gen, E, D, F, 1, layout)
    ys, grads = MG.moe_fwd(xs, wg, wu, wd, tg), MG.moe_bwd(xs, dy, wg, wu, wd, tg)
    want_ys, want = MG.moe_fwd_plain(xs, wg, wu, wd, tg), MG.moe_bwd_plain(xs, dy, wg, wu, wd, tg)
    assert _row_err(ys, want_ys) <= MOE_TOL and _row_err(grads[0], want[0]) <= MOE_TOL
    for got, exp in zip(grads[1:], want[1:]):
        for e in range(E):
            ref = exp[e].float()
            if ref.norm() == 0:
                assert bool((got[e] == 0).all()), e
                continue
            assert ((got[e].float() - ref).norm() / ref.norm()).item() <= MOE_TOL, e
    if layout != "span":
        assert all(bool((g[1] == 0).all()) for g in grads[1:])


def test_an_f32_mixtral_step_on_the_card_takes_the_grouped_product(gen):
    """JAX's eligibility rule, before any launch: an f32 Mixtral's loss and
    gradients on the card take the ``ragged_xla`` grouped product (no B7/B8
    launch, nothing raised) and equal the CPU's (the plain B7/B8 on the same
    f32 weights) within 1e-4."""
    import dataclasses

    from tony_tpu_torch.models import mixtral
    from tony_tpu_torch.ops import moe_gemm as MG

    cfg = dataclasses.replace(mixtral.MIXTRAL_TINY, dtype="float32", d_model=256, n_heads=4, n_kv_heads=2,
                              d_ff=256)
    params = mixtral.init(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = mixtral.synthetic_batch(torch.Generator().manual_seed(1), 2, 64, cfg)
    results = []
    for dev in ("cuda", "cpu"):
        p = {k: ({n: t.to(dev).requires_grad_(True) for n, t in v.items()} if isinstance(v, dict)
                 else v.to(dev).requires_grad_(True)) for k, v in params.items()}
        MG.reset_launches()
        loss, _ = mixtral.loss_fn(p, {k: v.to(dev) for k, v in batch.items()}, cfg)
        grads = torch.autograd.grad(loss, list(p["layers"].values()))
        results.append((loss.item(), [g.cpu() for g in grads], dict(MG.launches)))
    (lc, gc, launches), (lp, gp, _) = results
    assert launches == {"moe_fwd": 0, "moe_bwd": 0}
    assert abs(lc - lp) <= 1e-4 * abs(lp)
    for a, b in zip(gc, gp):
        assert ((a - b).norm() / b.norm().clamp_min(1e-30)).item() <= 1e-4


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


# -- ring attention (B9 forward step, B10 dq and dk/dv steps) ----------------------

def _ring_step_inputs(gen, dtype, B, H, Hkv, Tl, D, n_seg, my, n):
    """This shard's rows of q/do as a view of a [B, H, n·Tl, D] tensor (the
    held shards of a DeviceRing side by side), one held KV shard, the f32
    state, and segment ids over the whole sequence (its slice and the table)."""
    q, _, _, do, seg = _flash_inputs(gen, dtype, B, H, Hkv, n * Tl, D, n_seg)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    sl = slice(my * Tl, (my + 1) * Tl)
    k, v = r(B, Hkv, Tl, D).to(dtype), r(B, Hkv, Tl, D).to(dtype)
    segq = None if seg is None else seg[:, sl]
    return q[:, :, sl], do[:, :, sl], k, v, segq, seg


def _at_rows(t, n, my):
    """A copy of ``t`` [B, H, Tl(, D)] at rows my·Tl.. of a [B, H, n·Tl(, D)]
    tensor: the row layout of q's view, which the kernels share between q and
    every per-row tensor (acc, m, l, o, lse, do, delta, dq)."""
    Tl = t.shape[2]
    full = torch.zeros((*t.shape[:2], n * Tl, *t.shape[3:]), dtype=t.dtype, device=t.device)
    view = full[:, :, my * Tl:(my + 1) * Tl]
    view.copy_(t)
    return view


# (my, src, causal, window, segments) of one step of a ring of 3 shards of 200 rows
RING_STEPS = {
    "diagonal": (1, 1, True, 0, 1),
    "past": (2, 0, True, 0, 1),
    "window": (1, 0, True, 120, 1),
    "segments": (2, 1, True, 0, 3),
    "future-noncausal": (0, 2, False, 0, 1),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,n_rep", [(128, 4), (64, 1), (64, 8)])
@pytest.mark.parametrize("step", list(RING_STEPS))
def test_ring_step_kernels_match_plain(gen, dtype, D, n_rep, step):
    """One ring step of each kernel against its plain version on the same
    inputs and state: B9 as the first, a middle and the last step (acc, m, l;
    o, lse), B10's dq and riding dk/dv accumulators from a nonzero start."""
    from tony_tpu_torch.ops import ring as TR

    my, src, causal, window, n_seg = RING_STEPS[step]
    Tl, Hkv, n = 200, 2, 3
    H = Hkv * n_rep
    q, do, k, v, segq, segk = _ring_step_inputs(gen, dtype, 2, H, Hkv, Tl, D, n_seg, my, n)
    kw = dict(q_pos0=my * Tl, k_pos0=src * Tl, causal=causal, window=window, segq=segq, segk=segk)
    f32 = dict(dtype=torch.float32, device="cuda")
    rows = lambda t: _at_rows(t, n, my)  # noqa: E731
    # a state that a plain first step on another KV shard left
    k0, v0 = torch.randn_like(k.float()).to(dtype), torch.randn_like(v.float()).to(dtype)
    acc0, m0, l0 = torch.empty(q.shape, **f32), torch.empty(q.shape[:3], **f32), torch.empty(q.shape[:3], **f32)
    o_p, lse_p = torch.empty_like(q), torch.empty(q.shape[:3], **f32)
    TR.ring_fwd_step_plain(q, k0, v0, acc0, m0, l0, o_p, lse_p, **dict(kw, k_pos0=0, causal=False),
                           first=True)
    before = dict(TR.launches)
    for first, last in ((True, False), (False, False), (False, True)):
        st = [rows(t) for t in (acc0, m0, l0)]
        st_p = [t.clone() for t in (acc0, m0, l0)]
        o, lse = rows(torch.zeros_like(q)), rows(torch.zeros(q.shape[:3], **f32))
        o_p, lse_p = torch.zeros_like(q), torch.zeros(q.shape[:3], **f32)
        TR.ring_fwd_step(q, k, v, *st, o, lse, first=first, last=last, **kw)
        TR.ring_fwd_step_plain(q, k, v, *st_p, o_p, lse_p, first=first, last=last, **kw)
        torch.cuda.synchronize()
        if last:
            assert _row_err(o, o_p) <= ROW_TOL[dtype], f"o first={first}"
            assert (lse - lse_p).abs().max().item() <= LSE_ATOL
        else:
            assert _row_err(st[0], st_p[0]) <= ROW_TOL[dtype], f"acc first={first}"
            vis = st_p[1] > -1e29  # rows that saw a key: their max and sum
            assert torch.equal(vis, st[1] > -1e29)
            torch.testing.assert_close(st[1][vis], st_p[1][vis], atol=1e-4, rtol=0)
            torch.testing.assert_close(st[2], st_p[2], atol=0, rtol=1e-3)
    delta = (do.float() * o_p.float()).sum(-1)
    bwd = (q, k, v, do, rows(lse_p), rows(delta))
    dq0 = torch.randn(q.shape, **f32)
    dk0, dv0 = torch.randn(k.shape, **f32), torch.randn(v.shape, **f32)
    dq, dq_p = rows(dq0), dq0.clone()
    dk, dv, dk_p, dv_p = dk0.clone(), dv0.clone(), dk0.clone(), dv0.clone()
    TR.ring_bwd_dq_step(*bwd, dq, **kw)
    TR.ring_bwd_dkv_step(*bwd, dk, dv, **kw)
    TR.ring_bwd_dq_step_plain(*bwd, dq_p, **kw)
    TR.ring_bwd_dkv_step_plain(*bwd, dk_p, dv_p, **kw)
    torch.cuda.synchronize()
    for name, got, want, start in (("dq", dq, dq_p, dq0), ("dk", dk, dk_p, dk0), ("dv", dv, dv_p, dv0)):
        # the step's own contribution, held row by row
        assert _row_err(got - start, want - start) <= ROW_TOL[dtype], name
    assert TR.launches == {"ring_fwd": before["ring_fwd"] + 3, "ring_bwd_dq": before["ring_bwd_dq"] + 1,
                           "ring_bwd_dkv": before["ring_bwd_dkv"] + 1}


def _ring_pass(q, k, v, do, seg, n, window, plain, fwd=None):
    """The whole ring on a DeviceRing of n on the card (side-stream
    rotations): B9 forward → (o, lse), and B10 backward with the final
    rotation → (dq, dk, dv) from the forward ``fwd`` (o, lse; default this
    pass's own); ``plain`` swaps the plain steps in."""
    import contextlib
    from unittest import mock

    from tony_tpu_torch.ops import ring as TR
    from tony_tpu_torch.parallel.collectives import DeviceRing

    ring = DeviceRing(n, "cuda")
    names = ("ring_fwd_step", "ring_bwd_dq_step", "ring_bwd_dkv_step")
    with contextlib.ExitStack() as stack:
        for name in names if plain else ():
            stack.enter_context(mock.patch.object(TR, name, getattr(TR, name + "_plain")))
        segq, segk = TR._segments(ring, seg)
        o, lse = TR._ring_fwd(q, k, v, ring, True, window, segq, segk)
        o_b, lse_b = fwd if fwd is not None else (o, lse)
        grads = TR._ring_bwd(q, k, v, o_b, lse_b, do, ring, True, window, segq, segk)
    torch.cuda.synchronize()
    return (o, lse), grads


@pytest.mark.parametrize("dtype,B,H,Hkv,n,Tl,D,window,n_seg", [
    (torch.float32, 2, 8, 2, 4, 200, 64, 0, 1),
    (torch.float32, 1, 4, 4, 2, 96, 128, 150, 3),
    (torch.bfloat16, 2, 8, 2, 4, 200, 128, 300, 1),
    (torch.bfloat16, 1, 16, 2, 3, 333, 64, 0, 3),
    (torch.bfloat16, 1, 8, 2, 4, 4096, 128, 1024, 1),
    (torch.bfloat16, 1, 8, 2, 4, 4096, 128, 0, 3),
], ids=["f32", "f32-window-segments", "bf16-window", "bf16-segments-ragged", "bf16-Tl4096-window",
        "bf16-Tl4096-segments"])
def test_ring_on_card_matches_the_plain_ring(gen, dtype, B, H, Hkv, n, Tl, D, window, n_seg):
    """The ring through the kernels against the same ring through the plain
    steps, both on a DeviceRing on the card: o and lse forward; dq, dk and
    dv after the final rotation, both backwards from the plain forward's o
    and lse (as the flash tests share them); the launches follow the
    schedule."""
    from tony_tpu_torch.ops import ring as TR

    q, k, v, do, seg = _flash_inputs(gen, dtype, B, H, Hkv, n * Tl, D, n_seg)
    (o_p, lse_p), grads_p = _ring_pass(q, k, v, do, seg, n, window, plain=True)
    TR.reset_launches()
    (o, lse), grads = _ring_pass(q, k, v, do, seg, n, window, plain=False, fwd=(o_p, lse_p))
    runs = {"ring_fwd": sum(TR.fwd_step_runs(my, s, n, Tl, True, window) for my in range(n) for s in range(n)),
            "ring_bwd_dq": sum(TR.bwd_step_runs(my, s, n, Tl, True, window) for my in range(n) for s in range(n))}
    runs["ring_bwd_dkv"] = runs["ring_bwd_dq"]
    assert TR.launches == runs
    assert (lse - lse_p).abs().max().item() <= LSE_ATOL
    for name, g, w in zip(("o", "dq", "dk", "dv"), (o, *grads), (o_p, *grads_p)):
        assert g.dtype == dtype and bool(torch.isfinite(g.float()).all()), name
        assert _row_err(g, w) <= ROW_TOL[dtype], f"{name}: row err {_row_err(g, w)}"


def test_ring_at_a_context_model_ranks_local_heads_matches_the_plain_ring(gen):
    """B9/B10 at the shape a rank of ``context 2 × model 2`` gives them at
    Llama-3-8B widths: its 16 query heads and 4 kv heads (``H/2``,
    ``Hkv/2``) on a ring of 2 over T 8192 (Tl 4096), against the plain
    steps, o and lse, dq, dk and dv, with the schedule's launches."""
    from tony_tpu_torch.ops import ring as TR

    n, Tl = 2, 4096
    q, k, v, do, seg = _flash_inputs(gen, torch.bfloat16, 1, 16, 4, n * Tl, 128, 1)
    (o_p, lse_p), grads_p = _ring_pass(q, k, v, do, seg, n, 0, plain=True)
    TR.reset_launches()
    (o, lse), grads = _ring_pass(q, k, v, do, seg, n, 0, plain=False, fwd=(o_p, lse_p))
    fwd = sum(TR.fwd_step_runs(my, s, n, Tl, True, 0) for my in range(n) for s in range(n))
    bwd = sum(TR.bwd_step_runs(my, s, n, Tl, True, 0) for my in range(n) for s in range(n))
    assert TR.launches == {"ring_fwd": fwd, "ring_bwd_dq": bwd, "ring_bwd_dkv": bwd}
    assert (lse - lse_p).abs().max().item() <= LSE_ATOL
    for name, g, w in zip(("o", "dq", "dk", "dv"), (o, *grads), (o_p, *grads_p)):
        assert bool(torch.isfinite(g.float()).all()), name
        assert _row_err(g, w) <= ROW_TOL[torch.bfloat16], f"{name}: row err {_row_err(g, w)}"


def test_ring_autograd_on_card_matches_full_attention(gen):
    """``ring_attention_pallas_seg`` on the card against autograd through the
    full-sequence reference, in f32 (TF32 off)."""
    from tony_tpu_torch.ops import ring as TR
    from tony_tpu_torch.parallel.collectives import DeviceRing

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, seg = _flash_inputs(gen, torch.float32, 2, 8, 2, 4 * 96, 64, 3)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = TR.ring_attention_pallas_seg(*leaves, seg, DeviceRing(4, "cuda"), window=100)
    (o * do).sum().backward()
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o_r = A.attention_reference(ref[0], A.repeat_kv(ref[1], 4), A.repeat_kv(ref[2], 4),
                                segment_ids=seg, window=100)
    (o_r * do).sum().backward()
    torch.testing.assert_close(o, o_r, atol=2e-5, rtol=0)
    for a, b in zip(leaves, ref):
        assert (a.grad - b.grad).abs().max().item() / b.grad.abs().max().item() < 2e-4


def test_ring_kernels_refuse_what_they_do_not_take(gen):
    from tony_tpu_torch.ops import ring as TR
    from tony_tpu_torch.parallel.collectives import DeviceRing

    before = dict(TR.launches)
    q = torch.randn(1, 4, 256, 96, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        TR.ring_attention_pallas(q, q[:, :2], q[:, :2], DeviceRing(2, "cuda"))
    q = torch.randn(1, 4, 256, 64, device="cuda")
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        TR.ring_attention_pallas(q.half(), q[:, :2].half(), q[:, :2].half(), DeviceRing(2, "cuda"))
    assert TR.launches == before


# -- the Hopper bodies: determinism, segment skipping, ragged lengths ---------------

def _ring_compare(gen, dtype, B, H, Hkv, n, Tl, D, window, n_seg, seg_ids=None):
    """The ring through the kernels against the ring through the plain steps
    (both backwards from the plain forward), as
    ``test_ring_on_card_matches_the_plain_ring``; ``seg_ids`` [n·Tl] when given."""
    q, k, v, do, seg = _flash_inputs(gen, dtype, B, H, Hkv, n * Tl, D, n_seg)
    if seg_ids is not None:
        seg = seg_ids.to(device="cuda", dtype=torch.int32)[None].expand(B, n * Tl).contiguous()
    (o_p, lse_p), grads_p = _ring_pass(q, k, v, do, seg, n, window, plain=True)
    (o, lse), grads = _ring_pass(q, k, v, do, seg, n, window, plain=False, fwd=(o_p, lse_p))
    assert (lse - lse_p).abs().max().item() <= LSE_ATOL
    for name, g, w in zip(("o", "dq", "dk", "dv"), (o, *grads), (o_p, *grads_p)):
        assert g.dtype == dtype and bool(torch.isfinite(g.float()).all()), name
        assert _row_err(g, w) <= ROW_TOL[dtype], f"{name}: row err {_row_err(g, w)}"


@pytest.mark.parametrize("path", ["flash", "ring", "moe", "decode", "int8"])
def test_kernels_give_the_same_bits_twice(gen, path):
    """No float atomics: two runs on the same inputs give the same bits, B1-B3
    forward and backward, the whole ring pass (B9, B10), B7 and B8, B4/B5
    with their split merge, and B6 on both paths (decode with K split)."""
    if path == "int8":
        qt = Q.quantize_int8(torch.randn(4096, 1024, generator=gen, device="cuda") / 64)
        xs = [torch.randn(M, 4096, generator=gen, device="cuda").to(torch.bfloat16) for M in (8, 1024)]

        def run():
            return tuple(Q.int8_matmul(x, qt) for x in xs)
    elif path == "decode":
        a = _long_inputs(gen, torch.bfloat16, LONG_LENGTHS["edges"], 128, 4, 24)
        kw = dict(cur_k=a["cur_k"], cur_v=a["cur_v"], window=300)

        def run():
            return (DA.ragged_decode_attention(a["q"], a["ck"], a["cv"], a["lengths"], **kw),
                    DA.paged_decode_attention(a["q"], a["kp"], a["vp"], a["lengths"], a["pt"], staged_k=a["sk"],
                                              staged_v=a["sv"], staged_count=a["count"], **kw))
    elif path == "moe":
        from tony_tpu_torch.ops import moe_gemm as MG

        xs, (wg, wu, wd), tg, dy = _moe_inputs(gen, 8, 512, 1024, 1000, "random")

        def run():
            return (MG.moe_fwd(xs, wg, wu, wd, tg), *MG.moe_bwd(xs, dy, wg, wu, wd, tg))
    elif path == "flash":
        q, k, v, do, seg = _flash_inputs(gen, torch.bfloat16, 2, 8, 2, 1000, 128, 3)
        kw = dict(segment_ids=seg, window=300)

        def run():
            o, lse = A.flash_fwd(q, k, v, **kw)
            delta = (do.float() * o.float()).sum(-1)
            return (o, lse, A.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                    *A.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    else:
        q, k, v, do, seg = _flash_inputs(gen, torch.bfloat16, 1, 8, 2, 4 * 333, 128, 3)

        def run():
            (o, lse), grads = _ring_pass(q, k, v, do, seg, 4, 0, plain=False)
            return (o, lse, *grads)

    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _ids(*runs):
    """Segment ids [T] from (id, length) runs."""
    return torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in runs])


# segment layouts of T = 512 against the 128-row blocks (and 64-row tiles)
SEGMENT_LAYOUTS = {
    "tile-edge": _ids((0, 256), (1, 256)),                      # a boundary on a 128-row edge
    "off-edge": _ids((0, 300), (1, 212)),                       # a boundary inside a tile
    "inside-one-tile": _ids((0, 150), (1, 50), (2, 312)),       # a segment wholly in one tile
    "id0-padding": _ids((1, 200), (2, 180), (0, 132)),          # packed rows, then id-0 padding
    "skip-between": _ids((0, 128), (1, 128), (0, 128), (1, 128)),  # a tile skipped between two seen
}


@pytest.mark.parametrize("path", ["flash", "ring"])
@pytest.mark.parametrize("layout", list(SEGMENT_LAYOUTS))
def test_segment_skip_matches_plain(gen, path, layout):
    """Tiles whose query and key rows share no segment are skipped; every
    layout against the plain versions, D 128 and GQA, bf16."""
    seg = SEGMENT_LAYOUTS[layout]
    if path == "flash":
        _flash_compare(gen, torch.bfloat16, B=2, H=8, Hkv=2, T=512, D=128, causal=True, window=0,
                       n_seg=1, seg_ids=seg)
    else:
        _ring_compare(gen, torch.bfloat16, B=1, H=8, Hkv=2, n=4, Tl=128, D=128, window=0, n_seg=1,
                      seg_ids=seg)


@pytest.mark.parametrize("path", ["flash", "ring"])
@pytest.mark.parametrize("Tl,D", [(40, 64), (200, 128), (333, 64), (4160, 128)])
def test_ragged_and_short_lengths_match_plain(gen, path, Tl, D):
    """Lengths that are no multiple of the 128-row blocks, and one under a
    64-row tile: flash attention at T = Tl, the ring at Tl per shard."""
    if path == "flash":
        _flash_compare(gen, torch.bfloat16, B=1, H=8, Hkv=2, T=Tl, D=D, causal=True, window=0, n_seg=3)
    else:
        _ring_compare(gen, torch.bfloat16, B=1, H=8, Hkv=2, n=4, Tl=Tl, D=D, window=0, n_seg=3)


@pytest.mark.parametrize("model", ["llama", "mixtral"])
@pytest.mark.parametrize("layout", ["safetensors", "bin"])
@pytest.mark.parametrize("source", ["bfloat16", "float32"])
def test_hf_dir_loads_straight_onto_the_card_as_on_the_cpu(gen, tmp_path, model, layout, source):
    """``convert.load_hf_dir`` onto ``cuda:0``: the tensors move in their
    stored dtype and are transposed and cast on the card, with the bits of
    the CPU's load; an f32 checkpoint served in bf16 rounds on the card as
    the CPU rounds it (to nearest even)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from tony_tpu_torch.models import convert, llama, mixtral

    mod = llama if model == "llama" else mixtral
    cfg = mod.config_from_dict({"preset": "tiny", "dtype": source})
    params = mod.init(torch.Generator().manual_seed(0), cfg, "cpu")
    cs.write_hf_dir(tmp_path, cfg, cs.hf_state_dicts(cfg, params), layout)
    for dtype in (None, "bfloat16"):
        card, _ = convert.load_hf_dir(tmp_path, "cuda:0", dtype)
        host, _ = convert.load_hf_dir(tmp_path, "cpu", dtype)
        assert all(t.is_cuda for _, t in cs._leaves(card))
        assert cs.tree_mismatches(torch, {k: v for k, v in cs._leaves(card)},
                                  {k: v.cuda() for k, v in cs._leaves(host)}) == []


_PROCESS_RING = r"""
import datetime, sys, torch, torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from tony_tpu_torch.ops import ring as TR
from tony_tpu_torch.parallel.collectives import ProcessRing
rank, store, inp, out = int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
torch.cuda.set_device(0)
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=120))
ring = ProcessRing()
res = {}
for name, case in torch.load(inp).items():
    q, k, v, do, seg = (None if t is None else t.cuda() for t in case)
    Tl = q.shape[2] // 2
    sl = slice(rank * Tl, (rank + 1) * Tl)
    a, b, c = (t[:, :, sl].clone().requires_grad_(True) for t in (q, k, v))
    TR.reset_launches()
    if seg is None:
        o = TR.ring_attention_pallas(a, b, c, ring, window=100)
    else:
        o = TR.ring_attention_pallas_seg(a, b, c, seg[:, sl], ring)
    o.backward(do[:, :, sl])
    torch.cuda.synchronize()
    res[name] = {"grads": [t.cpu() for t in (o.detach(), a.grad, b.grad, c.grad)], "launches": dict(TR.launches)}
torch.save(res, out)
dist.destroy_process_group()
"""


def test_ring_kernels_over_a_two_process_gloo_ring_match_a_device_ring(gen, tmp_path):
    """B9/B10 with one context shard in each of two processes on the one card
    (``ProcessRing`` over gloo: KV and the riding dk/dv move between the
    processes) against a ``DeviceRing`` of 2 in this process on the same
    card, in bf16 and f32, with a window and with packed segments: each
    rank's o, dq, dk and dv the matching shard's within 1e-6 (the same
    kernels on the same inputs), and each rank's launches its half of the
    schedule's."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from tony_tpu_torch.ops import ring as TR
    from tony_tpu_torch.parallel.collectives import DeviceRing

    cases = {"bf16-window": _flash_inputs(gen, torch.bfloat16, 1, 8, 2, 2 * 512, 128, 1),
             "f32-segments": _flash_inputs(gen, torch.float32, 2, 8, 2, 2 * 200, 64, 3)}
    torch.save({n: [None if t is None else t.cpu() for t in c] for n, c in cases.items()}, tmp_path / "in.pt")
    root = str(Path(__file__).resolve().parents[1])
    procs = [subprocess.Popen([sys.executable, "-c", _PROCESS_RING, root, str(r), str(tmp_path / "store"),
                               str(tmp_path / "in.pt"), str(tmp_path / f"rank{r}.pt")],
                              env=dict(os.environ, PYTHONPATH=root), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    ring = DeviceRing(2, "cuda")
    for name, (q, k, v, do, seg) in cases.items():
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        TR.reset_launches()
        o = (TR.ring_attention_pallas(*leaves, ring, window=100) if seg is None
             else TR.ring_attention_pallas_seg(*leaves, seg, ring))
        o.backward(do)
        whole = [o.detach(), *(t.grad for t in leaves)]
        for r in range(2):
            sl = slice(r * q.shape[2] // 2, (r + 1) * q.shape[2] // 2)
            for what, mine, ref in zip(("o", "dq", "dk", "dv"), got[r][name]["grads"], whole):
                torch.testing.assert_close(mine.float(), ref[:, :, sl].float().cpu(), atol=1e-6, rtol=0,
                                           msg=f"{name} rank {r} {what}")
        assert {k: sum(g[name]["launches"][k] for g in got) for k in TR.launches} == TR.launches, name
