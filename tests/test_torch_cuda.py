"""On-card tests of the port's CUDA kernels against their plain PyTorch
versions (marked ``cuda``; they skip without a card — the kernels have no
CPU mode). On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest imports JAX, which these tests do
not need.)
"""

import pytest

torch = pytest.importorskip("torch")

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
