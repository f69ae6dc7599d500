"""Port parity for the whole serving slice on LLAMA_TINY in f32 (CPU):
weights carried across by ``params_from_numpy``; logits within 1e-4 and the
continuous-batching engines' greedy tokens IDENTICAL to the JAX engine's."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tony_tpu.models import generate as JG  # noqa: E402
from tony_tpu.models import serving as JS  # noqa: E402
from tony_tpu.models.llama import LLAMA_TINY  # noqa: E402
from tony_tpu.models.llama import init as jax_init  # noqa: E402
from tony_tpu.ops import quant as JQ  # noqa: E402
from tony_tpu_torch.models import generate as TG  # noqa: E402
from tony_tpu_torch.models import serving as TS  # noqa: E402
from tony_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from tony_tpu_torch.models.llama import PRESETS, config_from_dict  # noqa: E402
from tony_tpu_torch.ops import quant as TQ  # noqa: E402

CFG = dataclasses.replace(LLAMA_TINY, dtype="float32")


@pytest.fixture(scope="module")
def params():
    jp = jax_init(jax.random.PRNGKey(0), CFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tcfg():
    return config_from_dict({"preset": "tiny", "dtype": "float32"})


def test_config_and_presets_mirror_jax():
    from tony_tpu.models.llama import PRESETS as JP

    assert set(PRESETS) == set(JP)
    for name, jcfg in JP.items():
        assert dataclasses.asdict(PRESETS[name]) == dataclasses.asdict(jcfg), name
        assert PRESETS[name].head_dim == jcfg.head_dim
        assert PRESETS[name].num_params() == jcfg.num_params()


def test_bf16_leaves_cross_the_bridge_bit_for_bit():
    jp = jax_init(jax.random.PRNGKey(1), LLAMA_TINY)  # bf16 params
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["layers"]["wq"].float().numpy(),
                                  np.asarray(jp["layers"]["wq"], np.float32))


def test_prefill_and_decode_logits_match_jax(params):
    jp, tp = params
    toks = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 11)).astype(np.int32)
    jl, jc = JG.prefill(jp, jnp.asarray(toks), JG.init_cache(CFG, 2, 32), CFG)
    tl, tc = TG.prefill(tp, torch.from_numpy(toks), TG.init_cache(_tcfg(), 2, 32, "cpu"), _tcfg())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-4, rtol=0)
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    jl2, _ = JG._forward_with_cache(jp, jnp.asarray(nxt), jc, CFG)
    tl2, tc2 = TG._forward_with_cache(tp, torch.from_numpy(nxt), tc, _tcfg())
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-4, rtol=0)
    assert tc2.length == 12


def test_generate_greedy_matches_jax(params):
    jp, tp = params
    toks = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 5)).astype(np.int32)
    want = JG.generate(jp, jnp.asarray(toks), CFG, max_new_tokens=6)
    got = TG.generate(tp, torch.from_numpy(toks), _tcfg(), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_logits_keep_set_contains_jax_draws():
    """Greedy rows equal argmax; every JAX draw lies in the port's keep set
    (top-k then nucleus over one sort) — the draws themselves differ."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 64)).astype(np.float32) * 3
    temp = np.array([0.0, 1.0, 0.7, 1.3], np.float32)
    topk = np.array([0, 5, 0, 3], np.int32)
    topp = np.array([0.0, 0.0, 0.6, 0.9], np.float32)
    _, keep = TG.sample_keep(torch.from_numpy(logits), torch.from_numpy(temp),
                             torch.from_numpy(topk), torch.from_numpy(topp))
    keep = keep.numpy()
    assert keep[1].sum() == 5 and keep[3].sum() <= 3 and 1 <= keep[2].sum() < 64
    for seed in range(20):
        j = np.asarray(JG.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(seed),
                                        jnp.asarray(temp), jnp.asarray(topk), jnp.asarray(topp)))
        assert j[0] == logits[0].argmax()
        assert all(keep[r, j[r]] for r in range(1, 4)), (seed, j)
    g = torch.Generator().manual_seed(0)
    t = TG.sample_logits(torch.from_numpy(logits), g, torch.from_numpy(temp),
                         torch.from_numpy(topk), torch.from_numpy(topp)).numpy()
    assert t[0] == logits[0].argmax() and all(keep[r, t[r]] for r in range(1, 4))


_SHARED = list(range(3, 35))  # one full 32-token page, shared by two prompts
PROMPTS = [_SHARED + [40, 41, 42], [7, 8, 9, 10, 11], _SHARED + [50], [60, 61, 62]]


def _run_both(jp, tp, **kw):
    je = JS.ContinuousBatcher(jp, CFG, num_slots=3, max_len=128, **kw)
    te = TS.ContinuousBatcher(tp, _tcfg(), num_slots=3, max_len=128, **kw)
    for eng in (je, te):
        for i, p in enumerate(PROMPTS):
            eng.submit(p, 5 + i)
    return je, je.run(), te, te.run()


@pytest.mark.parametrize("kw", [
    dict(kv="dense", attn="bucketed"),
    dict(kv="dense", attn="ragged", decode_chunk=4),
    dict(kv="paged", page_len=32, decode_chunk=4),
    dict(kv="paged", page_len=32, decode_chunk=4, prefill_chunk=16),
], ids=["dense-bucketed", "dense-ragged", "paged", "paged-chunked-prefill"])
def test_engine_greedy_tokens_identical_to_jax(params, kw):
    jp, tp = params
    je, want, te, got = _run_both(jp, tp, **kw)
    assert got == want
    assert all(len(got[i]) == 5 + i for i in range(len(PROMPTS)))
    if kw["kv"] == "paged":
        assert te.prefix_hit_tokens == je.prefix_hit_tokens > 0


def test_int8_engine_greedy_tokens_identical_to_jax(params):
    jp, _ = params
    jq, _, _ = JQ.quantize_tree(jp, min_size=1)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    assert isinstance(tq["layers"]["wq"], TQ.QTensor) and isinstance(tq["lm_head"], TQ.QTensor)
    je, want, te, got = _run_both(jq, tq, kv="paged", page_len=32, decode_chunk=4)
    assert got == want
