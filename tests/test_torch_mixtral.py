"""Port parity for the Mixtral slice on the CPU, in f32.

Config and presets, the init tree, the weight bridge, ``loss_fn`` with its
aux metrics and every gradient leaf, a 4-step trainer trajectory against
optax, and serving: greedy tokens of ``generate`` and ``ContinuousBatcher``
identical to the JAX engine's (prefill through ``moe_ffn``, decode through
the all-expert branch). Weights cross with ``params_from_numpy``; batches
are numpy tokens from a seed. On the CPU the port's expert MLP runs the
plain B7/B8 versions; JAX's runs ``ragged_dot`` (f32 is outside its kernel
gate): the same function.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tony_tpu.models import generate as JG  # noqa: E402
from tony_tpu.models import mixtral as JM  # noqa: E402
from tony_tpu.models import serving as JS  # noqa: E402
from tony_tpu.train import trainer as JT  # noqa: E402
from tony_tpu_torch.models import generate as TG  # noqa: E402
from tony_tpu_torch.models import mixtral as TM  # noqa: E402
from tony_tpu_torch.models import serving as TS  # noqa: E402
from tony_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from tony_tpu_torch.train import trainer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(dtype="float32")
# wider than tiny: D=128, F=256 (head_dim 32), 4 experts top-2
WIDE = dict(dtype="float32", d_model=128, d_ff=256, n_heads=4, n_kv_heads=2, vocab_size=512)
CONFIGS = {"tiny": TINY, "wide": WIDE}


def _jcfg(**kw):
    return dataclasses.replace(JM.MIXTRAL_TINY, **kw)


def _tcfg(**kw):
    return TM.config_from_dict({"preset": "tiny", **kw})


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _tokens(seed, B, T, V):
    return np.random.default_rng(seed).integers(0, V, (B, T + 1)).astype(np.int32)


def _packed_segments(B, T):
    """[B, T+1] segment ids: three segments per row, then a padding tail (0)."""
    seg = np.zeros((B, T + 1), np.int32)
    for b in range(B):
        cuts = sorted(np.random.default_rng(b).choice(np.arange(8, T - 8), 2, replace=False))
        seg[b, :cuts[0]], seg[b, cuts[0]:cuts[1]], seg[b, cuts[1]:T - 4] = 1, 2, 3
    return seg


@pytest.fixture(scope="module")
def params():
    out = {}
    for name, kw in CONFIGS.items():
        jp = JM.init(jax.random.PRNGKey(0), _jcfg(**kw))
        out[name] = (jp, jax.tree.map(np.asarray, jp))
    return out


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def test_config_and_presets_mirror_jax():
    """The presets equal JAX's field for field (each takes the ragged
    dispatch); a dict naming any of JAX's dispatches configures it, and one
    JAX does not know raises JAX's ValueError."""
    assert set(TM.PRESETS) == set(JM.PRESETS)
    for name, jcfg in JM.PRESETS.items():
        tcfg = TM.PRESETS[name]
        assert jcfg.moe_dispatch == "ragged", name
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), name
        assert dataclasses.asdict(tcfg.moe) == dataclasses.asdict(jcfg.moe), name
        for fn in ("num_params", "active_params", "flops_per_token"):
            assert getattr(tcfg, fn)() == getattr(jcfg, fn)(), (name, fn)
    assert TM.config_from_dict({"preset": "mixtral-8x7b", "n_layers": 2}).n_layers == 2
    assert TM.config_from_dict({"preset": "tiny", "moe_dispatch": "ragged", "capacity_factor": 2.0}) \
        == dataclasses.replace(TM.MIXTRAL_TINY, capacity_factor=2.0)
    for dispatch in ("ragged_xla", "gather", "dense"):
        assert TM.config_from_dict({"preset": "tiny", "moe_dispatch": dispatch}).moe.dispatch == dispatch
    with pytest.raises(ValueError, match="dispatch must be 'gather' or 'dense', got 'bogus'"):
        TM.config_from_dict({"preset": "tiny", "moe_dispatch": "bogus"})
    with pytest.raises(NotImplementedError, match="A8"):
        TM.forward({"embed": torch.zeros(8, 4)}, torch.zeros(1, 4, dtype=torch.long), _tcfg(),
                   mesh=object())


def test_init_tree_matches_jax_layout():
    """The same leaves with the same shapes and dtypes (bf16 weights, the
    router in f32)."""
    jp = JM.init(jax.random.PRNGKey(0), JM.MIXTRAL_TINY)
    tp = TM.init(torch.Generator().manual_seed(0), TM.MIXTRAL_TINY, "cpu")
    j, t = dict(_leaves(jp)), dict(_leaves(tp))
    assert j.keys() == t.keys()
    for name, a in j.items():
        assert tuple(t[name].shape) == a.shape, name
        assert str(t[name].dtype).removeprefix("torch.") == str(a.dtype), name
    assert t["layers/router"].dtype == torch.float32


def test_jax_mixtral_tree_crosses_the_bridge(params):
    """bf16 expert weights bit for bit and the f32 router as f32; then both
    packages compute the same function on the carried f32 tree."""
    jp = JM.init(jax.random.PRNGKey(1), JM.MIXTRAL_TINY)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["layers"]["router"].dtype == torch.float32
    assert tp["layers"]["we_gate"].dtype == torch.bfloat16
    for name, a in _leaves(jp):
        np.testing.assert_array_equal(dict(_leaves(tp))[name].float().numpy(),
                                      np.asarray(a, np.float32), err_msg=name)
    jp32, npp = params["tiny"]
    toks = _tokens(3, 2, 24, 256)[:, :-1]
    jl, jaux = JM.forward(jp32, jnp.asarray(toks), _jcfg(**TINY))
    tl, taux = TM.forward(params_from_numpy(npp, "cpu"), torch.from_numpy(toks), _tcfg(**TINY))
    assert _rel(tl.numpy(), np.asarray(jl)) < 1e-5
    assert abs(taux["moe_z_loss"].item() - float(jaux["moe_z_loss"])) < 1e-6


# f32 both sides; only the order of f32 sums differs: 1e-5 on the loss and
# the aux metrics, 1e-4 relative per gradient leaf
LOSS_ATOL = 1e-5
GRAD_REL = 1e-4


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "segments"])
@pytest.mark.parametrize("ce_chunk,remat", [(16, False), (0, True)], ids=["chunked-ce", "full-ce-remat"])
@pytest.mark.parametrize("which", list(CONFIGS))
def test_loss_aux_and_gradients_match_jax(params, which, packed, ce_chunk, remat):
    jp, npp = params[which]
    kw = dict(CONFIGS[which], ce_chunk=ce_chunk, remat=remat)
    T = 48
    batch = {"tokens": _tokens(1, 2, T, kw.get("vocab_size", 256))}
    if packed:
        batch["segment_ids"] = _packed_segments(2, T)
    (jl, jaux), jg = jax.value_and_grad(JM.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, _jcfg(**kw))

    tp = params_from_numpy(npp, "cpu")
    for _, t in _leaves(tp):
        t.requires_grad_(True)
    tl, taux = TM.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, _tcfg(**kw))
    names, tensors = zip(*_leaves(tp))
    grads = dict(zip(names, torch.autograd.grad(tl, tensors)))
    assert set(taux) == set(jaux)
    assert int(taux["tokens"]) == int(jaux["tokens"])
    assert abs(tl.item() - float(jl)) < LOSS_ATOL
    for k in ("ce_loss", "moe_balance_loss", "moe_z_loss", "moe_dropped_frac"):
        assert abs(taux[k].item() - float(jaux[k])) < LOSS_ATOL, k
    for name, g in _leaves(jax.tree.map(np.asarray, jg)):
        assert _rel(grads[name].numpy(), g) < GRAD_REL, name


def test_four_step_trajectory_matches_the_jax_trainer(params):
    """loss and grad_norm of every step and the final parameters against
    the optax chain (clip → adamw, warmup-cosine): 1e-5 relative on loss and
    grad_norm, 1e-4 relative per final leaf."""
    _, npp = params["tiny"]
    opt_cfg = dict(learning_rate=1e-3, warmup_steps=1, total_steps=4)
    batches = [_tokens(10 + i, 2, 32, 256) for i in range(4)]
    jcfg, tcfg = _jcfg(**TINY), _tcfg(**TINY)

    jopt = JT.OptimizerConfig(**opt_cfg).build()
    jstate = JT.TrainState.create(jax.tree.map(jnp.asarray, npp), jopt)
    jstep = JT.make_train_step(lambda p, b: JM.loss_fn(p, b, jcfg), jopt)
    topt = TT.OptimizerConfig(**opt_cfg).build()
    tstate = TT.TrainState.create(params_from_numpy(npp, "cpu"), topt)
    tstep = TT.make_train_step(lambda p, b: TM.loss_fn(p, b, tcfg), topt)
    for toks in batches:
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(toks)})
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), (k, tm[k], jm[k])
        assert "moe_balance_loss" in tm and "moe_z_loss" in tm
    tparams = dict(_leaves(tstate.params))
    for name, p in _leaves(jax.tree.map(np.asarray, jstate.params)):
        assert _rel(tparams[name].detach().numpy(), p) < 1e-4, name


# -- serving -----------------------------------------------------------------

SERVE = dict(dtype="float32", max_seq=64)


@pytest.fixture(scope="module")
def serve_params():
    jp = JM.init(jax.random.PRNGKey(0), _jcfg(**SERVE))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_generate_matches_forward_argmax(serve_params):
    """Teacher-forced: greedy decode reproduces the training forward's
    argmax chain. The 20-token prompt prefills through ``moe_ffn`` (more than
    16 tokens); decode takes the all-expert branch."""
    _, tp = serve_params
    cfg = _tcfg(**SERVE)
    prompt = torch.from_numpy(_tokens(4, 1, 20, 256)[:, :-1])
    out = TG.generate(tp, prompt, cfg, max_new_tokens=4)
    toks = torch.cat([prompt, out.long()], dim=1)
    logits, _ = TM.forward(tp, toks[:, :-1], cfg)
    want = logits[0, prompt.shape[1] - 1:].argmax(-1)
    assert out[0].tolist() == want.tolist()


@pytest.mark.parametrize("Tp", [5, 20])
def test_generate_greedy_matches_jax(serve_params, Tp):
    jp, tp = serve_params
    toks = _tokens(5, 2, Tp, 256)[:, :-1]
    want = JG.generate(jp, jnp.asarray(toks), _jcfg(**SERVE), max_new_tokens=5)
    got = TG.generate(tp, torch.from_numpy(toks), _tcfg(**SERVE), max_new_tokens=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kw", [dict(kv="dense"), dict(kv="paged", page_len=16, decode_chunk=4)],
                         ids=["dense", "paged"])
def test_continuous_batcher_tokens_identical_to_jax(serve_params, kw):
    """The port of ``tests/test_serving.py``'s Mixtral engine test: every
    request's greedy tokens equal ``generate`` and the JAX engine's; prompts
    of 4 and 20 tokens (bucketed prefill of 16 and 32 rows, the second
    through ``moe_ffn``)."""
    jp, tp = serve_params
    prompts = [_tokens(10 + i, 1, n, 256)[0, :-1].tolist() for i, n in enumerate((4, 20, 4))]
    je = JS.ContinuousBatcher(jp, _jcfg(**SERVE), num_slots=2, max_len=64, **kw)
    te = TS.ContinuousBatcher(tp, _tcfg(**SERVE), num_slots=2, max_len=64, **kw)
    for eng in (je, te):
        for p in prompts:
            eng.submit(p, 5)
    want, got = je.run(), te.run()
    assert got == want
    for rid, p in enumerate(prompts):
        alone = TG.generate(tp, torch.tensor([p]), _tcfg(**SERVE), max_new_tokens=5)
        assert got[rid] == alone[0].tolist(), rid


def test_pretrain_mixtral_cli_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "tony_tpu_torch.train.pretrain_mixtral", "--preset", "tiny",
         "--device", "cpu", "--steps", "2", "--batch_size", "2", "--seq_len", "32",
         "--log_every", "1", "--warmup_steps", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert [x["step"] for x in lines] == [1, 2]
    for x in lines:
        assert np.isfinite(x["loss"]) and x["moe_balance_loss"] > 0 and x["moe_z_loss"] > 0
        assert x["moe_dropped_frac"] == 0.0
