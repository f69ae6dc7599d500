"""Port parity for ResNet (``tony_tpu_torch.models.resnet``) on the CPU, in f32.

JAX's SAME padding for each conv shape ResNet-50 meets and for the max pool
against ``jax.lax`` (and symmetric padding failing the same check); the
functional BatchNorm (output, biased running statistics, gradients) in
train and eval mode; the space-to-depth stem against JAX's and against the
plain stem; the ``tiny`` preset's forward (logits and every ``bn_state``
leaf, train and eval), ``loss_fn`` (loss, accuracy, every gradient leaf)
and a 3-step AdamW trajectory with ``bn_state`` threaded through batch and
metrics as ``examples/resnet/train.py`` does; ``SGD`` against
``optax.sgd``; ResNet-50's parameter and state counts against JAX's
``eval_shape``; the ``accum_steps`` refusal; the ``train_resnet`` and
``bench_resnet`` entry points. Weights cross with
``resnet.params_from_numpy`` (HWIO → OIHW); inputs are numpy arrays from a
seed.
"""

import json
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tony_tpu.models import resnet as JR  # noqa: E402
from tony_tpu.train import trainer as JT  # noqa: E402
from tony_tpu_torch.models import resnet as TR  # noqa: E402
from tony_tpu_torch.train import bench_resnet, train_resnet  # noqa: E402
from tony_tpu_torch.train import trainer as TT  # noqa: E402

# f32 both sides; only the order of the f32 sums differs (XLA's convolutions
# and reductions against oneDNN's and ATen's), so values agree to ~1e-6 of
# their scale. Relative to the largest magnitude of each array:
CONV_REL = 1e-5     # one conv or pool
BN_REL = 1e-5       # one BatchNorm: output, statistics, gradients
MODEL_REL = 1e-4    # the tiny ResNet-18: logits, loss, every state and gradient leaf
# params and state after 3 AdamW steps: Adam's normalised step turns the
# gradients' f32 noise into ~7e-5 of the BN biases, which start at 0 and
# are nothing but their steps (5.7e-5 to 7.4e-5 over 1 to 8 CPU threads)
TRAJ_REL = 2e-4
B = 8


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _to_jax_layout(t: torch.Tensor) -> np.ndarray:
    """A port leaf as the JAX tree holds it (OIHW conv weights back to HWIO)."""
    a = t.detach().float().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# -- SAME padding ---------------------------------------------------------------

# (kernel, stride, input length): each conv shape of ResNet-50 (the 7×7/2 stem
# on an even image, 3×3/2 and 1×1/2 on even maps, 3×3/1), and odd lengths
CONV_CASES = [(7, 2, 16), (7, 2, 15), (3, 2, 8), (3, 2, 9), (1, 2, 8), (1, 2, 7), (3, 1, 8), (3, 1, 7)]


@pytest.mark.parametrize("k,s,n", CONV_CASES)
def test_conv_pads_as_jax_same(k, s, n):
    rng = np.random.default_rng(k * 100 + s * 10 + n)
    x = rng.standard_normal((2, n, n, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4, 5)).astype(np.float32)
    want = np.asarray(JR._conv(jnp.asarray(x), jnp.asarray(w), s))
    got = _nhwc(TR._conv(_nchw(x), torch.from_numpy(w).permute(3, 2, 0, 1), s))
    assert got.shape == want.shape
    assert _rel(got, want) <= CONV_REL


def _jax_pool(x):
    return np.asarray(jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                            (1, 3, 3, 1), (1, 2, 2, 1), "SAME"))


@pytest.mark.parametrize("n", [8, 9, 112])
def test_max_pool_pads_as_jax_same(n):
    """Normal inputs, so that a zero pad and a -inf pad differ."""
    x = np.random.default_rng(n).standard_normal((2, n, n, 3)).astype(np.float32)
    want = _jax_pool(x)
    got = _nhwc(TR._max_pool(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_symmetric_padding_has_the_same_shapes_and_fails_the_check():
    """``padding=k // 2`` gives SAME's shapes but not its numbers: the check
    the port's convs and pool pass must fail it."""
    rng = np.random.default_rng(0)
    for k, n in ((3, 8), (7, 16)):
        x = rng.standard_normal((2, n, n, 4)).astype(np.float32)
        w = rng.standard_normal((k, k, 4, 5)).astype(np.float32)
        want = np.asarray(JR._conv(jnp.asarray(x), jnp.asarray(w), 2))
        sym = _nhwc(torch.nn.functional.conv2d(_nchw(x), torch.from_numpy(w).permute(3, 2, 0, 1),
                                               stride=2, padding=k // 2))
        assert sym.shape == want.shape and _rel(sym, want) > CONV_REL
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    sym = _nhwc(torch.nn.functional.max_pool2d(_nchw(x), 3, 2, padding=1))
    want = _jax_pool(x)
    assert sym.shape == want.shape and _rel(sym, want) > CONV_REL
    assert TR.same_pads(224, 7, 2) == (2, 3) and TR.same_pads(112, 3, 2) == (0, 1)


# -- BatchNorm, the stem ------------------------------------------------------------

def _bn_inputs(seed=0, C=6):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 5, 5, C)) * rng.uniform(0.5, 3, C) + rng.uniform(-2, 2, C)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32), "bias": rng.standard_normal(C).astype(np.float32)}
    s = {"mean": rng.standard_normal(C).astype(np.float32), "var": rng.uniform(0.5, 2, C).astype(np.float32)}
    r = rng.standard_normal(x.shape).astype(np.float32)
    return x, p, s, r


@pytest.mark.parametrize("train", [True, False])
def test_bn_matches_jax_with_its_running_statistics_and_gradients(train):
    x, p, s, r = _bn_inputs()

    def jloss(x, p):
        out, new_s = JR._bn(x, p, jax.tree.map(jnp.asarray, s), 0.9, train)
        return jnp.sum(out * r), (out, new_s)

    (_, (jout, jnew)), (jgx, jgp) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    tx = _nchw(x).requires_grad_(True)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    out, new_s = TR._bn(tx, tp, {k: torch.from_numpy(v) for k, v in s.items()}, 0.9, train)
    gx, gs, gb = torch.autograd.grad((out * _nchw(r)).sum(), (tx, tp["scale"], tp["bias"]))
    assert _rel(_nhwc(out), jout) <= BN_REL
    for k in ("mean", "var"):
        assert not new_s[k].requires_grad
        assert _rel(new_s[k].numpy(), jnew[k]) <= BN_REL, k
    assert _rel(_nhwc(gx), jgx) <= BN_REL
    assert _rel(gs.numpy(), jgp["scale"]) <= BN_REL and _rel(gb.numpy(), jgp["bias"]) <= BN_REL
    if train:  # the biased variance: with torch's unbiased one the update is off by n/(n-1)
        n = x.shape[0] * x.shape[1] * x.shape[2]
        unbiased = 0.9 * s["var"] + 0.1 * x.reshape(-1, x.shape[-1]).var(0, ddof=1)
        assert _rel(unbiased, jnew["var"]) > 1e-3 > BN_REL and n > 1


def test_space_to_depth_stem_matches_jax_and_the_plain_stem():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    w = rng.standard_normal((7, 7, 3, 8)).astype(np.float32)
    want = np.asarray(JR._stem_conv_s2d(jnp.asarray(img), jnp.asarray(w)))
    tw = torch.from_numpy(w).permute(3, 2, 0, 1)
    got = _nhwc(TR._stem_conv_s2d(torch.from_numpy(img), tw))
    plain = _nhwc(TR._conv(_nchw(img), tw, 2))
    assert got.shape == want.shape == plain.shape == (2, 8, 8, 8)
    assert _rel(got, want) <= CONV_REL and _rel(got, plain) <= CONV_REL


# -- the tiny model ------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny params and state, a random running state for eval, and
    two batches as numpy arrays."""
    cfg = JR.RESNET_TINY
    jp, js = jax.jit(JR.init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(5)
    npp, nps = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)

    def running(bn):
        return {"mean": (rng.standard_normal(bn["mean"].shape) * 0.1).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)}

    eval_state = jax.tree.map(running, nps, is_leaf=lambda d: isinstance(d, dict) and "mean" in d)
    batches = [{"image": rng.uniform(0, 1, (B, 32, 32, 3)).astype(np.float32),
                "label": rng.integers(0, cfg.num_classes, B).astype(np.int32)} for _ in range(3)]
    return cfg, npp, nps, eval_state, batches


def _port(npp, nps):
    return TR.params_from_numpy(npp, "cpu"), TR.state_from_numpy(nps, "cpu")


@pytest.mark.parametrize("train", [True, False])
def test_tiny_forward_matches_jax(tiny, train):
    cfg, npp, nps, eval_state, batches = tiny
    state = nps if train else eval_state
    jlogits, jstate = jax.jit(lambda p, s, x: JR.forward(p, s, x, cfg, train=train))(
        jax.tree.map(jnp.asarray, npp), jax.tree.map(jnp.asarray, state), jnp.asarray(batches[0]["image"]))
    params, tstate = _port(npp, state)
    with torch.no_grad():
        logits, new_state = TR.forward(params, tstate, torch.from_numpy(batches[0]["image"]),
                                       TR.RESNET_TINY, train=train)
    assert logits.shape == (B, cfg.num_classes)
    assert _rel(logits.numpy(), jlogits) <= MODEL_REL
    want = dict(_leaves(jax.tree.map(np.asarray, jstate)))
    got = dict(_leaves(new_state))
    assert got.keys() == want.keys() and len(got) == 2 * 20
    for name, v in want.items():
        assert _rel(got[name].numpy(), v) <= MODEL_REL, name


def test_tiny_loss_accuracy_state_and_every_gradient_match_jax(tiny):
    cfg, npp, nps, _, batches = tiny
    jb = {**{k: jnp.asarray(v) for k, v in batches[0].items()}, "bn_state": jax.tree.map(jnp.asarray, nps)}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(lambda p, b: JR.loss_fn(p, b, cfg), has_aux=True))(
        jax.tree.map(jnp.asarray, npp), jb)
    params, state = _port(npp, nps)
    names, tensors = zip(*_leaves(params))
    for t in tensors:
        t.requires_grad_(True)
    batch = {"image": torch.from_numpy(batches[0]["image"]), "label": torch.from_numpy(batches[0]["label"]),
             "bn_state": state}
    loss, aux = TR.loss_fn(params, batch, TR.RESNET_TINY)
    grads = torch.autograd.grad(loss, tensors)
    assert abs(loss.item() - float(jloss)) <= MODEL_REL * abs(float(jloss))
    assert aux["accuracy"].item() == float(jaux["accuracy"]) and aux["loss"] is loss
    for name, v in _leaves(jax.tree.map(np.asarray, jaux["bn_state"])):
        assert _rel(dict(_leaves(aux["bn_state"]))[name].numpy(), v) <= MODEL_REL, name
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    assert set(names) == want.keys()
    for name, g in zip(names, grads):
        assert g.shape == tensors[names.index(name)].shape
        assert _rel(_to_jax_layout(g), want[name]) <= MODEL_REL, name


def test_three_step_trajectory_threads_bn_state_as_the_jax_example(tiny):
    """make_train_step + AdamW on both sides, ``bn_state`` put in the batch
    and popped from the metrics each step (``examples/resnet/train.py``):
    the loss each step, then every param and state leaf after 3 steps."""
    cfg, npp, nps, _, batches = tiny
    opt_cfg = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    jopt = JT.OptimizerConfig(**opt_cfg).build()
    jstate = JT.TrainState.create(jax.tree.map(jnp.asarray, npp), jopt)
    jstep = JT.make_train_step(lambda p, b: JR.loss_fn(p, b, cfg), jopt)
    jbn, want = jax.tree.map(jnp.asarray, nps), []
    for b in batches:
        jstate, m = jstep(jstate, {**{k: jnp.asarray(v) for k, v in b.items()}, "bn_state": jbn})
        jbn = m.pop("bn_state")
        want.append(float(m["loss"]))

    params, bn = _port(npp, nps)
    topt = TT.OptimizerConfig(**opt_cfg).build()
    state = TT.TrainState.create(params, topt)
    tstep = TT.make_train_step(lambda p, b: TR.loss_fn(p, b, TR.RESNET_TINY), topt)
    got = []
    for b in batches:
        state, m = tstep(state, {**{k: torch.from_numpy(v) for k, v in b.items()}, "bn_state": bn})
        bn = m.pop("bn_state")
        got.append(float(m["loss"]))
    for tl, jl in zip(got, want):
        assert abs(tl - jl) <= TRAJ_REL * abs(jl), (got, want)
    jparams = dict(_leaves(jax.tree.map(np.asarray, jstate.params)))
    for name, p in _leaves(state.params):
        assert _rel(_to_jax_layout(p), jparams[name]) <= TRAJ_REL, name
    jbn = dict(_leaves(jax.tree.map(np.asarray, jbn)))
    for name, v in _leaves(bn):
        assert not v.requires_grad and _rel(v.numpy(), jbn[name]) <= TRAJ_REL, name


# -- SGD, sizes, refusals, entry points ------------------------------------------------

def test_sgd_matches_optax_sgd_over_three_steps():
    rng = np.random.default_rng(2)
    tree = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)}, "b": rng.standard_normal(5).astype(np.float32)}
    grads = [jax.tree.map(lambda v: rng.standard_normal(v.shape).astype(np.float32), tree) for _ in range(3)]
    opt = optax.sgd(0.1, momentum=0.9)
    jp = jax.tree.map(jnp.asarray, tree)
    js = opt.init(jp)
    params = {"a": {"w": torch.from_numpy(tree["a"]["w"].copy())}, "b": torch.from_numpy(tree["b"].copy())}
    sgd = TT.SGD(0.1, momentum=0.9)
    ts = sgd.init(params)
    for g in grads:
        upd, js = opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        sgd.update(params, {n: torch.from_numpy(v) for n, v in _leaves(g)}, ts)
    want_p = dict(_leaves(jax.tree.map(np.asarray, jp)))
    want_t = dict(_leaves(jax.tree.map(np.asarray, js[0].trace)))
    for name, p in _leaves(params):
        assert _rel(p.numpy(), want_p[name]) <= 1e-6 and _rel(ts["trace"][name].numpy(), want_t[name]) <= 1e-6
    bf = {"w": torch.ones(4, dtype=torch.bfloat16)}
    assert TT.SGD(0.1, 0.9).init(bf)["trace"]["w"].dtype == torch.bfloat16  # the parameter dtype


def test_resnet50_counts_match_jax_eval_shape():
    jp, js = jax.eval_shape(lambda k: JR.init(k, JR.RESNET50), jax.random.PRNGKey(0))
    want = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(jp))
    params, state = TR.init(torch.Generator().manual_seed(0), TR.RESNET50, "cpu")
    assert sum(t.numel() for _, t in _leaves(params)) == want == 25_557_032
    assert len(list(_leaves(state))) == len(jax.tree.leaves(js)) == 106
    shapes = dict(_leaves(jp))
    assert dict(_leaves(params)).keys() == shapes.keys()
    for name, t in _leaves(params):
        v = shapes[name]
        assert t.dtype == torch.bfloat16
        assert tuple(t.shape) == (tuple(v.shape[i] for i in (3, 2, 0, 1)) if t.dim() == 4 else v.shape)
        if t.dim() == 4:
            assert t.is_contiguous(memory_format=torch.channels_last)
    assert TR.config_from_dict({"preset": "tiny", "stem_s2d": True}) == TR.ResNetConfig(
        depth=18, num_classes=10, width=8, image_size=32, dtype="float32", stem_s2d=True)


def test_accumulation_over_a_batch_with_bn_state_is_refused_by_name():
    params, state = TR.init(torch.Generator().manual_seed(0), TR.RESNET_TINY, "cpu")
    opt = TT.OptimizerConfig().build()
    step = TT.make_train_step(lambda p, b: TR.loss_fn(p, b, TR.RESNET_TINY), opt, accum_steps=2)
    batch = TR.synthetic_batch(torch.Generator().manual_seed(1), 4, TR.RESNET_TINY)
    batch["bn_state"] = state
    with pytest.raises(ValueError, match=r"\['bn_state'\].*accum_steps=1"):
        step(TT.TrainState.create(params, opt), batch)
    with pytest.raises(NotImplementedError, match="A8"):
        TR.forward(params, state, batch["image"], TR.RESNET_TINY, mesh=object())


def test_train_resnet_prints_the_jax_line_and_moves_the_running_statistics(capsys):
    out = train_resnet.run(["--preset", "tiny", "--device", "cpu", "--steps", "3", "--log_every", "1",
                            "--batch_size", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert [int(re.fullmatch(r"step (\d+) loss=\d+\.\d{4} acc=\d\.\d{3}", x).group(1)) for x in lines] == [1, 2, 3]
    assert all(np.isfinite(x["loss"]) for x in out["log"])
    assert all(v.abs().max() > 0 for n, v in _leaves(out["bn_state"]) if n.endswith("mean"))


def test_bench_resnet_prints_the_jax_record(capsys):
    rec = bench_resnet.run(["--preset", "tiny", "--device", "cpu", "--batch", "4", "--steps", "2", "--warmup", "2"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == rec
    assert list(rec) == ["metric", "value", "unit", "step_time_ms", "batch", "mfu"]
    assert rec["metric"] == "resnet50_train_images_per_sec_1chip" and rec["unit"] == "images/sec/chip"
    assert rec["batch"] == 4 and rec["value"] > 0
