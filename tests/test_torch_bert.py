"""Port parity for BERT MLM (``tony_tpu_torch.models.bert``) on the CPU, in f32.

The config and presets against the JAX package's; ``loss_fn`` and every
gradient against the JAX model on the flash path (JAX's Pallas B1-B3 in
interpret mode at T=128, the shortest length its flash gate takes; the
port's plain kernel versions through its autograd function, non-causal)
and on the reference path, in the gathered and dense layouts, with and
without packed segments, remat on and off; the gathered head against the
dense one; a packed two-document row against the documents in their own
rows; the flops basis; a 5-step AdamW trajectory against the JAX trainer;
``pack_sequences`` against the JAX package's; the ``pretrain_bert`` entry
with a checkpoint and a resume. Weights cross with ``params_from_numpy``;
batches are numpy arrays from a seed.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tony_tpu.data import dataset as JD  # noqa: E402
from tony_tpu.models import bert as JB  # noqa: E402
from tony_tpu.train import metrics as JMet  # noqa: E402
from tony_tpu.train import trainer as JT  # noqa: E402
from tony_tpu_torch.data import dataset as TD  # noqa: E402
from tony_tpu_torch.models import bert as TB  # noqa: E402
from tony_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from tony_tpu_torch.train import loop as TLp  # noqa: E402
from tony_tpu_torch.train import metrics as TMet  # noqa: E402
from tony_tpu_torch.train import pretrain_bert  # noqa: E402
from tony_tpu_torch.train import trainer as TT  # noqa: E402

T = 128  # the shortest length JAX's flash gate sends to the kernels (blocks >= 128)
JCFG = dataclasses.replace(JB.BERT_TINY, max_seq=T, dtype="float32")
# f32 both sides; only the order of f32 sums differs (attention rows, matmul
# blocking): 1e-5 on the loss, 1e-4 relative per leaf, as test_torch_train.py
LOSS_ATOL = 1e-5
GRAD_REL = 1e-4


def _tcfg(**kw):
    return TB.config_from_dict({"preset": "tiny", "max_seq": T, "dtype": "float32", **kw})


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.fixture(scope="module")
def tiny_params():
    jp = JB.init(jax.random.PRNGKey(0), JCFG)
    return jp, jax.tree.map(np.asarray, jp)


def _packed_segments(B, T):
    """[B, T] segment ids: three documents a row, then a padding tail (0)."""
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        cuts = sorted(np.random.default_rng(b).choice(np.arange(8, T - 16), 2, replace=False))
        seg[b, :cuts[0]], seg[b, cuts[0]:cuts[1]], seg[b, cuts[1]:T - 8] = 1, 2, 3
    return seg


def _batch(seed, B, layout, packed):
    """A numpy MLM batch: gathered (round(0.15·T) positions a row, on real
    tokens when packed) or dense (-100 where unmasked, ~15% masked)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, JCFG.vocab_size, (B, T)).astype(np.int32)
    seg = _packed_segments(B, T) if packed else np.ones((B, T), np.int32)
    batch = {"tokens": tokens}
    if packed:
        batch["segment_ids"] = seg
    if layout == "gathered":
        M = round(0.15 * T)
        pos = np.stack([np.sort(rng.choice(np.flatnonzero(seg[b]), M, replace=False)) for b in range(B)])
        batch["masked_pos"] = pos.astype(np.int32)
        batch["masked_targets"] = np.take_along_axis(tokens, pos, axis=1)
    else:
        batch["targets"] = np.where(rng.random((B, T)) < 0.15, tokens, -100).astype(np.int32)
    return batch


def _jax_loss_and_grads(jp, batch, cfg):
    (loss, aux), grads = jax.value_and_grad(JB.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, cfg)
    return float(loss), int(aux["tokens"]), dict(_leaves(jax.tree.map(np.asarray, grads)))


def _port_loss_and_grads(npp, batch, cfg):
    tp = params_from_numpy(npp, "cpu")
    names, tensors = zip(*_leaves(tp))
    for t in tensors:
        t.requires_grad_(True)
    loss, aux = TB.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    grads = dict(zip(names, (g.numpy() for g in torch.autograd.grad(loss, tensors))))
    return loss.item(), int(aux["tokens"]), grads


# flash: every layout and packing once, remat on in half of them; the
# reference path the same four with remat flipped
CASES = [(impl, layout, packed, remat != (impl == "reference"))
         for impl in ("flash", "reference")
         for (layout, packed, remat) in (("gathered", False, False), ("gathered", True, True),
                                         ("dense", False, True), ("dense", True, False))]


@pytest.mark.parametrize("impl,layout,packed,remat", CASES,
                         ids=[f"{i}-{lay}-{'packed' if p else 'plain'}-{'remat' if r else 'noremat'}"
                              for i, lay, p, r in CASES])
def test_loss_and_gradients_match_jax(tiny_params, impl, layout, packed, remat):
    jp, npp = tiny_params
    batch = _batch(1, 2, layout, packed)
    jl, jn, jg = _jax_loss_and_grads(jp, batch, dataclasses.replace(JCFG, attn_impl=impl, remat=remat))
    tl, tn, tg = _port_loss_and_grads(npp, batch, _tcfg(attn_impl=impl, remat=remat))
    assert tn == jn and abs(tl - jl) < LOSS_ATOL, (tl, jl)
    assert tg.keys() == jg.keys()
    for name, g in jg.items():
        assert _rel(tg[name], g) < GRAD_REL, name


def test_flash_path_runs_the_kernels_plain_versions_non_causally(tiny_params, monkeypatch):
    """``attn_impl="flash"`` goes through B1-B3's wrappers with causal off
    and the segment ids, once a layer each (twice for B1 under remat)."""
    from tony_tpu_torch.ops import attention as A

    calls = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        real = getattr(A, name)
        monkeypatch.setattr(A, name, lambda *a, _n=name, _r=real, **kw: calls.append(
            (_n, kw["causal"], kw["segment_ids"] is not None)) or _r(*a, **kw))
    _, npp = tiny_params
    _port_loss_and_grads(npp, _batch(2, 2, "gathered", True), _tcfg(attn_impl="flash", remat=True))
    L = JCFG.n_layers
    assert sorted(set(calls)) == [(n, False, True) for n in ("flash_bwd_dkv", "flash_bwd_dq", "flash_fwd")]
    assert [n for n, _, _ in calls].count("flash_fwd") == 2 * L
    assert [n for n, _, _ in calls].count("flash_bwd_dq") == L


def test_gathered_head_equals_the_dense_one(tiny_params):
    """The gathered layout's loss and gradients equal the dense layout's
    with the same targets at the same positions (every row masks M)."""
    _, npp = tiny_params
    g = _batch(3, 2, "gathered", False)
    targets = np.full_like(g["tokens"], -100)
    np.put_along_axis(targets, g["masked_pos"], g["masked_targets"], axis=1)
    d = {"tokens": g["tokens"], "targets": targets}
    cfg = _tcfg()
    gl, gn, gg = _port_loss_and_grads(npp, g, cfg)
    dl, dn, dg = _port_loss_and_grads(npp, d, cfg)
    assert gn == dn == g["masked_pos"].size and abs(gl - dl) < 1e-6
    for name in gg:
        assert _rel(gg[name], dg[name]) < 1e-5, name


def test_packed_row_equals_the_documents_in_their_own_rows(tiny_params):
    """A packed two-document row (segment confinement, positions restarting)
    gives each masked position the loss the document gives alone, as JAX's
    ``test_packed_matches_separate_rows``."""
    _, npp = tiny_params
    tp = params_from_numpy(npp, "cpu")
    cfg = _tcfg()
    rng = np.random.default_rng(7)
    t1, t2 = rng.integers(0, 256, (1, 80)), rng.integers(0, 256, (1, 48))
    packed = {"tokens": torch.from_numpy(np.concatenate([t1, t2], axis=1)),
              "segment_ids": torch.from_numpy(np.repeat([[1, 2]], [80, 48], axis=1).astype(np.int32)),
              "masked_pos": torch.tensor([[3, 41, 85, 120]])}  # 85, 120: doc 2's positions 5, 40
    packed["masked_targets"] = torch.gather(packed["tokens"], 1, packed["masked_pos"])
    got = TB.loss_fn(tp, packed, cfg)[0].item()

    def solo(tok, pos):
        tok, pos = torch.from_numpy(tok), torch.tensor([pos])
        return TB.loss_fn(tp, {"tokens": tok, "masked_pos": pos,
                               "masked_targets": torch.gather(tok, 1, pos)}, cfg)[0].item()

    want = 0.5 * (solo(t1, [3, 41]) + solo(t2, [5, 40]))
    assert abs(got - want) < 1e-5, (got, want)


def test_config_presets_and_flops_match_jax():
    for name in ("bert-base", "tiny"):
        t, j = TB.PRESETS[name], JB.PRESETS[name]
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.head_dim == j.head_dim and t.num_params() == j.num_params()
        for frac in (None, 0.15, 77 / 512):
            assert t.flops_per_token(frac) == j.flops_per_token(frac)
    for d in ("tiny", {"preset": "bert-base", "remat": True, "n_layers": 3, "bogus": 1}, {"d_model": 128}):
        assert dataclasses.asdict(TB.config_from_dict(d)) == dataclasses.asdict(JB.config_from_dict(d))
    gathered, dense = _batch(0, 2, "gathered", False), _batch(0, 2, "dense", False)
    for batch in (gathered, dense):
        assert TMet.flops_per_token_for_batch(TB.BERT_BASE, batch, T) == JMet.flops_per_token_for_batch(
            JB.BERT_BASE, batch, T)


def test_init_tree_and_synthetic_batches(tiny_params):
    _, npp = tiny_params
    tp = TB.init(torch.Generator().manual_seed(0), _tcfg(), "cpu")
    want = {n: (a.shape, a.dtype.name) for n, a in _leaves(npp)}
    assert {n: (tuple(t.shape), str(t.dtype).split(".")[1]) for n, t in _leaves(tp)} == want
    cfg = TB.BERT_BASE
    b = TB.synthetic_batch(torch.Generator().manual_seed(1), 3, 512, cfg)
    M = round(0.15 * 512)
    assert b["tokens"].shape == (3, 512) and b["masked_pos"].shape == (3, M) == b["masked_targets"].shape
    for row in b["masked_pos"]:
        assert torch.equal(row, row.unique())  # distinct and sorted
    assert torch.equal(b["masked_targets"], torch.gather(b["tokens"], 1, b["masked_pos"]))
    d = TB.dense_synthetic_batch(torch.Generator().manual_seed(1), 4, 512, cfg)
    masked = d["targets"] != -100
    assert torch.equal(d["targets"][masked], d["tokens"][masked])
    assert 0.1 < masked.float().mean().item() < 0.2 and len(set(masked.sum(1).tolist())) > 1


def test_pack_sequences_matches_jax():
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 30_000, rng.integers(1, 300)).astype(np.int32) for _ in range(40)]
    docs.append(rng.integers(1, 30_000, 700).astype(np.int32))  # split into 512 + 188
    for got, want in zip(TD.pack_sequences(docs, 512), JD.pack_sequences(docs, 512)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    tok, seg = TD.pack_sequences([[5, 6], [7]], 4, pad_id=9)
    np.testing.assert_array_equal(tok, [[5, 6, 7, 9]])
    np.testing.assert_array_equal(seg, [[1, 1, 2, 0]])


def test_five_step_trajectory_matches_the_jax_trainer(tiny_params):
    """loss and grad_norm of every step (1e-5 relative) and the final
    parameters (1e-4 relative per leaf) against the optax chain, on the
    flash path with packed gathered batches."""
    jp, npp = tiny_params
    opt_cfg = dict(learning_rate=1e-3, warmup_steps=2, total_steps=5)
    batches = [_batch(10 + i, 2, "gathered", True) for i in range(5)]
    jcfg = dataclasses.replace(JCFG, attn_impl="flash")
    jopt = JT.OptimizerConfig(**opt_cfg).build()
    jstate = JT.TrainState.create(jax.tree.map(jnp.asarray, npp), jopt)
    jstep = JT.make_train_step(lambda p, b: JB.loss_fn(p, b, jcfg), jopt)
    want = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        want.append((float(m["loss"]), float(m["grad_norm"])))
    topt = TT.OptimizerConfig(**opt_cfg).build()
    state = TT.TrainState.create(params_from_numpy(npp, "cpu"), topt)
    tcfg = _tcfg(attn_impl="flash")
    tstep = TT.make_train_step(lambda p, b: TB.loss_fn(p, b, tcfg), topt)
    got = []
    for b in batches:
        state, m = tstep(state, {k: torch.from_numpy(v) for k, v in b.items()})
        got.append((float(m["loss"]), float(m["grad_norm"])))
    assert max(g for _, g in want) > 1.0  # the clip is exercised
    for (tl, tg), (jl, jg) in zip(got, want):
        assert abs(tl - jl) <= 1e-5 * abs(jl) and abs(tg - jg) <= 1e-5 * abs(jg), (got, want)
    tparams = {n: t.detach().numpy() for n, t in _leaves(state.params)}
    jparams = dict(_leaves(jax.tree.map(np.asarray, jstate.params)))
    # the key bias (bqkv's middle third) has no gradient but rounding noise:
    # it shifts each query's scores by a constant, which the softmax drops.
    # Adam's normalised step turns either side's noise into a step of ~lr, so
    # that third is held to Adam's bound (sum of the rates) on both sides
    D = JCFG.d_model
    bound = sum(topt.learning_rate(c) for c in range(5)) * 1.01
    for side in (tparams, jparams):
        key_bias = side["layers/bqkv"][:, D:2 * D]
        assert np.abs(key_bias).max() <= bound
        side["layers/bqkv"] = np.delete(side["layers/bqkv"], np.s_[D:2 * D], axis=1)
    for name, p in jparams.items():
        assert _rel(tparams[name], p) < 1e-4, name


def test_pretrain_bert_runs_checkpoints_and_resumes(tmp_path, capsys, monkeypatch):
    meters = []
    real_meter = TLp.Throughput
    monkeypatch.setattr(TLp, "Throughput", lambda **kw: meters.append(kw) or real_meter(**kw))
    ck = str(tmp_path / "ck")
    base = ["--preset", "tiny", "--device", "cpu", "--batch_size", "2", "--seq_len", "64",
            "--log_every", "1", "--warmup_steps", "1", "--schedule_steps", "5", "--checkpoint_dir", ck]
    assert pretrain_bert.main(base + ["--steps", "3"]) == 0
    assert pretrain_bert.main(base + ["--steps", "5"]) == 0
    import json

    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["step"] for x in lines] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(x["loss"]) and abs(x["loss"] - np.log(256)) < 1.5 for x in lines)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir() if p.name.isdigit()) == ["3", "5"]
    # the MFU basis is the gathered batch's: the head at its masked fraction
    want = TB.BERT_TINY.flops_per_token(round(0.15 * 64) / 64)
    assert [m["flops_per_token"] for m in meters] == [want, want] < [TB.BERT_TINY.flops_per_token()] * 2


def test_refusals_name_their_queue_and_the_entry_defaults_to_cuda():
    with pytest.raises(ValueError, match="--data_dir with BERT"):
        TLp.run_lm_training(TB, TB.BERT_TINY, TLp.LoopConfig(device="cpu", steps=1, data_dir="/nonexistent"))
    with pytest.raises(NotImplementedError, match="A8"):
        TB.hidden_states(TB.init(torch.Generator().manual_seed(0), TB.BERT_TINY, "cpu"),
                         torch.zeros(1, 8, dtype=torch.long), TB.BERT_TINY, mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pretrain_bert.main(["--preset", "tiny", "--steps", "1", "--seq_len", "64"])
