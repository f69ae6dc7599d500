"""Port parity for the training slice on the CPU, in f32.

``loss_fn`` and its gradients against the JAX model (the flash path: JAX's
Pallas kernels in interpret mode, the port's plain kernel versions through
its autograd function), a 5-step trajectory against the JAX trainer (optax
clip + AdamW + warmup-cosine), a checkpoint resume, a torn step, and the
pretraining CLI. Weights cross with ``params_from_numpy``; batches are numpy
tokens from a seed.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tony_tpu.models import llama as JM  # noqa: E402
from tony_tpu.train import trainer as JT  # noqa: E402
from tony_tpu_torch.models import llama as TM  # noqa: E402
from tony_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from tony_tpu_torch.train import checkpoint as TC  # noqa: E402
from tony_tpu_torch.train import loop as TLp  # noqa: E402
from tony_tpu_torch.train import metrics as TMet  # noqa: E402
from tony_tpu_torch.train import trainer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JCFG = dataclasses.replace(JM.LLAMA_TINY, dtype="float32")


def _tcfg(**kw):
    return TM.config_from_dict({"preset": "tiny", "dtype": "float32", **kw})


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
def tiny_params():
    jp = JM.init(jax.random.PRNGKey(0), JCFG)
    return jp, jax.tree.map(np.asarray, jp)


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


# f32 both sides; only the order of f32 sums differs (attention rows, CE
# chunks, matmul blocking): 1e-5 on the loss, 1e-4 relative per leaf
LOSS_ATOL = 1e-5
GRAD_REL = 1e-4


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "segments"])
@pytest.mark.parametrize("ce_chunk,remat", [(32, False), (0, True)], ids=["chunked-ce", "full-ce-remat"])
def test_loss_and_gradients_match_jax_on_the_flash_path(tiny_params, packed, ce_chunk, remat):
    jp, npp = tiny_params
    T = 128  # the shortest length the flash gate takes (blocks >= 128)
    batch = {"tokens": _tokens(1, 2, T, JCFG.vocab_size)}
    if packed:
        batch["segment_ids"] = _packed_segments(2, T)
    jcfg = dataclasses.replace(JCFG, attn_impl="flash", ce_chunk=ce_chunk, remat=remat)
    (jl, jaux), jg = jax.value_and_grad(JM.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)

    tp = params_from_numpy(npp, "cpu")
    for _, t in _leaves(tp):
        t.requires_grad_(True)
    tcfg = _tcfg(attn_impl="flash", ce_chunk=ce_chunk, remat=remat)
    tl, taux = TM.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    names, tensors = zip(*_leaves(tp))
    grads = dict(zip(names, torch.autograd.grad(tl, tensors)))
    assert int(taux["tokens"]) == int(jaux["tokens"])
    assert abs(tl.item() - float(jl)) < LOSS_ATOL
    for name, g in _leaves(jax.tree.map(np.asarray, jg)):
        assert _rel(grads[name].numpy(), g) < GRAD_REL, name


def test_model_helpers_match_jax():
    seg = _packed_segments(2, 40)
    np.testing.assert_array_equal(TM.segment_positions(torch.from_numpy(seg)).numpy(),
                                  np.asarray(JM.segment_positions(jnp.asarray(seg))))
    toks = _tokens(2, 2, 40, 256)
    jt, js = JM.mask_packed_targets(jnp.asarray(toks), jnp.asarray(seg))
    tt, ts = TM.mask_packed_targets(torch.from_numpy(toks), torch.from_numpy(seg))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for name in ("llama3-8b", "llama-1b", "tiny"):
        assert TM.PRESETS[name].flops_per_token() == JM.PRESETS[name].flops_per_token()
    b = TM.synthetic_batch(torch.Generator().manual_seed(0), 3, 16, TM.LLAMA_TINY)
    assert b["tokens"].shape == (3, 17) and 0 <= int(b["tokens"].min()) and int(b["tokens"].max()) < 256
    with pytest.raises(NotImplementedError, match="A8"):
        TM.embed_lookup(torch.zeros(8, 2), torch.zeros(1, 4, dtype=torch.long), mesh=object())


def test_peak_flops_table_and_flops_formula():
    assert TMet.PEAK_FLOPS["h100"] == 989e12
    assert TMet.detect_peak_flops("cpu") == TMet.PEAK_FLOPS["cpu"]
    from tony_tpu.train.metrics import transformer_flops_per_token as jax_formula

    assert TMet.transformer_flops_per_token(10**9, 8, 4096, 2048) == jax_formula(10**9, 8, 4096, 2048)


def _jax_run(npp, batches, opt_cfg, accum):
    jcfg = JCFG
    opt = JT.OptimizerConfig(**opt_cfg).build()
    state = JT.TrainState.create(jax.tree.map(jnp.asarray, npp), opt)
    step = JT.make_train_step(lambda p, b: JM.loss_fn(p, b, jcfg), opt, accum_steps=accum)
    out = []
    for toks in batches:
        state, m = step(state, {"tokens": jnp.asarray(toks)})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, jax.tree.map(np.asarray, state.params)


def _port_run(npp, batches, opt_cfg, accum):
    opt = TT.OptimizerConfig(**opt_cfg).build()
    state = TT.TrainState.create(params_from_numpy(npp, "cpu"), opt)
    step = TT.make_train_step(lambda p, b: TM.loss_fn(p, b, _tcfg()), opt, accum_steps=accum)
    out = []
    for toks in batches:
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, state


@pytest.mark.parametrize("accum", [1, 2])
def test_five_step_trajectory_matches_the_jax_trainer(tiny_params, accum):
    """loss and grad_norm of every step, and the final parameters, against
    the optax chain (clip_by_global_norm → adamw with warmup-cosine; the
    first update at lr 0). f32: 1e-5 relative on loss and grad_norm, 1e-4
    relative per final leaf (Adam's normalised steps carry the gradients'
    last-bit differences into the parameters)."""
    _, npp = tiny_params
    opt_cfg = dict(learning_rate=1e-3, warmup_steps=2, total_steps=5)
    batches = [_tokens(10 + i, 4, 32, JCFG.vocab_size) for i in range(5)]
    want, jparams = _jax_run(npp, batches, opt_cfg, accum)
    got, state = _port_run(npp, batches, opt_cfg, accum)
    assert state.step == 5 and state.opt_state["count"] == 5
    assert max(g for _, g in want) > 1.0  # the clip is exercised
    for (tl, tg), (jl, jg) in zip(got, want):
        assert abs(tl - jl) <= 1e-5 * abs(jl) and abs(tg - jg) <= 1e-5 * abs(jg), (got, want)
    tparams = dict(_leaves(state.params))
    for name, p in _leaves(jparams):
        assert _rel(tparams[name].detach().numpy(), p) < 1e-4, name


def test_optimizer_schedule_and_moment_dtype():
    opt = TT.OptimizerConfig(learning_rate=1.0, warmup_steps=2, total_steps=6, mu_dtype="bfloat16").build()
    import optax

    sched = optax.warmup_cosine_decay_schedule(0.0, 1.0, 2, 6)
    for count in range(9):
        assert abs(opt.learning_rate(count) - float(sched(count))) < 1e-6
    st = opt.init({"w": torch.zeros(3)})
    assert st["mu"]["w"].dtype == torch.bfloat16 and st["nu"]["w"].dtype == torch.float32


def _loop(tmp_path, steps, **kw):
    cfg = dict(steps=steps, schedule_steps=4, batch_size=2, seq_len=32, log_every=1,
               learning_rate=1e-3, warmup_steps=1, device="cpu", prefetch_depth=1, **kw)
    return TLp.run_lm_training(TM, _tcfg(), TLp.LoopConfig(**cfg))


def test_checkpoint_resume_continues_the_uninterrupted_run(tmp_path):
    ck = str(tmp_path / "ck")
    whole = _loop(tmp_path, 4)
    first = _loop(tmp_path, 2, checkpoint_dir=ck, checkpoint_every=2)
    assert first["start_step"] == 0 and TC.CheckpointManager(ck).all_steps() == [2]
    resumed = _loop(tmp_path, 4, checkpoint_dir=ck, checkpoint_every=2)
    assert resumed["start_step"] == 2
    assert [r["step"] for r in resumed["log"]] == [3, 4]
    assert resumed["loss"] == whole["loss"] and resumed["grad_norm"] == whole["grad_norm"]
    assert TC.CheckpointManager(ck).all_steps() == [2, 4]
    again = _loop(tmp_path, 4, checkpoint_dir=ck)  # nothing left to run
    assert again["start_step"] == 4 and again["log"] == []


def test_torn_step_is_quarantined_and_the_previous_one_restored(tmp_path):
    ck = tmp_path / "ck"
    mgr = TC.CheckpointManager(str(ck), max_to_keep=2)
    good = {"params": {"w": torch.arange(4.0)}, "opt_state": {"count": 1}, "step": 1}
    mgr.save(1, good)
    mgr.save(2, dict(good, step=2))
    mgr.save(3, dict(good, step=3))
    mgr.wait()  # saves are asynchronous: step 3 is on disk after the wait
    assert mgr.all_steps() == [2, 3]  # max_to_keep
    (ck / "3" / TC.STATE_FILE).write_bytes(b"torn")
    state, got_mgr, step = TC.restore_or_init(str(ck), lambda: {"w": torch.zeros(4)},
                                              lambda s, saved: {"w": s["w"].copy_(saved["params"]["w"])})
    assert step == 2 and torch.equal(state["w"], torch.arange(4.0))
    assert (ck / ".corrupt-3").is_dir() and got_mgr.all_steps() == [2]
    assert TC.restore_or_init(None, lambda: "fresh", None) == ("fresh", None, 0)


def test_state_load_checks_every_leaf_before_copying():
    opt = TT.OptimizerConfig().build()
    st = TT.TrainState.create({"a": torch.zeros(2), "b": torch.zeros(3)}, opt)
    saved = TT.TrainState.create({"a": torch.ones(2), "b": torch.ones(4)}, opt).state_dict()
    with pytest.raises(ValueError, match="b"):
        st.load(saved)
    assert float(st.params["a"].detach().sum()) == 0.0  # nothing was copied


def test_unported_options_and_gangs_raise(monkeypatch):
    """The options still to port (the interleaved schedule, A13b), an
    expert axis beside a context axis (A11's rest), a global batch that does
    not divide by the gang, and a gang launched without the
    torch.distributed rendezvous. The expert axis is ported for every
    family (Llama's leaves stay whole on it), and one process holds none of
    2; a model axis beside a context axis runs in a gang
    (``tests/test_torch_cp_tp.py``), and so does the stage axis
    (``tests/test_torch_pp.py``)."""
    with pytest.raises(NotImplementedError, match="not ported yet.*A13b"):
        TLp.run_lm_training(TM, _tcfg(), TLp.LoopConfig(device="cpu", stage_axis=2, pp_chunks=2))
    with pytest.raises(ValueError, match="not divisible by model"):
        TLp.run_lm_training(TM, _tcfg(), TLp.LoopConfig(device="cpu", expert_axis=2))
    from tony_tpu_torch.models import bert, mixtral

    with pytest.raises(NotImplementedError, match="not ported yet"):  # Llama's and Mixtral's model axis is ported
        TLp.run_lm_training(bert, bert.BERT_TINY, TLp.LoopConfig(device="cpu", model_axis=2))
    for model, cfg in ((TM, _tcfg()), (mixtral, mixtral.MIXTRAL_TINY)):
        with pytest.raises(ValueError, match="not divisible by model"):  # one process holds no model axis of 2
            TLp.run_lm_training(model, cfg, TLp.LoopConfig(device="cpu", model_axis=2))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="A11"):  # a context axis alone spans a gang
        TLp.run_lm_training(TM, _tcfg(), TLp.LoopConfig(device="cpu", steps=1, context_axis=2, expert_axis=2))
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="framework=pytorch"):
        TLp.run_lm_training(TM, _tcfg(), TLp.LoopConfig(device="cpu", steps=1))
    monkeypatch.delenv("JAX_NUM_PROCESSES")
    monkeypatch.setattr(TLp, "process_count", lambda: 2)  # the loop sees a gang of 2
    with pytest.raises(ValueError, match="must divide by the gang's 2 processes"):
        TLp.run_lm_training(TM, _tcfg(), TLp.LoopConfig(device="cpu", steps=1, batch_size=3))


def test_pretrain_cli_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), TONY_TRAIN_METRICS_FILE=str(tmp_path / "m.json"))
    out = subprocess.run(
        [sys.executable, "-m", "tony_tpu_torch.train.pretrain", "--preset", "tiny", "--device", "cpu",
         "--steps", "3", "--batch_size", "2", "--seq_len", "32", "--log_every", "1", "--warmup_steps", "1",
         "--checkpoint_dir", str(tmp_path / "ck")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    import json

    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert [x["step"] for x in lines] == [1, 2, 3]
    assert all(np.isfinite(x["loss"]) and x["loss"] > 0 for x in lines)
    assert json.loads((tmp_path / "m.json").read_text())["step"] == 3
    assert (tmp_path / "ck" / "3").is_dir()


@pytest.mark.parametrize("depth", [0, 2])
def test_input_pipeline_feeds_every_step_once_in_order(depth):
    from tony_tpu_torch.train.input_pipeline import InputPipeline, InputPipelineError

    made = []
    pipe = InputPipeline(lambda s: made.append(s) or s * 10, 3, 7, depth=depth)
    assert [pipe.next(s) for s in range(3, 7)] == [30, 40, 50, 60]
    with pytest.raises(StopIteration):
        pipe.next(7)
    assert pipe.close() and made == [3, 4, 5, 6]
    with pytest.raises(RuntimeError, match="after close"):
        pipe.next(8)

    def broken(step):
        if step == 1:
            raise OSError("disk gone")
        return step

    pipe = InputPipeline(broken, 0, 4, depth=depth)
    assert pipe.next(0) == 0
    with pytest.raises((InputPipelineError, OSError)) as err:
        pipe.next(1)
    if depth:
        assert isinstance(err.value.__cause__, OSError)
    with pytest.raises(ValueError, match="out-of-order"):
        pipe.next(3)
    assert pipe.close()
