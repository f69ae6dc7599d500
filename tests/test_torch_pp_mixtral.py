"""The stage axis on the CPU, Mixtral: the 1F1B schedule with the router
losses threaded through the hand-scheduled backward, in gloo gangs of the
port against JAX's ``pp_value_and_grad`` and ``make_pp_train_step`` on the
same meshes. Every gang runs its ranks with ``OMP_NUM_THREADS=1``, in f32 at
``MIXTRAL_TINY`` widths cut to 4 layers (remat "full", CE chunks of 16, the
ragged dispatch on B7/B8's plain versions); the two gangs run at once,
beside JAX's runs in this process. The helpers are ``test_torch_pp.py``'s.

- ``pp_value_and_grad`` from JAX's weights on JAX's batch: the loss, CE,
  token count and ``moe_aux_loss`` within 1e-5 relative (the count exact),
  each gradient block within 1e-4 of the leaf's max, on ``stage 2, M 4``
  and on ``stage 2 × data 2`` (each rank its block of each microbatch's
  rows, so its router losses are JAX's per-shard ones), both with the f32
  wire, as JAX's own test: a bf16 wire may flip near-tie routing.
- A planted fault: the aux cotangent seeded without the pre-counted tokens
  leaves the loss as it is and shrinks the router's gradients by the token
  count, which fails the gradient bound.
- ``run_lm_training(stage_axis=2, pp_microbatches=4)`` 3 steps (the bf16
  wire): JAX's ``make_pp_train_step`` on the same weights and batches gives
  the logged losses and grad norms and the final parameters within 1e-4
  relative; the save restores bit for bit into one process and into a fresh
  stage gang; the ``pretrain_mixtral`` entry trains the loop's run bit for
  bit.
"""

import dataclasses
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_pp import (B, LAYERS, LOOP, STEPS, T, check_case, jax_pp, jax_train, loop_inputs,  # noqa: E402
                           one_thread, rank_blocks, rel, restore_one, start_gang, _free_port)
from tony_tpu.models import mixtral as JM  # noqa: E402
from tony_tpu_torch.models import mixtral as TM  # noqa: E402
from tony_tpu_torch.train import trainer as TT  # noqa: E402

JCFG = dataclasses.replace(JM.MIXTRAL_TINY, dtype="float32", n_layers=LAYERS, remat=True, ce_chunk=16)
TCFG = dataclasses.replace(TM.MIXTRAL_TINY, dtype="float32", n_layers=LAYERS, remat=True, ce_chunk=16)
CASES = {
    "stage2_m4": (dict(stage=2), 4, "float32", False),
    "stage2_data2": (dict(stage=2, data=2), 4, "float32", False),
}

CONSTS = f"""
from tony_tpu_torch.models import mixtral as MODEL
CFG = dataclasses.replace(MODEL.MIXTRAL_TINY, dtype="float32", n_layers={LAYERS}, remat=True, ce_chunk=16)
CASES = {CASES!r}
LOOP = {LOOP!r}
"""

_GANG4 = """
inp, out = sys.argv[1:3]
data = torch.load(inp, weights_only=False)
init_distributed(torch.device("cpu"))
kw, M, wire, _ = CASES["stage2_data2"]
res = {"stage2_data2": pp_case(MeshSpec(**kw).build("cpu"), data["npp"], {"tokens": data["tokens"]}, M, wire)}
shutdown_distributed()
torch.save(res, out)
"""

_GANG2 = """
inp, out, ckpt, *ports = sys.argv[1:]
data = torch.load(inp, weights_only=False)
init_distributed(torch.device("cpu"))
mesh = MeshSpec(stage=2).build("cpu")
kw, M, wire, _ = CASES["stage2_m4"]
res = {"stage2_m4": pp_case(mesh, data["npp"], {"tokens": data["tokens"]}, M, wire)}
# the planted fault: the aux cotangent seeded without the token count
from tony_tpu_torch.parallel import pipeline
real = pipeline.spmd_pipeline_1f1b
pipeline.spmd_pipeline_1f1b = lambda *a, **k: real(*a, **{**k, "aux_seed_scale": 1.0})
res["aux_unseeded"] = pp_case(mesh, data["npp"], {"tokens": data["tokens"]}, M, wire)
pipeline.spmd_pipeline_1f1b = real
shutdown_distributed()
from tony_tpu_torch.train import pretrain_mixtral
res["train"] = train_runs(ckpt, ports, pretrain_mixtral, ["--device", "cpu", "--preset", "tiny", "--steps", "2",
                                                          "--batch_size", "8", "--seq_len", "32", "--log_every", "1",
                                                          "--stage_axis", "2", "--pp_microbatches", "4",
                                                          "--prefetch_depth", "0"])
torch.save(res, out)
"""


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """Both gangs, started together, beside JAX's runs on the same weights
    and batches."""
    d = tmp_path_factory.mktemp("pp_mixtral")
    npp = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(3), JCFG))
    tokens = np.random.default_rng(5).integers(0, JCFG.vocab_size, (B, T + 1))
    torch.save({"npp": npp, "tokens": torch.from_numpy(tokens)}, d / "in.pt")
    finish4 = start_gang(_GANG4, 4, [str(d / "in.pt"), str(d / "r4_{rank}.pt")], CONSTS)
    finish2 = start_gang(_GANG2, 2, [str(d / "in.pt"), str(d / "r2_{rank}.pt"), str(d / "ckpt"),
                                     *(str(_free_port()) for _ in range(4))], CONSTS)
    init, batches = loop_inputs(TM, TCFG)

    def oracles():
        out = {name: jax_pp(JM, JCFG, npp, {"tokens": tokens}, kw, M, wire)
               for name, (kw, M, wire, _) in CASES.items()}
        out["train"] = jax_train(JM, JCFG, init, batches)
        return out

    t0 = time.perf_counter()
    jax_runs = one_thread(oracles)
    jax_s = time.perf_counter() - t0
    finish4()
    finish2()
    return {"gang4": [torch.load(d / f"r4_{r}.pt", weights_only=False) for r in range(4)],
            "gang2": [torch.load(d / f"r2_{r}.pt", weights_only=False) for r in range(2)],
            "jax": jax_runs, "jax_s": jax_s, "one": restore_one(TM, TCFG, d / "ckpt")}


@pytest.mark.parametrize("case", list(CASES))
def test_mixtral_pp_value_and_grad_matches_jaxs_on_the_same_mesh(gangs, case):
    """The loss, CE, token count and ``moe_aux_loss`` within 1e-5 relative
    (the count exact), and each gradient block within 1e-4 of the leaf's
    max, on every rank; the router losses reach the router's gradient."""
    ranks = gangs["gang2" if case == "stage2_m4" else "gang4"]
    want = gangs["jax"][case]
    worst = check_case(ranks, want, TM.sharding_rules(TCFG), case, CASES[case][2])
    print(f"{case}: worst gradient error {worst:.2e}, metrics {want['metrics']}")
    assert want["metrics"]["moe_aux_loss"] > 0


def test_an_unseeded_aux_cotangent_fails_the_router_gradient(gangs):
    """The fault leaves the loss within its bound and moves the router's
    gradient past the gradient bound (it shrinks by about the token count)."""
    want = gangs["jax"]["stage2_m4"]
    rules = TM.sharding_rules(TCFG)
    for res in gangs["gang2"]:
        got = res["aux_unseeded"]
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        expected = rank_blocks(rules, want["grads"], got["shape"], got["coords"])
        err = float((got["grads"]["layers/router"] - expected["layers/router"]).abs().max()
                    / expected["layers/router"].abs().max())
        assert err > 100 * 1e-4, err
    with pytest.raises(AssertionError):
        check_case([{"c": r["aux_unseeded"]} for r in gangs["gang2"]], want, rules, "c", "float32")


def test_mixtral_run_lm_training_on_stages_matches_jaxs_make_pp_train_step(gangs):
    """3 steps of ``run_lm_training(stage_axis=2)``: every rank logs JAX's
    losses and grad norms (the log's 4 decimals) and ``moe_aux_loss``, and
    its blocks of the final parameters are JAX's within 1e-4 relative."""
    want, jparams = gangs["jax"]["train"]
    for r, res in enumerate(gangs["gang2"]):
        log = res["train"]["log"]
        assert [x["step"] for x in log] == [1, 2, 3] and all(x["moe_aux_loss"] > 0 for x in log)
        for x, (jl, jg) in zip(log, want, strict=True):
            assert abs(x["loss"] - jl) <= 1.5e-4 and abs(x["grad_norm"] - jg) <= 1.5e-4, (log, want)
        mine = rank_blocks(TM.sharding_rules(TCFG), jparams, {"stage": 2}, {"stage": r})
        assert set(mine) == set(res["train"]["final"]["params"])
        for name, p in res["train"]["final"]["params"].items():
            assert rel(p, mine[name]) < 1e-4, name


def test_a_mixtral_stage_gangs_save_restores_into_one_process_and_a_stage_gang(gangs):
    """The step-3 save restores bit for bit into one process (the f32 router
    beside the experts) and into a fresh stage gang."""
    state, _, start = gangs["one"]
    assert start == STEPS and state.opt_state["count"] == STEPS
    whole = {"params": dict(TT._leaves(state.params)), "mu": dict(TT._leaves(state.opt_state["mu"])),
             "nu": dict(TT._leaves(state.opt_state["nu"]))}
    for r, res in enumerate(gangs["gang2"]):
        final, restored = res["train"]["final"], res["train"]["gang_restore"]
        for part in ("params", "mu", "nu"):
            mine = rank_blocks(TM.sharding_rules(TCFG), whole[part], {"stage": 2}, {"stage": r})
            assert set(mine) == set(final[part]) == set(restored["blocks"][part])
            for name, t in mine.items():
                assert torch.equal(final[part][name], t) and torch.equal(restored["blocks"][part][name], t), name


def test_the_pretrain_mixtral_entry_trains_the_stage_axis_as_the_loop(gangs):
    """``pretrain_mixtral --stage_axis 2 --pp_microbatches 4`` trains the
    bits ``run_lm_training`` does with those settings."""
    for res in gangs["gang2"]:
        entry = res["train"]["entry"]
        assert entry["loop"]["stage_axis"] == 2 and entry["loop"]["pp_microbatches"] == 4
        keys = ("step", "loss", "grad_norm", "moe_aux_loss")
        strip = [{k: x[k] for k in keys} for x in entry["log"]]
        assert strip == [{k: x[k] for k in keys} for x in entry["direct"]] and len(strip) == 2


def test_mixtrals_expert_axis_with_stages_is_refused_in_jaxs_words():
    """JAX keeps Mixtral's experts stage-local under stages: an expert axis
    beside them raises its words before anything is built."""
    from tony_tpu_torch.train import loop as TLp

    with pytest.raises(ValueError, match="keeps experts stage-local"):
        TLp.run_lm_training(TM, TCFG, TLp.LoopConfig(device="cpu", stage_axis=2, expert_axis=2))
