"""The stage axis on the CPU, Llama: the 1F1B schedule of the port in gloo
gangs against JAX's ``pp_value_and_grad`` and ``make_pp_train_step`` on the
same meshes, the stage ownership of the state and its checkpoints, and the
refusals. Every gang runs its ranks with ``OMP_NUM_THREADS=1``, in f32 at
``LLAMA_TINY`` widths cut to 4 layers (remat "full", CE chunks of 16); the
two gangs run at once, beside JAX's runs in this process (each JAX oracle
computed once, on at most 4 of the 8 virtual devices).

- ``pp_value_and_grad`` from JAX's weights (bridged by ``models/convert.py``)
  on JAX's batch, each rank given its data × fsdp shard of each microbatch
  (``microbatch_rows``): the loss within 1e-5 relative of JAX's on the same
  mesh, the token count equal, and every gradient block a rank holds within
  1e-4 of JAX's (per leaf, relative to the leaf's max, JAX's own rule at a
  bound 200 times tighter), for ``stage 2, M 8`` (bf16 wire), ``stage 4, M
  4`` (f32 wire), ``stage 2 × data 2``, ``stage 2 × fsdp 2`` and a packed
  batch (segment ids and padding) on ``stage 2``.
- A mutant at ``stage 4``: the two rings' directions swapped
  (``ProcessRing.exchange`` sending the activation left and the gradient
  right) moves the loss and the gradients far past those bounds; at ``stage
  2`` the two directions are one pair, so only ``stage 4`` can show it.
- ``run_lm_training(stage_axis=2, pp_microbatches=4)`` 3 steps from the
  loop's own seeded init and batches: JAX's ``make_pp_train_step`` on the
  same weights and batches gives the same logged losses and grad norms and
  final parameters within 1e-4 relative; each rank holds its 2 layers, the
  embedding (stage 0) or the head (stage 1) and nothing else; the step-3
  save (DCP, each leaf once) restores bit for bit into one process, into
  a fresh stage gang and onto 4 stages; the ``pretrain`` entry's flags
  train the loop's run bit for bit.
"""

import dataclasses
import functools
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tony_tpu.models import llama as JL  # noqa: E402
from tony_tpu.parallel.mesh import MeshSpec as JMeshSpec  # noqa: E402
from tony_tpu.train import trainer as JT  # noqa: E402
from tony_tpu_torch.data import dataset as TD  # noqa: E402
from tony_tpu_torch.data.native import TokenLoader  # noqa: E402
from tony_tpu_torch.models import llama as TL  # noqa: E402
from tony_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402
from tony_tpu_torch.parallel.pipeline import Schedule, microbatch_rows, split_layers_into_stages  # noqa: E402
from tony_tpu_torch.parallel.sharding import Layout  # noqa: E402
from tony_tpu_torch.train import checkpoint as TC  # noqa: E402
from tony_tpu_torch.train import loop as TLp  # noqa: E402
from tony_tpu_torch.train import trainer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, T, LAYERS, STEPS = 8, 32, 4, 3
JCFG = dataclasses.replace(JL.LLAMA_TINY, dtype="float32", n_layers=LAYERS, remat=True, ce_chunk=16)
TCFG = dataclasses.replace(TL.LLAMA_TINY, dtype="float32", n_layers=LAYERS, remat=True, ce_chunk=16)
LOOP = dict(device="cpu", steps=STEPS, batch_size=B, seq_len=T, log_every=1, warmup_steps=1, learning_rate=1e-2,
            stage_axis=2, pp_microbatches=4, prefetch_depth=0)
#: loss and gradients against JAX's on the same mesh, in f32: a wire of f32
#: moves no bit, and one of bf16 rounds the two's activations apart where
#: they straddle a bf16 rounding boundary (a relative 2^-8 of that element)
LOSS_REL = 1e-5
GRAD_REL = {"float32": 1e-4, "bfloat16": 2e-3}
#: the cases: (mesh, microbatches, wire, packed); the gang of 2 runs the
#: stage-2 ones, the gang of 4 the others
CASES = {
    "stage2_m8": (dict(stage=2), 8, "bfloat16", False),
    "packed": (dict(stage=2), 4, "bfloat16", True),
    "stage4_m4": (dict(stage=4), 4, "float32", False),
    "stage2_data2": (dict(stage=2, data=2), 4, "bfloat16", False),
    "stage2_fsdp2": (dict(stage=2, fsdp=2), 4, "float32", False),
}

# shared by the gangs of both families (the script's constants name MODEL and CFG)
COMMON = """
import dataclasses, os, sys, torch
import torch.distributed as dist
from tony_tpu_torch.models.convert import params_from_numpy
from tony_tpu_torch.parallel import collectives as C
from tony_tpu_torch.parallel.mesh import MeshSpec
from tony_tpu_torch.parallel.pipeline import microbatch_rows
from tony_tpu_torch.parallel.sharding import Layout, prune
from tony_tpu_torch.runtime import init_distributed, shutdown_distributed
from tony_tpu_torch.train import trainer as TT


def placed(npp, mesh):
    # this rank's part of JAX's weights: its stage's layers, the embedding
    # or the head, its fsdp blocks of them
    layout = Layout(MODEL.sharding_rules(CFG), mesh)

    def walk(tree, prefix=""):
        return {k: walk(v, prefix + k + "/") if isinstance(v, dict) else layout.place(prefix + k, v)
                for k, v in tree.items()}

    params = prune(walk(params_from_numpy(npp, "cpu")))
    for _, p in TT._leaves(params):
        p.requires_grad_(True)
    return params


def coords(mesh):
    return {a: mesh.axis_index(a) for a in ("stage", "data", "fsdp")}


def pp_case(mesh, npp, batch, M, wire):
    shards = mesh.shape["data"] * mesh.shape["fsdp"]
    index = mesh.axis_index("data") * mesh.shape["fsdp"] + mesh.axis_index("fsdp")
    rows = microbatch_rows(batch, M, shards, index)
    loss, metrics, grads = MODEL.pp_value_and_grad(placed(npp, mesh), rows, CFG, mesh, M, getattr(torch, wire))
    return {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: g.detach() for n, g in TT._leaves(grads)}, "coords": coords(mesh), "shape": mesh.shape}


def swapped(real):
    # the mutant: the activation goes to the previous stage, the gradient to the next
    return lambda self, right, left: tuple(reversed(real(self, left, right)))


def blocks(state):
    return {part: {n: t.detach().clone() for n, t in TT._leaves(tree)}
            for part, tree in (("params", state.params), ("mu", state.opt_state["mu"]),
                               ("nu", state.opt_state["nu"]))}


def train_runs(ckpt, ports, entry, entry_args):
    # run_lm_training on the stage axis (its final state held), the save
    # restored into a fresh stage gang, then the entry against the loop
    from tony_tpu_torch.train import loop
    from tony_tpu_torch.train.checkpoint import restore_or_init
    held, real = {}, TT.AdamW.update

    def update(self, params, grads, state, norm):
        real(self, params, grads, state, norm)
        held.update(params=params, mu=state["mu"], nu=state["nu"])

    TT.AdamW.update = update
    os.environ["MASTER_PORT"] = ports[0]
    try:
        run = loop.run_lm_training(MODEL, CFG, loop.LoopConfig(checkpoint_dir=ckpt, checkpoint_every=3, **LOOP))
    finally:
        TT.AdamW.update = real
    res = {"log": run["log"], "final": {part: {n: t.detach().clone() for n, t in TT._leaves(tree)}
                                       for part, tree in held.items()}}
    os.environ["MASTER_PORT"] = ports[1]
    init_distributed(torch.device("cpu"))
    mesh = MeshSpec(stage=2).build("cpu")
    opt = TT.OptimizerConfig(learning_rate=1e-2, warmup_steps=1, total_steps=3).build()
    init = lambda place: MODEL.init(torch.Generator().manual_seed(1), CFG, "cpu", place)  # not the saved values
    st, _, start = restore_or_init(ckpt, lambda: TT.sharded_init(init, MODEL.sharding_rules(CFG), mesh, opt),
                                   TT.TrainState.load, group=mesh.gang)
    res["gang_restore"] = {"start": start, "count": st.opt_state["count"], "blocks": blocks(st)}
    shutdown_distributed()
    got = {}
    real_run = entry.run_lm_training
    entry.run_lm_training = lambda *a: got.update(log=real_run(*a)["log"], cfg=a[1], loop=a[2])
    os.environ["MASTER_PORT"] = ports[2]
    try:
        entry.main(entry_args)
    finally:
        entry.run_lm_training = real_run
    os.environ["MASTER_PORT"] = ports[3]
    direct = loop.run_lm_training(MODEL, got["cfg"], got["loop"])
    res["entry"] = {"log": got["log"], "loop": dataclasses.asdict(got["loop"]), "direct": direct["log"]}
    return res
"""

CONSTS = f"""
from tony_tpu_torch.models import llama as MODEL
CFG = dataclasses.replace(MODEL.LLAMA_TINY, dtype="float32", n_layers={LAYERS}, remat=True, ce_chunk=16)
CASES = {CASES!r}
LOOP = {LOOP!r}
"""

_GANG4 = """
inp, out, ckpt, data_dir, port = sys.argv[1:6]
data = torch.load(inp, weights_only=False)
init_distributed(torch.device("cpu"))
res = {"auto": MeshSpec.auto(stage=2).axis_sizes}
for name in ("stage4_m4", "stage2_data2", "stage2_fsdp2"):
    kw, M, wire, _ = CASES[name]
    res[name] = pp_case(MeshSpec(**kw).build("cpu"), data["npp"], {"tokens": data["tokens"]}, M, wire)
real = C.ProcessRing.exchange
C.ProcessRing.exchange = swapped(real)
kw, M, wire, _ = CASES["stage4_m4"]
res["stage4_swapped"] = pp_case(MeshSpec(**kw).build("cpu"), data["npp"], {"tokens": data["tokens"]}, M, wire)
C.ProcessRing.exchange = real
# the gang of 2's step-3 save, restored onto 4 stages (another stage count)
import time
from tony_tpu_torch.train.checkpoint import restore_or_init
deadline = time.time() + 240
while not os.path.isdir(os.path.join(ckpt, "3")) and time.time() < deadline:
    time.sleep(0.2)
mesh = MeshSpec(stage=4).build("cpu")
opt = TT.OptimizerConfig().build()
init = lambda place: MODEL.init(torch.Generator().manual_seed(1), CFG, "cpu", place)  # not the saved values
st, _, start = restore_or_init(ckpt, lambda: TT.sharded_init(init, MODEL.sharding_rules(CFG), mesh, opt),
                               TT.TrainState.load, group=mesh.gang)
res["stage4_restore"] = {"start": start, "coords": coords(mesh), "blocks": blocks(st)}
shutdown_distributed()
# run_lm_training on a data dir, stage 2 x fsdp 2: the tokens each step's schedule saw
from tony_tpu_torch.train import loop
seen, real_pp = [], MODEL.pp_value_and_grad
MODEL.pp_value_and_grad = lambda params, batch, *a, **k: (seen.append(batch["tokens"].clone()),
                                                          real_pp(params, batch, *a, **k))[1]
os.environ["MASTER_PORT"] = port
loop.run_lm_training(MODEL, CFG, loop.LoopConfig(**{**LOOP, "steps": 2, "data_dir": data_dir}))
MODEL.pp_value_and_grad = real_pp
res["rows"] = seen
torch.save(res, out)
"""

_GANG2 = """
inp, out, ckpt, *ports = sys.argv[1:]
data = torch.load(inp, weights_only=False)
init_distributed(torch.device("cpu"))
mesh = MeshSpec(stage=2).build("cpu")
res = {"stage_line": dist.get_process_group_ranks(mesh.stage_line), "group": dist.get_process_group_ranks(mesh.group)}
for name, batch in (("stage2_m8", {"tokens": data["tokens"]}),
                    ("packed", {"tokens": data["tokens"], "segment_ids": data["segment_ids"]})):
    kw, M, wire, _ = CASES[name]
    res[name] = pp_case(mesh, data["npp"], batch, M, wire)
shutdown_distributed()
from tony_tpu_torch.train import pretrain
res["train"] = train_runs(ckpt, ports, pretrain, ["--device", "cpu", "--preset", "tiny", "--steps", "2",
                                                  "--batch_size", "8", "--seq_len", "32", "--log_every", "1",
                                                  "--stage_axis", "2", "--pp_microbatches", "4",
                                                  "--prefetch_depth", "0"])
torch.save(res, out)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_gang(script: str, n: int, args: list[str], consts: str):
    """``n`` gloo ranks of ``script`` (the env the torch runtime adapter
    exports, one intra-op thread each); returns a function that waits for
    them and asserts each exited 0."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", COMMON + consts + script, *[a.format(rank=rank) for a in args]],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def finish() -> None:
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:  # a rank left waiting on a collective
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-3000:]

    return finish


def one_thread(fn):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


class At:
    """A rank's coordinates on a mesh, as ``shard`` and ``Layout`` read them."""

    def __init__(self, shape: dict, coords: dict):
        self.shape = {a: shape.get(a, 1) for a in ("stage", "data", "fsdp", "expert", "context", "model")}
        self.coords = coords

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def rank_blocks(rules, whole: dict, shape: dict, coords: dict) -> dict:
    """The blocks of ``whole`` ({leaf: array}) that the rank at ``coords``
    holds, by leaf (another stage's left out)."""
    layout = Layout(rules, At(shape, coords))
    out = {}
    for name, w in whole.items():
        block = layout.place(name, w.detach() if torch.is_tensor(w) else torch.from_numpy(np.array(w)))
        if block is not None:
            out[name] = block
    return out


def grad_err(got, want) -> float:
    """‖got − want‖∞ relative to ``want``'s max (JAX's rule)."""
    got, want = got.double(), (want if torch.is_tensor(want) else torch.from_numpy(np.array(want))).double()
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


def rel(got, want) -> float:
    got, want = (t.double() if torch.is_tensor(t) else torch.from_numpy(np.array(t)).double() for t in (got, want))
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def packed_segments(batch: int, length: int) -> np.ndarray:
    """Two segments a row and trailing padding (segment 0), as JAX's packed 1F1B test."""
    seg = np.ones((batch, length), np.int32)
    seg[:, length // 2:] = 2
    seg[:, -4:] = 0
    return seg


def jax_pp(jmodel, jcfg, npp, batch, kw, M, wire):
    """JAX's ``pp_value_and_grad`` on ``kw``'s mesh over as many virtual devices."""
    mesh = JMeshSpec(**kw).build(jax.devices()[:int(np.prod(list(kw.values())))])
    loss, metrics, grads = jax.jit(functools.partial(
        jmodel.pp_value_and_grad, cfg=jcfg, mesh=mesh, num_microbatches=M, wire_dtype=getattr(jnp, wire)))(
        npp, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": dict(leaves(jax.tree.map(np.asarray, grads)))}


def jax_train(jmodel, jcfg, npp, batches):
    """JAX's ``sharded_init`` + ``make_pp_train_step`` on ``stage 2``: each
    step's (loss, grad norm) and the final parameters."""
    mesh = JMeshSpec(stage=2).build(jax.devices()[:2])
    opt = JT.OptimizerConfig(learning_rate=1e-2, warmup_steps=1, total_steps=STEPS).build()
    state = JT.sharded_init(lambda: jax.tree.map(jnp.asarray, npp), jmodel.sharding_rules(jcfg), mesh, opt)
    step = JT.make_pp_train_step(functools.partial(jmodel.pp_value_and_grad, cfg=jcfg, mesh=mesh,
                                                   num_microbatches=LOOP["pp_microbatches"]), opt)
    out = []
    for b in batches:
        state, m = step(state, {"tokens": jnp.asarray(b)})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, dict(leaves(jax.tree.map(np.asarray, state.params)))


def loop_inputs(tmodel, tcfg):
    """The loop's one-process init (every rank draws every leaf of it) and
    its synthetic global batches, as numpy."""
    init = tmodel.init(torch.Generator().manual_seed(0), tcfg, "cpu")
    batches = [tmodel.synthetic_batch(TLp._batch_generator(torch.device("cpu"), 0, s), B, T, tcfg)["tokens"].numpy()
               for s in range(STEPS)]
    return jax.tree.map(lambda t: t.detach().numpy(), init), batches


def restore_one(tmodel, tcfg, ckpt):
    """The stage gang's step restored into one process (a fresh state of other values)."""
    return TC.restore_or_init(str(ckpt), lambda: TT.TrainState.create(
        tmodel.init(torch.Generator().manual_seed(1), tcfg, "cpu"), TT.OptimizerConfig().build()),
        TT.TrainState.load)


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """Both gangs, started together, beside JAX's runs on the same weights
    and batches."""
    d = tmp_path_factory.mktemp("pp")
    npp = jax.tree.map(np.asarray, JL.init(jax.random.PRNGKey(3), JCFG))
    tokens = np.random.default_rng(5).integers(0, JCFG.vocab_size, (B, T + 1))
    seg = packed_segments(B, T + 1)
    torch.save({"npp": npp, "tokens": torch.from_numpy(tokens), "segment_ids": torch.from_numpy(seg)}, d / "in.pt")
    data_dir = d / "data"
    data_dir.mkdir()
    for i in range(2):
        TD.write_token_shard(data_dir / f"s{i}.tonytok", np.random.default_rng(i).integers(0, JCFG.vocab_size, 3000))
    finish4 = start_gang(_GANG4, 4, [str(d / "in.pt"), str(d / "r4_{rank}.pt"), str(d / "ckpt"), str(data_dir),
                                     str(_free_port())], CONSTS)
    finish2 = start_gang(_GANG2, 2, [str(d / "in.pt"), str(d / "r2_{rank}.pt"), str(d / "ckpt"),
                                              *(str(_free_port()) for _ in range(4))], CONSTS)
    init, batches = loop_inputs(TL, TCFG)

    def oracles():
        out = {}
        for name, (kw, M, wire, packed) in CASES.items():
            batch = {"tokens": tokens, **({"segment_ids": seg} if packed else {})}
            out[name] = jax_pp(JL, JCFG, npp, batch, kw, M, wire)
        out["train"] = jax_train(JL, JCFG, init, batches)
        return out

    t0 = time.perf_counter()
    jax_runs = one_thread(oracles)
    jax_s = time.perf_counter() - t0
    finish4()
    finish2()
    one = restore_one(TL, TCFG, d / "ckpt")
    loader = TokenLoader(sorted(data_dir.glob("*.tonytok")), B, T, seed=0)
    stream = [loader.next() for _ in range(2)]
    loader.close()
    return {"stream": stream, "gang4": [torch.load(d / f"r4_{r}.pt", weights_only=False) for r in range(4)],
            "gang2": [torch.load(d / f"r2_{r}.pt", weights_only=False) for r in range(2)],
            "jax": jax_runs, "jax_s": jax_s, "one": one}


def case_ranks(gangs, name):
    return gangs["gang2" if name in ("stage2_m8", "packed") else "gang4"]


def check_case(ranks, want, rules, case, wire):
    """Every rank's loss and metrics (the token count exact) against JAX's, and each gradient block
    it holds against the same block of JAX's; returns the worst gradient
    error. Across the ranks every leaf is held."""
    worst, held = 0.0, set()
    for res in ranks:
        got = res[case]
        assert abs(got["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"]), (case, got["loss"], want["loss"])
        for k, w in want["metrics"].items():
            g = got["metrics"][k]
            assert g == w if k == "tokens" else abs(g - w) <= LOSS_REL * abs(w), (case, k, g, w)
        expected = rank_blocks(rules, want["grads"], got["shape"], got["coords"])
        assert set(got["grads"]) == set(expected), (case, sorted(got["grads"]), sorted(expected))
        held |= set(got["grads"])
        for name, g in got["grads"].items():
            err = grad_err(g, expected[name])
            worst = max(worst, err)
            assert err <= GRAD_REL[wire], (case, name, err)
    assert held == set(want["grads"]), case
    return worst


@pytest.mark.parametrize("case", list(CASES))
def test_pp_value_and_grad_matches_jaxs_on_the_same_mesh(gangs, case):
    """The loss within 1e-5 relative, the token count equal, and each
    gradient block within 1e-4 of the leaf's max, on every rank."""
    worst = check_case(case_ranks(gangs, case), gangs["jax"][case], TL.sharding_rules(TCFG), case, CASES[case][2])
    print(f"{case}: worst gradient error {worst:.2e}")


def test_swapped_rings_at_four_stages_fail_the_bounds(gangs):
    """The mutant (activations to the previous stage, gradients to the
    next) runs to its end and fails both the loss and the gradient bounds."""
    want = gangs["jax"]["stage4_m4"]
    losses = [r["stage4_swapped"]["loss"] for r in gangs["gang4"]]
    assert all(abs(x - want["loss"]) > 100 * LOSS_REL * abs(want["loss"]) for x in losses), losses
    with pytest.raises(AssertionError):
        check_case(gangs["gang4"], {**want, "loss": losses[0]}, TL.sharding_rules(TCFG), "stage4_swapped",
                   "float32")


def test_a_stage_gang_lays_stage_outermost_and_owns_its_leaves(gangs):
    """Rank r sits at stage r // (data·fsdp); ``MeshSpec.auto`` fills the
    rest of a gang into fsdp; the stage line is the ranks of one data ×
    fsdp index and ``group`` the data × fsdp ranks of one stage; each rank
    holds only its L/S layers plus the embedding (first stage) or the
    final norm and head (last stage)."""
    assert gangs["gang4"][0]["auto"] == {"stage": 2, "data": 1, "fsdp": 2, "expert": 1, "context": 1, "model": 1}
    for case in ("stage4_m4", "stage2_data2", "stage2_fsdp2"):
        for r, res in enumerate(gangs["gang4"]):
            shape, coords = res[case]["shape"], res[case]["coords"]
            inner = shape["data"] * shape["fsdp"]
            assert coords["stage"] == r // inner
            assert coords["data"] * shape["fsdp"] + coords["fsdp"] == r % inner
    for r, res in enumerate(gangs["gang2"]):
        assert res["stage_line"] == [0, 1] and res["group"] == [r]
        names = set(res["stage2_m8"]["grads"])
        layers = {n for n in names if n.startswith("layers/")}
        assert names - layers == ({"embed"} if r == 0 else {"final_norm", "lm_head"})
        assert all(res["stage2_m8"]["grads"][n].shape[0] == LAYERS // 2 for n in layers)


def test_run_lm_training_on_stages_matches_jaxs_make_pp_train_step(gangs):
    """3 steps of ``run_lm_training(stage_axis=2)``: every rank logs JAX's
    losses and grad norms (the log's 4 decimals), and its blocks of the
    final parameters are JAX's within 1e-4 relative."""
    want, jparams = gangs["jax"]["train"]
    assert min(g for _, g in want) > 0
    for r, res in enumerate(gangs["gang2"]):
        log = res["train"]["log"]
        assert [x["step"] for x in log] == [1, 2, 3]
        for x, (jl, jg) in zip(log, want, strict=True):
            assert abs(x["loss"] - jl) <= 1.5e-4 and abs(x["grad_norm"] - jg) <= 1.5e-4, (log, want)
        mine = rank_blocks(TL.sharding_rules(TCFG), jparams, {"stage": 2}, {"stage": r})
        assert set(mine) == set(res["train"]["final"]["params"])
        for name, p in res["train"]["final"]["params"].items():
            assert rel(p, mine[name]) < 1e-4, name


def test_a_stage_gangs_save_restores_into_one_process_and_a_stage_gang(gangs):
    """The step-3 save holds each leaf once (DCP): one process restores
    every leaf and its moments, bit for bit the blocks the ranks held, and
    a fresh stage gang restores its own blocks bit for bit."""
    state, _, start = gangs["one"]
    assert start == STEPS and state.step == STEPS and state.opt_state["count"] == STEPS
    whole = {"params": dict(TT._leaves(state.params)), "mu": dict(TT._leaves(state.opt_state["mu"])),
             "nu": dict(TT._leaves(state.opt_state["nu"]))}
    rules = TL.sharding_rules(TCFG)
    for r, res in enumerate(gangs["gang2"]):
        final, restored = res["train"]["final"], res["train"]["gang_restore"]
        assert restored["start"] == STEPS and restored["count"] == STEPS
        for part in ("params", "mu", "nu"):
            mine = rank_blocks(rules, whole[part], {"stage": 2}, {"stage": r})
            assert set(mine) == set(final[part]) == set(restored["blocks"][part])
            for name, t in mine.items():
                assert torch.equal(final[part][name], t), (part, name)
                assert torch.equal(restored["blocks"][part][name], t), (part, name)


def test_a_stage_2_save_restores_onto_4_stages(gangs):
    """Another stage count: a gang of 4 stages (one layer each) restores the
    2-stage save, each rank its own leaves and moments, bit for bit the
    blocks of one process's restore."""
    state, _, _ = gangs["one"]
    whole = {"params": dict(TT._leaves(state.params)), "mu": dict(TT._leaves(state.opt_state["mu"])),
             "nu": dict(TT._leaves(state.opt_state["nu"]))}
    for r, res in enumerate(gangs["gang4"]):
        got = res["stage4_restore"]
        assert got["start"] == STEPS and got["coords"]["stage"] == r
        for part in ("params", "mu", "nu"):
            mine = rank_blocks(TL.sharding_rules(TCFG), whole[part], {"stage": 4}, {"stage": r})
            assert set(mine) == set(got["blocks"][part])
            assert all(torch.equal(got["blocks"][part][n], t) for n, t in mine.items()), (r, part)


def test_a_stage_gangs_shards_read_their_block_of_each_microbatch(gangs):
    """``run_lm_training`` on a data dir, ``stage 2 × fsdp 2`` (the gang's
    fill): the two ranks of a stage line read the same rows, and the rows of
    fsdp index k are block k of each microbatch of the one-process stream's
    global batch (JAX's split of a microbatch over the batch axes)."""
    for r, res in enumerate(gangs["gang4"]):
        assert len(res["rows"]) == 2
        for step, got in enumerate(res["rows"]):
            want = microbatch_rows({"t": torch.from_numpy(gangs["stream"][step]).long()}, LOOP["pp_microbatches"], 2,
                                   r % 2)["t"]
            assert torch.equal(got, want), (r, step)


def test_the_pretrain_entry_trains_the_stage_axis_as_the_loop(gangs):
    """``pretrain --stage_axis 2 --pp_microbatches 4`` reaches the loop with
    those settings and trains the same bits as ``run_lm_training`` called
    with them."""
    for res in gangs["gang2"]:
        entry = res["train"]["entry"]
        assert entry["loop"]["stage_axis"] == 2 and entry["loop"]["pp_microbatches"] == 4
        strip = [{k: v for k, v in x.items() if k in ("step", "loss", "grad_norm")} for x in entry["log"]]
        assert strip == [{k: v for k, v in x.items() if k in ("step", "loss", "grad_norm")} for x in entry["direct"]]
        assert len(strip) == 2 and all(np.isfinite(x["loss"]) for x in strip)


def test_the_schedule_and_the_layer_split_are_jaxs():
    """``Schedule``: microbatch ``t - s`` forward and ``t - 2S + 1 + s``
    backward on tick t, ``M + 2S - 1`` ticks, every microbatch once each way
    on every stage, and a forward slot never overwritten before its backward
    reads it; ``split_layers_into_stages`` refuses a depth that does not
    split, in JAX's words."""
    for S, M in ((2, 4), (2, 8), (4, 4), (4, 2)):
        for s in range(S):
            sch = Schedule(S, M, s)
            assert sch.ticks() == M + 2 * S - 1
            fwd = [sch.forward(t) for t in range(sch.ticks())]
            bwd = [sch.backward(t) for t in range(sch.ticks())]
            assert sorted(m for m in fwd if m is not None) == list(range(M))
            assert sorted(m for m in bwd if m is not None) == list(range(M))
            live = {}
            for t in range(sch.ticks()):
                if fwd[t] is not None:
                    live[sch.write_slot(fwd[t])] = fwd[t]
                if bwd[t] is not None:
                    assert live[sch.read_slot(bwd[t])] == bwd[t]
    layers = {"wq": torch.arange(24.0).reshape(4, 6)}
    assert torch.equal(split_layers_into_stages(layers, 2)["wq"][1], layers["wq"][2:])
    with pytest.raises(ValueError, match="4 layers not divisible by 3 stages"):
        split_layers_into_stages(layers, 3)


@pytest.mark.parametrize("model", ["llama", "mixtral"])
def test_pp_value_and_grad_without_stages_is_the_flat_step(model):
    """A stage axis of 1 (no mesh, or a one-process mesh) runs the flat
    loss and its gradients, as JAX's ``pp_value_and_grad`` does: the same
    loss, metrics and gradient bits, shaped like the parameters."""
    from tony_tpu_torch.models import mixtral

    mod = {"llama": TL, "mixtral": mixtral}[model]
    cfg = dataclasses.replace(mod.PRESETS["tiny"], dtype="float32")
    params = mod.init(torch.Generator().manual_seed(0), cfg, "cpu")
    for _, p in leaves(params):
        p.requires_grad_(True)
    batch = mod.synthetic_batch(torch.Generator().manual_seed(1), 2, 16, cfg)
    want_loss, want_metrics = mod.loss_fn(params, batch, cfg)
    want = torch.autograd.grad(want_loss, [p for _, p in leaves(params)])
    for mesh in (None, MeshSpec().build("cpu")):
        loss, metrics, grads = mod.pp_value_and_grad(params, batch, cfg, mesh, num_microbatches=2)
        assert torch.equal(loss, want_loss.detach()) and metrics.keys() == want_metrics.keys()
        assert [n for n, _ in leaves(grads)] == [n for n, _ in leaves(params)]
        assert all(torch.equal(g, w) for (_, g), w in zip(leaves(grads), want))


def test_the_stage_axis_refuses_what_is_not_ported_before_building(monkeypatch):
    """A context axis beside stages (JAX's words), a model axis or Llama's
    expert axis beside them (A13c), ``pp_chunks > 1`` (A13b), a depth that
    does not split, a family without ``pp_value_and_grad`` (JAX's words),
    and a stage axis in one process, all before anything is built."""
    from tony_tpu_torch.models import bert, mlp

    with pytest.raises(ValueError, match="pipeline parallelism does not compose with a context axis"):
        MeshSpec(stage=2, context=2).build("cpu")
    for kw in (dict(model=2), dict(expert=2)):
        with pytest.raises(NotImplementedError, match="A13c"):
            MeshSpec(stage=2, **kw).build("cpu")
    with pytest.raises(ValueError, match="needs a gang of as many processes"):
        MeshSpec(stage=2).build("cpu")
    monkeypatch.setattr(TLp, "init_distributed", lambda *a: pytest.fail("built before refusing"))
    cases = [(dict(context_axis=2), ValueError, "does not compose with a context axis"),
             (dict(model_axis=2), NotImplementedError, "A13c"),
             (dict(expert_axis=2), NotImplementedError, "A13c"),
             (dict(pp_chunks=2), NotImplementedError, "A13b")]
    for kw, exc, words in cases:
        with pytest.raises(exc, match=words):
            TLp.run_lm_training(TL, TCFG, TLp.LoopConfig(device="cpu", stage_axis=2, **kw))
    with pytest.raises(ValueError, match="4 layers not divisible by 3 stages"):
        TLp.run_lm_training(TL, TCFG, TLp.LoopConfig(device="cpu", stage_axis=3))
    for mod, cfg in ((bert, bert.BERT_TINY), (mlp, mlp.MLPConfig())):
        with pytest.raises(ValueError, match="has no pp_value_and_grad"):
            TLp.run_lm_training(mod, cfg, TLp.LoopConfig(device="cpu", stage_axis=2))
    from tony_tpu_torch.parallel.mesh import Mesh, context_degree

    stage_mesh = Mesh(shape={"stage": 2, "data": 1, "fsdp": 1, "expert": 1, "context": 1, "model": 1},
                      device=torch.device("cpu"), ring=None)
    with pytest.raises(NotImplementedError, match="trains through pp_value_and_grad"):  # not the flat loss
        context_degree(stage_mesh, tensor_parallel=True)


def test_the_stage_layout_places_a_decoders_leaves():
    """``Layout`` on a stage axis: the stacked layers cut on their leading
    dim, the embedding on stage 0, the rest on the last; the blocks' whole
    shapes are the leaves'."""
    rules = TL.sharding_rules(TCFG)
    w = torch.arange(4 * 6.0).reshape(4, 6)
    for s in range(2):
        layout = Layout(rules, At({"stage": 2, "fsdp": 1}, {"stage": s}))
        assert layout.sharded and layout.owns("layers/wq")
        block = layout.place("layers/wq", w)
        assert torch.equal(block, w[2 * s:2 * s + 2]) and layout.full_shape("layers/wq", block) == (4, 6)
        assert (layout.place("embed", w) is None) == (s == 1)
        assert (layout.place("lm_head", w) is None) == (s == 0)
        assert (layout.place("final_norm", w) is None) == (s == 0)
