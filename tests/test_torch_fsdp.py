"""The fsdp axis on the CPU: gloo gangs of the port against JAX's sharded
step and against one process, and the sharded checkpoints across gang
sizes. Every gang runs its ranks with ``OMP_NUM_THREADS=1``, one spawned
gang per mesh shape with several checks inside it, in f32.

- A gang of 4 on ``data 2 × fsdp 2`` trains the tiny Llama 3 steps from
  weights JAX drew (bridged by ``models/convert.py``), against JAX's
  ``sharded_init`` + ``make_train_step`` on ``MeshSpec(data=2, fsdp=2)``
  over 4 of the 8 virtual CPU devices, whose embedding takes its one-hot
  branch there (the port takes the rows: the same values). Losses and grad
  norms within 1e-5 relative; each rank's blocks of the updated parameters
  within 1e-4 relative of the same blocks of JAX's (the tolerance of the
  one-process trajectory test: Adam's normalised steps carry the
  gradients' last-bit differences into the parameters).
- In that gang: each rank holds 1/fsdp of every leaf the rules split and
  of its moments, exactly, and the whole of the others; the weights are
  gathered one leaf of one layer at a time (2 + 7·L gathers a forward and
  backward without remat, 2 + 14·L under remat "full", whose backward
  gathers each layer again), never a stacked leaf.
- The same gang on ``fsdp 4`` (``MeshSpec.auto``'s fill) inits sharded (each
  block bit for bit the one-process init's), trains 2 steps and saves
  both, each rank writing its blocks. The steps restore bit for bit onto
  a gang of 2 on ``fsdp 2`` and on ``data 2``, and onto one process; a
  torn step is quarantined and the previous one restored.
- A gang of 2 on ``fsdp 2`` equals one process on the global batch for
  Mixtral (C2: the router statistics over the whole batch, on plain,
  packed and half-padding rows) and for BERT (unequal target counts, with
  ``accum_steps`` 1 and 2, C3): the loss and router losses within 1e-5,
  the token count exactly, and each rank's gradient blocks within 1e-4
  relative of the same blocks of one process's gradients. The same runs
  against JAX's ``sharded_init`` + ``make_train_step`` on
  ``MeshSpec(fsdp=2)`` over 2 virtual devices, from the same weights: the
  losses and router losses within 1e-5 relative, the updated parameter
  blocks within 1e-4 relative. And the fsdp
  collectives (``all_gather``, ``psum``, ``psum_scatter``,
  ``ring_all_reduce_sum``) give their values and gradients exactly.
"""

import dataclasses
import functools
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tony_tpu.models import bert as JB  # noqa: E402
from tony_tpu.models import llama as JL  # noqa: E402
from tony_tpu.models import mixtral as JMx  # noqa: E402
from tony_tpu.parallel.mesh import MeshSpec as JMeshSpec  # noqa: E402
from tony_tpu.train import trainer as JT  # noqa: E402
from tony_tpu_torch.chaos.inject import corrupt_latest_checkpoint  # noqa: E402
from tony_tpu_torch.models import llama as TL  # noqa: E402
from tony_tpu_torch.train import checkpoint as TC  # noqa: E402
from tony_tpu_torch.train import trainer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=3, grad_clip=0.5)
B, T, STEPS = 8, 32, 3
_JCFG = {JL: JL.LLAMA_TINY, JMx: JMx.MIXTRAL_TINY, JB: JB.BERT_TINY}

# shared by the gangs and the one-process references: the optimizer that
# records the gradients it is given, the global batches and one case's run
_COMMON = """
import dataclasses, functools, sys, torch
import torch.distributed as dist
from tony_tpu_torch.models import bert, llama, mixtral
from tony_tpu_torch.parallel import collectives
from tony_tpu_torch.parallel.mesh import MeshSpec
from tony_tpu_torch.parallel.sharding import Layout, shard_params
from tony_tpu_torch.train import trainer as TT
from tony_tpu_torch.train.checkpoint import CheckpointManager, restore_or_init

CFG = dataclasses.replace(llama.LLAMA_TINY, dtype="float32")
MCFG = dataclasses.replace(mixtral.MIXTRAL_TINY, dtype="float32")
BCFG = dataclasses.replace(bert.BERT_TINY, dtype="float32")
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=3, grad_clip=0.5)
B, T = 8, 32
# Mixtral rows as (segment, length) runs of the T+1 ids, 0 padding: rank 0's
# rows hold more routed tokens than rank 1's; step 2's second half is padding
PACKED = [((1, 25), (0, 8)), ((1, 10), (2, 23)), ((1, 33),), ((1, 5), (2, 20), (0, 8)),
          ((1, 20), (0, 13)), ((0, 33),), ((1, 3), (0, 30)), ((1, 16), (2, 17))]
PAD = ((0, 33),)


class Recording(TT.AdamW):
    def update(self, params, grads, state, norm):
        self.seen.append({k: g.detach().clone() for k, g in grads.items()})
        super().update(params, grads, state, norm)


def global_batch(model, step):
    gen = torch.Generator().manual_seed(100 + step)
    if model is bert:
        return bert.dense_synthetic_batch(gen, B, T, BCFG)
    batch = mixtral.synthetic_batch(gen, B, T, MCFG)
    if step:
        rows = PACKED if step == 1 else PACKED[:4] + [PAD] * 4
        batch["segment_ids"] = torch.tensor([sum(([s] * n for s, n in row), []) for row in rows])
    return batch


def run_case(model, cfg, steps, accum, mesh):
    # one case on this rank's rows (mesh None: one process, the whole batch):
    # each step's metrics, the gradients (blocks) the optimizer received and
    # the updated parameters (blocks)
    world = 1 if mesh is None else dist.get_world_size()
    rank = 0 if mesh is None else dist.get_rank()
    opt = Recording(TT.OptimizerConfig(**OPT))
    opt.seen = []
    init = functools.partial(model.init, torch.Generator().manual_seed(0), cfg, "cpu")
    if mesh is None:
        state = TT.TrainState.create(init(), opt)
    else:
        state = TT.sharded_init(init, model.sharding_rules(cfg), mesh, opt)
    step = TT.make_train_step(functools.partial(model.loss_fn, cfg=cfg, mesh=mesh), opt, accum_steps=accum,
                              group=None if mesh is None else mesh.group)
    rows = B // world
    log = []
    for i in steps:
        batch = {k: v[rank * rows:(rank + 1) * rows] for k, v in global_batch(model, i).items()}
        state, m = step(state, batch)
        log.append({k: float(v) for k, v in m.items() if k in ("loss", "tokens", "moe_balance_loss", "moe_z_loss")})
    return log, opt.seen, blocks(state)["params"]


def blocks(state):
    return {"params": {n: t.detach().clone() for n, t in TT._leaves(state.params)},
            "mu": {n: t.clone() for n, t in TT._leaves(state.opt_state["mu"])},
            "nu": {n: t.clone() for n, t in TT._leaves(state.opt_state["nu"])}}


def placement(mesh, rules, names):
    layout = Layout(rules, mesh)
    return {"fsdp": mesh.shape["fsdp"], "index": mesh.axis_index("fsdp"), "dims": {n: layout.dim(n) for n in names}}
"""

# the gang of 4: data 2 x fsdp 2 against JAX's sharded step (with the gathers
# counted), then fsdp 4 writing steps 1 and 2 of a sharded checkpoint
_GANG4 = """
inp, out, ckpt = sys.argv[1:4]
data = torch.load(inp)
rank = dist.get_rank()
res = {"auto": MeshSpec.auto().axis_sizes}
rules = llama.sharding_rules(CFG)
mesh = MeshSpec(data=2, fsdp=2).build("cpu")
whole = data["params"]
names = [n for n, _ in TT._leaves(whole)]
opt = TT.OptimizerConfig(**OPT).build()
state = TT.TrainState.create(shard_params(whole, rules, mesh), opt, Layout(rules, mesh))
step = TT.make_train_step(functools.partial(llama.loss_fn, cfg=CFG, mesh=mesh), opt, group=mesh.group)
rows = B // 4
gathered = []
real_gather = collectives._gather


def counting_gather(x, group, dim):
    out = real_gather(x, group, dim)
    gathered.append(tuple(out.shape))
    return out


collectives._gather = counting_gather
res["bytes"] = {"params": TT.tree_bytes(state.params), "mu": TT.tree_bytes(state.opt_state["mu"]),
                "nu": TT.tree_bytes(state.opt_state["nu"])}
log = []
for i, toks in enumerate(data["batches"]):
    state, m = step(state, {"tokens": toks[rank * rows:(rank + 1) * rows]})
    log.append((float(m["loss"]), float(m["grad_norm"])))
    if i == 0:
        res["gathers"] = list(gathered)
res["log"], res["blocks"] = log, blocks(state)
res["where"] = {**placement(mesh, rules, names), "data_index": mesh.axis_index("data")}
for remat in (False, True):  # one forward and backward: the gathers of each
    gathered.clear()
    cfg = dataclasses.replace(CFG, remat=remat)
    loss, _ = llama.loss_fn(state.params, {"tokens": data["batches"][0][:2]}, cfg, mesh)
    torch.autograd.grad(loss, [p for _, p in TT._leaves(state.params)])
    res[f"gathers_remat_{remat}"] = len(gathered)
collectives._gather = real_gather

mesh4 = MeshSpec.auto().build("cpu")
state = TT.sharded_init(functools.partial(llama.init, torch.Generator().manual_seed(0), CFG, "cpu"), rules, mesh4, opt)
res["init"] = blocks(state)
res["where4"] = placement(mesh4, rules, names)
step = TT.make_train_step(functools.partial(llama.loss_fn, cfg=CFG, mesh=mesh4), opt, group=mesh4.group)
mgr = CheckpointManager(ckpt, group=mesh4.group)
for i in (1, 2):
    state, _ = step(state, {"tokens": data["batches"][i][rank * rows:(rank + 1) * rows]})
    mgr.save(i, state.state_dict())
    res[f"step{i}"] = blocks(state)
mgr.close()
torch.save(res, out)
"""

# the gang of 2: the fsdp-4 steps restored on fsdp 2 and on data 2, the torn
# copy, then Mixtral (C2) and BERT (C3) on fsdp 2
_GANG2 = """
ckpt, torn, out = sys.argv[1:4]
res = {}
rules = llama.sharding_rules(CFG)
opt = TT.OptimizerConfig(**OPT).build()
names = [n for n, _ in TT._leaves(llama.init(torch.Generator().manual_seed(1), CFG, "cpu"))]
for name, spec, path in (("fsdp2", MeshSpec.auto(), ckpt), ("data2", MeshSpec(data=2), ckpt),
                         ("torn", MeshSpec.auto(), torn)):
    mesh = spec.build("cpu")
    init = functools.partial(llama.init, torch.Generator().manual_seed(1), CFG, "cpu")  # not the saved values
    state, _, start = restore_or_init(path, lambda: TT.sharded_init(init, rules, mesh, opt), TT.TrainState.load,
                                      group=mesh.group)
    res[name] = {"start": start, "step": state.step, "count": state.opt_state["count"], "blocks": blocks(state),
                 **placement(mesh, rules, names)}
mesh = MeshSpec.auto().build("cpu")
group, rank = mesh.axis_group("fsdp"), dist.get_rank()
x = (torch.arange(12.0).reshape(4, 3) * (rank + 1)).requires_grad_()
res["collectives"] = {}
for name, y in (("all_gather", collectives.all_gather(x, group, 1)), ("psum", collectives.psum(x, group)),
                ("psum_scatter", collectives.psum_scatter(x, group, 0)),
                ("ring_all_reduce_sum", collectives.ring_all_reduce_sum(x, group))):
    w = torch.arange(1.0, y.numel() + 1).reshape(y.shape)
    res["collectives"][name] = (y.detach(), torch.autograd.grad((w * y).sum(), x)[0])
res["mixtral"] = run_case(mixtral, MCFG, (0, 1, 2), 1, mesh)
for accum in (1, 2):
    res[f"bert {accum}"] = run_case(bert, BCFG, (0, 1), accum, mesh)
mnames = [n for n, _ in TT._leaves(mixtral.init(torch.Generator().manual_seed(0), MCFG, "cpu"))]
bnames = [n for n, _ in TT._leaves(bert.init(torch.Generator().manual_seed(0), BCFG, "cpu"))]
res["where_mixtral"] = placement(mesh, mixtral.sharding_rules(MCFG), mnames)
res["where_bert"] = placement(mesh, bert.sharding_rules(BCFG), bnames)
torch.save(res, out)
"""

# the tail of a rank's script: join the gloo group from the env, run, leave
_JOIN = """
from tony_tpu_torch.runtime import init_distributed, shutdown_distributed
init_distributed(torch.device("cpu"))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(script: str, n: int, args: list[str]):
    """``n`` gloo ranks of ``script`` (the env the torch runtime adapter
    exports, one intra-op thread each); returns a function that waits for
    them and asserts each exited 0."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _COMMON + _JOIN + script + "\nshutdown_distributed()\n",
             *[a.format(rank=rank) for a in args]],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def finish() -> None:
        try:
            outs = [p.communicate(timeout=240)[0] for p in procs]
        finally:
            for p in procs:  # a rank left waiting on a collective
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-3000:]

    return finish


def _one_thread(fn):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def _jax_sharded_run(jmod, npp, batches, spec, accum=1):
    """JAX's ``sharded_init`` + ``make_train_step`` (``accum_steps``
    ``accum``) of the tiny f32 config of the model module ``jmod`` from the
    numpy tree ``npp``, on ``spec`` over as many of the 8 virtual devices:
    each step's metrics and the final parameters."""
    jcfg = dataclasses.replace(_JCFG[jmod], dtype="float32")
    mesh = spec.build(devices=jax.devices()[:int(np.prod(list(spec.axis_sizes.values())))])
    opt = JT.OptimizerConfig(**OPT).build()
    state = JT.sharded_init(lambda: jax.tree.map(jnp.asarray, npp), jmod.sharding_rules(jcfg), mesh, opt)
    step = JT.make_train_step(functools.partial(jmod.loss_fn, cfg=jcfg, mesh=mesh), opt, accum_steps=accum)
    out = []
    for batch in batches:
        state, m = step(state, {k: jnp.asarray(np.asarray(v)) for k, v in batch.items()})
        out.append({k: float(v) for k, v in m.items()})
    return out, jax.tree.map(np.asarray, state.params)


def _jax_fsdp2_runs(ns):
    """The gang of 2's cases (``run_case``'s Mixtral and BERT) through JAX's
    sharded step on ``MeshSpec(fsdp=2)`` over 2 virtual devices, from the
    port's init: {case: (metrics, final params)}."""
    out = {}
    for case, model, jmod, cfg, steps, accum in (("mixtral", ns["mixtral"], JMx, ns["MCFG"], (0, 1, 2), 1),
                                                  ("bert 1", ns["bert"], JB, ns["BCFG"], (0, 1), 1),
                                                  ("bert 2", ns["bert"], JB, ns["BCFG"], (0, 1), 2)):
        npp = jax.tree.map(lambda t: t.detach().numpy(), model.init(torch.Generator().manual_seed(0), cfg, "cpu"))
        batches = [{k: v.numpy() for k, v in ns["global_batch"](model, i).items()} for i in steps]
        out[case] = _jax_sharded_run(jmod, npp, batches, JMeshSpec(fsdp=2), accum)
    return out


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _block(whole: torch.Tensor, where: dict, name: str) -> torch.Tensor:
    """The block of ``whole`` that the rank placed at ``where`` holds."""
    dim = where["dims"][name]
    return whole if dim is None else whole.chunk(where["fsdp"], dim)[where["index"]]


def _rel(got, want) -> float:
    got, want = torch.as_tensor(np.asarray(got)).double(), torch.as_tensor(np.asarray(want)).double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    """The gang of 4 (``_GANG4``) beside JAX's sharded run on the same
    weights and batches: (each rank's result, JAX's log, JAX's params,
    the checkpoint directory)."""
    d = tmp_path_factory.mktemp("fsdp4")
    npp = jax.tree.map(np.asarray, JL.init(jax.random.PRNGKey(3), dataclasses.replace(JL.LLAMA_TINY,
                                                                                        dtype="float32")))
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, JL.LLAMA_TINY.vocab_size, (B, T + 1)) for _ in range(STEPS)]
    from tony_tpu_torch.models.convert import params_from_numpy

    torch.save({"params": params_from_numpy(npp, "cpu"), "batches": [torch.from_numpy(b) for b in batches]},
               d / "in.pt")
    finish = _start(_GANG4, 4, [str(d / "in.pt"), str(d / "r{rank}.pt"), str(d / "ckpt")])
    want, jparams = _one_thread(lambda: _jax_sharded_run(JL, npp, [{"tokens": b} for b in batches],
                                                         JMeshSpec(data=2, fsdp=2)))
    finish()
    ranks = [torch.load(d / f"r{r}.pt", weights_only=False) for r in range(4)]
    return ranks, want, jparams, d / "ckpt"


@pytest.fixture(scope="module")
def gang2(gang4, tmp_path_factory):
    """The gang of 2 (``_GANG2``) beside one process's Mixtral and BERT
    runs and JAX's on fsdp 2: (each rank's result, one process's results,
    the torn copy, JAX's results)."""
    d = tmp_path_factory.mktemp("fsdp2")
    torn = d / "torn"
    shutil.copytree(gang4[3], torn)
    assert corrupt_latest_checkpoint(str(torn)) == 2
    finish = _start(_GANG2, 2, [str(gang4[3]), str(torn), str(d / "r{rank}.pt")])
    ns: dict = {}
    exec(_COMMON, ns)
    one = _one_thread(lambda: {
        "mixtral": ns["run_case"](ns["mixtral"], ns["MCFG"], (0, 1, 2), 1, None),
        **{f"bert {a}": ns["run_case"](ns["bert"], ns["BCFG"], (0, 1), a, None) for a in (1, 2)}})
    jax_runs = _one_thread(lambda: _jax_fsdp2_runs(ns))
    finish()
    return [torch.load(d / f"r{r}.pt", weights_only=False) for r in range(2)], one, torn, jax_runs


def test_data2_fsdp2_llama_matches_jaxs_sharded_step(gang4):
    """Losses and grad norms within 1e-5 relative of JAX's, each step, on
    every rank; each rank's blocks of the updated parameters within 1e-4
    relative of the same blocks of JAX's (the clip is active)."""
    ranks, want, jparams, _ = gang4
    want = [(m["loss"], m["grad_norm"]) for m in want]
    assert min(g for _, g in want) > OPT["grad_clip"]
    for res in ranks:
        assert res["auto"]["fsdp"] == 4 and res["auto"]["data"] == 1  # JAX's fill of a gang of 4
        for (tl, tg), (jl, jg) in zip(res["log"], want):
            assert abs(tl - jl) <= 1e-5 * abs(jl) and abs(tg - jg) <= 1e-5 * abs(jg), (res["log"], want)
        for name, p in _leaves(jparams):
            got = res["blocks"]["params"][name]
            assert _rel(got, _block(torch.from_numpy(np.array(p)), res["where"], name)) < 1e-4, name
    # the data axis's two replicas of one block are the same bits
    for a, b in ((0, 2), (1, 3)):
        assert ranks[a]["where"]["index"] == ranks[b]["where"]["index"]
        assert ranks[a]["where"]["data_index"] != ranks[b]["where"]["data_index"]
        for name, t in ranks[a]["blocks"]["params"].items():
            assert torch.equal(t, ranks[b]["blocks"]["params"][name]), name


def test_each_rank_holds_one_fsdp_th_of_the_split_leaves_and_their_moments(gang4):
    """Per leaf, a split leaf's block (and its moments' blocks) is
    ``numel / fsdp`` exactly, a whole leaf is whole; the rank's bytes are
    their sum, as the loop's step report counts them."""
    ranks, _, jparams, _ = gang4
    whole = {n: p.size * 4 for n, p in _leaves(jparams)}
    for res in ranks:
        where = res["where"]
        split = [n for n, d in where["dims"].items() if d is not None]
        assert {"embed", "lm_head", "layers/wq", "layers/w_down"} <= set(split)
        assert where["dims"]["layers/attn_norm"] is None and where["dims"]["final_norm"] is None
        want = sum(whole[n] // 2 if n in split else whole[n] for n in whole)
        for part in ("params", "mu", "nu"):
            assert res["bytes"][part] == want, part
            for n, t in res["blocks"][part].items():
                assert t.numel() * 4 * (2 if n in split else 1) == whole[n], (part, n)
        assert want < 0.52 * sum(whole.values())  # all but the norms split in two


def test_weights_are_gathered_per_layer_on_use(gang4):
    """One gather a split leaf a layer (and the embedding and the head), so
    at most one layer's whole weights a gather; under remat "full" the
    backward gathers every layer again."""
    ranks, _, _, _ = gang4
    L, split_per_layer = TL.LLAMA_TINY.n_layers, 7
    for res in ranks:
        assert res["gathers_remat_False"] == 2 + split_per_layer * L
        assert res["gathers_remat_True"] == 2 + 2 * split_per_layer * L
        assert len(res["gathers"]) == 2 + split_per_layer * L
        assert all(len(shape) == 2 for shape in res["gathers"])  # never a stacked [L, ...] leaf


def test_sharded_init_is_the_one_process_init_and_the_steps_restore_onto_one_process(gang4):
    """fsdp 4: each rank's blocks at init are those of the one-process init,
    bit for bit; the steps it wrote read back whole in one process (``fsdp
    1``), bit for bit against every rank's blocks, through ``read_whole``
    and through ``restore_or_init`` into a fresh whole state."""
    ranks, _, _, ckpt = gang4
    cfg = dataclasses.replace(TL.LLAMA_TINY, dtype="float32")
    init = dict(_leaves(TL.init(torch.Generator().manual_seed(0), cfg, "cpu")))
    assert TC.CheckpointManager(str(ckpt)).all_steps() == [1, 2]
    assert not (ckpt / "2" / TC.STATE_FILE).exists() and (ckpt / "2" / ".metadata").exists()  # DCP's
    for step in (1, 2):
        whole = TC.read_whole(str(ckpt / str(step)))
        assert whole["step"] == step and whole["opt_state"]["count"] == step
        for res in ranks:
            assert res["where4"]["fsdp"] == 4
            for name, t in init.items():
                assert torch.equal(res["init"]["params"][name], _block(t, res["where4"], name)), name
            for part, tree in (("params", whole["params"]), ("mu", whole["opt_state"]["mu"]),
                               ("nu", whole["opt_state"]["nu"])):
                for name, t in _leaves(tree):
                    assert torch.equal(res[f"step{step}"][part][name], _block(t, res["where4"], name)), name
    opt = TT.OptimizerConfig(**OPT).build()
    fresh = lambda: TT.TrainState.create(TL.init(torch.Generator().manual_seed(1), cfg, "cpu"), opt)  # noqa: E731
    state, _, start = TC.restore_or_init(str(ckpt), fresh, TT.TrainState.load)
    assert start == 2 and state.step == 2 and state.opt_state["count"] == 2
    whole = TC.read_whole(str(ckpt / "2"))
    for name, t in _leaves(state.params):
        assert torch.equal(t.detach(), dict(_leaves(whole["params"]))[name]), name


def test_fsdp4_steps_restore_onto_fsdp2_and_data2_and_a_torn_step_is_quarantined(gang2, gang4):
    """The fsdp-4 step 2 restored onto a gang of 2 on ``fsdp 2`` (half of
    each split leaf a rank) and on ``data 2`` (every leaf whole), bit for bit
    in params and both moments, with its step and count; the copy whose
    step 2 is torn is quarantined (``.corrupt-2``) and step 1 restored."""
    ranks, _, torn, _ = gang2
    for step, name in ((2, "fsdp2"), (2, "data2"), (1, "torn")):
        whole = TC.read_whole(str(gang4[3] / str(step)))
        trees = {"params": whole["params"], "mu": whole["opt_state"]["mu"], "nu": whole["opt_state"]["nu"]}
        for res in ranks:
            got = res[name]
            assert (got["start"], got["step"], got["count"]) == (step, step, step), name
            assert got["fsdp"] == (1 if name == "data2" else 2)
            for part, tree in trees.items():
                for leaf, t in _leaves(tree):
                    assert torch.equal(got["blocks"][part][leaf], _block(t, got, leaf)), (name, part, leaf)
    assert (torn / ".corrupt-2").is_dir() and TC.CheckpointManager(str(torn)).all_steps() == [1]


def test_fsdp_collectives_and_their_autograd_pairs(gang2):
    """Over the fsdp axis of a gang of 2, rank r holding ``x_r = base·(r+1)``
    and each rank's loss ``Σ w·y``: ``all_gather`` (dim 1) and ``psum``, and
    ``psum_scatter`` (dim 0) and ``ring_all_reduce_sum``, give JAX's values,
    and each gradient is the sum of every rank's loss's (the all-gather's
    backward the reduce-scatter, and back), exactly in f32."""
    ranks, _, _, _ = gang2
    base = torch.arange(12.0).reshape(4, 3)
    xs = [base, 2 * base]
    for rank, res in enumerate(ranks):
        got = res["collectives"]
        w24 = torch.arange(1.0, 25).reshape(4, 6)
        w12 = torch.arange(1.0, 13).reshape(4, 3)
        w6 = torch.arange(1.0, 7).reshape(2, 3)
        want = {"all_gather": (torch.cat(xs, 1), 2 * w24[:, 3 * rank:3 * rank + 3]),
                "psum": (xs[0] + xs[1], 2 * w12),
                "psum_scatter": ((xs[0] + xs[1])[2 * rank:2 * rank + 2], torch.cat([w6, w6])),
                "ring_all_reduce_sum": (xs[0] + xs[1], 2 * w12)}
        for name, (y, g) in want.items():
            assert torch.equal(got[name][0], y) and torch.equal(got[name][1], g), (rank, name, got[name])


def _assert_same_case(got, want, where, what) -> None:
    (got_log, got_grads, _), (want_log, want_grads, _) = got, want
    assert len(got_log) == len(want_log) == len(got_grads) == len(want_grads), what
    for step, (g, w) in enumerate(zip(got_log, want_log)):
        assert g.keys() == w.keys() and g.get("tokens") == w.get("tokens"), (what, step, g, w)
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-5, (what, step, k, g, w)
    for step, (g, w) in enumerate(zip(got_grads, want_grads)):
        assert g.keys() == w.keys(), what
        for name, t in w.items():
            want_block = _block(t, where, name)
            err = float((g[name] - want_block).abs().max() / want_block.abs().max().clamp_min(1e-12))
            assert err <= 1e-4, (what, step, name, err)


def test_mixtral_on_fsdp2_takes_its_router_losses_over_the_global_batch(gang2):
    """C2 on the fsdp axis: the loss, balance and z losses of the global
    batch on every rank, and each rank's blocks of the gradients those of
    one process, on plain rows, packed rows whose ranks route unequal
    counts, and rows whose second half (rank 1's) is all padding."""
    ranks, one, _, _ = gang2
    assert any(d is not None for d in ranks[0]["where_mixtral"]["dims"].values())
    assert ranks[0]["where_mixtral"]["dims"]["layers/we_gate"] == 2  # [L, E, D, F] split on D
    assert all({"moe_balance_loss", "moe_z_loss"} <= set(x) for x in one["mixtral"][0])
    for rank, res in enumerate(ranks):
        _assert_same_case(res["mixtral"], one["mixtral"], res["where_mixtral"], ("mixtral", rank))


@pytest.mark.parametrize("accum", [1, 2])
def test_bert_on_fsdp2_weighs_unequal_targets_and_microbatches_as_one_process(gang2, accum):
    """BERT's dense MLM rows hold unequal target counts on the two ranks:
    with ``accum_steps`` 1 each rank weighs ``n_r / Σn``, with 2 each holds
    one whole microbatch (C3); the loss of the global batch and each rank's
    gradient blocks are one process's."""
    ranks, one, _, _ = gang2
    for rank, res in enumerate(ranks):
        _assert_same_case(res[f"bert {accum}"], one[f"bert {accum}"], res["where_bert"], ("bert", accum, rank))


@pytest.mark.parametrize("case", ["mixtral", "bert 1", "bert 2"])
def test_mixtral_and_bert_on_fsdp2_match_jaxs_sharded_step(gang2, case):
    """The gang of 2's Mixtral (3 steps: plain, packed and half-padding rows)
    and BERT (2 steps, ``accum_steps`` 1 and 2; the first step's learning
    rate is 0, warmup from 0) runs against JAX's ``sharded_init`` +
    ``make_train_step`` on ``MeshSpec(fsdp=2)`` over 2 virtual devices from
    the same weights and batches: each step's loss, and Mixtral's balance
    and z losses, within 1e-5 relative, the token count exactly, and each
    rank's blocks of the updated parameters within 1e-4 relative of the
    same blocks of JAX's (the Llama gang's tolerance: Adam's normalised
    steps carry the gradients' last-bit differences into the parameters),
    BERT's key bias to Adam's bound."""
    ranks, _, _, jax_runs = gang2
    want_log, jparams = jax_runs[case]
    for rank, res in enumerate(ranks):
        log, _, params = res[case]
        where = res["where_mixtral" if case == "mixtral" else "where_bert"]
        assert len(log) == len(want_log), case
        for step, (got, want) in enumerate(zip(log, want_log)):
            assert got.get("tokens") == want.get("tokens"), (case, step, got, want)
            for k in got.keys() - {"tokens"}:
                assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (case, rank, step, k, got, want)
        got = {n: t.numpy() for n, t in params.items()}
        want = {n: _block(torch.from_numpy(np.array(p)), where, n).numpy() for n, p in _leaves(jparams)}
        if case != "mixtral":
            # BERT's key bias (bqkv's middle third, whole on every rank) has no
            # gradient but rounding noise, which Adam's normalised step makes
            # ~lr on either side: held to Adam's bound, as test_torch_bert.py does
            D = JB.BERT_TINY.d_model
            bound = sum(TT.OptimizerConfig(**OPT).build().learning_rate(c) for c in range(len(log))) * 1.01
            for side in (got, want):
                assert np.abs(side["layers/bqkv"][:, D:2 * D]).max() <= bound, (case, rank)
                side["layers/bqkv"] = np.delete(side["layers/bqkv"], np.s_[D:2 * D], axis=1)
        for name in want:
            assert _rel(got[name], want[name]) < 1e-4, (case, rank, name)
