"""Mixtral on the model axis, on the CPU: Megatron's attention and each
expert's F split over the model line in gloo gangs of the port against JAX's
sharded step, the router's gradient across a line, the router losses over a
data axis beside it, the slot groups of accumulated microbatches, the
sharded checkpoints, and the TP serving engine against JAX's. Every gang
runs its ranks with ``OMP_NUM_THREADS=1``, in f32, at ``MIXTRAL_TINY``
(``F/tp`` = 64 on the plain versions of B7/B8); the gangs run at once,
beside JAX's runs in this process.

- A gang of 4 on ``fsdp 2 × model 2`` and a gang of 2 on ``model 2`` train
  3 steps from seeded weights (bridged by ``models/convert.py``) against
  JAX's ``sharded_init`` + ``make_train_step`` on the same meshes over 4
  and 2 of the 8 virtual CPU devices, with the clip active: the loss, CE,
  balance and z losses and the grad norm within 1e-5 relative, each
  rank's blocks of the updated parameters within 1e-4 relative.
- The router, whole on every rank: its gradient is the same bits on the
  ranks of a model line at every step, and the first step's is JAX's
  (``jax.grad`` of the loss on the global batch) within 1e-5. Each rank
  holds ``1/(fsdp·model)`` of every expert leaf (D over fsdp, F over
  model); the gang of 4's step 3 restores bit for bit onto one process and
  onto ``fsdp 2``.
- The gang of 4 then runs ``data 2 × model 2`` on packed rows with padding:
  the balance and z losses on every rank are JAX's over the whole batch
  (C2 under a model axis: pooled over the data ranks of a model index,
  never over a model line, whose ranks hold the same rows).
- A gang of 8 on ``data 2 × fsdp 2 × model 2`` makes ``_microbatch_group``'s
  slot groups for ``accum_steps`` 2: each holds the data × fsdp ranks of
  one model line and one slot, as one all-reduce over it shows.
- The TP engine (``ContinuousBatcher(tp=2)``, both shards on the CPU) gives
  JAX's TP engine's greedy tokens and the tp=1 engine's, with a prompt
  longer than 16 tokens (its prefill through ``moe_ffn``); every shard's
  expert blocks are contiguous; ``serving_http --tp 2`` serves a Mixtral
  preset and an HF Mixtral directory with ``--tp 1``'s tokens.

B7/B8 at ``F/tp`` on a card (``D 4096, F 7168, E 8``) are held to their
plain versions in ``test_torch_cuda.py``, which imports no JAX.
"""

import concurrent.futures
import dataclasses
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tony_tpu.models import mixtral as JM  # noqa: E402
from tony_tpu.models import serving as JS  # noqa: E402
from tony_tpu.parallel.mesh import MeshSpec as JMeshSpec  # noqa: E402
from tony_tpu.train import trainer as JT  # noqa: E402
from tony_tpu_torch.models import mixtral as TM  # noqa: E402
from tony_tpu_torch.models import serving_http as TH  # noqa: E402
from tony_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from tony_tpu_torch.models.serving import ContinuousBatcher  # noqa: E402
from tony_tpu_torch.train import checkpoint as TC  # noqa: E402
from tony_tpu_torch.train import trainer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=3, grad_clip=0.5)
B, T, STEPS = 8, 32, 3
JCFG = dataclasses.replace(JM.MIXTRAL_TINY, dtype="float32")
TCFG = dataclasses.replace(TM.MIXTRAL_TINY, dtype="float32")
KEYS = ("loss", "ce_loss", "moe_balance_loss", "moe_z_loss", "grad_norm")
# packed rows as (segment, length) runs of the T+1 ids, 0 padding; the data
# ranks' halves route unequal counts and the last row is all padding
PACKED = [((1, 25), (0, 8)), ((1, 10), (2, 23)), ((1, 33),), ((1, 5), (2, 20), (0, 8)),
          ((1, 20), (0, 13)), ((1, 3), (0, 30)), ((1, 16), (2, 17)), ((0, 33),)]

# shared by the gangs: the recording optimizer, a trained run from JAX's
# weights, and where a rank's blocks sit
_COMMON = """
import dataclasses, functools, os, sys, time, torch
import torch.distributed as dist
from tony_tpu_torch.models import mixtral
from tony_tpu_torch.models.convert import blocks_from_numpy
from tony_tpu_torch.parallel.mesh import MeshSpec, model_group
from tony_tpu_torch.parallel.sharding import Layout
from tony_tpu_torch.runtime import init_distributed, shutdown_distributed
from tony_tpu_torch.train import trainer as TT
from tony_tpu_torch.train.checkpoint import CheckpointManager, restore_or_init

CFG = dataclasses.replace(mixtral.MIXTRAL_TINY, dtype="float32")
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=3, grad_clip=0.5)
B, T = 8, 32
RULES = mixtral.sharding_rules(CFG)
KEYS = ("loss", "ce_loss", "moe_balance_loss", "moe_z_loss", "grad_norm")


class Recording(TT.AdamW):
    def update(self, params, grads, state, norm):
        self.seen.append({k: g.detach().clone() for k, g in grads.items()})
        super().update(params, grads, state, norm)


def blocks(state):
    return {"params": {n: t.detach().clone() for n, t in TT._leaves(state.params)},
            "mu": {n: t.clone() for n, t in TT._leaves(state.opt_state["mu"])},
            "nu": {n: t.clone() for n, t in TT._leaves(state.opt_state["nu"])}}


def placement(mesh):
    layout = Layout(RULES, mesh)
    names = [n for n, _ in TT._leaves(mixtral.init(torch.Generator().manual_seed(1), CFG, "cpu"))]
    return {**{a: mesh.shape[a] for a in ("data", "fsdp", "model")},
            **{a[0] + "i": mesh.axis_index(a) for a in ("data", "fsdp", "model")},
            "dims": {n: (layout.dim(n), layout.model_dim(n)) for n in names}}


def rows_of(batch, mesh):
    # this rank's rows: those of its data x fsdp index
    rows = B // (mesh.shape["data"] * mesh.shape["fsdp"])
    k = dist.get_rank() // mesh.shape["model"]
    return {n: v[k * rows:(k + 1) * rows] for n, v in batch.items()}


def train(mesh, npp, batches):
    # 3 steps from the seeded weights on this rank's rows: the metrics, the
    # router's gradient at each step, the state
    opt = Recording(TT.OptimizerConfig(**OPT))
    opt.seen = []
    state = TT.TrainState.create(blocks_from_numpy(npp, RULES, mesh, "cpu"), opt, Layout(RULES, mesh))
    step = TT.make_train_step(functools.partial(mixtral.loss_fn, cfg=CFG, mesh=mesh), opt, group=mesh.group)
    log = []
    for b in batches:
        state, m = step(state, rows_of({"tokens": b}, mesh))
        log.append({k: float(m[k]) for k in KEYS})
    return log, [seen["layers/router"] for seen in opt.seen], state
"""

# the gang of 4: fsdp 2 x model 2 from the seeded weights and a sharded save of
# step 3; then data 2 x model 2 on packed rows: the router losses
_GANG4 = """
inp, out, ckpt = sys.argv[1:4]
data = torch.load(inp, weights_only=False)
init_distributed(torch.device("cpu"))
mesh = MeshSpec(fsdp=2, model=2).build("cpu")
res = {"where": placement(mesh)}
log, router, state = train(mesh, data["npp"], data["batches"])
res.update(log=log, router=router, blocks=blocks(state),
           bytes={"params": TT.tree_bytes(state.params), "mu": TT.tree_bytes(state.opt_state["mu"]),
                  "nu": TT.tree_bytes(state.opt_state["nu"])})
mgr = CheckpointManager(ckpt, group=mesh.gang)
mgr.save(STEPS, state.state_dict())
mgr.close()
mesh2 = MeshSpec(data=2, model=2).build("cpu")
params = blocks_from_numpy(data["npp"], RULES, mesh2, "cpu")
_, aux = mixtral.loss_fn(params, rows_of(data["packed"], mesh2), CFG, mesh2, group=mesh2.group)
res["packed"] = {k: float(aux[k]) for k in ("moe_balance_loss", "moe_z_loss")}
res["packed_group"] = dist.get_process_group_ranks(mesh2.group)
shutdown_distributed()
torch.save(res, out)
"""

# the gang of 2: model 2 from the seeded weights; then the gang of 4's step 3
# restored onto fsdp 2
_GANG2 = """
inp, out, ckpt = sys.argv[1:4]
data = torch.load(inp, weights_only=False)
init_distributed(torch.device("cpu"))
mesh = MeshSpec(model=2).build("cpu")
res = {"where": placement(mesh)}
log, router, state = train(mesh, data["npp"], data["batches"])
res.update(log=log, router=router, blocks=blocks(state))
deadline = time.time() + 200
while not os.path.isdir(os.path.join(ckpt, str(STEPS))) and time.time() < deadline:
    time.sleep(0.2)
mesh2 = MeshSpec.auto().build("cpu")
opt = TT.OptimizerConfig(**OPT).build()
init = functools.partial(mixtral.init, torch.Generator().manual_seed(1), CFG, "cpu")  # not the saved values
st, _, start = restore_or_init(ckpt, lambda: TT.sharded_init(init, RULES, mesh2, opt), TT.TrainState.load,
                               group=mesh2.gang)
res["fsdp2"] = {"start": start, "step": st.step, "count": st.opt_state["count"], "blocks": blocks(st),
                "where": placement(mesh2)}
shutdown_distributed()
torch.save(res, out)
"""

# the gang of 8: data 2 x fsdp 2 x model 2, the slot groups of accum_steps 2
_GANG8 = """
out = sys.argv[1]
init_distributed(torch.device("cpu"))
mesh = MeshSpec(data=2, fsdp=2, model=2).build("cpu")
world = dist.get_world_size(mesh.group)
_, slots = TT.gang_slots(2, world)
group = TT._microbatch_group(mesh.group, slots, dist.get_rank(mesh.group) * slots // world)
x = torch.tensor([float(1 << dist.get_rank())])
dist.all_reduce(x, group=group)
torch.save({"line": dist.get_process_group_ranks(mesh.group), "slot": dist.get_process_group_ranks(group),
            "sum": int(x.item())}, out)
shutdown_distributed()
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
            [sys.executable, "-c", f"STEPS = {STEPS}\n" + _COMMON + script, *[a.format(rank=rank) for a in args]],
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


def _jax_sharded_run(npp, batches, spec):
    """JAX's ``sharded_init`` + ``make_train_step`` of the tiny f32 Mixtral
    from ``npp`` on ``spec`` over as many of the 8 virtual devices: each
    step's metrics and the final parameters."""
    mesh = spec.build(devices=jax.devices()[:int(np.prod(list(spec.axis_sizes.values())))])
    opt = JT.OptimizerConfig(**OPT).build()
    state = JT.sharded_init(lambda: jax.tree.map(jnp.asarray, npp), JM.sharding_rules(JCFG), mesh, opt)
    step = JT.make_train_step(functools.partial(JM.loss_fn, cfg=JCFG, mesh=mesh), opt)
    out = []
    for b in batches:
        state, m = step(state, {"tokens": jnp.asarray(b)})
        out.append({k: float(m[k]) for k in KEYS})
    return out, jax.tree.map(np.asarray, state.params)


def _jax_references(npp, batches, packed):
    """JAX's runs on both meshes, the router's gradient of the first step's
    global loss, and the router losses of the packed batch as one global
    batch; each compiles apart, so the four run on threads of their own."""
    params = jax.tree.map(jnp.asarray, npp)

    def router_grad():
        grads = jax.jit(jax.grad(lambda p, b: JM.loss_fn(p, {"tokens": b}, JCFG)[0]))(
            params, jnp.asarray(batches[0]))
        return np.asarray(grads["layers"]["router"])

    def packed_losses():
        _, aux = jax.jit(lambda p, b: JM.loss_fn(p, b, JCFG))(params, {k: jnp.asarray(v) for k, v in packed.items()})
        return {k: float(aux[k]) for k in ("moe_balance_loss", "moe_z_loss")}

    jobs = {"fsdp2_model2": lambda: _jax_sharded_run(npp, batches, JMeshSpec(fsdp=2, model=2)),
            "model2": lambda: _jax_sharded_run(npp, batches, JMeshSpec(model=2)),
            "router_grad": router_grad, "packed": packed_losses}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def _seeded_weights(seed: int) -> dict:
    """The tiny f32 Mixtral's weights as a numpy tree, drawn by the port's
    seeded init (JAX's init would compile its draws first, seconds on this
    path), handed to JAX and to the port alike."""
    tree = TM.init(torch.Generator().manual_seed(seed), TCFG, "cpu")
    return {k: {n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _block(whole: torch.Tensor, where: dict, name: str) -> torch.Tensor:
    """The block of ``whole`` that the rank placed at ``where`` holds: its
    fsdp block, then the model block of that."""
    fd, md = where["dims"][name]
    out = whole
    if fd is not None:
        out = out.chunk(where["fsdp"], fd)[where["fi"]]
    if md is not None:
        out = out.chunk(where["model"], md)[where["mi"]]
    return out


def _rel(got, want) -> float:
    got, want = torch.as_tensor(np.asarray(got)).double(), torch.as_tensor(np.asarray(want)).double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """The gangs of 4, 2 and 8, started together, beside JAX's references on
    the same weights and batches and the one-process restore of the gang of
    4's step."""
    d = tmp_path_factory.mktemp("tp_mixtral")
    npp = _seeded_weights(3)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, JCFG.vocab_size, (B, T + 1)) for _ in range(STEPS)]
    packed = {"tokens": rng.integers(0, JCFG.vocab_size, (B, T + 1)),
              "segment_ids": np.array([sum(([s] * n for s, n in row), []) for row in PACKED])}
    torch.save({"npp": npp, "batches": [torch.from_numpy(b) for b in batches],
                "packed": {k: torch.from_numpy(v) for k, v in packed.items()}}, d / "in.pt")
    ckpt = d / "ckpt"
    finish4 = _start(_GANG4, 4, [str(d / "in.pt"), str(d / "r4_{rank}.pt"), str(ckpt)])
    finish2 = _start(_GANG2, 2, [str(d / "in.pt"), str(d / "r2_{rank}.pt"), str(ckpt)])
    finish8 = _start(_GANG8, 8, [str(d / "r8_{rank}.pt")])
    jax_runs = _one_thread(lambda: _jax_references(npp, batches, packed))
    finish8()
    finish4()
    finish2()
    whole_step = TC.restore_or_init(str(ckpt), lambda: TT.TrainState.create(
        TM.init(torch.Generator().manual_seed(1), TCFG, "cpu"), TT.OptimizerConfig(**OPT).build()),
        TT.TrainState.load)
    return {"fsdp2_model2": [torch.load(d / f"r4_{r}.pt", weights_only=False) for r in range(4)],
            "model2": [torch.load(d / f"r2_{r}.pt", weights_only=False) for r in range(2)],
            "slots": [torch.load(d / f"r8_{r}.pt", weights_only=False) for r in range(8)],
            "jax": jax_runs, "ckpt": ckpt, "one": whole_step}


@pytest.mark.parametrize("gang", ["fsdp2_model2", "model2"])
def test_mixtral_on_the_model_axis_matches_jaxs_sharded_step(gangs, gang):
    """The loss, CE, balance and z losses and the grad norm within 1e-5
    relative of JAX's on the same mesh, each step, on every rank (the clip
    active; the CE is a rank's own rows', their mean over the data × fsdp
    ranks JAX's); each rank's blocks of the updated parameters within 1e-4
    relative of the same blocks of JAX's."""
    want, jparams = gangs["jax"][gang]
    ranks = gangs[gang]
    assert min(x["grad_norm"] for x in want) > OPT["grad_clip"]
    model = ranks[0]["where"]["model"]
    for res in ranks:
        for step, (got, exp) in enumerate(zip(res["log"], want, strict=True)):
            ce = np.mean([r["log"][step]["ce_loss"] for r in ranks[res["where"]["mi"]::model]])
            for k in KEYS:
                value = ce if k == "ce_loss" else got[k]
                assert abs(value - exp[k]) <= 1e-5 * abs(exp[k]), (gang, step, k, value, exp[k])
        for name, p in _leaves(jparams):
            got = res["blocks"]["params"][name]
            assert _rel(got, _block(torch.from_numpy(np.array(p)), res["where"], name)) < 1e-4, name


@pytest.mark.parametrize("gang", ["fsdp2_model2", "model2"])
def test_the_routers_gradient_is_the_same_bits_on_a_model_line_and_jaxs(gangs, gang):
    """The router is whole on every rank: its gradient (after the gang's
    reduction, before the clip) is the same bits on the two ranks of each
    model line at every step, and at the first step within 1e-5 relative of
    JAX's gradient of the global batch's loss. Counted once: gates whose
    gradient skips the line's sum, or a ``copy_to_model`` before the router,
    would make it a partial or tp times too large."""
    ranks = gangs[gang]
    model = ranks[0]["where"]["model"]
    for a in range(0, len(ranks), model):
        for step in range(STEPS):
            assert torch.equal(ranks[a]["router"][step], ranks[a + 1]["router"][step]), (a, step)
    for res in ranks:
        assert _rel(res["router"][0], gangs["jax"]["router_grad"]) <= 1e-5


def test_each_rank_holds_a_quarter_of_every_expert_leaf(gangs):
    """fsdp 2 × model 2: each expert leaf ``[L, E, D, F]`` (``[L, E, F, D]``
    for ``we_down``) is split on D over fsdp and F over model, and a rank
    holds ``numel / 4`` of it and of its moments, exactly; the router and
    the norms are whole; a rank's bytes are their sum."""
    ranks = gangs["fsdp2_model2"]
    _, jparams = gangs["jax"]["fsdp2_model2"]
    whole = {n: p.size * 4 for n, p in _leaves(jparams)}
    for res in ranks:
        dims = res["where"]["dims"]
        assert dims["layers/we_gate"] == dims["layers/we_up"] == (2, 3) and dims["layers/we_down"] == (3, 2)
        assert dims["layers/router"] == (None, None)
        both = {n for n, (fd, md) in dims.items() if fd is not None and md is not None}
        assert both == set(whole) - {"layers/attn_norm", "layers/mlp_norm", "final_norm", "layers/router"}
        want = sum(whole[n] // 4 if n in both else whole[n] for n in whole)
        for part in ("params", "mu", "nu"):
            assert res["bytes"][part] == want, part
            for n, t in res["blocks"][part].items():
                assert t.numel() * 4 * (4 if n in both else 1) == whole[n], (part, n)


def test_a_fsdp2_model2_mixtral_step_restores_onto_one_process_and_onto_fsdp2(gangs):
    """The gang of 4's step 3 (each rank its blocks through DCP, the expert
    leaves split on two dims) read back whole in one process and onto a
    gang of 2 on ``fsdp 2``: params and both moments bit for bit, with the
    step and the count."""
    whole = TC.read_whole(str(gangs["ckpt"] / str(STEPS)))
    assert whole["step"] == STEPS and whole["opt_state"]["count"] == STEPS
    trees = {"params": whole["params"], "mu": whole["opt_state"]["mu"], "nu": whole["opt_state"]["nu"]}
    for res in gangs["fsdp2_model2"]:
        for part, tree in trees.items():
            for name, t in _leaves(tree):
                assert torch.equal(res["blocks"][part][name], _block(t, res["where"], name)), (part, name)
    state, _, start = gangs["one"]
    assert start == STEPS and state.step == STEPS and state.opt_state["count"] == STEPS
    for name, t in _leaves(state.params):
        assert torch.equal(t.detach(), dict(_leaves(whole["params"]))[name]), name
    for res in gangs["model2"]:
        got = res["fsdp2"]
        assert (got["start"], got["step"], got["count"]) == (STEPS, STEPS, STEPS)
        assert got["where"]["fsdp"] == 2 and got["where"]["model"] == 1
        for part, tree in trees.items():
            for name, t in _leaves(tree):
                assert torch.equal(got["blocks"][part][name], _block(t, got["where"], name)), (part, name)


def test_router_losses_on_data2_model2_are_jaxs_over_the_whole_packed_batch(gangs):
    """``data 2 × model 2`` on packed rows with padding (the data ranks'
    halves route unequal counts): each rank's balance and z losses are
    JAX's over the whole batch within 1e-5 relative, pooled over the data
    ranks of its model index (``Mesh.group``), not the world."""
    want = gangs["jax"]["packed"]
    for r, res in enumerate(gangs["fsdp2_model2"]):
        assert res["packed_group"] == [r % 2, r % 2 + 2]
        for k, v in want.items():
            assert abs(res["packed"][k] - v) <= 1e-5 * abs(v), (r, k, res["packed"][k], v)


def test_every_rank_makes_every_model_lines_slot_groups(gangs):
    """``data 2 × fsdp 2 × model 2`` with ``accum_steps`` 2: rank r's
    ``Mesh.group`` is its model line's data × fsdp ranks (r % 2, r % 2 + 2,
    ...), and its microbatch slot the half of them that holds its rows, a
    subgroup made by every rank for every line: an all-reduce of ``2^rank``
    over it sums exactly its members."""
    for r, res in enumerate(gangs["slots"]):
        line = list(range(r % 2, 8, 2))
        assert res["line"] == line
        slot = line[:2] if r in line[:2] else line[2:]
        assert res["slot"] == slot and res["sum"] == sum(1 << m for m in slot), (r, res)


# -- the TP engine ----------------------------------------------------------------------


def _serving_params():
    npp = _seeded_weights(0)
    return npp, params_from_numpy(npp, "cpu")


def _run(eng, prompts, n=6, **kw):
    rids = [eng.submit(p, max_new_tokens=n, **kw) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


PROMPTS = [[1, 2, 3, 4], [7, 8], [(5 * i + 3) % 256 for i in range(29)]]


def test_tp2_mixtral_engine_gives_jaxs_tp_engines_greedy_tokens_and_tp1s():
    """The tp=2 Mixtral engine, both shards on the CPU, against JAX's
    ``ContinuousBatcher`` on ``MeshSpec(model=2)`` over 2 virtual devices
    and the port's tp=1 engine, on the same f32 weights: the same greedy
    tokens, the 29-token prompt's prefill through ``moe_ffn``. Each shard
    holds ``F/2`` columns of every expert, contiguous, the whole router,
    and a cache of ``Hkv/2`` heads."""
    npp, params = _serving_params()
    mesh = JMeshSpec(model=2).build(devices=jax.devices()[:2])
    jeng = JS.ContinuousBatcher(jax.tree.map(jnp.asarray, npp), JCFG, num_slots=2, max_len=64, decode_chunk=4,
                                mesh=mesh)
    want = _run(jeng, PROMPTS)
    eng = ContinuousBatcher(params, TCFG, num_slots=2, max_len=64, decode_chunk=4, tp=2)
    F = TCFG.d_ff // 2
    for tree in eng.params.trees:
        lp = tree["layers"]
        assert lp["we_gate"].shape[-1] == lp["we_up"].shape[-1] == lp["we_down"].shape[-2] == F
        assert all(lp[k].is_contiguous() for k in ("we_gate", "we_up", "we_down"))
        assert lp["router"] is params["layers"]["router"]
    assert sum(t["layers"]["we_gate"].numel() for t in eng.params.trees) == params["layers"]["we_gate"].numel()
    assert [k.shape[2] for k in eng.cache.k] == [TCFG.n_kv_heads // 2] * 2
    assert _run(eng, PROMPTS) == want
    one = ContinuousBatcher(params, TCFG, num_slots=2, max_len=64, decode_chunk=4)
    assert _run(one, PROMPTS) == want


@pytest.fixture(scope="module")
def hf_mixtral_dir(tmp_path_factory):
    """A tiny Mixtral checkpoint directory: ``config.json`` from
    transformers' ``MixtralConfig`` and ``pytorch_model.bin`` holding a
    seeded tree under HF's names in HF's ``[out, in]`` layout (the
    modelling classes, seconds to import, are not needed)."""
    use_tf = os.environ.get("USE_TF")
    os.environ["USE_TF"] = "0"  # leave TensorFlow out of transformers' import
    try:
        transformers = pytest.importorskip("transformers")
    finally:
        if use_tf is None:
            del os.environ["USE_TF"]
        else:
            os.environ["USE_TF"] = use_tf
    d = tmp_path_factory.mktemp("hf_mixtral")
    transformers.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=1e6,
        num_local_experts=4, num_experts_per_tok=2, torch_dtype="float32").save_pretrained(d)
    params = TM.init(torch.Generator().manual_seed(7), TCFG, "cpu")
    lp = params["layers"]
    sd = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"],
          "lm_head.weight": params["lm_head"].T}
    for i in range(TCFG.n_layers):
        pre = f"model.layers.{i}."
        sd.update({pre + "input_layernorm.weight": lp["attn_norm"][i],
                   pre + "post_attention_layernorm.weight": lp["mlp_norm"][i],
                   pre + "block_sparse_moe.gate.weight": lp["router"][i].T})
        for name, key in (("q_proj", "wq"), ("k_proj", "wk"), ("v_proj", "wv"), ("o_proj", "wo")):
            sd[pre + f"self_attn.{name}.weight"] = lp[key][i].T
        for e in range(TCFG.num_experts):
            for w, key in (("w1", "we_gate"), ("w3", "we_up"), ("w2", "we_down")):
                sd[pre + f"block_sparse_moe.experts.{e}.{w}.weight"] = lp[key][i, e].T
    torch.save({k: v.contiguous() for k, v in sd.items()}, d / "pytorch_model.bin")
    return d


@pytest.mark.parametrize("source", ["preset", "hf"])
def test_serving_http_tp2_serves_mixtral_with_tp1s_tokens(hf_mixtral_dir, source):
    """``serving_http --tp 2`` on a Mixtral preset (``mixtral-tiny``, seeded)
    and on an HF Mixtral directory: two shards on the CPU, dense kv, the
    greedy tokens of ``--tp 1`` on the same weights."""
    args = ["--preset", "mixtral-tiny"] if source == "preset" else ["--hf", str(hf_mixtral_dir)]
    common = [*args, "--device", "cpu", "--slots", "2", "--max-len", "64", "--decode-chunk", "4", "--kv", "dense"]
    tp2 = TH.build_engine(TH.parse_args([*common, "--tp", "2"]))
    assert isinstance(tp2.cfg, TM.MixtralConfig) and tp2.tp == 2 and len(tp2.cache.k) == 2
    tp1 = TH.build_engine(TH.parse_args(common))
    assert _run(tp2, PROMPTS) == _run(tp1, PROMPTS)
