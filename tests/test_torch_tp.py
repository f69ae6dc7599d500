"""The model axis on the CPU: Megatron's tensor parallelism for Llama in gloo
gangs of the port against JAX's sharded step, the vocab-parallel embedding
and cross-entropy, the sharded checkpoints across the axes, and the TP
serving engine against JAX's. Every gang runs its ranks with
``OMP_NUM_THREADS=1``, in f32; the two gangs run at once, beside JAX's
runs in this process.

- A gang of 4 on ``fsdp 2 × model 2`` and a gang of 2 on ``model 2`` train
  the tiny Llama 3 steps from weights JAX drew (bridged by
  ``models/convert.py``), against JAX's ``sharded_init`` +
  ``make_train_step`` on the same meshes over 4 and 2 of the 8 virtual CPU
  devices, with the clip active: losses and grad norms within 1e-5
  relative, each rank's blocks of the updated parameters within 1e-4
  relative of the same blocks of JAX's (``test_torch_fsdp.py``'s bounds).
- Each rank holds ``1/(fsdp·model)`` of a leaf split on both axes; the
  sharded init is the one-process init's blocks bit for bit; the norms'
  gradients are the same bits on the ranks of a model line (checked, not
  assumed); the gang of 4's step 3 restores bit for bit onto one process
  and onto a gang of 2 on ``fsdp 2``.
- On the gang of 2: the vocab-parallel embedding and CE (chunked and not)
  equal the whole-table forms in value and gradient, and the embedding
  JAX's one-hot ``embed_lookup`` on a two-axis mesh; ``copy_to_model`` and
  ``reduce_from_model`` give exact values and gradients, and a copy of the
  reduce with a ``psum`` backward (a mutant, defined here only) multiplies
  the upstream gradient by the axis's size; remat "full" replays the
  collectives to the same loss and gradients.
- ``run_lm_training`` with ``model_axis=2`` on a ``--data_dir``: the two
  ranks of a model line read the same rows, the rows of data × fsdp index
  k are rows k of the one-process stream's global batch, and a resume
  reads on from the checkpointed batch (exactly once).
- The TP engine (``ContinuousBatcher(tp=2)``, both shards on the CPU)
  gives JAX's TP engine's greedy tokens and the tp=1 engine's; per-request
  sampling and streaming ride it; it refuses what JAX's refuses, and int8.
"""

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

from tony_tpu.models import llama as JL  # noqa: E402
from tony_tpu.models import serving as JS  # noqa: E402
from tony_tpu.parallel.mesh import MeshSpec as JMeshSpec  # noqa: E402
from tony_tpu.train import trainer as JT  # noqa: E402
from tony_tpu_torch.data import dataset as TD  # noqa: E402
from tony_tpu_torch.data.native import TokenLoader  # noqa: E402
from tony_tpu_torch.models import llama as TL  # noqa: E402
from tony_tpu_torch.models import serving_http as TH  # noqa: E402
from tony_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from tony_tpu_torch.models.serving import ContinuousBatcher  # noqa: E402
from tony_tpu_torch.train import checkpoint as TC  # noqa: E402
from tony_tpu_torch.train import trainer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=3, grad_clip=0.5)
B, T, STEPS = 8, 32, 3
JCFG = dataclasses.replace(JL.LLAMA_TINY, dtype="float32")
TCFG = dataclasses.replace(TL.LLAMA_TINY, dtype="float32")

# shared by both gangs: the recording optimizer, a trained run from JAX's
# weights, and where a rank's blocks sit
_COMMON = """
import dataclasses, functools, os, sys, time, torch
import torch.distributed as dist
from pathlib import Path
from tony_tpu_torch.models import llama
from tony_tpu_torch.models.convert import blocks_from_numpy
from tony_tpu_torch.ops import layers as L
from tony_tpu_torch.parallel import collectives as C
from tony_tpu_torch.parallel.mesh import MeshSpec, model_group
from tony_tpu_torch.parallel.sharding import Layout
from tony_tpu_torch.runtime import init_distributed, shutdown_distributed
from tony_tpu_torch.train import trainer as TT
from tony_tpu_torch.train.checkpoint import CheckpointManager, restore_or_init

CFG = dataclasses.replace(llama.LLAMA_TINY, dtype="float32")
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=3, grad_clip=0.5)
B, T = 8, 32
RULES = llama.sharding_rules(CFG)


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
    names = [n for n, _ in TT._leaves(llama.init(torch.Generator().manual_seed(1), CFG, "cpu"))]
    return {**{a: mesh.shape[a] for a in ("data", "fsdp", "model")},
            **{a[0] + "i": mesh.axis_index(a) for a in ("data", "fsdp", "model")},
            "dims": {n: (layout.dim(n), layout.model_dim(n)) for n in names},
            "model_ranks": dist.get_process_group_ranks(model_group(mesh)),
            "group_ranks": dist.get_process_group_ranks(mesh.group)}


def train(mesh, npp, batches, cfg=CFG):
    # 3 steps from JAX's weights (numpy) on this rank's rows (those of its
    # data x fsdp index): the metrics, the whole leaves' gradients, the state
    opt = Recording(TT.OptimizerConfig(**OPT))
    opt.seen = []
    layout = Layout(RULES, mesh)
    state = TT.TrainState.create(blocks_from_numpy(npp, RULES, mesh, "cpu"), opt, layout)
    step = TT.make_train_step(functools.partial(llama.loss_fn, cfg=cfg, mesh=mesh), opt, group=mesh.group)
    rows = B // (mesh.shape["data"] * mesh.shape["fsdp"])
    k = dist.get_rank() // mesh.shape["model"]
    log = []
    for b in batches:
        state, m = step(state, {"tokens": b[k * rows:(k + 1) * rows]})
        log.append((float(m["loss"]), float(m["grad_norm"])))
    whole_grads = [{n: g for n, g in seen.items() if not layout.split(n)} for seen in opt.seen]
    return log, whole_grads, state


def rows_run(data_dir, ckpt, ports):
    # run_lm_training on the model axis over a data dir, 2 steps saved each,
    # then resumed to step 3: the tokens each step's loss saw
    from tony_tpu_torch.train import loop
    seen, real = {}, llama.loss_fn

    def recording(params, batch, cfg, mesh=None):
        seen.setdefault(len(seen), batch["tokens"].clone())
        return real(params, batch, cfg, mesh)

    llama.loss_fn = recording
    try:
        for steps, port in zip((2, 3), ports):
            os.environ["MASTER_PORT"] = port
            loop.run_lm_training(llama, CFG, loop.LoopConfig(
                device="cpu", steps=steps, batch_size=B, seq_len=T, log_every=1, warmup_steps=1,
                checkpoint_dir=ckpt, checkpoint_every=1, model_axis=2, data_dir=data_dir,
                prefetch_depth=0))
    finally:
        llama.loss_fn = real
    return seen
"""

# the gang of 4: fsdp 2 x model 2 from JAX's weights, the sharded init, a
# sharded save of step 3, then the rows of run_lm_training on the data dir
_GANG4 = """
inp, out, ckpt, data_dir, rows_ckpt, p1, p2 = sys.argv[1:8]
data = torch.load(inp, weights_only=False)
init_distributed(torch.device("cpu"))
mesh = MeshSpec(fsdp=2, model=2).build("cpu")
res = {"auto": MeshSpec.auto(model=2).axis_sizes, "where": placement(mesh)}
log, whole_grads, state = train(mesh, data["npp"], data["batches"])
res.update(log=log, whole_grads=whole_grads, blocks=blocks(state),
           bytes={"params": TT.tree_bytes(state.params), "mu": TT.tree_bytes(state.opt_state["mu"]),
                  "nu": TT.tree_bytes(state.opt_state["nu"])})
opt = TT.OptimizerConfig(**OPT).build()
init = functools.partial(llama.init, torch.Generator().manual_seed(0), CFG, "cpu")
res["init"] = blocks(TT.sharded_init(init, RULES, mesh, opt))["params"]
mgr = CheckpointManager(ckpt, group=mesh.gang)
mgr.save(STEPS, state.state_dict())
mgr.close()
shutdown_distributed()
res["rows"] = rows_run(data_dir, rows_ckpt, (p1, p2))
torch.save(res, out)
"""

# the gang of 2: model 2 from JAX's weights; the model line's pieces (the
# Megatron pair and its mutant, the vocab-parallel embedding and CE, remat);
# then the gang of 4's step restored onto fsdp 2
_GANG2 = """
inp, out, ckpt = sys.argv[1:4]
data = torch.load(inp, weights_only=False)
init_distributed(torch.device("cpu"))
rank = dist.get_rank()
mesh = MeshSpec(model=2).build("cpu")
group = model_group(mesh)
res = {"where": placement(mesh)}
log, whole_grads, state = train(mesh, data["npp"], data["batches"])
res.update(log=log, whole_grads=whole_grads, blocks=blocks(state))

# remat "full" replays the block's collectives: the same loss and gradients
batch = {"tokens": data["batches"][0][:2]}
leaves = [p for _, p in TT._leaves(state.params)]
res["remat"] = []
for remat in (False, True):
    loss, _ = llama.loss_fn(state.params, batch, dataclasses.replace(CFG, remat=remat), mesh)
    res["remat"].append((loss.detach(), [g.detach() for g in torch.autograd.grad(loss, leaves)]))

# the Megatron pair on x_r = base * (r + 1), upstream w (the same on both ranks)
base = torch.arange(12.0).reshape(4, 3)
w = torch.arange(1.0, 13.0).reshape(4, 3)
x = (base * (rank + 1)).requires_grad_()
pair = {}
for name, fn in (("copy", C.copy_to_model), ("reduce", C.reduce_from_model)):
    y = fn(x, group)
    pair[name] = (y.detach(), torch.autograd.grad((w * y).sum(), x)[0])


class PsumBackwardReduce(torch.autograd.Function):  # the mutant: a psum backward at a row-parallel output
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return C._psum_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return C._psum_f32(g, ctx.group), None


y = PsumBackwardReduce.apply(x, group)
pair["mutant"] = (y.detach(), torch.autograd.grad((w * y).sum(), x)[0])
res["pair"] = pair

# the vocab-parallel embedding and CE against the whole-table forms
gen = torch.Generator().manual_seed(7)
E = torch.randn(CFG.vocab_size, CFG.d_model, generator=gen)
head = torch.randn(CFG.d_model, CFG.vocab_size, generator=gen) * 0.1
xs = torch.randn(2, 9, CFG.d_model, generator=gen)
tok = torch.randint(0, CFG.vocab_size, (2, 9), generator=gen)
targets = tok.clone()
targets[0, :3] = -100
wy = torch.randn(2, 9, CFG.d_model, generator=gen)
mi = mesh.axis_index("model")
local = E.chunk(2, 0)[mi].clone().requires_grad_()
whole = E.clone().requires_grad_()
yl, yw = llama.embed_lookup(local, tok, mesh), llama.embed_lookup(whole, tok)
res["embed"] = {"tokens": tok, "table": E, "got": yl.detach(), "want": yw.detach(),
                "grad": torch.autograd.grad((wy * yl).sum(), local)[0],
                "want_grad": torch.autograd.grad((wy * yw).sum(), whole)[0].chunk(2, 0)[mi]}
res["ce"] = {}
for chunked in (True, False):
    got = []
    for tp in (True, False):
        xv = xs.clone().requires_grad_()
        hv = (head.chunk(2, 1)[mi] if tp else head).clone().requires_grad_()
        g = group if tp else None
        if chunked:
            loss, n = L.chunked_cross_entropy_loss(C.copy_to_model(xv, g), hv, targets, chunk=4, group=g)
        else:
            loss, n = L.cross_entropy_loss(C.copy_to_model(xv, g) @ hv, targets, group=g)
        gx, gh = torch.autograd.grad(loss, [xv, hv])
        got.append((loss.detach(), int(n), gx, gh if tp else gh.chunk(2, 1)[mi]))
    res["ce"][chunked] = got

# the gang of 4's step 3, restored onto fsdp 2
deadline = time.time() + 200
while not os.path.isdir(os.path.join(ckpt, str(len(data["batches"])))) and time.time() < deadline:
    time.sleep(0.2)
mesh2 = MeshSpec.auto().build("cpu")
opt = TT.OptimizerConfig(**OPT).build()
init = functools.partial(llama.init, torch.Generator().manual_seed(1), CFG, "cpu")  # not the saved values
st, _, start = restore_or_init(ckpt, lambda: TT.sharded_init(init, RULES, mesh2, opt), TT.TrainState.load,
                               group=mesh2.gang)
res["fsdp2"] = {"start": start, "step": st.step, "count": st.opt_state["count"], "blocks": blocks(st),
                "where": placement(mesh2)}
shutdown_distributed()
torch.save(res, out)
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
    """JAX's ``sharded_init`` + ``make_train_step`` of the tiny f32 Llama
    from ``npp`` on ``spec`` over as many of the 8 virtual devices: each
    step's (loss, grad norm) and the final parameters."""
    mesh = spec.build(devices=jax.devices()[:int(np.prod(list(spec.axis_sizes.values())))])
    opt = JT.OptimizerConfig(**OPT).build()
    state = JT.sharded_init(lambda: jax.tree.map(jnp.asarray, npp), JL.sharding_rules(JCFG), mesh, opt)
    step = JT.make_train_step(functools.partial(JL.loss_fn, cfg=JCFG, mesh=mesh), opt)
    out = []
    for b in batches:
        state, m = step(state, {"tokens": jnp.asarray(b)})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, jax.tree.map(np.asarray, state.params)


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
    """Both gangs, started together, beside JAX's two sharded runs on the
    same weights and batches, the one-process data stream and the
    one-process restore of the gang of 4's step."""
    d = tmp_path_factory.mktemp("tp")
    npp = jax.tree.map(np.asarray, JL.init(jax.random.PRNGKey(3), JCFG))
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, JCFG.vocab_size, (B, T + 1)) for _ in range(STEPS)]
    torch.save({"npp": npp, "batches": [torch.from_numpy(b) for b in batches]}, d / "in.pt")
    data_dir = d / "data"
    data_dir.mkdir()
    for i in range(2):
        TD.write_token_shard(data_dir / f"s{i}.tonytok", rng.integers(0, JCFG.vocab_size, 3000))
    ckpt = d / "ckpt"
    finish4 = _start(_GANG4, 4, [str(d / "in.pt"), str(d / "r4_{rank}.pt"), str(ckpt), str(data_dir),
                                 str(d / "rows_ckpt"), str(_free_port()), str(_free_port())])
    finish2 = _start(_GANG2, 2, [str(d / "in.pt"), str(d / "r2_{rank}.pt"), str(ckpt)])
    jax_runs = _one_thread(lambda: {
        "fsdp2_model2": _jax_sharded_run(npp, batches, JMeshSpec(fsdp=2, model=2)),
        "model2": _jax_sharded_run(npp, batches, JMeshSpec(model=2))})
    loader = TokenLoader(sorted(data_dir.glob("*.tonytok")), B, T, seed=0)
    stream = [loader.next() for _ in range(3)]
    loader.close()
    finish4()
    finish2()
    whole_step = TC.restore_or_init(str(ckpt), lambda: TT.TrainState.create(
        TL.init(torch.Generator().manual_seed(1), TCFG, "cpu"), TT.OptimizerConfig(**OPT).build()),
        TT.TrainState.load)
    return {"fsdp2_model2": [torch.load(d / f"r4_{r}.pt", weights_only=False) for r in range(4)],
            "model2": [torch.load(d / f"r2_{r}.pt", weights_only=False) for r in range(2)],
            "jax": jax_runs, "stream": stream, "ckpt": ckpt, "one": whole_step}


@pytest.mark.parametrize("gang", ["fsdp2_model2", "model2"])
def test_llama_on_the_model_axis_matches_jaxs_sharded_step(gangs, gang):
    """Losses and grad norms within 1e-5 relative of JAX's on the same mesh,
    each step, on every rank (the clip active); each rank's blocks of the
    updated parameters within 1e-4 relative of the same blocks of JAX's."""
    want, jparams = gangs["jax"][gang]
    assert min(g for _, g in want) > OPT["grad_clip"]
    for res in gangs[gang]:
        for (tl, tg), (jl, jg) in zip(res["log"], want, strict=True):
            assert abs(tl - jl) <= 1e-5 * abs(jl) and abs(tg - jg) <= 1e-5 * abs(jg), (res["log"], want)
        for name, p in _leaves(jparams):
            got = res["blocks"]["params"][name]
            assert _rel(got, _block(torch.from_numpy(np.array(p)), res["where"], name)) < 1e-4, name


@pytest.mark.parametrize("gang", ["fsdp2_model2", "model2"])
def test_the_gang_lays_model_fastest_and_the_norms_gradients_agree_on_a_model_line(gangs, gang):
    """Rank r sits at model index r % model and data × fsdp index r //
    model; ``Mesh.group`` is the data × fsdp ranks of its model index and
    ``model_group`` its model line. The leaves the rules keep whole (the
    norms) get the same gradient bits on both ranks of a model line at
    every step: Megatron's ``copy_to_model`` summed the activations'
    gradients before them."""
    ranks = gangs[gang]
    model = ranks[0]["where"]["model"]
    for r, res in enumerate(ranks):
        where = res["where"]
        assert (where["mi"], where["fi"]) == (r % model, r // model % where["fsdp"])
        assert where["model_ranks"] == [r - r % model + m for m in range(model)]
        assert where["group_ranks"] == list(range(r % model, len(ranks), model))
    assert set(ranks[0]["whole_grads"][0]) == {"layers/attn_norm", "layers/mlp_norm", "final_norm"}
    for a in range(0, len(ranks), model):
        for step, grads in enumerate(ranks[a]["whole_grads"]):
            for name, g in grads.items():
                assert torch.equal(g, ranks[a + 1]["whole_grads"][step][name]), (a, step, name)


def test_each_rank_holds_a_quarter_of_the_leaves_split_on_both_axes(gangs):
    """fsdp 2 × model 2: every leaf but the norms is split on both axes, and a
    rank holds ``numel / 4`` of it and of its moments, exactly; its bytes are
    their sum plus the whole norms, as the loop's step report counts them."""
    ranks = gangs["fsdp2_model2"]
    _, jparams = gangs["jax"]["fsdp2_model2"]
    whole = {n: p.size * 4 for n, p in _leaves(jparams)}
    assert ranks[0]["auto"]["fsdp"] == 2 and ranks[0]["auto"]["model"] == 2
    for res in ranks:
        dims = res["where"]["dims"]
        both = {n for n, (fd, md) in dims.items() if fd is not None and md is not None}
        assert both == set(whole) - {"layers/attn_norm", "layers/mlp_norm", "final_norm"}
        assert dims["embed"] == (1, 0) and dims["lm_head"] == (0, 1) and dims["layers/wq"] == (1, 2)
        assert dims["layers/wo"] == (2, 1)
        want = sum(whole[n] // 4 if n in both else whole[n] for n in whole)
        for part in ("params", "mu", "nu"):
            assert res["bytes"][part] == want, part
            for n, t in res["blocks"][part].items():
                assert t.numel() * 4 * (4 if n in both else 1) == whole[n], (part, n)


def test_sharded_init_is_the_one_process_init_sliced(gangs):
    """Each rank's blocks of ``sharded_init`` on fsdp 2 × model 2 are those
    of the one-process init, bit for bit."""
    init = dict(_leaves(TL.init(torch.Generator().manual_seed(0), TCFG, "cpu")))
    for res in gangs["fsdp2_model2"]:
        for name, t in init.items():
            assert torch.equal(res["init"][name], _block(t, res["where"], name)), name


def test_a_fsdp2_model2_step_restores_onto_one_process_and_onto_fsdp2(gangs):
    """The gang of 4's step 3 (each rank its blocks through DCP) read back
    whole in one process (``read_whole`` and ``restore_or_init``) and onto a
    gang of 2 on ``fsdp 2``: params and both moments bit for bit, with the
    step and the count."""
    saved = gangs["fsdp2_model2"]
    whole = TC.read_whole(str(gangs["ckpt"] / str(STEPS)))
    assert whole["step"] == STEPS and whole["opt_state"]["count"] == STEPS
    trees = {"params": whole["params"], "mu": whole["opt_state"]["mu"], "nu": whole["opt_state"]["nu"]}
    for res in saved:
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


def test_vocab_parallel_embedding_equals_the_whole_table_and_jaxs_one_hot(gangs):
    """On model 2 each rank takes its rows and the line sums them: every
    rank has the whole table's rows exactly, its block of the table's
    gradient, and the value of JAX's ``embed_lookup`` on ``fsdp 2 × model
    2`` (two active axes: its one-hot product)."""
    mesh = JMeshSpec(fsdp=2, model=2).build(devices=jax.devices()[:4])
    for res in gangs["model2"]:
        e = res["embed"]
        assert torch.equal(e["got"], e["want"])
        assert float((e["grad"] - e["want_grad"]).abs().max()) <= 1e-6
        onehot = JL.embed_lookup(jnp.asarray(e["table"].numpy()), jnp.asarray(e["tokens"].numpy()), mesh)
        assert np.abs(np.asarray(onehot) - e["got"].numpy()).max() <= 1e-6


@pytest.mark.parametrize("chunked", [True, False])
def test_vocab_parallel_cross_entropy_equals_the_whole_vocabulary(gangs, chunked):
    """The loss over each rank's half of the head (max and exponentials
    summed over the line, the gold logit from its owner, ignored targets
    masked) equals the whole-vocabulary CE's within 1e-6 relative, the
    count exactly (3 targets ignored), and the gradients of the input and of
    the rank's head block within 1e-6 of the whole form's."""
    for res in gangs["model2"]:
        (tl, tn, tgx, tgh), (wl, wn, wgx, wgh) = res["ce"][chunked]
        assert tn == wn == 2 * 9 - 3
        assert abs(float(tl - wl)) <= 1e-6 * abs(float(wl))
        for got, want in ((tgx, wgx), (tgh, wgh)):
            assert float((got - want).abs().max()) <= 1e-6 * max(float(want.abs().max()), 1.0)


def test_the_megatron_pair_is_exact_and_a_psum_backward_reduce_scales_the_gradient(gangs):
    """``copy_to_model``: ``x`` forward, the line's sum of the upstream
    gradients backward; ``reduce_from_model``: the line's sum forward, the
    upstream gradient as it is backward, exactly. A reduce whose backward
    also sums (the mutant, defined only in the test's rank script) hands each
    rank ``tp`` times the upstream gradient."""
    base = torch.arange(12.0).reshape(4, 3)
    w = torch.arange(1.0, 13.0).reshape(4, 3)
    for rank, res in enumerate(gangs["model2"]):
        pair = res["pair"]
        assert torch.equal(pair["copy"][0], base * (rank + 1)) and torch.equal(pair["copy"][1], 2 * w)
        assert torch.equal(pair["reduce"][0], 3 * base) and torch.equal(pair["reduce"][1], w)
        assert torch.equal(pair["mutant"][0], 3 * base) and torch.equal(pair["mutant"][1], 2 * w)


def test_remat_replays_the_model_axis_collectives(gangs):
    """On model 2, remat "full" recomputes each block in the backward with
    its ``reduce_from_model`` again, in the same order on both ranks: the
    loss and every gradient are those without remat."""
    for res in gangs["model2"]:
        (l0, g0), (l1, g1) = res["remat"]
        assert torch.equal(l0, l1)
        for a, b in zip(g0, g1, strict=True):
            assert float((a - b).abs().max()) <= 1e-6 * max(float(b.abs().max()), 1.0)


def test_the_ranks_of_a_model_line_read_the_same_rows_once(gangs):
    """``run_lm_training(model_axis=2)`` in the gang of 4 (fsdp 2 × model 2)
    on a data dir, 2 steps then a resume to 3: at every step the two ranks
    of a model line read the same rows, data × fsdp index k reads rows k of
    the one-process stream's global batch, and the resumed run reads batch
    3 (no batch twice, none skipped)."""
    ranks, stream = gangs["fsdp2_model2"], gangs["stream"]
    rows = B // 2
    for r, res in enumerate(ranks):
        seen = res["rows"]
        assert sorted(seen) == [0, 1, 2], sorted(seen)
        k = r // 2
        for step in range(3):
            assert torch.equal(seen[step], ranks[r ^ 1]["rows"][step]), (r, step)
            assert np.array_equal(seen[step].numpy(), stream[step][k * rows:(k + 1) * rows]), (r, step)


# -- the TP engine ----------------------------------------------------------------------


def _serving_params():
    npp = jax.tree.map(np.asarray, JL.init(jax.random.PRNGKey(0), JCFG))
    return npp, params_from_numpy(npp, "cpu")


def _run(eng, prompts, n=6, **kw):
    rids = [eng.submit(p, max_new_tokens=n, **kw) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


def test_tp2_engine_gives_jaxs_tp_engines_greedy_tokens_and_tp1s():
    """The tp=2 engine, both shards on the CPU, against JAX's
    ``ContinuousBatcher`` on ``MeshSpec(model=2)`` over 2 virtual devices and
    the port's tp=1 engine, on the same f32 weights: the same greedy
    tokens. Its cache is two tensors of ``Hkv/2`` kv heads: TP, not a
    replicated copy."""
    npp, params = _serving_params()
    prompts = [[1, 2, 3, 4], [7, 8], [200, 13, 9, 9, 40]]
    mesh = JMeshSpec(model=2).build(devices=jax.devices()[:2])
    jeng = JS.ContinuousBatcher(jax.tree.map(jnp.asarray, npp), JCFG, num_slots=2, max_len=64, decode_chunk=4,
                                mesh=mesh)
    want = _run(jeng, prompts)
    eng = ContinuousBatcher(params, TCFG, num_slots=2, max_len=64, decode_chunk=4, tp=2)
    assert isinstance(eng.cache.k, list) and [k.shape[2] for k in eng.cache.k] == [TCFG.n_kv_heads // 2] * 2
    assert eng.attn == "bucketed"
    assert _run(eng, prompts) == want
    one = ContinuousBatcher(params, TCFG, num_slots=2, max_len=64, decode_chunk=4)
    assert _run(one, prompts) == want


def test_tp2_per_request_sampling_and_streaming():
    """The per-slot sampler and ``drain_stream`` ride the TP engine unchanged
    (JAX's test): the greedy request's tokens are the tp=1 engine's despite
    a sampled neighbour, the sampled one has its budget of in-vocabulary
    tokens, and the stream hands each request's tokens once."""
    _, params = _serving_params()
    eng = ContinuousBatcher(params, TCFG, num_slots=2, max_len=64, decode_chunk=4, tp=2,
                            generator=torch.Generator().manual_seed(0))
    g = eng.submit([1, 2, 3], max_new_tokens=6)
    s = eng.submit([4, 5], max_new_tokens=6, temperature=0.8, top_k=8)
    streamed: dict = {}
    while eng.step():
        for rid, (toks, _) in eng.drain_stream().items():
            streamed.setdefault(rid, []).extend(toks)
    for rid, (toks, _) in eng.drain_stream().items():
        streamed.setdefault(rid, []).extend(toks)
    out = dict(eng.done)
    ref = ContinuousBatcher(params, TCFG, num_slots=2, max_len=64, decode_chunk=4)
    assert out[g] == _run(ref, [[1, 2, 3]])[0]
    assert len(out[s]) == 6 and all(0 <= t < TCFG.vocab_size for t in out[s])
    assert streamed == out


def test_tp_rejects_paged_bad_heads_and_explicit_ragged():
    """JAX's refusals, in JAX's words: a paged cache ("dense"), heads that
    do not divide the axis ("divide"), an explicit ragged kernel; "auto" is
    "bucketed". The port's own: a vocabulary or FFN that does not split."""
    _, params = _serving_params()
    with pytest.raises(ValueError, match="dense"):
        ContinuousBatcher(params, TCFG, num_slots=1, max_len=64, kv="paged", page_len=32, tp=2)
    cfg3 = dataclasses.replace(TCFG, n_heads=3, n_kv_heads=3, d_model=48)
    with pytest.raises(ValueError, match="divide"):
        ContinuousBatcher(TL.init(torch.Generator().manual_seed(0), cfg3, "cpu"), cfg3, num_slots=1,
                          max_len=64, tp=2)
    with pytest.raises(ValueError, match="ragged"):
        ContinuousBatcher(params, TCFG, num_slots=1, max_len=64, attn="ragged", tp=2)
    assert ContinuousBatcher(params, TCFG, num_slots=1, max_len=64, attn="auto", tp=2).attn == "bucketed"
    odd = dataclasses.replace(TCFG, vocab_size=255)
    with pytest.raises(ValueError, match="vocab_size 255"):
        ContinuousBatcher(TL.init(torch.Generator().manual_seed(0), odd, "cpu"), odd, num_slots=1,
                          max_len=64, tp=2)


def test_tp_refuses_int8_resolves_dense_and_counts_devices(monkeypatch):
    """``--int8`` with ``--tp 2`` raises by name (JAX's engine fails to
    place int8 weights there), ``--kv`` unset resolves to dense under tp,
    ``--tp 2`` with one visible CUDA device raises as JAX's does, and
    ``--tp 2 --device cpu`` serves from two shards on the CPU."""
    from tony_tpu_torch.ops import quant

    with pytest.raises(ValueError, match="--int8 with --tp 2"):
        TH.build_engine(TH.parse_args(["--preset", "tiny", "--device", "cpu", "--tp", "2", "--int8"]))
    _, params = _serving_params()
    q, _, _ = quant.quantize_tree(params, min_size=1)
    assert isinstance(q["layers"]["wq"], quant.QTensor)
    with pytest.raises(ValueError, match="int8"):
        ContinuousBatcher(q, TCFG, num_slots=1, max_len=64, tp=2)
    args = TH.parse_args(["--preset", "tiny", "--device", "cpu", "--tp", "2", "--max-len", "512"])
    assert TH._resolve_kv(args) == "dense"
    assert TH._resolve_kv(TH.parse_args(["--preset", "tiny", "--max-len", "512"])) == "paged"
    eng = TH.build_engine(args)
    assert eng.kv == "dense" and eng.tp == 2 and len(eng.cache.k) == 2
    monkeypatch.setattr(TH, "resolve_device", lambda name: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--tp 2 needs 2 devices but only 1 are visible"):
        TH.build_engine(TH.parse_args(["--preset", "tiny", "--tp", "2"]))


def test_the_model_axis_still_refuses_what_is_not_ported(monkeypatch):
    """BERT on the model axis (A8b's second part), a model axis beside an
    expert axis (A11's rest), and a stage axis beside it (A13c) raise by name, for
    Mixtral too; a model axis beside a context axis is a gang's (A12c,
    ``test_torch_cp_tp.py``), which one process does not hold; Mixtral's TP
    engine serves (its tokens are held to JAX's in
    ``test_torch_tp_mixtral.py``); a Llama model axis whose heads,
    vocabulary or FFN do not split raises naming the numbers."""
    from tony_tpu_torch.models import bert, mixtral
    from tony_tpu_torch.parallel.mesh import MeshSpec
    from tony_tpu_torch.train import loop

    with pytest.raises(NotImplementedError, match="A8b's second part"):
        loop.run_lm_training(bert, bert.BERT_TINY, loop.LoopConfig(device="cpu", steps=1, model_axis=2))
    for mod, cfg in ((TL, TCFG), (mixtral, mixtral.MIXTRAL_TINY)):
        with pytest.raises(ValueError, match="not divisible by model"):
            loop.run_lm_training(mod, cfg, loop.LoopConfig(device="cpu", steps=1, model_axis=2, context_axis=2))
    for kw, item in ((dict(expert_axis=2), "A11"), (dict(stage_axis=2), "A13c")):
        with pytest.raises(NotImplementedError, match=item):
            loop.run_lm_training(mixtral, mixtral.MIXTRAL_TINY, loop.LoopConfig(device="cpu", steps=1, model_axis=2,
                                                                               **kw))
    for kw, item in ((dict(expert=2, model=2), "A11"), (dict(stage=2, model=2), "A13c")):
        with pytest.raises(NotImplementedError, match=item):
            MeshSpec(**kw).build("cpu")
    with pytest.raises(ValueError, match="needs a gang of as many processes"):
        MeshSpec(context=2, model=2).build("cpu")
    mcfg = dataclasses.replace(mixtral.MIXTRAL_TINY, dtype="float32")
    eng = ContinuousBatcher(mixtral.init(torch.Generator().manual_seed(0), mcfg, "cpu"), mcfg, num_slots=1,
                            max_len=64, tp=2)
    assert eng.tp == 2 and len(_run(eng, [[1, 2, 3]], n=3)[0]) == 3
    with pytest.raises(ValueError, match="n_heads 4, n_kv_heads 2, vocab_size 256 and d_ff 128 must divide"):
        TL.check_model_axis(TCFG, 8)
    TL.check_model_axis(TCFG, 2)
