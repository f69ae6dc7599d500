"""Expert parallelism and the MoE dispatches on the CPU, against the JAX package.

Every run is in f32 on numpy inputs from a seed, handed to both packages
(weights bridged by ``models/convert.py``). Two gloo gangs of the port run at
once, each rank with ``OMP_NUM_THREADS=1``, beside JAX's references, which
run on threads of their own in this process, each on at most 4 of the 8
virtual CPU devices:

- one process: ``moe_ffn``'s ``ragged_xla``, ``gather`` and ``dense``
  dispatches against JAX's on the inputs of JAX's ``tests/test_parallel.py``
  MoE tests (y, the aux losses and ``moe_dropped_frac`` within 1e-5, every
  gradient within 1e-4), the all-to-expert-0 router that drops more than
  half under capacity and nothing under the ragged dispatches, ``capacity``'s
  floor and the refusal of an unknown dispatch;
- a gang of 4 on ``data 2 × expert 2`` runs ``moe_ffn`` (every dispatch)
  against JAX's on ``MeshSpec(data=2, expert=2)``, with a token mask that
  gives the two data shards unequal valid counts: the ragged dispatches'
  router losses are JAX's per-shard means under its ``pmean``, the
  capacity dispatches' the global batch's; the ragged dispatch once more
  with NaN in its pad rows. It then trains ``MIXTRAL_TINY`` 3 steps on
  ``fsdp 2 × expert 2`` against JAX's sharded step on the same mesh, on
  packed batches whose padding leaves the two data × fsdp shards unequal
  target counts, and saves step 3;
- a gang of 2 runs ``moe_ffn`` on ``data 2`` (C2's global statistic on the
  same input), ``moe_all_to_all`` against JAX's ``all_to_all``, trains
  Mixtral and ``LLAMA_TINY`` on ``expert 2`` (a family without experts
  computes the same step on both ranks, as JAX's replicates it), restores
  the gang of 4's step onto ``expert 2``, and runs the ``pretrain_mixtral``
  and ``pretrain --expert_axis 2`` entries.
"""

import concurrent.futures
import dataclasses
import functools
import json
import math
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

from tony_tpu.compat import shard_map  # noqa: E402
from tony_tpu.models import llama as JL  # noqa: E402
from tony_tpu.models import mixtral as JM  # noqa: E402
from tony_tpu.parallel import expert as JE  # noqa: E402
from tony_tpu.parallel.mesh import MeshSpec as JMeshSpec  # noqa: E402
from tony_tpu.train import trainer as JT  # noqa: E402
from tony_tpu_torch.models import llama as TL  # noqa: E402
from tony_tpu_torch.models import mixtral as TM  # noqa: E402
from tony_tpu_torch.parallel import expert as TE  # noqa: E402
from tony_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402
from tony_tpu_torch.train import checkpoint as TC  # noqa: E402
from tony_tpu_torch.train import loop as TLp  # noqa: E402
from tony_tpu_torch.train import pretrain_mixtral  # noqa: E402
from tony_tpu_torch.train import trainer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=3, grad_clip=0.5)
B, T, STEPS = 8, 32, 3
JCFG = dataclasses.replace(JM.MIXTRAL_TINY, dtype="float32")
TCFG = dataclasses.replace(TM.MIXTRAL_TINY, dtype="float32")
JLCFG = dataclasses.replace(JL.LLAMA_TINY, dtype="float32")
TLCFG = dataclasses.replace(TL.LLAMA_TINY, dtype="float32")
KEYS = ("loss", "ce_loss", "moe_balance_loss", "moe_z_loss", "grad_norm")
LLAMA_KEYS = ("loss", "grad_norm")
AUX = ("moe_balance_loss", "moe_z_loss", "moe_dropped_frac")
DISPATCHES = ("ragged", "ragged_xla", "gather", "dense")
# the moe_ffn inputs of the gangs: E, D, F of JAX's sharded MoE test, 4 rows of
# 8 tokens; data shard 0 (rows 0-1) all valid, shard 1 with 6 of its 16 masked
E, D, F = 4, 16, 32
FFN_B, FFN_T = 4, 8
FFN_CAPACITY = 1.0

_COMMON = """
import dataclasses, functools, os, sys, time, torch
import torch.distributed as dist
from tony_tpu_torch.models import llama, mixtral
from tony_tpu_torch.models.convert import blocks_from_numpy
from tony_tpu_torch.parallel import expert
from tony_tpu_torch.parallel.mesh import MeshSpec
from tony_tpu_torch.parallel.sharding import Layout
from tony_tpu_torch.runtime import init_distributed, shutdown_distributed
from tony_tpu_torch.train import trainer as TT
from tony_tpu_torch.train.checkpoint import CheckpointManager, restore_or_init

CFG = dataclasses.replace(mixtral.MIXTRAL_TINY, dtype="float32")
LCFG = dataclasses.replace(llama.LLAMA_TINY, dtype="float32")
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=3, grad_clip=0.5)
B, T = 8, 32
RULES = mixtral.sharding_rules(CFG)
KEYS = ("loss", "ce_loss", "moe_balance_loss", "moe_z_loss", "grad_norm")
LLAMA_KEYS = ("loss", "grad_norm")
AXES = ("data", "fsdp", "expert", "model")


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
    from tony_tpu_torch.parallel.sharding import split_dim
    return {"size": {a: mesh.shape[a] for a in AXES}, "index": {a: mesh.axis_index(a) for a in AXES},
            "dims": {n: {a: split_dim(layout.spec(n), mesh, a) for a in ("fsdp", "expert", "model")}
                     for n in names}}


def rows_of(batch, mesh):
    # this rank's rows: those of its data x fsdp index
    rows = B // (mesh.shape["data"] * mesh.shape["fsdp"])
    k = dist.get_rank() // (mesh.shape["expert"] * mesh.shape["model"])
    return {n: v[k * rows:(k + 1) * rows] for n, v in batch.items()}


def train(mesh, npp, batches, model=mixtral, cfg=CFG, keys=KEYS):
    # 3 steps from the seeded weights on this rank's rows: the metrics, the
    # router's gradient at each step (Mixtral's), the state
    rules = model.sharding_rules(cfg)
    opt = Recording(TT.OptimizerConfig(**OPT))
    opt.seen = []
    state = TT.TrainState.create(blocks_from_numpy(npp, rules, mesh, "cpu"), opt, Layout(rules, mesh))
    step = TT.make_train_step(functools.partial(model.loss_fn, cfg=cfg, mesh=mesh), opt, group=mesh.group)
    log = []
    for b in batches:
        state, m = step(state, rows_of(b, mesh))
        log.append({k: float(m[k]) for k in keys})
    return log, [seen.get("layers/router") for seen in opt.seen], state


def nan_pads(mesh, ffn_in):
    # the ragged dispatch with every pad row of the span's expert output
    # (a row no choice was sorted to) set to NaN: a clamped index may point
    # at one, and y must not see it
    seen = {}
    real_route, real_rows, real_grouped = expert._route_named, expert._span_rows, expert._grouped

    def route(*args):
        out = real_route(*args)
        seen["dest"] = out[1]
        return out

    def span_rows(*args):
        out = real_rows(*args)
        seen["start"], seen["span"] = out[0], out[2]
        return out

    def grouped(*args):
        ys = real_grouped(*args)
        rel = seen["dest"] - seen["start"]
        pad = torch.ones(seen["span"], dtype=torch.bool)
        pad[rel[(rel >= 0) & (rel < seen["span"])]] = False
        return ys.masked_fill(pad[:, None], float("nan"))

    expert._route_named, expert._span_rows, expert._grouped = route, span_rows, grouped
    try:
        return ffn(mesh, ffn_in, ("ragged",))["ragged"]
    finally:
        expert._route_named, expert._span_rows, expert._grouped = real_route, real_rows, real_grouped


def ffn(mesh, ffn_in, dispatches):
    # moe_ffn on this rank's rows (its data index) and experts (its expert
    # index): y, the aux values, and the gradients of sum(y * wout) + the
    # router losses
    ep, ei = mesh.shape["expert"], mesh.axis_index("expert")
    rows = ffn_in["x"].shape[0] // mesh.shape["data"]
    di = mesh.axis_index("data")
    mine = lambda t: t[di * rows:(di + 1) * rows]
    out = {}
    for dispatch in dispatches:
        cfg = expert.MoEConfig(num_experts=ffn_in["wg"].shape[0], top_k=2, capacity_factor=ffn_in["cap"],
                               dispatch=dispatch)
        x = mine(ffn_in["x"]).clone().requires_grad_(True)
        router = ffn_in["router"].clone().requires_grad_(True)
        ws = [w.chunk(ep, 0)[ei].clone().requires_grad_(True) for w in (ffn_in["wg"], ffn_in["wu"], ffn_in["wd"])]
        y, aux = expert.moe_ffn(x, router, *ws, cfg, mesh, token_mask=mine(ffn_in["mask"]),
                                group=mesh.group)
        loss = (y * mine(ffn_in["wout"])).sum() + aux["moe_balance_loss"] + aux["moe_z_loss"]
        grads = torch.autograd.grad(loss, [x, router, *ws])
        out[dispatch] = {"y": y.detach(), "aux": {k: float(v) for k, v in aux.items()},
                         "grads": [g.detach() for g in grads]}
    return out
"""

# the gang of 4: moe_ffn on data 2 x expert 2; then 3 steps on fsdp 2 x expert 2
# and a sharded save of step 3
_GANG4 = """
inp, out, ckpt = sys.argv[1:4]
data = torch.load(inp, weights_only=False)
init_distributed(torch.device("cpu"))
mesh = MeshSpec(data=2, expert=2).build("cpu")
res = {"ffn": ffn(mesh, data["ffn"], DISPATCHES), "ffn_where": placement(mesh),
       "ffn_group": dist.get_process_group_ranks(mesh.group), "nan_pads": nan_pads(mesh, data["ffn"])}
mesh = MeshSpec.auto(expert=2).build("cpu")
res["where"] = placement(mesh)
log, router, state = train(mesh, data["npp"], data["batches"])
res.update(log=log, router=router, blocks=blocks(state),
           bytes={"params": TT.tree_bytes(state.params), "mu": TT.tree_bytes(state.opt_state["mu"]),
                  "nu": TT.tree_bytes(state.opt_state["nu"])})
mgr = CheckpointManager(ckpt, group=mesh.gang)
mgr.save(STEPS, state.state_dict())
mgr.close()
shutdown_distributed()
torch.save(res, out)
"""

# the gang of 2: moe_ffn on data 2; moe_all_to_all; 3 steps of Mixtral and
# of Llama on expert 2; the gang of 4's step 3 restored onto expert 2; the
# pretrain_mixtral and pretrain entries on expert 2
_GANG2 = """
inp, out, ckpt, entry_ckpt, port = sys.argv[1:6]
data = torch.load(inp, weights_only=False)
init_distributed(torch.device("cpu"))
mesh = MeshSpec(data=2).build("cpu")
res = {"ffn": ffn(mesh, data["ffn"], ("ragged",))}
from tony_tpu_torch.parallel.collectives import moe_all_to_all
a2a = data["a2a"][dist.get_rank()].clone().requires_grad_(True)
got = moe_all_to_all(a2a, dist.group.WORLD)
res["a2a"] = {"out": got.detach(),
              "grad": torch.autograd.grad((got * data["a2a_w"][dist.get_rank()]).sum(), a2a)[0]}
mesh = MeshSpec.auto(expert=2).build("cpu")
res["where"] = placement(mesh)
log, router, state = train(mesh, data["npp"], data["batches"])
res.update(log=log, router=router, blocks=blocks(state))
log, _, state = train(mesh, data["llama"], data["batches"], llama, LCFG, LLAMA_KEYS)
res["llama"] = {"log": log, "params": {n: t.detach().clone() for n, t in TT._leaves(state.params)}}
deadline = time.time() + 200
while not os.path.isdir(os.path.join(ckpt, str(STEPS))) and time.time() < deadline:
    time.sleep(0.2)
opt = TT.OptimizerConfig(**OPT).build()
init = functools.partial(mixtral.init, torch.Generator().manual_seed(1), CFG, "cpu")  # not the saved values
st, _, start = restore_or_init(ckpt, lambda: TT.sharded_init(init, RULES, mesh, opt), TT.TrainState.load,
                               group=mesh.gang)
res["expert2"] = {"start": start, "step": st.step, "count": st.opt_state["count"], "blocks": blocks(st)}
from tony_tpu_torch.train import pretrain_mixtral
pretrain_mixtral.main(["--device", "cpu", "--preset", "tiny", "--expert_axis", "2", "--steps", "2",
                       "--batch_size", "4", "--seq_len", "16", "--log_every", "1", "--warmup_steps", "1",
                       "--checkpoint_dir", entry_ckpt])  # leaves the group at its end
print("== llama entry ==", flush=True)
os.environ["MASTER_PORT"] = port
from tony_tpu_torch.train import pretrain
pretrain.main(["--device", "cpu", "--preset", "tiny", "--expert_axis", "2", "--steps", "2", "--batch_size", "4",
               "--seq_len", "16", "--log_every", "1", "--warmup_steps", "1"])
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
    head = f"STEPS = {STEPS}\nDISPATCHES = {DISPATCHES!r}\n"
    for rank in range(n):
        env = dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        env.pop("TONY_TRAIN_METRICS_FILE", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", head + _COMMON + script, *[a.format(rank=rank) for a in args]],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def finish() -> list[str]:
        try:
            outs = [p.communicate(timeout=240)[0] for p in procs]
        finally:
            for p in procs:  # a rank left waiting on a collective
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-3000:]
        return outs

    return finish


def _one_thread(fn):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def _ffn_inputs(seed: int = 4) -> dict:
    """JAX's sharded-MoE test widths (E 4, D 16, F 32): x, the router, the
    experts at fan-in scale, the output's weights and the token mask."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    mask = np.ones((FFN_B, FFN_T), bool)
    mask[2, 5:] = False
    mask[3, :3] = False
    return {"x": n(FFN_B, FFN_T, D), "router": n(D, E), "wg": n(E, D, F, scale=D ** -0.5),
            "wu": n(E, D, F, scale=D ** -0.5), "wd": n(E, F, D, scale=F ** -0.5), "wout": n(FFN_B, FFN_T, D),
            "mask": mask, "cap": FFN_CAPACITY}


def _jax_ffn(inp: dict, dispatch: str, mesh=None) -> dict:
    """JAX's ``moe_ffn`` (on ``mesh``, under jit): y, the aux values, and the
    gradients of sum(y * wout) + the router losses for x, the router and
    the experts."""
    cfg = JE.MoEConfig(num_experts=E, top_k=2, capacity_factor=inp["cap"], dispatch=dispatch)
    mask, wout = jnp.asarray(inp["mask"]), jnp.asarray(inp["wout"])

    def loss(x, router, wg, wu, wd):
        y, aux = JE.moe_ffn(x, router, wg, wu, wd, cfg, mesh, mask)
        return (y * wout).sum() + aux["moe_balance_loss"] + aux["moe_z_loss"], (y, aux)

    args = [jnp.asarray(inp[k]) for k in ("x", "router", "wg", "wu", "wd")]
    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(5)), has_aux=True))(*args)
    return {"y": np.asarray(y), "aux": {k: float(v) for k, v in aux.items()},
            "grads": [np.asarray(g) for g in grads]}


def _jax_sharded_run(npp, batches, spec, model=JM, cfg=JCFG, keys=KEYS):
    """JAX's ``sharded_init`` + ``make_train_step`` of a tiny f32 model
    (Mixtral unless named) from ``npp`` on ``spec`` over as many of the 8
    virtual devices: each step's metrics, the gradient of the first step's
    loss (Mixtral's router's) and the final parameters."""
    mesh = spec.build(devices=jax.devices()[:int(np.prod(list(spec.axis_sizes.values())))])
    opt = JT.OptimizerConfig(**OPT).build()
    state = JT.sharded_init(lambda: jax.tree.map(jnp.asarray, npp), model.sharding_rules(cfg), mesh, opt)
    loss_fn = functools.partial(model.loss_fn, cfg=cfg, mesh=mesh)
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    grads = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))(state.params, batches[0])
    step = JT.make_train_step(loss_fn, opt)
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append({k: float(m[k]) for k in keys})
    return out, np.asarray(grads["layers"].get("router", 0.0)), jax.tree.map(np.asarray, state.params)


def _jax_all_to_all(x: np.ndarray, w: np.ndarray):
    """JAX's ``moe_all_to_all`` over 2 devices (x [2, n, ...]: device i's
    block i) and the gradient of sum(out * w)."""
    from jax.sharding import PartitionSpec as P

    from tony_tpu.parallel.collectives import moe_all_to_all

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("expert",))
    fn = shard_map(lambda t: moe_all_to_all(t[0], "expert")[None], mesh=mesh, in_specs=P("expert"),
                   out_specs=P("expert"), check_vma=False)
    value = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    grad = np.asarray(jax.jit(jax.grad(lambda t: (fn(t) * jnp.asarray(w)).sum()))(jnp.asarray(x)))
    return value, grad


def _jax_references(npp, llama_npp, batches, ffn_in, a2a, a2a_w):
    jobs = {"fsdp2_expert2": lambda: _jax_sharded_run(npp, batches, JMeshSpec(fsdp=2, expert=2)),
            "expert2": lambda: _jax_sharded_run(npp, batches, JMeshSpec(expert=2)),
            "llama_expert2": lambda: _jax_sharded_run(llama_npp, batches, JMeshSpec(expert=2), JL, JLCFG,
                                                      LLAMA_KEYS),
            "a2a": lambda: _jax_all_to_all(a2a, a2a_w),
            "global_ragged": lambda: _jax_ffn(ffn_in, "ragged")}
    for d in DISPATCHES:
        jobs[f"ffn_{d}"] = functools.partial(
            lambda d: _jax_ffn(ffn_in, d, JMeshSpec(data=2, expert=2).build(devices=jax.devices()[:4])), d)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def _seeded_weights(seed: int, model=TM, cfg=TCFG) -> dict:
    """A tiny f32 model's weights (Mixtral's unless named) as a numpy tree,
    drawn by the port's seeded init, handed to JAX and to the port alike."""
    tree = model.init(torch.Generator().manual_seed(seed), cfg, "cpu")
    return {k: {n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _block(whole: torch.Tensor, where: dict, name: str) -> torch.Tensor:
    """The block of ``whole`` the rank placed at ``where`` holds."""
    out = whole
    for axis, dim in where["dims"][name].items():
        if dim is not None:
            out = out.chunk(where["size"][axis], dim)[where["index"][axis]]
    return out


def _packed_batches(rng) -> list[dict]:
    """``STEPS`` packed batches [B, T+1]: two segments a row; rows B/2.. end
    in 10–20 padding tokens, so the two data × fsdp shards of the gang of 4
    hold unequal target counts."""
    out = []
    for _ in range(STEPS):
        seg = np.ones((B, T + 1), np.int32)
        for b in range(B):
            seg[b, rng.integers(4, T - 4):] = 2
            if b >= B // 2:
                seg[b, T + 1 - rng.integers(10, 21):] = 0
        out.append({"tokens": rng.integers(0, JCFG.vocab_size, (B, T + 1)), "segment_ids": seg})
    return out


def _step_lines(out: str) -> list[dict]:
    """The JSON step reports a rank's loop printed."""
    return [json.loads(line) for line in out.splitlines() if line.startswith("{") and '"loss"' in line]


def _rel(got, want) -> float:
    got, want = torch.as_tensor(np.asarray(got)).double(), torch.as_tensor(np.asarray(want)).double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """The gangs of 4 and 2, started together, beside JAX's references on
    the same weights and inputs, and the one-process restore of the gang of
    4's step."""
    d = tmp_path_factory.mktemp("ep")
    npp, llama_npp = _seeded_weights(3), _seeded_weights(3, TL, TLCFG)
    rng = np.random.default_rng(5)
    batches = _packed_batches(rng)
    ffn_in = _ffn_inputs()
    a2a = rng.standard_normal((2, 6, 3)).astype(np.float32)
    a2a_w = rng.standard_normal((2, 6, 3)).astype(np.float32)
    torch.save({"npp": npp, "llama": llama_npp,
                "batches": [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches],
                "ffn": {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in ffn_in.items()},
                "a2a": torch.from_numpy(a2a), "a2a_w": torch.from_numpy(a2a_w)}, d / "in.pt")
    ckpt = d / "ckpt"
    finish4 = _start(_GANG4, 4, [str(d / "in.pt"), str(d / "r4_{rank}.pt"), str(ckpt)])
    finish2 = _start(_GANG2, 2, [str(d / "in.pt"), str(d / "r2_{rank}.pt"), str(ckpt), str(d / "entry"),
                                 str(_free_port())])
    jax_runs = _one_thread(lambda: _jax_references(npp, llama_npp, batches, ffn_in, a2a, a2a_w))
    finish4()
    outs2 = finish2()
    whole_step = TC.restore_or_init(str(ckpt), lambda: TT.TrainState.create(
        TM.init(torch.Generator().manual_seed(1), TCFG, "cpu"), TT.OptimizerConfig(**OPT).build()),
        TT.TrainState.load)
    return {"fsdp2_expert2": [torch.load(d / f"r4_{r}.pt", weights_only=False) for r in range(4)],
            "expert2": [torch.load(d / f"r2_{r}.pt", weights_only=False) for r in range(2)],
            "jax": jax_runs, "ckpt": ckpt, "one": whole_step, "entry": d / "entry", "entry_out": outs2,
            "ffn_in": ffn_in, "batches": batches}


# -- one process: the dispatches ---------------------------------------------------------


def _np_ffn_inputs(seed, B_=2, T_=8):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((B_, T_, D)).astype(np.float32),
            "router": rng.standard_normal((D, E)).astype(np.float32),
            "wg": (rng.standard_normal((E, D, F)) / D ** 0.5).astype(np.float32),
            "wu": (rng.standard_normal((E, D, F)) / D ** 0.5).astype(np.float32),
            "wd": (rng.standard_normal((E, F, D)) / F ** 0.5).astype(np.float32),
            "wout": rng.standard_normal((B_, T_, D)).astype(np.float32)}


def _port_ffn(inp: dict, dispatch: str, mask=None, cap: float = 2.0, top_k: int = 2):
    cfg = TE.MoEConfig(num_experts=inp["wg"].shape[0], top_k=top_k, capacity_factor=cap, dispatch=dispatch)
    ts = [torch.from_numpy(inp[k]).requires_grad_(True) for k in ("x", "router", "wg", "wu", "wd")]
    y, aux = TE.moe_ffn(*ts, cfg, None, None if mask is None else torch.from_numpy(mask))
    loss = (y * torch.from_numpy(inp["wout"])).sum() + aux["moe_balance_loss"] + aux["moe_z_loss"]
    return y.detach().numpy(), {k: float(v) for k, v in aux.items()}, torch.autograd.grad(loss, ts)


def _jax_local_ffn(inp: dict, dispatch: str, mask=None, cap: float = 2.0, top_k: int = 2):
    cfg = JE.MoEConfig(num_experts=inp["wg"].shape[0], top_k=top_k, capacity_factor=cap, dispatch=dispatch)
    wout = jnp.asarray(inp["wout"])

    def loss(x, router, wg, wu, wd):
        y, aux = JE.moe_ffn(x, router, wg, wu, wd, cfg, None, None if mask is None else jnp.asarray(mask))
        return (y * wout).sum() + aux["moe_balance_loss"] + aux["moe_z_loss"], (y, aux)

    args = [jnp.asarray(inp[k]) for k in ("x", "router", "wg", "wu", "wd")]
    (_, (y, aux)), grads = jax.value_and_grad(loss, argnums=tuple(range(5)), has_aux=True)(*args)
    return np.asarray(y), {k: float(v) for k, v in aux.items()}, grads


def _assert_ffn_equal(got, want, what):
    (ty, taux, tg), (jy, jaux, jg) = got, want
    assert _rel(ty, jy) <= 1e-5, what
    assert set(taux) == set(jaux) == set(AUX), what
    for k in AUX:
        assert abs(taux[k] - jaux[k]) <= 1e-5 * max(1.0, abs(jaux[k])), (what, k, taux[k], jaux[k])
    for name, a, b in zip(("x", "router", "w_gate", "w_up", "w_down"), tg, jg):
        assert _rel(a, b) <= 1e-4, (what, name, _rel(a, b))


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("dispatch", ["ragged_xla", "gather", "dense"])
def test_dispatches_match_jaxs_moe_ffn(dispatch, masked):
    """y, the balance and z losses and ``moe_dropped_frac`` within 1e-5 and
    the gradients of x, the router and the experts within 1e-4 of JAX's
    ``moe_ffn`` on the same inputs (``capacity_factor`` 2.0, as JAX's MoE
    tests); at 1.0 the capacity dispatches drop choices, equally."""
    inp = _np_ffn_inputs(4)
    mask = np.ones((2, 8), bool) if masked else None
    if masked:
        mask[0, 5:] = False
        mask[1, :2] = False
    for cap in (2.0, 1.0):
        got = _port_ffn(inp, dispatch, mask, cap)
        _assert_ffn_equal(got, _jax_local_ffn(inp, dispatch, mask, cap), (dispatch, masked, cap))
    if dispatch != "ragged_xla" and not masked:
        assert got[1]["moe_dropped_frac"] > 0  # cap 1.0 drops


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_an_all_to_expert0_router_drops_over_half_under_capacity_and_nothing_ragged(dispatch):
    """JAX's capacity-drop test: top-1 of 4 experts at ``capacity_factor``
    0.25 with every token sent to expert 0 drops more than half of the
    choices in the gather and dense dispatches, as JAX's do; the ragged
    dispatches drop nothing."""
    rng = np.random.default_rng(2)
    inp = {"x": rng.standard_normal((1, 32, 8)).astype(np.float32),
           "router": np.zeros((8, 4), np.float32), "wg": np.full((4, 8, 16), 0.1, np.float32),
           "wu": np.full((4, 8, 16), 0.1, np.float32), "wd": np.full((4, 16, 8), 0.1, np.float32),
           "wout": rng.standard_normal((1, 32, 8)).astype(np.float32)}
    inp["router"][:, 0] = 10.0
    got = _port_ffn(inp, dispatch, cap=0.25, top_k=1)
    want = _jax_local_ffn(inp, dispatch, cap=0.25, top_k=1)
    _assert_ffn_equal(got, want, dispatch)
    if dispatch in ("gather", "dense"):
        assert got[1]["moe_dropped_frac"] > 0.5
    else:
        assert got[1]["moe_dropped_frac"] == 0.0


def test_capacity_floor_and_an_unknown_dispatch_raise_as_jaxs():
    """``capacity`` JAX's (its floor at top_k), and a dispatch JAX does not
    know raises its ``ValueError`` in ``moe_ffn`` and in
    ``config_from_dict``; the named dispatches configure."""
    for tokens, cfg in ((64, dict(num_experts=4, top_k=2, capacity_factor=2.0)), (1, dict(num_experts=8, top_k=2)),
                        (2048, dict())):
        assert TE.capacity(tokens, TE.MoEConfig(**cfg)) == JE.capacity(tokens, JE.MoEConfig(**cfg))
    assert TE.capacity(1, TE.MoEConfig(num_experts=8, top_k=2)) == 2
    inp = {k: torch.from_numpy(v) for k, v in _np_ffn_inputs(0).items()}
    with pytest.raises(ValueError, match="dispatch must be 'gather' or 'dense', got 'scatter'"):
        TE.moe_ffn(inp["x"], inp["router"], inp["wg"], inp["wu"], inp["wd"], TE.MoEConfig(E, dispatch="scatter"))
    with pytest.raises(ValueError, match="got 'scatter'"):
        TM.config_from_dict({"preset": "tiny", "moe_dispatch": "scatter"})
    for d in DISPATCHES:
        cfg = TM.config_from_dict({"preset": "tiny", "moe_dispatch": d, "capacity_factor": 2.0})
        assert cfg.moe.dispatch == d and cfg.moe.capacity_factor == 2.0


def test_kernel_eligibility_is_jaxs_rule_before_any_launch():
    """B7/B8 take the ragged dispatch in bf16 with D and F multiples of 128
    on the card; f32, an unaligned shape or ``ragged_xla`` take the grouped
    product (the CPU's ragged dispatch runs the kernels' plain versions)."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    rag = TE.MoEConfig(dispatch="ragged")
    assert TE.kernel_eligible(rag, 4096, 14336, torch.bfloat16, cuda)
    assert not TE.kernel_eligible(rag, 4096, 14336, torch.float32, cuda)
    assert not TE.kernel_eligible(rag, 4096, 14336 - 64, torch.bfloat16, cuda)
    assert not TE.kernel_eligible(rag, 64, 128, torch.bfloat16, cuda)
    assert not TE.kernel_eligible(TE.MoEConfig(dispatch="ragged_xla"), 4096, 14336, torch.bfloat16, cuda)
    assert TE.kernel_eligible(rag, 64, 100, torch.float32, cpu)
    assert not TE.kernel_eligible(TE.MoEConfig(dispatch="gather"), 4096, 14336, torch.bfloat16, cpu)


def test_pretrain_mixtral_passes_the_dispatch_fields(monkeypatch):
    """``--moe_dispatch`` and ``--capacity_factor`` reach the config the
    loop trains; ``--expert_axis`` its ``LoopConfig``."""
    seen = {}
    monkeypatch.setattr(pretrain_mixtral, "run_lm_training",
                        lambda mod, cfg, loop: seen.update(cfg=cfg, loop=loop))
    pretrain_mixtral.main(["--device", "cpu", "--preset", "tiny", "--expert_axis", "2", "--moe_dispatch", "dense",
                           "--capacity_factor", "3.0"])
    assert seen["cfg"].moe_dispatch == "dense" and seen["cfg"].capacity_factor == 3.0
    assert seen["loop"].expert_axis == 2
    pretrain_mixtral.main(["--device", "cpu", "--preset", "tiny"])
    assert seen["cfg"] == TM.MIXTRAL_TINY


def test_the_expert_axis_refuses_what_is_not_ported():
    """An expert axis beside a model or context axis (A11's rest, Llama's
    too), with stages (A13c), or over experts it does not divide (JAX's
    words) raises before anything is built."""
    for kw, item in ((dict(expert=2, model=2), "A11"), (dict(expert=2, context=2), "A11"),
                     (dict(expert=2, stage=2), "A13c")):
        with pytest.raises(NotImplementedError, match=item):
            MeshSpec(**kw).build("cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        TLp.run_lm_training(TL, TLCFG, TLp.LoopConfig(device="cpu", steps=1, expert_axis=2, model_axis=2))
    for kw, item in ((dict(model_axis=2), "A11"), (dict(context_axis=2), "A11")):
        with pytest.raises(NotImplementedError, match=item):
            TLp.run_lm_training(TM, TCFG, TLp.LoopConfig(device="cpu", steps=1, expert_axis=2, **kw))
    with pytest.raises(ValueError, match="num_experts 4 must divide the expert axis 3"):
        TLp.run_lm_training(TM, TCFG, TLp.LoopConfig(device="cpu", steps=1, expert_axis=3))
    with pytest.raises(ValueError, match="num_experts 4 must divide the expert axis 3"):
        TE.check_expert_axis(4, 3)


# -- the gangs --------------------------------------------------------------------------


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_ffn_on_data2_expert2_is_jaxs_on_the_same_mesh(gangs, dispatch):
    """Each rank of ``data 2 × expert 2`` runs its data index's rows and its
    expert index's experts: y on its rows and the gradient of x within
    1e-5 / 1e-4 of JAX's ``moe_ffn`` on ``MeshSpec(data=2, expert=2)``, the
    router's gradient (summed over the data ranks) and each expert block's
    within 1e-4, the aux values within 1e-5, on unequal valid counts. The
    ranks of an expert line give the same y and router gradient, bit for
    bit, and ``Mesh.group`` is the data ranks of an expert index."""
    want = gangs["jax"][f"ffn_{dispatch}"]
    ranks = gangs["fsdp2_expert2"]
    rows = FFN_B // 2
    for r, res in enumerate(ranks):
        where = res["ffn_where"]
        di, ei = where["index"]["data"], where["index"]["expert"]
        assert res["ffn_group"] == [r % 2, r % 2 + 2]
        got = res["ffn"][dispatch]
        sl = slice(di * rows, (di + 1) * rows)
        assert _rel(got["y"], want["y"][sl]) <= 1e-5, (dispatch, r)
        assert _rel(got["grads"][0], want["grads"][0][sl]) <= 1e-4, (dispatch, r)
        for k in AUX:
            assert abs(got["aux"][k] - want["aux"][k]) <= 1e-5 * max(1.0, abs(want["aux"][k])), (dispatch, r, k)
        for i, w in enumerate(("w_gate", "w_up", "w_down")):
            summed = sum(ranks[d * 2 + ei]["ffn"][dispatch]["grads"][2 + i] for d in range(2))
            assert _rel(summed, np.split(want["grads"][2 + i], 2)[ei]) <= 1e-4, (dispatch, w, r)
        line = ranks[r ^ 1]["ffn"][dispatch]
        assert torch.equal(got["y"], line["y"]) and torch.equal(got["grads"][1], line["grads"][1]), (dispatch, r)
    router = sum(ranks[d * 2]["ffn"][dispatch]["grads"][1] for d in range(2))
    assert _rel(router, want["grads"][1]) <= 1e-4, dispatch


def test_nan_in_a_spans_pad_rows_never_reaches_y(gangs):
    """The expert output's pad rows are unspecified (B7's pad tiles): with
    every one of them NaN, the ragged dispatch on ``data 2 × expert 2``
    gives the same y and gradients, bit for bit, as JAX's ``row_ok`` mask
    makes it; choices outside a rank's span point at such rows."""
    for r, res in enumerate(gangs["fsdp2_expert2"]):
        got, want = res["nan_pads"], res["ffn"]["ragged"]
        assert torch.equal(got["y"], want["y"]), r
        assert got["aux"] == want["aux"], r
        for a, b in zip(got["grads"], want["grads"], strict=True):
            assert torch.equal(a, b), r


def test_the_ragged_expert_path_takes_jaxs_per_shard_means_and_a_data_axis_the_global_batch(gangs):
    """On unequal shards JAX's ``pmean`` of the per-shard router losses
    differs from the global batch's: the ragged dispatch on ``data 2 ×
    expert 2`` reads the former (held above), while on a data-only gang
    (``data 2``) it keeps C2's global statistic, JAX's unsharded values,
    with y and the gradients too; the capacity dispatches on the expert
    axis keep the global statistic."""
    pmean = gangs["jax"]["ffn_ragged"]["aux"]
    glob = gangs["jax"]["global_ragged"]
    assert abs(pmean["moe_balance_loss"] - glob["aux"]["moe_balance_loss"]) > 1e-3 * glob["aux"]["moe_balance_loss"]
    assert abs(gangs["jax"]["ffn_gather"]["aux"]["moe_z_loss"] - glob["aux"]["moe_z_loss"]) <= 1e-5
    rows = FFN_B // 2
    for r, res in enumerate(gangs["expert2"]):
        got = res["ffn"]["ragged"]
        sl = slice(r * rows, (r + 1) * rows)
        assert _rel(got["y"], glob["y"][sl]) <= 1e-5
        assert _rel(got["grads"][0], glob["grads"][0][sl]) <= 1e-4
        for k in AUX:
            assert abs(got["aux"][k] - glob["aux"][k]) <= 1e-5 * max(1.0, abs(glob["aux"][k])), (r, k)
    for i in range(1, 5):
        summed = sum(res["ffn"]["ragged"]["grads"][i] for res in gangs["expert2"])
        assert _rel(summed, glob["grads"][i]) <= 1e-4, i


def _shard_targets(batch: dict, shards: int) -> list[int]:
    """The targets each data × fsdp shard of ``batch`` counts (JAX's packed
    masking: within a segment, not padding)."""
    seg = batch["segment_ids"]
    ok = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] != 0)
    return [int(part.sum()) for part in np.split(ok, shards)]


@pytest.mark.parametrize("gang", ["fsdp2_expert2", "expert2"])
def test_mixtral_on_the_expert_axis_matches_jaxs_sharded_step(gangs, gang):
    """On packed batches, the loss, CE, balance and z losses and the grad
    norm within 1e-5 relative of JAX's on the same mesh, each step, on
    every rank (the clip active; the CE is a rank's own rows', their mean
    over the data × fsdp ranks weighed by their targets JAX's); each rank's
    blocks of the updated parameters within 1e-4 relative of the same
    blocks of JAX's. On ``fsdp 2 × expert 2`` the two shards count unequal
    targets: JAX's ``pmean`` of the per-shard router losses weighs each
    shard 1/2, not by its targets, in the losses and the gradients."""
    want, _, jparams = gangs["jax"][gang]
    ranks = gangs[gang]
    assert min(x["grad_norm"] for x in want) > OPT["grad_clip"]
    ep = ranks[0]["where"]["size"]["expert"]
    shards = len(ranks) // ep
    counts = [_shard_targets(b, shards) for b in gangs["batches"]]
    if shards > 1:
        assert all(len(set(c)) == shards for c in counts), counts
    for res in ranks:
        for step, (got, exp) in enumerate(zip(res["log"], want, strict=True)):
            line = ranks[res["where"]["index"]["expert"]::ep]
            ce = np.average([r["log"][step]["ce_loss"] for r in line], weights=counts[step])
            for k in KEYS:
                value = ce if k == "ce_loss" else got[k]
                assert abs(value - exp[k]) <= 1e-5 * abs(exp[k]), (gang, step, k, value, exp[k])
        for name, p in _leaves(jparams):
            got = res["blocks"]["params"][name]
            assert _rel(got, _block(torch.from_numpy(np.array(p)), res["where"], name)) < 1e-4, name


@pytest.mark.parametrize("gang", ["fsdp2_expert2", "expert2"])
def test_the_routers_gradient_is_the_same_bits_on_an_expert_line_and_jaxs(gangs, gang):
    """The router is whole on every rank: its gradient (after the gang's
    reduction, before the clip) is the same bits on the two ranks of each
    expert line at every step, and at the first step within 1e-5 relative
    of JAX's gradient of the loss on the same mesh."""
    ranks = gangs[gang]
    for a in range(0, len(ranks), 2):
        for step in range(STEPS):
            assert torch.equal(ranks[a]["router"][step], ranks[a + 1]["router"][step]), (a, step)
    for res in ranks:
        assert _rel(res["router"][0], gangs["jax"][gang][1]) <= 1e-5


def test_each_rank_holds_half_of_every_expert_leaf_and_a_quarter_with_fsdp(gangs):
    """``fsdp 2 × expert 2``: each expert leaf ``[L, E, D, F]`` is split on
    E over expert and D (F for ``we_down``'s ``[L, E, F, D]``: its fsdp dim)
    over fsdp, so a rank holds ``numel / 4`` of it and of its moments; the
    other leaves the fsdp rules split hold half, the router and the norms
    are whole. On ``expert 2`` every expert leaf is halved, the rest whole."""
    _, _, jparams = gangs["jax"]["fsdp2_expert2"]
    whole = {n: p.size * 4 for n, p in _leaves(jparams)}
    experts = {"layers/we_gate", "layers/we_up", "layers/we_down"}
    for gang in ("fsdp2_expert2", "expert2"):
        for res in gangs[gang]:
            dims = res["where"]["dims"]
            assert {n for n, d in dims.items() if d["expert"] is not None} == experts
            assert dims["layers/we_gate"]["expert"] == 1 and dims["layers/router"] == {
                "fsdp": None, "expert": None, "model": None}
            parts = {n: (2 if d["expert"] is not None else 1) * (2 if d["fsdp"] is not None else 1)
                     for n, d in dims.items()}
            if gang == "expert2":
                assert parts == {n: 2 if n in experts else 1 for n in whole}
                continue
            assert all(parts[n] == 4 for n in experts)
            want = sum(whole[n] // parts[n] for n in whole)
            for part in ("params", "mu", "nu"):
                assert res["bytes"][part] == want, part
                for n, t in res["blocks"][part].items():
                    assert t.numel() * 4 * parts[n] == whole[n], (part, n)


def test_a_fsdp2_expert2_step_restores_onto_one_process_and_onto_expert2(gangs):
    """The gang of 4's step 3 (each rank its blocks through DCP) read back
    whole in one process and onto a gang of 2 on ``expert 2``: params and
    both moments bit for bit, with the step and the count."""
    whole = TC.read_whole(str(gangs["ckpt"] / str(STEPS)))
    assert whole["step"] == STEPS and whole["opt_state"]["count"] == STEPS
    trees = {"params": whole["params"], "mu": whole["opt_state"]["mu"], "nu": whole["opt_state"]["nu"]}
    for res in gangs["fsdp2_expert2"]:
        for part, tree in trees.items():
            for name, t in _leaves(tree):
                assert torch.equal(res["blocks"][part][name], _block(t, res["where"], name)), (part, name)
    state, _, start = gangs["one"]
    assert start == STEPS and state.step == STEPS and state.opt_state["count"] == STEPS
    for name, t in _leaves(state.params):
        assert torch.equal(t.detach(), dict(_leaves(whole["params"]))[name]), name
    for res in gangs["expert2"]:
        got = res["expert2"]
        assert (got["start"], got["step"], got["count"]) == (STEPS, STEPS, STEPS)
        for part, tree in trees.items():
            for name, t in _leaves(tree):
                assert torch.equal(got["blocks"][part][name], _block(t, res["where"], name)), (part, name)


def test_moe_all_to_all_is_jaxs_with_its_gradient(gangs):
    """Over gloo, ``moe_all_to_all`` gives each rank JAX's ``all_to_all``
    (split 0, concat 0) block, and its backward JAX's gradient."""
    value, grad = gangs["jax"]["a2a"]
    for r, res in enumerate(gangs["expert2"]):
        np.testing.assert_array_equal(res["a2a"]["out"].numpy(), value[r])
        np.testing.assert_array_equal(res["a2a"]["grad"].numpy(), grad[r])


def test_llama_on_the_expert_axis_matches_jaxs_sharded_step(gangs):
    """A family without experts keeps every leaf whole on ``expert 2``, and
    both ranks take the same rows: the loss and grad norm within 1e-5
    relative of JAX's step on ``MeshSpec(expert=2)`` (which replicates the
    compute over the axis) each step, the updated parameters within 1e-4
    relative of JAX's, and the same bits on the two ranks."""
    want, _, jparams = gangs["jax"]["llama_expert2"]
    assert min(x["grad_norm"] for x in want) > OPT["grad_clip"]
    ranks = [res["llama"] for res in gangs["expert2"]]
    for res in ranks:
        for step, (got, exp) in enumerate(zip(res["log"], want, strict=True)):
            for k in LLAMA_KEYS:
                assert abs(got[k] - exp[k]) <= 1e-5 * abs(exp[k]), (step, k, got[k], exp[k])
        for name, p in _leaves(jparams):
            assert _rel(res["params"][name], p) < 1e-4, name
    assert ranks[0]["log"] == ranks[1]["log"]
    for name, t in ranks[0]["params"].items():
        assert torch.equal(t, ranks[1]["params"][name]), name


def test_the_pretrain_mixtral_entry_trains_on_the_expert_axis(gangs):
    """``pretrain_mixtral --expert_axis 2`` and ``pretrain --expert_axis 2``
    (Llama) in the gang of 2: both ranks log the same finite losses at
    steps 1 and 2, and Mixtral's each save its half of the experts."""
    entry = gangs["entry"]
    assert (entry / "2").is_dir()
    whole = TC.read_whole(str(entry / "2"))
    assert whole["step"] == 2 and whole["params"]["layers"]["we_gate"].shape == (2, 4, 64, 128)
    runs = [out.split("== llama entry ==") for out in gangs["entry_out"]]
    assert all(len(parts) == 2 for parts in runs)
    for family in range(2):
        logs = [_step_lines(parts[family]) for parts in runs]
        assert [line["step"] for line in logs[0]] == [1, 2], logs[0]
        assert all(math.isfinite(line["loss"]) and math.isfinite(line["grad_norm"]) for line in logs[0])
        keys = ("step", "loss", "grad_norm", *(k for k in logs[0][0] if k.startswith("moe_")))
        assert [{k: x[k] for k in keys} for x in logs[0]] == [{k: x[k] for k in keys} for x in logs[1]]
    assert "moe_balance_loss" in _step_lines(runs[0][0])[0]
