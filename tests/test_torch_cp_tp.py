"""A model axis beside a context axis across a gloo gang on the CPU, and the
capacity dispatches in a context gang, against the JAX package.

Every run is in f32 on numpy inputs from a seed, handed to both packages
(weights from the port's seeded init, bridged as numpy by
``models/convert.py``). Three gloo gangs of the port run at once, each rank
with ``OMP_NUM_THREADS=1``, beside JAX's references, which run on threads of
their own in this process on meshes of the same shape over the virtual CPU
devices. Each rank of a ``context 2 × model 2`` gang holds one window of its
rows (a ``ProcessRing`` over the ranks of its model index) and its model
blocks: ``H/2`` query heads, ``Hkv/2`` kv heads, ``F/2`` columns and ``V/2``
vocabulary rows.

- The gang of 4 on ``context 2 × model 2``: Llama's ``loss_fn`` and every
  gradient under ``cp_impl`` "pallas" (the plain step versions of B9/B10),
  "xla" and "ulysses", and "ulysses" at 6 heads (3 a rank, which the
  context degree 2 does not split: the port gathers the model line's heads,
  JAX splits all 6); Mixtral "ragged" with its router losses; 3 train steps
  of each with the clip active, Llama's "pallas" steps saved; ``accum_steps``
  2; the capacity dispatches ``gather`` and ``dense`` (``moe_ffn`` and
  3 Mixtral steps); the ``pretrain`` and ``pretrain_mixtral`` entries with
  ``--context_axis 2 --model_axis 2``.
- The gang of 8 on ``data 2 × context 2 × model 2`` (1 layer): 3 Llama
  steps ("xla"), and 3 Mixtral steps on packed rows ("pallas") with
  ``accum_steps`` 2 (the trainer's slot groups of every (context, model)
  line).
- The gang of 2 on ``context 2``: ``gather`` and ``dense`` (``moe_ffn`` and
  3 Mixtral steps), then the gang of 4's save restored onto ``context 2``
  and onto ``model 2``.

The references: JAX's ``loss_fn`` and gradients, ``sharded_init`` +
``make_train_step``, and ``moe_ffn`` on whole rows, over a JAX mesh of the
same shape, except where the port runs "pallas": JAX's Pallas ring runs in
TPU-interpret mode at ~100 s a case (``tests/test_torch_cp.py`` holds the
port's "pallas" to it in one process), so those cases are held to JAX's
"xla" ring on the same mesh, and the packed rows, which only "pallas"
composes with a context axis, to JAX without one. The capacity cases use a ``capacity_factor`` at
which some choices drop, so a slot taken from a window's own count instead
of the whole row's k-major order moves the output.

Tolerances, as ``tests/test_torch_tp.py``'s and ``test_torch_cp_gang.py``'s:
the loss, the router losses, each step's loss and grad norm and the dropped
fraction 1e-5 relative; each gradient leaf and each final parameter 1e-4 in
relative norm (f32 sums in another order); ``moe_ffn``'s output and
gradients 1e-4 in relative norm; a restore bit for bit; the entries, whose
tiny presets run in bf16, 2e-3 relative against one process.
"""

import concurrent.futures
import dataclasses
import functools
import json
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
from tony_tpu.models import mixtral as JM  # noqa: E402
from tony_tpu.parallel import expert as JE  # noqa: E402
from tony_tpu.parallel.mesh import MeshSpec as JMeshSpec  # noqa: E402
from tony_tpu.train import trainer as JT  # noqa: E402
from tony_tpu_torch.models import llama as TL  # noqa: E402
from tony_tpu_torch.models import mixtral as TM  # noqa: E402
from tony_tpu_torch.train import checkpoint as TC  # noqa: E402
from tony_tpu_torch.train import loop as TLp  # noqa: E402
from tony_tpu_torch.train import trainer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=3, grad_clip=0.5)
B, T, STEPS = 8, 32, 3
REL, LEAF_REL = 1e-5, 1e-4
#: the entries' bf16 runs against one process: about half a bf16 ulp (2^-8)
ENTRY_REL = 2e-3
#: the configs by name: the tiny models in f32, Llama at 6 heads, the 1-layer
#: models of the gang of 8, Mixtral's capacity dispatches at a factor that drops
CFGS = {
    "llama": ("llama", {}),
    "llama6": ("llama", dict(d_model=48, n_heads=6, n_kv_heads=2)),
    "llama1": ("llama", dict(n_layers=1)),
    "mixtral": ("mixtral", {}),
    "mixtral1": ("mixtral", dict(n_layers=1)),
    "gather": ("mixtral", dict(n_layers=1, moe_dispatch="gather", capacity_factor=1.0)),
    "dense": ("mixtral", dict(n_layers=1, moe_dispatch="dense", capacity_factor=1.0)),
}
FFN = dict(E=4, D=16, F=8, capacity_factor=0.75)  # moe_ffn's own case: B x T rows of D, F/2 a model rank
KEYS = {"llama": ("loss", "grad_norm"), "mixtral": ("loss", "ce_loss", "moe_balance_loss", "moe_z_loss", "grad_norm")}
ENTRY = ["--device", "cpu", "--preset", "tiny", "--context_axis", "2", "--steps", "2", "--batch_size", "4",
         "--seq_len", "16", "--log_every", "1", "--warmup_steps", "1"]

_COMMON = """
import dataclasses, functools, os, sys, time, numpy as np, torch
import torch.distributed as dist
from tony_tpu_torch.models import llama, mixtral
from tony_tpu_torch.models.convert import blocks_from_numpy
from tony_tpu_torch.parallel import expert
from tony_tpu_torch.parallel.mesh import MeshSpec, context_window, model_group
from tony_tpu_torch.parallel.sharding import Layout, shard
from tony_tpu_torch.runtime import init_distributed, shutdown_distributed
from tony_tpu_torch.train import trainer as TT
from tony_tpu_torch.train.checkpoint import CheckpointManager, restore_or_init

MODELS = {"llama": llama, "mixtral": mixtral}


def cfg_of(name, **kw):
    family, extra = CFGS[name]
    return dataclasses.replace(MODELS[family].PRESETS["tiny"], dtype="float32", **extra, **kw)


def rows_of(batch, mesh):
    # this rank's rows: those of its data x fsdp index (a context or model line shares them)
    rows = batch["tokens"].shape[0] // (mesh.shape["data"] * mesh.shape["fsdp"])
    k = dist.get_rank() // (mesh.shape["expert"] * mesh.shape["context"] * mesh.shape["model"])
    return {n: v[k * rows:(k + 1) * rows] for n, v in batch.items()}


def where(npp, rules, mesh):
    # each leaf's block on this rank, as indices into the whole leaf's flat elements
    out = {}
    for name, a in leaves(npp):
        out[name] = shard(torch.arange(a.size).reshape(a.shape), rules.spec_for(name), mesh)
    return {"index": out, "model": mesh.axis_index("model")}


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def loss_and_grads(mesh, npp, batch, name, cp_impl):
    # this rank's loss weighed by its share n_r / N of the targets and its
    # blocks' gradients: summed over the ranks of a model index, the global ones
    family = CFGS[name][0]
    model, cfg = MODELS[family], cfg_of(name, cp_impl=cp_impl)
    params = blocks_from_numpy(npp, model.sharding_rules(cfg), mesh, "cpu")
    names, tensors = zip(*TT._leaves(params))
    for t in tensors:
        t.requires_grad_(True)
    kw = {"group": mesh.group} if family == "mixtral" else {}
    loss, aux = model.loss_fn(params, rows_of(batch, mesh), cfg, mesh, **kw)
    n = aux["tokens"].float()
    total = n.clone()
    dist.all_reduce(total, group=mesh.group)
    weighed = loss * n / total
    out = {"loss": weighed.detach(), "grads": dict(zip(names, torch.autograd.grad(weighed, tensors))),
           **where(npp, model.sharding_rules(cfg), mesh)}
    out.update({k: float(aux[k]) for k in ("moe_balance_loss", "moe_z_loss") if k in aux})
    return out


def train(mesh, npp, batches, name, cp_impl="xla", accum=1):
    # 3 steps from the seeded weights on this rank's rows: the metrics and the blocks
    family = CFGS[name][0]
    model, cfg = MODELS[family], cfg_of(name, cp_impl=cp_impl)
    rules = model.sharding_rules(cfg)
    opt = TT.OptimizerConfig(**OPT).build()
    state = TT.TrainState.create(blocks_from_numpy(npp, rules, mesh, "cpu"), opt, Layout(rules, mesh))
    step = TT.make_train_step(functools.partial(model.loss_fn, cfg=cfg, mesh=mesh), opt, accum_steps=accum,
                              group=mesh.group, mesh=mesh)
    log = []
    for b in batches:
        state, m = step(state, rows_of(b, mesh))
        log.append({k: float(v) for k, v in m.items() if k != "step"})
    return {"log": log, "params": {n: t.detach().clone() for n, t in TT._leaves(state.params)},
            **where(npp, rules, mesh)}, state


def ffn(mesh, data, dispatch):
    # moe_ffn on this rank's window of the rows and F/model columns: y, the
    # gradients of (y * ct).sum(), the aux
    x, router, wg, wu, wd, ct, mask = (torch.from_numpy(data["ffn"][k]) for k in
                                       ("x", "router", "wg", "wu", "wd", "ct", "mask"))
    lo, hi = context_window(mesh, x.shape[1])
    m, M = mesh.axis_index("model"), mesh.shape["model"]
    F = wg.shape[-1] // M
    x = x[:, lo:hi].clone().requires_grad_(True)
    ws = [w.clone().requires_grad_(True) for w in (router, wg[..., m * F:(m + 1) * F], wu[..., m * F:(m + 1) * F],
                                                   wd[:, m * F:(m + 1) * F])]
    cfg = expert.MoEConfig(num_experts=wg.shape[0], top_k=2, capacity_factor=FFN["capacity_factor"], dispatch=dispatch)
    y, aux = expert.moe_ffn(x, *ws, cfg, mesh, token_mask=mask[:, lo:hi], group=mesh.group)
    grads = torch.autograd.grad((y * ct[:, lo:hi]).sum(), [x, *ws])
    return {"y": y.detach(), "grads": [g.detach() for g in grads], "window": (lo, hi), "model": m,
            "aux": {k: float(v) for k, v in aux.items()}}
"""

# the gang of 4 on context 2 x model 2
_GANG4 = """
inp, out, ckpt, port, port2 = sys.argv[1:6]
data = torch.load(inp, weights_only=False)
init_distributed(torch.device("cpu"))
mesh = MeshSpec(context=2, model=2).build("cpu")
res = {"group": dist.get_process_group_ranks(mesh.group), "model_line": dist.get_process_group_ranks(model_group(mesh)),
       "context_line": dist.get_process_group_ranks(mesh.context_line),
       "replicas": dist.get_process_group_ranks(mesh.replicas),
       "window": context_window(mesh, 32), "ring": (type(mesh.ring).__name__, mesh.ring.n, mesh.ring.positions)}
for impl in ("pallas", "xla", "ulysses"):
    res["loss_llama_" + impl] = loss_and_grads(mesh, data["llama"], data["plain"][0], "llama", impl)
res["loss_llama6_ulysses"] = loss_and_grads(mesh, data["llama6"], data["plain"][0], "llama6", "ulysses")
res["loss_mixtral_ragged"] = loss_and_grads(mesh, data["mixtral"], data["plain"][0], "mixtral", "xla")
for impl in ("xla", "ulysses"):
    res["train_llama_" + impl] = train(mesh, data["llama"], data["plain"], "llama", impl)[0]
res["train_llama_pallas"], state = train(mesh, data["llama"], data["plain"], "llama", "pallas")
mgr = CheckpointManager(ckpt, group=mesh.gang)
mgr.save(STEPS, state.state_dict())
mgr.close()
res["train_mixtral_ragged"] = train(mesh, data["mixtral"], data["plain"], "mixtral")[0]
res["accum2_llama"] = train(mesh, data["llama"], data["plain"], "llama", accum=2)[0]
for d in ("gather", "dense"):
    res["ffn_" + d] = ffn(mesh, data, d)
    res["train_" + d] = train(mesh, data["mixtral1"], data["plain"], d)[0]
shutdown_distributed()
from tony_tpu_torch.train import pretrain, pretrain_mixtral
os.environ["MASTER_PORT"] = port  # a fresh rendezvous: this one's store lives while its groups do
pretrain.main(ENTRY + ["--model_axis", "2"])  # leaves the group at its end
print("== mixtral entry ==", flush=True)
os.environ["MASTER_PORT"] = port2
pretrain_mixtral.main(ENTRY + ["--model_axis", "2"])
torch.save(res, out)
"""

# the gang of 8 on data 2 x context 2 x model 2
_GANG8 = """
inp, out = sys.argv[1:3]
data = torch.load(inp, weights_only=False)
init_distributed(torch.device("cpu"))
mesh = MeshSpec(data=2, context=2, model=2).build("cpu")
res = {"group": dist.get_process_group_ranks(mesh.group), "replicas": dist.get_process_group_ranks(mesh.replicas),
       "context_line": dist.get_process_group_ranks(mesh.context_line)}
res["train_llama1"] = train(mesh, data["llama1"], data["plain"], "llama1")[0]
res["accum2_mixtral1"] = train(mesh, data["mixtral1"], data["packed"], "mixtral1", "pallas", accum=2)[0]
shutdown_distributed()
torch.save(res, out)
"""

# the gang of 2 on context 2, then the gang of 4's save restored onto context 2 and model 2
_GANG2 = """
inp, out, ckpt = sys.argv[1:4]
data = torch.load(inp, weights_only=False)
init_distributed(torch.device("cpu"))
mesh = MeshSpec(context=2).build("cpu")
res = {}
for d in ("gather", "dense"):
    res["ffn_" + d] = ffn(mesh, data, d)
    res["train_" + d] = train(mesh, data["mixtral1"], data["plain"], d)[0]
deadline = time.time() + 250
while not os.path.isdir(os.path.join(ckpt, str(STEPS))) and time.time() < deadline:
    time.sleep(0.2)
cfg = cfg_of("llama", cp_impl="pallas")
opt = TT.OptimizerConfig(**OPT).build()
init = functools.partial(llama.init, torch.Generator().manual_seed(1), cfg, "cpu")  # not the saved values
for spec in (MeshSpec(context=2), MeshSpec(model=2)):
    m = spec.build("cpu")
    st, _, start = restore_or_init(ckpt, lambda: TT.sharded_init(init, llama.sharding_rules(cfg), m, opt),
                                   TT.TrainState.load, group=m.gang)
    res["restored_" + ("context" if spec.context > 1 else "model")] = {
        "start": start, "params": {n: t.detach().clone() for n, t in TT._leaves(st.params)},
        **where(data["llama"], llama.sharding_rules(cfg), m)}
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
    them, asserts each exited 0 and returns their outputs."""
    port = _free_port()
    procs = []
    head = f"ENTRY = {ENTRY!r}\nSTEPS = {STEPS}\nCFGS = {CFGS!r}\nFFN = {FFN!r}\nOPT = {OPT!r}\n"
    for rank in range(n):
        env = dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        env.pop("TONY_TRAIN_METRICS_FILE", None)
        procs.append(subprocess.Popen([sys.executable, "-c", head + _COMMON + script,
                                       *[a.format(rank=rank) for a in args]], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def finish() -> list[str]:
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
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


def _jcfg(name: str, cp_impl: str = "xla"):
    family, extra = CFGS[name]
    base = {"llama": JL.LLAMA_TINY, "mixtral": JM.MIXTRAL_TINY}[family]
    return dataclasses.replace(base, dtype="float32", cp_impl=cp_impl, **extra)


def _jmesh(spec):
    return spec.build(devices=jax.devices()[:int(np.prod(list(spec.axis_sizes.values())))])


def _jax_loss(npp, batch, name, cp_impl, spec):
    """JAX's ``loss_fn`` value, aux and gradient on ``spec``'s mesh."""
    model, cfg = (JL if CFGS[name][0] == "llama" else JM), _jcfg(name, cp_impl)
    fn = jax.jit(jax.value_and_grad(functools.partial(model.loss_fn, cfg=cfg, mesh=_jmesh(spec)), has_aux=True))
    (loss, aux), grads = fn(jax.tree.map(jnp.asarray, npp), {k: jnp.asarray(v) for k, v in batch.items()})
    return {"loss": float(loss), "aux": {k: float(v) for k, v in aux.items()},
            "grads": dict(_leaves(jax.tree.map(np.asarray, grads)))}


def _jax_train(npp, batches, name, cp_impl, spec, accum=1):
    """JAX's ``sharded_init`` + ``make_train_step`` on ``spec``'s mesh: each
    step's metrics and the final parameters."""
    model, cfg = (JL if CFGS[name][0] == "llama" else JM), _jcfg(name, cp_impl)
    mesh = _jmesh(spec)
    opt = JT.OptimizerConfig(**OPT).build()
    state = JT.sharded_init(lambda: jax.tree.map(jnp.asarray, npp), model.sharding_rules(cfg), mesh, opt)
    step = JT.make_train_step(functools.partial(model.loss_fn, cfg=cfg, mesh=mesh), opt, accum_steps=accum)
    log = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        log.append({k: float(v) for k, v in m.items() if k != "step"})
    return log, dict(_leaves(jax.tree.map(np.asarray, state.params)))


def _jax_ffn(f: dict, dispatch: str):
    """JAX's ``moe_ffn`` on the whole rows: y, the gradients of
    ``(y * ct).sum()`` and the aux."""
    cfg = JE.MoEConfig(num_experts=FFN["E"], top_k=2, capacity_factor=FFN["capacity_factor"], dispatch=dispatch)
    mask = jnp.asarray(f["mask"])

    def run(x, *ws):
        y, aux = JE.moe_ffn(x, *ws, cfg, None, token_mask=mask)
        return (y * f["ct"]).sum(), (y, aux)

    args = [jnp.asarray(f[k]) for k in ("x", "router", "wg", "wu", "wd")]
    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(run, argnums=tuple(range(5)), has_aux=True))(*args)
    return {"y": np.asarray(y), "grads": [np.asarray(g) for g in grads], "aux": {k: float(v) for k, v in aux.items()}}


def _jax_references(npp: dict, plain: list, packed: list, f: dict) -> dict:
    c2, c2m2, d2c2m2 = JMeshSpec(context=2), JMeshSpec(context=2, model=2), JMeshSpec(data=2, context=2, model=2)
    d2m2 = JMeshSpec(data=2, model=2)
    jobs = {
        "loss_llama_xla": lambda: _jax_loss(npp["llama"], plain[0], "llama", "xla", c2m2),
        "loss_llama_ulysses": lambda: _jax_loss(npp["llama"], plain[0], "llama", "ulysses", c2m2),
        "loss_llama6_ulysses": lambda: _jax_loss(npp["llama6"], plain[0], "llama6", "ulysses", c2m2),
        "loss_mixtral_ragged": lambda: _jax_loss(npp["mixtral"], plain[0], "mixtral", "xla", c2m2),
        "train_llama_xla": lambda: _jax_train(npp["llama"], plain, "llama", "xla", c2m2),
        "train_llama_ulysses": lambda: _jax_train(npp["llama"], plain, "llama", "ulysses", c2m2),
        "train_mixtral_ragged": lambda: _jax_train(npp["mixtral"], plain, "mixtral", "xla", c2m2),
        "accum2_llama": lambda: _jax_train(npp["llama"], plain, "llama", "xla", c2m2, accum=2),
        "ffn_gather": lambda: _jax_ffn(f, "gather"),
        "ffn_dense": lambda: _jax_ffn(f, "dense"),
        "c2_gather": lambda: _jax_train(npp["mixtral1"], plain, "gather", "xla", c2),
        "c2_dense": lambda: _jax_train(npp["mixtral1"], plain, "dense", "xla", c2),
        "c2m2_gather": lambda: _jax_train(npp["mixtral1"], plain, "gather", "xla", c2m2),
        "c2m2_dense": lambda: _jax_train(npp["mixtral1"], plain, "dense", "xla", c2m2),
        "train_llama1": lambda: _jax_train(npp["llama1"], plain, "llama1", "xla", d2c2m2),
        # packed rows compose with a context axis only through "pallas": the same function without one
        "accum2_mixtral1": lambda: _jax_train(npp["mixtral1"], packed, "mixtral1", "xla", d2m2, accum=2),
    }
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def _seeded_weights(seed: int, name: str) -> dict:
    """A tiny f32 model's weights as a numpy tree, drawn by the port's seeded
    init, handed to JAX and to the port alike."""
    family, extra = CFGS[name]
    model = {"llama": TL, "mixtral": TM}[family]
    cfg = dataclasses.replace(model.PRESETS["tiny"], dtype="float32", **extra)
    tree = model.init(torch.Generator().manual_seed(seed), cfg, "cpu")
    return {k: {n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def _ffn_inputs(rng) -> dict:
    """``moe_ffn``'s case: x [4, 32, D] and its weights, a cotangent, and a
    mask that pads the tail of the last two rows (in the second window)."""
    E, D, F = FFN["E"], FFN["D"], FFN["F"]
    mask = np.ones((4, T), bool)
    mask[2:, T - 6:] = False
    n = rng.standard_normal
    return {"x": n((4, T, D)).astype(np.float32), "router": (n((D, E)) / np.sqrt(D)).astype(np.float32),
            "wg": (n((E, D, F)) / np.sqrt(D)).astype(np.float32), "wu": (n((E, D, F)) / np.sqrt(D)).astype(np.float32),
            "wd": (n((E, F, D)) / np.sqrt(F)).astype(np.float32), "ct": n((4, T, D)).astype(np.float32), "mask": mask}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _batches(rng, packed: bool) -> list[dict]:
    """``STEPS`` batches [B, T+1]; packed: two segments a row and rows B/2..
    ending in padding, so the windows and the data shards hold unequal
    target counts."""
    out = []
    for _ in range(STEPS):
        b = {"tokens": rng.integers(0, 256, (B, T + 1))}
        if packed:
            seg = np.ones((B, T + 1), np.int32)
            for r in range(B):
                seg[r, rng.integers(4, T - 4):] = 2
                if r >= B // 2:
                    seg[r, T + 1 - rng.integers(10, 21):] = 0
            b["segment_ids"] = seg
        out.append(b)
    return out


def _step_lines(out: str) -> list[dict]:
    """The JSON step reports a rank's loop printed."""
    return [json.loads(line) for line in out.splitlines() if line.startswith("{") and '"loss"' in line]


def _rel(got, want) -> float:
    got, want = torch.as_tensor(np.asarray(got)).double(), torch.as_tensor(np.asarray(want)).double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _join(ranks: list, key: str, part: str, shapes: dict, summed: bool) -> dict:
    """Each leaf whole from the ranks' blocks of ``ranks[i][key][part]``
    (placed by their ``index``). ``summed``: the gradients, partial over the
    windows, summed over the ranks of one model index (a leaf the model axis
    leaves whole has its whole gradient on every model rank: model index 0's
    are taken); else the blocks written in place (replicas agree)."""
    out = {}
    for name, shape in shapes.items():
        whole = torch.zeros(int(np.prod(shape)), dtype=torch.float64)
        for r in ranks:
            rec = r[key]
            idx, blk = rec["index"][name].reshape(-1), rec[part][name].reshape(-1).double()
            if not summed:
                whole[idx] = blk
            elif idx.numel() < whole.numel() or rec["model"] == 0:
                whole.index_add_(0, idx, blk)
        out[name] = whole.reshape(shape)
    return out


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """The gangs of 4, 8 and 2, started together, beside JAX's references on
    the same weights and inputs; the one-process restore of the gang of 4's
    save; the entries' one-process runs with a context of 2."""
    d = tmp_path_factory.mktemp("cp_tp")
    npp = {name: _seeded_weights(3, name) for name in ("llama", "llama6", "llama1", "mixtral", "mixtral1")}
    rng = np.random.default_rng(7)
    plain, packed, f = _batches(rng, False), _batches(rng, True), _ffn_inputs(rng)
    torch.save({**npp, "ffn": f, "plain": [{k: torch.from_numpy(v) for k, v in b.items()} for b in plain],
                "packed": [{k: torch.from_numpy(v) for k, v in b.items()} for b in packed]}, d / "in.pt")
    ckpt = d / "ckpt"
    finish4 = _start(_GANG4, 4, [str(d / "in.pt"), str(d / "r4_{rank}.pt"), str(ckpt), str(_free_port()),
                                 str(_free_port())])
    finish8 = _start(_GANG8, 8, [str(d / "in.pt"), str(d / "r8_{rank}.pt")])
    finish2 = _start(_GANG2, 2, [str(d / "in.pt"), str(d / "r2_{rank}.pt"), str(ckpt)])
    jax_runs = _one_thread(lambda: _jax_references(npp, plain, packed, f))
    outs4 = finish4()
    finish8()
    finish2()
    cfg = dataclasses.replace(TL.LLAMA_TINY, dtype="float32")
    restored = TC.restore_or_init(str(ckpt), lambda: TT.TrainState.create(
        TL.init(torch.Generator().manual_seed(1), cfg, "cpu"), TT.OptimizerConfig(**OPT).build()), TT.TrainState.load)
    entries = {}
    for name, model in (("llama", TL), ("mixtral", TM)):
        loop, extra = TLp.parse_loop_args(ENTRY)
        entries[name] = _one_thread(lambda: TLp.run_lm_training(model, TLp.model_config(model, extra), loop))["log"]
    shapes = {name: {n: a.shape for n, a in _leaves(tree)} for name, tree in npp.items()}
    return {"r4": [torch.load(d / f"r4_{r}.pt", weights_only=False) for r in range(4)],
            "r8": [torch.load(d / f"r8_{r}.pt", weights_only=False) for r in range(8)],
            "r2": [torch.load(d / f"r2_{r}.pt", weights_only=False) for r in range(2)],
            "jax": jax_runs, "restored": restored, "entry_out": outs4, "entries": entries, "shapes": shapes,
            "ckpt": ckpt}


def test_the_gang_lays_the_context_ring_on_each_model_line(gangs):
    """``context 2 × model 2``: ``model`` varies fastest, as in JAX's
    ``ALL_AXES``; each rank's ring is the ranks of its model index (so KV
    of the same ``Hkv/2`` heads moves between them), its ``group`` the same
    line, its model line the two ranks of its window; ``data 2 × context 2 ×
    model 2`` adds the data ranks to the group and the replicas."""
    r4, r8 = gangs["r4"], gangs["r8"]
    assert [r["model_line"] for r in r4] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert [r["context_line"] for r in r4] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert [r["group"] for r in r4] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert [r["ring"] for r in r4] == [("ProcessRing", 2, (0,)), ("ProcessRing", 2, (0,)),
                                       ("ProcessRing", 2, (1,)), ("ProcessRing", 2, (1,))]
    assert [r["window"] for r in r4] == [(0, 16), (0, 16), (16, 32), (16, 32)]
    assert [r["replicas"] for r in r4] == [r["context_line"] for r in r4]
    assert [r["group"] for r in r8] == [[0, 2, 4, 6], [1, 3, 5, 7]] * 4
    assert [r["replicas"] for r in r8] == [[0, 2, 4, 6], [1, 3, 5, 7]] * 4
    assert [r["context_line"] for r in r8] == [[0, 2], [1, 3]] * 2 + [[4, 6], [5, 7]] * 2


def _assert_loss(gangs, case: str, name: str, want: dict):
    ranks = gangs["r4"]
    by_line = {}
    for r in ranks:
        by_line.setdefault(r[case]["model"], []).append(float(r[case]["loss"]))
    for m, losses in by_line.items():  # every model line's windows sum to the loss
        assert abs(sum(losses) - want["loss"]) <= REL * abs(want["loss"]), (case, m, losses, want["loss"])
    got = _join(ranks, case, "grads", gangs["shapes"][name], summed=True)
    for leaf, ref in want["grads"].items():
        assert _rel(got[leaf], ref) < LEAF_REL, (case, leaf, _rel(got[leaf], ref))


@pytest.mark.parametrize("case,name,ref", [
    ("loss_llama_pallas", "llama", "loss_llama_xla"), ("loss_llama_xla", "llama", "loss_llama_xla"),
    ("loss_llama_ulysses", "llama", "loss_llama_ulysses"), ("loss_llama6_ulysses", "llama6", "loss_llama6_ulysses"),
    ("loss_mixtral_ragged", "mixtral", "loss_mixtral_ragged")])
def test_context_2_model_2_gives_jaxs_loss_and_every_gradient(gangs, case, name, ref):
    """Each rank's window on its model blocks: the two windows' weighed
    losses of every model line sum to JAX's loss on a ``context 2 × model
    2`` mesh, and the blocks' gradients, summed over the windows and joined
    over the model line, are every one of JAX's gradient leaves: the ring on
    the local heads ("pallas", "xla"), Ulysses on them ("ulysses", 2 heads a
    rank over a context of 2) or on the model line's gathered heads (6
    heads: 3 a rank), and Mixtral's experts on ``F/2`` with JAX's router
    losses on every rank."""
    want = gangs["jax"][ref]
    _assert_loss(gangs, case, name, want)
    if name == "mixtral":
        for r in gangs["r4"]:
            for k in ("moe_balance_loss", "moe_z_loss"):
                assert abs(r[case][k] - want["aux"][k]) <= REL * abs(want["aux"][k]), (k, r[case][k])


def _assert_train(ranks: list, case: str, name: str, want: tuple, keys: tuple, shapes: dict):
    jlog, jparams = want
    for rank, r in enumerate(ranks):
        log = r[case]["log"]
        assert len(log) == len(jlog) == STEPS, case
        for got, ref in zip(log, jlog):
            for k in keys:
                assert abs(got[k] - ref[k]) <= REL * abs(ref[k]), (case, rank, k, got[k], ref[k])
    params = _join(ranks, case, "params", shapes[name], summed=False)
    for leaf, ref in jparams.items():
        assert _rel(params[leaf], ref) < LEAF_REL, (case, leaf, _rel(params[leaf], ref))


@pytest.mark.parametrize("case,name,ref", [
    ("train_llama_pallas", "llama", "train_llama_xla"), ("train_llama_xla", "llama", "train_llama_xla"),
    ("train_llama_ulysses", "llama", "train_llama_ulysses"), ("train_mixtral_ragged", "mixtral", "train_mixtral_ragged")])
def test_context_2_model_2_trains_as_jaxs_sharded_step_with_the_clip_active(gangs, case, name, ref):
    """3 steps on ``context 2 × model 2``: every rank's loss and grad norm
    (Mixtral's router losses) are JAX's sharded step's, with the norm over
    the clip at every step (so a norm that counted a context replica twice
    would move every later step), and the joined final blocks are JAX's
    parameters. A rank's ``ce_loss`` is its window's, so the windows' mean
    is compared."""
    keys = KEYS[CFGS[name][0]]
    ranks = gangs["r4"]
    if name == "mixtral":
        ce = [np.mean([r[case]["log"][i]["ce_loss"] for r in ranks]) for i in range(STEPS)]
        ranks = [{case: {**r[case], "log": [{**x, "ce_loss": c} for x, c in zip(r[case]["log"], ce)]}}
                 for r in ranks]
    assert all(x["grad_norm"] > OPT["grad_clip"] for x in gangs["jax"][ref][0])
    _assert_train(ranks, case, name, gangs["jax"][ref], keys, gangs["shapes"])


@pytest.mark.parametrize("case,name,gang", [("train_llama1", "llama1", "r8"), ("accum2_mixtral1", "mixtral1", "r8"),
                                            ("accum2_llama", "llama", "r4")])
def test_a_data_axis_and_accumulation_beside_context_and_model_train_as_jax(gangs, case, name, gang):
    """The gang of 8 on ``data 2 × context 2 × model 2`` ("xla", 1 layer):
    3 Llama steps, and 3 Mixtral steps on packed rows through "pallas" with
    ``accum_steps`` 2 (a microbatch a data index: the trainer's slot groups
    of every (context, model) line pool its router losses; held to JAX on
    ``data 2 × model 2``, the same function: packed rows compose with a
    context axis only through the ring kernels); and ``accum_steps`` 2 on ``context 2
    × model 2``, each rank accumulating both microbatches of its window:
    JAX's ``make_train_step`` on a mesh of the same shape."""
    keys = ("loss", "grad_norm")
    _assert_train(gangs[gang], case, name, gangs["jax"][case], keys, gangs["shapes"])


@pytest.mark.parametrize("gang", ["r2", "r4"])
@pytest.mark.parametrize("dispatch", ["gather", "dense"])
def test_the_capacity_dispatches_take_the_whole_rows_slots_in_a_context_gang(gangs, dispatch, gang):
    """``moe_ffn``'s ``gather`` and ``dense`` on each window (``context 2``,
    and ``context 2 × model 2`` on ``F/2``), with a capacity at which some
    choices drop and padded tails: each window's output and input gradient
    are JAX's on the whole rows, the router's and experts' gradients summed
    over the windows (joined over the model line) are JAX's, and the
    dropped fraction is JAX's on every rank."""
    want = gangs["jax"]["ffn_" + dispatch]
    assert want["aux"]["moe_dropped_frac"] > 0.05, want["aux"]
    ranks = [r["ffn_" + dispatch] for r in gangs[gang]]
    F = FFN["F"] // (2 if gang == "r4" else 1)
    for r in ranks:
        lo, hi = r["window"]
        assert _rel(r["y"], want["y"][:, lo:hi]) < LEAF_REL and _rel(r["grads"][0], want["grads"][0][:, lo:hi]) < LEAF_REL
        for k in ("moe_dropped_frac", "moe_balance_loss", "moe_z_loss"):
            assert abs(r["aux"][k] - want["aux"][k]) <= REL * abs(want["aux"][k]), (k, r["aux"][k], want["aux"][k])
    router = sum(r["grads"][1] for r in ranks if r["model"] == 0)
    assert _rel(router, want["grads"][1]) < LEAF_REL
    for i, dim in ((2, -1), (3, -1), (4, 1)):
        joined = [sum(r["grads"][i] for r in ranks if r["model"] == m) for m in sorted({r["model"] for r in ranks})]
        got = torch.cat(joined, dim) if len(joined) > 1 else joined[0]
        assert got.shape[dim] == FFN["F"] and joined[0].shape[dim] == F
        assert _rel(got, want["grads"][i]) < LEAF_REL, (dispatch, gang, i)


@pytest.mark.parametrize("gang,ref", [("r2", "c2"), ("r4", "c2m2")])
@pytest.mark.parametrize("dispatch", ["gather", "dense"])
def test_the_capacity_dispatches_train_as_jax_in_a_context_gang(gangs, dispatch, gang, ref):
    """3 Mixtral steps (1 layer, ``capacity_factor`` 1.0, choices dropped at
    every step) through ``gather`` and ``dense`` on ``context 2`` and
    ``context 2 × model 2``: every rank's loss, router losses, dropped
    fraction and grad norm are JAX's on a mesh of the same shape, and the
    joined final blocks are JAX's parameters."""
    want = gangs["jax"][f"{ref}_{dispatch}"]
    assert all(x["moe_dropped_frac"] > 0.01 for x in want[0])
    ranks = gangs[gang]
    case = "train_" + dispatch
    ce = [np.mean([r[case]["log"][i]["ce_loss"] for r in ranks]) for i in range(STEPS)]
    ranks = [{case: {**r[case], "log": [{**x, "ce_loss": c} for x, c in zip(r[case]["log"], ce)]}} for r in ranks]
    _assert_train(ranks, case, "mixtral1", want, KEYS["mixtral"] + ("moe_dropped_frac",), gangs["shapes"])


def test_a_context_2_model_2_save_restores_into_one_process_and_onto_context_2_and_model_2(gangs):
    """The gang of 4's step-3 "pallas" state (DCP: each block held by its
    model rank of the context line, written once) restores into one process
    as the blocks the ranks held, bit for bit, and onto ``context 2`` (whole
    leaves) and ``model 2`` (the model blocks) as the same bits."""
    r4, r2 = gangs["r4"], gangs["r2"]
    one, _, step = gangs["restored"]
    assert step == STEPS
    whole = {n: t.detach() for n, t in TT._leaves(one.params)}
    for r in r4:
        rec = r["train_llama_pallas"]
        for name, blk in rec["params"].items():
            assert torch.equal(blk.reshape(-1), whole[name].reshape(-1)[rec["index"][name].reshape(-1)]), name
    for key in ("restored_context", "restored_model"):
        for r in r2:
            rec = r[key]
            assert rec["start"] == STEPS
            for name, blk in rec["params"].items():
                assert torch.equal(blk.reshape(-1), whole[name].reshape(-1)[rec["index"][name].reshape(-1)]), (key, name)
    # the step holds each leaf once: its files are the size of one whole state, not one a context replica
    files = sum(p.stat().st_size for p in (gangs["ckpt"] / str(STEPS)).rglob("*.distcp"))
    state = sum(t.numel() * t.element_size() for tree in (one.params, one.opt_state["mu"], one.opt_state["nu"])
                for _, t in TT._leaves(tree))
    assert state <= files < 1.5 * state, (files, state)


def test_the_pretrain_entries_run_context_2_model_2(gangs):
    """``pretrain`` and ``pretrain_mixtral`` with ``--context_axis 2
    --model_axis 2`` in the gang of 4 log the same losses and grad norms on
    every rank, and those of the same entries in one process with a context
    of 2 within ``ENTRY_REL``: the tiny presets run in bf16, whose
    activations the model split rounds at other points (the row-parallel
    partials are summed in f32, then rounded)."""
    lines = [_step_lines(out) for out in gangs["entry_out"]]
    for name, i in (("llama", slice(0, 2)), ("mixtral", slice(2, 4))):
        one = gangs["entries"][name]
        for rank, got in enumerate(lines):
            got = got[i]
            assert [x["step"] for x in got] == [1, 2], (name, rank)
            assert [(x["loss"], x["grad_norm"]) for x in got] == [(x["loss"], x["grad_norm"]) for x in lines[0][i]]
            for x, y in zip(got, one):
                for k in ("loss", "grad_norm"):
                    assert abs(x[k] - y[k]) <= ENTRY_REL * abs(y[k]), (name, rank, k, x[k], y[k])


def test_the_layouts_still_to_port_raise_by_their_roadmap_labels():
    """An expert axis beside a model or context axis (A11's rest), a stage
    axis (A13) and BERT on the model axis (A8b's second part) raise by name,
    in the mesh and in the loop; "pallas" beside a model axis that does not
    split the kv heads raises in JAX's words."""
    from tony_tpu_torch.models import bert
    from tony_tpu_torch.parallel.mesh import MeshSpec

    for kw, item in ((dict(expert=2, model=2), "A11"), (dict(expert=2, context=2), "A11"),
                     (dict(context=2, model=2, stage=2), "A13")):
        with pytest.raises(NotImplementedError, match=item):
            MeshSpec(**kw).build("cpu")
    tiny = dataclasses.replace(TL.LLAMA_TINY, dtype="float32")
    for kw, item in ((dict(expert_axis=2), "A11"), (dict(stage_axis=2), "A13")):
        with pytest.raises(NotImplementedError, match=item):
            TLp.run_lm_training(TL, tiny, TLp.LoopConfig(device="cpu", steps=1, context_axis=2, model_axis=2, **kw))
    with pytest.raises(NotImplementedError, match="A8b's second part"):
        TLp.run_lm_training(bert, bert.BERT_TINY, TLp.LoopConfig(device="cpu", steps=1, context_axis=2, model_axis=2))
    mesh = type("M", (), {"shape": {"stage": 1, "data": 1, "fsdp": 1, "expert": 1, "context": 2, "model": 2}})()
    with pytest.raises(ValueError, match="cp_impl='pallas' shards kv heads over 'model'.*n_kv_heads 1 must divide"):
        TL.check_model_axis(dataclasses.replace(tiny, n_kv_heads=1, cp_impl="pallas"), 2, mesh)
    with pytest.raises(ValueError, match="n_kv_heads 1"):
        TL.check_model_axis(dataclasses.replace(tiny, n_kv_heads=1, cp_impl="xla"), 2, mesh)
