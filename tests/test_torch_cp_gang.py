"""Context parallelism across a gloo gang on the CPU, against the JAX package.

Every run is in f32 on numpy inputs from a seed, handed to both packages
(weights bridged by ``models/convert.py``). Two gloo gangs of the port run at
once, each rank with ``OMP_NUM_THREADS=1``, beside JAX's references, which
run on threads of their own in this process, each on at most 4 of the 8
virtual CPU devices. Each rank holds one window of every row's sequence
(``MeshSpec(context=…)`` in a gang: a ``ProcessRing`` over its context line).

- The gang of 2 on ``context 2``: Llama's ``loss_fn`` and every gradient
  under ``cp_impl`` "xla", "pallas" (the plain step versions of B9/B10) and
  "ulysses", one packed batch through "pallas", and Mixtral's under "xla"
  with its router losses; 3 train steps of Llama through "pallas" and a
  save; the gang of 4's ``fsdp 2 × context 2`` step restored onto
  ``context 2``; the ``pretrain`` and ``pretrain_mixtral`` entries with
  ``--context_axis 2``.
- The gang of 4: 3 train steps on ``data 2 × context 2`` (Llama "xla",
  Mixtral "xla", and Llama "pallas" on packed batches with ``accum_steps``
  2 and 4), on ``fsdp 2 × context 2`` (Llama "ulysses", Mixtral "xla", then
  a sharded save), and Mixtral on ``data 2 × expert 2`` with
  ``accum_steps`` 2 (the trainer's slot groups without a context axis).

The references: JAX's ``loss_fn`` and gradients, and ``sharded_init`` +
``make_train_step``, over a JAX mesh of the same shape and ``cp_impl``,
except where the port runs "pallas": JAX's Pallas ring runs in TPU-interpret
mode at ~100 s a case (``tests/test_torch_cp.py``, which holds the port's
"pallas" to it in one process), so the "pallas" cases are held to JAX's
"xla" ring on the same mesh, and the packed ones, which only "pallas"
composes with a context axis, to JAX without a context axis (the same
function of the same inputs).

Tolerances, as ``tests/test_torch_cp.py``'s: the loss 1e-5 relative, each
gradient leaf 2e-4 in relative norm, the router losses 1e-5; each train
step's metrics 1e-5 relative and the final parameters 2e-4 in relative norm
a leaf (3 Adam steps of f32 sums in another order); a restore bit for bit.
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
LOSS_REL, LEAF_REL, STEP_REL, PARAM_REL = 1e-5, 2e-4, 1e-5, 2e-4
JCFG = {"llama": dataclasses.replace(JL.LLAMA_TINY, dtype="float32"),
        "mixtral": dataclasses.replace(JM.MIXTRAL_TINY, dtype="float32")}
JMODELS = {"llama": JL, "mixtral": JM}
KEYS = {"llama": ("loss", "grad_norm"), "mixtral": ("loss", "ce_loss", "moe_balance_loss", "moe_z_loss", "grad_norm")}
ACCUM_KEYS = ("loss", "grad_norm")  # a scan's metrics carry no aux, in both packages
ENTRY = ["--device", "cpu", "--preset", "tiny", "--context_axis", "2", "--steps", "2", "--batch_size", "4",
         "--seq_len", "16", "--log_every", "1", "--warmup_steps", "1"]

_COMMON = """
import dataclasses, functools, os, sys, time, torch
import torch.distributed as dist
from tony_tpu_torch.models import llama, mixtral
from tony_tpu_torch.models.convert import blocks_from_numpy, params_from_numpy
from tony_tpu_torch.parallel.collectives import ProcessRing
from tony_tpu_torch.parallel.mesh import MeshSpec, context_window
from tony_tpu_torch.parallel.sharding import Layout
from tony_tpu_torch.runtime import init_distributed, shutdown_distributed
from tony_tpu_torch.train import trainer as TT
from tony_tpu_torch.train.checkpoint import CheckpointManager, restore_or_init

MODELS = {"llama": llama, "mixtral": mixtral}
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=3, grad_clip=0.5)


def cfg_of(family, cp_impl):
    return dataclasses.replace(MODELS[family].PRESETS["tiny"], dtype="float32", cp_impl=cp_impl)


def rows_of(batch, mesh):
    # this rank's rows: those of its data x fsdp index (a context, expert or
    # model line shares them)
    rows = batch["tokens"].shape[0] // (mesh.shape["data"] * mesh.shape["fsdp"])
    k = dist.get_rank() // (mesh.shape["expert"] * mesh.shape["context"] * mesh.shape["model"])
    return {n: v[k * rows:(k + 1) * rows] for n, v in batch.items()}


def loss_and_grads(mesh, npp, batch, family, cp_impl):
    # this rank's loss weighed by its share n_r / N of the targets, and its
    # gradient: both summed over the ranks are the global loss and gradient
    model, cfg = MODELS[family], cfg_of(family, cp_impl)
    params = params_from_numpy(npp, "cpu")
    names, tensors = zip(*TT._leaves(params))
    for t in tensors:
        t.requires_grad_(True)
    kw = {"group": mesh.group} if family == "mixtral" else {}
    loss, aux = model.loss_fn(params, rows_of(batch, mesh), cfg, mesh, **kw)
    n = aux["tokens"].float()
    total = n.clone()
    dist.all_reduce(total, group=mesh.group)
    weighed = loss * n / total
    out = {"loss": weighed.detach(), "tokens": int(aux["tokens"]),
           "grads": dict(zip(names, torch.autograd.grad(weighed, tensors)))}
    out.update({k: aux[k].detach() for k in ("moe_balance_loss", "moe_z_loss") if k in aux})
    return out


def params_of(state):
    return {n: t.detach().clone() for n, t in TT._leaves(state.params)}


def train(mesh, npp, batches, family, cp_impl, accum=1):
    # 3 steps from the seeded weights on this rank's rows: the metrics and the state
    model, cfg = MODELS[family], cfg_of(family, cp_impl)
    rules = model.sharding_rules(cfg)
    opt = TT.OptimizerConfig(**OPT).build()
    state = TT.TrainState.create(blocks_from_numpy(npp, rules, mesh, "cpu"), opt, Layout(rules, mesh))
    step = TT.make_train_step(functools.partial(model.loss_fn, cfg=cfg, mesh=mesh), opt, accum_steps=accum,
                              group=mesh.group, mesh=mesh)
    log = []
    for b in batches:
        state, m = step(state, rows_of(b, mesh))
        log.append({k: float(v) for k, v in m.items() if k != "step"})
    return log, state
"""

# the gang of 2 on context 2
_GANG2 = """
inp, out, ckpt, ckpt4, port, port2 = sys.argv[1:7]
data = torch.load(inp, weights_only=False)
init_distributed(torch.device("cpu"))
mesh = MeshSpec(context=2).build("cpu")
res = {"ring": type(mesh.ring).__name__, "window": context_window(mesh, 32),
       "group": dist.get_process_group_ranks(mesh.group)}
for impl in ("xla", "pallas", "ulysses"):
    res["llama_" + impl] = loss_and_grads(mesh, data["llama"], data["plain"][0], "llama", impl)
res["llama_packed"] = loss_and_grads(mesh, data["llama"], data["packed"][0], "llama", "pallas")
res["mixtral_xla"] = loss_and_grads(mesh, data["mixtral"], data["plain"][0], "mixtral", "xla")
log, state = train(mesh, data["llama"], data["plain"], "llama", "pallas")
res["train"] = {"log": log, "params": params_of(state)}
mgr = CheckpointManager(ckpt, group=mesh.gang)
mgr.save(len(log), state.state_dict())
mgr.close()
deadline = time.time() + 200
while not os.path.isdir(os.path.join(ckpt4, "3")) and time.time() < deadline:
    time.sleep(0.2)
cfg = cfg_of("mixtral", "xla")
opt = TT.OptimizerConfig(**OPT).build()
init = functools.partial(mixtral.init, torch.Generator().manual_seed(1), cfg, "cpu")  # not the saved values
st, _, start = restore_or_init(ckpt4, lambda: TT.sharded_init(init, mixtral.sharding_rules(cfg), mesh, opt),
                               TT.TrainState.load, group=mesh.gang)
res["restored4"] = {"start": start, "params": params_of(st)}
shutdown_distributed()
from tony_tpu_torch.train import pretrain, pretrain_mixtral
os.environ["MASTER_PORT"] = port  # a fresh rendezvous: this one's store lives while its groups do
pretrain.main(ENTRY)  # leaves the group at its end
print("== mixtral entry ==", flush=True)
os.environ["MASTER_PORT"] = port2
pretrain_mixtral.main(ENTRY)
torch.save(res, out)
"""

# the gang of 4: data 2 x context 2, fsdp 2 x context 2 (a sharded save), data 2 x expert 2
_GANG4 = """
inp, out, ckpt = sys.argv[1:4]
data = torch.load(inp, weights_only=False)
init_distributed(torch.device("cpu"))
mesh = MeshSpec(data=2, context=2).build("cpu")
res = {"d2c2_group": dist.get_process_group_ranks(mesh.group),
       "d2c2_replicas": dist.get_process_group_ranks(mesh.replicas), "d2c2_window": context_window(mesh, 32)}
res["d2c2_llama"] = train(mesh, data["llama"], data["plain"], "llama", "xla")[0]
res["d2c2_accum2"] = train(mesh, data["llama"], data["packed"], "llama", "pallas", accum=2)[0]
res["d2c2_accum4"] = train(mesh, data["llama"], data["packed"], "llama", "pallas", accum=4)[0]
res["d2c2_mixtral"] = train(mesh, data["mixtral"], data["plain"], "mixtral", "xla")[0]
mesh = MeshSpec.auto(context=2).build("cpu")
res["f2c2_shape"] = {a: mesh.shape[a] for a in ("data", "fsdp", "context")}
res["f2c2_replicas"] = dist.get_process_group_ranks(mesh.replicas)
res["f2c2_llama"] = train(mesh, data["llama"], data["plain"], "llama", "ulysses")[0]
log, state = train(mesh, data["mixtral"], data["plain"], "mixtral", "xla")
res["f2c2_mixtral"] = log
res["f2c2_blocks"] = params_of(state)
res["f2c2_fsdp_index"] = mesh.axis_index("fsdp")
mgr = CheckpointManager(ckpt, group=mesh.gang)
mgr.save(len(log), state.state_dict())
mgr.close()
mesh = MeshSpec(data=2, expert=2).build("cpu")
res["d2e2_accum2"] = train(mesh, data["mixtral"], data["packed"], "mixtral", "xla", accum=2)[0]
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
    head = f"ENTRY = {ENTRY!r}\n"
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


def _devices(spec) -> list:
    return jax.devices()[:int(np.prod(list(spec.axis_sizes.values())))]


def _jax_loss(npp, batch, family, cp_impl, spec):
    """JAX's ``loss_fn`` value, aux and gradient on ``spec``'s mesh (None: no mesh)."""
    model, cfg = JMODELS[family], dataclasses.replace(JCFG[family], cp_impl=cp_impl)
    mesh = None if spec is None else spec.build(devices=_devices(spec))
    fn = jax.jit(jax.value_and_grad(functools.partial(model.loss_fn, cfg=cfg, mesh=mesh), has_aux=True))
    (loss, aux), grads = fn(jax.tree.map(jnp.asarray, npp), {k: jnp.asarray(v) for k, v in batch.items()})
    return {"loss": float(loss), "aux": {k: float(v) for k, v in aux.items()},
            "grads": dict(_leaves(jax.tree.map(np.asarray, grads)))}


def _jax_train(npp, batches, family, cp_impl, spec, accum=1):
    """JAX's ``sharded_init`` + ``make_train_step`` on ``spec``'s mesh: each
    step's metrics and the final parameters."""
    model, cfg = JMODELS[family], dataclasses.replace(JCFG[family], cp_impl=cp_impl)
    mesh = spec.build(devices=_devices(spec))
    opt = JT.OptimizerConfig(**OPT).build()
    state = JT.sharded_init(lambda: jax.tree.map(jnp.asarray, npp), model.sharding_rules(cfg), mesh, opt)
    step = JT.make_train_step(functools.partial(model.loss_fn, cfg=cfg, mesh=mesh), opt, accum_steps=accum)
    log = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        log.append({k: float(v) for k, v in m.items() if k != "step"})
    return log, dict(_leaves(jax.tree.map(np.asarray, state.params)))


def _jax_references(npp: dict, plain: list, packed: list) -> dict:
    c2, d2, d2c2, f2c2, d2e2 = (JMeshSpec(context=2), JMeshSpec(data=2), JMeshSpec(data=2, context=2),
                                JMeshSpec(fsdp=2, context=2), JMeshSpec(data=2, expert=2))
    jobs = {
        "llama_xla": lambda: _jax_loss(npp["llama"], plain[0], "llama", "xla", c2),
        "llama_ulysses": lambda: _jax_loss(npp["llama"], plain[0], "llama", "ulysses", c2),
        "llama_packed": lambda: _jax_loss(npp["llama"], packed[0], "llama", "xla", None),
        "mixtral_xla": lambda: _jax_loss(npp["mixtral"], plain[0], "mixtral", "xla", c2),
        "train": lambda: _jax_train(npp["llama"], plain, "llama", "xla", c2),
        "d2c2_llama": lambda: _jax_train(npp["llama"], plain, "llama", "xla", d2c2),
        "d2c2_accum2": lambda: _jax_train(npp["llama"], packed, "llama", "xla", d2, accum=2),
        "d2c2_accum4": lambda: _jax_train(npp["llama"], packed, "llama", "xla", d2, accum=4),
        "d2c2_mixtral": lambda: _jax_train(npp["mixtral"], plain, "mixtral", "xla", d2c2),
        "f2c2_llama": lambda: _jax_train(npp["llama"], plain, "llama", "ulysses", f2c2),
        "f2c2_mixtral": lambda: _jax_train(npp["mixtral"], plain, "mixtral", "xla", f2c2),
        "d2e2_accum2": lambda: _jax_train(npp["mixtral"], packed, "mixtral", "xla", d2e2, accum=2),
    }
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def _seeded_weights(seed: int, model) -> dict:
    """A tiny f32 model's weights as a numpy tree, drawn by the port's seeded
    init, handed to JAX and to the port alike."""
    cfg = dataclasses.replace(model.PRESETS["tiny"], dtype="float32")
    tree = model.init(torch.Generator().manual_seed(seed), cfg, "cpu")
    return {k: {n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _batches(rng, packed: bool) -> list[dict]:
    """``STEPS`` batches [B, T+1]; packed: two segments a row, the second
    starting off the window edge, and rows B/2.. ending in 10–20 padding
    tokens, so the two windows of a row and the two data shards hold
    unequal target counts."""
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


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """The gangs of 2 and 4, started together, beside JAX's references on
    the same weights and inputs; the one-process restores of both gangs'
    saves; the entries' one-process runs."""
    d = tmp_path_factory.mktemp("cp_gang")
    npp = {"llama": _seeded_weights(3, TL), "mixtral": _seeded_weights(3, TM)}
    rng = np.random.default_rng(5)
    plain, packed = _batches(rng, False), _batches(rng, True)
    torch.save({**npp, "plain": [{k: torch.from_numpy(v) for k, v in b.items()} for b in plain],
                "packed": [{k: torch.from_numpy(v) for k, v in b.items()} for b in packed]}, d / "in.pt")
    ckpt2, ckpt4 = d / "ckpt2", d / "ckpt4"
    finish4 = _start(_GANG4, 4, [str(d / "in.pt"), str(d / "r4_{rank}.pt"), str(ckpt4)])
    finish2 = _start(_GANG2, 2, [str(d / "in.pt"), str(d / "r2_{rank}.pt"), str(ckpt2), str(ckpt4),
                                 str(_free_port()), str(_free_port())])
    jax_runs = _one_thread(lambda: _jax_references(npp, plain, packed))
    finish4()
    outs2 = finish2()
    restored = {}
    for name, path, family in (("ckpt2", ckpt2, "llama"), ("ckpt4", ckpt4, "mixtral")):
        model = {"llama": TL, "mixtral": TM}[family]
        cfg = dataclasses.replace(model.PRESETS["tiny"], dtype="float32")
        restored[name] = TC.restore_or_init(str(path), lambda: TT.TrainState.create(
            model.init(torch.Generator().manual_seed(1), cfg, "cpu"), TT.OptimizerConfig(**OPT).build()),
            TT.TrainState.load)
    entries = {}
    for name, model in (("llama", TL), ("mixtral", TM)):
        loop, extra = TLp.parse_loop_args(ENTRY)
        entries[name] = _one_thread(lambda: TLp.run_lm_training(model, TLp.model_config(model, extra), loop))["log"]
    return {"r2": [torch.load(d / f"r2_{r}.pt", weights_only=False) for r in range(2)],
            "r4": [torch.load(d / f"r4_{r}.pt", weights_only=False) for r in range(4)],
            "jax": jax_runs, "restored": restored, "entry_out": outs2, "entries": entries}


def _assert_loss(ranks: list, case: str, want: dict):
    """The ranks' weighed losses and gradients summed against JAX's."""
    loss = sum(float(r[case]["loss"]) for r in ranks)
    assert abs(loss - want["loss"]) <= LOSS_REL * abs(want["loss"]), (case, loss, want["loss"])
    for name, ref in want["grads"].items():
        got = sum(r[case]["grads"][name] for r in ranks)
        assert _rel(got, ref) < LEAF_REL, (case, name, _rel(got, ref))


@pytest.mark.parametrize("case,impl", [("llama_xla", "llama_xla"), ("llama_pallas", "llama_xla"),
                                       ("llama_ulysses", "llama_ulysses"), ("llama_packed", "llama_packed"),
                                       ("mixtral_xla", "mixtral_xla")])
def test_a_context_gang_of_two_gives_jaxs_loss_and_gradients(gangs, case, impl):
    """Each rank's window of the rows (``context 2``, a ``ProcessRing``):
    its loss weighed by its share of the targets and its gradient, summed
    over the two ranks, are JAX's loss and every gradient leaf on a
    context-2 mesh (the packed batch: without a mesh); the packed batch's
    windows hold unequal target counts; Mixtral's router losses are JAX's on
    both ranks."""
    ranks, want = gangs["r2"], gangs["jax"][impl]
    assert [r["ring"] for r in ranks] == ["ProcessRing"] * 2
    assert [r["window"] for r in ranks] == [(0, 16), (16, 32)]
    assert ranks[0]["group"] == [0, 1]
    _assert_loss(ranks, case, want)
    counts = [r[case]["tokens"] for r in ranks]
    assert sum(counts) == (B * T if case != "llama_packed" else sum(counts))
    if case == "llama_packed":
        assert counts[0] != counts[1], counts
    if case.startswith("mixtral"):
        for r in ranks:
            for k in ("moe_balance_loss", "moe_z_loss"):
                assert abs(float(r[case][k]) - want["aux"][k]) <= LOSS_REL * abs(want["aux"][k]), (k, r[case][k])


def _assert_train(log: list, want: tuple, keys: tuple, what: str, params: dict | None = None):
    jlog, jparams = want
    assert len(log) == len(jlog) == STEPS, what
    for got, ref in zip(log, jlog):
        for k in keys:
            assert abs(got[k] - ref[k]) <= STEP_REL * abs(ref[k]), (what, k, got[k], ref[k])
    for name, t in (params or {}).items():
        assert _rel(t, jparams[name]) < PARAM_REL, (what, name, _rel(t, jparams[name]))


@pytest.mark.parametrize("case,family,keys", [
    ("d2c2_llama", "llama", KEYS["llama"]), ("d2c2_mixtral", "mixtral", KEYS["mixtral"]),
    ("f2c2_llama", "llama", KEYS["llama"]), ("f2c2_mixtral", "mixtral", KEYS["mixtral"])])
def test_a_context_gang_of_four_trains_as_jaxs_sharded_step(gangs, case, family, keys):
    """3 steps on ``data 2 × context 2`` and ``fsdp 2 × context 2`` (Llama
    "xla" and "ulysses", Mixtral "xla" with its router losses): every rank's
    metrics are JAX's sharded step's on a mesh of the same shape. A rank's
    ``ce_loss`` is its own window's (as on the data axis), and the windows
    hold equal target counts here, so their mean is JAX's."""
    logs = [r[case] for r in gangs["r4"]]
    if family == "mixtral":
        assert all(x["tokens"] == B * T for log in logs for x in log)
        ce = [np.mean([log[i]["ce_loss"] for log in logs]) for i in range(STEPS)]
        logs = [[{**x, "ce_loss": c} for x, c in zip(log, ce)] for log in logs]
    for rank, log in enumerate(logs):
        _assert_train(log, gangs["jax"][case], keys, f"{case} rank {rank}")


def test_the_gangs_lay_out_their_lines(gangs):
    """``data 2 × context 2``: the group is every rank, the replicas of a
    block the data × context ranks, each window half a row; ``MeshSpec.auto
    (context=2)`` on 4 processes fills fsdp 2, its replicas the context
    line."""
    r4 = gangs["r4"]
    assert all(r["d2c2_group"] == [0, 1, 2, 3] for r in r4)
    assert [r["d2c2_replicas"] for r in r4] == [[0, 1, 2, 3]] * 4
    assert [r["d2c2_window"] for r in r4] == [(0, 16), (16, 32)] * 2
    assert all(r["f2c2_shape"] == {"data": 1, "fsdp": 2, "context": 2} for r in r4)
    assert [r["f2c2_replicas"] for r in r4] == [[0, 1], [0, 1], [2, 3], [2, 3]]


@pytest.mark.parametrize("case,family", [("d2c2_accum2", "llama"), ("d2c2_accum4", "llama"),
                                         ("d2e2_accum2", "mixtral")])
def test_accumulated_microbatches_on_a_context_or_expert_gang_weigh_as_jaxs_scan(gangs, case, family):
    """``accum_steps`` 2 on ``data 2 × context 2`` (a microbatch a row
    slice, its windows weighed over the context line by the one collective
    of the step) and 4 (two microbatches a rank, each weighed over its line
    by a collective of its own), both through "pallas" on packed rows whose
    windows hold unequal target counts; and 2 on ``data 2 × expert 2``
    (Mixtral, a microbatch an expert line): JAX's scan of the same
    microbatches."""
    for rank, r in enumerate(gangs["r4"]):
        _assert_train(r[case], gangs["jax"][case], ACCUM_KEYS, f"{case} rank {rank}")


def test_a_context_gangs_train_steps_and_save_restore_into_one_process(gangs):
    """3 Llama steps through "pallas" on ``context 2`` are JAX's sharded
    step's, with the same parameters on both ranks; rank 0's save restores
    into one process bit for bit; the ``fsdp 2 × context 2`` save (DCP, a
    block a context line) restores into one process as the blocks the ranks
    held (both ranks of a context line the same) and onto ``context 2``."""
    r2, r4 = gangs["r2"], gangs["r4"]
    for r in r2:
        _assert_train(r["train"]["log"], gangs["jax"]["train"], KEYS["llama"], "context 2", r["train"]["params"])
    one, _, step = gangs["restored"]["ckpt2"]
    assert step == STEPS
    for name, t in TT._leaves(one.params):
        assert torch.equal(t.detach(), r2[0]["train"]["params"][name]), name
        assert torch.equal(r2[1]["train"]["params"][name], r2[0]["train"]["params"][name]), name
    one4, _, step4 = gangs["restored"]["ckpt4"]
    assert step4 == STEPS
    whole = dict(TT._leaves(one4.params))
    rules = TM.sharding_rules(dataclasses.replace(TM.MIXTRAL_TINY, dtype="float32"))
    for rank, r in enumerate(r4):
        for name, block in r["f2c2_blocks"].items():
            dim = next((i for i, e in enumerate(rules.spec_for(name)) if e == "fsdp"), None)
            want = whole[name] if dim is None else whole[name].chunk(2, dim)[r["f2c2_fsdp_index"]]
            assert torch.equal(block, want.detach()), (rank, name)
    for r in r2:
        assert r["restored4"]["start"] == STEPS
        for name, t in r["restored4"]["params"].items():
            assert torch.equal(t, whole[name].detach()), name


def test_the_pretrain_entries_run_a_context_gang(gangs):
    """``pretrain --context_axis 2`` and ``pretrain_mixtral --context_axis
    2`` in the gang of 2 log, on both ranks, the losses and
    grad norms of the same entries in one process (both shards on a
    ``DeviceRing``)."""
    lines = [_step_lines(out) for out in gangs["entry_out"]]
    for name, i in (("llama", slice(0, 2)), ("mixtral", slice(2, 4))):
        one = gangs["entries"][name]
        for rank, got in enumerate(lines):
            got = got[i]
            assert [x["step"] for x in got] == [1, 2], (name, rank)
            for x, y in zip(got, one):
                for k in ("loss", "grad_norm"):
                    assert abs(x[k] - y[k]) <= 1e-4 * abs(y[k]), (name, rank, k, x[k], y[k])
