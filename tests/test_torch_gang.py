"""Port parity for the training gang on the CPU: data shards, replay, the
gloo gang, resume at another world size, chaos, urgent save and the obs
contract.

- The port's ``TokenLoader`` (its ctypes path and its numpy path,
  ``draw_batch``), ``global_slots`` and ``ConsumptionCursor`` against the
  JAX package's on shards the test writes: the same windows in the same
  order, and shard and cursor files each package reads from the other.
- A gloo gang of 2 processes of ``run_lm_training`` (spawned with the env
  names the torch runtime adapter exports) against one process on the same
  global batches, with ``data_dir`` and with synthetic batches: per-step
  losses and grad norms as logged (4 decimals, so within 1e-4) and the final
  parameters within ``PARAM_ATOL``, in f32. The tiny model's gradient norm
  is above the clip (1.0), so the clip on the global norm is exercised.
- 2 ranks for 3 steps, resumed on 1 rank to 6, equals 6 uninterrupted
  steps; a changed global batch or seed on resume raises.
- The gang's reductions against one process on the global batch: BERT with
  unequal target counts per rank; Mixtral's router losses taken over the
  whole batch (plain rows, packed rows whose router and CE counts differ,
  a rank with no targets); accumulated microbatches of BERT and Mixtral in
  gangs of 2 and 4 laid out as JAX's scan lays them (and against JAX's
  ``make_train_step``), a straddling layout refused.
- ``ckpt-corrupt`` chaos, the urgent save, and the ``.obs`` snapshot, spans
  and log records read by the JAX package's readers.
- The headline (``e2e``): ``tony submit`` of a 2-worker gang of
  ``python -m tony_tpu_torch.train.pretrain`` under node-loss chaos.
"""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tony_tpu.data import dataset as JD  # noqa: E402
from tony_tpu.data import native as JN  # noqa: E402
from tony_tpu.obs import introspect as JI  # noqa: E402
from tony_tpu_torch.data import dataset as TD  # noqa: E402
from tony_tpu_torch.data import native as TN  # noqa: E402
from tony_tpu_torch.models import llama as TM  # noqa: E402
from tony_tpu_torch.obs import introspect as TI  # noqa: E402
from tony_tpu_torch.train import checkpoint as TC  # noqa: E402
from tony_tpu_torch.train import loop as TLp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = dataclasses.replace(TM.LLAMA_TINY, dtype="float32")
#: f32: the gang averages two half-batch gradients where one process takes
#: the mean over the whole batch, so a parameter moves by a few f32 ulps
PARAM_ATOL = 1e-5
BASE = dict(batch_size=4, seq_len=32, log_every=1, warmup_steps=1, learning_rate=1e-2)

# each rank of a spawned gang: run_lm_training on the f32 tiny model with the
# LoopConfig given as JSON, printing its step log
_RANK = """
import dataclasses, json, sys
from tony_tpu_torch.models import llama
from tony_tpu_torch.train import loop
cfg = dataclasses.replace(llama.LLAMA_TINY, dtype="float32")
res = loop.run_lm_training(llama, cfg, loop.LoopConfig(device="cpu", **json.loads(sys.argv[1])))
print("LOG " + json.dumps(res["log"]))
"""


@pytest.fixture(autouse=True)
def _one_thread():
    """The in-process runs on one intra-op thread, as each gang rank has
    (``OMP_NUM_THREADS=1``): tier-1 runs this file beside other workers, and
    a tiny model's step on a full thread pool only waits for CPUs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gang(n: int, rank_env=lambda rank: {}, **kw) -> list[list[dict]]:
    """Run ``n`` ranks as the torch runtime adapter launches them (each with
    ``rank_env(rank)`` on top); every rank's step log."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(rank), WORLD_SIZE=str(n),
                   LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   INIT_METHOD=f"tcp://127.0.0.1:{port}", OMP_NUM_THREADS="1", **rank_env(rank))
        procs.append(subprocess.Popen([sys.executable, "-c", _RANK, json.dumps(kw)], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:  # a rank left waiting on a collective
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        logs.append(json.loads(next(x for x in out.splitlines() if x.startswith("LOG "))[4:]))
    return logs


def _one(**kw) -> list[dict]:
    return TLp.run_lm_training(TM, CFG, TLp.LoopConfig(device="cpu", **kw))["log"]


def _final_params(ckpt: Path) -> dict:
    """The newest step's parameters, whole: a gang's fsdp axis writes each
    rank's blocks (DCP), one process ``state.pt``."""
    step = max(int(p.name) for p in ckpt.iterdir() if p.name.isdigit())
    return TC.read_whole(str(ckpt / str(step)))["params"]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_same_run(got: list[dict], want: list[dict]) -> None:
    assert [x["step"] for x in got] == [x["step"] for x in want]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-4, (g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-4, (g, w)


def _assert_same_params(a: dict, b: dict) -> None:
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for name in la:
        err = float((la[name].detach().float() - lb[name].detach().float()).abs().max())
        assert err <= PARAM_ATOL, (name, err)


@pytest.fixture(scope="module")
def shards(tmp_path_factory) -> Path:
    """Three shards of seeded tokens of the tiny vocabulary (uint16 on disk),
    written by one package or the other."""
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(7)
    for i, n in enumerate((3000, 2500, 4100)):
        (TD if i % 2 else JD).write_token_shard(d / f"s{i}.tonytok", rng.integers(0, 256, n))
    return d


def _loader_paths(shards: Path) -> list[Path]:
    """The training shards and one whose ids exceed uint16 (int32 on disk)."""
    wide = shards.parent / "wide.tonytok"
    if not wide.exists():
        TD.write_token_shard(wide, np.random.default_rng(8).integers(0, 70_000, 1700))
    return sorted(shards.glob("*.tonytok")) + [wide]


# -- data: loader, slots, cursor ----------------------------------------------------

@pytest.mark.parametrize("shard_id,num_shards,start", [(0, 1, 0), (1, 2, 0), (2, 4, 3), (0, 2, 7)])
def test_token_loader_draws_the_jax_loaders_windows(shards, shard_id, num_shards, start):
    paths = _loader_paths(shards)
    batch, seq = 3, 31
    want_loader = JN.TokenLoader(paths, batch, seq, shard_id=shard_id, num_shards=num_shards,
                                 seed=11, start_index=start)
    got_loader = TN.TokenLoader(paths, batch, seq, shard_id=shard_id, num_shards=num_shards,
                                seed=11, start_index=start)
    assert got_loader.is_native, "the C++ loader did not build or load (make -C native)"
    mmaps = [TD.open_shard(p) for p in paths]
    try:
        for index in range(start, start + 40):  # past one epoch of the 366 windows at this width
            want = want_loader.next()
            np.testing.assert_array_equal(got_loader.next(), want)
            np.testing.assert_array_equal(
                TN.draw_batch(mmaps, batch, seq, shard_id, num_shards, 11, index), want)
    finally:
        want_loader.close()
        got_loader.close()
    assert got_loader.total_tokens == sum(s.size for s in mmaps) == 11_300


def test_global_slots_and_shard_files_match_jax(shards):
    for t in range(5):
        for k in (1, 2, 4, 8):
            for r in range(k):
                assert TD.global_slots(t, 8, r, k) == JD.global_slots(t, 8, r, k)
    # slots of a history of world sizes 2 → 1 → 4 cover [0, T*G) once each
    hist = [(t, 2) for t in range(3)] + [(t, 1) for t in range(3, 5)] + [(t, 4) for t in range(5, 9)]
    slots = [s for t, k in hist for r in range(k) for s in TD.global_slots(t, 8, r, k)]
    assert sorted(slots) == list(range(9 * 8))
    for fn in (TD.global_slots, JD.global_slots):
        with pytest.raises(ValueError, match="must divide"):
            fn(0, 6, 0, 4)
    for p in _loader_paths(shards):  # written by one package or the other
        np.testing.assert_array_equal(np.asarray(TD.open_shard(p)), JD.read_shard(p))


def test_cursor_files_cross_between_the_packages(tmp_path):
    TD.ConsumptionCursor(12, 8, 5, world_size=2).save(tmp_path)
    JD.ConsumptionCursor(16, 8, 5, world_size=4).save(tmp_path)
    assert JD.ConsumptionCursor.load(tmp_path, 12) == JD.ConsumptionCursor(12, 8, 5, 2)
    assert TD.ConsumptionCursor.load(tmp_path, 16) == TD.ConsumptionCursor(16, 8, 5, 4)
    assert TD.ConsumptionCursor.load(tmp_path, 20) is None
    cur_t, cur_j = TD.ConsumptionCursor.load(tmp_path, 12), JD.ConsumptionCursor.load(tmp_path, 12)
    cur_t.validate_resume(8, 5, 12)
    for args in ((4, 5, 12), (8, 6, 12), (8, 5, 13)):  # the same refusal, word for word
        with pytest.raises(ValueError) as want:
            cur_j.validate_resume(*args)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            cur_t.validate_resume(*args)


# -- the gang ------------------------------------------------------------------------

@pytest.mark.parametrize("data", ["shards", "synthetic"])
def test_gloo_gang_of_two_equals_one_process(shards, tmp_path, data):
    kw = dict(BASE, steps=4, data_dir=str(shards) if data == "shards" else "")
    logs = _gang(2, **kw, checkpoint_dir=str(tmp_path / "gang"))
    want = _one(**kw, checkpoint_dir=str(tmp_path / "one"))
    assert all(x["grad_norm"] > 1.0 for x in want)  # the clip is active on every step
    for log in logs:  # every rank logs the gang's (global) loss and norm
        _assert_same_run(log, want)
    _assert_same_params(_final_params(tmp_path / "gang"), _final_params(tmp_path / "one"))


def test_gang_resumed_on_one_rank_replays_the_stream(shards, tmp_path):
    """2 ranks to step 3 (checkpoint and cursor at 3), then 1 rank resumed to
    6, against 6 uninterrupted steps of one process."""
    kw = dict(BASE, schedule_steps=6, data_dir=str(shards), checkpoint_every=3)
    ck = tmp_path / "ck"
    first = _gang(2, **kw, steps=3, checkpoint_dir=str(ck))[0]
    cursor = TD.ConsumptionCursor.load(ck, 3)
    assert cursor == TD.ConsumptionCursor(3, 4, 0, world_size=2)
    with pytest.raises(ValueError, match="global batch changed"):
        _one(**{**kw, "batch_size": 2}, steps=6, checkpoint_dir=str(ck))
    with pytest.raises(ValueError, match="data seed changed"):
        _one(**kw, data_seed=1, steps=6, checkpoint_dir=str(ck))
    res = TLp.run_lm_training(TM, CFG, TLp.LoopConfig(device="cpu", **kw, steps=6, checkpoint_dir=str(ck)))
    assert res["start_step"] == 3
    want_ck = tmp_path / "whole"
    want = _one(**kw, steps=6, checkpoint_dir=str(want_ck))
    _assert_same_run(first + res["log"], want)
    _assert_same_params(_final_params(ck), _final_params(want_ck))
    assert TD.ConsumptionCursor.load(ck, 6).world_size == 1


# three train steps of the f32 tiny BERT on dense MLM batches (each position
# masked with probability 0.15, so the ranks' halves hold unequal counts of
# targets); ``run(rank, world, group)`` trains on this rank's rows of each
# global batch and returns every step's loss and the reduced gradients the
# optimizer received. Run as a gang rank and, with world 1, in process
_BERT_STEPS = """
import dataclasses, torch
from tony_tpu_torch.models import bert
from tony_tpu_torch.train import trainer as TT

CFG = dataclasses.replace(bert.BERT_TINY, dtype="float32")
B, T, STEPS = 4, 64, 3


class Recording(TT.AdamW):
    def update(self, params, grads, state, norm):
        self.seen.append({k: g.clone() for k, g in grads.items()})
        super().update(params, grads, state, norm)


def global_batch(step):
    return bert.dense_synthetic_batch(torch.Generator().manual_seed(100 + step), B, T, CFG)


def run(rank, world, group):
    opt = Recording(TT.OptimizerConfig(learning_rate=1e-2, warmup_steps=1, total_steps=STEPS))
    opt.seen = []
    state = TT.TrainState.create(bert.init(torch.Generator().manual_seed(0), CFG, "cpu"), opt)
    step = TT.make_train_step(lambda p, b: bert.loss_fn(p, b, CFG), opt, group=group)
    rows = B // world
    losses = []
    for i in range(STEPS):
        batch = {k: v[rank * rows:(rank + 1) * rows] for k, v in global_batch(i).items()}
        state, m = step(state, batch)
        losses.append((float(m["loss"]), float(m["tokens"])))
    return losses, opt.seen
"""

# the tail of a gang rank's script: join the gloo group as the torch runtime
# adapter's env describes it, save run(rank, world, group)'s result
_GANG_RUN = """
import sys, torch.distributed as dist
from tony_tpu_torch.runtime import init_distributed, shutdown_distributed
init_distributed(torch.device("cpu"))
torch.save(run(dist.get_rank(), dist.get_world_size(), dist.group.WORLD), sys.argv[1])
shutdown_distributed()
"""


def _start_gang(script: str, out_dir: Path, n: int) -> Callable[[], list]:
    """Start ``script + _GANG_RUN`` as ``n`` gloo ranks (one intra-op thread
    each); returns a function that waits for them and gives every rank's
    saved result."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", script + _GANG_RUN, str(out_dir / f"r{rank}.pt")],
                                      cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))

    def finish() -> list:
        try:
            outs = [p.communicate(timeout=180)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-3000:]
        return [torch.load(out_dir / f"r{rank}.pt", weights_only=True) for rank in range(n)]

    return finish


def _spawn_gang(script: str, tmp_path: Path, n: int = 2) -> list:
    return _start_gang(script, tmp_path, n)()


def _assert_grads_close(got: dict, want: dict, what) -> None:
    """Every leaf within 1e-4 of the want's largest magnitude."""
    assert got.keys() == want.keys(), what
    for name, w in want.items():
        g = torch.as_tensor(np.array(got[name])).float()
        w = torch.as_tensor(np.array(w)).float()
        err = float((g - w).abs().max() / w.abs().max().clamp_min(1e-12))
        assert err <= 1e-4, (what, name, err)


def test_gloo_gang_weighs_ranks_by_their_targets_as_one_process(tmp_path):
    """A gloo gang of 2 on BERT batches whose halves hold unequal counts of
    MLM targets equals one process on the global batch: the loss within
    1e-5 and every reduced gradient within 1e-4 relative, each step. A plain
    mean of the ranks' token means would weigh the ranks' targets unequally."""
    ns: dict = {}
    exec(_BERT_STEPS, ns)
    counts = [[int((ns["global_batch"](i)["targets"][r * 2:(r + 1) * 2] != -100).sum()) for r in (0, 1)]
              for i in range(ns["STEPS"])]
    assert all(a != b for a, b in counts), counts
    ranks = _spawn_gang(_BERT_STEPS, tmp_path)
    want_losses, want_grads = ns["run"](0, 1, None)
    for rank, (losses, grads) in enumerate(ranks):
        for (gl, gn), (wl, wn), c in zip(losses, want_losses, counts):
            assert gn == wn == sum(c) and abs(gl - wl) <= 1e-5, (losses, want_losses)
        for got, want in zip(grads, want_grads):
            _assert_grads_close(got, want, rank)


# The gang's reductions on global batches of 8 rows, the loss a partial as
# the training loop passes it (make_train_step hands Mixtral's the ranks
# that share its rows); run(rank, world, group) gives, for each case, every
# step's metrics and the reduced gradients the optimizer received:
# - "mixtral 1" (C2): three Mixtral steps without accumulation, on plain
#   rows, on packed rows whose ranks hold unequal router (valid input) and
#   CE (valid target) counts, and with the second half all padding (ranks
#   with no targets);
# - "bert A", "mixtral A" (C3): one step with accum_steps A, on BERT's C3
#   reading (dense_synthetic_batch seed 100: 7 11 8 11 4 7 7 7 targets a
#   row) and on the packed Mixtral rows, where rows 2-3 (a rank, or a
#   microbatch) hold no targets;
# and, in a gang, the refusal of accum_steps 3, which straddles.
_REDUCTIONS = """
import dataclasses, functools, torch
from tony_tpu_torch.models import bert, mixtral
from tony_tpu_torch.train import trainer as TT

CFG = dataclasses.replace(bert.BERT_TINY, dtype="float32")
MCFG = dataclasses.replace(mixtral.MIXTRAL_TINY, dtype="float32")
B, T, ACCUM = 8, 64, (2, 4)
# per Mixtral row: (segment, length) runs of the T+1 ids; 0 is padding
PAD = ((0, 65),)
PACKED = [((1, 45), (0, 20)), ((1, 30), (2, 35)), PAD, PAD,
          ((1, 10), (2, 40), (0, 15)), ((1, 65),), ((1, 20), (0, 45)), ((1, 50), (2, 15))]
RUNS = {1: PACKED, 2: PACKED[:2] + PACKED[4:6] + [PAD] * 4}
KEYS = ("loss", "tokens", "moe_balance_loss", "moe_z_loss")


class Recording(TT.AdamW):
    def update(self, params, grads, state, norm):
        self.seen.append({k: g.clone() for k, g in grads.items()})
        super().update(params, grads, state, norm)


def global_batch(model, step):
    if model is bert:
        return bert.dense_synthetic_batch(torch.Generator().manual_seed(100), B, T, CFG)
    batch = mixtral.synthetic_batch(torch.Generator().manual_seed(7 + step), B, T, MCFG)
    if step in RUNS:
        batch["segment_ids"] = torch.tensor([sum(([s] * n for s, n in row), []) for row in RUNS[step]])
    return batch


def train(model, cfg, steps, accum, rank, world, group):
    opt = Recording(TT.OptimizerConfig(learning_rate=1e-2, warmup_steps=1, total_steps=len(steps)))
    opt.seen = []
    state = TT.TrainState.create(model.init(torch.Generator().manual_seed(0), cfg, "cpu"), opt)
    loss_fn = functools.partial(model.loss_fn, cfg=cfg, mesh=None)
    step = TT.make_train_step(loss_fn, opt, accum_steps=accum, group=group)
    rows = B // world
    log = []
    for i in steps:
        state, m = step(state, {k: v[rank * rows:(rank + 1) * rows] for k, v in global_batch(model, i).items()})
        log.append((sorted(m), {k: float(m[k]) for k in KEYS if k in m}))
    return log, opt.seen


def run(rank, world, group):
    out = {"mixtral 1": train(mixtral, MCFG, (0, 1, 2), 1, rank, world, group)}
    for accum in ACCUM:
        out[f"bert {accum}"] = train(bert, CFG, (0,), accum, rank, world, group)
        out[f"mixtral {accum}"] = train(mixtral, MCFG, (1,), accum, rank, world, group)
    if group is not None:
        try:
            TT.make_train_step(functools.partial(bert.loss_fn, cfg=CFG), None, accum_steps=3, group=group)
        except ValueError as e:
            out["straddle"] = str(e)
    return out
"""


@pytest.fixture(scope="module")
def reductions(tmp_path_factory) -> dict:
    """``_REDUCTIONS`` in this process (world 1) and as gloo gangs of 2 and
    4, the gangs run at once: {world: [each rank's result]}."""
    gangs = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"gang{world}")
        gangs[world] = _start_gang(_REDUCTIONS, d, world)
    ns: dict = {}
    exec(_REDUCTIONS, ns)
    threads = torch.get_num_threads()  # a module fixture runs outside the per-test _one_thread
    torch.set_num_threads(1)
    try:
        one = ns["run"](0, 1, None)
    finally:
        torch.set_num_threads(threads)
    return {1: [one], **{world: finish() for world, finish in gangs.items()}}


def _assert_same_case(got, want, what) -> None:
    """The same metric keys, the listed values within 1e-5 (the token
    count exactly) and every gradient within 1e-4 relative, each step."""
    (got_log, got_grads), (want_log, want_grads) = got, want
    assert len(got_log) == len(want_log) == len(got_grads) == len(want_grads), what
    for step, ((gk, gv), (wk, wv)) in enumerate(zip(got_log, want_log)):
        assert gk == wk and gv.keys() == wv.keys(), (what, step, gk, wk)
        assert gv.get("tokens") == wv.get("tokens"), (what, step, gv, wv)
        for k in wv:
            assert abs(gv[k] - wv[k]) <= 1e-5, (what, step, k, gv, wv)
    for step, (g, w) in enumerate(zip(got_grads, want_grads)):
        _assert_grads_close(g, w, (what, step))


def test_gloo_gang_takes_mixtrals_router_losses_over_the_global_batch(reductions):
    """C2: gloo gangs of 2 and 4 of the tiny Mixtral in f32 equal one process
    on the global batch: the loss, the balance and z losses within 1e-5 and
    every reduced gradient within 1e-4 relative, on plain rows, on packed
    rows with unequal router and target counts, and with ranks whose rows
    are all padding (no targets: they weigh 0, and nothing turns NaN). Each
    rank's own balance statistic, averaged over the ranks, is off in the
    loss and in the router's gradient."""
    ns: dict = {}
    exec(_REDUCTIONS, ns)
    seg = ns["global_batch"](ns["mixtral"], 1)["segment_ids"]
    router = [int((seg[r * 4:(r + 1) * 4, :-1] != 0).sum()) for r in (0, 1)]
    assert router[0] != router[1]
    assert not ns["global_batch"](ns["mixtral"], 2)["segment_ids"][4:].any()
    want = reductions[1][0]["mixtral 1"]
    assert all(set(ns["KEYS"]) <= set(keys) for keys, _ in want[0])
    for world in (2, 4):
        for rank, out in enumerate(reductions[world]):
            _assert_same_case(out["mixtral 1"], want, (world, rank))


def test_accumulated_microbatches_in_a_gang_weigh_as_jaxs_scan(reductions):
    """C3: gloo gangs of 2 and 4 with ``accum_steps`` 2 and 4 equal one
    process with the same ``accum_steps`` on the global batch, and BERT's
    one process equals JAX's ``make_train_step`` (its scan over global
    microbatches): the loss within 1e-5, every gradient within 1e-4
    relative, and no aux in the metrics. The layouts: each rank holds whole
    microbatches (2 ranks, accum 2 and 4; 4 ranks, accum 4), or a microbatch
    spans two ranks (4 ranks, accum 2), whose ranks weigh ``n_r / N_i`` and
    pool Mixtral's router losses over their subgroup. A rank's rows split
    into ``accum_steps`` microbatches of their own are off by 1.7e-2 in
    BERT's loss. ``accum_steps`` 3 raises naming C3."""
    import optax

    from tony_tpu.models import bert as JB
    from tony_tpu.train import trainer as JT

    ns: dict = {}
    exec(_REDUCTIONS, ns)
    one = reductions[1][0]
    batch = {k: jnp.asarray(v.numpy()) for k, v in ns["global_batch"](ns["bert"], 0).items()}
    init = torch.Generator().manual_seed(0)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), ns["bert"].init(init, ns["CFG"], "cpu"))
    jcfg = dataclasses.replace(JB.BERT_TINY, dtype="float32")
    # an optimizer whose state after one update is the gradients it was given
    keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    for accum in ns["ACCUM"]:
        jstep = JT.make_train_step(lambda p, b: JB.loss_fn(p, b, jcfg), keep, accum_steps=accum)
        jstate, jm = jstep(JT.TrainState.create(jax.tree.map(jnp.array, jparams), keep), batch)  # donated
        jgrads = dict(_leaves(jax.tree.map(np.asarray, jstate.opt_state)))
        [(keys, values)], [grads] = one[f"bert {accum}"]
        assert abs(values["loss"] - float(jm["loss"])) <= 1e-5, (accum, values, float(jm["loss"]))
        _assert_grads_close(grads, jgrads, ("one process", accum))
    for world in (2, 4):
        for rank, out in enumerate(reductions[world]):
            for model in ("bert", "mixtral"):
                for accum in ns["ACCUM"]:
                    case = f"{model} {accum}"
                    assert one[case][0][0][0] == ["grad_norm", "loss", "step"], case
                    _assert_same_case(out[case], one[case], (world, rank, case))
            assert f"C3: accum_steps 3 over a gang of {world} ranks" in out["straddle"]


@pytest.mark.parametrize("accum, world, want", [
    (1, 2, (1, 1)), (2, 2, (1, 2)), (4, 2, (2, 2)), (2, 4, (1, 2)), (8, 1, (8, 1)), (3, 2, None), (2, 3, None),
])
def test_gang_slots_cover_whole_microbatches_or_raise(accum, world, want):
    from tony_tpu_torch.train.trainer import gang_slots

    if want is None:
        with pytest.raises(ValueError, match=f"C3: accum_steps {accum} over a gang of {world} ranks"):
            gang_slots(accum, world)
    else:
        assert gang_slots(accum, world) == want


# -- chaos, urgent save, obs --------------------------------------------------------

def _task_env(monkeypatch, tmp_path) -> Path:
    """The env an executor exports to the training child of worker:0."""
    staging = tmp_path / "staging"
    env = {"TONY_STAGING_DIR": staging, "JOB_NAME": "worker", "TASK_INDEX": "0",
           "TONY_APP_ID": "app_test", "TONY_TRAIN_METRICS_FILE": staging / "metrics" / "worker_0.json",
           "TONY_PROFILE_POLL_MS": "50"}
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    (staging / "metrics").mkdir(parents=True)
    return staging


@pytest.mark.parametrize("ranks", [1, 2])
def test_ckpt_corrupt_chaos_quarantines_the_torn_step(monkeypatch, tmp_path, ranks):
    """Steps 1-3 on disk; ``ckpt-corrupt`` tears step 3 before the restore,
    which quarantines it and resumes at 2. In a gang of 2 rank 0 tears it,
    both ranks then hit it at once (a rename lost to the peer is success)
    and agree on step 2."""
    ck = tmp_path / "ck"
    kw = dict(BASE, checkpoint_every=1, checkpoint_dir=str(ck), schedule_steps=5)
    _one(**kw, steps=3)
    staging = _task_env(monkeypatch, tmp_path)
    monkeypatch.setenv("TONY_CHAOS_SPEC", "ckpt-corrupt:latest")
    logs = _gang(2, **kw, steps=4) if ranks == 2 else [_one(**kw, steps=4)]
    assert all([x["step"] for x in log] == [3, 4] for log in logs), logs
    assert (ck / ".corrupt-3").is_dir() and (ck / ".corrupt-3" / "state.pt").stat().st_size == 0
    inj = [json.loads(x) for x in (staging / "chaos" / "injections-worker_0.jsonl").read_text().splitlines()]
    assert [x["kind"] for x in inj] == ["ckpt-corrupt"]
    # once per job: the latch under the staging dir holds across attempts
    res = TLp.run_lm_training(TM, CFG, TLp.LoopConfig(device="cpu", **kw, steps=5))
    assert res["start_step"] == 4


@pytest.mark.parametrize("ranks", [1, 2])
def test_drain_request_forces_a_save_and_is_acknowledged(monkeypatch, tmp_path, ranks):
    """A ``.drain`` request for worker 0 gives a forced save at step 1 and
    a ``.drain.done`` naming it. In a gang of 2 only rank 0 has a request:
    the ranks agree each step, so both save at step 1 (a rank that did not
    would leave the other in the save's barrier) and only rank 0 answers."""
    staging = _task_env(monkeypatch, tmp_path)
    metrics = staging / "metrics" / "worker_0.json"
    assert (TI.DRAIN_CONTROL_SUFFIX, TI.DRAIN_DONE_SUFFIX, TI.CONTROL_SUFFIX, TI.DONE_SUFFIX) == (
        JI.DRAIN_CONTROL_SUFFIX, JI.DRAIN_DONE_SUFFIX, JI.CONTROL_SUFFIX, JI.DONE_SUFFIX)
    JI.write_json_atomic(str(metrics) + JI.DRAIN_CONTROL_SUFFIX, {"req_id": "drain-1"})
    ck = tmp_path / "ck"
    kw = dict(BASE, steps=3, checkpoint_dir=str(ck), checkpoint_every=10)
    if ranks == 2:
        other = staging / "metrics" / "worker_1.json"
        _gang(2, rank_env=lambda r: {"TONY_TRAIN_METRICS_FILE": str(metrics if r == 0 else other)}, **kw)
        assert JI.read_json(str(other) + JI.DRAIN_DONE_SUFFIX) is None
    else:
        _one(**kw)
    done = JI.read_json(str(metrics) + JI.DRAIN_DONE_SUFFIX)
    assert done == {"req_id": "drain-1", "step": 1}
    assert sorted(int(p.name) for p in ck.iterdir() if p.name.isdigit()) == [1, 3]


def test_obs_snapshot_spans_and_logs_read_by_the_jax_readers(monkeypatch, tmp_path):
    from tony_tpu.cluster.events import Event, EventType
    from tony_tpu.obs import artifacts as JA
    from tony_tpu.obs import goodput as JG
    from tony_tpu.obs import logging as JL
    from tony_tpu.obs import metrics as JM
    from tony_tpu.train import checkpoint as JC  # noqa: F401 — registers the JAX instruments
    from tony_tpu.train import input_pipeline as JP  # noqa: F401
    from tony_tpu.train import loop as JLoop  # noqa: F401
    from tony_tpu_torch.obs import metrics as TMx

    staging = _task_env(monkeypatch, tmp_path)
    for k, v in {"TONY_TRACE_ENABLED": "1", "TONY_TRACE_DIR": staging / "trace",
                 "TONY_LOG_DIR": staging / "logs", "TONY_PROFILE_DIR": staging / "profile",
                 "TONY_PROFILE_START_STEP": "1", "TONY_PROFILE_NUM_STEPS": "2"}.items():
        monkeypatch.setenv(k, str(v))
    before = JI.histogram_stats(TMx.REGISTRY.snapshot(), "tony_train_step_seconds") or (0, 0.0)
    t0 = int(time.time() * 1000)
    _one(**BASE, steps=4, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2, prefetch_depth=2)
    t1 = int(time.time() * 1000)

    snap = json.loads((staging / "metrics" / "worker_0.json.obs").read_text())
    names = {m["name"] for m in snap}
    mine = {"tony_train_first_step_seconds", "tony_train_step_seconds", "tony_checkpoint_save_seconds",
            "tony_train_input_wait_seconds"}
    assert mine <= names
    jax_reg = {m["name"]: m for m in JM.REGISTRY.snapshot()}
    port_reg = {m["name"]: m for m in TMx.REGISTRY.snapshot()}
    for name in mine | {"tony_checkpoint_restore_seconds"}:  # the same instruments as the JAX child's
        keys = ("type", "help", "labelnames") + (("buckets",) if port_reg[name]["type"] == "histogram" else ())
        assert {k: port_reg[name][k] for k in keys} == {k: jax_reg[name][k] for k in keys}, name
    count, total = JI.histogram_stats(snap, "tony_train_step_seconds")
    # one sample a logging window after the first step (the registry is the process's)
    assert count - before[0] == 3 and total > before[1]
    infos = [{"name": "worker", "index": 0, "status": "RUNNING",
              "metrics": {"train": json.loads((staging / "metrics" / "worker_0.json").read_text())}}]
    row = JI.build_top_rows(infos, {"worker:0": snap})[0]
    assert row["step"] == 4 and row["steps_per_s"] > 0

    spans = JA.load_spans(str(staging / "trace"))
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    assert {"train.run", "train.first_step", "ckpt.save"} <= set(by_name)
    root = by_name["train.run"][0]
    assert root["identity"] == "worker:0:train" and root["trace_id"] == "app_test"
    assert all(s["parent_id"] == root["span_id"] for s in by_name["ckpt.save"] + by_name["train.first_step"])
    events = [Event(EventType.GANG_COMPLETE, {}, t0),
              Event(EventType.METRICS_SNAPSHOT, {"tasks": [{"task": "worker:0", "metrics": {"train": {"step": 4}}}]}, t1),
              Event(EventType.APPLICATION_FINISHED, {"status": "SUCCEEDED"}, t1 + 1)]
    ledger = JG.build_ledger("app_test", events, spans)
    assert ledger.phases_ms.get("compile", 0) > 0 and ledger.phases_ms.get("checkpoint", 0) > 0
    assert sum(ledger.phases_ms.values()) == ledger.wall_ms

    records = JL.read_records(str(staging / "logs"))
    steps = [r for r in records if r.get("identity") == "worker:0:train" and "loss" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    assert any(p.name.endswith(".pt.trace.json") and p.stat().st_size > 0
               for p in (staging / "profile").iterdir())


# -- the headline: tony submit of a gang under node-loss chaos ------------------------

#: attempt 1 trains to here; the node loss cuts attempt 0 within a few steps
#: of its gate (at steps 7 and 11 in two runs on 8 CPUs), long before
E2E_STEPS = 48
#: relative, in bf16 (the pretrain CLI's tiny preset): the gang averages two
#: half-batch gradients rounded to bf16 where one process rounds the whole
#: batch's; the worst step read 2.1e-4 in two runs on 8 CPUs
E2E_LOSS_TOL = 2e-3


def _step_lines(path: Path) -> dict[int, float]:
    out = {}
    for line in path.read_text().splitlines():
        if line.startswith("{") and '"loss"' in line:
            rec = json.loads(line)
            out[rec["step"]] = rec["loss"]
    return out


@pytest.mark.e2e
def test_tony_submit_gang_resumes_exactly_once_after_node_loss(tmp_tony_root, tmp_path, shards, capsys):
    """``tony submit`` (framework pytorch) of a 2-worker gloo gang of
    ``python -m tony_tpu_torch.train.pretrain --device cpu`` with
    ``node-loss:worker:1@step+9`` (armed once step 9 is reported): the gang
    restarts once, resumes
    from the newest checkpoint with a validated cursor, consumes every global slot
    once, logs the losses of one process on the same global batches, and
    its step metrics reach ``tony top`` and ``tony goodput``. Attempt 0 is
    given a far horizon so the node loss always lands mid-run; after
    training, each worker waits for a stop file so that ``tony top`` reads
    a live gang.

    Saves are asynchronous: step 4's write runs in rank 0's writer thread
    while the gang trains on, and may still be in flight when step 5 is
    reported (``[ckpt] step 4 published`` can come after it under load), so
    a node loss armed at step 5 could restart a gang that has nothing on
    disk. The save of step 8 first joins step 4's write, and no rank
    reports step 9 before rank 0 has made that save (step 9's gradient
    mean waits for it): once step 9 is reported, step 4 is published."""
    from tony_tpu.cli.goodput import main as goodput_main
    from tony_tpu.cli.introspect import main_top
    from tony_tpu.cluster.client import Client
    from tony_tpu.cluster.session import JobStatus
    from tony_tpu.config import TonyConfig, keys

    ck, stop = tmp_path / "ckpt", tmp_path / "stop"
    steps = f'$([ "${{TONY_RESTART_ATTEMPT:-0}}" = 0 ] && echo 100000 || echo {E2E_STEPS})'
    cmd = (f"export OMP_NUM_THREADS=1 PYTHONPATH={ROOT} && cd {ROOT} && "
           f"{sys.executable} -m tony_tpu_torch.train.pretrain --device cpu --preset tiny "
           f"--data_dir {shards} --batch_size 4 --seq_len 32 --log_every 1 --warmup_steps 2 "
           f"--schedule_steps {E2E_STEPS} --steps {steps} && "
           f"for i in $(seq 1200); do [ -e {stop} ] && break; sleep 0.1; done")
    cfg = TonyConfig({
        keys.AM_MONITOR_INTERVAL_MS: "50", keys.TASK_HEARTBEAT_INTERVAL_MS: "100",
        keys.TASK_METRICS_INTERVAL_MS: "200", keys.AM_GANG_TIMEOUT_MS: "60000",
        keys.STAGING_ROOT: str(tmp_tony_root), "tony.worker.instances": "2",
        keys.APPLICATION_FRAMEWORK: "pytorch", keys.EXECUTES: cmd,
        keys.TASK_RESTART_ON_FAILURE: "true", keys.CHAOS_SPEC: "node-loss:worker:1@step+9",
        keys.CHECKPOINT_DIR: str(ck), keys.CHECKPOINT_INTERVAL_STEPS: "4",
        keys.TRACE_ENABLED: "true",
    })
    client = Client(cfg)
    handle = client.submit()
    try:
        rpc = handle.rpc(timeout_s=30)
        assert rpc is not None, "AM never advertised"
        deadline = time.time() + 150
        while time.time() < deadline:
            infos = rpc.call("get_task_infos")
            trained = [((t.get("metrics") or {}).get("train") or {}).get("step") for t in infos]
            if len(infos) == 2 and trained == [E2E_STEPS, E2E_STEPS]:
                break
            time.sleep(0.2)
        else:
            pytest.fail(f"the gang never finished its steps: {rpc.call('get_task_infos')}")
        capsys.readouterr()
        assert main_top([handle.app_id, "--staging", str(tmp_tony_root), "--once"]) == 0
        frame = capsys.readouterr().out
        for w in (0, 1):  # the step report and the .obs step-time histogram, piggybacked
            m = re.search(rf"worker:{w}\s+RUNNING\s+{E2E_STEPS}\s+\S+\s+\S+\s+(\d+\.\d+)", frame)
            assert m and float(m.group(1)) > 0, frame
    finally:
        stop.touch()
    final = client.monitor_application(handle, quiet=True)
    assert final == JobStatus.SUCCEEDED, handle.final_status()

    logs = tmp_tony_root / handle.app_id / "logs"
    resumed = (logs / "worker_0_r1" / "stdout.log").read_text()
    m = re.search(r"resumed from checkpoint step (\d+)", resumed)
    assert m, resumed[-3000:]
    c = int(m.group(1))
    assert 0 < c < E2E_STEPS and c % 4 == 0
    for w in (0, 1):
        out = (logs / f"worker_{w}_r1" / "stdout.log").read_text()
        assert (f"data cursor validated: resuming the global stream at batch {c} "
                "(written at world size 2, now 2)") in out, out[-3000:]
    assert not (logs / "worker_0_r2").exists()  # one restart
    # exactly once: attempt 0 trained every batch below the checkpoint, the
    # restart every batch from it, and their slots cover [0, STEPS * G) once
    first, second = _step_lines(logs / "worker_0" / "stdout.log"), _step_lines(logs / "worker_0_r1" / "stdout.log")
    assert set(range(1, c + 1)) <= set(first) and sorted(second) == list(range(c + 1, E2E_STEPS + 1))
    slots = [s for t in range(E2E_STEPS) for r in range(2) for s in TD.global_slots(t, 4, r, 2)]
    assert sorted(slots) == list(range(E2E_STEPS * 4))
    assert TD.ConsumptionCursor.load(ck, c) == TD.ConsumptionCursor(c, 4, 0, world_size=2)
    assert TD.ConsumptionCursor.load(ck, E2E_STEPS).world_size == 2

    # the losses of one process on the same global batches (every step either attempt logged)
    want = TLp.run_lm_training(TM, TM.LLAMA_TINY, TLp.LoopConfig(
        device="cpu", data_dir=str(shards), batch_size=4, seq_len=32, log_every=1, warmup_steps=2,
        steps=E2E_STEPS))["log"]
    want = {x["step"]: x["loss"] for x in want}
    for step, loss in {**first, **second}.items():
        if step <= E2E_STEPS:
            assert abs(loss - want[step]) <= E2E_LOSS_TOL * abs(want[step]), (step, loss, want[step])

    capsys.readouterr()
    assert goodput_main([handle.app_id, "--staging", str(tmp_tony_root), "--json"]) == 0
    ledger = json.loads(capsys.readouterr().out)
    assert ledger["restarts"] == 1
    assert ledger["phases_ms"].get("compile", 0) > 0 and ledger["phases_ms"].get("checkpoint", 0) > 0
    assert {"worker:0", "worker:1"} <= set(ledger["step_time_by_task_ms"])
