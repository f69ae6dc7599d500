"""The port's asynchronous checkpoint saves on the CPU.

``CheckpointManager`` saves in a background thread by default, as the JAX
manager does through Orbax: ``save`` returns once the state is copied to
host buffers, while its ``torch.save`` is still blocked on a gate; the step
appears only when the write publishes it (a restore meanwhile takes the
previous step and never reads the ``.tmp-*`` directory); a process killed
during a write resumes from the previous step; a writer's error is raised by
the next ``save`` or ``wait``; ``use_async`` False and True restore equal
state; and a gloo gang of 2 agrees on every save and on ``saved_step``, and
acknowledges an urgent save only once its write has ended.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from tony_tpu_torch.models import llama as TM  # noqa: E402
from tony_tpu_torch.train import checkpoint as TC  # noqa: E402
from tony_tpu_torch.train import trainer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


class _Gate:
    """``torch.save`` that blocks until ``release`` is set."""

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()
        self.real = torch.save

    def __call__(self, obj, path):
        self.entered.set()
        if not self.release.wait(60):
            raise TimeoutError("the gate was never released")
        self.real(obj, path)


def _state(value: float, step: int) -> dict:
    return {"params": {"w": torch.full((4,), value)}, "opt_state": {"count": step}, "step": step}


def _restore(ck) -> tuple[dict, int]:
    state, mgr, step = TC.restore_or_init(
        str(ck), lambda: {"w": torch.zeros(4)},
        lambda s, saved: {"w": s["w"].copy_(saved["params"]["w"])})
    mgr.close()
    return state, step


def test_save_returns_before_its_write_and_the_step_appears_when_published(tmp_path, monkeypatch):
    ck = tmp_path / "ck"
    mgr = TC.CheckpointManager(str(ck))
    mgr.save(1, _state(1.0, 1))
    mgr.wait()
    gate = _Gate()
    monkeypatch.setattr(torch, "save", gate)
    state = _state(2.0, 2)
    assert mgr.save(2, state) and mgr.saved_step == 2
    assert gate.entered.wait(30)
    state["params"]["w"].add_(100.0)  # the optimizer's in-place update after the save returned
    # in flight: only the private directory exists, and a restore takes step 1
    assert mgr.all_steps() == [1] and [p.name for p in ck.glob(".tmp-2-*")]
    restored, step = _restore(ck)
    assert step == 1 and torch.equal(restored["w"], torch.full((4,), 1.0))
    gate.release.set()
    mgr.wait()
    assert mgr.all_steps() == [1, 2] and not list(ck.glob(".tmp-*"))
    restored, step = _restore(ck)
    assert step == 2 and torch.equal(restored["w"], torch.full((4,), 2.0))  # the state as saved
    assert not mgr.save(2, state)  # not past saved_step


_KILLED = """
import os, sys, threading, torch
from tony_tpu_torch.train import checkpoint as TC
ck = sys.argv[1]
mgr = TC.CheckpointManager(ck)
mgr.save(1, {"params": {"w": torch.full((4,), 1.0)}, "opt_state": {"count": 1}, "step": 1})
mgr.wait()
entered = threading.Event()
def gated(obj, path):
    entered.set()
    threading.Event().wait()  # never returns
torch.save = gated
mgr.save(2, {"params": {"w": torch.full((4,), 2.0)}, "opt_state": {"count": 2}, "step": 2})
entered.wait(60)
os._exit(0)  # killed with the write of step 2 in flight
"""


def test_a_process_killed_during_a_write_resumes_from_the_previous_step(tmp_path):
    ck = tmp_path / "ck"
    out = subprocess.run([sys.executable, "-c", _KILLED, str(ck)], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stdout + out.stderr
    assert [p.name for p in ck.iterdir() if p.name.startswith(".tmp-2-")]
    restored, step = _restore(ck)
    assert step == 1 and torch.equal(restored["w"], torch.full((4,), 1.0))


@pytest.mark.parametrize("raised_by", ["save", "wait"])
def test_a_write_error_is_raised_by_the_next_save_or_wait(tmp_path, monkeypatch, raised_by):
    def broken(obj, path):
        raise OSError("no space left on device")

    monkeypatch.setattr(torch, "save", broken)
    mgr = TC.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(1, _state(1.0, 1))  # dispatched: the write fails in the background
    with pytest.raises(RuntimeError, match="checkpoint write of step 1 failed") as err:
        mgr.save(2, _state(2.0, 2)) if raised_by == "save" else mgr.wait()
    assert isinstance(err.value.__cause__, OSError)
    mgr.wait()  # raised once
    assert mgr.all_steps() == []


def test_sync_and_async_saves_restore_equal_state(tmp_path):
    """The tiny model trained 3 steps with a save after steps 2 and 3 into
    a synchronous and an asynchronous manager: both restore each step to
    the same tensors, and step 3 to the trained state."""
    cfg = TM.config_from_dict({"preset": "tiny", "dtype": "float32"})
    opt = TT.OptimizerConfig(learning_rate=1e-2, warmup_steps=1, total_steps=3).build()
    state = TT.TrainState.create(TM.init(torch.Generator().manual_seed(0), cfg, "cpu"), opt)
    step_fn = TT.make_train_step(lambda p, b: TM.loss_fn(p, b, cfg), opt)
    mgrs = {mode: TC.CheckpointManager(str(tmp_path / mode), use_async=mode == "async")
            for mode in ("sync", "async")}
    gen = torch.Generator().manual_seed(1)
    for step in (1, 2, 3):
        state, _ = step_fn(state, TM.synthetic_batch(gen, 2, 16, cfg))
        if step >= 2:
            for mgr in mgrs.values():
                mgr.save(step, state.state_dict())
    for mgr in mgrs.values():
        mgr.close()
    for step in (2, 3):
        sync, asyn = (mgrs[m].restore(step) for m in ("sync", "async"))
        assert sync["step"] == asyn["step"] == step
        for part in ("params", "opt_state"):
            a, b = dict(TT._leaves(sync[part])), dict(TT._leaves(asyn[part]))
            assert a.keys() == b.keys()
            for name in a:
                assert (torch.equal(a[name], b[name]) if torch.is_tensor(a[name]) else a[name] == b[name]), name
    final = TT.TrainState.create(TM.init(torch.Generator().manual_seed(5), cfg, "cpu"), opt)
    final.load(mgrs["async"].restore(3))
    for (name, a), (_, b) in zip(TT._leaves(final.params), TT._leaves(state.params)):
        assert torch.equal(a, b), name


# each rank of a gloo gang: run_lm_training with a slow torch.save, recording
# every CheckpointManager.save (step, whether it saved, saved_step) and, on an
# urgent save's acknowledgement, whether the step was published by then
_RANK = """
import json, os, sys, time, torch
from tony_tpu_torch.models import llama
from tony_tpu_torch.train import checkpoint as C, loop
kw = json.loads(sys.argv[1])
real_save, real_mgr_save, real_ack = torch.save, C.CheckpointManager.save, C.UrgentSaveSignal.acknowledge
calls = []

def slow_save(obj, path):
    time.sleep(0.3)
    real_save(obj, path)

def save(self, step, state, *, force=False):
    did = real_mgr_save(self, step, state, force=force)
    calls.append(["save", step, did, self.saved_step])
    return did

def ack(self, req_id, step):
    calls.append(["ack", step, os.path.isdir(os.path.join(kw["checkpoint_dir"], str(step)))])
    real_ack(self, req_id, step)

torch.save, C.CheckpointManager.save, C.UrgentSaveSignal.acknowledge = slow_save, save, ack
cfg = llama.config_from_dict({"preset": "tiny", "dtype": "float32"})
loop.run_lm_training(llama, cfg, loop.LoopConfig(device="cpu", **kw))
print("CALLS " + json.dumps(calls))
"""


def test_gloo_gang_agrees_on_every_save_and_acknowledges_after_the_write(tmp_path):
    """Rank 0 has a drain request from the start: both ranks force a save at
    step 1 (agreed over the gang), rank 0 answers only once step 1 is on
    disk; the periodic saves at 2 and 4 follow on both ranks alike."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "worker_0.json.drain").write_text(json.dumps({"req_id": "drain-1"}))
    ck = tmp_path / "ck"
    kw = dict(steps=4, batch_size=4, seq_len=16, log_every=1, warmup_steps=1, checkpoint_every=2,
              checkpoint_dir=str(ck))
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), INIT_METHOD=f"tcp://127.0.0.1:{port}",
                   OMP_NUM_THREADS="1", TONY_PROFILE_POLL_MS="50",
                   TONY_TRAIN_METRICS_FILE=str(metrics / f"worker_{rank}.json"))
        procs.append(subprocess.Popen([sys.executable, "-c", textwrap.dedent(_RANK), json.dumps(kw)], cwd=ROOT,
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:  # a rank left waiting on a collective
            if p.poll() is None:
                p.kill()
                p.wait()
    calls = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        calls.append(json.loads(next(x for x in out.splitlines() if x.startswith("CALLS "))[6:]))
    saves = [["save", 1, True, 1], ["save", 2, True, 2], ["save", 4, True, 4]]
    assert [c for c in calls[0] if c[0] == "save"] == [c for c in calls[1] if c[0] == "save"] == saves
    assert [c for c in calls[0] if c[0] == "ack"] == [["ack", 1, True]]
    assert not [c for c in calls[1] if c[0] == "ack"]
    assert json.loads((metrics / "worker_0.json.drain.done").read_text()) == {"req_id": "drain-1", "step": 1}
    assert sorted(int(p.name) for p in ck.iterdir() if p.name.isdigit()) == [1, 2, 4]
