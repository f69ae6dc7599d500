"""Port parity for the MNIST MLP (``tony_tpu_torch.models.mlp``) on the CPU, in f32.

The config against the JAX package's; forward, ``loss_fn`` (loss, accuracy)
and every gradient against the JAX model on bridged weights; a 5-step
trajectory through ``make_train_step`` with ``train_mnist``'s AdamW against
the JAX trainer; the mesh refusal; ``train_mnist --device cpu`` printing
the JAX program's lines, in process and as a one-worker ``tony submit``
(framework pytorch).
"""

import dataclasses
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tony_tpu.models import mlp as JM  # noqa: E402
from tony_tpu.train import trainer as JT  # noqa: E402
from tony_tpu_torch.models import mlp as TM  # noqa: E402
from tony_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from tony_tpu_torch.train import train_mnist  # noqa: E402
from tony_tpu_torch.train import trainer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# f32 both sides, three products of K <= 784 summed in another order
REL = 1e-5
NORM_REL = 1e-5  # a parameter leaf after 5 AdamW steps, in relative norm
STEP_LINE = re.compile(r"step (\d+) loss=(\d+\.\d{4}) acc=(\d\.\d{3})")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), JM.MLPConfig()))


def _batch(seed, B=32):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0, 1, (B, 784)).astype(np.float32), "label": rng.integers(0, 10, B).astype(np.int32)}


def test_config_and_parameter_tree_are_jaxs(weights):
    assert [(f.name, f.default) for f in dataclasses.fields(TM.MLPConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(JM.MLPConfig)]
    cfg = TM.MLPConfig()
    assert cfg.num_params() == JM.MLPConfig().num_params() == 669_706
    got = TM.init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert {n: tuple(t.shape) for n, t in _leaves(got)} == {n: v.shape for n, v in _leaves(weights)}
    assert sum(t.numel() for _, t in _leaves(got)) == cfg.num_params()


def test_forward_loss_accuracy_and_grads_match_jax(weights):
    b = _batch(1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, jaux), jgrads = jax.value_and_grad(lambda p: JM.loss_fn(p, jb, JM.MLPConfig()), has_aux=True)(
        jax.tree.map(jnp.asarray, weights))
    params = params_from_numpy(weights, "cpu")
    names, tensors = zip(*_leaves(params))
    for t in tensors:
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    logits = TM.forward(params, tb["image"], TM.MLPConfig())
    assert _rel(logits.detach().numpy(), JM.forward(jax.tree.map(jnp.asarray, weights), jb["image"],
                                                    JM.MLPConfig())) <= REL
    loss, aux = TM.loss_fn(params, tb, TM.MLPConfig())
    assert abs(loss.item() - float(jloss)) <= REL * abs(float(jloss))
    assert aux["accuracy"].item() == float(jaux["accuracy"])
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    for name, g in zip(names, torch.autograd.grad(loss, tensors)):
        assert _rel(g.numpy(), want[name]) <= REL, name


def test_five_step_trajectory_with_train_mnists_optimizer_matches_jax(weights):
    """``train_mnist``'s AdamW (1e-3, no warmup, 200 steps): each step's loss
    and grad norm, and every parameter after 5 steps."""
    opt_cfg = dict(learning_rate=1e-3, warmup_steps=0, total_steps=train_mnist.STEPS)
    batches = [_batch(10 + i) for i in range(5)]
    jopt = JT.OptimizerConfig(**opt_cfg).build()
    jstate = JT.TrainState.create(jax.tree.map(jnp.asarray, weights), jopt)
    jstep = JT.make_train_step(lambda p, b: JM.loss_fn(p, b, JM.MLPConfig()), jopt)
    want = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        want.append((float(m["loss"]), float(m["grad_norm"]), float(m["accuracy"])))
    topt = TT.OptimizerConfig(**opt_cfg).build()
    state = TT.TrainState.create(params_from_numpy(weights, "cpu"), topt)
    tstep = TT.make_train_step(lambda p, b: TM.loss_fn(p, b, TM.MLPConfig()), topt)
    got = []
    for b in batches:
        state, m = tstep(state, {k: torch.from_numpy(v) for k, v in b.items()})
        got.append((float(m["loss"]), float(m["grad_norm"]), float(m["accuracy"])))
    for (tl, tg, ta), (jl, jg, ja) in zip(got, want):
        assert abs(tl - jl) <= REL * abs(jl) and abs(tg - jg) <= 1e-4 * abs(jg) and ta == ja, (got, want)
    # each leaf in relative norm: Adam's normalised step turns the rounding
    # noise of a gradient element that nearly cancels into a few percent of a
    # step (2.9e-5 on one element of layer_1/w, whose max is 0.2), which a
    # max-based check reads as 1.5e-4, while a missing weight decay moves the
    # whole leaf by 5e-4 of its norm
    jparams = dict(_leaves(jax.tree.map(np.asarray, jstate.params)))
    for name, p in _leaves(state.params):
        d = p.detach().numpy() - jparams[name]
        assert np.linalg.norm(d) <= NORM_REL * np.linalg.norm(jparams[name]), name


def test_a_mesh_beyond_the_data_axis_is_refused_naming_a8():
    params = TM.init(torch.Generator().manual_seed(0), TM.MLPConfig(), "cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        TM.forward(params, torch.zeros(1, 784), TM.MLPConfig(), mesh=object())


def _check_lines(text: str) -> None:
    lines = [STEP_LINE.fullmatch(x) for x in text.splitlines() if x.startswith("step ")]
    assert [int(m.group(1)) for m in lines] == list(range(train_mnist.LOG_EVERY, train_mnist.STEPS + 1,
                                                           train_mnist.LOG_EVERY))
    # labels are random each step: the loss stays near ln 10
    assert all(abs(float(m.group(2)) - math.log(10)) <= 0.5 for m in lines), text


def test_train_mnist_prints_the_jax_programs_lines(capsys):
    assert train_mnist.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "[train_mnist] device cpu"
    _check_lines(out)


@pytest.mark.e2e
def test_tony_submit_runs_train_mnist_on_a_pytorch_worker(tmp_tony_root):
    from tony_tpu.cluster.client import Client
    from tony_tpu.cluster.session import JobStatus
    from tony_tpu.config import TonyConfig, keys

    cmd = (f"export OMP_NUM_THREADS=2 PYTHONPATH={ROOT} && cd {ROOT} && "
           f"{sys.executable} -m tony_tpu_torch.train.train_mnist --device cpu")
    cfg = TonyConfig({
        keys.AM_MONITOR_INTERVAL_MS: "50", keys.TASK_HEARTBEAT_INTERVAL_MS: "100",
        keys.STAGING_ROOT: str(tmp_tony_root), "tony.worker.instances": "1",
        keys.APPLICATION_FRAMEWORK: "pytorch", keys.EXECUTES: cmd,
    })
    client = Client(cfg)
    handle = client.submit()
    final = client.monitor_application(handle, quiet=True)
    assert final == JobStatus.SUCCEEDED, handle.final_status()
    _check_lines((tmp_tony_root / handle.app_id / "logs" / "worker_0" / "stdout.log").read_text())
