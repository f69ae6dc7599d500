"""Port parity: tony_tpu_torch.ops.ring (B9, B10 and their ring) against tony_tpu.ops.ring.

The JAX side runs ``ring_attention_pallas[_seg]`` inside ``shard_map`` over
4 of the conftest's 8 virtual CPU devices, its Pallas kernels in TPU-interpret
mode (emulated remote DMA and semaphores), as ``tests/test_ring_pallas.py``
does; the port runs the plain versions of its step kernels through
``RingAttention`` on a CPU ``DeviceRing`` of 4. Each JAX case gives its
output and its gradients from one ``jax.vjp`` and is built once per module.
Then the ring against the port's full-sequence reference for every ring
size, and a gloo gang of 2 and of 4 processes (``ProcessRing``) against the
single-process ring. Inputs come from numpy with a seed, in f32.

Tolerances: the JAX suite's own (``tests/test_ring_pallas.py:77``, ``:173``):
forward 2e-5 absolute; dq/dk/dv max error over max |ref| below 2e-4. Both
sides are f32 and differ only in the order of their sums.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from tony_tpu.compat import shard_map  # noqa: E402
from tony_tpu_torch.ops import attention as TA  # noqa: E402
from tony_tpu_torch.ops import ring as TR  # noqa: E402
from tony_tpu_torch.parallel.collectives import DeviceRing  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FWD_ATOL = 2e-5
GRAD_REL = 2e-4
B, H, HKV, D = 1, 4, 2, 64

# case → (T, causal, window, packed segments)
CASES = {
    "causal": (256, True, 0, False),
    "noncausal": (256, False, 0, False),
    "segments": (256, True, 0, True),
    "window48": (256, True, 48, False),   # < the 64-row shard: whole shards are skipped
    "short_shard": (160, True, 0, False),  # 40 rows a shard
}


def _inputs(T, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32) * 0.5
    k = rng.standard_normal((B, HKV, T, D)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, HKV, T, D)).astype(np.float32) * 0.5
    w = rng.standard_normal((B, H, T, D)).astype(np.float32)
    return q, k, v, w


def _segments(T):
    """The layout of ``tests/test_ring_pallas.py:_mk_seg``: three segments and
    trailing padding (id 0), boundaries off the shard edges."""
    seg = np.ones((B, T), np.int32)
    seg[:, T // 5 + 3:] = 2
    seg[:, 3 * T // 5 + 7:] = 3
    seg[:, -T // 8:] = 0
    return seg


def _jax_case(T, causal, window, has_seg):
    """(o, (dq, dk, dv)) of the JAX Pallas ring: one forward and one vjp."""
    from jax.experimental.pallas import tpu as pltpu

    from tony_tpu.ops.ring import ring_attention_pallas, ring_attention_pallas_seg

    q, k, v, w = _inputs(T)
    mesh = Mesh(np.array(jax.devices()[:4]), ("context",))
    spec = P(None, None, "context", None)
    ip = pltpu.InterpretParams(detect_races=True)
    if has_seg:
        seg = jnp.asarray(_segments(T))
        body = functools.partial(ring_attention_pallas_seg, axis_name="context", causal=causal,
                                 interpret=ip, window=window)
        ring = shard_map(body, mesh=mesh, in_specs=(spec, spec, spec, P(None, "context")),
                         out_specs=spec, axis_names={"context"}, check_vma=False)
        fn = jax.jit(lambda q, k, v: ring(q, k, v, seg))
    else:
        body = functools.partial(ring_attention_pallas, axis_name="context", causal=causal,
                                 interpret=ip, window=window)
        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
                               axis_names={"context"}, check_vma=False))
    o, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), tuple(np.asarray(g) for g in vjp(jnp.asarray(w)))


@functools.lru_cache(maxsize=None)
def jax_case(name):
    return _jax_case(*CASES[name])


def _port(T, causal, window, has_seg, ring):
    q, k, v, w = _inputs(T)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    if has_seg:
        o = TR.ring_attention_pallas_seg(tq, tk, tv, torch.from_numpy(_segments(T)), ring,
                                         causal=causal, window=window)
    else:
        o = TR.ring_attention_pallas(tq, tk, tv, ring, causal=causal, window=window)
    (o * torch.from_numpy(w)).sum().backward()
    return o.detach().numpy(), (tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy())


def _assert_grads(got, want, what):
    for name, g, ref in zip(("dq", "dk", "dv"), got, want):
        err = np.abs(g - ref).max() / (np.abs(ref).max() + 1e-9)
        assert err < GRAD_REL, f"{what} {name}: rel err {err}"


@pytest.mark.parametrize("case", list(CASES))
def test_ring_matches_the_jax_pallas_ring(case):
    """Plain B9/B10 through ``RingAttention`` on a DeviceRing of 4 against
    the JAX Pallas ring kernels in interpret mode: o, then dq, dk, dv."""
    want_o, want_g = jax_case(case)
    got_o, got_g = _port(*CASES[case], DeviceRing(4, "cpu"))
    np.testing.assert_allclose(got_o, want_o, atol=FWD_ATOL, rtol=0)
    _assert_grads(got_g, want_g, case)


def _reference(T, causal, window, has_seg):
    q, k, v, w = _inputs(T)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    seg = torch.from_numpy(_segments(T)) if has_seg else None
    o = TA.attention_reference(tq, TA.repeat_kv(tk, H // HKV), TA.repeat_kv(tv, H // HKV),
                               causal=causal, window=window, segment_ids=seg)
    (o * torch.from_numpy(w)).sum().backward()
    return o.detach().numpy(), (tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy())


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["causal", "noncausal", "segments", "window48"])
def test_device_ring_of_every_size_matches_full_attention(n, case):
    """The ring on a DeviceRing of n shards against the port's
    full-sequence ``attention_reference``, forward and gradients."""
    want_o, want_g = _reference(*CASES[case])
    got_o, got_g = _port(*CASES[case], DeviceRing(n, "cpu"))
    np.testing.assert_allclose(got_o, want_o, atol=FWD_ATOL, rtol=0)
    _assert_grads(got_g, want_g, f"{case} n={n}")


def test_schedule_skips_like_the_tpu_kernels(monkeypatch):
    """Launches of the plain steps follow ``fwd_step_runs``/``bwd_step_runs``:
    causal, n=4, 64-row shards: the forward runs each shard's own step, its
    last step and the past shards in between (4+3+2+4 = 13 of 16); the
    backward its own step and the past shards (4+3+2+1 = 10); a window of
    48 keeps only the shard just before (forward 4+3+0+4, backward 4+3)."""
    runs = lambda f, n, w: sum(f(my, s, n, 64, True, w) for my in range(n) for s in range(n))  # noqa: E731
    assert runs(TR.fwd_step_runs, 4, 0) == 13 and runs(TR.bwd_step_runs, 4, 0) == 10
    assert runs(TR.fwd_step_runs, 4, 48) == 11 and runs(TR.bwd_step_runs, 4, 48) == 7
    assert all(TR.fwd_step_runs(my, s, 4, 64, False, 0) for my in range(4) for s in range(4))
    names = ("ring_fwd_step_plain", "ring_bwd_dq_step_plain", "ring_bwd_dkv_step_plain")
    calls = []
    for name in names:
        monkeypatch.setattr(TR, name, functools.partial(
            lambda orig, nm, *a, **kw: calls.append(nm) or orig(*a, **kw), getattr(TR, name), name))
    _port(256, True, 48, False, DeviceRing(4, "cpu"))
    assert [calls.count(x) for x in names] == [11, 7, 7]
    assert TR.launches == {"ring_fwd": 0, "ring_bwd_dq": 0, "ring_bwd_dkv": 0}  # no kernel on the CPU


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The shape checks run before any launch (the kernels themselves need a
    card): a wrong head_dim, dtype or layout raises."""
    q = torch.zeros(1, 4, 8, 64)
    k = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="head_dim"):
        TR._check(torch.zeros(1, 4, 8, 96), torch.zeros(1, 2, 8, 96), {}, {}, None, None)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        TR._check(q.half(), k.half(), {}, {}, None, None)
    with pytest.raises(ValueError, match="strides"):
        TR._check(q, k, {"o": (torch.zeros(1, 4, 64, 8).transpose(2, 3), torch.float32, True)},
                  {}, None, None)
    assert TR._check(torch.zeros(1, 4, 32, 64)[:, :, 8:16], k, {}, {"k": (k, torch.float32)},
                     None, None) == (32, 0)
    with pytest.raises(ValueError, match="does not split"):
        TR.ring_attention_pallas(torch.zeros(1, 4, 10, 64), torch.zeros(1, 2, 10, 64),
                                 torch.zeros(1, 2, 10, 64), DeviceRing(4, "cpu"))


# -- ProcessRing: one shard per process, gloo -------------------------------------

_GANG = r"""
import sys, datetime
import numpy as np, torch, torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from tony_tpu_torch.ops import ring as TR
from tony_tpu_torch.ops.attention import mha, repeat_kv
from tony_tpu_torch.parallel import context as TC
from tony_tpu_torch.parallel.collectives import ProcessRing
rank, n, store, out = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n,
                        timeout=datetime.timedelta(seconds=60))
ring = ProcessRing()
rng = np.random.default_rng(3)
T = 256
q, k, v, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32) * c)
              for s, c in (((1, 4, T, 64), .5), ((1, 2, T, 64), .5), ((1, 2, T, 64), .5),
                           ((1, 4, T, 64), 1.)))
seg = np.ones((1, T), np.int32); seg[:, 54:] = 2; seg[:, 160:] = 3; seg[:, -32:] = 0
sl = slice(rank * T // n, (rank + 1) * T // n)
res = {}
for name, fn in (
        ("packed_window", lambda a, b, c: TR.ring_attention_pallas_seg(
            a, b, c, torch.from_numpy(seg[:, sl]), ring, causal=True, window=48)),
        ("noncausal", lambda a, b, c: TR.ring_attention_pallas(a, b, c, ring, causal=False)),
        ("xla", lambda a, b, c: TC.ring_attention(a, repeat_kv(b, 2), repeat_kv(c, 2), ring=ring)),
        ("ulysses", lambda a, b, c: TC.ulysses_attention(
            a, repeat_kv(b, 2), repeat_kv(c, 2), ring=ring, attn_fn=lambda x, y, z: mha(x, y, z)))):
    a, b, c = (t[:, :, sl].clone().requires_grad_(True) for t in (q, k, v))
    o = fn(a, b, c)
    (o * w[:, :, sl]).sum().backward()
    res[name] = [o.detach(), a.grad, b.grad, c.grad]
torch.save(res, out)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("n", [2, 4])
def test_process_ring_gang_matches_the_device_ring(n, tmp_path):
    """A gloo gang of n processes on a FileStore, one shard each, runs the
    ring kernels' plain versions (packed segments with a window, and
    non-causal), the plain PyTorch ring and Ulysses; each rank's o, dq, dk
    and dv equal the matching shard of the same run on a DeviceRing of n to
    1e-6 (the same sums in the same order, up to gloo's copies)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", _GANG, str(ROOT), str(r), str(n),
                               str(tmp_path / "store"), str(tmp_path / f"rank{r}.pt")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]

    from tony_tpu_torch.parallel import context as TC

    T = 256
    q, k, v, w = (torch.from_numpy(a) for a in _inputs(T))
    seg = torch.from_numpy(_segments(T))
    assert seg[0].tolist() == np.r_[[1] * 54, [2] * 106, [3] * 64, [0] * 32].tolist()
    ring = DeviceRing(n, "cpu")
    runs = {
        "packed_window": lambda a, b, c: TR.ring_attention_pallas_seg(a, b, c, seg, ring, window=48),
        "noncausal": lambda a, b, c: TR.ring_attention_pallas(a, b, c, ring, causal=False),
        "xla": lambda a, b, c: TC.ring_attention(a, TA.repeat_kv(b, 2), TA.repeat_kv(c, 2), ring=ring),
        "ulysses": lambda a, b, c: TC.ulysses_attention(
            a, TA.repeat_kv(b, 2), TA.repeat_kv(c, 2), ring=ring, attn_fn=lambda x, y, z: TA.mha(x, y, z)),
    }
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(n)]
    for name, fn in runs.items():
        a, b, c = (t.clone().requires_grad_(True) for t in (q, k, v))
        o = fn(a, b, c)
        (o * w).sum().backward()
        whole = [o.detach(), a.grad, b.grad, c.grad]
        for r in range(n):
            sl = slice(r * T // n, (r + 1) * T // n)
            for what, mine, ref in zip(("o", "dq", "dk", "dv"), got[r][name], whole):
                torch.testing.assert_close(mine, ref[:, :, sl], atol=1e-6, rtol=0,
                                           msg=f"{name} rank {r} {what}")
