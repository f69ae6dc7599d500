"""Which collectives gloo carries on CUDA tensors, two processes on one card.

    python -m tony_tpu_torch.parallel.gloo_cuda_probe

nccl refuses two ranks on one card, so a gang of two on one card runs on
gloo or not at all. Each of two processes joins a gloo group on
``cuda:0`` and runs each collective the ``fsdp`` axis needs on CUDA tensors
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``), the
``all_to_all_single`` of ``collectives.moe_all_to_all`` and of Ulysses,
the context ring's shift to the right neighbour as ``ProcessRing`` sends it
on gloo (``all_to_all_single`` with split sizes, one buffer each way, run
asynchronously and waited on), then a ``torch.distributed.checkpoint``
save and load of a tensor split over the two ranks; each result is
checked against what the collective must give. Then gloo's point-to-point
on CUDA tensors, ``isend``/``irecv`` and ``batch_isend_irecv``, each in a
pair of processes of its own under a deadline, since gloo hands its
transport the tensor's data pointer and a CUDA one may crash the process
or hang it: such a check reads "process died: ..." or "hung: ...".
Prints the torch version and one JSON line: each check, ``"ok"`` or the
error it raised. Exits 0 when every check ran (passed or not), 2 without a
card.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CHECKS = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce", "all_to_all_single",
          "ring_shift_all_to_all", "dcp_save_load")
#: gloo's point-to-point on CUDA tensors, each probed in processes of its own
P2P_CHECKS = ("isend_irecv", "batch_isend_irecv")
#: seconds a point-to-point pair may take before it is reported as hung
P2P_DEADLINE_S = 60.0


def _check(results: dict, name: str, fn) -> None:
    try:
        fn()
        results[name] = "ok"
    except Exception as e:  # noqa: BLE001 — the probe reports what gloo refuses
        results[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:300] if str(e) else ''}"


def _rank(rank: int, port: int, ckpt: str, out: str, checks: tuple = CHECKS) -> None:
    import datetime

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=P2P_DEADLINE_S / 2))
    dev = torch.device("cuda", 0)
    results: dict = {}
    peer = 1 - rank

    def gather():
        x = torch.full((4,), float(rank + 1), device=dev)
        got = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(got, x)
        assert got.tolist() == [1.0] * 4 + [2.0] * 4, got.tolist()

    def scatter():
        x = torch.arange(8, dtype=torch.float32, device=dev) * (rank + 1)
        got = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(got, x)
        want = (torch.arange(8, dtype=torch.float32) * 3)[rank * 4:(rank + 1) * 4]
        assert got.cpu().tolist() == want.tolist(), got.tolist()

    def reduce():
        x = torch.full((3,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        assert x.tolist() == [3.0] * 3, x.tolist()

    def all_to_all():
        # rank r sends block j of [r*4 + 0..3] to rank j
        x = torch.arange(4, dtype=torch.float32, device=dev) + 4 * rank
        got = torch.empty(4, device=dev)
        dist.all_to_all_single(got, x)
        want = [float(4 * src + 2 * rank + i) for src in range(2) for i in range(2)]
        assert got.tolist() == want, got.tolist()

    def ring_shift():
        # rank r sends 6 values to its right neighbour and receives its left's;
        # a kernel writes the buffer just before and reads the result just after
        x = torch.arange(6, dtype=torch.float32, device=dev).mul_(rank + 1).add_(10 * rank)
        got = torch.empty(6, device=dev)
        splits = [0, 0]
        splits[peer] = 6
        work = dist.all_to_all_single(got, x, output_split_sizes=splits, input_split_sizes=splits,
                                      async_op=True)
        work.wait()
        got = got * 1.0
        want = [float(v) * (peer + 1) + 10 * peer for v in range(6)]
        assert got.tolist() == want, got.tolist()

    def p2p():
        x = torch.full((5,), float(rank + 1), device=dev)
        got = torch.zeros(5, device=dev)
        works = [dist.isend(x, peer), dist.irecv(got, peer)]
        for w in works:
            w.wait()
        assert got.tolist() == [float(peer + 1)] * 5, got.tolist()

    def batch_p2p():
        x = torch.full((5,), float(rank + 1), device=dev)
        got = torch.zeros(5, device=dev)
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer), dist.P2POp(dist.irecv, got, peer)]):
            w.wait()
        assert got.tolist() == [float(peer + 1)] * 5, got.tolist()

    def dcp_roundtrip():
        import torch.distributed.checkpoint as dcp
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor, Shard

        mesh = DeviceMesh("cuda", torch.arange(2))
        full = torch.arange(16, dtype=torch.float32).reshape(4, 4)
        local = full.chunk(2, 1)[rank].contiguous().to(dev)
        dcp.save({"w": DTensor.from_local(local, mesh, [Shard(1)], run_check=False)}, checkpoint_id=ckpt)
        back = {"w": DTensor.from_local(torch.zeros_like(local), mesh, [Shard(1)], run_check=False)}
        dcp.load(back, checkpoint_id=ckpt)
        assert torch.equal(back["w"].to_local().cpu(), local.cpu())

    fns = {"all_gather_into_tensor": gather, "reduce_scatter_tensor": scatter, "all_reduce": reduce,
           "all_to_all_single": all_to_all, "ring_shift_all_to_all": ring_shift, "dcp_save_load": dcp_roundtrip,
           "isend_irecv": p2p, "batch_isend_irecv": batch_p2p}
    for name in checks:
        _check(results, name, fns[name])
    if rank == 0:
        with open(out, "w") as f:
            json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pair(checks: tuple, d: str) -> dict:
    """``checks`` run by a pair of processes; rank 0's results, or each check
    "process died: ..." / "hung: ..." when the pair did not end cleanly."""
    out = os.path.join(d, "-".join(checks) + ".json")
    ctx = mp.start_processes(_rank, args=(_free_port(), os.path.join(d, "ckpt"), out, checks), nprocs=2,
                             join=False, start_method="spawn")
    import time

    deadline = time.monotonic() + P2P_DEADLINE_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                return {c: f"hung: no result in {P2P_DEADLINE_S:.0f} s" for c in checks}
    except Exception as e:  # noqa: BLE001 — a crashed rank is the answer being probed
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        lines = [ln.strip() for ln in str(e).strip().splitlines() if ln.strip()]
        return {c: f"process died: {type(e).__name__}: {(lines[-1] if lines else '')[:300]}" for c in checks}
    with open(out) as f:
        return json.load(f)


def probe() -> dict:
    """Each check's result on rank 0: "ok" or the error."""
    with tempfile.TemporaryDirectory() as d:
        results = _pair(CHECKS, d)
        for check in P2P_CHECKS:
            results.update(_pair((check,), d))
        return results


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device visible", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}", flush=True)
    print(json.dumps({"gloo_cuda": probe()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
