"""Which collectives gloo carries on CUDA tensors, two processes on one card.

    python -m tony_tpu_torch.parallel.gloo_cuda_probe

nccl refuses two ranks on one card, so a gang of two on one card runs on
gloo or not at all. Each of two processes joins a gloo group on
``cuda:0`` and runs each collective the ``fsdp`` axis needs on CUDA tensors
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``), the
``all_to_all_single`` of ``collectives.moe_all_to_all`` (no path runs it:
it is reported, not relied on), then a ``torch.distributed.checkpoint``
save and load of a tensor split over the two ranks; each result is
checked against what the collective must give.
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

CHECKS = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce", "all_to_all_single", "dcp_save_load")


def _check(results: dict, name: str, fn) -> None:
    try:
        fn()
        results[name] = "ok"
    except Exception as e:  # noqa: BLE001 — the probe reports what gloo refuses
        results[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:300] if str(e) else ''}"


def _rank(rank: int, port: int, ckpt: str, out: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
    dev = torch.device("cuda", 0)
    results: dict = {}

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

    for name, fn in zip(CHECKS, (gather, scatter, reduce, all_to_all, dcp_roundtrip)):
        _check(results, name, fn)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


def probe() -> dict:
    """Each check's result on rank 0: "ok" or the error."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "result.json")
        mp.spawn(_rank, args=(port, os.path.join(d, "ckpt"), out), nprocs=2, join=True)
        with open(out) as f:
            return json.load(f)


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device visible", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}", flush=True)
    print(json.dumps({"gloo_cuda": probe()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
