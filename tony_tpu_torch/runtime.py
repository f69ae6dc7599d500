"""Joining a training gang.

Counterpart of ``tony_tpu/runtime/__init__.init_distributed``. Under
``tony submit`` with ``tony.application.framework=pytorch`` the torch
runtime adapter exports the rendezvous (``MASTER_ADDR``/``MASTER_PORT``,
``INIT_METHOD``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``); a gang of more
than one process joins a ``torch.distributed`` process group from it, gloo
on the CPU and nccl on cards. One process joins nothing, as JAX's does not,
so the same program runs under ``tony submit`` and as bare python.

A gang restarted after a node loss rendezvouses again on the same
coordinator address: rank 0's store binds the port anew, and the others
retry their connection until ``RENDEZVOUS_TIMEOUT``.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from tony_tpu_torch import constants

#: how long a rank waits for the rendezvous and for each collective before
#: it raises (a peer lost mid-step surfaces as this timeout, if the AM has
#: not killed the gang first)
RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=300)


def world_size_from_env(env: dict[str, str] | None = None) -> int:
    env = os.environ if env is None else env
    sizes = [int(env.get(name, "1") or "1")
             for name in (constants.ENV_WORLD_SIZE, constants.ENV_JAX_NUM_PROCESSES)]
    return max(sizes)


def init_distributed(device: torch.device) -> torch.device:
    """Join the gang's process group when the env names more than one
    process; returns the device this process trains on (``cuda:LOCAL_RANK``
    in a gang on cards, else ``device``). A no-op for one process and when
    the group is already joined."""
    env = os.environ
    n = world_size_from_env(env)
    if n <= 1:
        return device
    if constants.ENV_WORLD_SIZE not in env or constants.ENV_RANK not in env:
        raise RuntimeError(
            f"the environment names a gang of {n} processes without the torch.distributed "
            "rendezvous (RANK, WORLD_SIZE, MASTER_ADDR/PORT); launch it with "
            "tony.application.framework=pytorch")
    if device.type == "cuda":
        device = torch.device("cuda", int(env.get(constants.ENV_LOCAL_RANK, "0") or 0))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    init_method = env.get(constants.ENV_INIT_METHOD) or (
        f"tcp://{env[constants.ENV_MASTER_ADDR]}:{env[constants.ENV_MASTER_PORT]}")
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=init_method,
        world_size=int(env[constants.ENV_WORLD_SIZE]), rank=int(env[constants.ENV_RANK]),
        timeout=RENDEZVOUS_TIMEOUT)
    return device


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def shutdown_distributed() -> None:
    """Leave the gang's process group (idempotent), so every rank exits 0."""
    if dist.is_initialized():
        dist.destroy_process_group()
