"""Joining a training gang: the single-process part.

Counterpart of ``tony_tpu/runtime/__init__.init_distributed``. Under
``tony submit`` the torch runtime adapter exports ``WORLD_SIZE``/``RANK``
(and the JAX adapter ``JAX_NUM_PROCESSES``); a gang of more than one
process needs the gloo/nccl process group, which is not ported yet.
"""

from __future__ import annotations

import os

from tony_tpu_torch import constants


def world_size_from_env(env: dict[str, str] | None = None) -> int:
    env = os.environ if env is None else env
    sizes = [int(env.get(name, "1") or "1")
             for name in (constants.ENV_WORLD_SIZE, constants.ENV_JAX_NUM_PROCESSES)]
    return max(sizes)


def init_distributed() -> None:
    """No-op for a single process; raises when the env names a larger gang."""
    n = world_size_from_env()
    if n > 1:
        raise NotImplementedError(
            f"the environment names a gang of {n} processes; multi-process training "
            "(gloo/nccl process group) is not ported yet (ROADMAP queue A6)")
