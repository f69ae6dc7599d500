"""``tony serve`` with port replicas.

    python -m tony_tpu_torch_launch.serve <tony serve flags> [--device cuda|cpu]

Builds the job exactly as ``tony serve`` does (``tony_tpu.cli.serve.
build_serve_config``: replicas, the disaggregated prefill tier, router,
autoscaler, every ``--conf``), then rewrites the ``serve`` COMMAND key, and
the ``prefill`` key when disaggregation is on, to run
``tony_tpu_torch.models.serving_http`` with the same forwarded engine flags
plus ``--device`` (``cuda`` unless asked otherwise), and hands the job to
``submit_serve``: the fleet router, health monitors and coordinator run in
this process as they do for JAX replicas.
"""

from __future__ import annotations

import argparse
import shlex
import sys

from tony_tpu import constants
from tony_tpu.cli.serve import build_serve_config, submit_serve
from tony_tpu.config import TonyConfig, keys

JAX_SERVER = "tony_tpu.models.serving_http"
PORT_SERVER = "tony_tpu_torch.models.serving_http"


def _port_command(cmd: str, device: str) -> str:
    """The JAX replica's command with the port's server and ``--device``."""
    argv = shlex.split(cmd)
    at = next((i for i in range(len(argv) - 1) if argv[i:i + 2] == ["-m", JAX_SERVER]), None)
    if at is None:
        raise ValueError(f"not a JAX serving command: {cmd!r}")
    return shlex.join([sys.executable, "-m", PORT_SERVER, "--device", device, *argv[at + 2:]])


def build_config(argv: list[str]) -> tuple[TonyConfig, argparse.Namespace]:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the port's replicas run (default: the card)")
    ours, rest = p.parse_known_args(argv)
    config, args = build_serve_config(rest)
    jobs = [constants.SERVE_JOB_NAME]
    if config.get_bool(keys.SERVE_DISAGG_ENABLED, False):
        jobs.append(constants.PREFILL_JOB_NAME)
    for job in jobs:
        key = keys.jobtype_key(job, keys.COMMAND_SUFFIX)
        config.set(key, _port_command(config.get(key), ours.device))
    return config, args


def main(argv: list[str] | None = None) -> int:
    config, args = build_config(list(sys.argv[1:] if argv is None else argv))
    return submit_serve(config, url_timeout_s=args.url_timeout_s, no_router=args.no_router)


if __name__ == "__main__":
    sys.exit(main())
