"""Mixtral (MoE) pretraining, the port's counterpart of ``examples/mixtral/pretrain.py``:
one process on one device, or a gang under ``tony submit`` (framework
pytorch) on the data and fsdp axes, whose router losses are taken over the
gang's global batch (``mixtral.loss_fn``'s ``group``), with
``--model_axis N`` on the model axis too (each expert's F over N ranks) or
``--expert_axis N`` on the expert axis (E/N whole experts a rank), or
``--context_axis N`` on the context axis (a window of the sequence a rank,
as Llama's), with ``--model_axis M`` beside it in a gang of ``N·M`` times
the data × fsdp workers. ``--moe_dispatch`` picks JAX's dispatch (ragged,
ragged_xla, gather, dense) and ``--capacity_factor`` the capacity
dispatches' slots, which in a context gang are the whole row's.
``--stage_axis S --pp_microbatches N`` trains through the 1F1B pipeline
schedule with the experts stage-local (the ragged dispatch inside each
stage), one stage a process:

    python -m tony_tpu_torch.train.pretrain_mixtral --preset mixtral-8x7b [--n_layers 1] [--steps N ...]
    python -m tony_tpu_torch.train.pretrain_mixtral --preset tiny --device cpu --steps 3 [--model_axis 2]
    python -m tony_tpu_torch.train.pretrain_mixtral --preset tiny --device cpu --steps 3 --expert_axis 2 \\
        [--moe_dispatch gather --capacity_factor 2.0]
    python -m tony_tpu_torch.train.pretrain_mixtral --preset tiny --device cpu --steps 3 --context_axis 2 \\
        [--model_axis 2] [--moe_dispatch gather --capacity_factor 1.0]
    python -m tony_tpu_torch.train.pretrain_mixtral --preset tiny --device cpu --steps 3 --stage_axis 2 \
        --pp_microbatches 4
"""

import argparse
import dataclasses
import sys

from tony_tpu_torch.models import mixtral
from tony_tpu_torch.parallel.expert import DISPATCHES
from tony_tpu_torch.train.loop import model_config, parse_loop_args, run_lm_training


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--moe_dispatch", choices=DISPATCHES, default=None)
    p.add_argument("--capacity_factor", type=float, default=None)
    moe, rest = p.parse_known_args(argv if argv is not None else sys.argv[1:])
    loop, extra = parse_loop_args(rest)
    cfg = model_config(mixtral, extra)
    asked = {k: v for k, v in (("moe_dispatch", moe.moe_dispatch), ("capacity_factor", moe.capacity_factor))
             if v is not None}
    run_lm_training(mixtral, dataclasses.replace(cfg, **asked), loop)
    return 0


if __name__ == "__main__":
    sys.exit(main())
