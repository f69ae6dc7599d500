"""Mixtral (MoE) pretraining, the port's counterpart of ``examples/mixtral/pretrain.py``:
one process on one device, or a gang under ``tony submit`` (framework
pytorch) on the data and fsdp axes, whose router losses are taken over the
gang's global batch (``mixtral.loss_fn``'s ``group``), and with
``--model_axis N`` on the model axis too (each expert's F over N ranks):

    python -m tony_tpu_torch.train.pretrain_mixtral --preset mixtral-8x7b [--n_layers 1] [--steps N ...]
    python -m tony_tpu_torch.train.pretrain_mixtral --preset tiny --device cpu --steps 3 [--model_axis 2]
"""

import sys

from tony_tpu_torch.models import mixtral
from tony_tpu_torch.train.loop import model_config, parse_loop_args, run_lm_training


def main(argv: list[str] | None = None) -> int:
    loop, extra = parse_loop_args(argv)
    cfg = model_config(mixtral, extra)
    run_lm_training(mixtral, cfg, loop)
    return 0


if __name__ == "__main__":
    sys.exit(main())
