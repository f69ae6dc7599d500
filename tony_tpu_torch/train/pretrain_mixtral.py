"""Mixtral (MoE) pretraining on one device, the port's counterpart of
``examples/mixtral/pretrain.py``:

    python -m tony_tpu_torch.train.pretrain_mixtral --preset mixtral-8x7b [--steps N ...]
    python -m tony_tpu_torch.train.pretrain_mixtral --preset tiny --device cpu --steps 3
"""

import sys

from tony_tpu_torch.models import mixtral
from tony_tpu_torch.train.loop import parse_loop_args, run_lm_training


def main(argv: list[str] | None = None) -> int:
    loop, extra = parse_loop_args(argv)
    cfg = mixtral.config_from_dict(extra["preset"])
    run_lm_training(mixtral, cfg, loop)
    return 0


if __name__ == "__main__":
    sys.exit(main())
