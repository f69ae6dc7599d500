"""Llama pretraining on one device, the port's counterpart of
``examples/llama/pretrain.py``:

    python -m tony_tpu_torch.train.pretrain --preset llama3-8b [--steps N ...]
    python -m tony_tpu_torch.train.pretrain --preset tiny --device cpu --steps 3
"""

import sys

from tony_tpu_torch.models import llama
from tony_tpu_torch.train.loop import parse_loop_args, run_lm_training


def main(argv: list[str] | None = None) -> int:
    loop, extra = parse_loop_args(argv)
    cfg = llama.config_from_dict(extra["preset"])
    run_lm_training(llama, cfg, loop)
    return 0


if __name__ == "__main__":
    sys.exit(main())
