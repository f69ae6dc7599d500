"""BERT MLM pretraining, the port's counterpart of ``examples/bert/pretrain.py``:
synthetic gathered-MLM batches (15% of each row masked) through
``run_lm_training``, so it also runs as a gang under ``tony submit``:

    python -m tony_tpu_torch.train.pretrain_bert --preset bert-base [--steps N ...]
    python -m tony_tpu_torch.train.pretrain_bert --preset tiny --device cpu --steps 3 --seq_len 64
"""

import sys

from tony_tpu_torch.models import bert
from tony_tpu_torch.train.loop import model_config, parse_loop_args, run_lm_training


def main(argv: list[str] | None = None) -> int:
    loop, extra = parse_loop_args(argv)
    cfg = model_config(bert, extra)
    run_lm_training(bert, cfg, loop)
    return 0


if __name__ == "__main__":
    sys.exit(main())
