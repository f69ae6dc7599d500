"""Llama pretraining, the port's counterpart of ``examples/llama/pretrain.py``:
one process on one device, or a gang under ``tony submit`` (framework
pytorch) on the data, fsdp, model, expert and context axes. With
``--context_axis C`` in a gang of ``C`` times the data × fsdp workers each
process holds one window of the sequence, its attention the preset's
``cp_impl`` (the plain ring; ``run_lm_training`` with a config of
``cp_impl="pallas"`` runs the ring kernels B9/B10). ``--context_axis C
--model_axis M`` together take a gang of ``C·M`` times the data × fsdp
workers: each window on the rank's ``1/M`` of the heads and FFN columns,
the ring on each model line's kv heads. ``--stage_axis S --pp_microbatches
N`` in a gang of ``S`` times the data × fsdp workers trains through the
1F1B pipeline schedule, one stage (``L/S`` layers) a process:

    python -m tony_tpu_torch.train.pretrain --preset llama3-8b [--steps N ...]
    python -m tony_tpu_torch.train.pretrain --preset tiny --device cpu --steps 3
    python -m tony_tpu_torch.train.pretrain --preset tiny --device cpu --steps 3 --context_axis 2
    python -m tony_tpu_torch.train.pretrain --preset tiny --device cpu --steps 3 --context_axis 2 --model_axis 2
    python -m tony_tpu_torch.train.pretrain --preset tiny --device cpu --steps 3 --stage_axis 2 --pp_microbatches 4

(a stage axis runs in a gang only: the last line in one of 2 ranks).
"""

import sys

from tony_tpu_torch.models import llama
from tony_tpu_torch.train.loop import model_config, parse_loop_args, run_lm_training


def main(argv: list[str] | None = None) -> int:
    loop, extra = parse_loop_args(argv)
    cfg = model_config(llama, extra)
    run_lm_training(llama, cfg, loop)
    return 0


if __name__ == "__main__":
    sys.exit(main())
