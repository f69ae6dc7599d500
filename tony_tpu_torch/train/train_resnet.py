"""ResNet image-classification training, the port's counterpart of
``examples/resnet/train.py`` (BASELINE config #3): AdamW through
``make_train_step``, synthetic batches, and the BatchNorm running
statistics threaded through the batch (``bn_state``) and back out of the
step's metrics, as the JAX program does:

    python -m tony_tpu_torch.train.train_resnet --preset resnet50 --batch_size 64 --steps 100
    python -m tony_tpu_torch.train.train_resnet --preset tiny --device cpu --steps 3 --log_every 1
"""

import functools
import sys

import torch

from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.models import resnet
from tony_tpu_torch.runtime import init_distributed
from tony_tpu_torch.train.loop import parse_loop_args
from tony_tpu_torch.train.trainer import OptimizerConfig, TrainState, make_train_step


def run(argv: list[str] | None = None) -> dict:
    """Train as the flags say; returns the final ``state``, ``bn_state`` and
    the logged ``log`` (step, loss, accuracy)."""
    loop, extra = parse_loop_args(argv)
    device = init_distributed(resolve_device(loop.device))
    cfg = resnet.config_from_dict(extra["preset"])
    opt = OptimizerConfig(learning_rate=loop.learning_rate, warmup_steps=loop.warmup_steps,
                          total_steps=loop.steps).build()
    params, bn_state = resnet.init(torch.Generator(device=device).manual_seed(0), cfg, device)
    state = TrainState.create(params, opt)
    step = make_train_step(functools.partial(resnet.loss_fn, cfg=cfg), opt)
    gen = torch.Generator(device=device).manual_seed(1)
    log = []
    for i in range(loop.steps):
        batch = resnet.synthetic_batch(gen, loop.batch_size, cfg)
        batch["bn_state"] = bn_state
        state, m = step(state, batch)
        bn_state = m.pop("bn_state", bn_state)
        if (i + 1) % loop.log_every == 0:
            log.append({"step": i + 1, "loss": float(m["loss"]), "accuracy": float(m["accuracy"])})
            print(f"step {i+1} loss={log[-1]['loss']:.4f} acc={log[-1]['accuracy']:.3f}", flush=True)
    return {"state": state, "bn_state": bn_state, "log": log}


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
