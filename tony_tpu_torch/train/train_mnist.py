"""MNIST-scale training, the port's counterpart of
``examples/mnist/train_mnist.py`` (BASELINE config #1): the 784-512-512-10
MLP, AdamW at 1e-3 without warmup over 200 steps of 64 synthetic images, a
line every 50 steps. It runs as bare python or as a gang task under ``tony
submit`` (``tony.application.framework=pytorch``):

    python -m tony_tpu_torch.train.train_mnist [--device cpu]

The labels are drawn afresh every step, so the loss stays near ln 10.
"""

import argparse
import functools
import sys

import torch

from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.models import mlp
from tony_tpu_torch.runtime import init_distributed
from tony_tpu_torch.train.trainer import OptimizerConfig, TrainState, make_train_step

STEPS = 200
BATCH = 64
LOG_EVERY = 50


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    device = init_distributed(resolve_device(args.device))
    print(f"[train_mnist] device {device}", flush=True)
    cfg = mlp.MLPConfig()
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=0, total_steps=STEPS).build()
    state = TrainState.create(mlp.init(torch.Generator(device=device).manual_seed(0), cfg, device), opt)
    step = make_train_step(functools.partial(mlp.loss_fn, cfg=cfg), opt)
    gen = torch.Generator(device=device).manual_seed(1)
    for i in range(STEPS):
        state, m = step(state, mlp.synthetic_batch(gen, BATCH, cfg))
        if (i + 1) % LOG_EVERY == 0:
            print(f"step {i+1} loss={float(m['loss']):.4f} acc={float(m['accuracy']):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
