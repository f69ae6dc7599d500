"""ResNet-50 training throughput (BASELINE config #3), the port's counterpart
of ``examples/resnet/bench_resnet.py``:

    python -m tony_tpu_torch.train.bench_resnet --batch 512 --steps 10

One fixed synthetic batch, ``SGD(0.1, momentum=0.9)`` (``optax.sgd``'s
numbers), the BatchNorm state carried from step to step, warmup steps
with a host sync each (cuDNN's autotuning happens there, ``cudnn.benchmark``
being on for the fixed shape), then timed steps, each synchronised by
reading its loss. Prints the JAX program's JSON line: images/s, ms/step
and MFU with the same basis (training = 3 × 4.1 GFLOP an image at 224²,
over ``detect_peak_flops``).
"""

import argparse
import json
import sys

import torch

from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.models import resnet
from tony_tpu_torch.train.metrics import detect_peak_flops
from tony_tpu_torch.train.trainer import SGD, Throughput, _leaves

FWD_GFLOP_PER_IMAGE = 4.1
BATCH = 512
STEPS = 10
WARMUP = 3


def make_step(cfg: resnet.ResNetConfig, batch_size: int, device: torch.device):
    """One train step on a fixed batch: returns ``step() -> loss`` (a 0-d
    tensor, not synchronised), which updates the params, the SGD trace and
    the batch's ``bn_state`` in place."""
    gen = torch.Generator(device=device).manual_seed(0)
    params, bn_state = resnet.init(gen, cfg, device)
    batch = resnet.synthetic_batch(gen, batch_size, cfg)
    batch["bn_state"] = bn_state
    opt = SGD(0.1, momentum=0.9)
    opt_state = opt.init(params)
    names, tensors = zip(*_leaves(params))
    for t in tensors:
        t.requires_grad_(True)

    def step() -> torch.Tensor:
        loss, aux = resnet.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, tensors)
        opt.update(params, dict(zip(names, grads)), opt_state)
        batch["bn_state"] = aux["bn_state"]
        return loss.detach()

    return step


def run(argv: list[str] | None = None) -> dict:
    """Run the bench as the flags say; prints and returns its record."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--warmup", type=int, default=WARMUP)
    p.add_argument("--preset", default="resnet50")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    cfg = resnet.PRESETS[args.preset]
    step = make_step(cfg, args.batch, device)
    for _ in range(max(args.warmup, 2)):
        float(step())  # per-step host sync

    meter = Throughput(tokens_per_step=args.batch, flops_per_token=int(3 * FWD_GFLOP_PER_IMAGE * 1e9),
                       n_chips=1, peak_flops=detect_peak_flops(device))
    meter.start()
    for _ in range(args.steps):
        float(step())
        meter.step()
    r = meter.report()
    rec = {
        "metric": "resnet50_train_images_per_sec_1chip",
        "value": round(r["tokens_per_sec"], 1),
        "unit": "images/sec/chip",
        "step_time_ms": round(r["step_time_ms"], 1),
        "batch": args.batch,
        "mfu": round(r["mfu"], 4),
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
