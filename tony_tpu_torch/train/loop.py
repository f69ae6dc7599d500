"""Reusable training loop: what a user training program calls.

Counterpart of ``tony_tpu/train/loop.py`` for one process on one device:
initialise (or resume) the state, step with throughput metrics, checkpoint
on an interval and at the end. ``context_axis > 1`` trains with a context
axis: every context shard on the one device, attention over the mesh's
ring (``cp_impl`` of the model config). The other mesh axes, a gang of
processes, real data shards, the obs tracer and registry, ``StepProfiler``
and the urgent-save drain are not ported yet (ROADMAP queue A6, A8, A11,
A13); the options that ask for them raise instead of being ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass

import torch

from tony_tpu_torch import constants
from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.parallel.mesh import MeshSpec
from tony_tpu_torch.runtime import init_distributed
from tony_tpu_torch.train.checkpoint import restore_or_init
from tony_tpu_torch.train.input_pipeline import InputPipeline
from tony_tpu_torch.train.metrics import detect_peak_flops, flops_per_token_for_batch
from tony_tpu_torch.train.trainer import OptimizerConfig, Throughput, TrainState, make_train_step


@dataclass(frozen=True)
class LoopConfig:
    steps: int = 100
    #: LR-schedule horizon; 0 → ``steps``. Set it when a run will be extended
    #: so warmup/decay stay anchored to the full plan
    schedule_steps: int = 0
    batch_size: int = 8
    seq_len: int = 512
    log_every: int = 10
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    model_axis: int = 1
    context_axis: int = 1
    expert_axis: int = 1
    stage_axis: int = 1
    pp_microbatches: int = 4
    pp_chunks: int = 1
    data_dir: str = ""
    #: synthetic-batch seed: batch ``step`` is a pure function of (data_seed, step)
    data_seed: int = 0
    #: input-pipeline lookahead; -1 → TONY_PREFETCH_DEPTH (default 2), 0 → inline
    prefetch_depth: int = -1
    #: "cuda" (the default) or "cpu"; the CPU only when asked for
    device: str = "cuda"


def _drop_train_metrics(line: dict) -> None:
    """Atomically publish the latest step report to the path the executor
    advertised (TONY_TRAIN_METRICS_FILE). No-op outside a tony container;
    never raises."""
    path = os.environ.get(constants.ENV_TRAIN_METRICS_FILE)
    if not path:
        return
    try:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(line, f)
        os.replace(tmp, path)
    except OSError:
        pass


def _refuse_unported(loop: LoopConfig) -> None:
    asked = {name: getattr(loop, name) for name in
             ("model_axis", "expert_axis", "stage_axis") if getattr(loop, name) > 1}
    if loop.data_dir:
        asked["data_dir"] = loop.data_dir
    if asked:
        raise NotImplementedError(
            f"{asked}: not ported yet — the port trains on one device with synthetic batches "
            "(ROADMAP queue A6 data loader, A8 mesh, A11 experts, A13 stages)")
    if loop.seq_len % loop.context_axis:
        raise ValueError(f"seq_len {loop.seq_len} does not split into context_axis "
                         f"{loop.context_axis} shards")


def _batch_generator(device: torch.device, data_seed: int, step: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(data_seed * 1_000_003 + step + 1)


def run_lm_training(model_module, model_cfg, loop: LoopConfig) -> dict:
    """Decoder-LM pretraining loop (the llama and mixtral modules).

    model_module exposes init(gen, cfg, device), loss_fn(params, batch, cfg,
    mesh) and synthetic_batch; the config flops_per_token(). Each logged step
    report carries the loss's ``moe_*`` metrics when it has them. Returns the
    final metrics plus ``start_step`` and ``log`` (every logged step report)."""
    _refuse_unported(loop)
    device = resolve_device(loop.device)
    init_distributed()  # a single process; raises if the env names a gang
    mesh = MeshSpec(context=loop.context_axis).build(device) if loop.context_axis > 1 else None

    opt = OptimizerConfig(
        learning_rate=loop.learning_rate, warmup_steps=loop.warmup_steps,
        total_steps=loop.schedule_steps or loop.steps,
    ).build()

    def init_state() -> TrainState:
        gen = torch.Generator(device=device).manual_seed(0)
        return TrainState.create(model_module.init(gen, model_cfg, device), opt)

    state, ckpt_mgr, start_step = restore_or_init(
        loop.checkpoint_dir or None, init_state, TrainState.load)
    if start_step:
        print(f"[train] resumed from checkpoint step {start_step}", flush=True)

    def loss_fn(params, batch):
        return model_module.loss_fn(params, batch, model_cfg, mesh)

    step_fn = make_train_step(loss_fn, opt)
    probe = model_module.synthetic_batch(_batch_generator(device, 0, 0), 1, loop.seq_len, model_cfg)
    meter = Throughput(
        tokens_per_step=loop.batch_size * loop.seq_len,
        flops_per_token=flops_per_token_for_batch(model_cfg, probe, loop.seq_len),
        n_chips=1,
        peak_flops=detect_peak_flops(device),
    )

    def make_batch(step: int) -> dict:
        return model_module.synthetic_batch(_batch_generator(device, loop.data_seed, step),
                                            loop.batch_size, loop.seq_len, model_cfg)

    metrics: dict = {}
    log: list[dict] = []
    pipeline = InputPipeline(make_batch, start_step, loop.steps,
                             depth=None if loop.prefetch_depth < 0 else loop.prefetch_depth)
    meter.start()
    try:
        for step in range(start_step, loop.steps):
            state, metrics = step_fn(state, pipeline.next(step))
            meter.step()
            if (step + 1) % loop.log_every == 0 or step + 1 == loop.steps:
                loss = float(metrics["loss"])  # synchronises the device before the clock is read
                report = meter.report()
                line = {
                    "step": int(metrics["step"]),
                    "loss": round(loss, 4),
                    "grad_norm": round(float(metrics["grad_norm"]), 4),
                    "tokens_per_sec": round(report["tokens_per_sec"], 1),
                    "step_time_ms": round(report["step_time_ms"], 2),
                    "mfu": round(report["mfu"], 4),
                    "time": time.strftime("%H:%M:%S"),
                    **{k: float(v) for k, v in metrics.items() if k.startswith("moe_")},
                }
                print(json.dumps(line), flush=True)
                _drop_train_metrics(line)
                log.append(line)
                meter.start()
            if ckpt_mgr is not None and loop.checkpoint_every and (step + 1) % loop.checkpoint_every == 0:
                ckpt_mgr.save(step + 1, state.state_dict())
    finally:
        pipeline.close()
    if ckpt_mgr is not None and ckpt_mgr.latest_step() != loop.steps:
        ckpt_mgr.save(loop.steps, state.state_dict())
    out = {k: float(v) for k, v in metrics.items() if torch.is_tensor(v) or isinstance(v, (int, float))}
    return {**out, "start_step": start_step, "log": log}


def parse_loop_args(argv: list[str] | None = None) -> tuple[LoopConfig, dict]:
    """Shared CLI for training programs; returns (LoopConfig, extra model args)."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--schedule_steps", type=int, default=0,
                   help="LR-schedule horizon (0 = --steps); set when extending runs")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--log_every", type=int, default=10)
    # checkpoint settings default from the executor-injected env; flags override
    p.add_argument("--checkpoint_dir", default=os.environ.get(constants.ENV_CHECKPOINT_DIR, ""))
    try:
        env_interval = int(os.environ.get(constants.ENV_CHECKPOINT_INTERVAL, "0") or 0)
    except ValueError:
        print(f"[train] ignoring non-integer {constants.ENV_CHECKPOINT_INTERVAL}="
              f"{os.environ[constants.ENV_CHECKPOINT_INTERVAL]!r}", file=sys.stderr)
        env_interval = 0
    p.add_argument("--checkpoint_every", type=int, default=env_interval)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--model_axis", type=int, default=1)
    p.add_argument("--context_axis", type=int, default=1)
    p.add_argument("--expert_axis", type=int, default=1)
    p.add_argument("--stage_axis", type=int, default=1)
    p.add_argument("--pp_microbatches", type=int, default=4)
    p.add_argument("--pp_chunks", type=int, default=1)
    p.add_argument("--data_dir", default="")
    p.add_argument("--data_seed", type=int, default=0)
    p.add_argument("--prefetch_depth", type=int, default=-1,
                   help="input-pipeline lookahead; -1 = TONY_PREFETCH_DEPTH (default 2), 0 = inline")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) or cpu (the kernels' plain versions)")
    p.add_argument("--preset", default="tiny")
    d = vars(p.parse_args(argv if argv is not None else sys.argv[1:]))
    preset = d.pop("preset")
    return LoopConfig(**d), {"preset": preset}
