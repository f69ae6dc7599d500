"""Reusable training loop: what a user program run by ``tony submit`` calls.

Counterpart of ``tony_tpu/train/loop.py``: join the gang (``init_distributed``
from the env the torch runtime adapter exports), build the mesh, initialise
or resume the state, step with throughput metrics, checkpoint on an interval
and at the end, and resume after a gang restart.

- The gang fills the mesh's fsdp axis (``MeshSpec.auto``, as JAX's), one
  device a process: each rank holds its blocks of the parameters and of
  their AdamW moments (``trainer.sharded_init`` with the model's
  ``sharding_rules``), trains on its contiguous row slice of a constant
  global batch, and the trainer reduces the gradients over the gang, so a
  gang's trajectory is that of one process on the same global batches.
  Each step report carries this rank's parameter and optimizer bytes.
  ``model_axis > 1`` runs Llama's and Mixtral's tensor parallelism across the gang
  (``MeshSpec.auto(model=…)`` fills the rest into fsdp), and
  ``expert_axis > 1`` Mixtral's expert parallelism (``MeshSpec.auto(expert=…)``,
  as JAX's loop; a family without experts keeps every leaf whole on the
  axis, so its expert line computes the same step, as JAX's replicates
  it): the ranks of a model or expert line take the same rows, so rows,
  shards and the data cursor are cut by the data × fsdp index.
  ``context_axis > 1`` trains with every context shard on this process's
  one device, or in a gang one shard a process, each rank a window of its
  line's rows; beside ``model_axis > 1`` (a gang of data × fsdp × context ×
  model processes) each window runs on the rank's heads and columns.
  ``stage_axis > 1`` trains Llama and Mixtral through the 1F1B schedule
  (``make_pp_train_step`` over the model's ``pp_value_and_grad``, JAX's
  loop), one stage a process, ``pp_microbatches`` microbatches a step,
  ``MeshSpec.auto(stage=…)`` filling the rest of the gang into fsdp: each
  rank holds its stage's part of the state, the ranks of a stage line take
  the same rows, and a data × fsdp shard takes its block of each
  microbatch's rows (``pipeline.microbatch_rows``: JAX's split of the
  microbatch over the batch axes). The model axis for BERT, an expert axis
  beside a model or context axis, the interleaved schedule
  (``pp_chunks > 1``) and a stage axis beside a model axis or Llama's expert
  axis raise until ported (ROADMAP queue A8b's second part, A11, A13b,
  A13c); a stage axis beside a context axis, for a model without
  ``pp_value_and_grad``, or beside Mixtral's expert axis raises in JAX's
  words.
- Batches come from ``*.tonytok`` shards under ``data_dir`` through
  ``TokenLoader`` (a pure function of (data_seed, global slot); rank 0
  writes the consumption cursor beside each checkpoint and a resume
  validates it, so the stream is consumed exactly once across restarts,
  even at another world size), or are synthetic: batch ``step`` is a pure
  function of (data_seed, step) and rank ``k`` takes its rows.
- The obs contract of the JAX loop: the step report at
  ``TONY_TRAIN_METRICS_FILE``, the metrics snapshot beside it (``.obs``),
  the ``train.run`` span with ``train.first_step`` and checkpoint children,
  JSON log records, ``StepProfiler`` and the urgent save on a drain request.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.distributed as dist

from tony_tpu_torch import constants
from tony_tpu_torch.data.dataset import ConsumptionCursor
from tony_tpu_torch.data.native import TokenLoader
from tony_tpu_torch.device import resolve_device
from tony_tpu_torch.obs import logging as obs_logging
from tony_tpu_torch.obs import metrics as obs_metrics
from tony_tpu_torch.obs import trace as obs_trace
from tony_tpu_torch.ops import attention, moe_gemm, ring
from tony_tpu_torch.parallel.pipeline import microbatch_rows
from tony_tpu_torch.parallel.expert import check_expert_axis
from tony_tpu_torch.parallel.mesh import MeshSpec, check_stage_layout
from tony_tpu_torch.runtime import (init_distributed, process_count, process_index,
                                    shutdown_distributed)
from tony_tpu_torch.train.checkpoint import UrgentSaveSignal, restore_or_init
from tony_tpu_torch.train.input_pipeline import InputPipeline
from tony_tpu_torch.train.metrics import detect_peak_flops, flops_per_token_for_batch
from tony_tpu_torch.train.profiling import StepProfiler
from tony_tpu_torch.train.trainer import (OptimizerConfig, Throughput, TrainState, make_pp_train_step,
                                          make_train_step, sharded_init, tree_bytes)

_FIRST_STEP_SECONDS = obs_metrics.gauge(
    "tony_train_first_step_seconds",
    "wall time of the first executed step (XLA compile + first run)")
_STEP_SECONDS = obs_metrics.histogram(
    "tony_train_step_seconds",
    "mean per-step wall time, sampled once per logging window")
#: the counterpart of the HBM sample the executor takes only through JAX's
#: devices: the CUDA caching allocator's bytes, sampled at each metrics drop
_DEVICE_MEMORY_BYTES = obs_metrics.gauge(
    "tony_device_memory_bytes",
    "CUDA memory of the training child (torch.cuda.memory_stats): allocated and "
    "reserved now, and the peak allocated", labelnames=("stat",))


@dataclass(frozen=True)
class LoopConfig:
    steps: int = 100
    #: LR-schedule horizon; 0 → ``steps``. Set it when a run will be extended
    #: so warmup/decay stay anchored to the full plan
    schedule_steps: int = 0
    #: GLOBAL batch rows a step, constant across gang sizes: each of the K
    #: processes trains on ``batch_size // K`` of them
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
    #: directory of ``*.tonytok`` shards; empty → synthetic batches
    data_dir: str = ""
    #: draw seed, fixed across restarts: batch ``step`` is a pure function of
    #: (data_seed, step) for synthetic batches, of (data_seed, slot) for shards
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


def _drop_obs_metrics(device: torch.device) -> None:
    """Atomically publish this child's non-empty metrics snapshot beside the
    step report (``<train-metrics-file>.obs``), where the executor merges it
    into its metrics push. No-op outside a tony container; never raises."""
    path = os.environ.get(constants.ENV_TRAIN_METRICS_FILE)
    if not path:
        return
    if device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        for stat, key in (("allocated", "allocated_bytes.all.current"),
                          ("reserved", "reserved_bytes.all.current"),
                          ("peak", "allocated_bytes.all.peak")):
            _DEVICE_MEMORY_BYTES.set(stats.get(key, 0), stat=stat)
    snap = [m for m in obs_metrics.REGISTRY.snapshot() if m["samples"]]
    if not snap:
        return
    try:
        tmp = path + ".obs.tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f)
        os.replace(tmp, path + ".obs")
    except OSError:
        pass


def _refuse_unported(model_module, loop: LoopConfig, model_cfg) -> None:
    name = getattr(model_module, "__name__", "").rsplit(".", 1)[-1]
    if loop.data_dir and name == "bert":
        raise ValueError(
            "--data_dir with BERT: the shard loader yields next-token LM rows, and BERT's "
            "loss_fn takes MLM batches (masked_pos/masked_targets or targets); train BERT on "
            "synthetic batches")
    if loop.stage_axis > 1:
        if not hasattr(model_module, "pp_value_and_grad"):
            raise ValueError(
                f"{model_module.__name__} has no pp_value_and_grad — "
                "pipeline parallelism (stage_axis > 1) needs a model with a "
                "1F1B train-step core (llama and mixtral families have one)")
        if loop.pp_chunks > 1:
            raise NotImplementedError(
                f"pp_chunks {loop.pp_chunks}: the interleaved 1F1B schedule is not ported yet (ROADMAP queue "
                "A13b); the port runs the 1F1B schedule (pp_chunks 1)")
        check_stage_layout({"stage": loop.stage_axis, "context": loop.context_axis, "model": loop.model_axis,
                            "expert": loop.expert_axis}, moe=hasattr(model_cfg, "num_experts"))
        if model_cfg.n_layers % loop.stage_axis:
            raise ValueError(f"{model_cfg.n_layers} layers not divisible by {loop.stage_axis} stages")
    if loop.expert_axis > 1:
        if loop.model_axis > 1 or loop.context_axis > 1:
            raise NotImplementedError(
                f"expert_axis {loop.expert_axis} with model_axis {loop.model_axis} and context_axis "
                f"{loop.context_axis}: not ported yet (ROADMAP queue A11, the rest: JAX's GSPMD gather "
                "dispatch); the expert axis runs with the data and fsdp axes")
        if hasattr(model_cfg, "num_experts"):
            check_expert_axis(model_cfg.num_experts, loop.expert_axis)
    if loop.model_axis > 1:
        if name not in ("llama", "mixtral"):
            raise NotImplementedError(
                f"model_axis {loop.model_axis} for {name}: not ported yet — the port runs the model axis "
                "for Llama and Mixtral (ROADMAP queue A8b's second part: BERT's wqkv blocks and MLM head)")
    if loop.seq_len % loop.context_axis:
        raise ValueError(f"seq_len {loop.seq_len} does not split into context_axis "
                         f"{loop.context_axis} shards")


def _batch_generator(device: torch.device, data_seed: int, step: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(data_seed * 1_000_003 + step + 1)


def run_lm_training(model_module, model_cfg, loop: LoopConfig) -> dict:
    """Pretraining loop of the llama, mixtral and bert modules.

    model_module exposes init(gen, cfg, device), loss_fn(params, batch, cfg,
    mesh) and synthetic_batch; the config flops_per_token(), read on a probe
    batch (a gathered-MLM batch counts the head at its masked fraction only).
    ``data_dir`` feeds next-token rows, so it serves the decoders only. Each
    logged step report carries the loss's ``moe_*`` metrics when it has them.
    Returns the final metrics plus ``start_step`` and ``log`` (every logged
    step report).

    Under a traced tony job (TONY_TRACE_* from the executor) the run is one
    ``train.run`` span; under TONY_LOG_DIR its records are JSON lines there."""
    if os.environ.get(constants.ENV_METRICS_ENABLED) == "0":
        obs_metrics.set_enabled(False)  # the job opted out (tony.metrics.enabled)
    obs_logging.init_from_env()
    tracer = obs_trace.init_from_env()
    try:
        if tracer is None:
            return _run_gang(model_module, model_cfg, loop, None)
        root, token = tracer.start_span("train.run")
        root.set(steps=loop.steps, batch_size=loop.batch_size)
        tracer.root_parent = root.span_id
        try:
            result = _run_gang(model_module, model_cfg, loop, tracer)
        except BaseException:
            tracer.end_span(root, token, status="error")
            raise
        tracer.end_span(root, token)
        return result
    finally:
        obs_trace.shutdown()
        obs_logging.shutdown()


def _run_gang(model_module, model_cfg, loop: LoopConfig, tracer) -> dict:
    _refuse_unported(model_module, loop, model_cfg)
    device = init_distributed(resolve_device(loop.device))
    try:
        return _train(model_module, model_cfg, loop, tracer, device)
    finally:
        shutdown_distributed()  # every rank leaves the group, so the gang exits 0


def _train(model_module, model_cfg, loop: LoopConfig, tracer, device: torch.device) -> dict:
    procs = process_count()
    mesh = MeshSpec.auto(model=loop.model_axis, context=loop.context_axis,
                         expert=loop.expert_axis, stage=loop.stage_axis).build(device)
    # the batch splits over data × fsdp; the ranks of a model, expert or
    # context line take the same rows (the context axis is the gang's only
    # in a gang: one process holds every shard of it), and so do the ranks
    # of a stage line, the outermost axis
    line = loop.model_axis * loop.expert_axis * (loop.context_axis if procs > 1 else 1)
    stages = loop.stage_axis
    rows_world, rows_rank = procs // (line * stages), process_index() % (procs // stages) // line
    if loop.batch_size % rows_world:
        raise ValueError(
            f"global batch_size {loop.batch_size} must divide by the gang's "
            f"{rows_world} processes that split the batch (data x fsdp: a stage, model, expert or context "
            "line takes one row slice; elastic restarts re-split the SAME global batch across the new gang)")
    local_rows = loop.batch_size // rows_world
    # a stage gang's data × fsdp shard takes its block of each microbatch,
    # cut from the global batch (global order: the loader's rows are the same)
    pp_rows = stages > 1 and rows_world > 1

    opt = OptimizerConfig(
        learning_rate=loop.learning_rate, warmup_steps=loop.warmup_steps,
        total_steps=loop.schedule_steps or loop.steps,
    ).build()

    rules = model_module.sharding_rules(model_cfg)

    def init_state() -> TrainState:
        # the same seed on every rank: each keeps its blocks of the same leaves
        gen = torch.Generator(device=device).manual_seed(0)
        return sharded_init(lambda place: model_module.init(gen, model_cfg, device, place), rules, mesh, opt)

    state, ckpt_mgr, start_step = restore_or_init(
        loop.checkpoint_dir or None, init_state, TrainState.load, group=mesh.gang)
    if start_step:
        obs_logging.info(f"[train] resumed from checkpoint step {start_step}", step=start_step)
    state_bytes = {"param_bytes": tree_bytes(state.params),
                   "opt_bytes": tree_bytes({k: state.opt_state[k] for k in ("mu", "nu")})}

    # a partial keeps the loss's keywords in sight: make_train_step hands a
    # loss that takes ``group`` (Mixtral's router losses) the ranks sharing its batch
    # a mesh of one device reaches the model as None: the unsharded path
    model_mesh = mesh if math.prod(mesh.shape[a] for a in ("context", "fsdp", "expert", "model")) > 1 else None
    if stages > 1:
        # the 1F1B schedule produces its own gradients (parallel/pipeline.py)
        step_fn = make_pp_train_step(functools.partial(
            model_module.pp_value_and_grad, cfg=model_cfg, mesh=mesh, num_microbatches=loop.pp_microbatches),
            opt, mesh)
    else:
        loss_fn = functools.partial(model_module.loss_fn, cfg=model_cfg, mesh=model_mesh)
        step_fn = make_train_step(loss_fn, opt, group=mesh.group, mesh=mesh)
    probe = model_module.synthetic_batch(_batch_generator(device, 0, 0), 1, loop.seq_len, model_cfg)
    meter = Throughput(
        tokens_per_step=loop.batch_size * loop.seq_len,
        flops_per_token=flops_per_token_for_batch(model_cfg, probe, loop.seq_len),
        n_chips=procs,
        peak_flops=detect_peak_flops(device),
    )

    loader = None
    if loop.data_dir:
        paths = sorted(Path(loop.data_dir).glob("*.tonytok"))
        if start_step and loop.checkpoint_dir:
            # the cursor saved with the restored step proves the resumed
            # stream is the checkpointed one: a changed global batch or seed
            # fails here instead of consuming samples twice or dropping them
            cursor = ConsumptionCursor.load(loop.checkpoint_dir, start_step)
            if cursor is not None:
                cursor.validate_resume(loop.batch_size, loop.data_seed, start_step)
                obs_logging.info(
                    f"[train] data cursor validated: resuming the global stream at batch "
                    f"{start_step} (written at world size {cursor.world_size}, now {rows_world})",
                    step=start_step)
        loader = TokenLoader(paths, loop.batch_size if pp_rows else local_rows, loop.seq_len,
                             shard_id=0 if pp_rows else rows_rank, num_shards=1 if pp_rows else rows_world,
                             seed=loop.data_seed, start_index=start_step)
        obs_logging.info(f"[train] data: {len(paths)} shards, {loader.total_tokens} tokens, "
                         f"native={loader.is_native}")

    def drop_cursor(next_batch: int) -> None:
        if loader is not None and process_index() == 0:
            ConsumptionCursor(global_batch_index=next_batch, global_batch_size=loop.batch_size,
                              seed=loop.data_seed, world_size=rows_world).save(loop.checkpoint_dir)

    def make_batch(step: int) -> dict:
        """Batch ``step`` of this rank; runs on the pipeline's thread, in step
        order, and issues no collective."""
        if loader is not None:
            batch = {"tokens": torch.from_numpy(loader.next()).to(device, torch.long)}
            if not pp_rows:
                return batch
        else:
            batch = model_module.synthetic_batch(_batch_generator(device, loop.data_seed, step),
                                                 loop.batch_size, loop.seq_len, model_cfg)
        if stages > 1:
            return microbatch_rows(batch, loop.pp_microbatches, rows_world, rows_rank)
        return {k: v[rows_rank * local_rows:(rows_rank + 1) * local_rows] for k, v in batch.items()}

    # a drain request reaches each rank's executor on its own clock; the
    # gang agrees each step (a one-int all-reduce over a CPU group) so that
    # its ranks save together
    urgent = UrgentSaveSignal()
    ctl_group = None
    if mesh.gang is not None and ckpt_mgr is not None:
        ctl_group = mesh.gang if device.type == "cpu" else dist.new_group(backend="gloo")

    def drain_request() -> str | None:
        """This rank's new request id; "" when only a peer's is new; else None."""
        req = urgent.poll()
        if ctl_group is None:
            return req
        flag = torch.tensor([0 if req is None else 1])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=ctl_group)
        return req if req is not None else ("" if flag.item() else None)

    metrics: dict = {}
    log: list[dict] = []
    profiler = StepProfiler()  # no-op unless the executor exported TONY_PROFILE_DIR or a request
    pipeline = InputPipeline(make_batch, start_step, loop.steps,
                             depth=None if loop.prefetch_depth < 0 else loop.prefetch_depth,
                             tracer=tracer)
    meter.start()
    window_t0, window_step0 = time.perf_counter(), start_step
    try:
        for step in range(start_step, loop.steps):
            profiler.step(step)
            batch = pipeline.next(step)
            first = step == start_step
            if first:
                t_first = time.perf_counter()
            state, metrics = step_fn(state, batch)
            if first:
                float(metrics["loss"])  # synchronises the device
                first_s = time.perf_counter() - t_first
                _FIRST_STEP_SECONDS.set(first_s)
                if tracer is not None:
                    with tracer.span("train.first_step", step=step) as sp:
                        sp.start_ms -= first_s * 1000.0
                window_t0, window_step0 = time.perf_counter(), step + 1
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
                    **state_bytes,
                }
                obs_logging.info(json.dumps(line), **line)
                _drop_train_metrics(line)
                log.append(line)
                n_window = step + 1 - window_step0
                if n_window > 0:
                    _STEP_SECONDS.observe((time.perf_counter() - window_t0) / n_window)
                window_t0, window_step0 = time.perf_counter(), step + 1
                _drop_obs_metrics(device)  # after observe: the window's sample ships with it
                meter.start()
            saved_this_step = False
            if ckpt_mgr is not None and loop.checkpoint_every and (step + 1) % loop.checkpoint_every == 0:
                drop_cursor(step + 1)
                ckpt_mgr.save(step + 1, state.state_dict())
                saved_this_step = True
            if ckpt_mgr is not None and (drain_req := drain_request()) is not None:
                # the pool is preempting the job (checkpoint-then-yield): save
                # now, so the resumed gang loses only the steps after this one
                obs_logging.warning(f"[train] urgent pre-preemption checkpoint at step {step + 1}",
                                    step=step + 1)
                if not saved_this_step:
                    drop_cursor(step + 1)
                    ckpt_mgr.save(step + 1, state.state_dict(), force=True)
                ckpt_mgr.wait()  # the step is on disk before the answer: the gang dies on it
                if drain_req:
                    urgent.acknowledge(drain_req, step + 1)
    finally:
        if ckpt_mgr is not None:
            # a write in flight ends before the loop returns or raises; no
            # barrier: a failing rank must not wait for its peers
            ckpt_mgr.join()
        # pipeline first: its producer calls the loader
        producer_dead = pipeline.close()
        if loader is not None:
            if producer_dead:
                loader.close()
            else:
                # the producer is inside a stalled loader read: unmapping the
                # shards under it would crash the process, so leave it open
                obs_logging.warning("[train] input-pipeline producer did not exit within the "
                                    "close deadline; leaving the data loader open")
        profiler.stop()
    if ckpt_mgr is not None:
        if ckpt_mgr.saved_step != loop.steps:  # not already saved or resumed at
            drop_cursor(loop.steps)
            ckpt_mgr.save(loop.steps, state.state_dict(), force=True)
        ckpt_mgr.close()  # the final write is on disk on every rank
    _drop_obs_metrics(device)  # the last window and the final checkpoint's sample
    # this process's launches of each kernel wrapper, as serving's /stats
    # reports them: a worker's log shows which kernels its steps ran
    launches = {**attention.launches, **moe_gemm.launches, **ring.launches}
    obs_logging.info(f"[train] kernel launches {json.dumps(launches)}", **launches)
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
    p.add_argument("--n_layers", type=int, default=0,
                   help="cut the preset to this many layers (0 = the preset's): a full-width "
                        "model that fits one card")
    d = vars(p.parse_args(argv if argv is not None else sys.argv[1:]))
    extra = {"preset": d.pop("preset"), "n_layers": d.pop("n_layers")}
    return LoopConfig(**d), extra


def model_config(model_module, extra: dict):
    """The config ``parse_loop_args``'s extra args name: the preset, cut to
    ``n_layers`` when that is set."""
    cfg = model_module.config_from_dict(extra["preset"])
    return dataclasses.replace(cfg, n_layers=extra["n_layers"]) if extra["n_layers"] else cfg
