#!/usr/bin/env python3
"""On-card smoke check of the PyTorch/CUDA port (``tony_tpu_torch``).

    python3 chip_smoke.py [--out DIR]

Needs one CUDA card. Phases, any failure exits non-zero before the result:

1. card and build: prints ``nvidia-smi``'s name and power limit, builds every
   kernel from ``tony_tpu_torch/csrc`` with ``nvcc`` and prints the seconds;
2. kernels: holds each kernel against its plain PyTorch version on the card,
   in bf16, at the Llama-3-8B serving shapes (B4-B6) and training shapes
   (B1-B3 flash attention: B=4, T=2048 causal; B=1, T=8192; 3 packed
   segments; window 1024), and times the kernel, the plain version, the one
   PyTorch call that computes the same function (SDPA over a padded batch or
   with the band as a mask: its forward, and its backward alone; ``x @ W_bf16``)
   and the least time the card could take; prints ptxas's registers and spill
   bytes, the shared memory a block asks for and the ``nvcc`` seconds of each
   attention kernel and of each instantiation of B4/B5 (a bf16 one that
   spills fails the run); B4/B5 also on ``decode_batch``, the serve runs'
   decode regime (8 slots at 140 positions, 4 of them staged), each decode
   case run twice for the same bits, with two planted faults (the longest
   slot one split shorter, the current token from another slot) that must
   fail the limit the kernel passes; B6 (``int8_matmul.cu``: its build
   report, a spill fails the run) at M 8, 128 and 1024 on the five Llama-3-8B
   weights, each twice for the same bits, with two planted faults (q's last
   128 K rows zeroed, a column tile's scales from the next tile) that must
   fail ``INT8_REL_TOL``, and its two paths timed against each other at M
   16-96 (the crossover);
3. serve: starts ``python -m tony_tpu_torch.models.serving_http --preset
   llama3-8b`` (full width, all 32 layers, seeded random weights, 8 slots,
   max_len 2048) three times — paged KV (the default), ``--int8``, and
   ``--kv dense --attn ragged`` — sends eight requests to each (two sharing a
   512-token prefix, two identical greedy prompts, one streamed), checks
   every request returns ``max_tokens`` tokens, the identical prompts agree,
   ``/stats`` (prefix hits on the paged runs, kernel launch counts > 0), and
   that SIGTERM drains to exit 0; then a decode-dominated batch (one 16-token
   prompt per slot, 128-token answers); prints tok/s of both batches, the
   decode step time and the time to the first streamed token; then the
   ``--int8`` engine in this process: one decode chunk of a full batch and
   one 1000-token prefill (the 1024 bucket) under ``torch.profiler``, device
   ms by kernel family (``int8`` is B6) and the busy share;
3h. kv-handoff: the disaggregated KV handoff in this process at Llama-3-8B
   (all 32 layers, bf16, paged, page_len 256): two ``EngineServer``s on one
   set of weights behind their own HTTP servers, one in the prefill role; a
   1280-token prompt (5 pages) through ``/v1/prefill`` with the decode
   server's URL: 5 pages adopted, the decode pool's pages the exported
   payload's bytes exactly, a re-ship all ``already_resident``, a wrong
   ``shape`` answered 400, prefix hits on the decode tier's continuation
   (its agreement with the prefill server's is printed, not held: bf16);
   prints the handoff ms, the export ms and the payload's bytes;
3f. fleet: ``tony serve`` through ``python -m tony_tpu_torch_launch.serve``
   (a subprocess, as is ``tony loadtest``) twice on the card, Llama-3-8B
   paged, 8 slots, max_len 2048: ``disagg`` (a prefill and a decode
   replica) and ``colocated`` (one replica), each under the same streamed
   ``tony loadtest`` traffic (2 sessions x 2 turns, prompts of 768 or 1280
   tokens sharing 512, 64 tokens a turn): 4/4 requests ok, prefix hits,
   B5 launched by the decode replica during the load, pages exported and
   adopted (``disagg``); SIGINT to the launcher kills the job, every
   replica logs its drain and exits, the launcher within 120 s; prints the
   startup seconds, TTFT p50/p95/p99, the gap between tokens, latency
   p50/p99, tok/s and the handoff's p50 and pages with the card line. Both
   tiers share the one card: the handoff's mechanics and cost, not the gain
   of separate tiers;
4. whole step: ``loss_fn`` and every gradient through the flash kernels
   against ``attn_impl="reference"`` on the same params and batch (8B width,
   2 layers, B=1, T=2048); two planted faults (a query head dropped by B1,
   or by B3) must fail the limits the kernels pass;
5. train: ``run_lm_training`` in this process at the full 8B width cut to
   2 layers (bf16, remat "full", ce_chunk 512, B=4, T=2048): 3 steps with a
   checkpoint, then a second call to 6 steps that must resume at step 3;
   prints loss and grad_norm per step, tok/s, ms/step, MFU, peak memory and
   the B1-B3 launches of the two calls; then the same step on a fresh state
   split with CUDA events into loss + gradients and the optimizer update,
   and its device time by kernel family from ``torch.profiler`` with the
   card's busy share of the profiled window;
5r. remat policies: the train shape (2 layers, B=4, T=2048) under "full",
   "dots" and "flash" from one state and batch: the loss and every gradient
   of each against "full"'s within the whole-step limits (and whether the
   bits are identical), B1 launched 2L / 2L / L times a forward and
   backward and B2, B3 L times; then the mean ms/step of 3 train steps and
   the peak memory under each;
5a. gang: the training gang at ``llama-1b`` cut to 4 of its 16 layers
   (bf16, remat "full", B=8, T=2048) on four ``*.tonytok`` shards written
   from a seed: ``tony submit`` (run as ``python -m tony_tpu.cli.main``, a
   subprocess) of ``python -m tony_tpu_torch.train.pretrain`` for 8 steps
   with an asynchronous checkpoint every 3 and a node loss at step 7: one
   restart, the resume at the newest step attempt 0's log shows published
   (3, since the save at step 6 joins step 3's write) with a validated
   cursor, every global slot consumed once, ``tony top`` on the live worker
   and ``tony goodput`` after; the same 8 steps in this process through
   B1-B3 (launches counted) with each loss the worker's within
   ``GANG_LOSS_REL``; an urgent save on a drain request and a
   ``torch.profiler`` window in this process; the bucketed mean over a
   one-rank nccl group; prints ms/step, tok/s, MFU and peak memory of both
   runs, the checkpoint's bytes, its save dispatch, write and restore
   seconds, goodput's ``checkpoint`` seconds, and the time to recover (node
   loss to the restart's first step);
5s. asynchronous save, in this process, at the gang's shape: 14 train
   steps saved after steps 4 and 14, once with ``use_async=False`` and once
   with ``use_async=True``: each save's dispatch and write seconds, the
   steps during the first write against the steady step, the wall of each
   run, and the same bytes restored from both (the async step 4 also the
   state as it was at its save);
5b. bench.py's ``1chip`` recipe (``llama-1b``, remat "flash", ce_chunk
   1024, B=12, T=2048) through ``run_lm_training`` for 6 steps: ms/step,
   tok/s, MFU, peak memory and B1-B3 launches (B1 L times a step);
5c. context parallelism (B9, B10): the ring kernels' build report, then
   the whole ring pass over a ``DeviceRing`` of 4 on the card at 8B
   widths, B=1, T=16384 (causal, 3 segments, window 1024; and on rings of
   2: over T=16384, ``[cp-gang]``'s shape, held only, and over T=8192 on
   16 query and 4 kv heads, ``[cp-tp]``'s, held and timed) against the
   plain steps, with two planted faults that must fail; the causal pass
   run twice must give the same bits; a 2-layer whole-step check against
   the flash path; ``run_lm_training`` with a context axis of 4 at 4
   layers for 3 steps (B9/B10 launches must equal the schedule's count);
   then Mixtral-8x7B widths at 2 layers, B=1, T=16384, 3 steps with a
   context axis of 4 (B9/B10, B7/B8 once a layer pass) against the same
   run without one (B1-B3), each loss within ``MOE_STEP_LOSS_REL``;
6. MoE kernels (B7, B8; after the Llama phases, so their minutes of load
   do not run before the serve runs): the build report of the six passes
   of ``moe_gemm.cu`` (registers, spills, shared memory; a pass that
   spills fails the run), then the grouped SwiGLU forward and
   backward against their plain versions at Mixtral-8x7B widths (D 4096,
   F 14336, 8 experts, top-2) on three routings (the train shape B=4,
   T=2048; every token to experts 0 and 1; one 1000-token prompt) and at
   a ``[mixtral-tp]`` rank's ``F/2`` = 7168 columns (B=1, T=2048) and on a
   ``[mixtral-ep]`` rank's span of 4 whole experts (B=1, T=2048), ys and
   dxs row by row and each expert's dW in relative norm, with a planted
   fault (each expert's last row tile on the next expert's weights) that
   must fail every check; times against the three grouped GEMMs of
   ``torch._grouped_mm``;
7. Mixtral whole step: ``loss_fn`` and every gradient through B7/B8 against
   the plain versions (full width, 1 layer, B=1, T=2048); two planted faults
   (B7 zeroes an expert's rows, B8 drops an expert's dWd) must fail;
8. Mixtral train: ``run_lm_training`` at Mixtral-8x7B width cut to 2
   layers (bf16, remat "full", B=4, T=2048), 4 steps; loss, grad_norm and
   the MoE metrics per step, ms/step, tok/s, MFU on the active parameters,
   peak memory, and B7/B8 launches of exactly 2·layers·steps and
   layers·steps; then the same step on a fresh state split into loss +
   gradients and the optimizer, and its device time by kernel family
   (``moe``, ``attention``, ``gemm``, ``other``) with the busy share; the
   same shape under remat "flash" against "full" as in 5r (B7 launched
   L times a forward and backward, not 2L); then bench.py's ``moe`` recipe
   (d1024, 8 layers, 8 experts top-2, F 2048, remat "flash", ce_chunk 512,
   B=44, T=2048) as in 5b, MFU on the active parameters;
9. Mixtral serve: the in-process ``ContinuousBatcher`` (paged KV, 8 slots,
   max_len 2048) at Mixtral-8x7B width cut to 8 of 32 layers, with the
   Llama serve runs' traffic: the mixed batch (prefill through B7, decode
   through the all-expert products; prefix hits, the identical greedy
   prompts agree, the first token of one request timed) and the decode
   batch; tok/s of both, the decode step time and peak memory; then one
   decode chunk of a full batch under ``torch.profiler``: device ms by
   kernel family (``decode`` is B4/B5) and the card's busy share;
10. BERT-base MLM (last, with every earlier phase's state freed): B1-B3 on
    BERT's shapes (non-causal, H = Hkv = 12, Dh 64, T=512: bench.py's B=384,
    and B=64 rows of three packed segments and a padded tail), held, faulted
    and timed as the Llama cases (the plain versions compared, not timed:
    seconds a call at these shapes), each also twice for the same bits and
    with a query head dropped by B1 and by B3; ``[bert-step]``: ``loss_fn`` and
    every gradient through the kernels against ``attn_impl="reference"``
    (12 layers, bf16, B=8, T=512) on the gathered layout and on a dense
    packed batch, with a query head dropped by B1 that must fail;
    ``[bench-bert]``: bench.py's bert recipe (remat, B=384, T=512) through
    ``run_lm_training`` as in 5b, MFU with the head at the masked fraction,
    B1/B2/B3 24/12/12 launches a step; ``[bert-pack]``: ``pack_ab.py``'s
    seeded documents padded one a row against packed by ``pack_sequences``,
    content tokens/s of both and the pack ratio;
11. the MNIST MLP and ResNet-50 (after BERT, with its state freed; no
    kernel of the port on their path: cuDNN's convolutions, BatchNorm and
    cuBLAS): ``[mnist]``: ``tony submit`` (framework pytorch, one worker) of
    ``python -m tony_tpu_torch.train.train_mnist`` on the card, the job
    SUCCEEDED and its four step lines finite and near ln 10; ``[resnet-step]``:
    ResNet-50 at full width in f32 with TF32 off, B=4, the logits, loss,
    every running statistic and every gradient on the card against the CPU
    from the same weights and batch, the stride-2 convolutions padded
    symmetrically failing the limits, then a finite bf16 loss near ln 1000;
    ``[bench-resnet]``: ``bench_resnet`` (bf16, B=512, SGD with momentum):
    images/s, ms/step, MFU on the JAX program's basis, peak memory and a
    profiled step by kernel family (``conv``, ``norm``, ``gemm``,
    ``other``); ``[resnet-train]``: ``train_resnet`` for 4 steps of 64, every
    running mean moved and every statistic finite;
12. Hugging Face checkpoints and the Mixtral gang (last): ``[hf-load]``
    writes two HF checkpoint directories from seeded bf16 trees (Llama-3-8B
    widths cut to 2 layers as safetensors shards with their index,
    Mixtral-8x7B widths cut to 1 layer as ``pytorch_model.bin``), loads each
    onto the card through ``convert.load_hf_dir`` with every leaf the
    source's bit for bit, and a third with layer 0's ``o_proj`` written
    untransposed must fail that check; prints load seconds and GB/s;
    ``[hf-serve]``: ``serving_http --hf <llama dir> --int8 --kv paged`` (B5,
    B6) answers four greedy requests one at a time with the tokens of the
    in-process engine on the source tree quantized the same way, and the
    Mixtral directory through ``build_engine`` in process (B7 in prefill)
    gives the source tree's tokens; ``[mixtral-gang]``: ``tony submit``
    (framework pytorch, one worker) of ``pretrain_mixtral`` at Mixtral-8x7B
    width cut to 1 layer, B=1, T=2048, 3 steps: SUCCEEDED, finite steps with
    their ``moe_*`` metrics, the first loss near ln V, and the worker's
    B1-B3, B7, B8 launches as remat "full" schedules them;
13. ``[fsdp]``: a gang of two processes on the one card over gloo
    (nccl refuses two ranks on one card), on the mesh's fsdp axis
    (``MeshSpec.auto``'s fill): ``run_lm_training`` at ``llama-1b`` cut to
    ``FSDP_LAYERS`` of its 16 layers, B=8, T=2048, 3 steps with sharded
    asynchronous saves after step
    2 and at the end; each rank's losses and grad norms against one process
    on the global batch within ``FSDP_REL``, each rank holding half of every
    split leaf and its moments, B1-B3 launched on each, the newest step
    restored into one process bit for bit against the blocks the ranks
    saved, each rank's blocks of the step-3 parameters and moments against
    one process's within ``FSDP_STATE_REL``, and two planted faults, one
    step each at 2 layers, that must fail: a rank whose gradients skip the
    reduce-scatter (the grad norm) and a rank that skips its moment update
    (the blocks); prints per-rank bytes, peak memory and ms/step;
14. ``[tp]``: a gang of two processes on the one card over gloo on the
    mesh's model axis (``run_lm_training(model_axis=2)``: Megatron's column
    and row blocks, the vocab-parallel embedding and CE) at Llama-3-8B
    widths cut to 2 layers (bf16, remat "full", B=2, T=2048), 3 steps with
    a sharded save at the end: each rank's losses and grad norms against
    one process's within ``GANG_LOSS_REL``, B1-B3 launched by each rank as
    often as by one process, the step restored into one process bit for bit
    against the blocks the ranks saved, each rank's blocks of the step-3
    parameters and moments within ``FSDP_STATE_REL``, and two planted
    faults, one step each, that must fail: a row-parallel reduce whose
    backward also sums, and a rank whose embedding skips its sum; prints
    per-rank bytes, peak memory, launches and ms/step;
15. ``[tp-serve]``: the TP engine (``ContinuousBatcher(tp=2)``, both shards
    on the one card) at Llama-3-8B widths cut to 4 layers in f32 against
    the tp=1 engine on the same weights: the same greedy tokens on 4
    requests, the decode ms/step of both (reported), and a planted fault
    (one shard's row partial dropped) that must change the tokens;
16. ``[mixtral-tp]``: the ``[tp]`` gang for Mixtral (``tp_phase`` with the
    family) at Mixtral-8x7B widths cut to 1 layer (bf16, remat "full",
    B=1, T=2048): each rank's experts on F/tp = 7168 columns (B7/B8 on
    ``[8, 4096, 7168]`` blocks), 3 steps and a sharded save held as
    ``[tp]``'s, with the router losses among the held metrics, B1-B3, B7
    and B8 launched by each rank as often as by one process, and the
    router's gradient the same bits on both ranks at every step; two
    planted faults that must fail: combine gates whose gradient skips the
    line's sum (the router gradients differ) and a rank whose expert
    output skips ``reduce_from_model``; then in the same two processes
    ``[mixtral-ep]``, the expert axis (``run_lm_training(expert_axis=2)``:
    4 whole experts a rank, B7/B8 on the span of sorted rows they own, 4
    groups), 3 steps and a sharded save held to the same one-process run:
    the losses, grad norms and router losses, the router's gradient the same
    bits on both ranks, the step-3 blocks, the per-rank bytes exactly the
    whole less half of every expert leaf, B1-B3/B7/B8 launched as by one
    process with every B7/B8 call on 4 experts, the step restored into one
    process bit for bit; two planted faults that must fail: the MoE output
    not summed over the expert line, and every rank taking expert 0's span;
17. ``[mixtral-tp-serve]``: the TP engine against the tp=1 engine at
    Mixtral-8x7B widths cut to 4 layers in bf16, every prompt's prefill
    through B7 on each shard's blocks: the decode ms/step of both
    (reported); both fed tp 1's tokens, every prefill's and decode step's
    logits row within ``MIXTRAL_TP_SERVE_ROW_TOL`` of tp 1's and the
    argmax tp 1's where its margin is clear; contiguous expert blocks; a
    planted fault (one shard's expert partial dropped) that must read above
    the limit;
18. ``[cp-gang]``: a gang of two processes on the one card over gloo with a
    context axis of 2, one context shard each (B9/B10 moving KV and dk/dv
    between the processes): Llama-3-8B widths cut to 1 layer, B=1,
    T=16384, 2 steps and a save, then a step of each planted fault (KV kept
    in its process; RoPE without the window's offset); Mixtral-8x7B widths
    cut to 1 layer, B=1, T=8192, 2 steps and a save; each held to one
    process with the context on a ``DeviceRing``: losses and grad norms
    (and router losses) within ``GANG_LOSS_REL``, the step-1 gradients of
    ``wq``/``wk``/``wv`` within ``CP_STEP_GRAD_REL`` (where both faults
    must fail), the step-2 parameters and moments within
    ``FSDP_STATE_REL`` and each save restored into one process bit for
    bit, each rank's launches the schedule's for its ring position; prints
    peak memory and ms/step a rank;
19. ``[cp-tp]``: a gang of four processes on the one card over gloo on
    ``context 2 × model 2`` (A12c): each rank a window of T/2 on its model
    blocks (16 query and 4 kv heads, F/2, V/2), B9/B10 on those heads
    with KV between the two ranks of its model index, Megatron's pair and
    the vocab-parallel CE over its model line: Llama-3-8B widths cut to 1
    layer, B=1, T=8192, 2 steps and a save, then a step of each planted
    fault (a context ring across the model lines; ``reduce_from_model``
    over the context line); held to one process with the context of 2 on a
    ``DeviceRing``: losses and grad norms within ``GANG_LOSS_REL``, the
    step-1 ``wq``/``wk``/``wv`` gradients joined over the model line within
    ``CP_STEP_GRAD_REL``, the last step's parameters and moments within
    ``FSDP_STATE_REL``, the save restored into one process bit for bit,
    each rank's launches the schedule's for its ring position; prints the
    bytes, peak memory and ms/step a rank;
20. ``[pp]``: a gang of two processes on the one card over gloo on ``stage
    2`` (A13a), the 1F1B schedule, one stage a process (its layer; the
    embedding on stage 0, the final norm and head on stage 1), the
    activations and gradients of each tick between the two:
    Llama-3-8B widths cut to 2 layers, B=4, T=2048, 4 microbatches, 3
    steps and a save, then a step of each planted fault (the backward
    reading the next microbatch's residual; the schedule one tick short);
    Mixtral-8x7B widths cut to 2 layers, 2 steps and a save, then a step of
    its fault (the router losses' cotangent seeded without the token
    count); each held to one process's ``make_train_step`` over the same
    4 microbatches on the same seed, run before the gang: losses and grad
    norms within ``GANG_LOSS_REL`` and the same on both ranks, the step-1
    gradients of every leaf within ``CP_STEP_GRAD_REL`` of its max (the
    router printed apart; each fault must fail), the last step's state
    within ``FSDP_STATE_REL``, each save restored into one process bit for
    bit, each rank's launches the schedule's (B1, B7 three times a layer and
    microbatch, B2, B3, B8 once); prints the bytes reckoned a rank, peak
    memory, ms/step, ticks and the ring exchange's share of a step;
21. prints ``{"kernels": [...]}`` (B5 with its fleet launches, B1-B3 with
    their ``[bench-bert]`` launches and BERT cases, and the launches of the
    phases of 12 to 20 as ``launches_hf_serve``, ``launches_mixtral_gang``,
    ``launches_fsdp``, the sum over the two ranks, ``launches_tp``,
    ``launches_mixtral_tp`` and ``launches_mixtral_ep``, one rank's,
    ``launches_mixtral_tp_serve``, ``launches_cp_train_mixtral``,
    ``launches_cp_gang``, the sum over its two ranks' sound runs,
    ``launches_cp_tp``, the sum over its four ranks', and ``launches_pp``,
    stage 0's over both families' sound runs)
    and, last, ``{"ok": true, "device": {...}}``.

Each phase prints ``[phase] <name> start`` and ``[phase] <name> <s>s``, so a
failure is named by the last start line.

Imports only ``tony_tpu_torch``, torch, numpy and the standard library; it
runs the orchestrator (``tony_tpu.cli.main``, and ``tony_tpu_torch_launch``,
which imports it) as subprocesses only.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
from unittest import mock
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores

# Llama-3-8B serving shapes
S, H, HKV, DH, MAXT, PLEN = 8, 32, 8, 128, 2048, 256
LENGTHS = [0, 1, 255, 256, 1000, 2047, 512, 1500]
INT8_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]
ATTN_TOL = 2e-2    # bf16 output: ~2 ulps at |o| <= 1 (f32 maths in both, sums in another order)
DECODE_BATCH_LEN, DECODE_BATCH_STAGED = 140, 4  # kernel case "decode_batch": the serve runs' decode regime
INT8_REL_TOL = 2e-2  # max |kernel - plain| <= 2e-2 * max |plain|: ~2.5 bf16 ulps at the top of the range
INT8_MS = (8, 128, 1024)  # B6 cases: a decode step, a short prompt, a 1000-token prompt's prefill bucket

# training shapes of the flash kernels (B1-B3): Llama-3-8B's (causal GQA, Dh
# 128) and BERT-base's (non-causal MHA, Dh 64: bench.py's bert recipe, and
# packed rows of three documents and a padded tail, segment 0)
_LLAMA_HEADS = dict(H=H, Hkv=HKV, Dh=DH, causal=True)
_BERT_HEADS = dict(H=12, Hkv=12, Dh=64, causal=False)
FLASH_CASES = {
    "train": dict(B=4, T=2048, window=0, n_seg=1, **_LLAMA_HEADS),      # the train run's shape
    "long": dict(B=1, T=8192, window=0, n_seg=1, **_LLAMA_HEADS),       # where JAX streams dk/dv
    "segments": dict(B=4, T=2048, window=0, n_seg=3, **_LLAMA_HEADS),   # 3 packed segments a row
    "window": dict(B=4, T=2048, window=1024, n_seg=1, **_LLAMA_HEADS),  # sliding window 1024
    "pp": dict(B=1, T=2048, window=0, n_seg=1, **_LLAMA_HEADS),         # a [pp] microbatch: B/M = 1 row
    "bert": dict(B=384, T=512, window=0, n_seg=1, **_BERT_HEADS),       # bench.py's bert recipe
    "bert_packed": dict(B=64, T=512, window=0, n_seg=3, pad=True, **_BERT_HEADS),
}
LLAMA_FLASH_CASES = ("train", "long", "segments", "window", "pp")
#: run in the BERT phases, after the others; also held to the same bits twice
#: and to a query head dropped by B1 and by B3 (each must fail the row limit)
BERT_FLASH_CASES = ("bert", "bert_packed")
# o, dq, dk and dv of the bf16 kernels against their f32 plain versions, held
# row by row (``row_rel_err``): the kernels round P and dS to bf16 for the
# tensor cores, so a sound row is off by a few bf16 ulps of the row (H100:
# 4.2e-3 to 5.1e-3). The limit sits between that and the readings of a
# planted fault, a skipped 64-key tile for the last q tile's rows (2.2e-2 for
# dk/dv at T=8192, 0.14 to 0.99 elsewhere; PERF.md). lse is f32 on both sides
FLASH_ROW_TOL = 1e-2
LSE_ATOL = 1e-3
# whole step, bf16, 2 layers, against attn_impl="reference": the loss within
# STEP_LOSS_REL relative, every gradient leaf within STEP_GRAD_REL in relative
# norm. Each limit sits between the sound reading (H100: loss 4.1e-6, worst
# leaf 8.7e-3) and that of a planted fault, one query head of each kv group
# dropped by B1 (loss 5.3e-5) or by B3 (worst leaf 0.53); PERF.md
STEP_LOSS_REL = 1.5e-5
STEP_GRAD_REL = 5e-2
#: the train, remat and breakdown phases' depth: Llama-3-8B cut to 4 layers
#: (its checkpoint round trip ~11.5 GB), which pays for part of the Mixtral
#: model-axis phases' seconds
#: 2 layers, a cut that keeps the command within its time limit
TRAIN_LAYERS = 2

# Mixtral-8x7B widths of the MoE kernels (B7, B8): D, F, experts, top-k
MOE_D, MOE_F, MOE_E, MOE_K = 4096, 14336, 8, 2
MOE_CASES = {
    "train": dict(tokens=4 * 2048, skew="random"),   # the train run's B=4, T=2048
    "skewed": dict(tokens=4 * 2048, skew="two"),     # every token to experts 0 and 1
    "prefill": dict(tokens=1000, skew="random"),     # one 1000-token prompt
    "tp2": dict(tokens=2048, skew="random", F=MOE_F // 2),  # a [mixtral-tp] rank's F/2 blocks, B=1, T=2048
    "ep2": dict(tokens=2048, skew="random", experts=MOE_E // 2),  # a [mixtral-ep] rank's span of 4 experts
    "pp": dict(tokens=2048, skew="random"),  # a [pp] microbatch: one row of 2048 tokens, all 8 experts, full F
}
# ys and dxs of the bf16 kernels against their plain versions row by row
# (``row_rel_err``), each expert's dW in relative Frobenius norm: both sum in
# f32 and round h, dg and du to bf16, so a sound kernel differs only where a
# sum in another order moves a rounding (H100: rows <= 1.9e-3, dW <= 8.6e-4).
# The planted fault (``next_expert_tiles``) reads 1.47-1.49 on rows and
# 0.18-0.97 on dW (PERF.md)
MOE_ROW_TOL = 1e-2
MOE_W_TOL = 1e-2
# Mixtral whole step (1 layer, B=1, T=2048), kernels against the plain
# versions: the loss within MOE_STEP_LOSS_REL relative, every gradient leaf
# within MOE_STEP_GRAD_REL in relative norm. Each limit sits between the
# sound reading (H100: loss 2.8e-6, worst leaf 6.1e-3) and the planted
# faults' (B7 zeroes expert 1's rows: loss 2.2e-4, worst leaf 0.36; B8 drops
# its dWd: worst leaf 0.37)
MOE_STEP_LOSS_REL = 3e-5
MOE_STEP_GRAD_REL = 2e-2
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_STEPS = 4
# bf16 weights of 2.90 GB a layer plus 0.52 GB of embed and head: 27 layers
# are the deepest cut that fits one 80 GB card; 8 (23.7 GB) keep the
# command within its time limit (the init of 27 layers' random weights took
# most of the phase's seconds)
MOE_SERVE_LAYERS = 8

# context-parallel Llama training (B9, B10): B=1, T=16384 over a context of 4
# (Tl 4096) on a DeviceRing on the card; the ring kernels are held against
# their plain versions row by row with the flash limits (the kernels round P
# and dS to bf16 for the tensor cores as B1-B3 do, the plain versions keep
# f32; H100: rows <= 5.1e-3, the planted faults 0.96 and more)
RING_N, RING_T = 4, 16384
RING_CASES = {
    "causal": dict(window=0, n_seg=1),
    "segments": dict(window=0, n_seg=3),    # 3 packed segments, boundaries off the shard edges
    "window": dict(window=1024, n_seg=1),   # sliding window 1024 < Tl: whole shards skipped
    # [cp-tp]'s shape: a rank's 16 query and 4 kv heads (Llama-3-8B's over a
    # model axis of 2) on a ring of 2 over T 8192 (Tl 4096), timed
    "cp2xtp2": dict(window=0, n_seg=1, n=2, T=8192, H=16, Hkv=4),
    # [cp-gang]'s shape: a ring of 2 (Tl 8192) and its causal schedule, held
    # to the plain steps only (its times are the causal case's)
    "causal-n2": dict(window=0, n_seg=1, n=2, check_only=True),
}
# whole step (2 layers) with cp_impl "pallas" against the single-device flash
# path (B1-B3): the loss within CP_STEP_LOSS_REL relative, every gradient leaf
# within CP_STEP_GRAD_REL in relative norm. H100: sound loss 3.4e-6, worst
# leaf 5.8e-3; B9 skipping one ring step of one shard: loss 7.2e-6 (within
# the loss limit: one step's KV of one layer barely moves a random-weight
# loss), worst leaf 0.11; B10 keeping a neighbour's dk/dv: worst leaf 0.96.
# The gradient limit sits between the sound reading and both faults'
CP_STEP_LOSS_REL = 1.5e-5
CP_STEP_GRAD_REL = 2e-2
CP_TRAIN_LAYERS = 4
CP_TRAIN_STEPS = 3
#: [cp-train]'s Mixtral part (A12a): Mixtral-8x7B widths cut to CP_MOE_LAYERS
#: layers in this process, B=1, T=RING_T over a context of RING_N (B9/B10,
#: B7/B8 on the whole rows), CP_MOE_STEPS steps, each loss held to the same
#: run without a context axis (B1-B3) within MOE_STEP_LOSS_REL
CP_MOE_LAYERS, CP_MOE_STEPS = 2, 3

# the training gang at llama-1b cut to GANG_LAYERS of its 16 layers (a cut
# that keeps the command within its time limit): B=8, T=2048 over 4 seeded
# shards, 8 steps with a checkpoint every 3 and a node loss at step 7 under
# ``tony submit``. Saves are asynchronous and a write (~1.9 GB) outlasts
# three steps, so the
# save at step 6 first joins step 3's write: step 3 is published before
# step 7 is reported, and the restart resumes at the newest step the
# worker's log shows published (3, or 6 if its write also ended).
# Each step's loss of the gang's worker against the same steps in this
# process: the same program on the same data, so the same bits unless a
# kernel or library reduction on the path runs in another order between the
# two (bf16, 8 steps: a few ulps of the loss)
GANG_STEPS, GANG_CKPT_EVERY, GANG_LOSS_AT = 8, 3, 7
GANG_LAYERS = 4
GANG_B, GANG_T, GANG_SHARDS = 8, 2048, 4
GANG_LOSS_REL = 2e-3

# BERT-base MLM (bench.py's bert recipe: B=384, T=512, remat): [bert-step] at
# B=8 against attn_impl="reference", the loss within BERT_STEP_LOSS_REL
# relative and every gradient leaf within BERT_STEP_GRAD_REL in relative norm.
# The sound readings (H100, gathered / dense packed): loss 1.9e-5 / 3.1e-5,
# worst leaf 1.7e-2 / 1.6e-2 (pos_embed: rows summed over every token, which
# the reference's bf16 probabilities round). A query head dropped by B1
# reads loss 1.2e-3 / 9.9e-5 and worst leaf 0.87 / 1.08: the gradient limit
# sits between the two on both batches, the loss limit on the gathered one
# (one head of twelve, where only 15% of the positions score, barely moves
# the dense loss). [bert-pack] on pack_ab.py's seeded stream of 384 documents
BERT_T, BERT_STEP_B = 512, 8
BERT_STEP_LOSS_REL = 2e-4
BERT_STEP_GRAD_REL = 0.2
BERT_DOC_LEN = (48, 512)
BERT_PACK_ROWS, BERT_PACK_WARMUP, BERT_PACK_STEPS = 384, 2, 4

# The MNIST MLP (BASELINE config #1) under ``tony submit``: train_mnist's
# step lines (200 steps, one every 50); its labels are random every step,
# so each loss stays within MNIST_LOSS_BAND of ln 10
MNIST_LOG_STEPS = [50, 100, 150, 200]
MNIST_LOSS_BAND = 0.5
# ResNet-50 (BASELINE config #3). [resnet-step]: full width, B=4, the same
# weights and batch three ways: in f64 on the CPU (the reference), in f32 on
# the CPU and in f32 on the card with TF32 off. At B=4 the backward through
# 53 BatchNorms is ill-conditioned: each BN's backward removes the mean and
# the normalised-input part of a gradient that varies over only 4 images,
# so f32 rounding leaves 2-3% in most gradient leaves (an H100 run read the
# CPU's f32 at 2.2e-2 to 3.2e-2 from f64, the card's at 2.6e-2 to 3.5e-2;
# the logits 2.2e-5 and 2.1e-5). So each array (logits, loss, every
# running statistic, every gradient leaf) is held, as ||x - f64|| / ||f64||,
# to RESNET_STEP_NOISE_X times the CPU's own f32 error plus
# RESNET_STEP_FLOOR: the card must be as exact as f32 on the CPU. The
# stride-2 convolutions padded symmetrically must fail. Then the same
# weights in bf16 on the card: a finite loss within 1.5 of ln 1000
RESNET_STEP_B = 4
RESNET_STEP_NOISE_X = 3.0
RESNET_STEP_FLOOR = 1e-6
RESNET_BF16_LOSS_BAND = 1.5
# [bench-resnet]: bench_resnet's flags (examples/resnet/bench_resnet.py's
# defaults); [resnet-train]: train_resnet at resnet50 for 4 steps of 64
RESNET_BENCH_B, RESNET_BENCH_STEPS, RESNET_BENCH_WARMUP = 512, 10, 3
RESNET_TRAIN_B, RESNET_TRAIN_STEPS = 64, 4


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# -- timing ------------------------------------------------------------------

def time_ms(torch, fn, flush, iters: int = 20, warmup: int = 3, clean: bool = False) -> float:
    """Median device time of ``fn`` with CUDA events, L2 flushed before each
    launch (the serving caller finds weights and KV cold). The flush writes
    the 64 MB buffer, so ``fn`` finds L2 full of dirty lines that it must write
    back as it reads; ``clean`` flushes by reading the buffer instead (what a
    decode step's matmul finds: the last one's clean weight lines)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # hold the card while the host enqueues every launch, so each event pair
    # times the device work and not the host's launch latency
    torch.cuda._sleep(100_000_000)
    pairs = []
    for _ in range(iters):
        if clean:
            flush.view(torch.int64).max()
        else:
            flush.zero_()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    t = sorted(a.elapsed_time(b) for a, b in pairs)
    return t[len(t) // 2]


# -- kernel phase --------------------------------------------------------------

def attention_cases(torch):
    """Inputs of the decode-attention kernel at the 8B shapes: dense and a
    shuffled page pool holding the same cache, a staged window, a window."""
    g = torch.Generator(device="cuda").manual_seed(0)
    dev, bf = "cuda", torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev, dtype=torch.float32).to(bf)  # noqa: E731
    q, cur_k, cur_v = rnd(S, H, DH), rnd(S, HKV, DH), rnd(S, HKV, DH)
    ck, cv = rnd(S, HKV, MAXT, DH), rnd(S, HKV, MAXT, DH)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    max_pages = MAXT // PLEN
    P = S * max_pages + 1
    perm = torch.randperm(P - 1, generator=g, device=dev)[: S * max_pages] + 1
    pt = perm.reshape(S, max_pages).to(torch.int32)
    kp = torch.zeros(P, HKV, PLEN, DH, dtype=bf, device=dev)
    vp = torch.zeros_like(kp)
    kp[pt.long()] = ck.reshape(S, HKV, max_pages, PLEN, DH).transpose(1, 2)
    vp[pt.long()] = cv.reshape(S, HKV, max_pages, PLEN, DH).transpose(1, 2)
    W = 8
    sk, sv = rnd(S, W, HKV, DH), rnd(S, W, HKV, DH)
    count = torch.tensor([3, 1, 7, 8, 5, 8, 0, 6], dtype=torch.int32, device=dev)
    base = dict(q=q, cur_k=cur_k, cur_v=cur_v, lengths=lengths)
    # the serve runs' decode batch halfway through: every slot at DECODE_BATCH_LEN
    # cache positions, the last DECODE_BATCH_STAGED of them still staged
    batch = dict(base, lengths=torch.full((S,), DECODE_BATCH_LEN, dtype=torch.int32, device=dev),
                 staged_count=torch.full((S,), DECODE_BATCH_STAGED, dtype=torch.int32, device=dev))
    return {
        "ragged": dict(base, kind="ragged", ck=ck, cv=cv, window=0),
        "ragged_window": dict(base, kind="ragged", ck=ck, cv=cv, window=700),
        "paged": dict(base, kind="paged", ck=kp, cv=vp, page_table=pt, window=0),
        "paged_staged": dict(base, kind="paged", ck=kp, cv=vp, page_table=pt, window=0,
                             staged_k=sk, staged_v=sv, staged_count=count),
        "paged_staged_window": dict(base, kind="paged", ck=kp, cv=vp, page_table=pt, window=700,
                                    staged_k=sk, staged_v=sv, staged_count=count),
        "decode_batch": dict(batch, kind="paged", ck=kp, cv=vp, page_table=pt, window=0, staged_k=sk, staged_v=sv),
    }


def attention_positions(c) -> int:
    """Key positions this run's data needs, summed over slots: the cache
    band, the staged entries inside the window, and the current token."""
    counts = c["staged_count"].tolist() if "staged_k" in c else [0] * S
    total = 0
    for ln, cnt in zip(c["lengths"].tolist(), counts):
        lo = max(ln + 1 - c["window"], 0) if c["window"] > 0 else 0
        pool_len = max(ln - cnt, 0)
        total += max(pool_len - lo, 0) + sum(1 for j in range(cnt) if pool_len + j >= lo) + 1
    return total


def attention_bytes(c) -> int:
    """Each needed K and V row read once, q read and o written once (bf16)."""
    return (attention_positions(c) * HKV * DH * 2 + 2 * S * H * DH) * 2


def attention_flops(c) -> int:
    """q·k and p·v for every query head over every needed position."""
    return 4 * H * DH * attention_positions(c)


def run_attention(torch, DA, c, plain: bool):
    kw = dict(cur_k=c["cur_k"], cur_v=c["cur_v"], window=c["window"])
    if c["kind"] == "paged":
        kw.update(page_table=c["page_table"])
        for k in ("staged_k", "staged_v", "staged_count"):
            if k in c:
                kw[k] = c[k]
        if plain:
            return DA.decode_attention_ref(c["q"], c["ck"], c["cv"], c["lengths"], **kw)
        pt = kw.pop("page_table")
        return DA.paged_decode_attention(c["q"], c["ck"], c["cv"], c["lengths"], pt, **kw)
    if plain:
        return DA.decode_attention_ref(c["q"], c["ck"], c["cv"], c["lengths"], **kw)
    return DA.ragged_decode_attention(c["q"], c["ck"], c["cv"], c["lengths"], **kw)


def sdpa_inputs(torch, DA, c):
    """The library yardstick's inputs: a padded batch [S, H, T+W+1, Dh] with
    the band (plus staged window and current token) as a boolean mask."""
    ck, cv = c["ck"], c["cv"]
    if c["kind"] == "paged":
        ck, cv = DA._gather_pages(ck, c["page_table"]), DA._gather_pages(cv, c["page_table"])
    keys, vals = [ck], [cv]
    lengths = c["lengths"].long()[:, None]
    count = c["staged_count"].long()[:, None] if "staged_k" in c else torch.zeros_like(lengths)
    pool_len = (lengths - count).clamp_min(0)
    lo = (lengths + 1 - c["window"]).clamp_min(0) if c["window"] > 0 else torch.zeros_like(lengths)
    pos = torch.arange(MAXT, device="cuda")[None, :]
    ok = [(pos >= lo) & (pos < pool_len)]
    if "staged_k" in c:
        keys.append(c["staged_k"].transpose(1, 2))
        vals.append(c["staged_v"].transpose(1, 2))
        j = torch.arange(c["staged_k"].shape[1], device="cuda")[None, :]
        ok.append((j < count) & (pool_len + j >= lo))
    keys.append(c["cur_k"][:, :, None])
    vals.append(c["cur_v"][:, :, None])
    ok.append(torch.ones(S, 1, dtype=torch.bool, device="cuda"))
    rep = H // HKV
    k = torch.cat(keys, 2).repeat_interleave(rep, dim=1).contiguous()
    v = torch.cat(vals, 2).repeat_interleave(rep, dim=1).contiguous()
    mask = torch.cat(ok, 1)[:, None, None, :]
    return c["q"][:, :, None].contiguous(), k, v, mask


def kernel_phase(torch, DA, Q, flush) -> dict:
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    build = decode_build_report()
    # what the event pair reads around one tiny launch: the floor under every decode time
    tiny = torch.empty(16, dtype=torch.int8, device="cuda")
    floor = time_ms(torch, tiny.zero_, flush)
    print(f"[kernel] event-pair floor (one 16-byte memset between the events, L2 flushed): {floor:.4f} ms",
          flush=True)
    cases = attention_cases(torch)
    att = {}
    for name, c in cases.items():
        got = run_attention(torch, DA, c, plain=False)
        again = run_attention(torch, DA, c, plain=False)
        # planted faults, from inputs outside the kernel: the longest slot one
        # split shorter in the kernel's call only (a missed split), and every
        # slot's current token taken from the slot before it
        cut = c["lengths"].clone()
        longest = int(cut.argmax())
        cut[longest] = max(int(cut[longest]) - DA._entry()[1], 0)
        faults = {"missed_split": run_attention(torch, DA, dict(c, lengths=cut), plain=False),
                  "other_slot_token": run_attention(
                      torch, DA, dict(c, cur_k=c["cur_k"].roll(1, 0).contiguous(),
                                      cur_v=c["cur_v"].roll(1, 0).contiguous()), plain=False)}
        torch.cuda.synchronize()
        want = run_attention(torch, DA, c, plain=True)
        check(bool(torch.isfinite(got.float()).all()), f"decode attention {name}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        fault = {f: (bad.float() - want.float()).abs().max().item() for f, bad in faults.items()}
        same = torch.equal(got, again)
        rec = {"case": name, "max_abs_err": err, "tol": ATTN_TOL, "fault_max_abs_err": fault, "same_bits": same}
        print(f"[kernel] decode_attention {name:20s} max_abs_err {err:.3e} (tol {ATTN_TOL}; planted faults "
              + ", ".join(f"{f} {e:.3e}" for f, e in fault.items()) + f"); same bits twice: {same}", flush=True)
        check(err <= ATTN_TOL, f"decode attention {name}: error {err} > {ATTN_TOL}")
        check(same, f"decode attention {name}: two runs of the kernel differ in their bits")
        for f, e in fault.items():
            check(e > ATTN_TOL, f"decode attention {name}: the check passes the planted fault {f} ({e})")
        del got, again, faults
        rec["ms"] = time_ms(torch, lambda c=c: run_attention(torch, DA, c, plain=False), flush)
        rec["plain_ms"] = time_ms(torch, lambda c=c: run_attention(torch, DA, c, plain=True), flush, iters=5)
        qq, kk, vv, mm = sdpa_inputs(torch, DA, c)
        lib = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mm)[:, :, 0]
        rec["library_max_abs_err"] = (lib.float() - want.float()).abs().max().item()
        rec["library_ms"] = time_ms(
            torch, lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mm), flush)
        b, f = attention_bytes(c), attention_flops(c)
        rec["bound_ms"] = max(b / HBM_BYTES_PER_S, f / F32_FLOPS) * 1e3
        rec["bound_by"] = "bytes" if b / HBM_BYTES_PER_S >= f / F32_FLOPS else "operations"
        rec["bytes"] = b
        rec["gbps"] = b / rec["ms"] / 1e6
        rec["event_floor_ms"] = floor
        print(f"[kernel]   ms {rec['ms']:.4f} plain {rec['plain_ms']:.4f} sdpa {rec['library_ms']:.4f} "
              f"bound {rec['bound_ms']:.4f} ({rec['bound_by']}); {rec['gbps']:.0f} GB/s; "
              f"sdpa err {rec['library_max_abs_err']:.3e}", flush=True)
        att[name] = rec
        del qq, kk, vv, mm
    out["ragged_decode_attention"] = dict(att["ragged"], cases=[att["ragged"], att["ragged_window"]], build=build)
    out["paged_decode_attention"] = dict(
        att["paged_staged"], cases=[att["paged"], att["paged_staged"], att["paged_staged_window"],
                                    att["decode_batch"]], build=build)
    del cases
    torch.cuda.empty_cache()

    out["int8_matmul"] = int8_kernel_phase(torch, Q, flush)
    return out


def int8_case(torch, Q, qt, x, flush) -> dict:
    """B6 on one (M, K, N) against its plain version: the same bits twice, and two
    planted faults, from inputs outside the kernel, that must fail the limit the
    kernel passes: q with its last 128 K rows zeroed (a missed K split) and the
    first 128-column tile's scales taken from the next tile; then the times."""
    M, (K, N) = x.shape[0], qt.q.shape
    got = Q.int8_matmul(x, qt)
    again = Q.int8_matmul(x, qt)
    q_cut = qt.q.clone()
    q_cut[-128:] = 0
    s_bad = qt.scale.clone()
    s_bad[:128] = qt.scale[128:256]
    faults = {"missed_k_split": Q.int8_matmul(x, Q.QTensor(q_cut, qt.scale)),
              "next_tile_scale": Q.int8_matmul(x, Q.QTensor(qt.q, s_bad))}
    del q_cut, s_bad
    torch.cuda.synchronize()
    want = Q.int8_matmul_plain(x, qt).float()
    name = f"M{M}_K{K}_N{N}"
    check(bool(torch.isfinite(got.float()).all()), f"int8_matmul {name}: non-finite output")
    err = (got.float() - want).abs().max().item()
    tol = INT8_REL_TOL * want.abs().max().item()
    fault = {f: (bad.float() - want).abs().max().item() for f, bad in faults.items()}
    same = torch.equal(got, again)
    print(f"[kernel] int8_matmul {name:22s} max_abs_err {err:.3e} (tol {tol:.3e}; planted faults "
          + ", ".join(f"{f} {e:.3e}" for f, e in fault.items()) + f"); same bits twice: {same}", flush=True)
    check(err <= tol, f"int8_matmul {name}: error {err} > {tol}")
    check(same, f"int8_matmul {name}: two runs of the kernel differ in their bits")
    for f, e in fault.items():
        check(e > tol, f"int8_matmul {name}: the check passes the planted fault {f} ({e} <= {tol})")
    del got, again, faults, want
    rec = {"case": name, "M": M, "K": K, "N": N, "path": "decode" if M <= Q.DECODE_MAX_M else "prefill",
           "max_abs_err": err, "tol": tol, "fault_max_abs_err": fault, "same_bits": same}
    rec["ms"] = time_ms(torch, lambda: Q.int8_matmul(x, qt), flush)
    rec["ms_clean_l2"] = time_ms(torch, lambda: Q.int8_matmul(x, qt), flush, clean=True)
    rec["plain_ms"] = time_ms(torch, lambda: Q.int8_matmul_plain(x, qt), flush, iters=5)
    w_bf16 = Q.dequantize(qt, torch.bfloat16)
    rec["library_ms"] = time_ms(torch, lambda: x @ w_bf16, flush)
    rec["library_ms_clean_l2"] = time_ms(torch, lambda: x @ w_bf16, flush, clean=True)
    del w_bf16
    b = K * N + 4 * N + 2 * M * K + 2 * M * N
    f = 2 * M * K * N
    rec["bound_ms"] = max(b / HBM_BYTES_PER_S, f / BF16_FLOPS) * 1e3
    rec["bound_by"] = "bytes" if b / HBM_BYTES_PER_S >= f / BF16_FLOPS else "operations"
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    print(f"[kernel]   ms {rec['ms']:.4f} plain {rec['plain_ms']:.4f} x@W_bf16 {rec['library_ms']:.4f} "
          f"bound {rec['bound_ms']:.4f} ({rec['bound_by']}, {rec['bound_share']:.0%} of it); "
          f"{rec['path']} path; L2 flushed clean: ms {rec['ms_clean_l2']:.4f} x@W_bf16 "
          f"{rec['library_ms_clean_l2']:.4f}", flush=True)
    return rec


def int8_kernel_phase(torch, Q, flush) -> dict:
    """B6 (``csrc/int8_matmul.cu``): the build report, every ``INT8_SHAPES`` weight
    at M 8 (a decode step), 128 and 1024 (the prefill bucket of a 1000-token
    prompt) through ``int8_case``, then the crossover of the two paths: each forced
    at M 16 .. 64 on the gate/up weight (K 4096, N 14336), the prefill path alone
    above."""
    build = int8_build_report()
    g = torch.Generator(device="cuda").manual_seed(1)
    recs = []
    for K, N in INT8_SHAPES:
        w = torch.randn(K, N, generator=g, device="cuda") / K ** 0.5
        qt = Q.quantize_int8(w)
        del w
        for M in INT8_MS:
            x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
            recs.append(int8_case(torch, Q, qt, x, flush))
            del x
        if (K, N) == (4096, 14336):
            cross = []
            for M in (16, 32, 48, 64, 80, 96):
                x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
                row = {"M": M, "prefill_ms": time_ms(torch, lambda: Q._launch(x, qt, 1), flush)}
                if M <= Q.DECODE_MAX_M:
                    row["decode_ms"] = time_ms(torch, lambda: Q._launch(x, qt, 0), flush)
                cross.append(row)
                print(f"[kernel] int8_matmul crossover M {M}: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in row.items() if k != "M"), flush=True)
        del qt
        torch.cuda.empty_cache()
    head = next(r for r in recs if r["case"] == "M8_K4096_N14336")
    return dict(head, cases=recs, crossover=cross, build=build)


# -- flash attention kernels (B1-B3) --------------------------------------------

_PTXAS_KERNEL = re.compile(r"(hop|simt)\d+(attn_[a-z_]+?_kernel)ILi(\d+)ELb([01])E")
_PTXAS_MOE = re.compile(r"moe_gemm_kernelILi(\d)E")
_PTXAS_DECODE = re.compile(r"decode_attention_kernelI(13__nv_bfloat16|f)Li(\d+)E")
_PTXAS_INT8 = re.compile(r"i8_(decode|prefill)_kernelILi(\d)E")
INT8_KERNELS = [("decode", 1), ("decode", 2), ("decode", 4), ("decode", 8), ("prefill", 1), ("prefill", 2)]
MOE_PASSES = ["up", "up_bwd", "down", "dx", "dw_gu", "dw_d"]  # moe_gemm.cu's Pass, in order


def ptxas_entries(log: str, pattern) -> list:
    """(the pattern's groups, {registers, spill_stores, spill_loads, stack_frame}) of
    each kernel entry in a ptxas ``-v`` report whose name the pattern matches;
    registers are those at entry (a warp-specialised kernel's consumers raise
    theirs with setmaxnreg)."""
    entries, cur = [], None
    for line in log.splitlines():
        found = pattern.search(line)
        if "Compiling entry function" in line:
            cur = {} if found else None
            if found:
                entries.append((found.groups(), cur))
        elif cur is not None and "spill stores" in line:
            for n, what in re.findall(r"(\d+) bytes (stack frame|spill stores|spill loads)", line):
                cur[what.replace(" ", "_")] = int(n)
        elif cur is not None and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return entries


def nvcc_seconds(stem: str, log: str):
    """The ``nvcc`` wall seconds a build's log ends with (printed; None if absent)."""
    from tony_tpu_torch.ops import _build

    wall = re.search(re.escape(_build.NVCC_WALL) + r" ([\d.]+)", log)
    secs = float(wall.group(1)) if wall else None
    print(f"[build] {stem}.cu: nvcc " + (f"{secs:.1f}s" if wall else "seconds not in the log"), flush=True)
    return secs


def attention_build_report(stem: str) -> dict:
    """The attention kernels of the library built from ``csrc/<stem>.cu``:
    ptxas's registers (at entry: the bf16 kernels' consumer warpgroups raise
    theirs to 240 with setmaxnreg) and spill bytes from the ``.log`` that
    ``_build`` writes beside the library, the dynamic shared memory a block
    asks for, and the ``nvcc`` seconds that log ends with."""
    import ctypes

    from tony_tpu_torch.ops import _build

    log = _build.build_all()[stem].with_suffix(".log").read_text()
    smem = _build.library("flash_attention").tt_attention_smem_bytes
    smem.restype, smem.argtypes = ctypes.c_int, [ctypes.c_int] * 3
    kinds = {"attn_fwd_kernel": 0, "attn_bwd_dq_kernel": 1, "attn_bwd_dkv_kernel": 2}
    kernels = []
    for (route, name, d, step), rec in ptxas_entries(log, _PTXAS_KERNEL):
        kernels.append({"kernel": name, "dtype": "bf16" if route == "hop" else "f32", "D": int(d),
                        "step": step == "1", "smem_bytes": smem(kinds[name], int(d), 0 if route == "hop" else 1),
                        **rec})
    secs = nvcc_seconds(stem, log)
    for k in kernels:
        print(f"[build]   {k['dtype']} {k['kernel']}<D{k['D']}{', ring step' if k['step'] else ''}>: "
              f"{k['registers']} registers at entry, {k['smem_bytes']} B shared memory, spills "
              f"{k['spill_stores']} / {k['spill_loads']} B", flush=True)
    return {"nvcc_s": secs, "kernels": kernels}


def moe_build_report() -> dict:
    """The six passes of ``csrc/moe_gemm.cu`` (bf16, one warp-specialised body):
    ptxas's registers at entry (the consumers raise theirs to 240) and spill
    bytes, the dynamic shared memory a block asks for, the ``nvcc`` seconds.
    A pass that spills fails the run."""
    import ctypes

    from tony_tpu_torch.ops import _build

    log = _build.build_all()["moe_gemm"].with_suffix(".log").read_text()
    smem = _build.library("moe_gemm").tt_moe_smem_bytes
    smem.restype, smem.argtypes = ctypes.c_int, []
    kernels = [{"kernel": "moe_gemm_kernel", "pass": MOE_PASSES[int(p)], "dtype": "bf16",
                "smem_bytes": smem(), **rec} for (p,), rec in ptxas_entries(log, _PTXAS_MOE)]
    secs = nvcc_seconds("moe_gemm", log)
    for k in kernels:
        print(f"[build]   bf16 moe_gemm_kernel<{k['pass']}>: {k['registers']} registers at entry, "
              f"{k['smem_bytes']} B shared memory, spills {k['spill_stores']} / {k['spill_loads']} B",
              flush=True)
    check(sorted(k["pass"] for k in kernels) == sorted(MOE_PASSES),
          f"moe build: ptxas reported passes {[k['pass'] for k in kernels]}, want {MOE_PASSES}")
    check(all(k["spill_stores"] == 0 and k["spill_loads"] == 0 for k in kernels),
          "moe build: a bf16 MoE kernel spills: " + str([(k["pass"], k["spill_stores"]) for k in kernels]))
    return {"nvcc_s": secs, "kernels": kernels}


def decode_build_report() -> dict:
    """The four instantiations of ``csrc/decode_attention.cu`` (B4/B5, bf16
    and f32, Dh 64 and 128): ptxas's registers and spill bytes, the dynamic
    shared memory a block asks for, the ``nvcc`` seconds. A bf16
    instantiation that spills fails the run."""
    import ctypes

    from tony_tpu_torch.ops import _build

    log = _build.build_all()["decode_attention"].with_suffix(".log").read_text()
    smem = _build.library("decode_attention").tt_decode_smem_bytes
    smem.restype, smem.argtypes = ctypes.c_int, [ctypes.c_int] * 2
    kernels = []
    for (t, d), rec in ptxas_entries(log, _PTXAS_DECODE):
        dtype = "f32" if t == "f" else "bf16"
        kernels.append({"kernel": "decode_attention_kernel", "dtype": dtype, "D": int(d),
                        "smem_bytes": smem(int(dtype == "f32"), int(d)), **rec})
    secs = nvcc_seconds("decode_attention", log)
    for k in kernels:
        print(f"[build]   {k['dtype']} decode_attention_kernel<D{k['D']}>: {k['registers']} registers, "
              f"{k['smem_bytes']} B shared memory, spills {k['spill_stores']} / {k['spill_loads']} B", flush=True)
    check(sorted((k["dtype"], k["D"]) for k in kernels) == [("bf16", 64), ("bf16", 128), ("f32", 64), ("f32", 128)],
          f"decode build: ptxas reported {[(k['dtype'], k['D']) for k in kernels]}")
    check(all(k["spill_stores"] == 0 and k["spill_loads"] == 0 for k in kernels if k["dtype"] == "bf16"),
          "decode build: a bf16 decode kernel spills: " + str([(k["D"], k["spill_stores"])
                                                             for k in kernels if k["dtype"] == "bf16"]))
    return {"nvcc_s": secs, "kernels": kernels}


def int8_build_report() -> dict:
    """The kernels of ``csrc/int8_matmul.cu`` (B6): the decode path at MT 1, 2, 4
    and 8 column tiles of 8 tokens, and the prefill path at TH 1 and 2 128-token
    halves a block tile (``tile``); ptxas's registers (at entry: the prefill
    consumers raise theirs to 240 with setmaxnreg) and spill bytes, the dynamic
    shared memory a block asks for, the ``nvcc`` seconds. Any of them that
    spills fails the run."""
    import ctypes

    from tony_tpu_torch.ops import _build

    log = _build.build_all()["int8_matmul"].with_suffix(".log").read_text()
    smem = _build.library("int8_matmul").tt_int8_smem_bytes
    smem.restype, smem.argtypes = ctypes.c_int, [ctypes.c_int] * 2
    kernels = []
    for (path, tile), rec in ptxas_entries(log, _PTXAS_INT8):
        kernels.append({"kernel": f"i8_{path}_kernel", "path": path, "tile": int(tile),
                        "smem_bytes": smem(int(path == "prefill"), int(tile)), **rec})
    secs = nvcc_seconds("int8_matmul", log)
    for k in kernels:
        print(f"[build]   {k['kernel']}<{'MT' if k['path'] == 'decode' else 'TH'} {k['tile']}>: {k['registers']} "
              f"registers, {k['smem_bytes']} B shared memory, spills {k['spill_stores']} / {k['spill_loads']} B",
              flush=True)
    check(sorted((k["path"], k["tile"]) for k in kernels) == INT8_KERNELS,
          f"int8 build: ptxas reported {[(k['path'], k['tile']) for k in kernels]}")
    check(all(k["spill_stores"] == 0 and k["spill_loads"] == 0 for k in kernels),
          "int8 build: a B6 kernel spills: " + str([(k["kernel"], k["tile"], k["spill_stores"]) for k in kernels]))
    return {"nvcc_s": secs, "kernels": kernels}


def row_rel_err(got, want) -> float:
    """Largest error of a row (a head_dim vector) over that row's norm, the
    norm floored at a tenth of the RMS row norm: a row whose exact value is
    0 (dq of a segment's first query) holds only rounding noise."""
    d = (got.float() - want.float()).norm(dim=-1)
    n = want.float().norm(dim=-1)
    return (d / n.clamp_min(0.1 * n.square().mean().sqrt())).max().item()


def skipped_tile(A):
    """``_visible`` of a faulty kernel, planted to show the check's reach:
    the rows of the last 64-row q tile skip the 64-key tile holding the
    first key row T-1 sees (a wrong window start), one tile of up to 32."""
    real = A._visible

    def visible(Tq, Tk, causal, window, seg_b, device):
        ok = real(Tq, Tk, causal, window, seg_b, device)
        k0 = min(int(ok[-1].nonzero()[0]) // 64 * 64, Tq - 128)
        ok[Tq - 64:, k0:k0 + 64] = False
        return ok

    return visible


def flash_inputs(torch, A, c):
    """q, k, v, do (bf16), segment ids and the [B, T, T] visible mask of a
    flash case. Segments: ``n_seg`` a row from random cuts, numbered from 0;
    with ``pad`` numbered from 1 and followed by a padded tail of 16-64
    positions (segment 0), as ``pack_sequences`` lays out rows."""
    g = torch.Generator(device="cuda").manual_seed(2)
    B, T, Hq, Hkv, Dh = c["B"], c["T"], c["H"], c["Hkv"], c["Dh"]
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    q, k, v, do = rnd(B, Hq, T, Dh), rnd(B, Hkv, T, Dh), rnd(B, Hkv, T, Dh), rnd(B, Hq, T, Dh)
    seg = None
    if c["n_seg"] > 1:
        rows = []
        for _ in range(B):
            tail = int(torch.randint(16, 65, (1,), generator=g, device="cuda")) if c.get("pad") else 0
            cuts = torch.randperm(T - tail - 1, generator=g, device="cuda")[: c["n_seg"] - 1].sort().values + 1
            ids = torch.searchsorted(cuts, torch.arange(T, device="cuda"), right=True)
            if c.get("pad"):
                ids = torch.where(torch.arange(T, device="cuda") < T - tail, ids + 1, 0)
            rows.append(ids)
        seg = torch.stack(rows).to(torch.int32).contiguous()
    visible = torch.stack([A._visible(T, T, c["causal"], c["window"], None if seg is None else seg[b], "cuda")
                           for b in range(B)])
    return q, k, v, do, seg, visible


def flash_cost(c, pairs: int, seg) -> dict:
    """Operations and bytes of each kernel on this run's data: ``pairs``
    visible (query, key) positions per head; each input read once, each
    output written once (bf16 tensors, f32 lse / delta, int32 segment ids)."""
    B, T, Hq, Hkv, Dh = c["B"], c["T"], c["H"], c["Hkv"], c["Dh"]
    qb, kvb, row = B * Hq * T * Dh * 2, B * Hkv * T * Dh * 2, B * Hq * T * 4
    segb = B * T * 4 if seg is not None else 0
    return {
        "flash_fwd": (4 * Hq * Dh * pairs, 2 * qb + 2 * kvb + row + segb),
        "flash_bwd_dq": (6 * Hq * Dh * pairs, 3 * qb + 2 * kvb + 2 * row + segb),
        "flash_bwd_dkv": (8 * Hq * Dh * pairs, 2 * qb + 4 * kvb + 2 * row + segb),
    }


def flash_kernel_phase(torch, A, flush, cases) -> dict:
    """B1-B3 against their plain versions on the ``FLASH_CASES`` named by
    ``cases``, with planted faults, timed against their bound and SDPA."""
    import torch.nn.functional as F

    build = attention_build_report("flash_attention")
    recs = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkv": []}
    for name in cases:
        c = FLASH_CASES[name]
        print(f"[kernel] flash case {name}: B={c['B']} T={c['T']} H={c['H']} Hkv={c['Hkv']} Dh={c['Dh']} "
              f"causal={c['causal']} window={c['window']} segments={c['n_seg']}"
              + (" + padded tail" if c.get("pad") else ""), flush=True)
        q, k, v, do, seg, visible = flash_inputs(torch, A, c)
        kw = dict(causal=c["causal"], segment_ids=seg, window=c["window"])
        o, lse = A.flash_fwd(q, k, v, **kw)
        o_p, lse_p = A.flash_fwd_plain(q, k, v, **kw)
        delta = (do.float() * o_p.float()).sum(-1)
        bwd = (q, k, v, do, lse_p, delta)
        dq = A.flash_bwd_dq(*bwd, **kw)
        dk, dv = A.flash_bwd_dkv(*bwd, **kw)
        torch.cuda.synchronize()
        dq_p = A.flash_bwd_dq_plain(*bwd, **kw)
        dk_p, dv_p = A.flash_bwd_dkv_plain(*bwd, **kw)
        lse_err = (lse - lse_p).abs().max().item()
        with mock.patch.object(A, "_visible", skipped_tile(A)):
            o_f = A.flash_fwd_plain(q, k, v, **kw)[0]
            dq_f = A.flash_bwd_dq_plain(*bwd, **kw)
            dk_f, dv_f = A.flash_bwd_dkv_plain(*bwd, **kw)
        outs = {"flash_fwd": [(o, o_p, o_f)], "flash_bwd_dq": [(dq, dq_p, dq_f)],
                "flash_bwd_dkv": [(dk, dk_p, dk_f), (dv, dv_p, dv_f)]}
        head_faults, same_bits = {}, None
        if name in BERT_FLASH_CASES:
            # the same bits from a second launch of each kernel; a query head
            # dropped by B1 (its o) and by B3 (its do and delta) must fail too
            o2, lse2 = A.flash_fwd(q, k, v, **kw)
            dk2, dv2 = A.flash_bwd_dkv(*bwd, **kw)
            same_bits = all(torch.equal(a, b) for a, b in (
                (o, o2), (lse, lse2), (dq, A.flash_bwd_dq(*bwd, **kw)), (dk, dk2), (dv, dv2)))
            del o2, lse2, dk2, dv2
            o_h = dropped_head_fwd(A)(q, k, v, **kw)[0]
            dk_h, dv_h = dropped_head_dkv(A)(*bwd, **kw)
            head_faults = {"flash_fwd": row_rel_err(o_h, o_p),
                           "flash_bwd_dkv": max(row_rel_err(dk_h, dk_p), row_rel_err(dv_h, dv_p))}
            del o_h, dk_h, dv_h
        # the library yardstick: SDPA on head-expanded K/V (a boolean mask for
        # segments and the window), its forward, and its backward alone from
        # a saved forward (which covers B2 and B3 together)
        rep = c["H"] // c["Hkv"]
        kk = k.repeat_interleave(rep, 1).requires_grad_(True)
        vv = v.repeat_interleave(rep, 1).requires_grad_(True)
        qq = q.detach().clone().requires_grad_(True)
        mask = visible[:, None] if seg is not None or c["window"] else None
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qq, kk, vv, attn_mask=mask, is_causal=mask is None and c["causal"])
        with torch.no_grad():
            lib_err = (sdpa().float() - o_p.float()).abs().max().item()
            lib_fwd = time_ms(torch, sdpa, flush)
        lib_o = sdpa()
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(lib_o, (qq, kk, vv), do, retain_graph=True),
                          flush)
        del lib_o
        pairs = int(visible.sum().item())
        cost = flash_cost(c, pairs, seg)
        kernels = {"flash_fwd": lambda: A.flash_fwd(q, k, v, **kw),
                   "flash_bwd_dq": lambda: A.flash_bwd_dq(*bwd, **kw),
                   "flash_bwd_dkv": lambda: A.flash_bwd_dkv(*bwd, **kw)}
        plains = {"flash_fwd": lambda: A.flash_fwd_plain(q, k, v, **kw),
                  "flash_bwd_dq": lambda: A.flash_bwd_dq_plain(*bwd, **kw),
                  "flash_bwd_dkv": lambda: A.flash_bwd_dkv_plain(*bwd, **kw)}
        errs = {}
        for kname, triples in outs.items():
            for got, _, _ in triples:
                check(bool(torch.isfinite(got.float()).all()), f"{kname} {name}: non-finite output")
            err = max(row_rel_err(got, want) for got, want, _ in triples)
            fault = max(row_rel_err(bad, want) for _, want, bad in triples)
            abs_err = max((got.float() - want.float()).abs().max().item() for got, want, _ in triples)
            errs[kname] = (err, fault, abs_err)
            print(f"[kernel] {kname} {name:9s} row err {err:.3e} (tol {FLASH_ROW_TOL}; planted fault "
                  f"{fault:.3e}), max_abs_err {abs_err:.3e}"
                  + (f"; lse err {lse_err:.2e} (tol {LSE_ATOL}); sdpa max_abs_err {lib_err:.2e}"
                     if kname == "flash_fwd" else "")
                  + (f"; dropped query head {head_faults[kname]:.3e}" if kname in head_faults else ""),
                  flush=True)
        check(lse_err <= LSE_ATOL, f"flash_fwd {name}: lse error {lse_err} > {LSE_ATOL}")
        for kname, (err, fault, _) in errs.items():
            check(err <= FLASH_ROW_TOL, f"{kname} {name}: row error {err} > {FLASH_ROW_TOL}")
            check(fault > FLASH_ROW_TOL, f"{kname} {name}: the check passes a planted fault ({fault})")
        for kname, fault in head_faults.items():
            check(fault > FLASH_ROW_TOL, f"{kname} {name}: the check passes a dropped query head ({fault})")
        if same_bits is not None:
            print(f"[kernel] flash {name}: a second launch of B1-B3 gives the same bits: {same_bits}", flush=True)
            check(same_bits, f"flash {name}: a second launch of B1-B3 gave other bits")
        for kname, (err, fault, abs_err) in errs.items():
            flops, nbytes = cost[kname]
            rec = {"case": name, "max_abs_err": abs_err, "row_err": err, "tol": FLASH_ROW_TOL,
                   "fault_row_err": fault, "pairs": pairs, "flops": flops, "bytes": nbytes,
                   **({"fault_head_row_err": head_faults[kname]} if kname in head_faults else {}),
                   **({"same_bits": same_bits} if same_bits is not None else {}),
                   "ms": time_ms(torch, kernels[kname], flush),
                   # at BERT's shapes a plain call takes seconds and is no yardstick:
                   # compared with above, not timed
                   "plain_ms": None if name in BERT_FLASH_CASES
                   else time_ms(torch, plains[kname], flush, iters=3, warmup=1),
                   "library_ms": lib_fwd if kname == "flash_fwd" else lib_bwd,
                   "library_call": "sdpa forward" if kname == "flash_fwd"
                   else "sdpa backward alone (covers B2+B3 together)",
                   "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
                   "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations"}
            rec["tflops"] = flops / rec["ms"] / 1e9
            plain = "not timed" if rec["plain_ms"] is None else f"{rec['plain_ms']:.4f}"
            print(f"[kernel] {kname} {name:9s} ms {rec['ms']:.4f} plain {plain} "
                  f"{rec['library_call']} {rec['library_ms']:.4f} bound {rec['bound_ms']:.4f} "
                  f"({rec['bound_by']}); {rec['tflops']:.1f} TFLOP/s", flush=True)
            recs[kname].append(rec)
        del q, k, v, do, seg, visible, o, lse, o_p, lse_p, delta, dq, dk, dv, dq_p, dk_p, dv_p
        del o_f, dq_f, dk_f, dv_f, qq, kk, vv, mask, outs, bwd
        torch.cuda.empty_cache()
    return {kname: dict(rs[0], cases=rs, build=build) for kname, rs in recs.items()}


def _leaves(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


def _dropped_heads(q, k) -> slice:
    """Query head 0 of every kv group; head 0 alone where each group is one
    head (MHA)."""
    n_rep = q.shape[1] // k.shape[1]
    return slice(None, None, n_rep) if n_rep > 1 else slice(0, 1)


def dropped_head_fwd(A):
    """B1 with a planted fault: query head 0 of every kv group gives zeros."""
    real = A.flash_fwd

    def fwd(q, k, v, **kw):
        o, lse = real(q, k, v, **kw)
        o = o.clone()
        o[:, _dropped_heads(q, k)] = 0
        return o, lse

    return fwd


def dropped_head_dkv(A):
    """B3 with a planted fault: dk and dv leave out query head 0 of every
    kv group (its do and delta read as zeros)."""
    real = A.flash_bwd_dkv

    def dkv(q, k, v, do, lse, delta, **kw):
        do, delta = do.clone(), delta.clone()
        do[:, _dropped_heads(q, k)] = 0
        delta[:, _dropped_heads(q, k)] = 0
        return real(q, k, v, do, lse, delta, **kw)

    return dkv


def whole_step_check(torch, llama, A) -> dict:
    """One ``loss_fn`` value and gradient through the kernels (remat "full",
    as the train run) against ``attn_impl="reference"`` on the same params
    and batch: 8B width, 2 layers, B=1, T=2048. Two planted faults (one
    query head of each kv group dropped by B1, or by B3) must fail the limits
    that the sound kernels pass."""
    cfg = llama.config_from_dict({"preset": "llama3-8b", "n_layers": 2})
    params = llama.init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    names, tensors = zip(*_leaves(params))
    for t in tensors:
        t.requires_grad_(True)
    batch = llama.synthetic_batch(torch.Generator(device="cuda").manual_seed(1), 1, 2048, cfg)

    def run(impl):
        A.reset_launches()
        loss, _ = llama.loss_fn(params, batch, dataclasses.replace(cfg, attn_impl=impl))
        return loss.item(), torch.autograd.grad(loss, tensors), dict(A.launches)

    lr, gr, nr = run("reference")
    check(not any(nr.values()), f"whole step: the reference launched kernels {nr}")
    out = {"loss_reference": lr}
    variants = {"kernels": None, "fault_b1_head": ("flash_fwd", dropped_head_fwd(A)),
                "fault_b3_head": ("flash_bwd_dkv", dropped_head_dkv(A))}
    for variant, patch in variants.items():
        with mock.patch.object(A, *patch) if patch else contextlib.nullcontext():
            lk, gk, nk = run("auto")
        grad_rel = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
                    for n, a, b in zip(names, gk, gr)}
        del gk
        worst = max(grad_rel, key=grad_rel.get)
        rec = {"loss": lk, "loss_rel": abs(lk - lr) / abs(lr), "worst_leaf": worst,
               "worst_grad_rel": grad_rel[worst], "grad_rel": grad_rel, "launches": nk}
        out[variant] = rec
        print(f"[step] {variant}: loss {lk:.6f} reference {lr:.6f} rel {rec['loss_rel']:.2e} "
              f"(tol {STEP_LOSS_REL}); worst grad leaf {worst} rel norm {grad_rel[worst]:.2e} "
              f"(tol {STEP_GRAD_REL}); kernel launches {nk}", flush=True)
        check(all(nk.values()), f"whole step {variant}: kernel launches {nk}")
    k = out["kernels"]
    check(math.isfinite(k["loss"]) and k["loss_rel"] <= STEP_LOSS_REL,
          f"whole step: loss {k['loss']} vs {lr}")
    check(all(math.isfinite(x) and x <= STEP_GRAD_REL for x in k["grad_rel"].values()),
          f"whole step: gradient relative norms {k['grad_rel']}")
    check(out["fault_b1_head"]["loss_rel"] > STEP_LOSS_REL,
          f"whole step: the loss limit passes a planted B1 fault ({out['fault_b1_head']['loss_rel']})")
    for variant in ("fault_b1_head", "fault_b3_head"):
        check(out[variant]["worst_grad_rel"] > STEP_GRAD_REL,
              f"whole step: the gradient limit passes the planted {variant} "
              f"({out[variant]['worst_grad_rel']})")
    return out


def train_phase(torch, llama, A, out_dir: Path) -> dict:
    """``run_lm_training`` twice on one checkpoint directory: 3 steps with a
    checkpoint at step 3, then 6 steps resumed from it. The kernel launch
    counts are set to 0 just before and read just after the two calls."""
    from tony_tpu_torch.train.loop import LoopConfig, run_lm_training
    from tony_tpu_torch.train.metrics import transformer_flops_per_token

    cfg = llama.config_from_dict({"preset": "llama3-8b", "n_layers": TRAIN_LAYERS})
    ck = out_dir / "train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    base = dict(batch_size=4, seq_len=2048, warmup_steps=2, schedule_steps=6, checkpoint_every=3,
                checkpoint_dir=str(ck), log_every=1)
    runs = []
    A.reset_launches()
    for steps in (3, 6):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run_lm_training(llama, cfg, LoopConfig(steps=steps, **base))
        res["wall_s"] = time.perf_counter() - t0
        res["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        runs.append(res)
    launches = dict(A.launches)
    shutil.rmtree(ck, ignore_errors=True)
    log = runs[0]["log"] + runs[1]["log"]
    for line in log:
        check(math.isfinite(line["loss"]) and math.isfinite(line["grad_norm"]), f"train: {line}")
        print(f"[train] step {line['step']} loss {line['loss']} grad_norm {line['grad_norm']} "
              f"{line['step_time_ms']} ms", flush=True)
    check([x["step"] for x in log] == [1, 2, 3, 4, 5, 6], f"train: steps {[x['step'] for x in log]}")
    check(abs(log[0]["loss"] - math.log(cfg.vocab_size)) <= 1.5,
          f"train: first loss {log[0]['loss']} not within 1.5 of ln(V) {math.log(cfg.vocab_size):.2f}")
    check(runs[0]["start_step"] == 0 and runs[1]["start_step"] == 3,
          f"train: start steps {runs[0]['start_step']}, {runs[1]['start_step']} (want 0, 3)")
    check(all(launches.values()), f"train: a flash kernel was never launched: {launches}")
    # steady state: every step but the first of each call (allocator / first-use warm-up)
    steady = sorted(x["step_time_ms"] for x in runs[0]["log"][1:] + runs[1]["log"][1:])
    ms = steady[len(steady) // 2]
    tokens = base["batch_size"] * base["seq_len"]
    fpt = transformer_flops_per_token(cfg.num_params(), cfg.n_layers, cfg.d_model, base["seq_len"])
    rec = {
        "layers": TRAIN_LAYERS, "params": cfg.num_params(), "batch": base["batch_size"],
        "seq_len": base["seq_len"], "log": log, "launches": launches,
        "step_ms": ms, "tok_per_s": tokens / ms * 1e3,
        "mfu_loop": sorted(x["mfu"] for x in runs[0]["log"][1:] + runs[1]["log"][1:])[len(steady) // 2],
        "mfu_t2048": tokens / ms * 1e3 * fpt / BF16_FLOPS,
        "max_memory_gib": max(r["max_memory_gib"] for r in runs),
        "wall_s": [r["wall_s"] for r in runs], "start_steps": [r["start_step"] for r in runs],
    }
    print(f"[train] 8B width, {TRAIN_LAYERS} layers, B=4 T=2048: {rec['step_ms']:.1f} ms/step, "
          f"{rec['tok_per_s']:.0f} tok/s, MFU {rec['mfu_t2048']:.3f} (6N + attention at T=2048; "
          f"the loop's max_seq basis {rec['mfu_loop']:.3f}), peak memory {rec['max_memory_gib']:.1f} GiB, "
          f"calls {rec['wall_s'][0]:.1f}s + {rec['wall_s'][1]:.1f}s; launches {launches}", flush=True)
    return rec


def _union_us(ranges) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(ranges):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _kernel_family(name: str) -> str:
    """The port's kernels by source (``moe`` B7/B8, ``attention`` B1-B3 and
    B9/B10, ``decode`` B4/B5, ``int8`` B6), cuDNN's convolutions (forward,
    data and weight gradients; many are implicit GEMMs) as ``conv`` and
    BatchNorm's kernels as ``norm`` (both before ``gemm``, so no name of the
    transformer phases changes family), cuBLAS's products as ``gemm``, the
    rest ``other``."""
    if "moe_gemm_kernel" in name:
        return "moe"
    if re.search(r"i8_(decode|prefill)_kernel", name):
        return "int8"
    if "decode_attention_kernel" in name:
        return "decode"
    if re.search(r"attn_(fwd|bwd_dq|bwd_dkv)_kernel", name):
        return "attention"
    low = name.lower()
    if re.search(r"fprop|dgrad|wgrad|implicit|conv(?!ert)", low):
        return "conv"
    if "batch_norm" in low or "bn_" in low:
        return "norm"
    return "gemm" if any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma")) else "other"


def profile_families(torch, run, reps: int):
    """``reps`` calls of ``run`` under ``torch.profiler``: device ms a call by
    kernel family, the five kernels with the most device ms a call (name, ms,
    launches), device-busy ms a call (the union of the kernels' spans), the
    host wall a call, and the busy share (busy over the host wall, which the
    profiler's own host cost stretches). None if the profiler recorded no
    device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    fam: dict = {}
    names: dict = {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3 / reps
        f = _kernel_family(e.name)
        fam[f] = fam.get(f, 0.0) + ms
        rec = names.setdefault(e.name[:120], [0.0, 0])
        rec[0] += ms
        rec[1] += 1
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in kernels)
    top_kernels = [(n, ms, count // reps) for n, (ms, count) in sorted(names.items(), key=lambda kv: -kv[1][0])[:5]]
    return {"device_ms_by_family": fam, "top_kernels": top_kernels, "device_ms": busy_us / 1e3 / reps,
            "profiled_wall_ms": wall_us / 1e3 / reps, "busy_share": busy_us / wall_us}


def step_breakdown(torch, model, cfg, tag: str, B: int = 4, T: int = 2048) -> dict:
    """Where the train step's time goes, at ``cfg`` on B rows of T (the train
    runs' B=4, T=2048 by default): the step as ``make_train_step``
    runs it (``loss_fn``, gradients, global norm, AdamW), timed with CUDA
    events in two parts, then two more steps under ``torch.profiler`` for
    device time by kernel family and the busy share (device time over the
    host wall of the profiled steps, which the profiler's own host cost
    stretches)."""
    from tony_tpu_torch.train.trainer import OptimizerConfig, TrainState, global_norm

    opt = OptimizerConfig(learning_rate=3e-4, warmup_steps=2, total_steps=6).build()
    state = TrainState.create(model.init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda"), opt)
    names, tensors = zip(*_leaves(state.params))
    gen = torch.Generator(device="cuda").manual_seed(3)

    def step():
        batch = model.synthetic_batch(gen, B, T, cfg)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss, _ = model.loss_fn(state.params, batch, cfg)
        grads = torch.autograd.grad(loss, tensors)
        ev[1].record()
        opt.update(state.params, dict(zip(names, grads)), state.opt_state, global_norm(grads))
        ev[2].record()
        return ev

    step()
    timed = [step() for _ in range(2)]
    torch.cuda.synchronize()
    split = [(a.elapsed_time(b), b.elapsed_time(c)) for a, b, c in timed]
    rec = {"grads_ms": min(x[0] for x in split), "optimizer_ms": min(x[1] for x in split)}
    prof = profile_families(torch, step, 2)
    if prof:
        rec.update(prof)
        fam = prof["device_ms_by_family"]
        print(f"[{tag}] step split: loss+grads {rec['grads_ms']:.1f} ms, optimizer {rec['optimizer_ms']:.1f} ms; "
              f"device ms a step by kernel family {({k: round(v, 1) for k, v in fam.items()})}, "
              f"busy {rec['busy_share']:.3f} of the profiled wall", flush=True)
        for name, ms, n in prof["top_kernels"]:
            print(f"[{tag}]   {ms:8.1f} ms {n:5d}x  {name}", flush=True)
    else:
        rec["device_ms_by_family"] = "not measured: the profiler recorded no device activity"
        print(f"[{tag}] step split: loss+grads {rec['grads_ms']:.1f} ms, optimizer {rec['optimizer_ms']:.1f} ms; "
              "the profiler recorded no device activity", flush=True)
    return rec


# -- remat policies, bench.py's recipes, asynchronous saves -------------------------

# B1 (flash_fwd) and B7 (moe_fwd) launches a layer over one forward and
# backward under each remat policy: "flash" keeps their outputs, the others
# replay them; B2, B3 and B8 run once a layer under every policy
REMAT_FWD_PER_LAYER = {"full": 2, "dots": 2, "flash": 1}
REMAT_TIMED_STEPS = 3
# bench.py's single-card training presets (its ``_build_presets``), field for
# field: (model, config fields, batch, seq); the optimizer as bench.py's
# (warmup 10 of 1000 steps at the default rate)
BENCH_RECIPES = {
    "1chip": ("llama", {"preset": "llama-1b", "max_seq": 2048, "remat": True, "remat_policy": "flash",
                        "attn_impl": "auto", "ce_chunk": 1024}, 12, 2048),
    "moe": ("mixtral", {"vocab_size": 32_000, "d_model": 1024, "n_layers": 8, "n_heads": 8, "n_kv_heads": 4,
                        "d_ff": 2048, "max_seq": 2048, "num_experts": 8, "top_k": 2, "remat": True,
                        "remat_policy": "flash", "ce_chunk": 512}, 44, 2048),
    "bert": ("bert", {"preset": "bert-base", "remat": True, "attn_impl": "auto"}, 384, 512),
}
BENCH_STEPS = 6
# the asynchronous save at the gang's shape (llama-1b cut to GANG_LAYERS
# layers, B=8, T=2048): saves after step 4, whose write (one torch.save at
# ~0.8-1.3 GB/s) the 10 steps after it overlap, and after the last step
ASYNC_STEPS, ASYNC_SAVE_AT = 14, (4, 14)


def _expected_launches(counters, L: int, per: int, steps: int = 1) -> dict:
    """The launch counts ``steps`` forward and backward passes of ``L``
    layers should give, B1 and B7 ``per`` times a layer."""
    want = {"flash_fwd": per * L, "flash_bwd_dq": L, "flash_bwd_dkv": L, "moe_fwd": per * L, "moe_bwd": L}
    return {k: want[k] * steps for C in counters for k in C.launches}


def remat_phase(torch, model, cfg, policies, counters, tag: str, loss_tol: float, grad_tol: float) -> dict:
    """One train state and batch (B=4, T=2048) under each remat policy:
    the loss and every gradient against the first policy's ("full") within
    the whole-step limits ``loss_tol`` / ``grad_tol``, with B1-B3 (and B7,
    B8: ``counters``) launched as ``REMAT_FWD_PER_LAYER`` schedules, and the
    peak memory that forward and backward adds to the state (activations
    kept and replayed, and the gradients); then a warm-up and
    ``REMAT_TIMED_STEPS`` train steps (loss, gradients, AdamW) under each,
    their mean ms/step on the host clock around synchronised steps, the
    peak memory and the launches of those steps, and one more step's device
    ms by kernel family (``torch.profiler``)."""
    from tony_tpu_torch.train.trainer import OptimizerConfig, TrainState, make_train_step

    L = cfg.n_layers
    opt = OptimizerConfig(learning_rate=3e-4, warmup_steps=2, total_steps=6).build()
    state = TrainState.create(model.init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda"), opt)
    names, tensors = zip(*_leaves(state.params))
    batch = model.synthetic_batch(torch.Generator(device="cuda").manual_seed(1), 4, 2048, cfg)

    def count(fn):
        for C in counters:
            C.reset_launches()
        fn()
        torch.cuda.synchronize()
        return {k: v for C in counters for k, v in C.launches.items()}

    out, ref = {}, None
    for policy in policies:
        pcfg = dataclasses.replace(cfg, remat_policy=policy)
        res = {}

        def fwd_bwd():
            loss, _ = model.loss_fn(state.params, batch, pcfg)
            res["loss"], res["grads"] = loss.item(), torch.autograd.grad(loss, tensors)

        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        n = count(fwd_bwd)
        added = (torch.cuda.max_memory_allocated() - base) / 2**30
        want = _expected_launches(counters, L, REMAT_FWD_PER_LAYER[policy])
        check(n == want, f"{tag} {policy}: launches {n} of one forward and backward, want {want}")
        if ref is None:
            ref = res
        grad_rel = {k: ((a.float() - b.float()).norm() / b.float().norm()).item()
                    for k, a, b in zip(names, res["grads"], ref["grads"])}
        worst = max(grad_rel, key=grad_rel.get)
        rec = {"loss": res["loss"], "loss_rel": abs(res["loss"] - ref["loss"]) / abs(ref["loss"]),
               "worst_leaf": worst, "worst_grad_rel": grad_rel[worst], "launches": n, "fwd_bwd_added_gib": added,
               "same_bits": res["loss"] == ref["loss"] and all(
                   torch.equal(a, b) for a, b in zip(res["grads"], ref["grads"]))}
        del res
        check(math.isfinite(rec["loss"]) and rec["loss_rel"] <= loss_tol and all(
            math.isfinite(x) and x <= grad_tol for x in grad_rel.values()),
            f"{tag} {policy}: loss rel {rec['loss_rel']:.2e} (tol {loss_tol}), gradient relative norms {grad_rel}")
        out[policy] = rec
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    for policy in policies:
        pcfg = dataclasses.replace(cfg, remat_policy=policy)
        step_fn = make_train_step(lambda p, b, c=pcfg: model.loss_fn(p, b, c), opt)
        torch.cuda.reset_peak_memory_stats()
        state, m = step_fn(state, batch)  # warm-up
        float(m["loss"])
        t0 = [0.0]

        def steps():
            t0[0] = time.perf_counter()
            for _ in range(REMAT_TIMED_STEPS):
                step_fn(state, batch)

        alloc0 = torch.cuda.memory_stats()
        n = count(steps)
        ms = (time.perf_counter() - t0[0]) * 1e3 / REMAT_TIMED_STEPS
        alloc1 = torch.cuda.memory_stats()
        want = _expected_launches(counters, L, REMAT_FWD_PER_LAYER[policy], REMAT_TIMED_STEPS)
        check(n == want, f"{tag} {policy}: launches {n} of {REMAT_TIMED_STEPS} steps, want {want}")
        rec = out[policy]
        # the caching allocator's cudaMalloc and cudaFree calls over the timed steps
        # (a cudaFree waits for the card): where a step's idle time could go
        rec.update(step_ms=ms, max_memory_gib=torch.cuda.max_memory_allocated() / 2**30, step_launches=n,
                   allocator={k: alloc1.get(k, 0) - alloc0.get(k, 0)
                              for k in ("num_device_alloc", "num_device_free", "num_alloc_retries")})
        prof = profile_families(torch, lambda: step_fn(state, batch), 1)
        rec["profile"] = prof or "not measured: the profiler recorded no device activity"
        fam = (f"{({k: round(v, 1) for k, v in prof['device_ms_by_family'].items()})}, busy "
               f"{prof['device_ms']:.1f} ms of the profiled {prof['profiled_wall_ms']:.1f} ms" if prof
               else "not measured")
        print(f"[{tag}] {policy}: loss {rec['loss']:.6f} rel {rec['loss_rel']:.2e} (tol {loss_tol}); worst grad "
              f"leaf {rec['worst_leaf']} rel norm {rec['worst_grad_rel']:.2e} (tol {grad_tol}); same bits as "
              f"{policies[0]} {rec['same_bits']}; launches a forward and backward {rec['launches']}, which "
              f"add {rec['fwd_bwd_added_gib']:.2f} GiB to the state; {ms:.1f} ms/step (mean of "
              f"{REMAT_TIMED_STEPS}), peak memory {rec['max_memory_gib']:.1f} GiB, allocator calls "
              f"{rec['allocator']}; device ms a step by kernel family {fam}", flush=True)
    return out


def bench_line(name: str, rec: dict) -> str:
    return (f"[bench-{name}] bench.py's {name} recipe ({rec['params'] / 1e9:.3f} B params, MFU basis "
            f"{rec['mfu_params'] / 1e9:.3f} B), B={rec['batch']} T={rec['seq_len']}, remat {rec['remat']}, "
            f"ce_chunk {rec['ce_chunk']}: {rec['step_ms']:.1f} ms/step, {rec['tok_per_s']:.0f} tok/s, MFU "
            f"{rec['mfu']:.3f} ({rec['mfu_basis']}), peak memory {rec['max_memory_gib']:.1f} GiB, wall "
            f"{rec['wall_s']:.1f}s; launches {rec['launches']}, a step {rec['launches_per_step']}")


def bench_recipe_phase(torch, name: str, model, counters) -> dict:
    """bench.py's ``name`` preset through ``run_lm_training`` for
    ``BENCH_STEPS`` steps: ms/step and tok/s over the steady steps (all but
    the first), MFU on 6N + causal attention at T (N active for a MoE; for
    BERT 6N + bidirectional attention with the MLM head at the gathered
    batch's masked fraction, the loop's basis), peak memory and the kernel
    launches (counts set to 0 just before the call)."""
    from tony_tpu_torch.train.loop import LoopConfig, run_lm_training
    from tony_tpu_torch.train.metrics import transformer_flops_per_token

    _, fields, B, T = BENCH_RECIPES[name]
    cfg = model.config_from_dict(fields)
    loop = LoopConfig(steps=BENCH_STEPS, batch_size=B, seq_len=T, warmup_steps=10, schedule_steps=1000,
                      log_every=1)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for C in counters:
        C.reset_launches()
    t0 = time.perf_counter()
    res = run_lm_training(model, cfg, loop)
    wall = time.perf_counter() - t0
    launches = {k: v for C in counters for k, v in C.launches.items()}
    log, L = res["log"], cfg.n_layers
    check([x["step"] for x in log] == list(range(1, BENCH_STEPS + 1)) and all(
        math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"]) for x in log), f"bench {name}: {log}")
    check(abs(log[0]["loss"] - math.log(cfg.vocab_size)) <= 1.5,
          f"bench {name}: first loss {log[0]['loss']} not within 1.5 of ln(V) {math.log(cfg.vocab_size):.2f}")
    policy = getattr(cfg, "remat_policy", "full")  # BERT's remat is JAX's plain checkpoint: "full"
    want = _expected_launches(counters, L, REMAT_FWD_PER_LAYER[policy], BENCH_STEPS)
    check(launches == want, f"bench {name}: launches {launches}, want {want}")
    steady = sorted(x["step_time_ms"] for x in log[1:])
    ms = steady[len(steady) // 2]
    if hasattr(cfg, "remat_policy"):
        n_params = getattr(cfg, "active_params", cfg.num_params)()
        fpt, basis = transformer_flops_per_token(n_params, L, cfg.d_model, T), f"6N + attention at T={T}"
    else:
        n_params, masked = cfg.num_params(), max(1, round(T * 0.15))
        fpt = cfg.flops_per_token(masked / T)
        basis = f"6N + bidirectional attention at T={T}, the head at {masked} of {T} positions"
    rec = {"config": fields, "batch": B, "seq_len": T, "params": cfg.num_params(), "mfu_params": n_params,
           "remat": policy, "ce_chunk": getattr(cfg, "ce_chunk", None), "log": log, "launches": launches,
           "launches_per_step": {k: v // BENCH_STEPS for k, v in launches.items()},
           "step_ms": ms, "tok_per_s": B * T / ms * 1e3, "mfu": B * T / ms * 1e3 * fpt / BF16_FLOPS,
           "mfu_basis": basis, "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "wall_s": wall}
    for x in log:
        print(f"[bench-{name}] step {x['step']} loss {x['loss']} grad_norm {x['grad_norm']} "
              f"{x['step_time_ms']} ms", flush=True)
    print(bench_line(name, rec), flush=True)
    return rec


def async_save_phase(torch, llama, out_dir: Path) -> dict:
    """The same ``ASYNC_STEPS`` train steps at the gang's shape, saved after
    the steps of ``ASYNC_SAVE_AT``, once with ``use_async=False`` and once
    with ``use_async=True``: each save's dispatch and write seconds (the
    first async dispatch allocates the pinned buffers), the median step
    during the first write against the median steady step, the wall of each run
    (its last write included), and that the two runs' steps restore the
    same bytes, and the async step the state as it was at its save."""
    from tony_tpu_torch.train.checkpoint import CheckpointManager
    from tony_tpu_torch.train.trainer import OptimizerConfig, TrainState, make_train_step

    cfg = dataclasses.replace(llama.config_from_dict("llama-1b"), n_layers=GANG_LAYERS)
    opt = OptimizerConfig(learning_rate=3e-4, warmup_steps=2, total_steps=ASYNC_STEPS).build()
    work = out_dir / "async_save"
    shutil.rmtree(work, ignore_errors=True)
    out, ref = {}, None
    for mode in ("sync", "async"):
        gc.collect()
        torch.cuda.empty_cache()
        state = TrainState.create(llama.init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda"), opt)
        step_fn = make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt)
        mgr = CheckpointManager(str(work / mode), use_async=mode == "async")
        writes, saves, steps = {}, {}, []
        real_write = mgr._write

        def timed_write(step, snapshot, real_write=real_write, writes=writes):
            t0 = time.perf_counter()
            real_write(step, snapshot)
            writes[step] = (t0, time.perf_counter())

        mgr._write = timed_write
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        for step in range(1, ASYNC_STEPS + 1):
            batch = llama.synthetic_batch(torch.Generator(device="cuda").manual_seed(100 + step), GANG_B,
                                          GANG_T, cfg)
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            float(m["loss"])
            steps.append((t0, time.perf_counter()))
            if step in ASYNC_SAVE_AT:
                if mode == "async" and step == ASYNC_SAVE_AT[0]:
                    ref = {k: v.detach().clone() for k, v in _leaves(state.state_dict()) if torch.is_tensor(v)}
                t0 = time.perf_counter()
                mgr.save(step, state.state_dict())
                saves[step] = (t0, time.perf_counter())
        mgr.close()
        wall = time.perf_counter() - t_run
        first_end = writes[ASYNC_SAVE_AT[0]][1]
        after = [i for i, (a, _) in enumerate(steps) if a >= saves[ASYNC_SAVE_AT[0]][1]]
        during = [i for i in after if steps[i][0] < first_end]
        steady = [i for i in range(1, ASYNC_STEPS) if i not in during]

        def ms(ids):  # the median step of ``ids``, 0 for none
            return 1e3 * sorted(steps[i][1] - steps[i][0] for i in ids)[len(ids) // 2] if ids else 0.0

        rec = {"dispatch_s": {s: b - a for s, (a, b) in saves.items()},
               "write_s": {s: b - a for s, (a, b) in writes.items()}, "wall_s": wall,
               "steps_during_write": len(during), "during_write_ms": ms(during), "steady_ms": ms(steady),
               "step_ms": [1e3 * (b - a) for a, b in steps]}
        out[mode] = rec
        print(f"[async-save] {mode}: llama-1b cut to {GANG_LAYERS} layers B={GANG_B} T={GANG_T}, {ASYNC_STEPS} "
              f"steps, saves after steps "
              f"{list(ASYNC_SAVE_AT)}: dispatch s {({k: round(v, 3) for k, v in rec['dispatch_s'].items()})}, "
              f"write s {({k: round(v, 3) for k, v in rec['write_s'].items()})}; {len(during)} steps during "
              f"the first write at {rec['during_write_ms']:.1f} ms against {rec['steady_ms']:.1f} ms steady (medians); "
              f"wall {wall:.1f} s", flush=True)
        del state, step_fn
    same = True
    for step in ASYNC_SAVE_AT:
        a, b = ({k: v for k, v in _leaves(torch.load(work / mode / str(step) / "state.pt", map_location="cpu",
                                                           weights_only=True, mmap=True))}
                for mode in ("sync", "async"))
        same &= a.keys() == b.keys() and all(
            torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k] for k in a)
        if step == ASYNC_SAVE_AT[0]:
            check(all(torch.equal(b[k].to("cuda"), v) for k, v in ref.items()),
                  f"async save: step {step} restores other bytes than the state at its save")
        del a, b
    del ref
    shutil.rmtree(work, ignore_errors=True)
    check(same, "async save: the sync and async runs restore different bytes")
    out["same_bytes"] = same
    print(f"[async-save] both runs restore the same bytes at steps {list(ASYNC_SAVE_AT)}: {same}; the async "
          f"step {ASYNC_SAVE_AT[0]} is the state at its save; wall sync {out['sync']['wall_s']:.1f} s, async "
          f"{out['async']['wall_s']:.1f} s", flush=True)
    return out


# -- context-parallel ring attention (B9, B10) ------------------------------------

def _tony(args: list[str], env: dict, timeout: float = 60) -> subprocess.CompletedProcess:
    """``python -m tony_tpu.cli.main <args>`` (the orchestrator, run and never
    imported here)."""
    return subprocess.run([sys.executable, "-m", "tony_tpu.cli.main", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _step_lines(text: str) -> dict:
    """step -> the step report of a worker's stdout."""
    out = {}
    for line in text.splitlines():
        if line.startswith("{") and '"loss"' in line:
            rec = json.loads(line)
            out[rec["step"]] = rec
    return out


def _published_steps(text: str) -> list[int]:
    """The steps a worker's stdout shows published by its checkpoint writer."""
    return [int(m) for m in re.findall(r"^\[ckpt\] step (\d+) published$", text, re.M)]


def _histogram(snap: list, name: str):
    """(count, sum) of a histogram in a metrics snapshot, or None."""
    for m in snap:
        if m["name"] == name and m["samples"]:
            return (sum(s["count"] for s in m["samples"]), sum(s["sum"] for s in m["samples"]))
    return None


def nccl_one_rank_check(torch) -> dict:
    """``all_reduce_mean`` over a one-rank nccl group on the card: nccl's AVG,
    the f32 buckets (one tensor past a bucket's size) and the copy back. More
    than one rank needs more than one card and is not run here."""
    import socket

    import torch.distributed as dist
    from tony_tpu_torch.parallel.collectives import BUCKET_NUMEL, all_reduce_mean

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        gen = torch.Generator(device="cuda").manual_seed(3)
        ts = [torch.randn(n, generator=gen, device="cuda").to(dt) for n, dt in
              ((BUCKET_NUMEL + 5, torch.bfloat16), (4096 * 1024, torch.bfloat16), (333, torch.float32))]
        want = [t.clone() for t in ts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce_mean(ts, dist.group.WORLD)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(all(torch.equal(a, b) for a, b in zip(ts, want)), "gang: one-rank nccl mean changed a value")
    finally:
        dist.destroy_process_group()
    print(f"[gang] nccl one-rank all_reduce_mean over {sum(t.numel() for t in ts)} elements: {ms:.2f} ms "
          "(same values; more than one rank is not run on one card)", flush=True)
    return {"elements": sum(t.numel() for t in ts), "ms": ms}


def gang_phase(torch, llama, A, out_dir: Path) -> dict:
    """The training gang at ``llama-1b`` cut to ``GANG_LAYERS`` of its 16
    layers (d_model 2048, bf16, remat "full", B=8, T=2048) on ``*.tonytok``
    shards written here from a seed:

    1. ``tony submit`` (framework pytorch, one worker) of ``python -m
       tony_tpu_torch.train.pretrain --data_dir ...`` for ``GANG_STEPS`` steps
       with an asynchronous checkpoint every ``GANG_CKPT_EVERY`` and
       ``node-loss:worker:0@step+GANG_LOSS_AT``:
       the job must succeed after one gang restart that resumes at the
       newest step attempt 0's log shows published (at least the first save) with a
       validated cursor, and the global slots of the steps each attempt
       trained must cover ``[0, GANG_STEPS*8)`` once; ``tony top`` reads the live
       worker (which waits for a stop file after training) and ``tony
       goodput`` the finished job; the time to recover runs from the node
       loss to the first step of the restart;
    2. ``run_lm_training`` in this process on the same shards, the same steps: B1-B3
       launched (counts set to 0 just before), and each step's loss that of
       the gang's worker within ``GANG_LOSS_REL``;
    3. in this process, 5 steps with the static ``StepProfiler`` window
       (steps 1-2) and a drain request dropped once step 2 is reported: a
       forced checkpoint at a later step, a ``.drain.done`` naming it, and a
       non-empty ``torch.profiler`` trace with CUDA kernels;
    4. ``all_reduce_mean`` over a one-rank nccl group."""
    import numpy as np

    from tony_tpu_torch.data.dataset import ConsumptionCursor, global_slots, write_token_shard
    from tony_tpu_torch.obs import metrics as obs_metrics
    from tony_tpu_torch.train.loop import LoopConfig, run_lm_training

    cfg = dataclasses.replace(llama.config_from_dict("llama-1b"), n_layers=GANG_LAYERS)
    work = out_dir / "gang"
    shutil.rmtree(work, ignore_errors=True)
    data, ck, stop, root = work / "data", work / "ckpt", work / "stop", work / "tony"
    data.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(GANG_SHARDS):  # 4 x 2^18 tokens: 511 windows of 2049, more than the 64 drawn
        write_token_shard(data / f"shard-{i:02d}.tonytok", rng.integers(0, cfg.vocab_size, 1 << 18))
    run = ["--preset", "llama-1b", "--n_layers", str(GANG_LAYERS), "--data_dir", str(data),
           "--steps", str(GANG_STEPS),
           "--batch_size", str(GANG_B), "--seq_len", str(GANG_T), "--log_every", "1",
           "--warmup_steps", "2"]
    cmd = (f"cd {ROOT} && PYTHONPATH={ROOT} {sys.executable} -m tony_tpu_torch.train.pretrain "
           f"{' '.join(run)} && for i in $(seq 1200); do [ -e {stop} ] && break; sleep 0.1; done")
    env = dict(os.environ, TONY_ROOT=str(root), PYTHONPATH=str(ROOT))
    conf = {"tony.worker.instances": "1", "tony.application.framework": "pytorch",
            "tony.task.restart-on-failure": "true", "tony.chaos.spec": f"node-loss:worker:0@step+{GANG_LOSS_AT}",
            "tony.checkpoint.dir": str(ck), "tony.checkpoint.interval-steps": str(GANG_CKPT_EVERY),
            "tony.task.metrics-interval-ms": "200", "tony.am.monitor-interval-ms": "50",
            "tony.am.gang-timeout-ms": "300000",
            "tony.trace.enabled": "true"}
    argv = [sys.executable, "-m", "tony_tpu.cli.main", "submit", "--executes", cmd]
    for k, v in conf.items():
        argv += ["--conf", f"{k}={v}"]
    submit_log = work / "submit.log"
    t0 = time.perf_counter()
    with open(submit_log, "w") as logf:
        sub = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT)
    top_frame, app = "", None
    try:
        deadline = time.time() + 600
        while time.time() < deadline and sub.poll() is None:
            time.sleep(1.0)
            apps = sorted(p.name for p in root.glob("application_*")) if root.is_dir() else []
            if not apps:
                continue
            app = apps[0]
            frame = _tony(["top", app, "--staging", str(root), "--once"], env).stdout
            m = re.search(rf"worker:0\s+RUNNING\s+{GANG_STEPS}\s+\S+\s+\S+\s+(\d+\.\d+)", frame)
            if m and float(m.group(1)) > 0:
                top_frame = frame
                break
    finally:
        stop.touch()  # the worker's wait ends and the job finishes
        try:
            sub.wait(timeout=300)
        except subprocess.TimeoutExpired:
            sub.kill()
            subprocess.run(["pkill", "-f", "tony_tpu.cluster"], check=False)  # the job's AM and executor
            sub.wait()
    wall = time.perf_counter() - t0
    out = submit_log.read_text()
    check(sub.returncode == 0, f"gang: tony submit exited {sub.returncode}:\n{out[-4000:]}")
    check(bool(top_frame), "gang: tony top never showed the worker at the last step with a step rate")
    staging = root / app
    logs = staging / "logs"
    first = (logs / "worker_0" / "stdout.log").read_text()
    resumed = (logs / "worker_0_r1" / "stdout.log").read_text()
    check(not (logs / "worker_0_r2").exists(), "gang: more than one restart")
    # the restart resumes at the newest step attempt 0 published before the
    # node loss killed it (a write still in flight then is lost)
    published = _published_steps(first)
    at = max(published, default=0)
    check(at >= GANG_CKPT_EVERY, f"gang: attempt 0 published steps {published}; the save at step "
          f"{2 * GANG_CKPT_EVERY} joins step {GANG_CKPT_EVERY}'s write before step {GANG_LOSS_AT}")
    check(f"resumed from checkpoint step {at}" in resumed,
          f"gang: the restart did not resume at step {at}, the newest published:\n{resumed[-3000:]}")
    check(f"data cursor validated: resuming the global stream at batch {at}" in resumed,
          f"gang: no validated cursor on resume:\n{resumed[-3000:]}")
    a0, a1 = _step_lines(first), _step_lines(resumed)
    check(set(range(1, at + 1)) <= set(a0), f"gang: attempt 0 steps {sorted(a0)}")
    check(sorted(a1) == list(range(at + 1, GANG_STEPS + 1)), f"gang: attempt 1 steps {sorted(a1)}")
    trained = list(range(at)) + list(range(at, GANG_STEPS))
    slots = sorted(s for t in trained for s in global_slots(t, GANG_B, 0, 1))
    check(slots == list(range(GANG_STEPS * GANG_B)),
          f"gang: the consumed global slots are not [0, {GANG_STEPS * GANG_B}) once each")
    check(ConsumptionCursor.load(ck, at) == ConsumptionCursor(at, GANG_B, 0, 1), f"gang: cursor of step {at}")
    gang_log = {**{k: v for k, v in a0.items() if k <= at}, **a1}

    # time to recover: the node loss (the AM's injection record) to the first
    # step report of the restart (the worker's JSON log record, epoch 1)
    loss_ts = [json.loads(x)["ts_ms"] for p in (staging / "chaos").glob("injections-*.jsonl")
               for x in p.read_text().splitlines() if json.loads(x)["kind"] == "node-loss"]
    recs = [json.loads(x) for x in (logs / "worker_0_train.log.jsonl").read_text().splitlines()]
    back = [r["ts_ms"] for r in recs if r.get("epoch") == 1 and "loss" in r]
    check(len(loss_ts) == 1 and back, f"gang: node-loss records {loss_ts}, restart steps {len(back)}")
    recover_s = (min(back) - loss_ts[0]) / 1e3
    obs = json.loads((staging / "metrics" / "worker_0.json.obs").read_text())
    restore = _histogram(obs, "tony_checkpoint_restore_seconds")
    save = _histogram(obs, "tony_checkpoint_save_seconds")
    write = _histogram(obs, "tony_checkpoint_write_seconds")
    peak = next((s["value"] for m in obs if m["name"] == "tony_device_memory_bytes"
                 for s in m["samples"] if s["labels"]["stat"] == "peak"), 0.0)
    check(restore is not None and save is not None and write is not None and peak > 0,
          f"gang: worker .obs lacks instruments: "
          f"{[m['name'] for m in obs]}")
    ckpt_bytes = (ck / str(GANG_STEPS) / "state.pt").stat().st_size
    good = _tony(["goodput", app, "--staging", str(root), "--json"], env)
    check(good.returncode == 0, f"gang: tony goodput: {good.stderr[-2000:]}")
    ledger = json.loads(good.stdout)
    check(ledger["restarts"] == 1 and ledger["phases_ms"].get("checkpoint", 0) > 0,
          f"gang: goodput ledger {ledger['phases_ms']}, restarts {ledger['restarts']}")

    # 2. the same 8 steps in this process, through B1-B3
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loop = dict(batch_size=GANG_B, seq_len=GANG_T, log_every=1, warmup_steps=2, data_dir=str(data))
    A.reset_launches()
    res = run_lm_training(llama, cfg, LoopConfig(steps=GANG_STEPS, **loop))
    launches = dict(A.launches)
    peak_inproc = torch.cuda.max_memory_allocated()
    check(all(launches.values()), f"gang: a flash kernel was never launched: {launches}")
    here = {x["step"]: x for x in res["log"]}
    check(sorted(here) == sorted(gang_log), f"gang: steps {sorted(here)} vs {sorted(gang_log)}")
    worst = max(abs(gang_log[s]["loss"] - here[s]["loss"]) / abs(here[s]["loss"]) for s in here)
    same_bits = all(gang_log[s]["loss"] == here[s]["loss"] for s in here)
    for s in sorted(here):
        print(f"[gang] step {s} loss gang {gang_log[s]['loss']} in-process {here[s]['loss']} "
              f"grad_norm {here[s]['grad_norm']}", flush=True)
    check(worst <= GANG_LOSS_REL, f"gang: worker losses differ from the in-process run by {worst:.2e}")

    # 3. urgent save and the static profiler window, in this process
    metrics_file, prof_dir, ck2 = work / "m" / "worker_0.json", work / "profile", work / "ckpt_drain"
    metrics_file.parent.mkdir(parents=True)
    saves0 = _histogram(obs_metrics.REGISTRY.snapshot(), "tony_checkpoint_save_seconds") or (0, 0.0)
    done_event = threading.Event()

    def drop_drain():
        while not done_event.is_set():
            try:
                if json.loads(metrics_file.read_text())["step"] >= 2:
                    (metrics_file.parent / (metrics_file.name + ".drain")).write_text('{"req_id": "chip-drain"}')
                    return
            except (OSError, ValueError, KeyError):
                pass
            time.sleep(0.02)

    watcher = threading.Thread(target=drop_drain, daemon=True)
    watcher.start()
    env3 = {"TONY_TRAIN_METRICS_FILE": str(metrics_file), "TONY_PROFILE_POLL_MS": "50",
            "TONY_PROFILE_DIR": str(prof_dir), "TONY_PROFILE_START_STEP": "1", "TONY_PROFILE_NUM_STEPS": "2"}
    try:
        with mock.patch.dict(os.environ, env3):
            run_lm_training(llama, cfg, LoopConfig(steps=5, checkpoint_dir=str(ck2), **loop))
    finally:
        done_event.set()
        watcher.join(timeout=5)
    done = json.loads((metrics_file.parent / (metrics_file.name + ".drain.done")).read_text())
    steps_on_disk = sorted(int(p.name) for p in ck2.iterdir() if p.name.isdigit())
    # the request is written once step 2's report is out; the loop polls for
    # it after that report, so the save lands at step 2 when the watcher wins
    # that race or at a later step
    check(done["req_id"] == "chip-drain" and 2 <= done["step"] < 5 and steps_on_disk == [done["step"], 5],
          f"gang: drain answered {done}, checkpoints {steps_on_disk}")
    saves1 = _histogram(obs_metrics.REGISTRY.snapshot(), "tony_checkpoint_save_seconds")
    traces = list(prof_dir.glob("*.pt.trace.json"))
    check(len(traces) == 1 and traces[0].stat().st_size > 0, f"gang: profiler traces {traces}")
    text = traces[0].read_text()
    check('"cat": "kernel"' in text, "gang: the profiler trace holds no CUDA kernel")
    nccl = nccl_one_rank_check(torch)
    shutil.rmtree(work, ignore_errors=True)

    tokens = GANG_B * GANG_T

    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    def speed(log: dict) -> dict:  # steady state: every step but the first of each attempt
        steady = [log[s] for s in log if s not in (1, at + 1)]
        ms = med([x["step_time_ms"] for x in steady])
        return {"step_ms": ms, "tok_per_s": tokens / ms * 1e3, "mfu": med([x["mfu"] for x in steady])}

    rec = {
        "preset": "llama-1b", "layers": GANG_LAYERS, "params": cfg.num_params(), "batch": GANG_B, "seq_len": GANG_T,
        "launches": launches, "submit_wall_s": wall, "resumed_at": at, "published_attempt0": published,
        "gang": speed(gang_log), "in_process": speed(here), "loss_worst_rel": worst, "same_bits": same_bits,
        "peak_gib_worker": peak / 2**30, "peak_gib_in_process": peak_inproc / 2**30,
        "ckpt_bytes": ckpt_bytes, "worker_save_s": save[1] / save[0], "worker_write_s": write[1] / write[0],
        "worker_saves": save[0], "worker_restore_s": restore[1] / restore[0],
        "drain_save_s": (saves1[1] - saves0[1]) / (saves1[0] - saves0[0]), "drain_step": done["step"],
        "time_to_recover_s": recover_s, "goodput_phases_ms": ledger["phases_ms"],
        "goodput_fraction": ledger["goodput_fraction"], "nccl_one_rank": nccl,
        "obs_instruments": sorted(m["name"] for m in obs), "top_frame": top_frame,
    }
    print(f"[gang] tony top while the worker waits:\n{top_frame}", flush=True)
    print(f"[gang] worker .obs instruments: {rec['obs_instruments']}", flush=True)
    print(f"[gang] tony goodput: restarts 1, goodput {ledger['goodput_fraction']:.3f}, phases ms "
          f"{ledger['phases_ms']}", flush=True)
    print(f"[gang] llama-1b cut to {GANG_LAYERS} layers B={GANG_B} T={GANG_T}: gang "
          f"{rec['gang']['step_ms']:.1f} ms/step "
          f"{rec['gang']['tok_per_s']:.0f} tok/s MFU {rec['gang']['mfu']:.3f}; in-process "
          f"{rec['in_process']['step_ms']:.1f} ms/step {rec['in_process']['tok_per_s']:.0f} tok/s MFU "
          f"{rec['in_process']['mfu']:.3f}; losses same bits {same_bits} (worst rel {worst:.2e}); "
          f"peak memory worker {rec['peak_gib_worker']:.1f} GiB, in-process {rec['peak_gib_in_process']:.1f} GiB; "
          f"launches {launches}", flush=True)
    print(f"[gang] checkpoint {ckpt_bytes / 1e9:.2f} GB: save dispatch {rec['worker_save_s']:.2f} s, "
          f"write {rec['worker_write_s']:.2f} s (worker's last attempt, mean of {save[0]}); save dispatch "
          f"{rec['drain_save_s']:.2f} s (in-process, mean of the drain's and the final); restore "
          f"{rec['worker_restore_s']:.2f} s (worker); goodput checkpoint "
          f"{ledger['phases_ms'].get('checkpoint', 0) / 1e3:.1f} s; attempt 0 published steps {published}, "
          f"resumed at {at}; time to recover {recover_s:.1f} s (node loss to the restart's first step); "
          f"urgent save at step {done['step']}; tony submit wall {wall:.1f} s", flush=True)
    return rec


def ring_inputs(torch, A, c):
    """q, k, v, do at Llama-3-8B widths over the whole T=16384 (the case's
    ``T`` and heads where it names them), three packed segments with
    boundaries off the shard edges, the visible (query, key) pairs of the
    case."""
    g = torch.Generator(device="cuda").manual_seed(4)
    T, h, hkv = c.get("T", RING_T), c.get("H", H), c.get("Hkv", HKV)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    q, k, v, do = rnd(1, h, T, DH), rnd(1, hkv, T, DH), rnd(1, hkv, T, DH), rnd(1, h, T, DH)
    seg = None
    if c["n_seg"] > 1:
        cuts = torch.tensor([int(0.31 * T) + 5, int(0.68 * T) + 11], device="cuda")
        seg = torch.searchsorted(cuts, torch.arange(T, device="cuda"), right=True)[None].to(torch.int32)
    visible = A._visible(T, T, True, c["window"], None if seg is None else seg[0], "cuda")
    return q, k, v, do, seg, visible


@contextlib.contextmanager
def plain_ring_steps(TR):
    """The ring with the plain step versions in place of the kernels."""
    with contextlib.ExitStack() as stack:
        for name in ("ring_fwd_step", "ring_bwd_dq_step", "ring_bwd_dkv_step"):
            stack.enter_context(mock.patch.object(TR, name, getattr(TR, name + "_plain")))
        yield


def skipped_ring_step(TR, my: int = 3, src: int = 2, n: int = RING_N, T: int = RING_T):
    """B9 with a planted fault: shard ``my`` of a ring of ``n`` over ``T``
    never folds in the KV shard ``src`` (a past step of the ring: its state
    passes through unchanged)."""
    real = TR.ring_fwd_step
    Tl = T // n

    def step(*a, **kw):
        if kw["q_pos0"] == my * Tl and kw["k_pos0"] == src * Tl:
            return None
        return real(*a, **kw)

    return step


def kept_home_dkv(TR):
    """B10 with a planted fault: shard 0 skips the final rotation and keeps
    the dk/dv accumulators it holds (its right neighbour's)."""
    real = TR._deliver_home

    def deliver(ring, dk_acc, dv_acc):
        dk, dv = real(ring, dk_acc, dv_acc)
        dk[0], dv[0] = dk_acc[0], dv_acc[0]
        return dk, dv

    return deliver


def ring_cost(pairs: int, seg, c: dict | None = None) -> dict:
    """(operations, bytes, the launches' own operations) of one ring pass on
    this run's data (the case ``c``'s length and heads, Llama-3-8B's T=16384
    by default), as ``flash_cost``. B9 as B1. B10 as the TPU kernel's one
    pass of five products a visible pair (q.k, do.v, p.do, ds.q, ds.k: 10 H
    DH), reading q, k, v, do, lse, delta once and writing dq, dk, dv once;
    the port's dq and dk/dv step kernels each recompute q.k and do.v (14 H
    DH), work of the split and not of the function."""
    c = c or {}
    T, h, hkv = c.get("T", RING_T), c.get("H", H), c.get("Hkv", HKV)
    qb, kvb, row = h * T * DH * 2, hkv * T * DH * 2, h * T * 4
    segb = T * 4 if seg is not None else 0
    return {"ring_fwd": (4 * h * DH * pairs, 2 * qb + 2 * kvb + row + segb, 4 * h * DH * pairs),
            "ring_bwd": (10 * h * DH * pairs, 3 * qb + 4 * kvb + 2 * row + segb, 14 * h * DH * pairs)}


def ring_kernel_phase(torch, A, TR, flush) -> dict:
    """B9 and B10 at Llama-3-8B widths, B=1, T=16384 over a DeviceRing of 4
    on the card (Tl 4096), in bf16: the whole ring pass (steps, side-stream
    rotations, the final rotation) through the kernels against the same pass
    through the plain steps, o and lse forward, dq, dk and dv backward (the
    backward of both from the plain forward's o and lse), row by row; two
    planted faults must fail the same limits. Times of the passes, of one
    diagonal and one past step of each kernel, and of SDPA over the whole
    sequence on head-expanded KV (forward; backward alone)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from tony_tpu_torch.parallel.collectives import DeviceRing

    build = attention_build_report("ring_attention")
    recs = {"ring_fwd": [], "ring_bwd": []}
    for name, c in RING_CASES.items():
        n, T = c.get("n", RING_N), c.get("T", RING_T)
        ring = DeviceRing(n, "cuda")
        Tl = T // n
        q, k, v, do, seg, visible = ring_inputs(torch, A, c)
        segq, segk = TR._segments(ring, seg)
        w = c["window"]
        fwd = lambda: TR._ring_fwd(q, k, v, ring, True, w, segq, segk)  # noqa: E731
        o, lse = fwd()
        with plain_ring_steps(TR):
            o_p, lse_p = fwd()
        bwd = lambda: TR._ring_bwd(q, k, v, o_p, lse_p, do, ring, True, w, segq, segk)  # noqa: E731
        grads = bwd()
        with plain_ring_steps(TR):
            grads_p = bwd()
        with mock.patch.object(TR, "ring_fwd_step", skipped_ring_step(TR, n - 1, n - 2, n, T)):
            o_f = fwd()[0]
        with mock.patch.object(TR, "_deliver_home", kept_home_dkv(TR)):
            grads_f = bwd()
        torch.cuda.synchronize()
        lse_err = (lse - lse_p).abs().max().item()
        outs = {"ring_fwd": [(o, o_p, o_f)], "ring_bwd": list(zip(grads, grads_p, grads_f))}
        errs = {}
        for kname, triples in outs.items():
            for got, _, _ in triples:
                check(bool(torch.isfinite(got.float()).all()), f"{kname} {name}: non-finite output")
            err = max(row_rel_err(got, want) for got, want, _ in triples)
            fault = max(row_rel_err(bad, want) for _, want, bad in triples)
            abs_err = max((got.float() - want.float()).abs().max().item() for got, want, _ in triples)
            errs[kname] = (err, fault, abs_err)
            print(f"[ring] {kname} {name:9s} n={n} row err {err:.3e} (tol {FLASH_ROW_TOL}; planted fault "
                  f"{fault:.3e}), max_abs_err {abs_err:.3e}"
                  + (f"; lse err {lse_err:.2e} (tol {LSE_ATOL})" if kname == "ring_fwd" else ""), flush=True)
        check(lse_err <= LSE_ATOL, f"ring_fwd {name}: lse error {lse_err} > {LSE_ATOL}")
        for kname, (err, fault, _) in errs.items():
            check(err <= FLASH_ROW_TOL, f"{kname} {name}: row error {err} > {FLASH_ROW_TOL}")
            # (a NaN fails the limit too: on a ring of 2 the skipped step is
            # the last, which writes o and lse)
            check(not fault <= FLASH_ROW_TOL, f"{kname} {name}: the check passes a planted fault ({fault})")
        if name == "causal":
            # no atomics: a second pass gives the same bits
            o2, lse2 = fwd()
            grads2 = bwd()
            torch.cuda.synchronize()
            same = (torch.equal(o, o2) and torch.equal(lse, lse2)
                    and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
            print(f"[ring] causal: a second pass gives the same bits: {same}", flush=True)
            check(same, "ring causal: two passes of the kernels differ in their bits")
            del o2, lse2, grads2
        del o, lse, grads, grads_f, o_f, outs
        if c.get("check_only"):
            recs["checks"] = recs.get("checks", []) + [
                {"case": name, "n": n, "tl": Tl, "kernel": k_, "row_err": e[0], "max_abs_err": e[2], "lse_err": lse_err,
                 # the kernels line is strict JSON: a non-finite fault reading is named, not printed
                 "fault_row_err": e[1] if math.isfinite(e[1]) else None, "fault_finite": math.isfinite(e[1])}
                for k_, e in errs.items()]
            del q, k, v, do, seg, visible, o_p, lse_p, grads_p, fwd, bwd, segq, segk
            torch.cuda.empty_cache()
            continue
        # one diagonal step (shard 1 on its own KV) and one past step (shard
        # n-1 on shard n-2's KV: every pair visible under the causal mask)
        f32 = dict(dtype=torch.float32, device="cuda")
        delta = (do.float() * o_p.float()).sum(-1)
        step_ms = {}
        for sname, my, src in (("diagonal", 1, 1), ("past", n - 1, n - 2)):
            sl = slice(my * Tl, (my + 1) * Tl)
            qs, dos, os_ = (t[:, :, sl].contiguous() for t in (q, do, o_p))
            ks, vs = (t[:, :, src * Tl:(src + 1) * Tl].contiguous() for t in (k, v))
            rows = (lse_p[:, :, sl].contiguous(), delta[:, :, sl].contiguous())
            acc, m, l = torch.zeros(qs.shape, **f32), torch.zeros(qs.shape[:3], **f32), torch.zeros(qs.shape[:3], **f32)
            lse_s = torch.zeros(qs.shape[:3], **f32)
            dq, dk, dv = torch.zeros(qs.shape, **f32), torch.zeros(ks.shape, **f32), torch.zeros(ks.shape, **f32)
            kw = dict(q_pos0=my * Tl, k_pos0=src * Tl, causal=True, window=w,
                      segq=None if segq is None else segq[:, sl].contiguous(), segk=segk)
            step_ms[sname] = {
                "ring_fwd": time_ms(torch, lambda: TR.ring_fwd_step(qs, ks, vs, acc, m, l, os_, lse_s,
                                                                    first=my == src, **kw), flush),
                "ring_bwd_dq": time_ms(torch, lambda: TR.ring_bwd_dq_step(qs, ks, vs, dos, *rows, dq, **kw), flush),
                "ring_bwd_dkv": time_ms(torch, lambda: TR.ring_bwd_dkv_step(qs, ks, vs, dos, *rows, dk, dv, **kw),
                                        flush),
            }
        del acc, m, l, lse_s, dq, dk, dv
        # the library yardstick: SDPA over the whole sequence on head-expanded
        # K/V (a boolean mask for segments and the window), never the MATH
        # backend's T x T scores
        rep = q.shape[1] // k.shape[1]
        kk = k.repeat_interleave(rep, 1).requires_grad_(True)
        vv = v.repeat_interleave(rep, 1).requires_grad_(True)
        qq = q.detach().clone().requires_grad_(True)
        mask = visible[None, None] if seg is not None or w else None
        backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]

        def sdpa():
            with sdpa_kernel(backends):
                return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask, is_causal=mask is None)

        with torch.no_grad():
            lib_err = (sdpa().float() - o_p.float()).abs().max().item()
            lib_fwd = time_ms(torch, sdpa, flush, iters=10)
        lib_o = sdpa()
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(lib_o, (qq, kk, vv), do, retain_graph=True),
                          flush, iters=10)
        del lib_o, qq, kk, vv, mask
        torch.cuda.empty_cache()
        pairs = int(visible.sum().item())
        cost = ring_cost(pairs, seg, c)
        passes = {"ring_fwd": (fwd, lib_fwd, "sdpa forward over the whole sequence"),
                  "ring_bwd": (bwd, lib_bwd, "sdpa backward alone over the whole sequence")}
        for kname, (run, lib_ms, lib_call) in passes.items():
            err, fault, abs_err = errs[kname]
            flops, nbytes, kernel_flops = cost[kname]
            rec = {"case": name, "max_abs_err": abs_err, "row_err": err, "tol": FLASH_ROW_TOL,
                   # the kernels line is strict JSON: a non-finite fault reading is named, not printed
                   "fault_row_err": fault if math.isfinite(fault) else None, "fault_finite": math.isfinite(fault),
                   "pairs": pairs, "flops": flops, "bytes": nbytes,
                   "kernel_flops": kernel_flops,
                   "ms": time_ms(torch, run, flush, iters=10),
                   "step_ms": {s: {x: t for x, t in d.items() if x.startswith(kname)} for s, d in step_ms.items()},
                   "library_ms": lib_ms, "library_call": lib_call,
                   "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
                   "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations"}
            with plain_ring_steps(TR):
                rec["plain_ms"] = time_ms(torch, run, flush, iters=2, warmup=1)
            rec["tflops"] = flops / rec["ms"] / 1e9
            rec["kernel_tflops"] = kernel_flops / rec["ms"] / 1e9
            if kname == "ring_fwd":
                rec["library_max_abs_err"] = lib_err
            print(f"[ring] {kname} {name:8s} pass ms {rec['ms']:.3f} (steps: {rec['step_ms']}) plain "
                  f"{rec['plain_ms']:.3f} {lib_call} {lib_ms:.3f} bound {rec['bound_ms']:.3f} "
                  f"({rec['bound_by']}); {rec['tflops']:.1f} TFLOP/s of the function, "
                  f"{rec['kernel_tflops']:.1f} of the launches' own work", flush=True)
            recs[kname].append(rec)
        del q, k, v, do, seg, visible, o_p, lse_p, grads_p, delta, segq, segk, fwd, bwd, passes
        torch.cuda.empty_cache()
    checks = recs.pop("checks", [])
    return {kname: dict(rs[0], cases=rs, build=build, checks=[x for x in checks if x["kernel"] == kname])
            for kname, rs in recs.items()}


def cp_whole_step_check(torch, llama, A, TR) -> dict:
    """One ``loss_fn`` value and gradient with ``cp_impl="pallas"`` over a
    context of 4 (the B9/B10 ring on a DeviceRing on the card) against the
    single-device flash path (B1-B3, no mesh) on the same params and batch:
    8B width, 2 layers, B=1, T=16384, remat "full". The two planted ring
    faults must fail the gradient limit that the sound kernels pass."""
    from tony_tpu_torch.parallel.mesh import MeshSpec

    cfg = llama.config_from_dict({"preset": "llama3-8b", "n_layers": 2, "cp_impl": "pallas"})
    params = llama.init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    names, tensors = zip(*_leaves(params))
    for t in tensors:
        t.requires_grad_(True)
    batch = llama.synthetic_batch(torch.Generator(device="cuda").manual_seed(1), 1, RING_T, cfg)
    mesh = MeshSpec(context=RING_N).build("cuda")

    def run(m):
        A.reset_launches()
        TR.reset_launches()
        loss, _ = llama.loss_fn(params, batch, cfg, m)
        return loss.item(), torch.autograd.grad(loss, tensors), {**A.launches, **TR.launches}

    lr, gr, nr = run(None)
    check(all(nr[x] for x in A.launches) and not any(nr[x] for x in TR.launches),
          f"cp whole step: the flash path launched {nr}")
    out = {"loss_flash": lr}
    variants = {"kernels": None, "fault_b9_step": ("ring_fwd_step", skipped_ring_step(TR)),
                "fault_b10_home": ("_deliver_home", kept_home_dkv(TR))}
    for variant, patch in variants.items():
        with mock.patch.object(TR, *patch) if patch else contextlib.nullcontext():
            lk, gk, nk = run(mesh)
        grad_rel = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
                    for n, a, b in zip(names, gk, gr)}
        del gk
        worst = max(grad_rel, key=grad_rel.get)
        rec = {"loss": lk, "loss_rel": abs(lk - lr) / abs(lr), "worst_leaf": worst,
               "worst_grad_rel": grad_rel[worst], "grad_rel": grad_rel, "launches": nk}
        out[variant] = rec
        print(f"[cp-step] {variant}: loss {lk:.6f} flash {lr:.6f} rel {rec['loss_rel']:.2e} "
              f"(tol {CP_STEP_LOSS_REL}); worst grad leaf {worst} rel norm {grad_rel[worst]:.2e} "
              f"(tol {CP_STEP_GRAD_REL}); launches {nk}", flush=True)
    k = out["kernels"]
    check(all(k["launches"][x] for x in TR.launches) and not any(k["launches"][x] for x in A.launches),
          f"cp whole step: the ring path launched {k['launches']}")
    check(math.isfinite(k["loss"]) and k["loss_rel"] <= CP_STEP_LOSS_REL,
          f"cp whole step: loss {k['loss']} vs {lr}")
    check(all(math.isfinite(x) and x <= CP_STEP_GRAD_REL for x in k["grad_rel"].values()),
          f"cp whole step: gradient relative norms {k['grad_rel']}")
    for variant in ("fault_b9_step", "fault_b10_home"):
        check(out[variant]["worst_grad_rel"] > CP_STEP_GRAD_REL,
              f"cp whole step: the gradient limit passes the planted {variant} "
              f"({out[variant]['worst_grad_rel']})")
    return out


def cp_train_phase(torch, llama, A, TR) -> dict:
    """``run_lm_training`` with a context axis of 4 (``cp_impl="pallas"``) at
    the 8B width cut to ``CP_TRAIN_LAYERS`` layers, B=1, T=16384, remat
    "full", ``CP_TRAIN_STEPS`` steps. The launch counts are set to 0 just
    before and read just after; B9/B10 launches must equal the schedule's
    (shards x steps that run x layers x train steps, the forward twice
    under remat)."""
    from tony_tpu_torch.train.loop import LoopConfig, run_lm_training
    from tony_tpu_torch.train.metrics import transformer_flops_per_token

    cfg = llama.config_from_dict({"preset": "llama3-8b", "n_layers": CP_TRAIN_LAYERS, "cp_impl": "pallas"})
    loop = LoopConfig(steps=CP_TRAIN_STEPS, batch_size=1, seq_len=RING_T, context_axis=RING_N,
                      warmup_steps=1, schedule_steps=CP_TRAIN_STEPS, log_every=1)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    TR.reset_launches()
    t0 = time.perf_counter()
    res = run_lm_training(llama, cfg, loop)
    wall = time.perf_counter() - t0
    launches = {**A.launches, **TR.launches}
    log = res["log"]
    for line in log:
        check(math.isfinite(line["loss"]) and math.isfinite(line["grad_norm"]), f"cp train: {line}")
        print(f"[cp-train] step {line['step']} loss {line['loss']} grad_norm {line['grad_norm']} "
              f"{line['step_time_ms']} ms", flush=True)
    L, S, Tl = CP_TRAIN_LAYERS, CP_TRAIN_STEPS, RING_T // RING_N
    sched = [(my, s) for my in range(RING_N) for s in range(RING_N)]
    want = {"ring_fwd": 2 * L * S * sum(TR.fwd_step_runs(my, s, RING_N, Tl, True, 0) for my, s in sched),
            "ring_bwd_dq": L * S * sum(TR.bwd_step_runs(my, s, RING_N, Tl, True, 0) for my, s in sched)}
    want["ring_bwd_dkv"] = want["ring_bwd_dq"]
    check([x["step"] for x in log] == list(range(1, S + 1)), f"cp train: steps {[x['step'] for x in log]}")
    check(abs(log[0]["loss"] - math.log(cfg.vocab_size)) <= 1.5,
          f"cp train: first loss {log[0]['loss']} not within 1.5 of ln(V) {math.log(cfg.vocab_size):.2f}")
    check({x: launches[x] for x in want} == want and not any(launches[x] for x in A.launches),
          f"cp train: launches {launches} (want {want} and no flash launch)")
    steady = sorted(x["step_time_ms"] for x in log[1:])
    ms = steady[len(steady) // 2]
    fpt = transformer_flops_per_token(cfg.num_params(), L, cfg.d_model, RING_T)
    rec = {
        "layers": L, "params": cfg.num_params(), "batch": 1, "seq_len": RING_T, "context": RING_N,
        "log": log, "launches": {**launches, "ring_bwd": launches["ring_bwd_dq"] + launches["ring_bwd_dkv"]},
        "launches_want": want, "step_ms": ms, "tok_per_s": RING_T / ms * 1e3,
        "mfu_t16384": RING_T / ms * 1e3 * fpt / BF16_FLOPS,
        "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "wall_s": wall,
    }
    print(f"[cp-train] 8B width, {L} layers, B=1 T={RING_T} over a context of {RING_N} (cp_impl pallas): "
          f"{ms:.1f} ms/step, {rec['tok_per_s']:.0f} tok/s, MFU {rec['mfu_t16384']:.3f} (6N + causal attention "
          f"at T={RING_T}), peak memory {rec['max_memory_gib']:.1f} GiB, wall {wall:.1f}s; launches {launches}",
          flush=True)
    return rec


def cp_train_mixtral(torch, mixtral, A, MG, TR, cfg: dict | None = None, T: int = RING_T,
                     device: str = "cuda") -> dict:
    """[cp-train]'s Mixtral part (A12a): ``run_lm_training`` at Mixtral-8x7B's
    widths cut to ``CP_MOE_LAYERS`` layers (``cfg`` and ``device`` another
    config and device), B=1, T=``T``, ``CP_MOE_STEPS`` steps, once with a
    context axis of ``RING_N`` in this process (``cp_impl="pallas"``: B9/B10
    on the ring, B7/B8 on the whole rows) and once without (B1-B3). The
    launch counts are set to 0 just before each run and read just after:
    the context run's B9/B10 must be the schedule's, its B7/B8 once a layer
    pass (remat "full": 2·L·S and L·S), and no flash launch; each loss
    must be the run without a context axis's within ``MOE_STEP_LOSS_REL``."""
    from tony_tpu_torch.train.loop import LoopConfig, run_lm_training

    cfg = mixtral.config_from_dict(cfg or {"preset": "mixtral-8x7b", "n_layers": CP_MOE_LAYERS, "cp_impl": "pallas"})
    cuda = device == "cuda"
    runs = {}
    for n in (RING_N, 1):
        loop = LoopConfig(steps=CP_MOE_STEPS, batch_size=1, seq_len=T, context_axis=n, warmup_steps=1,
                          schedule_steps=CP_MOE_STEPS, log_every=1, device=device)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        for mod in (A, MG, TR):
            mod.reset_launches()
        t0 = time.perf_counter()
        log = run_lm_training(mixtral, cfg, loop)["log"]
        runs[n] = {"log": log, "launches": {**A.launches, **MG.launches, **TR.launches},
                   "wall_s": time.perf_counter() - t0,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0}
    cp, one = runs[RING_N], runs[1]
    L, S, Tl = cfg.n_layers, CP_MOE_STEPS, T // RING_N
    for line in cp["log"]:
        check(all(math.isfinite(line[k]) for k in ("loss", "grad_norm", "moe_balance_loss", "moe_z_loss")),
              f"cp train mixtral: {line}")
    check([x["step"] for x in cp["log"]] == list(range(1, S + 1)), f"cp train mixtral: steps {cp['log']}")
    rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(cp["log"], one["log"])]
    for step, r in enumerate(rel, 1):
        check(r <= MOE_STEP_LOSS_REL, f"cp train mixtral: step {step} loss {cp['log'][step - 1]['loss']} against "
                                      f"{one['log'][step - 1]['loss']} without a context axis: {r:.2e} > "
                                      f"{MOE_STEP_LOSS_REL:.0e}")
    sched = [(my, s) for my in range(RING_N) for s in range(RING_N)]
    want = {"ring_fwd": 2 * L * S * sum(TR.fwd_step_runs(my, s, RING_N, Tl, True, 0) for my, s in sched),
            "ring_bwd_dq": L * S * sum(TR.bwd_step_runs(my, s, RING_N, Tl, True, 0) for my, s in sched),
            "moe_fwd": 2 * L * S, "moe_bwd": L * S}
    want["ring_bwd_dkv"] = want["ring_bwd_dq"]
    got = cp["launches"]
    if cuda:
        check({k: got[k] for k in want} == want and not any(got[k] for k in A.launches),
              f"cp train mixtral: launches {got} (want {want} and no flash launch)")
    else:
        check(not any(got.values()), f"cp train mixtral: launches on the CPU {got}")
    steady = sorted(x["step_time_ms"] for x in cp["log"][1:])
    rec = {"layers": L, "params": cfg.num_params(), "seq_len": T, "context": RING_N,
           "losses": [x["loss"] for x in cp["log"]], "one_losses": [x["loss"] for x in one["log"]],
           "grad_norms": [x["grad_norm"] for x in cp["log"]], "one_grad_norms": [x["grad_norm"] for x in one["log"]],
           "balance": [x["moe_balance_loss"] for x in cp["log"]], "one_balance": [x["moe_balance_loss"] for x in one["log"]],
           "loss_rel": rel, "launches": got, "launches_want": want, "one_launches": one["launches"],
           "step_ms": steady[len(steady) // 2], "one_step_ms": sorted(x["step_time_ms"] for x in one["log"][1:])[0],
           "max_memory_gib": cp["peak_gib"], "one_max_memory_gib": one["peak_gib"],
           "wall_s": cp["wall_s"], "one_wall_s": one["wall_s"],
           "launches_run": {**{k: got[k] for k in ("ring_fwd", "moe_fwd", "moe_bwd")},
                            "ring_bwd": got["ring_bwd_dq"] + got["ring_bwd_dkv"]}}
    print(f"[cp-train] {getattr(cfg, 'd_model')}-wide Mixtral ({cfg.num_experts} experts), {L} layers, B=1 T={T} over a "
          f"context of {RING_N} (cp_impl pallas): losses "
          f"{rec['losses']} (no context axis {rec['one_losses']}, worst rel {max(rel):.2e}, limit "
          f"{MOE_STEP_LOSS_REL:.0e}); grad norms {rec['grad_norms']} ({rec['one_grad_norms']}); balance "
          f"{rec['balance']} ({rec['one_balance']}); {rec['step_ms']:.1f} ms/step (no context axis "
          f"{rec['one_step_ms']:.1f}), peak memory {rec['max_memory_gib']:.1f} GiB ({rec['one_max_memory_gib']:.1f}); "
          f"launches {got}", flush=True)
    return rec


# -- serve phase ---------------------------------------------------------------

def _post(url: str, body: dict, timeout: float = 600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _get(url: str, timeout: float = 60) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def serve_requests(vocab: int = 128_000):
    """Eight requests: two sharing a 512-token prefix, two identical greedy
    prompts (shorter than a page, so neither is a prefix hit of the other
    and both run the same computation), four of other lengths; the last is
    streamed. Tokens in [1, vocab) come from a seeded numpy generator."""
    import numpy as np

    rng = np.random.default_rng(0)
    tok = lambda n: rng.integers(1, vocab, n).tolist()  # noqa: E731
    prefix = tok(512)
    same = tok(100)
    prompts = [prefix + tok(40), prefix + tok(70), same, list(same), tok(17), tok(300), tok(1000), tok(200)]
    return [{"prompt_tokens": p, "max_tokens": 32, "stream": i == 7} for i, p in enumerate(prompts)]


DECODE_TOKENS = 128


def decode_requests(vocab: int = 128_000):
    """Eight short prompts (16 tokens) with 128-token answers: one per slot,
    so the run is dominated by full-batch decode steps."""
    import numpy as np

    rng = np.random.default_rng(1)
    return [{"prompt_tokens": rng.integers(1, vocab, 16).tolist(), "max_tokens": DECODE_TOKENS,
             "stream": False} for _ in range(S)]


def send_batch(url: str, reqs: list[dict]):
    """Send every request at once from its own thread. Returns (per-request
    tokens or the exception raised, time to the first streamed event or
    None, wall seconds of the batch)."""
    results: list = [None] * len(reqs)
    ttft = [None]

    def one(i: int) -> None:
        t0 = time.perf_counter()
        try:
            with _post(url + "/v1/completions", reqs[i]) as r:
                if not reqs[i]["stream"]:
                    results[i] = json.load(r)["tokens"]
                    return
                for line in r:
                    line = line.decode().strip()
                    if not line.startswith("data: "):
                        continue
                    ev = json.loads(line[6:])
                    if ttft[0] is None:
                        ttft[0] = time.perf_counter() - t0
                    if ev.get("finished"):
                        results[i] = ev["tokens"]
        except Exception as e:  # noqa: BLE001 — reported as this request's failure by the caller
            results[i] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results, ttft[0], time.perf_counter() - t0


def run_server(name: str, extra: list[str], out_dir: Path) -> dict:
    url_file = out_dir / f"{name}.url"
    url_file.unlink(missing_ok=True)
    log = open(out_dir / f"{name}.log", "w")
    cmd = [sys.executable, "-m", "tony_tpu_torch.models.serving_http", "--preset", "llama3-8b",
           "--slots", "8", "--max-len", "2048", "--decode-chunk", "8", "--url-file", str(url_file), *extra]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t_start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 300
        while not url_file.exists():
            if proc.poll() is not None or time.time() > deadline:
                log.flush()
                raise SmokeFailure(f"serve {name}: server did not come up (rc={proc.poll()}); log:\n"
                                   + (out_dir / f"{name}.log").read_text()[-4000:])
            time.sleep(0.5)
        url = url_file.read_text()
        startup_s = time.perf_counter() - t_start
        # warm-up: first CUDA use of every path (not part of the timings below)
        with _post(url + "/v1/completions", {"prompt_tokens": list(range(1, 40)), "max_tokens": 8}) as r:
            check(len(json.load(r)["tokens"]) == 8, f"serve {name}: warm-up returned a short answer")
        reqs = serve_requests()
        results, ttft, wall = send_batch(url, reqs)
        for i, (rq, res) in enumerate(zip(reqs, results)):
            check(isinstance(res, list) and len(res) == rq["max_tokens"],
                  f"serve {name}: request {i} returned {res!r:.200}")
            check(all(0 <= t < 128_256 for t in res), f"serve {name}: request {i} has out-of-vocab tokens")
        check(results[2] == results[3], f"serve {name}: identical greedy prompts disagree:\n"
                                        f"{results[2]}\n{results[3]}")
        # decode-dominated batch: every slot busy, short prompts, long answers
        dreqs = decode_requests()
        dres, _, dwall = send_batch(url, dreqs)
        check(all(isinstance(r, list) and len(r) == DECODE_TOKENS for r in dres),
              f"serve {name}: decode batch returned {dres!r:.300}")
        st = _get(url + "/stats")
        check(st["healthy"] and st["requests_done"] == len(reqs) + len(dreqs) + 1,
              f"serve {name}: /stats {st}")
        if "--kv" not in extra:
            check(st.get("prefix_hit_tokens", 0) > 0, f"serve {name}: no prefix hits in {st}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 0, f"serve {name}: SIGTERM exit code {rc}")
        gen = sum(len(r) for r in results)
        rec = {
            "run": name, "args": extra, "startup_s": startup_s, "wall_s": wall,
            "tokens": gen, "tok_per_s": gen / wall, "ttft_stream_s": ttft,
            "decode_tok_per_s": len(dreqs) * DECODE_TOKENS / dwall,
            "decode_step_ms": dwall / DECODE_TOKENS * 1e3,
            "kernel_launches": st["kernel_launches"], "prefix_hit_tokens": st.get("prefix_hit_tokens"),
            "first_tokens": [r[0] for r in results],
        }
        print(f"[serve] {name}: {gen} tokens in {wall:.2f}s = {rec['tok_per_s']:.1f} tok/s, "
              f"TTFT(stream) {ttft:.3f}s; decode batch {rec['decode_tok_per_s']:.1f} tok/s "
              f"({rec['decode_step_ms']:.2f} ms/step); startup {startup_s:.1f}s, launches {st['kernel_launches']}, "
              f"prefix_hit_tokens {st.get('prefix_hit_tokens')}", flush=True)
        return rec
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


# -- fleet phases: the KV handoff in process, then `tony serve` fleets ----------

HANDOFF_PROMPT = 1280  # 5 full pages of 256: the [kv-handoff] prompt
HANDOFF_TOKENS = 32    # greedy continuation compared between the tiers
# the engine of every fleet replica: Llama-3-8B, all 32 layers, paged KV
FLEET_ENGINE = ["--preset", "llama3-8b", "--kv", "paged", "--page_len", str(PLEN), "--slots", str(S),
                "--max_len", str(MAXT), "--decode_chunk", "8"]
FLEETS = {"disagg": ["--disagg", "--replicas", "1", "--prefill_replicas", "1"],
          "colocated": ["--replicas", "1"]}
# `tony loadtest` traffic, the same for both fleets: 2 sessions x 2 turns =
# 4 streamed requests (a cut that keeps the command within its time limit);
# the longest conversation is 1280 + (64 + 8) + 64 = 1416 of the 2048 positions
LOADTEST = ["--rate", "2", "--sessions", "2", "--turns", "2", "--prompt-mix", "768:1,1280:1",
            "--shared-prefix", "512", "--max-tokens", "64", "--seed", "0"]
LOADTEST_REQUESTS = 4
_ROUTER_LINE = re.compile(r"^\[tony-serve\] fleet router (http://\S+) ", re.M)
_REPLICA_LINE = re.compile(r"^\[tony-serve\] (http://\S+) role=(serve|prefill) ", re.M)
_DRAINED_LINE = re.compile(r"^\[tony-serve\] drained: (\d+) request\(s\) completed, exit 0$", re.M)


def _replica(engine, role: str):
    """An EngineServer behind its own HTTP server on an ephemeral port."""
    from http.server import ThreadingHTTPServer

    from tony_tpu_torch.models import serving_http as SH

    srv = SH.EngineServer(engine, role=role).start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), type("Handler", (SH._Handler,), {"server_ref": srv}))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return srv, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post_status(url: str, body: dict, timeout: float = 600) -> tuple[int, dict]:
    try:
        with _post(url, body, timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def kv_handoff_phase(torch, llama, DA) -> dict:
    """The disaggregated KV handoff in this process at Llama-3-8B (all 32
    layers, bf16, paged, page_len 256): two EngineServers on one set of
    weights, each behind its own HTTP server, one in the prefill role. A
    1280-token prompt (5 full pages) goes through the prefill server's
    ``/v1/prefill`` with the decode server's URL: 5 pages adopted, the decode
    pool's pages the exported payload's bytes exactly (k and v), a re-ship all
    ``already_resident``, a payload with a wrong ``shape`` answered 400, and
    the decode tier's greedy continuation of the prompt served from prefix
    hits. Its agreement with the prefill server's own continuation is printed
    and not held: bf16 greedy agreement is rounding luck."""
    import base64

    import numpy as np

    from tony_tpu_torch.models.paged_cache import gather_pages, prefix_keys
    from tony_tpu_torch.models.serving import ContinuousBatcher
    from tony_tpu_torch.serve import disagg

    cfg = llama.PRESETS["llama3-8b"]
    with torch.no_grad():
        params = llama.init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    made = []
    try:
        for role in ("prefill", "serve"):
            eng = ContinuousBatcher(params, cfg, num_slots=S, max_len=MAXT, decode_chunk=8, kv="paged",
                                    page_len=PLEN)
            made.append(_replica(eng, role))
        (pre, _, pre_url), (dec, _, dec_url) = made
        warm = {"prompt_tokens": list(range(1000, 1040)), "max_tokens": 8}  # first CUDA use of each path
        for url in (pre_url, dec_url):
            check(_post_status(url + "/v1/completions", warm)[0] == 200, "kv-handoff: warm-up failed")
        prompt = np.random.default_rng(5).integers(2000, cfg.vocab_size, HANDOFF_PROMPT).tolist()
        pages = HANDOFF_PROMPT // PLEN
        st, leg = _post_status(pre_url + "/v1/prefill", {"prompt_tokens": prompt, "decode_url": dec_url})
        check(st == 200 and "ship_error" not in leg and (leg["pages"], leg["adopted"], leg["already_resident"])
              == (pages, pages, 0), f"kv-handoff: the prefill leg answered {st} {leg}")
        # the exported payload (the prefill pool still holds the pages) against
        # the decode pool's adopted pages, byte for byte; on the way, the host
        # stages of one ship: the export on the engine thread (gather, copy to
        # the host, base64), the wait for the idle engine loop to take it, and
        # the JSON encode, JSON parse and base64 decode of the wire payload
        def timed_export():
            t = time.perf_counter()
            return disagg.export_prefix_pages(pre, prompt), time.perf_counter() - t

        t0 = time.perf_counter()
        payload, export_s = pre.run_on_engine(timed_export)
        pickup_s = time.perf_counter() - t0 - export_s
        t0 = time.perf_counter()
        body = json.dumps(payload).encode()
        dumps_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        json.loads(body)
        loads_s = time.perf_counter() - t0
        wire_bytes = len(body)
        del body
        t0 = time.perf_counter()
        want_k, want_v = base64.b64decode(payload["k"]), base64.b64decode(payload["v"])
        b64decode_s = time.perf_counter() - t0

        def adopted_bytes():
            got = dec.engine.allocator.match_prefix(prefix_keys(prompt, PLEN))
            try:
                pk, pv = gather_pages(dec.engine.cache.k, dec.engine.cache.v, got)
                return len(got), disagg.tensor_bytes(pk.cpu()), disagg.tensor_bytes(pv.cpu())
            finally:
                for p in got:
                    dec.engine.allocator.release(p)

        n, k_bytes, v_bytes = dec.run_on_engine(adopted_bytes)
        same = n == pages and k_bytes == want_k and v_bytes == want_v
        check(same, f"kv-handoff: the decode pool's {n} adopted pages differ from the exported payload")
        st, again = _post_status(pre_url + "/v1/prefill", {"prompt_tokens": prompt, "decode_url": dec_url})
        check(st == 200 and (again["adopted"], again["already_resident"]) == (0, pages),
              f"kv-handoff: the re-ship answered {st} {again}")
        bad = dict(payload, shape=[*payload["shape"][:-1], payload["shape"][-1] + 1])
        st, refused = _post_status(dec_url + "/v1/kv/adopt", bad)
        check(st == 400 and "geometry mismatch" in refused.get("error", ""),
              f"kv-handoff: a wrong shape was answered {st} {refused}")
        hits0 = _get(dec_url + "/stats")["prefix_hit_tokens"]
        b5 = DA.launches["paged_decode_attention"]
        body = {"prompt_tokens": prompt, "max_tokens": HANDOFF_TOKENS}
        st, dec_out = _post_status(dec_url + "/v1/completions", body)
        b5 = DA.launches["paged_decode_attention"] - b5
        hits = _get(dec_url + "/stats")["prefix_hit_tokens"] - hits0
        check(st == 200 and len(dec_out["tokens"]) == HANDOFF_TOKENS and hits > 0 and b5 > 0,
              f"kv-handoff: the decode tier's continuation {st} {dec_out!r:.200}, prefix hits {hits}, "
              f"B5 launches {b5}")
        st, pre_out = _post_status(pre_url + "/v1/completions", body)
        check(st == 200, f"kv-handoff: the prefill server's continuation answered {st}")
        agree = next((i for i, (a, b) in enumerate(zip(dec_out["tokens"], pre_out["tokens"])) if a != b),
                     HANDOFF_TOKENS)
        rec = {"pages": pages, "handoff_ms": leg["handoff_ms"], "reship_ms": again["handoff_ms"],
               "export_s": export_s, "pickup_s": pickup_s, "json_encode_s": dumps_s, "json_parse_s": loads_s,
               "b64decode_s": b64decode_s, "wire_bytes": wire_bytes, "same_bytes": same,
               "prefix_hit_tokens": hits, "b5_launches": b5, "tokens_agree": agree,
               "first_token": leg["first_token"]}
        print(f"[kv-handoff] llama3-8b bf16 page_len {PLEN}: {pages} pages of a {HANDOFF_PROMPT}-token prompt "
              f"shipped in {leg['handoff_ms']:.1f} ms (prefill leg: one token, export, ship, adopt; re-ship "
              f"{again['handoff_ms']:.1f} ms, already resident {pages}); {wire_bytes / 1e6:.1f} MB of JSON; "
              f"the adopted pages are the payload's bytes: {same}; wrong shape → 400", flush=True)
        print(f"[kv-handoff] host stages of one ship: export {export_s * 1e3:.1f} ms on the engine thread "
              f"(gather, copy to the host, base64) after {pickup_s * 1e3:.1f} ms for the idle loop to take it; "
              f"JSON encode {dumps_s * 1e3:.1f} ms, JSON parse {loads_s * 1e3:.1f} ms, base64 decode "
              f"{b64decode_s * 1e3:.1f} ms", flush=True)
        print(f"[kv-handoff] the decode tier's greedy continuation: {hits} prefix-hit tokens, B5 launched "
              f"{b5} times; {agree} of its {HANDOFF_TOKENS} tokens agree with the prefill server's own "
              "(bf16: not held)", flush=True)
        return rec
    finally:
        for srv, httpd, _ in made:
            httpd.shutdown()
            httpd.server_close()
            srv.stop(timeout_s=30)


def _replica_urls(root: Path) -> dict:
    """role → URL of the replicas whose stdout the staging dir holds."""
    out = {}
    for log in root.glob("application_*/logs/*_0/stdout.log"):
        for url, role in _REPLICA_LINE.findall(log.read_text(errors="replace")):
            out[role] = url
    return out


def _serving_processes() -> list[str]:
    ps = subprocess.run(["pgrep", "-f", "tony_tpu_torch.models.serving_http"], capture_output=True, text=True)
    return ps.stdout.split()


def run_fleet(name: str, extra: list[str], out_dir: Path, card: str) -> dict:
    """One ``tony serve`` fleet through the port's launcher, driven by ``tony
    loadtest`` (both run as subprocesses), then SIGINT to the launcher."""
    work = out_dir / "fleet" / name
    shutil.rmtree(work, ignore_errors=True)
    root = work / "tony"
    root.mkdir(parents=True)
    env = dict(os.environ, TONY_ROOT=str(root), PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "tony_tpu_torch_launch.serve", *FLEET_ENGINE, *extra,
           "--conf", "tony.task.metrics-interval-ms=500"]
    log_path = work / "launcher.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT)
    roles = {"serve", "prefill"} if "--disagg" in extra else {"serve"}
    try:
        router = urls = None
        deadline = time.time() + 400
        while time.time() < deadline and proc.poll() is None:
            m = _ROUTER_LINE.search(log_path.read_text(errors="replace"))
            urls = _replica_urls(root)
            if m and set(urls) == roles:
                router = m.group(1)
                break
            time.sleep(0.5)
        check(router is not None, f"fleet {name}: no router and replicas {sorted(urls or {})} (launcher rc "
                                  f"{proc.poll()}):\n{log_path.read_text(errors='replace')[-3000:]}")
        # the first request through the router: a prompt of 300 tokens outside
        # the load's, so a disaggregated fleet fires (and must complete) a leg
        warm = {"prompt_tokens": list(range(2000, 2300)), "max_tokens": 8}
        while True:
            st, out = _post_status(router + "/v1/completions", warm)
            check(st == 200 and len(out.get("tokens", [])) == 8, f"fleet {name}: warm-up answered {st} {out}")
            legs = (_get(router + "/stats").get("disagg") or {}).get("legs_ok", 0)
            if "prefill" not in roles or legs:
                break
            check(time.time() < deadline, f"fleet {name}: the router never fired a prefill leg")
            time.sleep(1.0)
        startup_s = time.perf_counter() - t0
        before = {role: _get(url + "/stats") for role, url in urls.items()}
        report_path, record_path = work / "loadtest.json", work / "SERVE_BENCH_fleet.json"
        lt = _tony(["loadtest", "--url", router, *LOADTEST, "--out", str(report_path),
                    "--bench-record", str(record_path)], env, timeout=600)
        check(lt.returncode == 0 and report_path.exists(),
              f"fleet {name}: tony loadtest exited {lt.returncode}:\n{lt.stdout[-3000:]}\n{lt.stderr[-2000:]}")
        rep = json.loads(report_path.read_text())
        after = {role: _get(url + "/stats") for role, url in urls.items()}
        b5 = (after["serve"]["kernel_launches"]["paged_decode_attention"]
              - before["serve"]["kernel_launches"]["paged_decode_attention"])
        check(rep["requests_ok"] == LOADTEST_REQUESTS and rep["requests_failed"] == 0 and rep["stream"],
              f"fleet {name}: {rep['requests_ok']} ok, {rep['requests_failed']} failed: {rep.get('first_errors')}")
        check(rep.get("prefix_hit_tokens", 0) > 0, f"fleet {name}: no prefix hits in {rep}")
        check(b5 > 0, f"fleet {name}: the decode replica never launched B5: {after['serve']['kernel_launches']}")
        if "prefill" in roles:
            exported = after["prefill"]["kv_handoff_exported"] - before["prefill"]["kv_handoff_exported"]
            adopted = after["serve"]["kv_handoff_adopted"] - before["serve"]["kv_handoff_adopted"]
            check(rep.get("kv_handoff_pages", 0) > 0 and rep.get("handoff_p50_ms", 0) > 0
                  and exported > 0 and adopted > 0,
                  f"fleet {name}: handoff pages {rep.get('kv_handoff_pages')}, p50 {rep.get('handoff_p50_ms')} "
                  f"ms, exported {exported}, adopted {adopted}")
        # SIGINT to the launcher: the job is killed, every replica drains
        t_int = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
        stop_s = time.perf_counter() - t_int
        check(rc == 0, f"fleet {name}: the launcher exited {rc} after SIGINT")
        drained = {}
        for log in root.glob("application_*/logs/*_0/stdout.log"):
            m = _DRAINED_LINE.search(log.read_text(errors="replace"))
            drained[log.parent.name] = int(m.group(1)) if m else None
        check(len(drained) == len(roles) and all(v is not None for v in drained.values()),
              f"fleet {name}: replica drains {drained}")
        check(_wait_gone(60), f"fleet {name}: replica processes outlived the job: {_serving_processes()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
            subprocess.run(["pkill", "-f", "tony_tpu.cluster"], check=False)  # the job's AM and executors
            subprocess.run(["pkill", "-f", "tony_tpu_torch.models.serving_http"], check=False)
    rec = {"fleet": name, "args": extra, "startup_s": startup_s, "stop_s": stop_s, "b5_launches": b5,
           "drained": drained, **{k: rep.get(k) for k in (
               "requests_ok", "requests_failed", "tokens_total", "tokens_per_sec", "wall_s", "ttft_p50_ms",
               "ttft_p95_ms", "ttft_p99_ms", "token_latency_p50_ms", "latency_p50_ms", "latency_p99_ms",
               "prefix_hit_tokens", "kv_handoff_pages", "handoff_p50_ms", "handoff_p95_ms")}}
    print(fleet_line(rec, card), flush=True)
    return rec


def _wait_gone(timeout_s: float) -> bool:
    deadline = time.time() + timeout_s
    while _serving_processes():
        if time.time() > deadline:
            return False
        time.sleep(0.5)
    return True


def fleet_line(rec: dict, card: str) -> str:
    line = (f"[fleet] {rec['fleet']}: startup {rec['startup_s']:.1f} s; {rec['requests_ok']}/{LOADTEST_REQUESTS} "
            f"ok, {rec['tokens_per_sec']:.1f} tok/s; TTFT p50/p95/p99 {rec['ttft_p50_ms']:.1f} / "
            f"{rec['ttft_p95_ms']:.1f} / {rec['ttft_p99_ms']:.1f} ms; gap between tokens p50 "
            f"{rec['token_latency_p50_ms']:.2f} ms; latency p50/p99 {rec['latency_p50_ms']:.1f} / "
            f"{rec['latency_p99_ms']:.1f} ms; prefix hits {rec['prefix_hit_tokens']}; B5 {rec['b5_launches']}")
    if rec.get("kv_handoff_pages"):
        line += f"; handoff p50 {rec['handoff_p50_ms']:.1f} ms, {rec['kv_handoff_pages']} pages moved"
    return line + f"; stop {rec['stop_s']:.1f} s; {card}"


def fleet_phase(out_dir: Path, card: str) -> dict:
    """``tony serve`` through ``python -m tony_tpu_torch_launch.serve`` twice,
    each fleet Llama-3-8B (all 32 layers, paged, page_len 256, 8 slots,
    max_len 2048) on the one card: ``disagg`` (one prefill and one decode
    replica, the KV handoff between them) and ``colocated`` (one replica),
    each driven by the same ``tony loadtest`` traffic (``LOADTEST``, streamed).
    Holds 12/12 requests ok, prefix hits, B5 launched by the decode replica
    during the load, and for ``disagg`` pages moved and adopted; SIGINT to the
    launcher ends the job, every replica logs a drain and exits, and the
    launcher within 120 s. Both tiers share the card, so ``disagg`` measures
    the handoff's mechanics and cost, not the gain of separate tiers."""
    check(not _serving_processes(), f"fleet: serving processes already running: {_serving_processes()}")
    return {name: run_fleet(name, extra, out_dir, card) for name, extra in FLEETS.items()}


# -- MoE grouped SwiGLU kernels (B7, B8) and the Mixtral path --------------------

def moe_inputs(torch, MG, expert, c):
    """Routed rows at Mixtral-8x7B widths (F, or ``c["F"]`` columns of it):
    ``c["tokens"]`` tokens routed top-2 over 8 experts by a seeded random
    router ('random'), or every token to experts 0 and 1 ('two': experts 2-7
    own one pad tile and no real row); with ``c["experts"]`` the sorted rows
    of the first that many experts only, an expert-axis rank's span; expert
    weights at fan-in scale; the cotangent zero on pad rows, as the
    combine's backward makes it. ``rows``: the real routed rows."""
    g = torch.Generator(device="cuda").manual_seed(4)
    N, F, bf = c["tokens"], c.get("F", MOE_F), torch.bfloat16
    x = torch.randn(1, N, MOE_D, generator=g, device="cuda").to(bf)
    router = torch.randn(MOE_D, MOE_E, generator=g, device="cuda") / MOE_D ** 0.5
    if c["skew"] == "two":
        router = torch.zeros_like(router)
        router[:, :2] = 1.0
        x = x.abs()
    sort_tok, _, _, gate_sorted, gs, _ = expert.route_ragged(
        x, router, expert.MoEConfig(MOE_E, MOE_K), tile=MG.TILE)
    E, rows = c.get("experts", MOE_E), N * MOE_K
    if E < MOE_E:
        gs = gs[:E]
        span = int(gs.sum())
        sort_tok, gate_sorted = sort_tok[:span], gate_sorted[:span]
        rows = int((gate_sorted != 0).sum())
    xs = x.reshape(N, MOE_D)[sort_tok.long()].contiguous()
    tg = MG.tile_group_map(gs, xs.shape[0] // MG.TILE, MG.TILE)

    def w(*shape, fan):
        return (torch.randn(*shape, generator=g, device="cuda") * fan ** -0.5).to(bf)

    wg, wu, wd = w(E, MOE_D, F, fan=MOE_D), w(E, MOE_D, F, fan=MOE_D), w(E, F, MOE_D, fan=F)
    dy = (torch.randn(xs.shape, generator=g, device="cuda") * (gate_sorted != 0)[:, None]).to(bf)
    return dict(xs=xs, wg=wg, wu=wu, wd=wd, tg=tg, dy=dy, gs=gs, rows=rows)


def next_expert_tiles(torch, tg, E: int):
    """A planted fault for the plain versions: the last row tile of each
    expert's run computed with the next expert's weights."""
    bad = tg.clone()
    end = torch.tensor([E], dtype=tg.dtype, device=tg.device)
    last = torch.nonzero(torch.diff(tg, append=end) != 0)[:, 0]
    bad[last] = (tg[last] + 1) % E
    return bad


def expert_rel_err(got, want) -> tuple[float, bool]:
    """(largest relative Frobenius error over the experts whose reference
    dW is not zero, whether every other expert's dW is exactly zero)."""
    errs, zeros_ok = [0.0], True
    for e in range(want.shape[0]):
        ref = want[e].float()
        n = ref.norm()
        if n == 0:
            zeros_ok &= bool((got[e] == 0).all())
        else:
            errs.append(((got[e].float() - ref).norm() / n).item())
    return max(errs), zeros_ok


def library_swiglu(torch, xs, wg, wu, wd, gs):
    """The yardstick: the expert MLP as three ``torch._grouped_mm`` products
    with silu·mul between them, over the experts' spans."""
    import torch.nn.functional as F

    offs = torch.cumsum(gs, 0).to(torch.int32)
    xs = xs[:int(offs[-1])]  # the rows of the experts' spans (the tiles past them are unused)

    def mm(a, b):
        return torch._grouped_mm(a, b, offs=offs)

    return mm(F.silu(mm(xs, wg)) * mm(xs, wu), wd)


def moe_cost(m) -> dict:
    """Operations over this run's real routed rows and the bytes of each
    input read once and each output written once."""
    PN, E, D, F = m["xs"].shape[0], m["wg"].shape[0], MOE_D, m["wg"].shape[-1]
    w, act = 3 * E * D * F * 2, PN * D * 2
    return {"moe_fwd": (2 * m["rows"] * D * F * 3, 2 * act + w + PN // 128 * 4),
            "moe_bwd": (2 * m["rows"] * D * F * 8, 3 * act + 2 * w + PN // 128 * 4)}


MOE_KERNEL_PASSES = {"moe_fwd": ("up", "down"), "moe_bwd": ("up_bwd", "dx", "dw_gu", "dw_d")}


def moe_pass_ms(torch, kernels) -> dict:
    """Device ms of each pass of B7 and B8 (``torch.profiler``, L2 warm): the
    median over three launches of each, by the pass in the kernel's name
    (the profiler may miss its first kernels); empty if it saw no device
    activity."""
    from torch.profiler import ProfilerActivity, profile

    for fn in kernels.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            for fn in kernels.values():
                fn()
        torch.cuda.synchronize()
    runs: dict = {}
    for e in prof.events():
        found = re.search(r"moe_gemm_kernel<(\d)>", e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and found:
            runs.setdefault(MOE_PASSES[int(found.group(1))], []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    ms = {k: sorted(v)[len(v) // 2] for k, v in runs.items()}
    print("[moe]   device ms by pass " + (str({k: round(v, 3) for k, v in ms.items()}) if ms
                                          else "not measured: the profiler recorded no device activity"),
          flush=True)
    return ms


def moe_kernel_phase(torch, MG, expert, flush) -> dict:
    """B7 and B8 against their plain versions on the card, in bf16: ys and
    dxs row by row, each expert's dW in relative Frobenius norm, a planted
    fault (``next_expert_tiles``) that each check must fail; then the times."""
    build = moe_build_report()
    lib_name = "torch._grouped_mm"
    recs = {"moe_fwd": [], "moe_bwd": []}
    for name, c in MOE_CASES.items():
        m = moe_inputs(torch, MG, expert, c)
        args = (m["xs"], m["wg"], m["wu"], m["wd"])
        ys = MG.moe_fwd(*args, m["tg"])
        bwd = MG.moe_bwd(m["xs"], m["dy"], *args[1:], m["tg"])
        torch.cuda.synchronize()
        ys_p = MG.moe_fwd_plain(*args, m["tg"])
        bwd_p = MG.moe_bwd_plain(m["xs"], m["dy"], *args[1:], m["tg"])
        bad = next_expert_tiles(torch, m["tg"], m["wg"].shape[0])
        ys_f = MG.moe_fwd_plain(*args, bad)
        bwd_f = MG.moe_bwd_plain(m["xs"], m["dy"], *args[1:], bad)
        for t in (ys, *bwd):
            check(bool(torch.isfinite(t.float()).all()), f"moe {name}: non-finite kernel output")
        w_err = [expert_rel_err(a, b) for a, b in zip(bwd[1:], bwd_p[1:])]
        w_fault = max(expert_rel_err(a, b)[0] for a, b in zip(bwd_f[1:], bwd_p[1:]))
        errs = {
            "moe_fwd": {"row_err": row_rel_err(ys, ys_p), "fault_row_err": row_rel_err(ys_f, ys_p),
                        "max_abs_err": (ys.float() - ys_p.float()).abs().max().item()},
            "moe_bwd": {"row_err": row_rel_err(bwd[0], bwd_p[0]),
                        "fault_row_err": row_rel_err(bwd_f[0], bwd_p[0]),
                        "w_err": max(e for e, _ in w_err), "fault_w_err": w_fault,
                        "w_zeros_exact": all(z for _, z in w_err),
                        "max_abs_err": max((a.float() - b.float()).abs().max().item()
                                           for a, b in zip(bwd, bwd_p))},
        }
        del ys_f, bwd_f
        lib_ys = library_swiglu(torch, *args, m["gs"])
        lib_err = row_rel_err(lib_ys, ys_p[:lib_ys.shape[0]])
        for kname, e in errs.items():
            print(f"[moe] {kname} {name:8s} row err {e['row_err']:.3e} (tol {MOE_ROW_TOL}; planted fault "
                  f"{e['fault_row_err']:.3e}), max_abs_err {e['max_abs_err']:.3e}"
                  + (f"; dW rel err {e['w_err']:.3e} (tol {MOE_W_TOL}; planted fault {e['fault_w_err']:.3e}),"
                     f" zero-row experts exactly 0: {e['w_zeros_exact']}" if kname == "moe_bwd"
                     else f"; {lib_name} row err {lib_err:.3e}"), flush=True)
        leaves = [t.detach().clone().requires_grad_(True) for t in args]
        lib_out = library_swiglu(torch, *leaves, m["gs"])
        lib_ms = {
            "moe_fwd": time_ms(torch, lambda: library_swiglu(torch, *args, m["gs"]), flush, iters=5),
            "moe_bwd": time_ms(torch, lambda: torch.autograd.grad(lib_out, leaves, m["dy"][:lib_out.shape[0]],
                                                                  retain_graph=True),
                               flush, iters=5),
        }
        del lib_out, leaves, lib_ys
        kernels = {"moe_fwd": lambda: MG.moe_fwd(*args, m["tg"]),
                   "moe_bwd": lambda: MG.moe_bwd(m["xs"], m["dy"], *args[1:], m["tg"])}
        plains = {"moe_fwd": lambda: MG.moe_fwd_plain(*args, m["tg"]),
                  "moe_bwd": lambda: MG.moe_bwd_plain(m["xs"], m["dy"], *args[1:], m["tg"])}
        cost = moe_cost(m)
        for kname, e in errs.items():
            flops, nbytes = cost[kname]
            rec = dict(e, case=name, tol=MOE_ROW_TOL, rows=m["rows"], padded_rows=m["xs"].shape[0],
                       flops=flops, bytes=nbytes,
                       ms=time_ms(torch, kernels[kname], flush, iters=5, warmup=1),
                       plain_ms=time_ms(torch, plains[kname], flush, iters=3, warmup=1),
                       library_ms=lib_ms[kname],
                       library_call=f"{lib_name}: 3 GEMMs + silu·mul" if kname == "moe_fwd"
                       else f"autograd backward of the {lib_name} composite, from a saved forward",
                       bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
                       bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations")
            if kname == "moe_fwd":
                rec["library_row_err"] = lib_err
            rec["tflops"] = flops / rec["ms"] / 1e9
            print(f"[moe] {kname} {name:8s} ms {rec['ms']:.3f} plain {rec['plain_ms']:.3f} library "
                  f"{rec['library_ms']:.3f} bound {rec['bound_ms']:.3f} ({rec['bound_by']}); "
                  f"{rec['tflops']:.1f} TFLOP/s", flush=True)
            recs[kname].append(rec)
        passes = moe_pass_ms(torch, kernels)
        for kname in recs:
            recs[kname][-1]["pass_ms"] = {k: v for k, v in passes.items() if k in MOE_KERNEL_PASSES[kname]}
        del m, args, ys, bwd, ys_p, bwd_p, kernels, plains
        torch.cuda.empty_cache()
        for kname, rs in recs.items():
            e = rs[-1]
            check(e["row_err"] <= MOE_ROW_TOL, f"{kname} {name}: row error {e['row_err']} > {MOE_ROW_TOL}")
            check(e["fault_row_err"] > MOE_ROW_TOL,
                  f"{kname} {name}: the row check passes a planted fault ({e['fault_row_err']})")
        b = recs["moe_bwd"][-1]
        check(b["w_err"] <= MOE_W_TOL and b["w_zeros_exact"],
              f"moe_bwd {name}: dW error {b['w_err']} > {MOE_W_TOL} or a zero-row expert's dW is not 0")
        check(b["fault_w_err"] > MOE_W_TOL, f"moe_bwd {name}: the dW check passes a planted fault")
    return {kname: dict(rs[0], cases=rs, build=build) for kname, rs in recs.items()}


def zeroed_expert_fwd(MG, e: int = 1):
    """B7 with a planted fault: the rows of expert ``e`` come out as zeros."""
    real = MG.moe_fwd

    def fwd(xs, wg, wu, wd, tile_group, tile=MG.TILE):
        ys = real(xs, wg, wu, wd, tile_group, tile)
        ys[tile_group.repeat_interleave(tile) == e] = 0
        return ys

    return fwd


def dropped_dwd_bwd(MG, e: int = 1):
    """B8 with a planted fault: expert ``e``'s dWd is left out (zeros)."""
    real = MG.moe_bwd

    def bwd(*a, **kw):
        dxs, dwg, dwu, dwd = real(*a, **kw)
        dwd[e] = 0
        return dxs, dwg, dwu, dwd

    return bwd


def moe_whole_step_check(torch, mixtral, MG) -> dict:
    """One Mixtral ``loss_fn`` value and every gradient leaf through B7/B8
    (remat "full", as the train run) against the same step with the plain
    versions swapped in, on the same params and batch: full width, 1 layer,
    B=1, T=2048. Two planted faults (expert 1's rows zeroed by B7, or its
    dWd left out by B8) must fail the limits that the kernels pass."""
    cfg = mixtral.config_from_dict({"preset": "mixtral-8x7b", "n_layers": 1})
    params = mixtral.init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    names, tensors = zip(*_leaves(params))
    for t in tensors:
        t.requires_grad_(True)
    batch = mixtral.synthetic_batch(torch.Generator(device="cuda").manual_seed(1), 1, 2048, cfg)

    def run():
        MG.reset_launches()
        loss, aux = mixtral.loss_fn(params, batch, cfg)
        return loss.item(), torch.autograd.grad(loss, tensors), dict(MG.launches)

    plain = [mock.patch.object(MG, "moe_fwd", MG.moe_fwd_plain),
             mock.patch.object(MG, "moe_bwd", MG.moe_bwd_plain)]
    with contextlib.ExitStack() as stack:
        for p in plain:
            stack.enter_context(p)
        lr, gr, nr = run()
    check(not any(nr.values()), f"moe whole step: the plain run launched kernels {nr}")
    out = {"loss_plain": lr}
    variants = {"kernels": None, "fault_b7_expert": ("moe_fwd", zeroed_expert_fwd(MG)),
                "fault_b8_dwd": ("moe_bwd", dropped_dwd_bwd(MG))}
    for variant, patch in variants.items():
        with mock.patch.object(MG, *patch) if patch else contextlib.nullcontext():
            lk, gk, nk = run()
        grad_rel = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
                    for n, a, b in zip(names, gk, gr)}
        del gk
        worst = max(grad_rel, key=grad_rel.get)
        rec = {"loss": lk, "loss_rel": abs(lk - lr) / abs(lr), "worst_leaf": worst,
               "worst_grad_rel": grad_rel[worst], "grad_rel": grad_rel, "launches": nk}
        out[variant] = rec
        print(f"[moe-step] {variant}: loss {lk:.6f} plain {lr:.6f} rel {rec['loss_rel']:.2e} "
              f"(tol {MOE_STEP_LOSS_REL}); worst grad leaf {worst} rel norm {grad_rel[worst]:.2e} "
              f"(tol {MOE_STEP_GRAD_REL}); launches {nk}", flush=True)
    k = out["kernels"]
    check(k["launches"] == {"moe_fwd": 2, "moe_bwd": 1}, f"moe whole step: launches {k['launches']}")
    check(math.isfinite(k["loss"]) and k["loss_rel"] <= MOE_STEP_LOSS_REL,
          f"moe whole step: loss {k['loss']} vs {lr}")
    check(all(math.isfinite(x) and x <= MOE_STEP_GRAD_REL for x in k["grad_rel"].values()),
          f"moe whole step: gradient relative norms {k['grad_rel']}")
    check(out["fault_b7_expert"]["loss_rel"] > MOE_STEP_LOSS_REL,
          f"moe whole step: the loss limit passes a planted B7 fault ({out['fault_b7_expert']['loss_rel']})")
    for variant in ("fault_b7_expert", "fault_b8_dwd"):
        check(out[variant]["worst_grad_rel"] > MOE_STEP_GRAD_REL,
              f"moe whole step: the gradient limit passes the planted {variant} "
              f"({out[variant]['worst_grad_rel']})")
    return out


def moe_train_phase(torch, mixtral, A, MG) -> dict:
    """``run_lm_training`` on Mixtral-8x7B's widths cut to 2 layers (bf16,
    remat "full", ce_chunk 512, B=4, T=2048), 4 steps in this process. The
    kernel launch counts are set to 0 just before and read just after."""
    from tony_tpu_torch.train.loop import LoopConfig, run_lm_training
    from tony_tpu_torch.train.metrics import transformer_flops_per_token

    cfg = mixtral.config_from_dict({"preset": "mixtral-8x7b", "n_layers": MOE_TRAIN_LAYERS})
    loop = LoopConfig(steps=MOE_TRAIN_STEPS, batch_size=4, seq_len=2048, warmup_steps=2,
                      schedule_steps=MOE_TRAIN_STEPS, log_every=1)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    MG.reset_launches()
    t0 = time.perf_counter()
    res = run_lm_training(mixtral, cfg, loop)
    wall = time.perf_counter() - t0
    launches = {**A.launches, **MG.launches}
    log = res["log"]
    for line in log:
        check(all(math.isfinite(line[k]) for k in ("loss", "grad_norm", "moe_balance_loss", "moe_z_loss")),
              f"mixtral train: {line}")
        print(f"[moe-train] step {line['step']} loss {line['loss']} grad_norm {line['grad_norm']} "
              f"balance {line['moe_balance_loss']:.6f} z {line['moe_z_loss']:.6f} "
              f"dropped {line['moe_dropped_frac']} {line['step_time_ms']} ms", flush=True)
    L, S = MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS
    check([x["step"] for x in log] == list(range(1, S + 1)), f"mixtral train: steps {[x['step'] for x in log]}")
    check(abs(log[0]["loss"] - math.log(cfg.vocab_size)) <= 1.5,
          f"mixtral train: first loss {log[0]['loss']} not within 1.5 of ln(V) {math.log(cfg.vocab_size):.2f}")
    check(launches["moe_fwd"] == 2 * L * S and launches["moe_bwd"] == L * S,
          f"mixtral train: MoE launches {launches} (want moe_fwd {2 * L * S}, moe_bwd {L * S})")
    check(all(launches.values()), f"mixtral train: a kernel was never launched: {launches}")
    steady = sorted(x["step_time_ms"] for x in log[1:])
    ms = steady[len(steady) // 2]
    tokens = loop.batch_size * loop.seq_len
    fpt = transformer_flops_per_token(cfg.active_params(), L, cfg.d_model, loop.seq_len)
    rec = {
        "layers": L, "params": cfg.num_params(), "active_params": cfg.active_params(),
        "batch": loop.batch_size, "seq_len": loop.seq_len, "log": log, "launches": launches,
        "step_ms": ms, "tok_per_s": tokens / ms * 1e3, "mfu_active_t2048": tokens / ms * 1e3 * fpt / BF16_FLOPS,
        "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "wall_s": wall,
    }
    print(f"[moe-train] Mixtral-8x7B width, {L} layers ({rec['params'] / 1e9:.2f} B params, "
          f"{rec['active_params'] / 1e9:.2f} B active), B=4 T=2048: {ms:.1f} ms/step, "
          f"{rec['tok_per_s']:.0f} tok/s, MFU {rec['mfu_active_t2048']:.3f} (active 6N + attention at "
          f"T=2048), peak memory {rec['max_memory_gib']:.1f} GiB, wall {wall:.1f}s; launches {launches}",
          flush=True)
    return rec


def engine_batch(torch, eng, reqs: list[dict]):
    """Submit every request at once to the in-process engine and step it to
    the end. Returns (tokens per request, seconds to the first token of the
    streamed request, wall seconds of the batch)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(r["prompt_tokens"], r["max_tokens"]) for r in reqs]
    streamed = [rid for rid, r in zip(rids, reqs) if r["stream"]]
    ttft = None
    while eng.step():
        if ttft is None and streamed and eng.drain_stream().get(streamed[0], ([],))[0]:
            ttft = time.perf_counter() - t0
    wall = time.perf_counter() - t0
    return [eng.done[rid] for rid in rids], ttft, wall


def decode_chunk_profile(torch, eng, vocab: int, tag: str = "moe-serve") -> dict:
    """Decode chunks of the engine (``decode_chunk`` steps, every slot busy
    with a ``decode_requests`` answer, no prefill in them): one timed on the
    host clock, the next under ``torch.profiler`` for device ms by kernel
    family; the busy share is that device time over the unprofiled chunk's
    wall. Then the requests run to their end."""
    reqs = decode_requests(vocab)
    rids = [eng.submit(r["prompt_tokens"], r["max_tokens"]) for r in reqs]
    for _ in range(64):
        if len(eng.running) == S and not (eng.pending or eng._staged):
            break
        eng.step()
    check(len(eng.running) == S and not (eng.pending or eng._staged),
          f"decode chunk: {len(eng.running)} slots decoding, prefills still queued")
    t0 = time.perf_counter()
    eng.step()  # one chunk outside the profiler: its host wall (the step ends on a device-to-host copy)
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_families(torch, eng.step, 1)
    eng.run()
    check(all(len(eng.done[rid]) == DECODE_TOKENS for rid in rids), "decode chunk: a request came back short")
    if prof is None:
        print(f"[{tag}] decode chunk: the profiler recorded no device activity", flush=True)
        return {"device_ms_by_family": "not measured: the profiler recorded no device activity"}
    busy = prof["device_ms"] / wall_ms
    print(f"[{tag}] one decode chunk ({eng.decode_chunk} steps, {S} slots): device ms by kernel family "
          f"{({k: round(v, 2) for k, v in prof['device_ms_by_family'].items()})}; device busy "
          f"{prof['device_ms']:.2f} ms of the chunk's {wall_ms:.2f} ms unprofiled wall ({busy:.3f}; "
          f"{prof['busy_share']:.3f} of the profiled wall, which the profiler stretches to "
          f"{prof['profiled_wall_ms']:.2f} ms)", flush=True)
    return dict(prof, steps=eng.decode_chunk, wall_ms=wall_ms, busy_share_unprofiled=busy)


def int8_serve_profile(torch, Q) -> dict:
    """Where an int8 serve step's device time goes: the engine the ``--int8`` server
    builds (Llama-3-8B, all 32 layers, seeded random weights quantized to int8, 8
    slots, max_len 2048, paged KV), in this process. One decode chunk of a full
    batch (``decode_chunk_profile``), then one prefill of a 1000-token prompt
    (its 1024 bucket) after an unprofiled one, each under ``torch.profiler``:
    device ms by kernel family (``int8`` is B6) and the busy share. B6 must run
    in both."""
    import numpy as np

    from tony_tpu_torch.models import serving_http

    args = serving_http.parse_args(["--preset", "llama3-8b", "--int8", "--slots", str(S), "--max-len",
                                    str(MAXT), "--decode-chunk", "8"])
    with torch.no_grad():
        eng = serving_http.build_engine(args)
    eng.submit(list(range(1, 40)), 8)  # warm-up: first CUDA use of each path
    eng.run()
    Q.reset_launches()
    chunk = decode_chunk_profile(torch, eng, eng.cfg.vocab_size, tag="int8-serve")
    check(Q.launches["int8_matmul"] > 0, "int8 serve: the decode chunk never launched B6")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, eng.cfg.vocab_size, 1000).tolist() for _ in range(2)]
    eng.submit(prompts[0], 1)
    eng._stage_prefills(1)  # the 1024 bucket's first run, unprofiled
    eng.run()
    rid = eng.submit(prompts[1], 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill = profile_families(torch, lambda: eng._stage_prefills(1), 1)
    wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run()
    check(len(eng.done[rid]) == 1, f"int8 serve: the prefill request returned {eng.done[rid]}")
    if prefill is None:
        prefill = {"device_ms_by_family": "not measured: the profiler recorded no device activity"}
        print("[int8-serve] prefill: the profiler recorded no device activity", flush=True)
    else:
        print(f"[int8-serve] one prefill of a 1000-token prompt (bucket 1024): device ms by kernel family "
              f"{({k: round(v, 2) for k, v in prefill['device_ms_by_family'].items()})}; device busy "
              f"{prefill['device_ms']:.2f} ms of the profiled {wall_ms:.2f} ms wall "
              f"({prefill['busy_share']:.3f})", flush=True)
    rec = {"decode_chunk": chunk, "prefill_1024": prefill, "launches": dict(Q.launches)}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def moe_serve_phase(torch, mixtral, DA, MG) -> dict:
    """The in-process ``ContinuousBatcher`` (paged KV, page_len 256, 8 slots,
    max_len 2048, decode_chunk 8) at Mixtral-8x7B width cut to
    ``MOE_SERVE_LAYERS`` layers, with the traffic of the Llama serve runs:
    the mixed batch of ``serve_requests`` (prefill of more than 16 tokens
    through B7, decode through the all-expert products and B5) and the
    decode batch of ``decode_requests``. Every request returns its tokens,
    the identical greedy pair agrees, the shared prefix is a cache hit, and
    B7 and B5 were launched."""
    from tony_tpu_torch.models.serving import ContinuousBatcher

    cfg = mixtral.config_from_dict({"preset": "mixtral-8x7b", "n_layers": MOE_SERVE_LAYERS})
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        params = mixtral.init(torch.Generator(device="cuda").manual_seed(5), cfg, "cuda")
    weights_gib = torch.cuda.memory_allocated() / 2**30
    eng = ContinuousBatcher(params, cfg, num_slots=S, max_len=MAXT, kv="paged", page_len=PLEN,
                            decode_chunk=8)
    eng.submit(list(range(1, 40)), 8)  # warm-up: first CUDA use of each path
    eng.run()
    reqs = serve_requests(cfg.vocab_size)
    MG.reset_launches()
    DA.reset_launches()
    results, ttft, wall = engine_batch(torch, eng, reqs)
    for i, (rq, res) in enumerate(zip(reqs, results)):
        check(len(res) == rq["max_tokens"] and all(0 <= t < cfg.vocab_size for t in res),
              f"mixtral serve: request {i} ({len(rq['prompt_tokens'])} prompt tokens) returned {res}")
    check(results[2] == results[3], f"mixtral serve: identical greedy prompts disagree:\n"
                                    f"{results[2]}\n{results[3]}")
    check(eng.prefix_hit_tokens > 0, "mixtral serve: the shared prefix was never a cache hit")
    dreqs = decode_requests(cfg.vocab_size)
    dres, _, dwall = engine_batch(torch, eng, dreqs)
    check(all(len(r) == DECODE_TOKENS for r in dres), f"mixtral serve: decode batch returned {dres!r:.300}")
    launches = {**MG.launches, **DA.launches}
    check(launches["moe_fwd"] > 0 and launches["moe_bwd"] == 0 and launches["paged_decode_attention"] > 0,
          f"mixtral serve: launches {launches}")
    chunk = decode_chunk_profile(torch, eng, cfg.vocab_size)
    gen = sum(len(r) for r in results)
    rec = {
        "layers": MOE_SERVE_LAYERS, "params": cfg.num_params(), "weights_gib": weights_gib,
        "wall_s": wall, "tokens": gen, "tok_per_s": gen / wall, "ttft_stream_s": ttft,
        "decode_tok_per_s": len(dreqs) * DECODE_TOKENS / dwall, "decode_step_ms": dwall / DECODE_TOKENS * 1e3,
        "prefix_hit_tokens": eng.prefix_hit_tokens, "launches": launches,
        "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "card_memory_gib": torch.cuda.get_device_properties(0).total_memory / 2**30,
        "first_tokens": [r[0] for r in results], "decode_chunk": chunk,
    }
    print(f"[moe-serve] Mixtral-8x7B width, {MOE_SERVE_LAYERS} layers ({rec['params'] / 1e9:.2f} B params, "
          f"{weights_gib:.1f} GiB): {gen} tokens in {wall:.2f}s = {rec['tok_per_s']:.1f} tok/s, "
          f"TTFT(stream) {ttft:.3f}s; decode batch {rec['decode_tok_per_s']:.1f} tok/s "
          f"({rec['decode_step_ms']:.2f} ms/step); prefix_hit_tokens {eng.prefix_hit_tokens}; peak memory "
          f"{rec['max_memory_gib']:.1f} of {rec['card_memory_gib']:.1f} GiB; launches {launches}", flush=True)
    return rec


# -- BERT ------------------------------------------------------------------------

def bert_docs(n_docs: int, seed: int = 0) -> list:
    """``examples/bert/pack_ab.py``'s document stream: lengths uniform in
    [48, 512] (a mean of ~280 of a 512 row), token ids uniform in [1, 30000)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi = BERT_DOC_LEN
    return [rng.integers(1, 30_000, size=rng.integers(lo, hi + 1)).astype(np.int32) for _ in range(n_docs)]


def padded_rows(docs: list, T: int):
    """One document a row: (tokens, segment ids 1 on the document, 0 after)."""
    import numpy as np

    tok, seg = np.zeros((len(docs), T), np.int32), np.zeros((len(docs), T), np.int32)
    for i, d in enumerate(docs):
        tok[i, :len(d)], seg[i, :len(d)] = d[:T], 1
    return tok, seg


def masked_positions(rng, seg, m: int):
    """``pack_ab.py``'s: m mask positions a row drawn with replacement from
    the row's real (non-pad) positions, sorted."""
    import numpy as np

    pos = np.zeros((seg.shape[0], m), np.int32)
    for b in range(seg.shape[0]):
        pos[b] = rng.choice(np.flatnonzero(seg[b] != 0), size=m, replace=True)
    return np.sort(pos, axis=1)


def bert_gathered_batch(torch, tok, seg, seed: int = 1) -> dict:
    """A gathered-MLM batch on the card, M = round(0.15·T) ``masked_positions``
    a row."""
    import numpy as np

    pos = masked_positions(np.random.default_rng(seed), seg, max(1, round(tok.shape[1] * 0.15)))
    batch = {"tokens": torch.from_numpy(tok).cuda().long(), "segment_ids": torch.from_numpy(seg).cuda(),
             "masked_pos": torch.from_numpy(pos).cuda().long()}
    batch["masked_targets"] = torch.gather(batch["tokens"], 1, batch["masked_pos"])
    return batch


def bert_whole_step_check(torch, bert, A) -> dict:
    """``[bert-step]``: one ``loss_fn`` value and gradient through B1-B3 (BERT-
    base, 12 layers, bf16, remat as bench.py's recipe) against
    ``attn_impl="reference"`` on the same params, on two batches of
    B=8, T=512: the gathered layout (no segments) and a dense packed batch
    (``pack_sequences`` rows of the seeded documents, 15% of the real
    positions masked, padding never scored). A query head dropped by B1 must
    fail the limits the kernels pass."""
    import numpy as np
    from tony_tpu_torch.data.dataset import pack_sequences

    cfg = bert.config_from_dict(BENCH_RECIPES["bert"][1])
    params = bert.init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    names, tensors = zip(*_leaves(params))
    for t in tensors:
        t.requires_grad_(True)
    tok, seg = pack_sequences(bert_docs(40, seed=2), BERT_T)
    tok, seg = tok[:BERT_STEP_B], seg[:BERT_STEP_B]
    check(len(tok) == BERT_STEP_B and (seg == 0).any(), f"bert-step: {len(tok)} packed rows")
    rng = np.random.default_rng(3)
    targets = np.where((rng.random(tok.shape) < 0.15) & (seg != 0), tok, -100)
    batches = {
        "gathered": bert.synthetic_batch(torch.Generator(device="cuda").manual_seed(1), BERT_STEP_B, BERT_T, cfg),
        "dense_packed": {"tokens": torch.from_numpy(tok).cuda().long(), "segment_ids": torch.from_numpy(seg).cuda(),
                         "targets": torch.from_numpy(targets).cuda().long()},
    }

    def run(batch, impl):
        A.reset_launches()
        loss, aux = bert.loss_fn(params, batch, dataclasses.replace(cfg, attn_impl=impl))
        return loss.item(), int(aux["tokens"]), torch.autograd.grad(loss, tensors), dict(A.launches)

    out = {}
    for layout, batch in batches.items():
        lr, n, gr, nr = run(batch, "reference")
        check(not any(nr.values()), f"bert-step {layout}: the reference launched kernels {nr}")
        recs = {"loss_reference": lr, "targets": n}
        for variant, patch in (("kernels", None), ("fault_b1_head", ("flash_fwd", dropped_head_fwd(A)))):
            with mock.patch.object(A, *patch) if patch else contextlib.nullcontext():
                lk, _, gk, nk = run(batch, "auto")
            grad_rel = {k: ((a.float() - b.float()).norm() / b.float().norm()).item()
                        for k, a, b in zip(names, gk, gr)}
            del gk
            worst = max(grad_rel, key=grad_rel.get)
            rec = {"loss": lk, "loss_rel": abs(lk - lr) / abs(lr), "worst_leaf": worst,
                   "worst_grad_rel": grad_rel[worst], "grad_rel": grad_rel, "launches": nk}
            recs[variant] = rec
            print(f"[bert-step] {layout} {variant}: loss {lk:.6f} reference {lr:.6f} ({n} targets) rel "
                  f"{rec['loss_rel']:.2e} (tol {BERT_STEP_LOSS_REL}); worst grad leaf {worst} rel norm "
                  f"{grad_rel[worst]:.2e} (tol {BERT_STEP_GRAD_REL}); kernel launches {nk}", flush=True)
            check(nk == _expected_launches((A,), cfg.n_layers, 2),
                  f"bert-step {layout} {variant}: kernel launches {nk}")
        del gr
        k, f = recs["kernels"], recs["fault_b1_head"]
        check(math.isfinite(k["loss"]) and k["loss_rel"] <= BERT_STEP_LOSS_REL,
              f"bert-step {layout}: loss {k['loss']} vs {lr}")
        check(all(math.isfinite(x) and x <= BERT_STEP_GRAD_REL for x in k["grad_rel"].values()),
              f"bert-step {layout}: gradient relative norms {k['grad_rel']}")
        check(f["loss_rel"] > BERT_STEP_LOSS_REL or f["worst_grad_rel"] > BERT_STEP_GRAD_REL,
              f"bert-step {layout}: the limits pass a query head dropped by B1 (loss {f['loss_rel']}, "
              f"worst leaf {f['worst_grad_rel']})")
        out[layout] = recs
    return out


def bert_pack_line(rec: dict, card: str) -> str:
    pad, pk = rec["padded"], rec["packed"]
    return (f"[bert-pack] padded {pad['rows']} rows {pad['step_ms']:.1f} ms/step, {pad['content_tok_per_s']:.0f} "
            f"content tok/s; packed {pk['rows']} rows {pk['step_ms']:.1f} ms/step, {pk['content_tok_per_s']:.0f} "
            f"content tok/s; pack ratio {rec['pack_ratio']:.3f} ({rec['docs']} documents), content speedup "
            f"{rec['speedup']:.3f}x; {card}")


def bert_pack_phase(torch, bert, A, card: str) -> dict:
    """``[bert-pack]``, ``examples/bert/pack_ab.py`` in the port: the seeded
    document stream one document a row (padded) and first-fit packed by
    ``pack_sequences`` (rows cut to a multiple of 8), each a gathered-MLM
    batch (masks on real positions) through the train step at bench.py's
    bert configuration on a fresh state: ``BERT_PACK_WARMUP`` steps, then
    ``BERT_PACK_STEPS`` timed on the host clock around synchronised steps;
    content (non-pad) tokens/s of both arms, the pack ratio and B1-B3's
    launches (2L / L / L a step)."""
    from tony_tpu_torch.data.dataset import pack_sequences
    from tony_tpu_torch.train.trainer import OptimizerConfig, TrainState, make_train_step

    cfg = bert.config_from_dict(BENCH_RECIPES["bert"][1])
    docs = bert_docs(BERT_PACK_ROWS)
    tok_pk, seg_pk = pack_sequences(docs, BERT_T)
    keep = (len(tok_pk) // 8) * 8 or len(tok_pk)
    arms = {"padded": padded_rows(docs, BERT_T), "packed": (tok_pk[:keep], seg_pk[:keep])}
    out = {"docs": len(docs)}
    for arm, (tok, seg) in arms.items():
        batch = bert_gathered_batch(torch, tok, seg)
        opt = OptimizerConfig(warmup_steps=10, total_steps=1000).build()
        state = TrainState.create(bert.init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda"), opt)
        step_fn = make_train_step(lambda p, b: bert.loss_fn(p, b, cfg), opt)
        torch.cuda.reset_peak_memory_stats()
        for _ in range(BERT_PACK_WARMUP):
            state, m = step_fn(state, batch)
            float(m["loss"])
        A.reset_launches()
        t0 = time.perf_counter()
        losses = []
        for _ in range(BERT_PACK_STEPS):
            state, m = step_fn(state, batch)
            losses.append(m["loss"])
        losses = [float(x) for x in losses]  # synchronises the card before the clock is read
        dt = (time.perf_counter() - t0) / BERT_PACK_STEPS
        launches = dict(A.launches)
        check(all(math.isfinite(x) for x in losses), f"bert-pack {arm}: losses {losses}")
        want = _expected_launches((A,), cfg.n_layers, 2, BERT_PACK_STEPS)
        check(launches == want, f"bert-pack {arm}: launches {launches}, want {want}")
        real = int((seg != 0).sum())
        out[arm] = {"rows": len(tok), "real_tokens": real, "step_ms": dt * 1e3, "content_tok_per_s": real / dt,
                    "losses": losses, "launches": launches,
                    "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
        del state, step_fn, batch, opt, m
        gc.collect()
        torch.cuda.empty_cache()
    out["pack_ratio"] = out["padded"]["rows"] / out["packed"]["rows"]
    out["speedup"] = out["packed"]["content_tok_per_s"] / out["padded"]["content_tok_per_s"]
    print(bert_pack_line(out, card), flush=True)
    return out


# -- ResNet-50 and the MNIST MLP ------------------------------------------------

_STEP_LINE = re.compile(r"^step (\d+) loss=(\S+) acc=(\S+)$", re.M)


def mnist_phase(out_dir: Path) -> dict:
    """``[mnist]``: ``tony submit`` (framework pytorch, one worker) of ``python
    -m tony_tpu_torch.train.train_mnist`` on the card: the job must succeed,
    the worker's log name the CUDA device and show the steps of
    ``MNIST_LOG_STEPS``, each loss finite and within ``MNIST_LOSS_BAND`` of
    ln 10; prints the job's wall."""
    work = out_dir / "mnist"
    shutil.rmtree(work, ignore_errors=True)
    root = work / "tony"
    cmd = f"cd {ROOT} && PYTHONPATH={ROOT} {sys.executable} -m tony_tpu_torch.train.train_mnist"
    argv = [sys.executable, "-m", "tony_tpu.cli.main", "submit", "--executes", cmd,
            "--conf", "tony.worker.instances=1", "--conf", "tony.application.framework=pytorch"]
    env = dict(os.environ, TONY_ROOT=str(root), PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    try:
        sub = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        subprocess.run(["pkill", "-f", "tony_tpu.cluster"], check=False)  # the job's AM and executor
        raise SmokeFailure("mnist: tony submit did not finish in 300 s")
    wall = time.perf_counter() - t0
    out = sub.stdout + sub.stderr
    check(sub.returncode == 0 and "SUCCEEDED" in out, f"mnist: tony submit exited {sub.returncode}:\n{out[-4000:]}")
    apps = sorted(root.glob("application_*"))
    check(len(apps) == 1, f"mnist: applications {apps}")
    log = (apps[0] / "logs" / "worker_0" / "stdout.log").read_text()
    check("[train_mnist] device cuda" in log, f"mnist: the worker did not train on the card:\n{log[-2000:]}")
    steps = [(int(a), float(b), float(c)) for a, b, c in _STEP_LINE.findall(log)]
    check([x[0] for x in steps] == MNIST_LOG_STEPS, f"mnist: step lines {steps}")
    check(all(math.isfinite(x[1]) and abs(x[1] - math.log(10)) <= MNIST_LOSS_BAND for x in steps),
          f"mnist: losses {steps} not within {MNIST_LOSS_BAND} of ln 10")
    shutil.rmtree(work, ignore_errors=True)
    print(f"[mnist] tony submit of train_mnist (784-512-512-10, f32, 200 steps of 64) SUCCEEDED on cuda in "
          f"{wall:.1f} s; step/loss/accuracy {steps}", flush=True)
    return {"submit_wall_s": wall, "steps": steps}


def _rel_norm(got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return ((got - want).norm() / want.norm()).item()


def resnet_step_check(torch, resnet) -> dict:
    """``[resnet-step]``: ResNet-50 at full width (224², 1000 classes), B=4:
    the logits, loss, running statistics and every gradient leaf of f32 on
    the card (TF32 off) and of f32 on the CPU, each against f64 on the CPU
    from the same weights and batch; the card's error within
    ``RESNET_STEP_NOISE_X`` times the CPU's plus ``RESNET_STEP_FLOOR``. The
    stride-2 convolutions padded symmetrically (same shapes, wrong pixels)
    must fail; then the same weights in bf16 on the card."""
    F = torch.nn.functional
    cfg = resnet.config_from_dict({"preset": "resnet50", "dtype": "float32"})
    cfg64 = resnet.config_from_dict({"preset": "resnet50", "dtype": "float64"})
    params, state = resnet.init(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = resnet.synthetic_batch(torch.Generator().manual_seed(1), RESNET_STEP_B, cfg)

    def to(tree, dev, dt=None):
        return {k: to(v, dev, dt) if isinstance(v, dict) else
                v.to(dev, dtype=dt if dt and v.is_floating_point() else v.dtype) for k, v in tree.items()}

    def run(c, dev, dt=None):
        """(logits, loss, {name: running statistic or gradient}) of ``loss_fn``'s
        arithmetic (the mean of -log_softmax at the labels in f32, here in
        f64 for the reference); the running statistics stay f32 but there."""
        wide = torch.float64 if dt is torch.float64 else torch.float32
        p, s, b = to(params, dev, dt), to(state, dev, wide), to(batch, dev, dt)
        names, tensors = zip(*_leaves(p))
        for t in tensors:
            t.requires_grad_(True)
        logits, new_s = resnet.forward(p, s, b["image"], c)
        loss = F.cross_entropy(logits.to(wide), b["label"].long())
        grads = torch.autograd.grad(loss, tensors)
        return logits.detach(), loss.detach(), {**{f"state/{n}": v for n, v in _leaves(new_s)},
                                                **{f"grad/{n}": g for n, g in zip(names, grads)}}

    ref = run(cfg64, "cpu", torch.float64)

    def errors(got) -> dict:
        return {"logits": _rel_norm(got[0], ref[0]), "loss": _rel_norm(got[1], ref[1]),
                **{n: _rel_norm(v, ref[2][n]) for n, v in got[2].items()}}

    cpu = errors(run(cfg, "cpu"))
    limit = {n: RESNET_STEP_NOISE_X * e + RESNET_STEP_FLOOR for n, e in cpu.items()}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        card = errors(run(cfg, "cuda"))
        with mock.patch.object(resnet, "_conv", lambda x, w, stride: F.conv2d(
                x, w, stride=stride, padding=w.shape[-1] // 2)):
            fault = errors(run(cfg, "cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    over = {n: card[n] / limit[n] for n in card}
    worst = sorted(over, key=over.get, reverse=True)[:3]
    grads = [n for n in card if n.startswith("grad/")]
    print(f"[resnet-step] f32 against f64 (card / CPU): logits {card['logits']:.2e} / {cpu['logits']:.2e}, loss "
          f"{card['loss']:.2e} / {cpu['loss']:.2e}; gradient leaves {min(card[n] for n in grads):.2e} to "
          f"{max(card[n] for n in grads):.2e} / {min(cpu[n] for n in grads):.2e} to {max(cpu[n] for n in grads):.2e}; "
          f"nearest the limit ({RESNET_STEP_NOISE_X} x the CPU's + {RESNET_STEP_FLOOR}): "
          + ", ".join(f"{n} {card[n]:.2e} of {limit[n]:.2e}" for n in worst), flush=True)
    print(f"[resnet-step] symmetric padding planted: logits {fault['logits']:.2e}, loss {fault['loss']:.2e}, worst "
          f"gradient leaf {max(fault[n] for n in grads):.2e}", flush=True)
    check(all(math.isfinite(x) and x <= limit[n] for n, x in card.items()),
          f"resnet-step: beyond the CPU's f32 error: {[(n, card[n], limit[n]) for n in worst]}")
    check(fault["logits"] > limit["logits"], f"resnet-step: symmetric padding passes ({fault['logits']:.2e})")

    bf = resnet.config_from_dict("resnet50")
    logits, loss, out = run(bf, "cuda", torch.bfloat16)
    check(math.isfinite(loss.item()) and abs(loss.item() - math.log(bf.num_classes)) <= RESNET_BF16_LOSS_BAND,
          f"resnet-step: bf16 loss {loss.item()} not within {RESNET_BF16_LOSS_BAND} of ln 1000")
    check(all(torch.isfinite(v).all() for v in out.values()), "resnet-step: a bf16 gradient or statistic not finite")
    print(f"[resnet-step] bf16 on the card: loss {loss.item():.4f} (f64 {ref[1].item():.4f}, ln 1000 "
          f"{math.log(1000):.4f}); logits {_rel_norm(logits, ref[0]):.2e} from f64", flush=True)
    return {"card": card, "cpu": cpu, "fault_symmetric_pad": fault, "loss_f64": ref[1].item(),
            "loss_bf16": loss.item()}


def bench_resnet_phase(torch, card: str) -> dict:
    """``[bench-resnet]``: ``bench_resnet`` at ``resnet50``, B=``RESNET_BENCH_B``
    (its JSON line: images/s, ms/step, MFU on the JAX program's basis of 3 ×
    4.1 GFLOP an image), the peak memory of the run, then two more steps of
    a fresh bench state under ``torch.profiler``: device ms a step by kernel
    family and the busy share."""
    from tony_tpu_torch.models import resnet
    from tony_tpu_torch.train import bench_resnet

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = bench_resnet.run(["--preset", "resnet50", "--batch", str(RESNET_BENCH_B), "--steps",
                            str(RESNET_BENCH_STEPS), "--warmup", str(RESNET_BENCH_WARMUP)])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(rec["batch"] == RESNET_BENCH_B and rec["value"] > 0 and math.isfinite(rec["mfu"]), f"bench-resnet: {rec}")
    gc.collect()
    torch.cuda.empty_cache()
    step = bench_resnet.make_step(resnet.RESNET50, RESNET_BENCH_B, torch.device("cuda"))
    float(step())
    prof = profile_families(torch, step, 2)
    out = {**rec, "max_memory_gib": peak, "wall_s": wall}
    if prof:
        out.update(prof)
        fam = {k: round(v, 1) for k, v in prof["device_ms_by_family"].items()}
        print(f"[bench-resnet] device ms a step by kernel family {fam}, busy {prof['busy_share']:.3f} of the "
              "profiled wall", flush=True)
        for name, ms, n in prof["top_kernels"]:
            print(f"[bench-resnet]   {ms:8.1f} ms {n:5d}x  {name}", flush=True)
    else:
        out["device_ms_by_family"] = "not measured: the profiler recorded no device activity"
        print("[bench-resnet] the profiler recorded no device activity", flush=True)
    print(f"[bench-resnet] ResNet-50 bf16 224² B={RESNET_BENCH_B}: {rec['value']} images/s, {rec['step_time_ms']} "
          f"ms/step, MFU {rec['mfu']} (3 x 4.1 GFLOP an image, the JAX program's basis), peak memory {peak:.1f} GiB, "
          f"wall {wall:.1f}s; {card}", flush=True)
    return out


def resnet_train_phase(torch) -> dict:
    """``[resnet-train]``: ``train_resnet`` at ``resnet50`` (AdamW, the BN
    state through batch and metrics) for ``RESNET_TRAIN_STEPS`` steps of
    ``RESNET_TRAIN_B``: every loss finite, every running mean moved from 0,
    every running statistic finite."""
    from tony_tpu_torch.train import train_resnet

    t0 = time.perf_counter()
    res = train_resnet.run(["--preset", "resnet50", "--batch_size", str(RESNET_TRAIN_B), "--steps",
                            str(RESNET_TRAIN_STEPS), "--log_every", "1"])
    wall = time.perf_counter() - t0
    log = res["log"]
    check([x["step"] for x in log] == list(range(1, RESNET_TRAIN_STEPS + 1)) and
          all(math.isfinite(x["loss"]) for x in log), f"resnet-train: {log}")
    stats = dict(_leaves(res["bn_state"]))
    means = {n: v for n, v in stats.items() if n.endswith("/mean")}
    check(len(stats) == 106 and all(torch.isfinite(v).all() for v in stats.values()),
          f"resnet-train: {len(stats)} running statistics, or one not finite")
    still = [n for n, v in means.items() if not (v != 0).any()]
    check(not still, f"resnet-train: running means still 0: {still}")
    print(f"[resnet-train] ResNet-50 B={RESNET_TRAIN_B}, {RESNET_TRAIN_STEPS} steps: losses "
          f"{[round(x['loss'], 4) for x in log]}; all {len(means)} running means moved, all 106 statistics finite; "
          f"wall {wall:.1f}s", flush=True)
    return {"log": log, "wall_s": wall,
            "mean_abs_running_mean": {n: v.abs().mean().item() for n, v in means.items()}}


# -- Hugging Face checkpoints and the Mixtral gang ------------------------------

HF_LLAMA_LAYERS = 2    # Llama-3-8B widths, ~3.0 GB in bf16
HF_MIXTRAL_LAYERS = 1  # Mixtral-8x7B widths, ~3.4 GB in bf16
HF_SERVE_PROMPTS = (17, 300, 1000, 64)  # prompt lengths of the [hf-serve] requests, 32 tokens each
HF_SERVE_ARGS = ["--kv", "paged", "--slots", str(S), "--max-len", str(MAXT), "--decode-chunk", "8"]
MIXTRAL_GANG_STEPS, MIXTRAL_GANG_T = 3, 2048
#: the config fields a checkpoint's config.json carries (the rest are training choices)
HF_CONFIG_FIELDS = ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff", "max_seq", "rope_theta",
                    "norm_eps", "dtype", "sliding_window", "rope_scaling", "num_experts", "top_k")


def hf_config(cfg) -> dict:
    """The ``config.json`` of an HF checkpoint of the port's ``cfg``."""
    d = {"model_type": "llama", "architectures": ["LlamaForCausalLM"], "vocab_size": cfg.vocab_size,
         "hidden_size": cfg.d_model, "intermediate_size": cfg.d_ff, "num_hidden_layers": cfg.n_layers,
         "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
         "head_dim": cfg.head_dim, "max_position_embeddings": cfg.max_seq, "rope_theta": cfg.rope_theta,
         "rms_norm_eps": cfg.norm_eps, "rope_scaling": None, "attention_bias": False, "mlp_bias": False,
         "tie_word_embeddings": False, "torch_dtype": cfg.dtype}
    if hasattr(cfg, "num_experts"):
        d.update(model_type="mixtral", architectures=["MixtralForCausalLM"], sliding_window=None,
                 num_local_experts=cfg.num_experts, num_experts_per_tok=cfg.top_k)
    return d


def hf_state_dicts(cfg, params, fault: bool = False) -> list[dict]:
    """The port's tree under HF's names in HF's ``[out, in]`` layout (the
    inverse of ``convert``'s map), on the CPU, as one state dict a shard:
    the embedding, each layer, then the final norm and the head. ``fault``
    writes layer 0's ``o_proj`` untransposed: square, so its shape passes."""
    def cpu(t, transpose=True):
        return (t.T if transpose else t).contiguous().cpu()

    lp = params["layers"]
    shards = [{"model.embed_tokens.weight": cpu(params["embed"], False)}]
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        sd = {pre + "input_layernorm.weight": cpu(lp["attn_norm"][i], False),
              pre + "post_attention_layernorm.weight": cpu(lp["mlp_norm"][i], False)}
        for name, key in (("q_proj", "wq"), ("k_proj", "wk"), ("v_proj", "wv"), ("o_proj", "wo")):
            sd[pre + f"self_attn.{name}.weight"] = cpu(lp[key][i], not (fault and i == 0 and key == "wo"))
        if "router" in lp:
            sd[pre + "block_sparse_moe.gate.weight"] = cpu(lp["router"][i])  # f32, as the port keeps it
            for e in range(cfg.num_experts):
                for w, key in (("w1", "we_gate"), ("w3", "we_up"), ("w2", "we_down")):
                    sd[pre + f"block_sparse_moe.experts.{e}.{w}.weight"] = cpu(lp[key][i, e])
        else:
            for name, key in (("gate_proj", "w_gate"), ("up_proj", "w_up"), ("down_proj", "w_down")):
                sd[pre + f"mlp.{name}.weight"] = cpu(lp[key][i])
        shards.append(sd)
    shards.append({"model.norm.weight": cpu(params["final_norm"], False), "lm_head.weight": cpu(params["lm_head"])})
    return shards


def write_safetensors(path: Path, tensors: dict) -> None:
    """The safetensors format: an 8-byte little-endian header length, the
    JSON header (``dtype``, ``shape``, ``data_offsets``), the raw bytes."""
    import struct

    import torch

    names = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, at = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [at, at + n]}
        at += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            f.write(t.view(-1).view(torch.uint8).numpy())


def write_hf_dir(d: Path, cfg, shards: list[dict], layout: str) -> int:
    """An HF checkpoint directory: ``config.json`` and the weights as
    safetensors shards with their index (``layout`` "safetensors") or one
    ``pytorch_model.bin`` ("bin"). Returns the weight files' bytes."""
    import torch

    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps(hf_config(cfg)))
    if layout == "bin":
        torch.save({k: v for sd in shards for k, v in sd.items()}, d / "pytorch_model.bin")
        return (d / "pytorch_model.bin").stat().st_size
    weight_map = {}
    for j, sd in enumerate(shards):
        name = f"model-{j + 1:05d}-of-{len(shards):05d}.safetensors"
        write_safetensors(d / name, sd)
        weight_map.update(dict.fromkeys(sd, name))
    size = sum((d / f).stat().st_size for f in set(weight_map.values()))
    (d / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": size}, "weight_map": weight_map}))
    return size


def tree_mismatches(torch, got: dict, want: dict) -> list[str]:
    """The leaves of ``got`` that are not ``want``'s bit for bit (or differ in
    name, shape or dtype)."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    bad = sorted(g.keys() ^ w.keys())
    for name in sorted(g.keys() & w.keys()):
        a, b = g[name], w[name]
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            bad.append(name)
    return bad


def hf_load_phase(torch, llama, mixtral, out_dir: Path) -> tuple[dict, dict]:
    """``[hf-load]``: two HF checkpoint directories written here from the
    port's seeded bf16 trees through ``hf_state_dicts``: Llama-3-8B widths cut
    to ``HF_LLAMA_LAYERS`` layers as safetensors shards with their index, and
    Mixtral-8x7B widths cut to ``HF_MIXTRAL_LAYERS`` as ``pytorch_model.bin``.
    Each loads onto the card through ``convert.load_hf_dir`` with every leaf
    the source's bit for bit and the source's ``HF_CONFIG_FIELDS``; a third directory
    (layer 0's ``o_proj`` written untransposed, its other shards the Llama
    directory's) must fail that check on ``layers/wo`` alone. Prints each
    load's seconds and GB/s (the files were just written: a warm read).
    Returns the record and the directories with their source trees."""
    from tony_tpu_torch.models.convert import load_hf_dir

    work = out_dir / "hf"
    shutil.rmtree(work, ignore_errors=True)
    with torch.no_grad():
        lcfg = llama.config_from_dict({"preset": "llama3-8b", "n_layers": HF_LLAMA_LAYERS})
        mcfg = mixtral.config_from_dict({"preset": "mixtral-8x7b", "n_layers": HF_MIXTRAL_LAYERS})
        sources = {"llama": (lcfg, llama.init(torch.Generator(device="cuda").manual_seed(11), lcfg, "cuda")),
                   "mixtral": (mcfg, mixtral.init(torch.Generator(device="cuda").manual_seed(12), mcfg, "cuda"))}
    dirs = {"llama": work / "llama", "mixtral": work / "mixtral", "fault": work / "llama_o_proj_untransposed"}
    sizes, write_s = {}, {}
    for name, layout in (("llama", "safetensors"), ("mixtral", "bin")):
        cfg, params = sources[name]
        t0 = time.perf_counter()
        sizes[name] = write_hf_dir(dirs[name], cfg, hf_state_dicts(cfg, params), layout)
        write_s[name] = time.perf_counter() - t0
    cfg, params = sources["llama"]
    shutil.copytree(dirs["llama"], dirs["fault"], copy_function=os.link)  # the same shards, hard-linked
    shard = dirs["fault"] / f"model-00002-of-{cfg.n_layers + 2:05d}.safetensors"
    shard.unlink()
    write_safetensors(shard, hf_state_dicts(cfg, params, fault=True)[1])
    sizes["fault"] = sizes["llama"]
    rec = {}
    for name in ("llama", "mixtral", "fault"):
        cfg, params = sources["mixtral" if name == "mixtral" else "llama"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, got_cfg = load_hf_dir(dirs[name], "cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        bad = tree_mismatches(torch, got, params)
        del got
        if name == "fault":
            check(bad == ["layers/wo"], f"hf-load: the untransposed o_proj was not caught alone: {bad}")
        else:
            check(not bad, f"hf-load: {name}: leaves unlike the source: {bad}")
            arch = [f for f in HF_CONFIG_FIELDS if hasattr(cfg, f)]
            check(all(getattr(got_cfg, f) == getattr(cfg, f) for f in arch),
                  f"hf-load: {name}: config {got_cfg} is not the source's {cfg} in {arch}")
        rec[name] = {"bytes": sizes[name], "write_s": write_s.get(name), "load_s": load_s,
                     "load_gb_per_s": sizes[name] / load_s / 1e9, "mismatched": bad}
        print(f"[hf-load] {name}: {sizes[name] / 1e9:.2f} GB ({'pytorch_model.bin' if name == 'mixtral' else 'safetensors shards'}"
              f"{', written in %.1f s' % write_s[name] if name in write_s else ''}) loaded onto the card in "
              f"{load_s:.2f} s = {rec[name]['load_gb_per_s']:.2f} GB/s (warm page cache); "
              f"{'mismatched leaves ' + str(bad) + ' (planted, must fail)' if bad else 'every leaf the source bit for bit'}",
              flush=True)
    return rec, {"dirs": dirs, "sources": sources}


def hf_requests(vocab: int) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(21)
    return [rng.integers(1, vocab, n).tolist() for n in HF_SERVE_PROMPTS]


def engine_one_at_a_time(eng, prompts: list, max_tokens: int = 32) -> list:
    """Each prompt alone through the in-process engine, to its end."""
    out = []
    for p in prompts:
        rid = eng.submit(p, max_tokens)
        eng.run()
        out.append(eng.done[rid])
    return out


def hf_serve_phase(torch, Q, DA, MG, hf: dict, out_dir: Path) -> dict:
    """``[hf-serve]``: ``python -m tony_tpu_torch.models.serving_http --hf
    <llama dir> --int8 --kv paged`` (B5, B6): ``HF_SERVE_PROMPTS`` sent one
    at a time, greedy, each answer equal to that of an in-process
    ``ContinuousBatcher`` with the same settings on the source tree quantized
    the same way, also one at a time; the server's launches from its
    ``/stats``; SIGTERM exits 0. Then the Mixtral directory through
    ``build_engine(--hf)`` in this process (B7 in its prefills; launches set
    to 0 just before) with the tokens of the engine on the source tree."""
    from tony_tpu_torch.models import serving_http

    lcfg, lparams = hf["sources"]["llama"]
    prompts = hf_requests(lcfg.vocab_size)
    url_file = out_dir / "hf-serve.url"
    url_file.unlink(missing_ok=True)
    logf = open(out_dir / "hf-serve.log", "w")
    argv = ["--hf", str(hf["dirs"]["llama"]), "--int8", *HF_SERVE_ARGS]
    proc = subprocess.Popen([sys.executable, "-m", "tony_tpu_torch.models.serving_http", *argv,
                             "--url-file", str(url_file)], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                            stdout=logf, stderr=subprocess.STDOUT)
    t0 = time.perf_counter()
    try:
        deadline = time.time() + 300
        while not url_file.exists():
            if proc.poll() is not None or time.time() > deadline:
                logf.flush()
                raise SmokeFailure(f"hf-serve: server did not come up (rc={proc.poll()}); log:\n"
                                   + (out_dir / "hf-serve.log").read_text()[-4000:])
            time.sleep(0.5)
        startup_s = time.perf_counter() - t0
        url = url_file.read_text()
        served = []
        for p in prompts:
            with _post(url + "/v1/completions", {"prompt_tokens": p, "max_tokens": 32}) as r:
                served.append(json.load(r)["tokens"])
        st = _get(url + "/stats")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 0, f"hf-serve: SIGTERM exit code {rc}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        logf.close()
    args = serving_http.parse_args(HF_SERVE_ARGS)
    with torch.no_grad():
        eng = serving_http.engine_for(Q.quantize_tree(lparams)[0], lcfg, args, torch.device("cuda"))
        want = engine_one_at_a_time(eng, prompts)
    del eng
    check(all(len(t) == 32 for t in served), f"hf-serve: short answers {[len(t) for t in served]}")
    check(served == want, "hf-serve: the --hf --int8 server's tokens differ from the engine on the source "
                          f"tree:\n{served}\n{want}")
    launches = st["kernel_launches"]
    check(launches["paged_decode_attention"] > 0 and launches["int8_matmul"] > 0,
          f"hf-serve: the server's launches {launches}")
    mcfg, mparams = hf["sources"]["mixtral"]
    mprompts = hf_requests(mcfg.vocab_size)
    with torch.no_grad():
        eng = serving_http.build_engine(serving_http.parse_args(["--hf", str(hf["dirs"]["mixtral"]), *HF_SERVE_ARGS]))
        MG.reset_launches()
        mixtral_tokens = engine_one_at_a_time(eng, mprompts)
        moe_launches = dict(MG.launches)
        del eng
        want_m = engine_one_at_a_time(serving_http.engine_for(mparams, mcfg, args, torch.device("cuda")), mprompts)
    check(moe_launches["moe_fwd"] > 0 and moe_launches["moe_bwd"] == 0,
          f"hf-serve: the Mixtral engine's MoE launches {moe_launches}")
    check(mixtral_tokens == want_m, f"hf-serve: the Mixtral directory's tokens differ from the source tree's:\n"
                                    f"{mixtral_tokens}\n{want_m}")
    shutil.rmtree(out_dir / "hf", ignore_errors=True)
    rec = {"startup_s": startup_s, "prompts": list(HF_SERVE_PROMPTS), "tokens": served, "launches": launches,
           "mixtral_tokens": mixtral_tokens, "mixtral_launches": moe_launches}
    print(f"[hf-serve] serving_http --hf (Llama-3-8B widths, {lcfg.n_layers} layers) --int8 --kv paged: up in "
          f"{startup_s:.1f} s; {len(prompts)} greedy requests one at a time, tokens equal to the engine on the "
          f"source tree; launches {launches}; Mixtral directory ({mcfg.n_layers} layer) in process: tokens "
          f"equal to the source tree's, launches {moe_launches}", flush=True)
    return rec


_LAUNCHES_LINE = re.compile(r"^\[train\] kernel launches (\{.*\})$", re.M)


def mixtral_gang_phase(out_dir: Path) -> dict:
    """``[mixtral-gang]``: ``tony submit`` (framework pytorch, one worker) of
    ``python -m tony_tpu_torch.train.pretrain_mixtral`` at Mixtral-8x7B
    width cut to 1 layer (bf16, remat "full"), B=1, T=2048, 3 steps: the job
    must succeed, every step line be finite with its ``moe_*`` metrics, the
    first loss within 1.5 of ln V, and the worker's kernel launches (its
    ``[train] kernel launches`` line) B1 and B7 2·L·steps, B2, B3 and B8
    L·steps. One rank: more than one needs more than one card."""
    work = out_dir / "mixtral_gang"
    shutil.rmtree(work, ignore_errors=True)
    root = work / "tony"
    run = ["--preset", "mixtral-8x7b", "--n_layers", "1", "--steps", str(MIXTRAL_GANG_STEPS), "--batch_size", "1",
           "--seq_len", str(MIXTRAL_GANG_T), "--log_every", "1", "--warmup_steps", "1"]
    cmd = f"cd {ROOT} && PYTHONPATH={ROOT} {sys.executable} -m tony_tpu_torch.train.pretrain_mixtral {' '.join(run)}"
    argv = [sys.executable, "-m", "tony_tpu.cli.main", "submit", "--executes", cmd,
            "--conf", "tony.worker.instances=1", "--conf", "tony.application.framework=pytorch"]
    env = dict(os.environ, TONY_ROOT=str(root), PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    try:
        sub = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        subprocess.run(["pkill", "-f", "tony_tpu.cluster"], check=False)  # the job's AM and executor
        raise SmokeFailure("mixtral-gang: tony submit did not finish in 300 s")
    wall = time.perf_counter() - t0
    out = sub.stdout + sub.stderr
    check(sub.returncode == 0 and "SUCCEEDED" in out,
          f"mixtral-gang: tony submit exited {sub.returncode}:\n{out[-4000:]}")
    apps = sorted(root.glob("application_*"))
    check(len(apps) == 1, f"mixtral-gang: applications {apps}")
    log = (apps[0] / "logs" / "worker_0" / "stdout.log").read_text()
    steps = _step_lines(log)
    check(sorted(steps) == list(range(1, MIXTRAL_GANG_STEPS + 1)), f"mixtral-gang: steps {sorted(steps)}:\n{log[-3000:]}")
    keys = ("loss", "grad_norm", "moe_balance_loss", "moe_z_loss", "moe_dropped_frac")
    for rec in steps.values():
        check(all(k in rec and math.isfinite(rec[k]) for k in keys), f"mixtral-gang: step line {rec}")
    V = 32_000
    check(abs(steps[1]["loss"] - math.log(V)) <= 1.5,
          f"mixtral-gang: first loss {steps[1]['loss']} not within 1.5 of ln(V) {math.log(V):.2f}")
    m = _LAUNCHES_LINE.search(log)
    check(m is not None, f"mixtral-gang: no kernel launches line in the worker's log:\n{log[-3000:]}")
    launches = json.loads(m.group(1))
    L, n = 1, MIXTRAL_GANG_STEPS
    want = {"flash_fwd": 2 * L * n, "flash_bwd_dq": L * n, "flash_bwd_dkv": L * n, "moe_fwd": 2 * L * n,
            "moe_bwd": L * n}
    check({k: launches.get(k) for k in want} == want, f"mixtral-gang: worker launches {launches}, want {want}")
    shutil.rmtree(work, ignore_errors=True)
    step_ms = [steps[i]["step_time_ms"] for i in sorted(steps)]
    print(f"[mixtral-gang] tony submit of pretrain_mixtral (Mixtral-8x7B width, 1 layer, bf16, B=1 T={MIXTRAL_GANG_T}, "
          f"{n} steps) SUCCEEDED in {wall:.1f} s; losses {[steps[i]['loss'] for i in sorted(steps)]}, balance "
          f"{[round(steps[i]['moe_balance_loss'], 6) for i in sorted(steps)]}, step ms {step_ms}; worker launches "
          f"{launches}", flush=True)
    return {"submit_wall_s": wall, "steps": [steps[i] for i in sorted(steps)], "launches": launches}


# [fsdp]: a gang of FSDP_RANKS processes on the one card, on the mesh's fsdp
# axis, over gloo: torch 2.11's gloo carries all_gather_into_tensor,
# reduce_scatter_tensor, all_reduce and a torch.distributed.checkpoint save
# and load on CUDA tensors (``python -m tony_tpu_torch.parallel.gloo_cuda_probe``
# on an H100), and nccl refuses two ranks on one card, so the phase's form
# rests on this recorded finding
FSDP_BACKEND = "gloo"
FSDP_RANKS, FSDP_STEPS, FSDP_SAVE_EVERY = 2, 3, 2
FSDP_FAULT_RANK = 1
#: the sound run's depth: llama-1b cut to 4 of its 16 layers, which pays for
#: part of the model-axis and context-gang phases' seconds
FSDP_LAYERS = 4
#: the planted faults' runs: one step at the preset cut to this depth (the
#: embedding and the head, most of llama-1b's gloo traffic, stay whole)
FSDP_FAULT_LAYERS = 2
#: the gang's loss and grad norm of each step against one process's on the
#: global batch (the blocks' gradients summed over the ranks in f32, the
#: whole batch's in one product: a few bf16 ulps); a rank whose gradients
#: skip the reduce-scatter holds its own half of them, which moves the global
#: norm of the first step by tens of percent
FSDP_REL = GANG_LOSS_REL
#: each rank's blocks of the last step's parameters and moments against the
#: same blocks of one process's, ‖a − b‖ / ‖b‖ per block: bf16 gradients
#: summed in another order, through Adam's normalised update and the bf16
#: rounding of the stored values. The sound run on an H100 read at worst
#: 6.65e-4 (params), 1.44e-2 (mu), 1.38e-2 (nu): the limit is 3.5x the
#: worst; a rank that skips its moment update keeps zero moments, 1.0 on
#: each of its blocks
FSDP_STATE_REL = 5e-2


def fingerprint(torch, t) -> list:
    """Two integer sums of a tensor's bits (its words as int64, plain and
    weighted by position mod 65521): equal bits give equal sums."""
    w = t.detach().contiguous().view(-1)
    bits = w.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[w.element_size()]).to(torch.int64)
    idx = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return [int(bits.sum()), int((bits * idx).sum())]


def skip_reduce_scatter(collectives, rank: int) -> None:
    """A planted fault: this rank's gradient blocks skip the reduce-scatter
    (each keeps its own block of its own gradient); the collective still
    runs, so its peer is not left waiting."""
    real = collectives._scatter

    def own_block(x, group, dim):
        real(x, group, dim)
        return x.chunk(FSDP_RANKS, dim)[rank].contiguous()

    collectives._scatter = own_block


def skip_moment_update(trainer) -> None:
    """A planted fault: this rank's AdamW keeps its moments as they were (the
    update itself reads the new ones, so the parameters move as they should)."""
    real = trainer.AdamW.update

    def update(self, params, grads, state, norm):
        kept = {part: {n: t.clone() for n, t in state[part].items()} for part in ("mu", "nu")}
        real(self, params, grads, state, norm)
        for part, tree in kept.items():
            for n, t in tree.items():
                state[part][n].copy_(t)

    trainer.AdamW.update = update


def hold_final_state(trainer) -> tuple:
    """While installed, the AdamW updates of this process leave their
    parameters and moments (the live tensors) in the dict returned; the
    function returned uninstalls it."""
    held, real = {}, trainer.AdamW.update

    def update(self, params, grads, state, norm):
        real(self, params, grads, state, norm)
        held.update(params=dict(_leaves(params)), mu=state["mu"], nu=state["nu"])

    trainer.AdamW.update = update
    return held, lambda: setattr(trainer.AdamW, "update", real)


def fsdp_rank(spec_json: str) -> None:
    """One rank of the ``[fsdp]`` gang (``RANK`` in the env): ``run_lm_training``
    three times, each in a gloo group of its own (a file store under the
    spec's directory), each step report's loss and grad norm and the rank's
    state bytes recorded: "ok" with checkpoints (the fingerprint of each
    block the rank hands each save, and its shape), then the planted faults'
    runs, where rank ``FSDP_FAULT_RANK`` skips the reduce-scatter
    ("fault") or its moment update ("moments", saved). Writes
    ``rank<r>.json`` there."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from tony_tpu_torch.models import llama
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.parallel import collectives
    from tony_tpu_torch.train import checkpoint as C
    from tony_tpu_torch.train import trainer
    from tony_tpu_torch.train.loop import LoopConfig, run_lm_training

    spec = json.loads(spec_json)
    rank, work = int(os.environ["RANK"]), Path(spec["dir"])
    cuda = spec["device"] == "cuda"
    real_save, real_scatter, real_update = C.CheckpointManager.save, collectives._scatter, trainer.AdamW.update
    out = {}
    for run in ("ok", "fault", "moments"):
        saves: dict = {}

        def save(self, step, state, force=False):
            local = {name: t.to_local() if hasattr(t, "to_local") else t for name, t in _leaves(state)}
            saves[step] = {name: {"shape": list(t.shape), "fp": fingerprint(torch, t)}
                           for name, t in local.items() if hasattr(t, "shape")}
            return real_save(self, step, state, force=force)

        if cuda:
            torch.cuda.set_device(0)
            torch.cuda.reset_peak_memory_stats()
        dist.init_process_group(FSDP_BACKEND, init_method=f"file://{work / ('store-' + run)}",
                                world_size=FSDP_RANKS, rank=rank)
        C.CheckpointManager.save = save
        if run == "fault" and rank == FSDP_FAULT_RANK:
            skip_reduce_scatter(collectives, rank)
        if run == "moments" and rank == FSDP_FAULT_RANK:
            skip_moment_update(trainer)
        A.reset_launches()
        try:
            cfg = llama.config_from_dict(spec["cfg"] if run == "ok" else spec["fault_cfg"])
            res = run_lm_training(llama, cfg, LoopConfig(**spec[run]))  # leaves the group at its end
        finally:
            C.CheckpointManager.save, collectives._scatter, trainer.AdamW.update = (real_save, real_scatter,
                                                                                    real_update)
        out[run] = {"log": res["log"], "launches": dict(A.launches), "saves": saves,
                    "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    (work / f"rank{rank}.json").write_text(json.dumps(out))


def run_gang(work: Path, spec: dict, entry: str, n: int, tag: str, timeout: float = 600) -> list:
    """Run ``n`` ranks of ``chip_smoke.<entry>(spec)`` as processes (``RANK``
    in the env, one intra-op thread each), all waited for (killed past
    ``timeout``); each rank's record, ``rank<r>.json`` under ``work``."""
    spec = json.dumps(spec)
    procs = []
    for rank in range(n):
        env = dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(rank), WORLD_SIZE=str(n),
                   LOCAL_RANK="0", OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", f"import chip_smoke; chip_smoke.{entry}({spec!r})"],
                                      cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    except subprocess.TimeoutExpired:
        outs = None
    finally:
        for p in procs:  # a rank left waiting on a collective
            if p.poll() is None:
                p.kill()
                p.wait()
    check(outs is not None, f"{tag}: the gang did not finish in {timeout:.0f} s")
    for rank, (p, text) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{tag}: rank {rank} exited {p.returncode}:\n{text[-4000:]}")
    return [json.loads((work / f"rank{r}.json").read_text()) for r in range(n)]


def fsdp_gang(work: Path, cfg: dict, fault_cfg: dict, loop: dict, device: str, timeout: float = 600) -> list:
    """Run the ``[fsdp]`` gang's ranks (``fsdp_rank``) as processes, all
    waited for (killed past ``timeout``); each rank's record."""
    work = work.resolve()  # the ranks' file store takes an absolute path
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ok = dict(loop, steps=FSDP_STEPS, checkpoint_dir=str(work / "ckpt"), checkpoint_every=FSDP_SAVE_EVERY,
              device=device)
    spec = {"dir": str(work), "cfg": cfg, "fault_cfg": fault_cfg, "device": device, "ok": ok,
            "fault": dict(loop, steps=1, device=device),
            "moments": dict(loop, steps=1, device=device, checkpoint_dir=str(work / "ckpt-moments"))}
    return run_gang(work, spec, "fsdp_rank", FSDP_RANKS, "fsdp", timeout)


def fsdp_check(ranks: list, one: list, run: str = "ok", tag: str = "fsdp",
               keys: tuple = ("loss", "grad_norm")) -> float:
    """Every rank's step reports of ``run`` against one process's on the
    global batch: the same steps, each of ``keys`` (the loss and grad norm)
    within ``FSDP_REL`` relative. Returns the worst. ``tag`` names the phase."""
    worst = 0.0
    want = {x["step"]: x for x in one}
    for rank, rec in enumerate(ranks):
        got = {x["step"]: x for x in rec[run]["log"]}
        check(set(got) <= set(want) and got, f"{tag}: rank {rank} steps {sorted(got)}, one process {sorted(want)}")
        for s, x in got.items():
            for k in keys:
                err = abs(x[k] - want[s][k]) / abs(want[s][k])
                worst = max(worst, err)
                check(err <= FSDP_REL, f"{tag}: rank {rank} ({run}) step {s} {k} {x[k]} against one process's "
                                       f"{want[s][k]}: {err:.2e} > {FSDP_REL:.0e}")
    return worst


def fsdp_blocks(torch, ranks: list, whole: dict, step: int, tag: str = "fsdp", run: str = "ok",
                index=lambda rank: rank) -> int:
    """The blocks each rank handed its save of ``step`` in ``run`` against
    the same blocks of ``whole`` (a one-process restore's tree), bit for
    bit; each split leaf's blocks together its whole bytes (one axis of
    ``FSDP_RANKS`` splits it: rank r's block is block ``index(r)``).
    Returns the leaves split."""
    split = 0
    for name, t in _leaves(whole):
        if not hasattr(t, "shape"):
            continue
        shapes = [rec[run]["saves"][str(step)][name]["shape"] for rec in ranks]
        dims = [d for d in range(t.ndim) if shapes[0][d] != t.shape[d]]
        check(len(dims) <= 1 and all(s == shapes[0] for s in shapes),
              f"{tag}: {name} blocks {shapes} of {list(t.shape)}")
        if dims:
            split += 1
            check(shapes[0][dims[0]] * FSDP_RANKS == t.shape[dims[0]],
                  f"{tag}: {name} blocks {shapes} of {list(t.shape)}")
        for rank, rec in enumerate(ranks):
            block = t.chunk(FSDP_RANKS, dims[0])[index(rank)] if dims else t
            check(rec[run]["saves"][str(step)][name]["fp"] == fingerprint(torch, block),
                  f"{tag}: rank {rank}'s block of {name} at step {step} is not the one-process restore's")
    return split


def fsdp_state_check(torch, gang: dict, one: dict, saved: dict, what: str, tag: str = "fsdp",
                     leaves: dict | None = None) -> dict:
    """Each rank's blocks of the gang's parameters and moments (``gang``: a
    whole state restored from the ranks' save) against the same blocks of
    one process's (``one``: {"params"|"mu"|"nu": {leaf: tensor}}), each
    within ``FSDP_STATE_REL`` as ‖a − b‖ / ‖b‖ in f32 (``saved``: the
    shapes a rank handed that save, by state name, which give the dim a
    leaf is split on). Returns the worst of each part; ``leaves``, when
    given, receives the leaf that read it."""
    worst = {}
    for part in ("params", "mu", "nu"):
        mine = dict(_leaves(gang["params"] if part == "params" else gang["opt_state"][part]))
        worst[part] = 0.0
        for name, ref in one[part].items():
            block = saved[f"params/{name}"]["shape"]
            d = next((i for i, n in enumerate(block) if n != ref.shape[i]), None)
            for rank in range(FSDP_RANKS if d is not None else 1):
                a, b = (t.detach().chunk(FSDP_RANKS, d)[rank] if d is not None else t.detach()
                        for t in (mine[name], ref))
                b = b.float()
                err = float((a.float() - b).norm() / b.norm().clamp_min(1e-30))
                if leaves is not None and err >= worst[part]:
                    leaves[part] = name
                worst[part] = max(worst[part], err)
                check(err <= FSDP_STATE_REL, f"{tag}: {what} rank {rank}'s block of {part}/{name}: "
                                             f"{err:.2e} > {FSDP_STATE_REL:.0e} from one process's")
    return worst


def fsdp_line(rec: dict, card: str) -> str:
    """The ``[fsdp]`` report line."""
    state = ", ".join(f"{k} {v:.2e}" for k, v in rec["state_rel"].items())
    return (f"[fsdp] {FSDP_RANKS} ranks on one card over {FSDP_BACKEND}, {rec['preset']} B={rec['batch']} "
            f"T={rec['seq_len']}, fsdp {FSDP_RANKS}: losses {rec['losses']} (one process {rec['one_losses']}, worst "
            f"rel {rec['worst_rel']:.2e}); step {rec['restored_step']} blocks against one process's, worst "
            f"{state} (limit {FSDP_STATE_REL:.0e}); per rank params {rec['param_bytes'] / 1e9:.3f} GB + moments "
            f"{rec['opt_bytes'] / 1e9:.3f} GB of {rec['whole_bytes'] / 1e9:.3f} GB whole ({rec['split_leaves']} "
            f"leaves split), peak {[round(b / 2**30, 2) for b in rec['peak_bytes']]} GiB (one process "
            f"{rec['one_peak_bytes'] / 2**30:.2f} GiB), ms/step {rec['step_ms']} (one process "
            f"{rec['one_step_ms']}); step {rec['restored_step']} restored into one process bit for bit in "
            f"{rec['restore_s']:.1f} s; planted faults at {FSDP_FAULT_LAYERS} layers, rank {FSDP_FAULT_RANK} "
            f"skips the reduce-scatter: grad norm {rec['fault_grad_norm']} vs {rec['fault_one_grad_norm']}, failed; "
            f"skips its moment update: {rec['moments_fault']}, failed; launches per rank {rec['launches']}; {card}")


def fsdp_phase(torch, llama, A, out_dir: Path, card: str, cfg: dict | None = None, device: str = "cuda") -> dict:
    """``[fsdp]``: the gang of ``FSDP_RANKS`` on the card at the ``llama-1b``
    preset cut to ``FSDP_LAYERS`` layers (bf16, remat "full", the gang
    phase's B=8, T=2048; ``cfg`` and ``device`` another model and device),
    ``MeshSpec.auto``'s fill (fsdp 2): ``FSDP_STEPS`` steps through
    ``run_lm_training`` with asynchronous sharded saves after step
    ``FSDP_SAVE_EVERY`` and at the end, then the planted faults' steps at
    ``FSDP_FAULT_LAYERS`` layers. Each rank's losses and grad norms must be
    one process's on the global batch (``run_lm_training`` here, B1-B3
    counted), each rank must hold half of every split leaf (and, on the
    card, launch B1-B3), the newest step restored into one process
    (``restore_or_init`` into a whole state) must be the blocks the ranks
    saved, bit for bit, and each rank's blocks of its parameters and
    moments must be one process's within ``FSDP_STATE_REL``. The run whose
    rank skips the reduce-scatter must fail ``fsdp_check``, and the one
    whose rank skips its moment update ``fsdp_state_check``. Prints
    per-rank bytes, peak memory and ms/step."""
    from tony_tpu_torch.train import trainer
    from tony_tpu_torch.train.checkpoint import restore_or_init
    from tony_tpu_torch.train.loop import LoopConfig, run_lm_training
    from tony_tpu_torch.train.trainer import OptimizerConfig, TrainState, tree_bytes

    cfg = cfg or {"preset": "llama-1b", "n_layers": FSDP_LAYERS}
    model_cfg = llama.config_from_dict(cfg)
    fault_cfg = dict(cfg, n_layers=min(FSDP_FAULT_LAYERS, model_cfg.n_layers))
    cuda = device == "cuda"
    loop = dict(batch_size=GANG_B, seq_len=GANG_T if cuda else 32, log_every=1, warmup_steps=1)
    work = out_dir / "fsdp"
    ranks = fsdp_gang(work, cfg, fault_cfg, loop, device)
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    held, unhold = hold_final_state(trainer)
    try:
        one = run_lm_training(llama, model_cfg, LoopConfig(steps=FSDP_STEPS, device=device, **loop))["log"]
        one_state = dict(held)
        one_launches, one_peak = dict(A.launches), torch.cuda.max_memory_allocated() if cuda else 0
        fault_one = run_lm_training(llama, llama.config_from_dict(fault_cfg),
                                    LoopConfig(steps=1, device=device, **loop))["log"]
        fault_state = dict(held)
    finally:
        unhold()
    worst = fsdp_check(ranks, one)
    fault_caught = False
    try:
        fsdp_check(ranks, fault_one, "fault")
    except SmokeFailure:
        fault_caught = True
    check(fault_caught, "fsdp: the planted fault (a rank whose gradients skip the reduce-scatter) passed")
    for rank, rec in enumerate(ranks):
        check(not cuda or all(rec["ok"]["launches"][k] > 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
              f"fsdp: rank {rank} launches {rec['ok']['launches']}")
    opt = OptimizerConfig(learning_rate=3e-4, warmup_steps=1, total_steps=FSDP_STEPS).build()

    def restored(path: str, mcfg):
        """The newest step under ``path`` restored into one process's whole state."""
        return restore_or_init(path, lambda: TrainState.create(
            llama.init(torch.Generator(device=device).manual_seed(1), mcfg, device), opt), TrainState.load)[::2]

    t0 = time.perf_counter()
    state, step = restored(str(work / "ckpt"), model_cfg)
    restore_s = time.perf_counter() - t0
    check(step == FSDP_STEPS, f"fsdp: one process restored step {step}, want {FSDP_STEPS}")
    split = fsdp_blocks(torch, ranks, state.state_dict(), step)
    state_rel = fsdp_state_check(torch, state.state_dict(), one_state, ranks[0]["ok"]["saves"][str(step)],
                                 f"step {step}")
    whole_bytes = tree_bytes(state.params) + tree_bytes({k: state.opt_state[k] for k in ("mu", "nu")})
    del state, one_state, held
    moments, _ = restored(str(work / "ckpt-moments"), llama.config_from_dict(fault_cfg))
    try:
        fsdp_state_check(torch, moments.state_dict(), fault_state, ranks[0]["moments"]["saves"]["1"],
                         "moments fault")
        moments_fault = None
    except SmokeFailure as e:
        moments_fault = str(e).split(": ", 1)[-1]
    check(moments_fault is not None, "fsdp: the planted fault (a rank that skips its moment update) passed")
    del moments, fault_state
    shutil.rmtree(work, ignore_errors=True)
    last = [rec["ok"]["log"][-1] for rec in ranks]
    check(all(x["param_bytes"] + x["opt_bytes"] < 0.51 * whole_bytes for x in last),
          f"fsdp: per-rank bytes {[(x['param_bytes'], x['opt_bytes']) for x in last]} of {whole_bytes} whole")
    rec = {
        "preset": cfg.get("preset", "") + (f" cut to {model_cfg.n_layers} layers" if "n_layers" in cfg else ""),
        "batch": loop["batch_size"], "seq_len": loop["seq_len"], "steps": FSDP_STEPS, "losses": [x["loss"] for x in ranks[0]["ok"]["log"]],
        "one_losses": [x["loss"] for x in one], "grad_norms": [x["grad_norm"] for x in ranks[0]["ok"]["log"]],
        "worst_rel": worst, "state_rel": state_rel, "param_bytes": last[0]["param_bytes"],
        "opt_bytes": last[0]["opt_bytes"], "whole_bytes": whole_bytes, "split_leaves": split,
        "peak_bytes": [rec["ok"]["peak_bytes"] for rec in ranks],
        "one_peak_bytes": one_peak, "step_ms": [x["step_time_ms"] for x in ranks[0]["ok"]["log"]],
        "one_step_ms": [x["step_time_ms"] for x in one], "restored_step": step, "restore_s": restore_s,
        "fault_grad_norm": ranks[0]["fault"]["log"][0]["grad_norm"],
        "fault_one_grad_norm": fault_one[0]["grad_norm"], "moments_fault": moments_fault,
        "launches": [rec["ok"]["launches"] for rec in ranks], "one_launches": one_launches,
        "launches_sum": {k: sum(rec["ok"]["launches"][k] for rec in ranks) for k in ranks[0]["ok"]["launches"]},
    }
    print(fsdp_line(rec, card), flush=True)
    return rec


# [tp] and [mixtral-tp]: Megatron's tensor parallelism, a gang of TP_RANKS
# processes on the one card over gloo (``FSDP_BACKEND``: nccl refuses two
# ranks on one card) on ``MeshSpec.auto(model=2)`` (model 2, fsdp 1), bf16,
# remat "full", T=TP_T: TP_STEPS steps with a sharded save at the end, then
# one step of each planted fault. [tp] runs Llama-3-8B widths cut to
# TP_LAYERS layers at B=TP_B; [mixtral-tp] Mixtral-8x7B widths cut to
# MIXTRAL_TP_LAYERS layers at B=MIXTRAL_TP_B, each rank's experts on F/tp
# columns (B7/B8 at [E, D, 7168]). The losses and grad norms (and Mixtral's
# router losses) are held to one process's within GANG_LOSS_REL
# (``FSDP_REL``), the step's blocks of the parameters and moments within
# FSDP_STATE_REL (``fsdp_check``, ``fsdp_state_check``: the model axis
# splits each leaf on one dim, as fsdp does)
TP_RANKS, TP_STEPS = 2, 3
TP_LAYERS, TP_B, TP_T = 2, 2, 2048
#: [mixtral-tp]'s depth, 1 layer since the context gang's phase came (2
#: before): the router's step-3 mu reads 4.89e-2 of FSDP_STATE_REL's 5e-2
#: there (4.42e-2 at 2 layers), the same bits on every H100 run so far; 2
#: layers put the whole run 37 s under its 1,200 s limit
MIXTRAL_TP_LAYERS, MIXTRAL_TP_B = 1, 1
TP_FAULT_RANK = 1
#: the planted faults' runs, one step each: every rank's row-parallel reduce
#: also sums its gradient ("reduce"), and rank TP_FAULT_RANK's embedding keeps
#: its own rows without the line's sum ("embed")
TP_FAULTS = ("reduce", "embed")
#: Mixtral's: every rank's combine gates skip the model line's sum on their
#: gradient ("gates": each router gradient holds its own columns' share, so
#: the two ranks' differ), and rank TP_FAULT_RANK's expert output skips
#: ``reduce_from_model`` ("expert")
MIXTRAL_TP_FAULTS = ("gates", "expert")
#: [mixtral-ep]: the [mixtral-tp] gang's two processes also run the expert
#: axis, ``MeshSpec.auto(expert=2)`` (4 of the 8 experts a rank: B7/B8 on 4
#: groups, the span of sorted rows the rank's experts own), against the same
#: one-process run, then one step of each planted fault: every rank's MoE
#: output skips the expert line's sum ("unsummed"), and every rank takes
#: expert 0's span of the sorted rows ("span0")
MIXTRAL_EP_FAULTS = ("unsummed", "span0")
MIXTRAL_EP_RUNS = ("ep-ok", *(f"ep-{f}" for f in MIXTRAL_EP_FAULTS))
#: the family's gang: its phase's tag, its cut preset, batch rows and faults,
#: the step-report keys held to one process's and the kernels it launches
TP_FAMILIES = {
    "llama": dict(tag="tp", cfg={"preset": "llama3-8b", "n_layers": TP_LAYERS}, batch=TP_B, faults=TP_FAULTS,
                  keys=("loss", "grad_norm"), kernels=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    "mixtral": dict(tag="mixtral-tp", cfg={"preset": "mixtral-8x7b", "n_layers": MIXTRAL_TP_LAYERS},
                    batch=MIXTRAL_TP_B, faults=MIXTRAL_TP_FAULTS,
                    keys=("loss", "grad_norm", "moe_balance_loss", "moe_z_loss"),
                    kernels=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "moe_fwd", "moe_bwd"),
                    ep_runs=MIXTRAL_EP_RUNS),
}
#: [tp-serve]: the TP engine (``ContinuousBatcher(tp=2)``) with both shards on
#: the one card against the tp=1 engine on the same weights, Llama-3-8B widths
#: cut to TP_SERVE_LAYERS layers in f32 (bf16 greedy parity is rounding luck):
#: TP_SERVE_PROMPTS prompt lengths, TP_SERVE_TOKENS greedy tokens each
TP_SERVE_LAYERS, TP_SERVE_TOKENS, TP_SERVE_CHUNK = 4, 32, 8
TP_SERVE_PROMPTS = (17, 64, 200, 33)
#: [mixtral-tp-serve]: the same engines at Mixtral-8x7B widths cut to
#: MIXTRAL_TP_SERVE_LAYERS layers in bf16 (B7 takes bf16 only), every prompt
#: longer than 16 tokens so that its prefill runs B7 on each shard's [E, D,
#: 7168] blocks, MIXTRAL_TP_SERVE_TOKENS tokens each. bf16 greedy parity is
#: rounding luck, so both engines are fed tp 1's token stream (teacher
#: forcing) and each prefill's and decode step's last-position logits row is
#: held to tp 1's: ‖Δ‖∞ / ‖row‖∞ within MIXTRAL_TP_SERVE_ROW_TOL. The
#: shards' partials are rounded to bf16 apart and summed in f32, tp 1's
#: products once: ~1 bf16 ulp (4e-3) of the residual stream a layer, a few
#: ulps of the logits (|logits| ~4: 2e-2 of a row's largest). The limit is
#: 5x that estimate; an H100 read 6.2e-3 to 1.3e-2. A router choice near a
#: tie can round the other way on the shards (the first H100 run: one row in
#: 64, its token sent to another expert in one layer, 0.24): so the limit
#: holds the rows whose own token routed as tp 1's in every layer (the
#: routes are recorded on both engines), and at most MIXTRAL_TP_SERVE_FLIPS
#: of the rows may route otherwise. One shard's expert partial dropped (half
#: of every mixture) moves the rows by tens of percent and reroutes most
#: tokens after the first layer. The argmax must be tp 1's wherever tp 1's
#: top-2 margin exceeds twice the limit, on the rows the limit holds
MIXTRAL_TP_SERVE_LAYERS, MIXTRAL_TP_SERVE_TOKENS = 4, 16
MIXTRAL_TP_SERVE_ROW_TOL = 0.1
MIXTRAL_TP_SERVE_FLIPS = 0.1


def psum_backward_reduce(collectives) -> None:
    """A planted fault on every rank: the row-parallel reduce's backward also
    sums over the model line (``psum``'s pair), which hands each rank tp times
    the upstream gradient."""
    def backward(ctx, g):
        return collectives._psum_f32(g, ctx.group), None

    collectives._ReduceFromModel.backward = staticmethod(backward)


def skip_embedding_psum(llama) -> None:
    """A planted fault: this rank's embedding keeps its own rows (zeros for
    the tokens its peer holds) instead of the line's sum; the sum still runs,
    so its peer is not left waiting."""
    real = llama.embed_lookup

    def own_rows(embed, tokens, mesh=None):
        real(embed, tokens, mesh)
        return llama.vocab_rows(embed, tokens, mesh.axis_index("model") * embed.shape[0])

    llama.embed_lookup = own_rows


def unsummed_gates(expert, top_k: int) -> None:
    """A planted fault on every rank: the gates entering the MoE combine
    ([B·T, top_k]) skip ``copy_to_model``, so their gradient, and the
    router's, hold only this rank's columns' share; the dispatched rows
    ([B·T, D]) keep it."""
    real = expert.copy_to_model
    expert.copy_to_model = lambda x, group: x if x.shape[-1] == top_k else real(x, group)


def skip_expert_reduce(expert) -> None:
    """A planted fault: this rank's MoE output is its own experts' partial,
    without the model line's sum; the sum still runs, so its peer is not
    left waiting."""
    real = expert.reduce_from_model

    def own_partial(x, group):
        real(x, group)
        return x

    expert.reduce_from_model = own_partial


def span_of_expert0(expert) -> None:
    """A planted fault on every rank: the MoE takes expert 0's span of the
    sorted rows (and its group sizes) for this rank's experts."""
    expert._expert_span = lambda mesh, num_experts: (0, num_experts // mesh.shape["expert"])


def record_moe_experts(MG, seen: set) -> None:
    """While installed, each B7/B8 wrapper call adds its experts (the
    weights' leading dim) to ``seen``."""
    real_fwd, real_bwd = MG.moe_fwd, MG.moe_bwd

    def fwd(xs, wg, *a, **kw):
        seen.add(wg.shape[0])
        return real_fwd(xs, wg, *a, **kw)

    def bwd(xs, dy, wg, *a, **kw):
        seen.add(wg.shape[0])
        return real_bwd(xs, dy, wg, *a, **kw)

    MG.moe_fwd, MG.moe_bwd = fwd, bwd


def tp_rank(spec_json: str) -> None:
    """One rank of the ``[tp]`` or ``[mixtral-tp]`` gang (``RANK`` in the
    env; the spec's ``model``: llama or mixtral): ``run_lm_training`` with
    ``model_axis`` TP_RANKS once sound with a sharded save (the fingerprint
    and shape of each block the rank hands it) and once for each planted
    fault, then (Mixtral) the same on ``expert_axis`` TP_RANKS
    (``MIXTRAL_EP_RUNS``), each in a gloo group of its own (a file store
    under the spec's directory); each run's step reports, kernel launches,
    the experts each B7/B8 call took, peak memory and (Mixtral) the
    fingerprint of the router's gradient at each step. Writes
    ``rank<r>.json`` there."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from tony_tpu_torch.models import llama, mixtral
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import moe_gemm as MG
    from tony_tpu_torch.parallel import collectives, expert
    from tony_tpu_torch.train import checkpoint as C
    from tony_tpu_torch.train import trainer
    from tony_tpu_torch.train.loop import LoopConfig, run_lm_training

    spec = json.loads(spec_json)
    rank, work = int(os.environ["RANK"]), Path(spec["dir"])
    cuda = spec["device"] == "cuda"
    model = {"llama": llama, "mixtral": mixtral}[spec["model"]]
    cfg = model.config_from_dict(spec["cfg"])
    real = (C.CheckpointManager.save, vars(collectives._ReduceFromModel)["backward"], llama.embed_lookup,
            expert.copy_to_model, expert.reduce_from_model, trainer.AdamW.update, expert._expert_span,
            MG.moe_fwd, MG.moe_bwd)
    out = {}
    for run in ("ok", *spec["faults"], *spec["ep_runs"]):
        saves: dict = {}
        router: list = []
        experts: set = set()

        def save(self, step, state, force=False):
            local = {name: t.to_local() if hasattr(t, "to_local") else t for name, t in _leaves(state)}
            saves[step] = {name: {"shape": list(t.shape), "fp": fingerprint(torch, t)}
                           for name, t in local.items() if hasattr(t, "shape")}
            return real[0](self, step, state, force=force)

        def update(self, params, grads, state, norm):
            if "layers/router" in grads:
                router.append(fingerprint(torch, grads["layers/router"]))
            return real[5](self, params, grads, state, norm)

        if cuda:
            torch.cuda.set_device(0)
            torch.cuda.reset_peak_memory_stats()
        dist.init_process_group(FSDP_BACKEND, init_method=f"file://{work / ('store-' + run)}",
                                world_size=TP_RANKS, rank=rank)
        C.CheckpointManager.save, trainer.AdamW.update = save, update
        if run == "reduce":
            psum_backward_reduce(collectives)
        if run == "embed" and rank == TP_FAULT_RANK:
            skip_embedding_psum(llama)
        if run == "gates":
            unsummed_gates(expert, cfg.top_k)
        if run == "expert" and rank == TP_FAULT_RANK:
            skip_expert_reduce(expert)
        if run == "ep-unsummed":
            skip_expert_reduce(expert)
        if run == "ep-span0":
            span_of_expert0(expert)
        record_moe_experts(MG, experts)
        A.reset_launches()
        MG.reset_launches()
        try:
            res = run_lm_training(model, cfg, LoopConfig(**spec[run]))
        finally:
            (C.CheckpointManager.save, collectives._ReduceFromModel.backward, llama.embed_lookup,
             expert.copy_to_model, expert.reduce_from_model, trainer.AdamW.update, expert._expert_span,
             MG.moe_fwd, MG.moe_bwd) = real
        out[run] = {"log": res["log"], "launches": {**A.launches, **MG.launches}, "saves": saves,
                    "router": router, "experts": sorted(experts),
                    "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    (work / f"rank{rank}.json").write_text(json.dumps(out))


def router_check(ranks: list, run: str = "ok", tag: str = "mixtral-tp") -> int:
    """The router's gradient, whole on every rank, must be the same bits on
    every rank of the model line at every step of ``run`` (the trainer's norm
    and update assume it of a leaf the rules keep whole). Returns the steps
    checked."""
    steps = [rec[run]["router"] for rec in ranks]
    check(steps[0] and all(len(s) == len(steps[0]) for s in steps), f"{tag}: router gradients recorded {steps}")
    for i, fps in enumerate(zip(*steps)):
        check(all(fp == fps[0] for fp in fps),
              f"{tag}: ({run}) the ranks' router gradients differ at step {i + 1}: {list(fps)}")
    return len(steps[0])


def tp_line(rec: dict, card: str) -> str:
    """The ``[tp]`` / ``[mixtral-tp]`` report line."""
    state = ", ".join(f"{k} {v:.2e} ({rec['state_worst_leaf'][k]})" for k, v in rec["state_rel"].items())
    faults = "; ".join(f"{k}: grad norm {v['grad_norm']} loss {v['loss']} against one process's "
                       f"{rec['one_grad_norm']} / {rec['one_loss']}"
                       f"{', the ranks router gradients differ' if k == 'gates' else ''}, failed"
                       for k, v in rec["faults"].items())
    moe = (f"; router losses balance {rec['balance']} z {rec['z']} (one process {rec['one_balance']} / "
           f"{rec['one_z']}); the router's gradient the same bits on both ranks at {rec['router_steps']} steps"
           if "balance" in rec else "")
    return (f"[{rec['tag']}] {TP_RANKS} ranks on one card over {FSDP_BACKEND}, {rec['preset']} widths {rec['layers']} "
            f"layers B={rec['batch']} T={rec['seq_len']}, model {TP_RANKS}: losses {rec['losses']} grad norms "
            f"{rec['grad_norms']} (one process {rec['one_losses']} / {rec['one_grad_norms']}, worst rel "
            f"{rec['worst_rel']:.2e}, limit {FSDP_REL:.0e}){moe}; step {rec['restored_step']} blocks against one "
            f"process's, worst {state} (limit {FSDP_STATE_REL:.0e}); per rank params "
            f"{rec['param_bytes'] / 1e9:.3f} GB + moments {rec['opt_bytes'] / 1e9:.3f} GB of "
            f"{rec['whole_bytes'] / 1e9:.3f} GB whole ({rec['split_leaves']} leaves split), peak "
            f"{[round(b / 2**30, 2) for b in rec['peak_bytes']]} GiB (one process "
            f"{rec['one_peak_bytes'] / 2**30:.2f} GiB); {'/'.join(rec['kernels'])} a rank {rec['launches']} (one "
            f"process {rec['one_launches']}); ms/step {rec['step_ms']} over gloo (one process {rec['one_step_ms']}); "
            f"step {rec['restored_step']} restored into one process bit for bit in {rec['restore_s']:.1f} s; "
            f"seconds {rec['seconds']}; planted faults, {faults}; {card}")


def tp_phase(torch, model, A, out_dir: Path, card: str, cfg: dict | None = None, device: str = "cuda") -> dict:
    """``[tp]`` (``model`` llama) or ``[mixtral-tp]`` (mixtral): the gang of
    ``TP_RANKS`` on the card on the model axis at the family's widths cut
    to depth (``TP_FAMILIES``; ``cfg`` and ``device`` another config and
    device), ``TP_STEPS`` steps through ``run_lm_training(model_axis=2)``
    with a sharded save at the end, then a step of each planted fault.
    Each rank's losses and grad norms (and router losses) must be one
    process's on the same batches (``run_lm_training`` here, kernels
    counted), each rank must launch the family's kernels as often as one
    process, hold half of every split leaf, and the step restored into one
    process must be the blocks the ranks saved, bit for bit, and each
    rank's blocks of its parameters and moments one process's within
    ``FSDP_STATE_REL``; Mixtral's router gradient must be the same bits on
    both ranks. Llama's faults must fail ``fsdp_check``; Mixtral's
    unsummed gates ``router_check`` and its unreduced expert output
    ``fsdp_check``. Prints per-rank bytes, peak memory, launches and
    ms/step."""
    from tony_tpu_torch.ops import moe_gemm as MG
    from tony_tpu_torch.train import trainer
    from tony_tpu_torch.train.checkpoint import restore_or_init
    from tony_tpu_torch.train.loop import LoopConfig, run_lm_training
    from tony_tpu_torch.train.trainer import OptimizerConfig, TrainState, tree_bytes

    family = model.__name__.rsplit(".", 1)[-1]
    fam = TP_FAMILIES[family]
    tag, kernels = fam["tag"], fam["kernels"]
    cfg = cfg or fam["cfg"]
    model_cfg = model.config_from_dict(cfg)
    cuda = device == "cuda"
    loop = dict(batch_size=fam["batch"], seq_len=TP_T if cuda else 32, log_every=1, warmup_steps=1)
    work = (out_dir / tag).resolve()  # the ranks' file store takes an absolute path
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    gang = dict(loop, model_axis=TP_RANKS, device=device)
    ep_runs = fam.get("ep_runs", ())
    ep = dict(loop, expert_axis=TP_RANKS, device=device)
    spec = {"dir": str(work), "model": family, "cfg": cfg, "device": device, "faults": list(fam["faults"]),
            "ep_runs": list(ep_runs),
            "ok": dict(gang, steps=TP_STEPS, checkpoint_dir=str(work / "ckpt"), checkpoint_every=TP_STEPS),
            **{f: dict(gang, steps=1) for f in fam["faults"]},
            **{r: dict(ep, steps=TP_STEPS, checkpoint_dir=str(work / "ckpt-ep"), checkpoint_every=TP_STEPS)
               if r == "ep-ok" else dict(ep, steps=1) for r in ep_runs}}
    t0 = time.perf_counter()
    ranks = run_gang(work, spec, "tp_rank", TP_RANKS, tag)
    seconds = {"gang": time.perf_counter() - t0}
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    MG.reset_launches()
    held, unhold = hold_final_state(trainer)
    t0 = time.perf_counter()
    try:
        one = run_lm_training(model, model_cfg, LoopConfig(steps=TP_STEPS, device=device, **loop))["log"]
        one_state = dict(held)
    finally:
        unhold()
    seconds["one_process"] = time.perf_counter() - t0
    one_launches, one_peak = {**A.launches, **MG.launches}, torch.cuda.max_memory_allocated() if cuda else 0
    worst = fsdp_check(ranks, one, tag=tag, keys=fam["keys"])
    router_steps = router_check(ranks, tag=tag) if family == "mixtral" else 0
    faults = {}
    for fault in fam["faults"]:
        try:
            if fault == "gates":
                router_check(ranks, fault, tag=tag)
            else:
                fsdp_check(ranks, one, fault, tag=tag, keys=fam["keys"])
        except SmokeFailure:
            faults[fault] = {k: [rec[fault]["log"][0][k] for rec in ranks] for k in ("loss", "grad_norm")}
        check(fault in faults, f"{tag}: the planted fault {fault!r} passed")
    for rank, rec in enumerate(ranks):
        got = {k: rec["ok"]["launches"][k] for k in kernels}
        check(got == {k: one_launches[k] for k in kernels} and (not cuda or all(got.values())),
              f"{tag}: rank {rank} launches {got}, one process {one_launches}")
    opt = OptimizerConfig(learning_rate=3e-4, warmup_steps=1, total_steps=TP_STEPS).build()
    t0 = time.perf_counter()
    state, _, step = restore_or_init(str(work / "ckpt"), lambda: TrainState.create(
        model.init(torch.Generator(device=device).manual_seed(1), model_cfg, device), opt), TrainState.load)
    restore_s = time.perf_counter() - t0
    check(step == TP_STEPS, f"{tag}: one process restored step {step}, want {TP_STEPS}")
    split = fsdp_blocks(torch, ranks, state.state_dict(), step, tag=tag)
    worst_leaves: dict = {}
    state_rel = fsdp_state_check(torch, state.state_dict(), one_state, ranks[0]["ok"]["saves"][str(step)],
                                 f"step {step}", tag=tag, leaves=worst_leaves)
    whole_bytes = tree_bytes(state.params) + tree_bytes({k: state.opt_state[k] for k in ("mu", "nu")})
    del state
    ep_rec = None
    if ep_runs:
        ep_rec = ep_check(torch, model, model_cfg, ranks, one, one_state, one_launches, work, device, kernels,
                          fam["keys"], opt)
        ep_rec.update(preset=cfg.get("preset", ""), layers=model_cfg.n_layers, batch=loop["batch_size"],
                      seq_len=loop["seq_len"], one_losses=[x["loss"] for x in one],
                      one_grad_norms=[x["grad_norm"] for x in one], seconds_gang=round(seconds["gang"], 1))
    del one_state, held
    shutil.rmtree(work, ignore_errors=True)
    last = [rec["ok"]["log"][-1] for rec in ranks]
    check(all(x["param_bytes"] + x["opt_bytes"] < 0.51 * whole_bytes for x in last),
          f"{tag}: per-rank bytes {[(x['param_bytes'], x['opt_bytes']) for x in last]} of {whole_bytes} whole")
    log0 = ranks[0]["ok"]["log"]
    rec = {
        "tag": tag, "preset": cfg.get("preset", ""), "layers": model_cfg.n_layers, "batch": loop["batch_size"],
        "seq_len": loop["seq_len"], "steps": TP_STEPS, "losses": [x["loss"] for x in log0],
        "grad_norms": [x["grad_norm"] for x in log0], "one_losses": [x["loss"] for x in one],
        "one_grad_norms": [x["grad_norm"] for x in one], "one_loss": one[0]["loss"],
        "one_grad_norm": one[0]["grad_norm"], "worst_rel": worst, "state_rel": state_rel,
        "state_worst_leaf": worst_leaves, "param_bytes": last[0]["param_bytes"], "opt_bytes": last[0]["opt_bytes"], "whole_bytes": whole_bytes,
        "split_leaves": split, "peak_bytes": [rec["ok"]["peak_bytes"] for rec in ranks],
        "one_peak_bytes": one_peak, "step_ms": [x["step_time_ms"] for x in log0],
        "one_step_ms": [x["step_time_ms"] for x in one], "restored_step": step, "restore_s": restore_s,
        "seconds": {k: round(v, 1) for k, v in seconds.items()}, "faults": faults,
        "kernels": list(kernels), "launches": [[rec["ok"]["launches"][k] for k in kernels] for rec in ranks],
        "one_launches": [one_launches[k] for k in kernels],
        "launches_rank": {k: ranks[0]["ok"]["launches"][k] for k in kernels},
    }
    if family == "mixtral":
        rec.update(balance=[x["moe_balance_loss"] for x in log0], z=[x["moe_z_loss"] for x in log0],
                   one_balance=[x["moe_balance_loss"] for x in one], one_z=[x["moe_z_loss"] for x in one],
                   router_steps=router_steps)
    print(tp_line(rec, card), flush=True)
    if ep_rec is not None:
        rec["ep"] = ep_rec
        print(ep_line(ep_rec, card), flush=True)
    return rec


#: the expert leaves, which the expert axis halves
EXPERT_LEAVES = ("layers/we_gate", "layers/we_up", "layers/we_down")


def ep_check(torch, model, model_cfg, ranks: list, one: list, one_state: dict, one_launches: dict, work: Path,
             device: str, kernels: tuple, keys: tuple, opt) -> dict:
    """``[mixtral-ep]``'s holds on the gang's ``MIXTRAL_EP_RUNS``: each rank's
    losses, grad norms and router losses one process's within
    ``FSDP_REL`` (the data × fsdp size is 1, so JAX's per-shard mean is the
    batch's); the router's gradient the same bits on both ranks at every
    step; each rank's B1-B3, B7 and B8 launches one process's, every B7/B8
    call on ``E/2`` experts (and, on the card, B7 launched: the bf16
    aligned path has no fallback); the per-rank bytes exactly the whole
    state's less half of every expert leaf and its moments; the saved step
    restored into one process bit for bit, and each rank's blocks of it
    within ``FSDP_STATE_REL`` of one process's. Each planted fault must
    fail ``fsdp_check``."""
    from tony_tpu_torch.train.checkpoint import restore_or_init
    from tony_tpu_torch.train.trainer import TrainState, tree_bytes

    tag, run = "mixtral-ep", "ep-ok"
    worst = fsdp_check(ranks, one, run, tag=tag, keys=keys)
    router_steps = router_check(ranks, run, tag=tag)
    faults = {}
    for fault in MIXTRAL_EP_FAULTS:
        try:
            fsdp_check(ranks, one, f"ep-{fault}", tag=tag, keys=keys)
        except SmokeFailure:
            faults[fault] = {k: [rec[f"ep-{fault}"]["log"][0][k] for rec in ranks] for k in ("loss", "grad_norm")}
        check(fault in faults, f"{tag}: the planted fault {fault!r} passed")
    cuda = device == "cuda"
    local = model_cfg.num_experts // TP_RANKS
    for rank, rec in enumerate(ranks):
        got = {k: rec[run]["launches"][k] for k in kernels}
        check(got == {k: one_launches[k] for k in kernels} and (not cuda or all(got.values())),
              f"{tag}: rank {rank} launches {got}, one process {one_launches}")
        check(rec[run]["experts"] == [local], f"{tag}: rank {rank}'s B7/B8 calls took {rec[run]['experts']} "
                                              f"experts, want {local}")
    t0 = time.perf_counter()
    state, _, step = restore_or_init(str(work / "ckpt-ep"), lambda: TrainState.create(
        model.init(torch.Generator(device=device).manual_seed(1), model_cfg, device), opt), TrainState.load)
    restore_s = time.perf_counter() - t0
    check(step == TP_STEPS, f"{tag}: one process restored step {step}, want {TP_STEPS}")
    split = fsdp_blocks(torch, ranks, state.state_dict(), step, tag=tag, run=run)
    check(split == 3 * len(EXPERT_LEAVES),
          f"{tag}: {split} leaves split, want the {len(EXPERT_LEAVES)} expert leaves and their two moments")
    worst_leaves: dict = {}
    state_rel = fsdp_state_check(torch, state.state_dict(), one_state, ranks[0][run]["saves"][str(step)],
                                 f"step {step}", tag=tag, leaves=worst_leaves)
    trees = (state.params, state.opt_state["mu"], state.opt_state["nu"])
    whole_bytes = sum(tree_bytes(t) for t in trees)
    expert_bytes = sum(tree_bytes({n: t for n, t in _leaves(tree) if n in EXPERT_LEAVES}) for tree in trees)
    del state
    last = [rec[run]["log"][-1] for rec in ranks]
    want = whole_bytes - expert_bytes // TP_RANKS
    check(all(x["param_bytes"] + x["opt_bytes"] == want for x in last),
          f"{tag}: per-rank bytes {[(x['param_bytes'], x['opt_bytes']) for x in last]}, want {want}: "
          f"{whole_bytes} whole less half of the experts' {expert_bytes}")
    log0 = ranks[0][run]["log"]
    return {
        "tag": tag, "steps": TP_STEPS, "losses": [x["loss"] for x in log0],
        "grad_norms": [x["grad_norm"] for x in log0], "worst_rel": worst,
        "balance": [x["moe_balance_loss"] for x in log0], "z": [x["moe_z_loss"] for x in log0],
        "one_balance": [x["moe_balance_loss"] for x in one], "one_z": [x["moe_z_loss"] for x in one],
        "router_steps": router_steps, "state_rel": state_rel, "state_worst_leaf": worst_leaves,
        "param_bytes": last[0]["param_bytes"], "opt_bytes": last[0]["opt_bytes"], "whole_bytes": whole_bytes,
        "expert_bytes": expert_bytes, "split_leaves": split, "local_experts": local,
        "peak_bytes": [rec[run]["peak_bytes"] for rec in ranks],
        "step_ms": [x["step_time_ms"] for x in log0], "restored_step": step, "restore_s": restore_s,
        "faults": faults, "kernels": list(kernels),
        "launches": [[rec[run]["launches"][k] for k in kernels] for rec in ranks],
        "one_launches": [one_launches[k] for k in kernels],
        "launches_rank": {k: ranks[0][run]["launches"][k] for k in kernels},
    }


def ep_line(rec: dict, card: str) -> str:
    """The ``[mixtral-ep]`` report line."""
    state = ", ".join(f"{k} {v:.2e} ({rec['state_worst_leaf'][k]})" for k, v in rec["state_rel"].items())
    faults = "; ".join(f"{k}: loss {v['loss']} grad norm {v['grad_norm']} against one process's "
                       f"{rec['one_losses'][0]} / {rec['one_grad_norms'][0]}, failed" for k, v in rec["faults"].items())
    return (f"[{rec['tag']}] {TP_RANKS} ranks on one card over {FSDP_BACKEND}, {rec['preset']} widths {rec['layers']} "
            f"layers B={rec['batch']} T={rec['seq_len']}, expert {TP_RANKS} ({rec['local_experts']} experts a rank): "
            f"losses {rec['losses']} grad norms {rec['grad_norms']} (one process {rec['one_losses']} / "
            f"{rec['one_grad_norms']}, worst rel {rec['worst_rel']:.2e}, limit {FSDP_REL:.0e}); router losses "
            f"balance {rec['balance']} z {rec['z']} (one process {rec['one_balance']} / {rec['one_z']}); the router's "
            f"gradient the same bits on both ranks at {rec['router_steps']} steps; step {rec['restored_step']} blocks "
            f"against one process's, worst {state} (limit {FSDP_STATE_REL:.0e}); per rank params "
            f"{rec['param_bytes'] / 1e9:.3f} GB + moments {rec['opt_bytes'] / 1e9:.3f} GB of "
            f"{rec['whole_bytes'] / 1e9:.3f} GB whole, exactly less half of the experts' "
            f"{rec['expert_bytes'] / 1e9:.3f} GB ({rec['split_leaves']} leaves split), peak "
            f"{[round(b / 2**30, 2) for b in rec['peak_bytes']]} GiB; {'/'.join(rec['kernels'])} a rank "
            f"{rec['launches']} (one process {rec['one_launches']}), each B7/B8 call on {rec['local_experts']} "
            f"experts; ms/step {rec['step_ms']} over gloo; step {rec['restored_step']} restored into one process bit "
            f"for bit in {rec['restore_s']:.1f} s; gang {rec['seconds_gang']} s with [mixtral-tp]'s runs; planted "
            f"faults, {faults}; {card}")


def tp_serve_requests(vocab: int) -> list[list[int]]:
    """The ``[tp-serve]`` prompts: ``TP_SERVE_PROMPTS`` lengths of seeded ids."""
    import random

    rng = random.Random(0)
    return [[rng.randrange(vocab) for _ in range(n)] for n in TP_SERVE_PROMPTS]


def drop_last_shard_partial(collectives) -> None:
    """A planted fault: the one-process reduce over the shards drops the last
    shard's row-parallel partial."""
    real = collectives.DeviceModel.reduce_from_model

    def reduce_from_model(self, parts):
        return real(self, parts[:-1] + [parts[-1] * 0])

    collectives.DeviceModel.reduce_from_model = reduce_from_model


def serve_tokens(torch, eng, prompts: list, tokens: int = TP_SERVE_TOKENS) -> tuple[list, float]:
    """Every prompt submitted at once to the in-process engine, run to its
    end: (each request's ``tokens`` greedy tokens, the mean ms of a decode
    step, from the chunks after every slot was admitted)."""
    rids = [eng.submit(p, tokens) for p in prompts]
    eng.step()  # admission: every prompt's prefill and the first chunk
    check(len(eng.running) + len(eng.done) == len(prompts) and not (eng.pending or eng._staged),
          "tp-serve: a prompt was not admitted by the first step")
    t0, chunks = time.perf_counter(), 0
    while eng.step():
        chunks += 1
    ms = (time.perf_counter() - t0) * 1e3 / max(chunks * eng.decode_chunk, 1)
    return [eng.done[r] for r in rids], ms


def tp_serve_line(rec: dict, card: str) -> str:
    """The ``[tp-serve]`` report line."""
    return (f"[tp-serve] {rec['preset']} widths {rec['layers']} layers {rec['dtype']}, {len(TP_SERVE_PROMPTS)} "
            f"requests of {TP_SERVE_TOKENS} greedy tokens, prompts {list(TP_SERVE_PROMPTS)}: tp 2 (both shards on "
            f"{rec['devices']}) tokens equal tp 1's; decode ms/step tp 2 {rec['tp2_ms']:.2f} / tp 1 "
            f"{rec['tp1_ms']:.2f} (reported, not judged); planted fault, one shard's row partial dropped: "
            f"{rec['fault_changed']} of {len(TP_SERVE_PROMPTS)} requests' tokens changed, failed; {card}")


def tp_serve_phase(torch, llama, card: str, cfg: dict | None = None, device: str = "cuda") -> dict:
    """``[tp-serve]``: the TP engine with both shards on the one device
    against the tp=1 engine on the same seeded weights (Llama-3-8B widths cut
    to ``TP_SERVE_LAYERS`` layers, f32; ``cfg`` and ``device`` another model
    and device): the same greedy tokens; the decode ms/step of both,
    reported; a planted fault (one shard's row partial dropped) must change
    the tokens."""
    from tony_tpu_torch.models.serving import ContinuousBatcher
    from tony_tpu_torch.parallel import collectives

    cfg = cfg or {"preset": "llama3-8b", "n_layers": TP_SERVE_LAYERS, "dtype": "float32"}
    model_cfg = llama.config_from_dict(cfg)
    params = llama.init(torch.Generator(device=device).manual_seed(0), model_cfg, device)
    prompts = tp_serve_requests(model_cfg.vocab_size)
    kw = dict(num_slots=len(prompts), max_len=max(TP_SERVE_PROMPTS) + TP_SERVE_TOKENS + TP_SERVE_CHUNK,
              decode_chunk=TP_SERVE_CHUNK)

    def engine(tp: int):
        return ContinuousBatcher(params, model_cfg, tp=tp, devices=[device] * tp if tp > 1 else None, **kw)

    want, tp1_ms = serve_tokens(torch, engine(1), prompts)
    got, tp2_ms = serve_tokens(torch, engine(2), prompts)
    check(got == want, f"tp-serve: tp 2 tokens {got} differ from tp 1's {want}")
    real = collectives.DeviceModel.reduce_from_model
    drop_last_shard_partial(collectives)
    try:
        faulty, _ = serve_tokens(torch, engine(2), prompts)
    finally:
        collectives.DeviceModel.reduce_from_model = real
    changed = sum(a != b for a, b in zip(faulty, want))
    check(changed > 0, "tp-serve: the planted fault (one shard's row partial dropped) left the tokens as they were")
    rec = {"preset": cfg.get("preset", ""), "layers": model_cfg.n_layers, "dtype": model_cfg.dtype,
           "devices": f"{device} twice", "tokens": got, "tp1_ms": tp1_ms, "tp2_ms": tp2_ms,
           "fault_changed": changed}
    print(tp_serve_line(rec, card), flush=True)
    return rec


def forced_logits(torch, params, cfg, prompt: list, stream: list):
    """The engine's forward (``generate``) on ``params`` (a tree or the TP
    engine's ``ModelShards``) fed ``prompt`` then ``stream`` one token at a
    time, teacher-forced: the prefill's last-position logits and each decode
    step's, [1 + len(stream) - 1, V] f32 on the first device."""
    from tony_tpu_torch.models import generate as G

    devices = params.axis.devices if isinstance(params, G.ModelShards) else G.params_device(params)
    home = G.params_device(params)
    with torch.inference_mode():
        cache = G.init_cache(cfg, 1, len(prompt) + len(stream), devices)
        last, cache = G.prefill(params, torch.tensor([prompt], device=home), cache, cfg)
        rows = [last[0]]
        for t in stream[:-1]:
            logits, cache = G._forward_with_cache(params, torch.tensor([[t]], device=home), cache, cfg)
            rows.append(logits[0, -1])
    return torch.stack(rows).float()


def logit_row_errs(torch, got, want) -> list:
    """Each row's ‖got − want‖∞ / ‖want‖∞."""
    return ((got - want).abs().amax(-1) / want.abs().amax(-1).clamp_min(1e-30)).tolist()


def recorded_routes(expert) -> tuple:
    """While installed, each top-k choice of the router (``expert._top_k``,
    which the prefill's ``moe_ffn`` and the decode's ``_gating`` both reach)
    is appended to the list returned, each position's experts sorted
    ([positions, K] on the CPU); the function returned uninstalls it."""
    seen, real = [], expert._top_k

    def top_k(probs, k):
        vals, idx = real(probs, k)
        seen.append(idx.reshape(-1, k).sort(-1).values.cpu())
        return vals, idx

    expert._top_k = top_k
    return seen, lambda: setattr(expert, "_top_k", real)


def forced_run(torch, expert, params, cfg, prompts: list, streams: list, shards: int) -> tuple[list, list]:
    """``forced_logits`` of each prompt fed its stream, with the routes of
    every call: (each prompt's rows, each prompt's routes indexed [call]
    [layer][shard], call c giving row c)."""
    rows, routes = [], []
    for prompt, stream in zip(prompts, streams):
        seen, unhook = recorded_routes(expert)
        try:
            rows.append(forced_logits(torch, params, cfg, prompt, stream))
        finally:
            unhook()
        L = cfg.n_layers
        check(len(seen) == len(stream) * L * shards,
              f"mixtral-tp-serve: {len(seen)} router calls for {len(stream)} forward calls of {L} layers")
        routes.append([[seen[(c * L + i) * shards:(c * L + i + 1) * shards] for i in range(L)]
                       for c in range(len(stream))])
    return rows, routes


def forced_reading(torch, got: list, got_routes: list, ref: list, ref_routes: list) -> dict:
    """tp 2's teacher-forced rows and routes against tp 1's: whether every
    shard routed every call alike, the rows whose own token routed as tp
    1's in every layer (their errors, and how many have a clear tp 1
    margin and which of those keep tp 1's argmax), and the others'."""
    held, flipped, clear, kept, shards_alike = [], [], 0, 0, True
    for a, b, ra, rb in zip(got, ref, got_routes, ref_routes):
        errs = logit_row_errs(torch, a, b)
        top = b.topk(2, dim=-1).values
        margin = (top[:, 0] - top[:, 1]) > 2 * MIXTRAL_TP_SERVE_ROW_TOL * b.abs().amax(-1)
        same_top = a.argmax(-1) == b.argmax(-1)
        for r, (call_a, call_b) in enumerate(zip(ra, rb)):
            shards_alike &= all(torch.equal(la[0], x) for la in call_a for x in la[1:])
            if any(not torch.equal(la[0][-1], lb[0][-1]) for la, lb in zip(call_a, call_b)):
                flipped.append(errs[r])
                continue
            held.append(errs[r])
            clear += int(margin[r])
            kept += int(margin[r] and same_top[r])
    return {"rows": len(held) + len(flipped), "worst_row": max(held, default=0.0), "row_errs": held,
            "flipped_errs": flipped, "argmax_rows": clear, "argmax_kept": kept, "shards_alike": shards_alike}


def forced_check(reading: dict) -> None:
    """``forced_reading``'s limits: the shards route alike, the rows routed
    as tp 1 within ``MIXTRAL_TP_SERVE_ROW_TOL`` with tp 1's argmax where
    its margin is clear, at most ``MIXTRAL_TP_SERVE_FLIPS`` of the rows
    routed otherwise."""
    check(reading["shards_alike"], "mixtral-tp-serve: the TP engine's shards routed a token differently")
    check(reading["worst_row"] <= MIXTRAL_TP_SERVE_ROW_TOL,
          f"mixtral-tp-serve: a teacher-forced logits row of tp 2 is {reading['worst_row']:.2e} > "
          f"{MIXTRAL_TP_SERVE_ROW_TOL:.0e} from tp 1's (rows {['%.1e' % e for e in reading['row_errs']]})")
    check(len(reading["flipped_errs"]) <= MIXTRAL_TP_SERVE_FLIPS * reading["rows"],
          f"mixtral-tp-serve: {len(reading['flipped_errs'])} of {reading['rows']} rows' tokens routed otherwise "
          f"than tp 1's, more than {MIXTRAL_TP_SERVE_FLIPS:.0%}")
    check(reading["argmax_kept"] == reading["argmax_rows"],
          f"mixtral-tp-serve: tp 2's argmax differs from tp 1's on {reading['argmax_rows'] - reading['argmax_kept']} "
          "rows whose margin is clear")


def drop_last_shard_experts(generate, shards) -> None:
    """A planted fault: the expert partial of the last of ``shards`` (a
    ``ModelShards``) is dropped in every MoE layer; attention keeps both."""
    real = generate._ffn_with_cache
    last = shards.trees[-1]["layers"]["we_gate"].untyped_storage().data_ptr()

    def ffn(h, lp, cfg):
        y = real(h, lp, cfg)
        return y * 0 if lp["we_gate"].untyped_storage().data_ptr() == last else y

    generate._ffn_with_cache = ffn


def mixtral_tp_serve_line(rec: dict, card: str) -> str:
    """The ``[mixtral-tp-serve]`` report line."""
    flips = ", ".join(f"{e:.2e}" for e in rec["flipped_errs"]) or "none"
    return (f"[mixtral-tp-serve] {rec['preset']} widths {rec['layers']} layers {rec['dtype']}, "
            f"{len(TP_SERVE_PROMPTS)} requests of {MIXTRAL_TP_SERVE_TOKENS} greedy tokens, prompts "
            f"{list(TP_SERVE_PROMPTS)}: tp 2 (both shards on {rec['devices']}, expert blocks {rec['expert_block']} "
            f"contiguous, routing alike) teacher-forced on tp 1's tokens, {rec['rows']} logits rows: the "
            f"{len(rec['row_errs'])} whose token routed as tp 1's worst {rec['worst_row']:.2e} (limit "
            f"{MIXTRAL_TP_SERVE_ROW_TOL:.0e}), argmax tp 1's on the {rec['argmax_rows']} with a clear margin; "
            f"{len(rec['flipped_errs'])} routed otherwise (limit {MIXTRAL_TP_SERVE_FLIPS:.0%} of the rows): {flips}; "
            f"greedy tokens equal tp 1's on {rec['greedy_equal']} of {len(TP_SERVE_PROMPTS)} (reported); B7 "
            f"{rec['launches']} launches; decode ms/step tp 2 {rec['tp2_ms']:.2f} / tp 1 {rec['tp1_ms']:.2f} "
            f"(reported, not judged); planted fault, one shard's expert partial dropped: worst row routed as tp 1 "
            f"{rec['fault']['worst_row']:.2e}, {len(rec['fault']['flipped_errs'])} of {rec['fault']['rows']} rows "
            f"routed otherwise, failed; {card}")


def mixtral_tp_serve_phase(torch, mixtral, MG, card: str, cfg: dict | None = None, device: str = "cuda") -> dict:
    """``[mixtral-tp-serve]``: the TP engine with both shards on the one
    device against the tp=1 engine on the same seeded weights
    (Mixtral-8x7B widths cut to ``MIXTRAL_TP_SERVE_LAYERS`` layers, bf16;
    ``cfg`` and ``device`` another config and device). Both serve the
    prompts greedily (decode ms/step reported); then both are fed tp 1's
    tokens with their routes recorded, and ``forced_check`` holds tp 2's
    logits rows and routes to tp 1's. Every shard's expert blocks must be
    contiguous, and on the card the TP engine must launch B7 (its
    prefills). A planted fault (one shard's expert partial dropped) must
    fail ``forced_check``."""
    from tony_tpu_torch.models import generate
    from tony_tpu_torch.models.serving import ContinuousBatcher
    from tony_tpu_torch.parallel import expert

    cfg = cfg or {"preset": "mixtral-8x7b", "n_layers": MIXTRAL_TP_SERVE_LAYERS}
    model_cfg = mixtral.config_from_dict(cfg)
    with torch.no_grad():
        params = mixtral.init(torch.Generator(device=device).manual_seed(0), model_cfg, device)
    prompts = tp_serve_requests(model_cfg.vocab_size)
    kw = dict(num_slots=len(prompts), max_len=max(TP_SERVE_PROMPTS) + MIXTRAL_TP_SERVE_TOKENS + TP_SERVE_CHUNK,
              decode_chunk=TP_SERVE_CHUNK)
    one = ContinuousBatcher(params, model_cfg, **kw)
    want, tp1_ms = serve_tokens(torch, one, prompts, MIXTRAL_TP_SERVE_TOKENS)
    MG.reset_launches()
    eng = ContinuousBatcher(params, model_cfg, tp=2, devices=[device] * 2, **kw)
    got, tp2_ms = serve_tokens(torch, eng, prompts, MIXTRAL_TP_SERVE_TOKENS)
    launches = MG.launches["moe_fwd"]
    check(device != "cuda" or launches > 0, f"mixtral-tp-serve: the TP engine launched B7 {launches} times")
    blocks = [t["layers"][k] for t in eng.params.trees for k in ("we_gate", "we_up", "we_down")]
    check(all(b.is_contiguous() for b in blocks), "mixtral-tp-serve: a shard's expert block is not contiguous")
    F = model_cfg.d_ff // 2
    check([tuple(b.shape[-2:]) for b in blocks[:3]] == [(model_cfg.d_model, F)] * 2 + [(F, model_cfg.d_model)],
          f"mixtral-tp-serve: shard 0's expert blocks {[tuple(b.shape) for b in blocks[:3]]}")
    ref, ref_routes = forced_run(torch, expert, one.params, model_cfg, prompts, want, 1)
    reading = forced_reading(torch, *forced_run(torch, expert, eng.params, model_cfg, prompts, want, 2),
                             ref, ref_routes)
    forced_check(reading)
    real = generate._ffn_with_cache
    drop_last_shard_experts(generate, eng.params)
    try:
        fault = forced_reading(torch, *forced_run(torch, expert, eng.params, model_cfg, prompts, want, 2),
                               ref, ref_routes)
    finally:
        generate._ffn_with_cache = real
    try:
        forced_check(fault)
        caught = False
    except SmokeFailure:
        caught = True
    check(caught, "mixtral-tp-serve: the planted fault (one shard's expert partial dropped) passed")
    rec = {"preset": cfg.get("preset", ""), "layers": model_cfg.n_layers, "dtype": model_cfg.dtype,
           "devices": f"{device} twice", "expert_block": list(blocks[0].shape), **reading, "tokens": want,
           "greedy_equal": sum(a == b for a, b in zip(got, want)), "launches": launches, "tp1_ms": tp1_ms,
           "tp2_ms": tp2_ms, "fault": {k: fault[k] for k in ("rows", "worst_row", "flipped_errs")}}
    print(mixtral_tp_serve_line(rec, card), flush=True)
    return rec


# -- main ----------------------------------------------------------------------

# [cp-gang] (A12b): the context axis across a gang, CP_GANG_RANKS processes on
# the one card over gloo (``FSDP_BACKEND``; nccl refuses two ranks on one
# card), one context shard each: B9/B10 move KV and the riding dk/dv between
# the processes (``ProcessRing``: gloo's ``all_to_all_single`` to the right
# neighbour; ``gloo_cuda_probe``: gloo's point-to-point on CUDA tensors dies).
# Llama-3-8B widths cut to CP_GANG_LAYERS layers, B=1, T=CP_GANG_T,
# CP_GANG_STEPS steps and a save, then a step of each planted fault;
# Mixtral-8x7B widths cut to CP_GANG_MOE_LAYERS layer, B=1, T=CP_GANG_MOE_T,
# CP_GANG_STEPS steps and a save. Each held to one process with the context
# of 2 on a DeviceRing: the losses and grad norms (and Mixtral's router
# losses) within GANG_LOSS_REL (``FSDP_REL``), the last step's parameters and
# moments within FSDP_STATE_REL
#: (2 steps and 1 layer: with the other cuts, they keep the command within
#: its time limit beside the model-beside-context phase)
CP_GANG_RANKS, CP_GANG_STEPS = 2, 2
CP_GANG_LAYERS, CP_GANG_T = 1, 16384
CP_GANG_MOE_LAYERS, CP_GANG_MOE_T = 1, 8192
#: the planted faults: a ring whose KV never leaves its process (each slot
#: receives the process's own), and RoPE without the window's offset (each
#: window's positions from 0). At random weights over 8192 keys a window
#: attends nearly uniformly, so neither moves the loss or the grad norm past
#: GANG_LOSS_REL (H100: the local ring passed it); both move the step-1
#: gradients of the attention's projections (CP_GANG_GRAD_LEAVES), which
#: every rank and one process hold after the step's reduction, and which are
#: held within CP_STEP_GRAD_REL in relative norm a leaf, the whole-step
#: check's limit between the sound ring and a faulted one
CP_GANG_FAULTS = ("local-kv", "rope")
CP_GANG_GRAD_LEAVES = ("layers/wq", "layers/wk", "layers/wv")

# [cp-tp] (A12c): a model axis beside the context axis, CP_TP_RANKS processes
# on the one card over gloo, ``MeshSpec(context=2, model=2)``: each rank a
# window of T/2 on its model blocks (16 of Llama-3-8B's 32 query heads, 4 of
# its 8 kv heads, 7168 FFN columns, 64128 vocabulary rows), B9/B10 on those
# heads with KV moving between the two ranks of its model index, Megatron's
# pair and the vocab-parallel CE over its model line. Llama-3-8B widths cut
# to CP_TP_LAYERS layer, B=1, T=CP_TP_T, CP_TP_STEPS steps and a save, then a
# step of each planted fault; held to one process with the context of 2 on a
# DeviceRing as [cp-gang] is: losses and grad norms within GANG_LOSS_REL,
# the step-1 attention gradients, joined over the model line, within
# CP_STEP_GRAD_REL, the last step's state within FSDP_STATE_REL
CP_TP_CONTEXT, CP_TP_MODEL = 2, 2
CP_TP_RANKS = CP_TP_CONTEXT * CP_TP_MODEL
CP_TP_LAYERS, CP_TP_T, CP_TP_STEPS = 1, 8192, 2
#: the planted faults: a context ring across the model lines (each rank
#: receives the other model rank's kv heads), and ``reduce_from_model``
#: summing over the context line instead of the model line
CP_TP_FAULTS = ("cross-line", "context-sum")


def record_first_grads(trainer, names: tuple, path: Path | None = None) -> tuple:
    """While installed, the first AdamW update of this process leaves the
    gradients of ``names`` (as given to the update, on the CPU) in the dict
    returned, and writes them to ``path`` when one is given; the function
    returned uninstalls it."""
    import torch

    got, real = {}, trainer.AdamW.update

    def update(self, params, grads, state, norm):
        if not got:
            got.update({n: grads[n].detach().cpu() for n in names})
            if path is not None:
                torch.save(got, path)
        return real(self, params, grads, state, norm)

    trainer.AdamW.update = update
    return got, lambda: setattr(trainer.AdamW, "update", real)


def grad_rel(torch, got: dict, want: dict) -> dict:
    """‖a − b‖ / ‖b‖ in f32 of each leaf of ``want``."""
    return {n: float((got[n].float() - w.float()).norm() / w.float().norm().clamp_min(1e-30)) for n, w in want.items()}


def keep_kv_local(collectives) -> None:
    """A planted fault: every ``ProcessRing`` transfer stays in its process
    (each receive buffer gets the process's own send), on every rank, so
    no rank waits on a peer."""
    def local(self, src, dst):
        for a, b in zip(src, dst):
            b.copy_(a)
        return collectives._Done()

    collectives.ProcessRing.send_recv = local


def drop_rope_offset(llama) -> None:
    """A planted fault: a window's RoPE positions restart at 0 (unpacked rows
    take ``0…T/c`` instead of the window's global ``lo…hi``)."""
    real = llama.context_inputs

    def no_offset(tokens, mesh, segment_ids=None):
        t, seg, positions = real(tokens, mesh, segment_ids)
        return t, seg, positions if segment_ids is not None else None

    llama.context_inputs = no_offset


def crossed_context_lines(context: int = CP_TP_CONTEXT, model: int = CP_TP_MODEL) -> list:
    """The ranks of a ``context × model`` gang (rank ``c·model + m``) in
    rings that pair window 0 of model index m with the other windows of
    model index ``model - 1 - m``: each window keeps its ring position and
    receives another model rank's heads."""
    return [[c * model + (m if c == 0 else model - 1 - m) for c in range(context)] for m in range(model)]


def cross_line_ring(mesh_mod) -> None:
    """A planted fault of ``[cp-tp]``: each rank's context ring is a line of
    ``crossed_context_lines``, so the KV of the other model rank's heads
    arrives in place of its own. Every rank makes the crossed groups as it
    builds its mesh."""
    import torch.distributed as dist

    real = mesh_mod.ProcessRing

    def crossed(group=None):
        mine, _ = dist.new_subgroups_by_enumeration(crossed_context_lines())
        return real(mine)

    mesh_mod.ProcessRing = crossed


def context_sum(collectives) -> None:
    """A planted fault of ``[cp-tp]``: ``reduce_from_model`` sums its
    partials over the rank's context line instead of its model line (the
    embedding's rows and the row-parallel outputs of attention and the
    FFN); every rank makes the context lines' groups here."""
    import torch.distributed as dist

    lines = [[c * CP_TP_MODEL + m for c in range(CP_TP_CONTEXT)] for m in range(CP_TP_MODEL)]
    line, _ = dist.new_subgroups_by_enumeration(lines)

    def forward(ctx, x, group):
        ctx.group = group
        return collectives._psum_f32(x, line)

    collectives._ReduceFromModel.forward = staticmethod(forward)


def cp_gang_rank(spec_json: str) -> None:
    """One rank of the ``[cp-gang]`` or ``[cp-tp]`` gang (``RANK`` in the
    env; the spec's ``ranks`` of them): ``run_lm_training`` for each run of
    the spec (the sound runs, each with a save; each planted fault), each in
    a gloo group of its own (a file store under the spec's directory); each
    run's step reports, kernel launches, the fingerprint and shape of each
    leaf the rank hands a save, peak memory and wall. Writes
    ``rank<r>.json`` there."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from tony_tpu_torch.models import llama, mixtral
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import moe_gemm as MG
    from tony_tpu_torch.ops import ring as TR
    from tony_tpu_torch.parallel import collectives
    from tony_tpu_torch.parallel import mesh as mesh_mod
    from tony_tpu_torch.train import checkpoint as C
    from tony_tpu_torch.train import trainer
    from tony_tpu_torch.train.loop import LoopConfig, run_lm_training

    spec = json.loads(spec_json)
    rank, work = int(os.environ["RANK"]), Path(spec["dir"])
    cuda = spec["device"] == "cuda"
    real = (C.CheckpointManager.save, collectives.ProcessRing.send_recv, llama.context_inputs, trainer.AdamW.update,
            mesh_mod.ProcessRing, collectives._ReduceFromModel.forward)
    out = {}
    for run in spec["runs"]:
        saves: dict = {}

        def save(self, step, state, force=False):
            local = {name: t.to_local() if hasattr(t, "to_local") else t for name, t in _leaves(state)}
            saves[step] = {name: {"shape": list(t.shape), "fp": fingerprint(torch, t)}
                           for name, t in local.items() if hasattr(t, "shape")}
            return real[0](self, step, state, force=force)

        if cuda:
            torch.cuda.set_device(0)
            torch.cuda.reset_peak_memory_stats()
        dist.init_process_group(FSDP_BACKEND, init_method=f"file://{work / ('store-' + run)}",
                                world_size=spec.get("ranks", CP_GANG_RANKS), rank=rank)
        C.CheckpointManager.save = save
        if run == "local-kv":
            keep_kv_local(collectives)
        if run == "rope":
            drop_rope_offset(llama)
        if run == "cross-line":
            cross_line_ring(mesh_mod)
        if run == "context-sum":
            context_sum(collectives)
        record_first_grads(trainer, CP_GANG_GRAD_LEAVES, work / f"grads-{run}-rank{rank}.pt")
        for mod in (A, MG, TR):
            mod.reset_launches()
        model = {"llama": llama, "mixtral": mixtral}[spec[run]["model"]]
        t0 = time.perf_counter()
        try:
            res = run_lm_training(model, model.config_from_dict(spec[run]["cfg"]), LoopConfig(**spec[run]["loop"]))
        finally:
            (C.CheckpointManager.save, collectives.ProcessRing.send_recv, llama.context_inputs,
             trainer.AdamW.update, mesh_mod.ProcessRing) = real[:5]
            collectives._ReduceFromModel.forward = staticmethod(real[5])
        out[run] = {"log": res["log"], "launches": {**A.launches, **MG.launches, **TR.launches}, "saves": saves,
                    "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
                    "wall_s": time.perf_counter() - t0}
    (work / f"rank{rank}.json").write_text(json.dumps(out))


def cp_gang_launches(TR, my: int, L: int, S: int, Tl: int, moe: bool, n: int = CP_GANG_RANKS) -> dict:
    """The launches ring position ``my`` of a ring of ``n`` makes in S steps
    of L layers under remat "full" (the forward twice): B9 at the forward
    steps the schedule runs, B10 at the backward's, B7/B8 (Mixtral) once
    a layer pass."""
    fwd = sum(TR.fwd_step_runs(my, s, n, Tl, True, 0) for s in range(n))
    bwd = sum(TR.bwd_step_runs(my, s, n, Tl, True, 0) for s in range(n))
    out = {"ring_fwd": 2 * L * S * fwd, "ring_bwd_dq": L * S * bwd, "ring_bwd_dkv": L * S * bwd,
           "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    out.update({"moe_fwd": 2 * L * S, "moe_bwd": L * S} if moe else {"moe_fwd": 0, "moe_bwd": 0})
    return out


def cp_gang_line(rec: dict, card: str) -> str:
    """The ``[cp-gang]`` report line."""
    faults = "; ".join(f"{k}: loss {v['loss']} grad norm {v['grad_norm']} against one process's "
                       f"{rec['llama']['one_losses'][0]} / {rec['llama']['one_grad_norms'][0]}, step-1 "
                       f"{'/'.join(CP_GANG_GRAD_LEAVES)} gradients worst rel {v['worst_grad_rel']:.2e}, failed"
                       for k, v in rec["faults"].items())
    parts = []
    for fam in ("llama", "mixtral"):
        r = rec[fam]
        moe = (f", balance {r['balance']} z {r['z']} (one process {r['one_balance']} / {r['one_z']})"
               if fam == "mixtral" else "")
        state = (f"; step {r['restored_step']} parameters and moments against one process's, worst "
                 + ", ".join(f"{k} {v:.2e} ({r['state_leaf'][k]})" for k, v in r["state_rel"].items())
                 + f" (limit {FSDP_STATE_REL:.0e}); the save restored into one process bit for bit in "
                   f"{r['restore_s']:.1f} s")
        parts.append(f"{r['preset']} widths {r['layers']} layers B=1 T={r['seq_len']} (T/{CP_GANG_RANKS} a rank): losses "
                     f"{r['losses']} grad norms {r['grad_norms']} (one process {r['one_losses']} / "
                     f"{r['one_grad_norms']}, worst rel {r['worst_rel']:.2e}, limit {FSDP_REL:.0e}){moe}; step-1 "
                     f"{'/'.join(CP_GANG_GRAD_LEAVES)} gradients worst rel {r['worst_grad_rel']:.2e} (limit "
                     f"{CP_STEP_GRAD_REL:.0e}){state}; "
                     f"launches a rank {r['launches']} (the schedule's); ms/step a rank {r['step_ms']} (one process "
                     f"{r['one_step_ms']}); peak a rank {[round(b / 2**30, 2) for b in r['peak_bytes']]} GiB (one "
                     f"process {r['one_peak_bytes'] / 2**30:.2f} GiB)")
    return (f"[cp-gang] {CP_GANG_RANKS} ranks on one card over {FSDP_BACKEND}, context {CP_GANG_RANKS}, cp_impl "
            f"pallas: " + "; ".join(parts) + f"; seconds {rec['seconds']}; planted faults, {faults}; {card}")


def cp_gang_phase(torch, llama, mixtral, A, out_dir: Path, card: str, cfgs: dict | None = None,
                  T: tuple = (CP_GANG_T, CP_GANG_MOE_T), device: str = "cuda") -> dict:
    """``[cp-gang]``: the gang of ``CP_GANG_RANKS`` on the card with a
    context axis of as many (one shard a process, KV between the processes
    through B9/B10), at Llama-3-8B and Mixtral-8x7B widths cut to depth
    (``cfgs`` {"llama", "mixtral"}, ``T`` and ``device`` other configs,
    lengths and device): Llama ``CP_GANG_STEPS`` steps with a save, a step
    of each planted fault, Mixtral ``CP_GANG_STEPS`` steps with a save.
    Each rank's losses and grad norms (and router losses) must be one
    process's with the same context on a ``DeviceRing``
    (``run_lm_training`` here), each rank's launches the schedule's for its
    ring position, each save restored into one process the state the ranks
    handed it, bit for bit, and its parameters and moments one process's
    within ``FSDP_STATE_REL``; each planted fault must fail ``fsdp_check``.
    Prints per-rank peak memory, launches and ms/step."""
    from tony_tpu_torch.ops import moe_gemm as MG
    from tony_tpu_torch.ops import ring as TR
    from tony_tpu_torch.train import trainer
    from tony_tpu_torch.train.checkpoint import restore_or_init
    from tony_tpu_torch.train.loop import LoopConfig, run_lm_training
    from tony_tpu_torch.train.trainer import OptimizerConfig, TrainState

    cfgs = cfgs or {"llama": {"preset": "llama3-8b", "n_layers": CP_GANG_LAYERS, "cp_impl": "pallas"},
                    "mixtral": {"preset": "mixtral-8x7b", "n_layers": CP_GANG_MOE_LAYERS, "cp_impl": "pallas"}}
    cuda = device == "cuda"
    work = (out_dir / "cp-gang").resolve()  # the ranks' file store takes an absolute path
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    loops = {fam: dict(batch_size=1, seq_len=t, log_every=1, warmup_steps=1, context_axis=CP_GANG_RANKS,
                       device=device) for fam, t in zip(("llama", "mixtral"), T)}
    spec = {"dir": str(work), "device": device, "runs": ["llama-ok", *CP_GANG_FAULTS, "mixtral-ok"],
            **{f"{fam}-ok": {"model": fam, "cfg": cfgs[fam],
                             "loop": dict(loops[fam], steps=CP_GANG_STEPS, checkpoint_dir=str(work / f"ckpt-{fam}"),
                                          checkpoint_every=CP_GANG_STEPS)} for fam in ("llama", "mixtral")},
            **{f: {"model": "llama", "cfg": cfgs["llama"], "loop": dict(loops["llama"], steps=1)}
               for f in CP_GANG_FAULTS}}
    t0 = time.perf_counter()
    ranks = run_gang(work, spec, "cp_gang_rank", CP_GANG_RANKS, "cp-gang")
    seconds = {"gang": time.perf_counter() - t0}
    for run in spec["runs"]:
        print(f"[cp-gang] {run}: wall a rank {[round(x[run]['wall_s'], 1) for x in ranks]} s, ms/step a rank "
              f"{[[y['step_time_ms'] for y in x[run]['log']] for x in ranks]}, losses "
              f"{[[y['loss'] for y in x[run]['log']] for x in ranks]}; {card}", flush=True)

    def grads_of(run: str) -> list:
        return [torch.load(work / f"grads-{run}-rank{r}.pt") for r in range(CP_GANG_RANKS)]

    def worst_grad_rel(run: str, want: dict) -> float:
        return max(v for got in grads_of(run) for v in grad_rel(torch, got, want).values())

    rec: dict = {"faults": {}}
    for fam, model in (("llama", llama), ("mixtral", mixtral)):
        model_cfg = model.config_from_dict(cfgs[fam])
        run = f"{fam}-ok"
        if cuda:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        for mod in (A, MG, TR):
            mod.reset_launches()
        t0 = time.perf_counter()
        held, unhold = hold_final_state(trainer)  # the final state, held to the gang's save
        first, unrecord = record_first_grads(trainer, CP_GANG_GRAD_LEAVES)
        try:
            one = run_lm_training(model, model_cfg, LoopConfig(steps=CP_GANG_STEPS, **loops[fam]))["log"]
        finally:
            unrecord()
            unhold()
        seconds[f"one_{fam}"] = time.perf_counter() - t0
        one_launches = {**A.launches, **MG.launches, **TR.launches}
        one_peak = torch.cuda.max_memory_allocated() if cuda else 0
        keys = ("loss", "grad_norm") + (("moe_balance_loss", "moe_z_loss") if fam == "mixtral" else ())
        worst = fsdp_check(ranks, one, run, tag="cp-gang", keys=keys)
        worst_grad = worst_grad_rel(run, first)
        check(worst_grad <= CP_STEP_GRAD_REL, f"cp-gang: {fam} step-1 gradients of {CP_GANG_GRAD_LEAVES} against "
                                              f"one process's: {worst_grad:.2e} > {CP_STEP_GRAD_REL:.0e}")
        Tl = loops[fam]["seq_len"] // CP_GANG_RANKS
        launches = [rec_r[run]["launches"] for rec_r in ranks]
        for my, got in enumerate(launches):
            want = cp_gang_launches(TR, my, model_cfg.n_layers, CP_GANG_STEPS, Tl, fam == "mixtral")
            got = {k: got[k] for k in want}
            check(got == want if cuda else not any(got.values()),
                  f"cp-gang: {fam} rank {my} launches {got}, the schedule's {want}")
        check(all(sum(x[k] for x in launches) == one_launches[k] for k in TR.launches),
              f"cp-gang: {fam} the ranks' ring launches {launches} do not add up to one process's {one_launches}")
        log0 = ranks[0][run]["log"]
        r = {"preset": cfgs[fam]["preset"], "layers": model_cfg.n_layers, "seq_len": loops[fam]["seq_len"],
             "losses": [x["loss"] for x in log0], "grad_norms": [x["grad_norm"] for x in log0],
             "one_losses": [x["loss"] for x in one], "one_grad_norms": [x["grad_norm"] for x in one],
             "worst_rel": worst, "worst_grad_rel": worst_grad,
             "launches": [{k: v for k, v in x.items() if v} for x in launches],
             "one_launches": {k: v for k, v in one_launches.items() if v},
             "step_ms": [[x["step_time_ms"] for x in rec_r[run]["log"]] for rec_r in ranks],
             "one_step_ms": [x["step_time_ms"] for x in one], "peak_bytes": [rec_r[run]["peak_bytes"] for rec_r in ranks],
             "one_peak_bytes": one_peak, "wall_s": [round(rec_r[run]["wall_s"], 1) for rec_r in ranks]}
        if fam == "mixtral":
            r.update(balance=[x["moe_balance_loss"] for x in log0], z=[x["moe_z_loss"] for x in log0],
                     one_balance=[x["moe_balance_loss"] for x in one], one_z=[x["moe_z_loss"] for x in one])
        else:
            for fault in CP_GANG_FAULTS:
                got = {k: [x[fault]["log"][0][k] for x in ranks] for k in ("loss", "grad_norm")}
                got["worst_grad_rel"] = worst_grad_rel(fault, first)
                try:
                    fsdp_check(ranks, one, fault, tag="cp-gang")
                    check(got["worst_grad_rel"] <= CP_STEP_GRAD_REL, "step-1 gradients")
                except SmokeFailure:
                    rec["faults"][fault] = got
                check(fault in rec["faults"], f"cp-gang: the planted fault {fault!r} passed: {got}")
        one_state = {part: held[part] for part in ("params", "mu", "nu")}
        opt = OptimizerConfig(learning_rate=3e-4, warmup_steps=1, total_steps=CP_GANG_STEPS).build()
        t0 = time.perf_counter()
        state, _, step = restore_or_init(str(work / f"ckpt-{fam}"), lambda: TrainState.create(
            model.init(torch.Generator(device=device).manual_seed(1), model_cfg, device), opt), TrainState.load)
        r["restore_s"] = time.perf_counter() - t0
        check(step == CP_GANG_STEPS, f"cp-gang: {fam} one process restored step {step}, want {CP_GANG_STEPS}")
        fsdp_blocks(torch, ranks, state.state_dict(), step, tag=f"cp-gang {fam}", run=run)
        r["state_leaf"] = {}
        r["state_rel"] = fsdp_state_check(torch, state.state_dict(), one_state, ranks[0][run]["saves"][str(step)],
                                          f"{fam} step {step}", tag="cp-gang", leaves=r["state_leaf"])
        r["restored_step"] = step
        del state, one_state, held
        rec[fam] = r
    shutil.rmtree(work, ignore_errors=True)
    rec["seconds"] = {k: round(v, 1) for k, v in seconds.items()}
    rec["launches_sum"] = {k: sum(x[f"{fam}-ok"]["launches"][k] for x in ranks for fam in ("llama", "mixtral"))
                           for k in ranks[0]["llama-ok"]["launches"]}
    print(cp_gang_line(rec, card), flush=True)
    return rec


def cp_tp_line(rec: dict, card: str) -> str:
    """The ``[cp-tp]`` report line."""
    faults = "; ".join(f"{k}: loss {v['loss']} grad norm {v['grad_norm']} against one process's "
                       f"{rec['one_losses'][0]} / {rec['one_grad_norms'][0]}, step-1 "
                       f"{'/'.join(CP_GANG_GRAD_LEAVES)} gradients worst rel {v['worst_grad_rel']:.2e}, failed"
                       for k, v in rec["faults"].items())
    state = ", ".join(f"{k} {v:.2e} ({rec['state_leaf'][k]})" for k, v in rec["state_rel"].items())
    return (f"[cp-tp] {CP_TP_RANKS} ranks on one card over {FSDP_BACKEND}, context {CP_TP_CONTEXT} x model "
            f"{CP_TP_MODEL}, cp_impl pallas: {rec['preset']} widths {rec['layers']} layer(s) B=1 T={rec['seq_len']} "
            f"(T/{CP_TP_CONTEXT} a rank on {rec['heads']} query and {rec['kv_heads']} kv heads): losses "
            f"{rec['losses']} grad norms {rec['grad_norms']} (one process, context {CP_TP_CONTEXT} on a DeviceRing: "
            f"{rec['one_losses']} / {rec['one_grad_norms']}, worst rel {rec['worst_rel']:.2e}, limit "
            f"{FSDP_REL:.0e}); step-1 {'/'.join(CP_GANG_GRAD_LEAVES)} gradients joined over the model line, worst "
            f"rel {rec['worst_grad_rel']:.2e} (limit {CP_STEP_GRAD_REL:.0e}); step {rec['restored_step']} "
            f"parameters and moments against one process's, worst {state} (limit {FSDP_STATE_REL:.0e}); the save "
            f"restored into one process bit for bit in {rec['restore_s']:.1f} s; launches a rank {rec['launches']} "
            f"(the schedule's); ms/step a rank {rec['step_ms']} (one process {rec['one_step_ms']}); per rank "
            f"params {rec['param_bytes'] / 1e9:.3f} GB + moments {rec['opt_bytes'] / 1e9:.3f} GB, peak a rank "
            f"{[round(b / 2**30, 2) for b in rec['peak_bytes']]} GiB (one process {rec['one_peak_bytes'] / 2**30:.2f} "
            f"GiB); seconds {rec['seconds']}; planted faults, {faults}; {card}")


def cp_tp_phase(torch, llama, A, out_dir: Path, card: str, cfg: dict | None = None, T: int = CP_TP_T,
                device: str = "cuda") -> dict:
    """``[cp-tp]``: the gang of ``CP_TP_RANKS`` on the card on ``context
    CP_TP_CONTEXT × model CP_TP_MODEL`` (one window and one model block a
    process, KV between the ranks of a model index through B9/B10) at
    Llama-3-8B widths cut to depth (``cfg``, ``T`` and ``device`` another
    config, length and device): ``CP_TP_STEPS`` steps with a save, then a
    step of each planted fault. Each rank's losses and grad norms must be
    one process's with the context on a ``DeviceRing`` (``run_lm_training``
    here), the step-1 attention gradients joined over the model line
    within ``CP_STEP_GRAD_REL``, each rank's launches the schedule's for its
    ring position, the save restored into one process the blocks the
    ranks handed it, bit for bit, and its state one process's within
    ``FSDP_STATE_REL``; each planted fault must fail a check. Prints the
    bytes a rank, its peak memory, launches and ms/step."""
    from tony_tpu_torch.ops import ring as TR
    from tony_tpu_torch.train import trainer
    from tony_tpu_torch.train.checkpoint import restore_or_init
    from tony_tpu_torch.train.loop import LoopConfig, run_lm_training
    from tony_tpu_torch.train.trainer import OptimizerConfig, TrainState

    cfg = cfg or {"preset": "llama3-8b", "n_layers": CP_TP_LAYERS, "cp_impl": "pallas"}
    model_cfg = llama.config_from_dict(cfg)
    cuda = device == "cuda"
    work = (out_dir / "cp-tp").resolve()  # the ranks' file store takes an absolute path
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    loop = dict(batch_size=1, seq_len=T, log_every=1, warmup_steps=1, context_axis=CP_TP_CONTEXT, device=device)
    gang_loop = dict(loop, model_axis=CP_TP_MODEL)
    spec = {"dir": str(work), "device": device, "ranks": CP_TP_RANKS, "runs": ["ok", *CP_TP_FAULTS],
            "ok": {"model": "llama", "cfg": cfg, "loop": dict(gang_loop, steps=CP_TP_STEPS, checkpoint_dir=str(
                work / "ckpt"), checkpoint_every=CP_TP_STEPS)},
            **{f: {"model": "llama", "cfg": cfg, "loop": dict(gang_loop, steps=1)} for f in CP_TP_FAULTS}}
    t0 = time.perf_counter()
    ranks = run_gang(work, spec, "cp_gang_rank", CP_TP_RANKS, "cp-tp")
    seconds = {"gang": time.perf_counter() - t0}
    for run in spec["runs"]:
        print(f"[cp-tp] {run}: wall a rank {[round(x[run]['wall_s'], 1) for x in ranks]} s, ms/step a rank "
              f"{[[y['step_time_ms'] for y in x[run]['log']] for x in ranks]}, losses "
              f"{[[y['loss'] for y in x[run]['log']] for x in ranks]}; {card}", flush=True)
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    TR.reset_launches()
    t0 = time.perf_counter()
    held, unhold = hold_final_state(trainer)  # the final state, held to the gang's save
    first, unrecord = record_first_grads(trainer, CP_GANG_GRAD_LEAVES)
    try:
        one = run_lm_training(llama, model_cfg, LoopConfig(steps=CP_TP_STEPS, **loop))["log"]
    finally:
        unrecord()
        unhold()
    seconds["one"] = time.perf_counter() - t0
    one_launches = dict(TR.launches)
    one_peak = torch.cuda.max_memory_allocated() if cuda else 0

    def worst_grad_rel(run: str) -> float:
        """The step-1 gradients of each context rank's model line, joined
        along the dim the model axis splits, against one process's."""
        got = [torch.load(work / f"grads-{run}-rank{r}.pt") for r in range(CP_TP_RANKS)]
        worst = 0.0
        for c in range(CP_TP_CONTEXT):
            line = got[c * CP_TP_MODEL:(c + 1) * CP_TP_MODEL]
            joined = {}
            for n, w in first.items():
                d = next(i for i in range(w.ndim) if line[0][n].shape[i] != w.shape[i])
                joined[n] = torch.cat([g[n] for g in line], d)
            worst = max(worst, *grad_rel(torch, joined, first).values())
        return worst

    rec = {"preset": cfg.get("preset", ""), "layers": model_cfg.n_layers, "seq_len": T,
           "heads": model_cfg.n_heads // CP_TP_MODEL, "kv_heads": model_cfg.n_kv_heads // CP_TP_MODEL, "faults": {}}
    rec["worst_rel"] = fsdp_check(ranks, one, "ok", tag="cp-tp")
    rec["worst_grad_rel"] = worst_grad_rel("ok")
    check(rec["worst_grad_rel"] <= CP_STEP_GRAD_REL,
          f"cp-tp: step-1 gradients of {CP_GANG_GRAD_LEAVES} joined over the model line against one process's: "
          f"{rec['worst_grad_rel']:.2e} > {CP_STEP_GRAD_REL:.0e}")
    Tl = T // CP_TP_CONTEXT
    launches = [x["ok"]["launches"] for x in ranks]
    for r, got in enumerate(launches):
        want = cp_gang_launches(TR, r // CP_TP_MODEL, model_cfg.n_layers, CP_TP_STEPS, Tl, False, n=CP_TP_CONTEXT)
        got = {k: got[k] for k in want}
        check(got == want if cuda else not any(got.values()),
              f"cp-tp: rank {r} (ring position {r // CP_TP_MODEL}) launches {got}, the schedule's {want}")
    check(all(sum(x[k] for x in launches) == CP_TP_MODEL * one_launches[k] for k in TR.launches),
          f"cp-tp: the ranks' ring launches {launches} are not {CP_TP_MODEL} times one process's {one_launches}")
    for fault in CP_TP_FAULTS:
        got = {k: [x[fault]["log"][0][k] for x in ranks] for k in ("loss", "grad_norm")}
        got["worst_grad_rel"] = worst_grad_rel(fault)
        try:
            fsdp_check(ranks, one, fault, tag="cp-tp")
            check(got["worst_grad_rel"] <= CP_STEP_GRAD_REL, "step-1 gradients")
        except SmokeFailure:
            rec["faults"][fault] = got
        check(fault in rec["faults"], f"cp-tp: the planted fault {fault!r} passed: {got}")
    one_state = {part: held[part] for part in ("params", "mu", "nu")}
    opt = OptimizerConfig(learning_rate=3e-4, warmup_steps=1, total_steps=CP_TP_STEPS).build()
    t0 = time.perf_counter()
    state, _, step = restore_or_init(str(work / "ckpt"), lambda: TrainState.create(
        llama.init(torch.Generator(device=device).manual_seed(1), model_cfg, device), opt), TrainState.load)
    rec["restore_s"] = time.perf_counter() - t0
    check(step == CP_TP_STEPS, f"cp-tp: one process restored step {step}, want {CP_TP_STEPS}")
    split = fsdp_blocks(torch, ranks, state.state_dict(), step, tag="cp-tp", run="ok",
                        index=lambda r: r % CP_TP_MODEL)
    check(split > 0, "cp-tp: no leaf was split over the model axis")
    rec["state_leaf"] = {}
    rec["state_rel"] = fsdp_state_check(torch, state.state_dict(), one_state, ranks[0]["ok"]["saves"][str(step)],
                                        f"step {step}", tag="cp-tp", leaves=rec["state_leaf"])
    rec["restored_step"] = step
    del state, one_state, held
    log0 = ranks[0]["ok"]["log"]
    rec.update(losses=[x["loss"] for x in log0], grad_norms=[x["grad_norm"] for x in log0],
               one_losses=[x["loss"] for x in one], one_grad_norms=[x["grad_norm"] for x in one],
               launches=[{k: v for k, v in x.items() if v} for x in launches],
               one_launches={k: v for k, v in one_launches.items() if v},
               step_ms=[[x["step_time_ms"] for x in r_["ok"]["log"]] for r_ in ranks],
               one_step_ms=[x["step_time_ms"] for x in one], peak_bytes=[r_["ok"]["peak_bytes"] for r_ in ranks],
               one_peak_bytes=one_peak, param_bytes=log0[-1].get("param_bytes", 0),
               opt_bytes=log0[-1].get("opt_bytes", 0), split_leaves=split)
    rec["launches_sum"] = {k: sum(x["ok"]["launches"][k] for x in ranks) for k in ranks[0]["ok"]["launches"]}
    shutil.rmtree(work, ignore_errors=True)
    rec["seconds"] = {k: round(v, 1) for k, v in seconds.items()}
    print(cp_tp_line(rec, card), flush=True)
    return rec


# [pp] (A13a): the 1F1B schedule across a gang of PP_RANKS processes on the
# one card over gloo, ``MeshSpec(stage=2)``: each rank one stage (its L/2
# layers; the embedding on stage 0, the final norm and head on stage 1),
# the activations and gradients a tick over ``ProcessRing.exchange``.
# Llama-3-8B widths at PP_LAYERS layers, B=PP_B, T=PP_T, PP_M microbatches,
# remat "full", PP_STEPS steps and a save, then a step of each Llama fault;
# Mixtral-8x7B widths at PP_MOE_LAYERS layers, the same B, T and M,
# PP_MOE_STEPS steps and a save, then a step of its fault. Held to one
# process's flat ``make_train_step`` on the same seed and batches with
# ``accum_steps`` PP_M (run before the gang, never beside it: JAX's scan
# over the same microbatches, so Mixtral's router losses are the same
# per-microbatch statistics as the schedule's): losses and grad norms within
# GANG_LOSS_REL, the step-1 gradients of every leaf a rank holds within
# CP_STEP_GRAD_REL of the leaf's max (JAX's rule for its 1F1B tests; the
# router printed apart), the last step's state within FSDP_STATE_REL, each
# save restored into one process bit for bit
PP_RANKS, PP_B, PP_T, PP_M = 2, 4, 2048, 4
PP_LAYERS, PP_STEPS = 2, 3
PP_MOE_LAYERS, PP_MOE_STEPS = 2, 2
#: the planted faults: the backward unit reads the residual slot of the
#: next microbatch; the tick loop stops one tick early (stage 0's last
#: backward never runs); Mixtral's aux cotangent seeded without the
#: pre-counted tokens
PP_FAULTS = ("stale-residual", "short-schedule", "aux-unseeded")
PP_RUNS = ("llama-ok", "stale-residual", "short-schedule", "mixtral-ok", "aux-unseeded")


def plant_pp_fault(run: str, pipeline) -> None:
    """Install ``run``'s planted fault in ``pipeline`` (nothing for a sound run)."""
    if run == "stale-residual":
        pipeline.Schedule.read_slot = lambda self, m: (m + 1) % (2 * self.stages)
    if run == "short-schedule":
        pipeline.Schedule.ticks = lambda self: self.microbatches + 2 * self.stages - 2
    if run == "aux-unseeded":
        real = pipeline.spmd_pipeline_1f1b
        pipeline.spmd_pipeline_1f1b = lambda *a, **k: real(*a, **{**k, "aux_seed_scale": 1.0})


def max_rel(torch, got, want) -> float:
    """‖got − want‖∞ / ‖want‖∞ in f32 (JAX's rule in its 1F1B tests)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def pp_stage_block(name: str, whole, stage: int, stages: int = PP_RANKS):
    """The part of a whole leaf that stage ``stage`` holds: its block of a
    stacked layer leaf, the leaf itself otherwise."""
    return whole.chunk(stages, 0)[stage] if name.startswith("layers/") else whole


def pp_rank(spec_json: str) -> None:
    """One rank of the ``[pp]`` gang (``RANK`` in the env, its stage):
    ``run_lm_training`` with ``stage_axis`` 2 for each run of the spec, each
    in a gloo group of its own (a file store under the spec's directory):
    each run's step reports, kernel launches, the step-1 gradient error of
    each leaf it holds against one process's (read from the spec's file),
    the schedule's ``Ticks`` a step, the fingerprint and shape
    of each leaf it hands a save, peak memory and wall. Writes
    ``rank<r>.json`` there."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from tony_tpu_torch.models import llama, mixtral
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import moe_gemm as MG
    from tony_tpu_torch.parallel import pipeline
    from tony_tpu_torch.train import checkpoint as C
    from tony_tpu_torch.train import trainer
    from tony_tpu_torch.train.loop import LoopConfig, run_lm_training

    spec = json.loads(spec_json)
    rank, work = int(os.environ["RANK"]), Path(spec["dir"])
    cuda = spec["device"] == "cuda"
    real = (C.CheckpointManager.save, pipeline.Schedule.read_slot, pipeline.Schedule.ticks,
            pipeline.spmd_pipeline_1f1b, trainer.AdamW.update)
    out, refs = {}, {}
    for run in spec["runs"]:
        saves, errs, stats, timing = {}, {}, [], {}
        fam = spec[run]["model"]

        def save(self, step, state, force=False):
            local = {name: t.to_local() if hasattr(t, "to_local") else t for name, t in _leaves(state)}
            saves[step] = {name: {"shape": list(t.shape), "fp": fingerprint(torch, t)}
                           for name, t in local.items() if hasattr(t, "shape")}
            return real[0](self, step, state, force=force)

        def update(self, params, grads, state, norm):
            if not errs:  # the first step's gradients against one process's, leaf by leaf
                t0 = time.perf_counter()
                if fam not in refs:  # this stage's part of them, read once a family
                    refs.clear()
                    whole = torch.load(work / f"ref-{fam}.pt", mmap=True)
                    refs[fam] = {n: pp_stage_block(n, whole[n], rank).to(g.device) for n, g in grads.items()}
                    del whole
                for name, g in grads.items():
                    errs[name] = max_rel(torch, g, refs[fam][name])
                timing["compare_s"] = time.perf_counter() - t0
            return real[4](self, params, grads, state, norm)

        if cuda:
            torch.cuda.set_device(0)
            torch.cuda.reset_peak_memory_stats()
        dist.init_process_group(FSDP_BACKEND, init_method=f"file://{work / ('store-' + run)}",
                                world_size=PP_RANKS, rank=rank)
        C.CheckpointManager.save = save
        trainer.AdamW.update = update
        plant_pp_fault(run, pipeline)
        schedule = pipeline.spmd_pipeline_1f1b

        def timed(*a, schedule=schedule, stats=stats, **k):
            out = schedule(*a, **k)
            stats.append(dict(vars(out[-1])))
            return out

        pipeline.spmd_pipeline_1f1b = timed
        for mod in (A, MG):
            mod.reset_launches()
        model = {"llama": llama, "mixtral": mixtral}[fam]
        t0 = time.perf_counter()
        try:
            res = run_lm_training(model, model.config_from_dict(spec[run]["cfg"]), LoopConfig(**spec[run]["loop"]))
        finally:
            (C.CheckpointManager.save, pipeline.Schedule.read_slot, pipeline.Schedule.ticks,
             pipeline.spmd_pipeline_1f1b, trainer.AdamW.update) = real
        out[run] = {"log": res["log"], "launches": {**A.launches, **MG.launches}, "saves": saves, "grad_err": errs,
                    "stats": stats, "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
                    "wall_s": time.perf_counter() - t0, **timing}
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    (work / f"rank{rank}.json").write_text(json.dumps(out))


def pp_launches(L: int, steps: int, moe: bool, stage: int, M: int = PP_M, stages: int = PP_RANKS) -> dict:
    """Stage ``stage``'s launches in ``steps`` steps of L layers (L/S a
    stage) under remat "full": B1 (B7) three times a layer and microbatch
    (the forward unit, then the backward unit's recompute and its remat
    replay), twice on the last stage (its forward unit runs no layer), B2,
    B3 (B8) once."""
    passes = M * (L // stages) * steps
    fwd = (2 if stage == stages - 1 else 3) * passes
    out = {"flash_fwd": fwd, "flash_bwd_dq": passes, "flash_bwd_dkv": passes}
    out.update({"moe_fwd": fwd, "moe_bwd": passes} if moe else {"moe_fwd": 0, "moe_bwd": 0})
    return out


def pp_bytes(tree: dict, stage: int, stages: int = PP_RANKS) -> dict:
    """A stage's parameters (its L/S layers, the embedding on the first
    stage, the final norm and head on the last) and the bytes it holds of
    them, of their moments, of the f32 accumulators and the gradients,
    reckoned from the parameter tree (on the meta device) before any run."""
    from tony_tpu_torch.parallel.sharding import stage_owner

    n = nbytes = 0
    for name, t in _leaves(tree):
        owner = stage_owner(name, stages)
        if owner is None:
            k = t.numel() // stages
        elif owner == stage:
            k = t.numel()
        else:
            continue
        n += k
        nbytes += k * t.element_size()
    return {"params": n, "param_bytes": nbytes, "moment_bytes": 2 * nbytes, "grad_bytes": nbytes,
            "acc_bytes": 4 * n, "total_bytes": 4 * nbytes + 4 * n}


def pp_reference(torch, model, model_cfg, steps: int, B: int, T: int, device: str, grads_path: Path) -> dict:
    """One process's ``steps`` of ``make_train_step`` with ``accum_steps``
    PP_M from the weights and batches the loop draws on its seed (the
    loop's init and synthetic batches): each step's loss, grad norm and ms,
    the step-1 gradients written to ``grads_path`` in each leaf's dtype (the
    schedule's are cast to it), the final state on the host, and the peak
    memory."""
    from tony_tpu_torch.train import trainer
    from tony_tpu_torch.train.loop import _batch_generator

    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    opt = trainer.OptimizerConfig(learning_rate=3e-4, warmup_steps=1, total_steps=steps).build()
    state = trainer.TrainState.create(model.init(torch.Generator(device=device).manual_seed(0), model_cfg, device),
                                      opt)
    step_fn = trainer.make_train_step(functools.partial(model.loss_fn, cfg=model_cfg), opt, accum_steps=PP_M)
    dtypes = {n: p.dtype for n, p in _leaves(state.params)}
    real = trainer.AdamW.update

    def update(self, params, grads, opt_state, norm):
        if opt_state["count"] == 0:  # the step-1 gradients, in each leaf's dtype, as the schedule gives them
            torch.save({n: g.detach().to(dtypes[n]).cpu() for n, g in grads.items()}, grads_path)
        return real(self, params, grads, opt_state, norm)

    trainer.AdamW.update = update
    log = []
    try:
        for s in range(steps):
            batch = model.synthetic_batch(_batch_generator(torch.device(device), 0, s), B, T, model_cfg)
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            loss, norm = float(m["loss"]), float(m["grad_norm"])  # synchronises the device
            log.append({"step": s + 1, "loss": loss, "grad_norm": norm,
                        "step_time_ms": round((time.perf_counter() - t0) * 1000, 2)})
    finally:
        trainer.AdamW.update = real
    out = {"log": log, "peak": torch.cuda.max_memory_allocated() if cuda else 0,
           "state": {"params": {n: t.detach().cpu() for n, t in _leaves(state.params)},
                     **{part: {n: t.cpu() for n, t in state.opt_state[part].items()} for part in ("mu", "nu")}}}
    del state, step_fn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def pp_line(rec: dict, card: str) -> str:
    """The ``[pp]`` report line."""
    faults = "; ".join(f"{k}: loss {v['loss']} grad norm {v['grad_norm']} against one process's "
                       f"{v['one_loss']} / {v['one_grad_norm']}, step-1 gradients worst rel {v['worst_grad']:.2e} "
                       f"({v['worst_leaf']})" + (f", router {v['router']:.2e}" if "router" in v else "") + ", failed"
                       for k, v in rec["faults"].items())
    parts = []
    for fam in ("llama", "mixtral"):
        r = rec[fam]
        router = f", router {r['router_err']:.2e}" if fam == "mixtral" else ""
        state = ", ".join(f"{k} {v:.2e} ({r['state_leaf'][k]})" for k, v in r["state_rel"].items())
        parts.append(
            f"{r['preset']} widths {r['layers']} layers B={r['batch']} T={r['seq_len']} M={PP_M}: losses {r['losses']} "
            f"grad norms "
            f"{r['grad_norms']} (one process {r['one_losses']} / {r['one_grad_norms']}, worst rel "
            f"{r['worst_rel']:.2e}, limit {FSDP_REL:.0e}); step-1 gradients of every leaf a rank holds, worst "
            f"{r['worst_grad']:.2e} ({r['worst_leaf']}){router} (limit {CP_STEP_GRAD_REL:.0e}); step "
            f"{r['restored_step']} parameters and moments against one process's, worst {state} (limit "
            f"{FSDP_STATE_REL:.0e}); the save restored into one process bit for bit in {r['restore_s']:.1f} s; "
            f"launches a rank {r['launches']} (the schedule's); reckoned a rank {r['reckoned']}; peak a rank "
            f"{[round(b / 2**30, 2) for b in r['peak_bytes']]} GiB (one process {r['one_peak_bytes'] / 2**30:.2f} "
            f"GiB); ms/step a rank {r['step_ms']} (first step apart; one process {r['one_step_ms']}); "
            f"{r['ticks']} ticks a step; shares of a rank's steps after the first: waiting for its own units "
            f"before the ring exchange {r['sync_share']}, in the ring exchange {r['exchange_share']} (the "
            f"transfer and the wait for the peer), the fastest tick's exchange times the ticks "
            f"{r['transfer_share']} (the transfer alone, at most)")
    return (f"[pp] {PP_RANKS} ranks on one card over {FSDP_BACKEND}, stage {PP_RANKS}, 1F1B: " + "; ".join(parts)
            + f"; seconds {rec['seconds']}; planted faults, {faults}; {card}")


def pp_phase(torch, llama, mixtral, out_dir: Path, card: str, cfgs: dict | None = None,
             B: int = PP_B, T: int = PP_T, device: str = "cuda") -> dict:
    """``[pp]``: the 1F1B gang of ``PP_RANKS`` on the card, one stage a
    process, at Llama-3-8B and Mixtral-8x7B widths cut to depth (``cfgs``
    {"llama", "mixtral"}, ``B``, ``T`` and ``device`` other configs, sizes
    and device): Llama ``PP_STEPS`` steps with a save and a step of each of
    its faults, Mixtral ``PP_MOE_STEPS`` steps with a save and a step of its
    fault. One process first runs each family's flat step on the same seed,
    its step-1 gradients written for the ranks. Each rank's losses and grad
    norms must be one process's within ``GANG_LOSS_REL`` and the two ranks'
    the same, its step-1 gradients within ``CP_STEP_GRAD_REL`` (the router
    printed apart), its launches the schedule's, each save restored into
    one process the leaves the ranks handed it, bit for bit, its state one
    process's within ``FSDP_STATE_REL``; each planted fault must fail a
    check. Prints the bytes reckoned a rank, peak memory, ms/step, ticks and
    the shares of a step that the schedule's clocks (``pipeline.Ticks``)
    read."""
    from tony_tpu_torch.train.checkpoint import restore_or_init
    from tony_tpu_torch.train.trainer import OptimizerConfig, TrainState

    cfgs = cfgs or {"llama": {"preset": "llama3-8b", "n_layers": PP_LAYERS},
                    "mixtral": {"preset": "mixtral-8x7b", "n_layers": PP_MOE_LAYERS}}
    models = {"llama": llama, "mixtral": mixtral}
    steps = {"llama": PP_STEPS, "mixtral": PP_MOE_STEPS}
    cuda = device == "cuda"
    work = (out_dir / "pp").resolve()  # the ranks' file store takes an absolute path
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    loop = dict(batch_size=B, seq_len=T, log_every=1, warmup_steps=1, device=device)
    pp = dict(loop, stage_axis=PP_RANKS, pp_microbatches=PP_M)
    fam_of = {"llama-ok": "llama", "stale-residual": "llama", "short-schedule": "llama", "mixtral-ok": "mixtral",
              "aux-unseeded": "mixtral"}
    spec = {"dir": str(work), "device": device, "runs": list(PP_RUNS),
            **{run: {"model": fam, "cfg": cfgs[fam],
                     "loop": dict(pp, steps=steps[fam], checkpoint_dir=str(work / f"ckpt-{fam}"),
                                  checkpoint_every=steps[fam]) if run.endswith("-ok") else dict(pp, steps=1)}
               for run, fam in fam_of.items()}}
    rec: dict = {"faults": {}}
    seconds: dict = {}
    shapes = {fam: model.init(torch.Generator(), model.config_from_dict(cfgs[fam]), "meta")
              for fam, model in models.items()}
    reckoned = {fam: [pp_bytes(shapes[fam], s) for s in range(PP_RANKS)] for fam in models}
    for fam, r in reckoned.items():
        print(f"[pp] {fam} reckoned a rank before any run: " + "; ".join(
            f"stage {s}: {x['params'] / 1e9:.3f} G parameters, {x['total_bytes'] / 2**30:.2f} GiB of parameters, "
            f"moments, gradients and f32 accumulators" for s, x in enumerate(r)), flush=True)

    # one process's steps first, each family's step-1 gradients on disk
    one: dict = {}
    for fam, model in models.items():
        t0 = time.perf_counter()
        one[fam] = pp_reference(torch, model, model.config_from_dict(cfgs[fam]), steps[fam], B, T, device,
                                work / f"ref-{fam}.pt")
        seconds[f"one_{fam}"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ranks = run_gang(work, spec, "pp_rank", PP_RANKS, "pp", timeout=900)
    seconds["gang"] = time.perf_counter() - t0
    for run in PP_RUNS:
        print(f"[pp] {run}: wall a rank {[round(x[run]['wall_s'], 1) for x in ranks]} s (the step-1 gradient "
              f"comparison {[round(x[run].get('compare_s', 0), 1) for x in ranks]} s of it), ms/step a rank "
              f"{[[y['step_time_ms'] for y in x[run]['log']] for x in ranks]}, losses "
              f"{[[y['loss'] for y in x[run]['log']] for x in ranks]}, step-1 gradients worst rel a rank "
              f"{[max(x[run]['grad_err'].values()) for x in ranks]}; {card}", flush=True)

    def grad_worst(run: str) -> tuple[float, str]:
        return max((e, n) for x in ranks for n, e in x[run]["grad_err"].items())

    for fam, model in models.items():
        model_cfg = model.config_from_dict(cfgs[fam])
        run = f"{fam}-ok"
        keys = ("loss", "grad_norm")
        worst = fsdp_check(ranks, one[fam]["log"], run, tag="pp", keys=keys)
        logs = [[{k: x[k] for k in ("step", *keys)} for x in r_[run]["log"]] for r_ in ranks]
        check(all(lg == logs[0] for lg in logs), f"pp: {fam} the ranks' losses and grad norms differ: {logs}")
        router = max((e for x in ranks for n, e in x[run]["grad_err"].items() if n == "layers/router"), default=0.0)
        worst_grad, worst_leaf = max((e, n) for x in ranks for n, e in x[run]["grad_err"].items()
                                     if n != "layers/router")
        print(f"[pp] {fam} step-1 gradients a rank: "
              + "; ".join(f"rank {i} " + ", ".join(f"{n} {e:.2e}" for n, e in sorted(x[run]["grad_err"].items()))
                          for i, x in enumerate(ranks)), flush=True)
        check(worst_grad <= CP_STEP_GRAD_REL, f"pp: {fam} step-1 gradient of {worst_leaf} against one process's: "
                                              f"{worst_grad:.2e} > {CP_STEP_GRAD_REL:.0e}")
        check(router <= CP_STEP_GRAD_REL, f"pp: {fam} step-1 router gradient against one process's: "
                                          f"{router:.2e} > {CP_STEP_GRAD_REL:.0e}")
        launches = [r_[run]["launches"] for r_ in ranks]
        want = [pp_launches(model_cfg.n_layers, steps[fam], fam == "mixtral", i) for i in range(PP_RANKS)]
        for i, got in enumerate(launches):
            got = {k: got[k] for k in want[i]}
            check(got == want[i] if cuda else not any(got.values()),
                  f"pp: {fam} rank {i} launches {got}, the schedule's {want[i]}")
        stats = [r_[run]["stats"] for r_ in ranks]
        step_ms = [[x["step_time_ms"] for x in r_[run]["log"]] for r_ in ranks]
        steady = [sum(ms[1:]) / max(len(ms) - 1, 1) for ms in step_ms]

        def share(key: str, per_tick: bool = False) -> list:
            """A clock's share of each rank's steps after the first."""
            return [round(sum(s[key] * (s["ticks"] if per_tick else 1) for s in st[1:]) * 1000
                          / max(sum(ms[1:]), 1e-9), 3) for st, ms in zip(stats, step_ms)]
        r = {"preset": cfgs[fam]["preset"], "layers": model_cfg.n_layers, "batch": B, "seq_len": T,
             "losses": [x["loss"] for x in ranks[0][run]["log"]],
             "grad_norms": [x["grad_norm"] for x in ranks[0][run]["log"]],
             "one_losses": [x["loss"] for x in one[fam]["log"]],
             "one_grad_norms": [x["grad_norm"] for x in one[fam]["log"]], "worst_rel": worst,
             "worst_grad": worst_grad, "worst_leaf": worst_leaf, "router_err": router,
             "launches": [{k: v for k, v in x.items() if v} for x in launches], "launches_want": want,
             "reckoned": [f"{x['params'] / 1e9:.3f} G params, {x['total_bytes'] / 2**30:.2f} GiB"
                          for x in reckoned[fam]],
             "peak_bytes": [r_[run]["peak_bytes"] for r_ in ranks], "one_peak_bytes": one[fam]["peak"],
             "step_ms": step_ms, "one_step_ms": [x["step_time_ms"] for x in one[fam]["log"]],
             "ticks": stats[0][0]["ticks"], "ticks_s": stats,
             "sync_share": share("sync_s"), "exchange_share": share("exchange_s"),
             "transfer_share": share("fastest_s", per_tick=True), "steady_ms": steady}
        # the save, restored into one process: the leaves the ranks handed it, bit for bit
        opt = OptimizerConfig(learning_rate=3e-4, warmup_steps=1, total_steps=steps[fam]).build()
        t0 = time.perf_counter()
        state, _, step = restore_or_init(str(work / f"ckpt-{fam}"), lambda: TrainState.create(
            model.init(torch.Generator(device=device).manual_seed(1), model_cfg, device), opt), TrainState.load)
        r["restore_s"] = time.perf_counter() - t0
        check(step == steps[fam], f"pp: {fam} one process restored step {step}, want {steps[fam]}")
        whole = dict(_leaves(state.state_dict()))
        for i, x in enumerate(ranks):
            saved = x[run]["saves"][str(step)]
            check(set(saved) <= set(whole), f"pp: {fam} rank {i} saved leaves the restore lacks")
            for name, got in saved.items():
                leaf = name.split("/", 1)[1] if name.startswith("params/") else name.split("/", 2)[-1]
                block = pp_stage_block(leaf, whole[name], i)
                check(got["fp"] == fingerprint(torch, block) and got["shape"] == list(block.shape),
                      f"pp: {fam} rank {i}'s {name} at step {step} is not the one-process restore's")
        check(all(name in set().union(*(x[run]["saves"][str(step)] for x in ranks))
                  for name, t in whole.items() if hasattr(t, "shape")),
              f"pp: {fam} a leaf of the restore was saved by no rank")
        r["state_rel"], r["state_leaf"] = {}, {}
        for part in ("params", "mu", "nu"):
            mine = dict(_leaves(state.params if part == "params" else state.opt_state[part]))
            worst_s = (0.0, "")
            for name, ref in one[fam]["state"][part].items():
                for i in range(PP_RANKS if name.startswith("layers/") else 1):
                    a = pp_stage_block(name, mine[name].detach(), i)
                    b = pp_stage_block(name, ref, i).to(a.device).float()
                    err = float((a.float() - b).norm() / b.norm().clamp_min(1e-30))
                    worst_s = max(worst_s, (err, name))
            r["state_rel"][part], r["state_leaf"][part] = worst_s
            check(worst_s[0] <= FSDP_STATE_REL, f"pp: {fam} step {step} {part}/{worst_s[1]}: {worst_s[0]:.2e} > "
                                                f"{FSDP_STATE_REL:.0e} from one process's")
        r["restored_step"] = step
        del state, whole
        gc.collect()
        rec[fam] = r
        # the planted faults of this family: each must fail a check
        for fault in [f for f in PP_FAULTS if fam_of[f] == fam]:
            log0 = [x[fault]["log"][0] for x in ranks]
            got = {"loss": [x["loss"] for x in log0], "grad_norm": [x["grad_norm"] for x in log0],
                   "one_loss": one[fam]["log"][0]["loss"], "one_grad_norm": one[fam]["log"][0]["grad_norm"]}
            got["worst_grad"], got["worst_leaf"] = grad_worst(fault)
            if fam == "mixtral":
                got["router"] = max(x[fault]["grad_err"]["layers/router"] for x in ranks)
            try:
                fsdp_check(ranks, one[fam]["log"], fault, tag="pp")
                check(got["worst_grad"] <= CP_STEP_GRAD_REL, "step-1 gradients")
            except SmokeFailure:
                rec["faults"][fault] = got
            check(fault in rec["faults"], f"pp: the planted fault {fault!r} passed: {got}")
    for fam in models:
        del one[fam]["state"]
    shutil.rmtree(work, ignore_errors=True)
    rec["seconds"] = {k: round(v, 1) for k, v in seconds.items()}
    rec["launches_rank"] = [{k: x["llama-ok"]["launches"][k] + x["mixtral-ok"]["launches"][k]
                             for k in x["llama-ok"]["launches"]} for x in ranks]
    rec["launches_sum"] = {k: sum(x[k] for x in rec["launches_rank"]) for k in rec["launches_rank"][0]}
    print(pp_line(rec, card), flush=True)
    return rec


class Phases:
    """``with phases(name):`` runs one phase between a start line and its
    seconds, so a failure is named by the last start line (and by
    ``current``); the caching allocator is emptied after each phase."""

    def __init__(self, torch):
        self.torch, self.current, self.seconds = torch, None, {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        self.current = name
        print(f"[phase] {name} start", flush=True)
        t0 = time.perf_counter()
        yield
        self.seconds[name] = time.perf_counter() - t0
        print(f"[phase] {name} {self.seconds[name]:.1f}s", flush=True)
        gc.collect()
        self.torch.cuda.empty_cache()

    def total_s(self) -> float:
        return sum(self.seconds.values())


KERNELS = {
    "flash_fwd": ("tony_tpu_torch/csrc/flash_attention.cu",
                  "tony_tpu/ops/attention.py:95 (_flash_kernel via _flash_fwd_lanes :215)", "train"),
    "flash_bwd_dq": ("tony_tpu_torch/csrc/flash_attention.cu",
                     "tony_tpu/ops/attention.py:287 (_flash_bwd_dq_kernel via _flash_bwd_impl :526)",
                     "train"),
    "flash_bwd_dkv": ("tony_tpu_torch/csrc/flash_attention.cu",
                      "tony_tpu/ops/attention.py:373 and :434 (_flash_bwd_dkv_kernel_resident :572, "
                      "_flash_bwd_dkv_kernel :662)", "train"),
    "ragged_decode_attention": ("tony_tpu_torch/csrc/decode_attention.cu",
                                "tony_tpu/ops/decode_attention.py:49 (_kernel via ragged_decode_attention :185)",
                                "dense_ragged"),
    "paged_decode_attention": ("tony_tpu_torch/csrc/decode_attention.cu",
                               "tony_tpu/ops/decode_attention.py:49 (_kernel via paged_decode_attention :263)",
                               "paged"),
    "int8_matmul": ("tony_tpu_torch/csrc/int8_matmul.cu",
                    "tony_tpu/ops/quant.py:54 (_quant_matmul_kernel via int8_matmul :78)",
                    "int8"),
    "moe_fwd": ("tony_tpu_torch/csrc/moe_gemm.cu",
                "tony_tpu/ops/moe_gemm.py:104 (_fwd_kernel via _fwd_call :198; moe_swiglu_grouped :262)",
                "mixtral_train"),
    "moe_bwd": ("tony_tpu_torch/csrc/moe_gemm.cu",
                "tony_tpu/ops/moe_gemm.py:128 (_bwd_kernel via _bwd_call :238)", "mixtral_train"),
    "ring_fwd": ("tony_tpu_torch/csrc/ring_attention.cu",
                 "tony_tpu/ops/ring.py:83 (_ring_fwd_kernel via _ring_fwd :347; ring_attention_pallas :766, "
                 "ring_attention_pallas_seg :810)", "cp_train"),
    "ring_bwd": ("tony_tpu_torch/csrc/ring_attention.cu",
                 "tony_tpu/ops/ring.py:380 (_ring_bwd_kernel via _ring_bwd :720; the dq and dk/dv step "
                 "kernels, launches of both)", "cp_train"),
}
def kernel_rows(kern: dict, path_launches: dict, fleet_b5: dict, bert_launches: dict, bert_kern: dict,
                more: dict | None = None) -> list:
    """The ``kernels`` line: one row a kernel of ``KERNELS``, its launches
    those of its main-path run (a kernel never launched there fails the run),
    its times those of its first case; B5 adds its launches on each fleet's
    decode tier, and B1-B3 their ``[bench-bert]`` launches (``launches_bert``)
    and the BERT cases after their own. ``more`` maps a kernel to the
    launches of later phases, ``{phase: n}``, each added to its row as
    ``launches_<phase>`` and each required to be more than 0."""
    rows = []
    for name, (source, replaces, run) in KERNELS.items():
        k = kern[name]
        launches = path_launches[run][name]
        check(launches > 0, f"{name} was not launched by the {run} run")
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_run": run, "case": k["case"],
            "max_abs_err": k["max_abs_err"], "tol": k["tol"],
            **{x: k[x] for x in ("row_err", "fault_row_err", "w_err", "fault_w_err", "library_call",
                                 "step_ms", "tflops", "checks") if x in k},
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"], "cases": k["cases"],
        })
        if name == "paged_decode_attention":  # B5 on the decode tier of each fleet, during its load
            rows[-1]["launches_fleet"] = fleet_b5
        if name in bert_kern:
            check(bert_launches.get(name, 0) > 0, f"{name} was not launched by the bench-bert run")
            rows[-1]["launches_bert"] = bert_launches[name]
            rows[-1]["cases"] = k["cases"] + bert_kern[name]["cases"]
        for phase_name, n in (more or {}).get(name, {}).items():
            check(n > 0, f"{name} was not launched by the {phase_name} phase")
            rows[-1][f"launches_{phase_name}"] = n
    return rows


SERVE_RUNS = [("paged", []), ("int8", ["--int8"]), ("dense_ragged", ["--kv", "dense", "--attn", "ragged"])]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="", help="directory for server logs and the full result JSON "
                                             "(default: build/chip_smoke)")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check runs on the card only", file=sys.stderr)
        return 2
    if not (ROOT / "tony_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no tony_tpu_torch package; run from the repository root",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    from tony_tpu_torch.models import bert, llama, mixtral, resnet
    from tony_tpu_torch.ops import _build
    from tony_tpu_torch.ops import moe_gemm as MG
    from tony_tpu_torch.parallel import expert
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import decode_attention as DA
    from tony_tpu_torch.ops import quant as Q
    from tony_tpu_torch.ops import ring as TR

    out_dir = Path(args.out) if args.out else ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(card, flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}",
          flush=True)
    phase = Phases(torch)
    try:
        with phase("build"):
            t0 = time.perf_counter()
            libs = _build.build_all()
            print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f}s", flush=True)
            for stem, path in libs.items():
                for line in path.with_suffix(".log").read_text().splitlines():
                    if "registers" in line or "spill" in line:
                        print(f"[ptxas] {stem}: {line.strip()}", flush=True)
        flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")  # > 50 MB L2
        with phase("kernels"):
            kern = kernel_phase(torch, DA, Q, flush)
        with phase("flash-kernels"):
            kern.update(flash_kernel_phase(torch, A, flush, LLAMA_FLASH_CASES))
        del flush
        torch.cuda.empty_cache()
        # serving before training and the MoE kernel phase: the serve runs'
        # host-bound decode steps are measured as they were before those
        # minutes of load existed
        serve = {}
        for name, extra in SERVE_RUNS:
            with phase(f"serve-{name}"):
                serve[name] = run_server(name, extra, out_dir)
        with phase("int8-serve"):
            serve["int8"]["profile"] = int8_serve_profile(torch, Q)
        # the fleet after the serve runs and before the Mixtral phases, whose
        # in-process serve needs the card's memory with every replica gone
        with phase("kv-handoff"):
            handoff = kv_handoff_phase(torch, llama, DA)
        with phase("fleet"):
            fleet = fleet_phase(out_dir, card)
        with phase("whole-step"):
            step = whole_step_check(torch, llama, A)
        with phase("train"):
            train = train_phase(torch, llama, A, out_dir)
        with phase("train-breakdown"):
            train["breakdown"] = step_breakdown(
                torch, llama, llama.config_from_dict({"preset": "llama3-8b", "n_layers": TRAIN_LAYERS}), "train")
        with phase("remat"):
            remat = remat_phase(torch, llama, llama.config_from_dict({"preset": "llama3-8b", "n_layers": TRAIN_LAYERS}),
                                ("full", "dots", "flash"), (A,), "remat", STEP_LOSS_REL, STEP_GRAD_REL)
        with phase("gang"):
            gang = gang_phase(torch, llama, A, out_dir)
        with phase("async-save"):
            async_save = async_save_phase(torch, llama, out_dir)
        with phase("bench-1chip"):
            bench = {"1chip": bench_recipe_phase(torch, "1chip", llama, (A,))}
        # context-parallel training through the ring kernels, after the
        # single-device Llama phases, with their state freed
        with phase("ring-kernels"):
            flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
            kern.update(ring_kernel_phase(torch, A, TR, flush))
            del flush
        with phase("cp-step"):
            cp_step = cp_whole_step_check(torch, llama, A, TR)
        with phase("cp-train"):
            cp_train = cp_train_phase(torch, llama, A, TR)
            cp_train["mixtral"] = cp_train_mixtral(torch, mixtral, A, MG, TR)
        # Mixtral after the Llama phases, with their state freed
        with phase("moe-kernels"):
            flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
            kern.update(moe_kernel_phase(torch, MG, expert, flush))
            del flush
        with phase("moe-step"):
            moe_step = moe_whole_step_check(torch, mixtral, MG)
        with phase("moe-train"):
            moe_train = moe_train_phase(torch, mixtral, A, MG)
        with phase("moe-train-breakdown"):
            moe_train["breakdown"] = step_breakdown(
                torch, mixtral, mixtral.config_from_dict({"preset": "mixtral-8x7b", "n_layers": MOE_TRAIN_LAYERS}),
                "moe-train")
        with phase("moe-remat"):
            moe_remat = remat_phase(torch, mixtral,
                                    mixtral.config_from_dict({"preset": "mixtral-8x7b", "n_layers": MOE_TRAIN_LAYERS}),
                                    ("full", "flash"), (A, MG), "moe-remat", MOE_STEP_LOSS_REL, MOE_STEP_GRAD_REL)
        with phase("bench-moe"):
            bench["moe"] = bench_recipe_phase(torch, "moe", mixtral, (A, MG))
        with phase("moe-serve"):
            moe_serve = moe_serve_phase(torch, mixtral, DA, MG)
        # BERT last, after every earlier phase ran as it did before and freed
        # its state: B1-B3 at BERT-base's shapes (non-causal, Dh 64, packed)
        with phase("bert-kernels"):
            flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
            bert_kern = flash_kernel_phase(torch, A, flush, BERT_FLASH_CASES)
            del flush
        with phase("bert-step"):
            bert_step = bert_whole_step_check(torch, bert, A)
        with phase("bench-bert"):
            bench["bert"] = bench_recipe_phase(torch, "bert", bert, (A,))
            _, fields, B, T = BENCH_RECIPES["bert"]
            bench["bert"]["breakdown"] = step_breakdown(torch, bert, bert.config_from_dict(fields), "bench-bert", B, T)
        with phase("bert-pack"):
            bert_pack = bert_pack_phase(torch, bert, A, card)
        # the MNIST MLP and ResNet-50 after BERT, with its state freed: cuDNN's
        # convolutions and BatchNorm, no kernel of the port on their path
        with phase("mnist"):
            mnist = mnist_phase(out_dir)
        with phase("resnet-step"):
            resnet_step = resnet_step_check(torch, resnet)
        with phase("bench-resnet"):
            bench["resnet"] = bench_resnet_phase(torch, card)
        with phase("resnet-train"):
            resnet_train = resnet_train_phase(torch)
        # Hugging Face checkpoints (written from seeded trees, loaded, served)
        # and the Mixtral gang under tony submit, after every earlier phase
        with phase("hf-load"):
            hf_load, hf = hf_load_phase(torch, llama, mixtral, out_dir)
        with phase("hf-serve"):
            hf_serve = hf_serve_phase(torch, Q, DA, MG, hf, out_dir)
            del hf
        with phase("mixtral-gang"):
            mixtral_gang = mixtral_gang_phase(out_dir)
        # the fsdp axis, then the model axis, last: gangs of two processes on
        # the card, after every earlier phase ran as before
        with phase("fsdp"):
            fsdp = fsdp_phase(torch, llama, A, out_dir, card)
        with phase("tp"):
            tp = tp_phase(torch, llama, A, out_dir, card)
        with phase("tp-serve"):
            tp_serve = tp_serve_phase(torch, llama, card)
        # Mixtral on the model axis (its experts on F/tp columns, B7/B8 at 7168),
        # then in the same two processes [mixtral-ep], the expert axis (4 whole
        # experts a rank), against the same one-process run
        with phase("mixtral-tp"):
            mixtral_tp = tp_phase(torch, mixtral, A, out_dir, card)
        with phase("mixtral-tp-serve"):
            mixtral_tp_serve = mixtral_tp_serve_phase(torch, mixtral, MG, card)
        # the context axis across the gang (A12b), last: one shard a process,
        # B9/B10 moving KV between the two processes on the card
        with phase("cp-gang"):
            cp_gang = cp_gang_phase(torch, llama, mixtral, A, out_dir, card)
        # a model axis beside the context axis (A12c): four processes, each a
        # window and a model block, B9/B10 on its 16 query and 4 kv heads
        with phase("cp-tp"):
            cp_tp = cp_tp_phase(torch, llama, A, out_dir, card)
        # pipeline stages (A13a), last: one stage a process, the 1F1B
        # schedule's activations and gradients between the two on the card
        with phase("pp"):
            pp = pp_phase(torch, llama, mixtral, out_dir, card)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED in phase {phase.current}: {e}", file=sys.stderr, flush=True)
        return 1
    print(f"[phase] all phases {phase.total_s():.1f}s", flush=True)
    path_launches = {run: rec["kernel_launches"] for run, rec in serve.items()}
    path_launches["train"] = train["launches"]
    path_launches["gang"] = gang["launches"]
    path_launches["mixtral_train"] = moe_train["launches"]
    path_launches["cp_train"] = cp_train["launches"]
    try:
        gang_launches = mixtral_gang["launches"]
        more = {k: {"mixtral_gang": gang_launches[k]} for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "moe_bwd")}
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            more[k]["fsdp"] = fsdp["launches_sum"][k]
            more[k]["tp"] = tp["launches_rank"][k]
        more["moe_fwd"] = {"mixtral_gang": gang_launches["moe_fwd"], "hf_serve": hf_serve["mixtral_launches"]["moe_fwd"]}
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "moe_fwd", "moe_bwd"):
            more[k]["mixtral_tp"] = mixtral_tp["launches_rank"][k]
            more[k]["mixtral_ep"] = mixtral_tp["ep"]["launches_rank"][k]
        more["moe_fwd"]["mixtral_tp_serve"] = mixtral_tp_serve["launches"]
        for k in ("ring_fwd", "ring_bwd", "moe_fwd", "moe_bwd"):
            more.setdefault(k, {})["cp_train_mixtral"] = cp_train["mixtral"]["launches_run"][k]
        gang_sum = cp_gang["launches_sum"]
        for k, n in (("ring_fwd", gang_sum["ring_fwd"]), ("ring_bwd", gang_sum["ring_bwd_dq"] + gang_sum["ring_bwd_dkv"]),
                     ("moe_fwd", gang_sum["moe_fwd"]), ("moe_bwd", gang_sum["moe_bwd"])):
            more[k]["cp_gang"] = n
        tp_sum = cp_tp["launches_sum"]
        more["ring_fwd"]["cp_tp"] = tp_sum["ring_fwd"]
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "moe_fwd", "moe_bwd"):
            more[k]["pp"] = pp["launches_sum"][k]
        more["ring_bwd"]["cp_tp"] = tp_sum["ring_bwd_dq"] + tp_sum["ring_bwd_dkv"]
        for k in ("paged_decode_attention", "int8_matmul"):
            more[k] = {"hf_serve": hf_serve["launches"][k]}
        kernels = kernel_rows(kern, path_launches, {f: rec["b5_launches"] for f, rec in fleet.items()},
                              bench["bert"]["launches"], bert_kern, more)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    builds = {"flash_attention": kern["flash_fwd"]["build"], "ring_attention": kern["ring_fwd"]["build"],
              "moe_gemm": kern["moe_fwd"]["build"], "decode_attention": kern["paged_decode_attention"]["build"],
              "int8_matmul": kern["int8_matmul"]["build"]}
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, "builds": builds, "whole_step": step, "train": train,
         "remat": remat, "serve": serve, "kv_handoff": handoff, "fleet": fleet, "gang": gang,
         "async_save": async_save, "bench": bench,
         "mixtral": {"whole_step": moe_step, "train": moe_train, "remat": moe_remat, "serve": moe_serve},
         "cp": {"whole_step": cp_step, "train": cp_train},
         "bert": {"whole_step": bert_step, "pack": bert_pack}, "mnist": mnist,
         "resnet": {"whole_step": resnet_step, "train": resnet_train},
         "hf": {"load": hf_load, "serve": hf_serve}, "mixtral_gang": mixtral_gang, "fsdp": fsdp, "tp": tp,
         "tp_serve": tp_serve, "mixtral_tp": mixtral_tp, "mixtral_tp_serve": mixtral_tp_serve,
         "cp_gang": cp_gang, "cp_tp": cp_tp, "pp": pp}, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
