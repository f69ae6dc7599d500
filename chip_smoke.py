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
4. whole step: ``loss_fn`` and every gradient through the flash kernels
   against ``attn_impl="reference"`` on the same params and batch (8B width,
   2 layers, B=1, T=2048); two planted faults (a query head dropped by B1,
   or by B3) must fail the limits the kernels pass;
5. train: ``run_lm_training`` in this process at the full 8B width cut to
   8 layers (bf16, remat "full", ce_chunk 512, B=4, T=2048): 3 steps with a
   checkpoint, then a second call to 6 steps that must resume at step 3;
   prints loss and grad_norm per step, tok/s, ms/step, MFU, peak memory and
   the B1-B3 launches of the two calls; then the same step on a fresh state
   split with CUDA events into loss + gradients and the optimizer update,
   and its device time by kernel family from ``torch.profiler`` with the
   card's busy share of the profiled window;
5r. remat policies: the train shape (8 layers, B=4, T=2048) under "full",
   "dots" and "flash" from one state and batch: the loss and every gradient
   of each against "full"'s within the whole-step limits (and whether the
   bits are identical), B1 launched 2L / 2L / L times a forward and
   backward and B2, B3 L times; then the mean ms/step of 3 train steps and
   the peak memory under each;
5a. gang: the training gang at the full ``llama-1b`` preset (16 layers,
   bf16, remat "full", B=8, T=2048) on four ``*.tonytok`` shards written
   from a seed: ``tony submit`` (run as ``python -m tony_tpu.cli.main``, a
   subprocess) of ``python -m tony_tpu_torch.train.pretrain`` for 12 steps
   with an asynchronous checkpoint every 4 and a node loss at step 9: one
   restart, the resume at the newest step attempt 0's log shows published
   (4, since the save at step 8 joins step 4's write) with a validated
   cursor, every global slot consumed once, ``tony top`` on the live worker
   and ``tony goodput`` after; the same 12 steps in this process through
   B1-B3 (launches counted) with each loss the worker's within
   ``GANG_LOSS_REL``; an urgent save on a drain request and a
   ``torch.profiler`` window in this process; the bucketed mean over a
   one-rank nccl group; prints ms/step, tok/s, MFU and peak memory of both
   runs, the checkpoint's bytes, its save dispatch, write and restore
   seconds, goodput's ``checkpoint`` seconds, and the time to recover (node
   loss to the restart's first step);
5s. asynchronous save, in this process, at the gang's shape: 20 train
   steps saved after steps 4 and 20, once with ``use_async=False`` and once
   with ``use_async=True``: each save's dispatch and write seconds, the
   steps during the first write against the steady step, the wall of each
   run, and the same bytes restored from both (the async step 4 also the
   state as it was at its save);
5b. bench.py's ``1chip`` recipe (``llama-1b``, remat "flash", ce_chunk
   1024, B=12, T=2048) through ``run_lm_training`` for 6 steps: ms/step,
   tok/s, MFU, peak memory and B1-B3 launches (B1 L times a step);
5c. context parallelism (B9, B10): the ring kernels' build report, then
   the whole ring pass over a ``DeviceRing`` of 4 on the card at 8B
   widths, B=1, T=16384 (causal, 3 segments, window 1024) against the
   plain steps, with two planted faults that must fail; the causal pass
   run twice must give the same bits; a 2-layer whole-step check against
   the flash path; ``run_lm_training`` with a context axis of 4 at 4
   layers for 3 steps (B9/B10 launches must equal the schedule's count);
6. MoE kernels (B7, B8; after the Llama phases, so their minutes of load
   do not run before the serve runs): the build report of the six passes
   of ``moe_gemm.cu`` (registers, spills, shared memory; a pass that
   spills fails the run), then the grouped SwiGLU forward and
   backward against their plain versions at Mixtral-8x7B widths (D 4096,
   F 14336, 8 experts, top-2) on three routings (the train shape B=4,
   T=2048; every token to experts 0 and 1; one 1000-token prompt), ys and
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
   max_len 2048) at Mixtral-8x7B width cut to 27 of 32 layers, with the
   Llama serve runs' traffic: the mixed batch (prefill through B7, decode
   through the all-expert products; prefix hits, the identical greedy
   prompts agree, the first token of one request timed) and the decode
   batch; tok/s of both, the decode step time and peak memory; then one
   decode chunk of a full batch under ``torch.profiler``: device ms by
   kernel family (``decode`` is B4/B5) and the card's busy share;
10. prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.

Imports only ``tony_tpu_torch``, torch, numpy and the standard library; it
runs the orchestrator, ``tony_tpu.cli.main``, as a subprocess only.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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

# Llama-3-8B training shapes of the flash kernels (B1-B3)
FLASH_CASES = {
    "train": dict(B=4, T=2048, window=0, n_seg=1),      # the train run's shape
    "long": dict(B=1, T=8192, window=0, n_seg=1),       # where JAX streams dk/dv
    "segments": dict(B=4, T=2048, window=0, n_seg=3),   # 3 packed segments a row
    "window": dict(B=4, T=2048, window=1024, n_seg=1),  # sliding window 1024
}
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
TRAIN_LAYERS = 8

# Mixtral-8x7B widths of the MoE kernels (B7, B8): D, F, experts, top-k
MOE_D, MOE_F, MOE_E, MOE_K = 4096, 14336, 8, 2
MOE_CASES = {
    "train": dict(tokens=4 * 2048, skew="random"),   # the train run's B=4, T=2048
    "skewed": dict(tokens=4 * 2048, skew="two"),     # every token to experts 0 and 1
    "prefill": dict(tokens=1000, skew="random"),     # one 1000-token prompt
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
# the deepest cut that fits one 80 GB card: bf16 weights of 2.90 GB a layer
# plus 0.52 GB of embed and head are 78.9 GB (73.5 GiB) at 27 layers, and
# with the KV pool (68 MB a layer) and the prefill temporaries the engine
# peaks at 77.6 of the H100's 79.2 GiB; a 28th layer adds 2.7 GiB
MOE_SERVE_LAYERS = 27

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

# the training gang at the full llama-1b preset: B=8, T=2048 over 4 seeded
# shards, 12 steps with a checkpoint every 4 and a node loss at step 9 under
# ``tony submit``. Saves are asynchronous and a 5.24 GB write outlasts four
# steps, so the save at step 8 first joins step 4's write: step 4 is
# published before step 9 is reported, and the restart resumes at the newest
# step the worker's log shows published (4, or 8 if its write also ended).
# Each step's loss of the gang's worker against the same steps in this
# process: the same program on the same data, so the same bits unless a
# kernel or library reduction on the path runs in another order between the
# two (bf16, 12 steps: a few ulps of the loss)
GANG_STEPS, GANG_CKPT_EVERY, GANG_LOSS_AT = 12, 4, 9
GANG_B, GANG_T, GANG_SHARDS = 8, 2048, 4
GANG_LOSS_REL = 2e-3


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
    g = torch.Generator(device="cuda").manual_seed(2)
    B, T = c["B"], c["T"]
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    q, k, v, do = rnd(B, H, T, DH), rnd(B, HKV, T, DH), rnd(B, HKV, T, DH), rnd(B, H, T, DH)
    seg = None
    if c["n_seg"] > 1:
        rows = []
        for _ in range(B):
            cuts = torch.randperm(T - 1, generator=g, device="cuda")[: c["n_seg"] - 1].sort().values + 1
            rows.append(torch.searchsorted(cuts, torch.arange(T, device="cuda"), right=True))
        seg = torch.stack(rows).to(torch.int32).contiguous()
    visible = torch.stack([A._visible(T, T, True, c["window"], None if seg is None else seg[b], "cuda")
                           for b in range(B)])
    return q, k, v, do, seg, visible


def flash_cost(c, pairs: int, seg) -> dict:
    """Operations and bytes of each kernel on this run's data: ``pairs``
    visible (query, key) positions per head; each input read once, each
    output written once (bf16 tensors, f32 lse / delta, int32 segment ids)."""
    B, T = c["B"], c["T"]
    qb, kvb, row = B * H * T * DH * 2, B * HKV * T * DH * 2, B * H * T * 4
    segb = B * T * 4 if seg is not None else 0
    return {
        "flash_fwd": (4 * H * DH * pairs, 2 * qb + 2 * kvb + row + segb),
        "flash_bwd_dq": (6 * H * DH * pairs, 3 * qb + 2 * kvb + 2 * row + segb),
        "flash_bwd_dkv": (8 * H * DH * pairs, 2 * qb + 4 * kvb + 2 * row + segb),
    }


def flash_kernel_phase(torch, A, flush) -> dict:
    import torch.nn.functional as F

    build = attention_build_report("flash_attention")
    recs = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkv": []}
    for name, c in FLASH_CASES.items():
        q, k, v, do, seg, visible = flash_inputs(torch, A, c)
        kw = dict(causal=True, segment_ids=seg, window=c["window"])
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
        # the library yardstick: SDPA on head-expanded K/V (a boolean mask for
        # segments and the window), its forward, and its backward alone from
        # a saved forward (which covers B2 and B3 together)
        rep = H // HKV
        kk = k.repeat_interleave(rep, 1).requires_grad_(True)
        vv = v.repeat_interleave(rep, 1).requires_grad_(True)
        qq = q.detach().clone().requires_grad_(True)
        mask = visible[:, None] if seg is not None or c["window"] else None
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qq, kk, vv, attn_mask=mask, is_causal=mask is None)
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
                     if kname == "flash_fwd" else ""), flush=True)
        check(lse_err <= LSE_ATOL, f"flash_fwd {name}: lse error {lse_err} > {LSE_ATOL}")
        for kname, (err, fault, _) in errs.items():
            check(err <= FLASH_ROW_TOL, f"{kname} {name}: row error {err} > {FLASH_ROW_TOL}")
            check(fault > FLASH_ROW_TOL, f"{kname} {name}: the check passes a planted fault ({fault})")
        for kname, (err, fault, abs_err) in errs.items():
            flops, nbytes = cost[kname]
            rec = {"case": name, "max_abs_err": abs_err, "row_err": err, "tol": FLASH_ROW_TOL,
                   "fault_row_err": fault, "pairs": pairs, "flops": flops, "bytes": nbytes,
                   "ms": time_ms(torch, kernels[kname], flush),
                   "plain_ms": time_ms(torch, plains[kname], flush, iters=3, warmup=1),
                   "library_ms": lib_fwd if kname == "flash_fwd" else lib_bwd,
                   "library_call": "sdpa forward" if kname == "flash_fwd"
                   else "sdpa backward alone (covers B2+B3 together)",
                   "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
                   "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations"}
            rec["tflops"] = flops / rec["ms"] / 1e9
            print(f"[kernel] {kname} {name:9s} ms {rec['ms']:.4f} plain {rec['plain_ms']:.4f} "
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


def dropped_head_fwd(A):
    """B1 with a planted fault: query head 0 of every kv group gives zeros."""
    real = A.flash_fwd

    def fwd(q, k, v, **kw):
        o, lse = real(q, k, v, **kw)
        o = o.clone()
        o[:, ::q.shape[1] // k.shape[1]] = 0
        return o, lse

    return fwd


def dropped_head_dkv(A):
    """B3 with a planted fault: dk and dv leave out query head 0 of every
    kv group (its do and delta read as zeros)."""
    real = A.flash_bwd_dkv

    def dkv(q, k, v, do, lse, delta, **kw):
        do, delta = do.clone(), delta.clone()
        do[:, ::q.shape[1] // k.shape[1]] = 0
        delta[:, ::q.shape[1] // k.shape[1]] = 0
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
    B9/B10, ``decode`` B4/B5, ``int8`` B6), cuBLAS's products as ``gemm``, the
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
    return "gemm" if any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma")) else "other"


def profile_families(torch, run, reps: int):
    """``reps`` calls of ``run`` under ``torch.profiler``: device ms a call by
    kernel family, device-busy ms a call (the union of the kernels' spans),
    the host wall a call, and the busy share (busy over the host wall, which
    the profiler's own host cost stretches). None if the profiler recorded
    no device activity."""
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
    for e in kernels:
        f = _kernel_family(e.name)
        fam[f] = fam.get(f, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in kernels)
    return {"device_ms_by_family": fam, "device_ms": busy_us / 1e3 / reps,
            "profiled_wall_ms": wall_us / 1e3 / reps, "busy_share": busy_us / wall_us}


def step_breakdown(torch, model, preset: str, layers: int, tag: str) -> dict:
    """Where the train step's time goes, on the train run's shapes (B=4,
    T=2048, ``preset`` cut to ``layers``): the step as ``make_train_step``
    runs it (``loss_fn``, gradients, global norm, AdamW), timed with CUDA
    events in two parts, then two more steps under ``torch.profiler`` for
    device time by kernel family and the busy share (device time over the
    host wall of the profiled steps, which the profiler's own host cost
    stretches)."""
    from tony_tpu_torch.train.trainer import OptimizerConfig, TrainState, global_norm

    cfg = model.config_from_dict({"preset": preset, "n_layers": layers})
    opt = OptimizerConfig(learning_rate=3e-4, warmup_steps=2, total_steps=6).build()
    state = TrainState.create(model.init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda"), opt)
    names, tensors = zip(*_leaves(state.params))
    gen = torch.Generator(device="cuda").manual_seed(3)

    def step():
        batch = model.synthetic_batch(gen, 4, 2048, cfg)
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
}
BENCH_STEPS = 6
# the asynchronous save at the gang's shape (llama-1b, B=8, T=2048): saves
# after step 4, whose write (~6 s: one torch.save at ~0.8 GB/s) the 16 steps after it
# (~6.8 s) outlast, and after the last step
ASYNC_STEPS, ASYNC_SAVE_AT = 20, (4, 20)


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


def bench_recipe_phase(torch, name: str, model, counters) -> dict:
    """bench.py's ``name`` preset through ``run_lm_training`` for
    ``BENCH_STEPS`` steps: ms/step and tok/s over the steady steps (all but
    the first), MFU on 6N + causal attention at T (N active for a MoE), peak
    memory and the kernel launches (counts set to 0 just before the call)."""
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
    want = _expected_launches(counters, L, REMAT_FWD_PER_LAYER[cfg.remat_policy], BENCH_STEPS)
    check(launches == want, f"bench {name}: launches {launches}, want {want}")
    steady = sorted(x["step_time_ms"] for x in log[1:])
    ms = steady[len(steady) // 2]
    n_params = getattr(cfg, "active_params", cfg.num_params)()
    fpt = transformer_flops_per_token(n_params, L, cfg.d_model, T)
    rec = {"config": fields, "batch": B, "seq_len": T, "params": cfg.num_params(), "mfu_params": n_params,
           "log": log, "launches": launches, "step_ms": ms, "tok_per_s": B * T / ms * 1e3,
           "mfu": B * T / ms * 1e3 * fpt / BF16_FLOPS,
           "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "wall_s": wall}
    for x in log:
        print(f"[bench-{name}] step {x['step']} loss {x['loss']} grad_norm {x['grad_norm']} "
              f"{x['step_time_ms']} ms", flush=True)
    print(f"[bench-{name}] bench.py's {name} recipe ({rec['params'] / 1e9:.3f} B params, MFU basis "
          f"{n_params / 1e9:.3f} B), B={B} T={T}, remat {cfg.remat_policy}, ce_chunk {cfg.ce_chunk}: "
          f"{ms:.1f} ms/step, {rec['tok_per_s']:.0f} tok/s, MFU {rec['mfu']:.3f} (6N + attention at T={T}), "
          f"peak memory {rec['max_memory_gib']:.1f} GiB, wall {wall:.1f}s; launches {launches}", flush=True)
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

    cfg = llama.config_from_dict("llama-1b")
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
        print(f"[async-save] {mode}: llama-1b B={GANG_B} T={GANG_T}, {ASYNC_STEPS} steps, saves after steps "
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
    """The training gang at the full ``llama-1b`` preset (16 layers, d_model
    2048, bf16, remat "full", B=8, T=2048) on ``*.tonytok`` shards written
    here from a seed:

    1. ``tony submit`` (framework pytorch, one worker) of ``python -m
       tony_tpu_torch.train.pretrain --data_dir ...`` for 12 steps with an
       asynchronous checkpoint every 4 and ``node-loss:worker:0@step+9``:
       the job must succeed after one gang restart that resumes at the
       newest step attempt 0's log shows published (at least 4) with a
       validated cursor, and the global slots of the steps each attempt
       trained must cover ``[0, 12*8)`` once; ``tony top`` reads the live
       worker (which waits for a stop file after training) and ``tony
       goodput`` the finished job; the time to recover runs from the node
       loss to the first step of the restart;
    2. ``run_lm_training`` in this process on the same shards, 12 steps: B1-B3
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

    cfg = llama.config_from_dict("llama-1b")
    work = out_dir / "gang"
    shutil.rmtree(work, ignore_errors=True)
    data, ck, stop, root = work / "data", work / "ckpt", work / "stop", work / "tony"
    data.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(GANG_SHARDS):  # 4 x 2^18 tokens: 511 windows of 2049, more than the 96 drawn
        write_token_shard(data / f"shard-{i:02d}.tonytok", rng.integers(0, cfg.vocab_size, 1 << 18))
    run = ["--preset", "llama-1b", "--data_dir", str(data), "--steps", str(GANG_STEPS),
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
    check(done["req_id"] == "chip-drain" and 2 < done["step"] < 5 and steps_on_disk == [done["step"], 5],
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
        "preset": "llama-1b", "params": cfg.num_params(), "batch": GANG_B, "seq_len": GANG_T,
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
    print(f"[gang] llama-1b B={GANG_B} T={GANG_T}: gang {rec['gang']['step_ms']:.1f} ms/step "
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
    """q, k, v, do at Llama-3-8B widths over the whole T=16384, three packed
    segments with boundaries off the shard edges, the visible (query, key)
    pairs of the case."""
    g = torch.Generator(device="cuda").manual_seed(4)
    T = RING_T
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    q, k, v, do = rnd(1, H, T, DH), rnd(1, HKV, T, DH), rnd(1, HKV, T, DH), rnd(1, H, T, DH)
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


def skipped_ring_step(TR, my: int = 3, src: int = 2):
    """B9 with a planted fault: shard ``my`` never folds in the KV shard
    ``src`` (a middle step of the ring: its state passes through unchanged)."""
    real = TR.ring_fwd_step
    Tl = RING_T // RING_N

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


def ring_cost(pairs: int, seg) -> dict:
    """(operations, bytes, the launches' own operations) of one ring pass on
    this run's data, as ``flash_cost``. B9 as B1. B10 as the TPU kernel's
    one pass of five products a visible pair (q.k, do.v, p.do, ds.q, ds.k:
    10 H DH), reading q, k, v, do, lse, delta once and writing dq, dk, dv
    once; the port's dq and dk/dv step kernels each recompute q.k and do.v
    (14 H DH), work of the split and not of the function."""
    qb, kvb, row = H * RING_T * DH * 2, HKV * RING_T * DH * 2, H * RING_T * 4
    segb = RING_T * 4 if seg is not None else 0
    return {"ring_fwd": (4 * H * DH * pairs, 2 * qb + 2 * kvb + row + segb, 4 * H * DH * pairs),
            "ring_bwd": (10 * H * DH * pairs, 3 * qb + 4 * kvb + 2 * row + segb, 14 * H * DH * pairs)}


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
    ring = DeviceRing(RING_N, "cuda")
    Tl = RING_T // RING_N
    recs = {"ring_fwd": [], "ring_bwd": []}
    for name, c in RING_CASES.items():
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
        with mock.patch.object(TR, "ring_fwd_step", skipped_ring_step(TR)):
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
            print(f"[ring] {kname} {name:8s} row err {err:.3e} (tol {FLASH_ROW_TOL}; planted fault "
                  f"{fault:.3e}), max_abs_err {abs_err:.3e}"
                  + (f"; lse err {lse_err:.2e} (tol {LSE_ATOL})" if kname == "ring_fwd" else ""), flush=True)
        check(lse_err <= LSE_ATOL, f"ring_fwd {name}: lse error {lse_err} > {LSE_ATOL}")
        for kname, (err, fault, _) in errs.items():
            check(err <= FLASH_ROW_TOL, f"{kname} {name}: row error {err} > {FLASH_ROW_TOL}")
            check(fault > FLASH_ROW_TOL, f"{kname} {name}: the check passes a planted fault ({fault})")
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
        # one diagonal step (shard 1 on its own KV) and one past step (shard 3
        # on shard 2's KV: every pair visible under the causal mask)
        f32 = dict(dtype=torch.float32, device="cuda")
        delta = (do.float() * o_p.float()).sum(-1)
        step_ms = {}
        for sname, my, src in (("diagonal", 1, 1), ("past", 3, 2)):
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
        rep = H // HKV
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
        cost = ring_cost(pairs, seg)
        passes = {"ring_fwd": (fwd, lib_fwd, "sdpa forward over the whole sequence"),
                  "ring_bwd": (bwd, lib_bwd, "sdpa backward alone over the whole sequence")}
        for kname, (run, lib_ms, lib_call) in passes.items():
            err, fault, abs_err = errs[kname]
            flops, nbytes, kernel_flops = cost[kname]
            rec = {"case": name, "max_abs_err": abs_err, "row_err": err, "tol": FLASH_ROW_TOL,
                   "fault_row_err": fault, "pairs": pairs, "flops": flops, "bytes": nbytes,
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
    return {kname: dict(rs[0], cases=rs, build=build) for kname, rs in recs.items()}


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


# -- MoE grouped SwiGLU kernels (B7, B8) and the Mixtral path --------------------

def moe_inputs(torch, MG, expert, c):
    """Routed rows at Mixtral-8x7B widths: ``c["tokens"]`` tokens routed
    top-2 over 8 experts by a seeded random router ('random'), or every
    token to experts 0 and 1 ('two': experts 2-7 own one pad tile and no
    real row); expert weights at fan-in scale; the cotangent zero on pad rows,
    as the combine's backward makes it."""
    g = torch.Generator(device="cuda").manual_seed(4)
    N, bf = c["tokens"], torch.bfloat16
    x = torch.randn(1, N, MOE_D, generator=g, device="cuda").to(bf)
    router = torch.randn(MOE_D, MOE_E, generator=g, device="cuda") / MOE_D ** 0.5
    if c["skew"] == "two":
        router = torch.zeros_like(router)
        router[:, :2] = 1.0
        x = x.abs()
    sort_tok, _, _, gate_sorted, gs, _ = expert.route_ragged(
        x, router, expert.MoEConfig(MOE_E, MOE_K), tile=MG.TILE)
    xs = x.reshape(N, MOE_D)[sort_tok.long()].contiguous()
    tg = MG.tile_group_map(gs, xs.shape[0] // MG.TILE, MG.TILE)

    def w(*shape, fan):
        return (torch.randn(*shape, generator=g, device="cuda") * fan ** -0.5).to(bf)

    wg, wu, wd = w(MOE_E, MOE_D, MOE_F, fan=MOE_D), w(MOE_E, MOE_D, MOE_F, fan=MOE_D), \
        w(MOE_E, MOE_F, MOE_D, fan=MOE_F)
    dy = (torch.randn(xs.shape, generator=g, device="cuda") * (gate_sorted != 0)[:, None]).to(bf)
    return dict(xs=xs, wg=wg, wu=wu, wd=wd, tg=tg, dy=dy, gs=gs, rows=N * MOE_K)


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
    PN, E, D, F = m["xs"].shape[0], MOE_E, MOE_D, MOE_F
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
        bad = next_expert_tiles(torch, m["tg"], MOE_E)
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


# -- main ----------------------------------------------------------------------

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
    from tony_tpu_torch.models import llama, mixtral
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
    try:
        t0 = time.perf_counter()
        libs = _build.build_all()
        print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f}s", flush=True)
        for stem, path in libs.items():
            for line in path.with_suffix(".log").read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[ptxas] {stem}: {line.strip()}", flush=True)
        flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")  # > 50 MB L2
        kern = kernel_phase(torch, DA, Q, flush)
        kern.update(flash_kernel_phase(torch, A, flush))
        del flush
        torch.cuda.empty_cache()
        # serving before training and the MoE kernel phase: the serve runs'
        # host-bound decode steps are measured as they were before those
        # minutes of load existed
        serve = {name: run_server(name, extra, out_dir) for name, extra in SERVE_RUNS}
        serve["int8"]["profile"] = int8_serve_profile(torch, Q)
        step = whole_step_check(torch, llama, A)
        gc.collect()
        torch.cuda.empty_cache()
        train = train_phase(torch, llama, A, out_dir)
        gc.collect()
        torch.cuda.empty_cache()
        train["breakdown"] = step_breakdown(torch, llama, "llama3-8b", TRAIN_LAYERS, "train")
        gc.collect()
        torch.cuda.empty_cache()
        remat = remat_phase(torch, llama, llama.config_from_dict({"preset": "llama3-8b", "n_layers": TRAIN_LAYERS}),
                            ("full", "dots", "flash"), (A,), "remat", STEP_LOSS_REL, STEP_GRAD_REL)
        gc.collect()
        torch.cuda.empty_cache()
        gang = gang_phase(torch, llama, A, out_dir)
        gc.collect()
        torch.cuda.empty_cache()
        async_save = async_save_phase(torch, llama, out_dir)
        gc.collect()
        torch.cuda.empty_cache()
        bench = {"1chip": bench_recipe_phase(torch, "1chip", llama, (A,))}
        gc.collect()
        torch.cuda.empty_cache()
        # context-parallel training through the ring kernels, after the
        # single-device Llama phases, with their state freed
        flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
        kern.update(ring_kernel_phase(torch, A, TR, flush))
        del flush
        gc.collect()
        torch.cuda.empty_cache()
        cp_step = cp_whole_step_check(torch, llama, A, TR)
        gc.collect()
        torch.cuda.empty_cache()
        cp_train = cp_train_phase(torch, llama, A, TR)
        gc.collect()
        torch.cuda.empty_cache()
        # Mixtral after the Llama phases, with their state freed
        flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
        kern.update(moe_kernel_phase(torch, MG, expert, flush))
        del flush
        gc.collect()
        torch.cuda.empty_cache()
        moe_step = moe_whole_step_check(torch, mixtral, MG)
        gc.collect()
        torch.cuda.empty_cache()
        moe_train = moe_train_phase(torch, mixtral, A, MG)
        gc.collect()
        torch.cuda.empty_cache()
        moe_train["breakdown"] = step_breakdown(torch, mixtral, "mixtral-8x7b", MOE_TRAIN_LAYERS, "moe-train")
        gc.collect()
        torch.cuda.empty_cache()
        moe_remat = remat_phase(torch, mixtral,
                                mixtral.config_from_dict({"preset": "mixtral-8x7b", "n_layers": MOE_TRAIN_LAYERS}),
                                ("full", "flash"), (A, MG), "moe-remat", MOE_STEP_LOSS_REL, MOE_STEP_GRAD_REL)
        gc.collect()
        torch.cuda.empty_cache()
        bench["moe"] = bench_recipe_phase(torch, "moe", mixtral, (A, MG))
        gc.collect()
        torch.cuda.empty_cache()
        moe_serve = moe_serve_phase(torch, mixtral, DA, MG)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    path_launches = {run: rec["kernel_launches"] for run, rec in serve.items()}
    path_launches["train"] = train["launches"]
    path_launches["gang"] = gang["launches"]
    path_launches["mixtral_train"] = moe_train["launches"]
    path_launches["cp_train"] = cp_train["launches"]
    kernels = []
    for name, (source, replaces, run) in KERNELS.items():
        k = kern[name]
        launches = path_launches[run][name]
        if not launches:
            print(f"chip_smoke FAILED: {name} was not launched by the {run} run", file=sys.stderr)
            return 1
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_run": run, "case": k["case"],
            "max_abs_err": k["max_abs_err"], "tol": k["tol"],
            **{x: k[x] for x in ("row_err", "fault_row_err", "w_err", "fault_w_err", "library_call",
                                 "step_ms", "tflops") if x in k},
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"], "cases": k["cases"],
        })
    builds = {"flash_attention": kern["flash_fwd"]["build"], "ring_attention": kern["ring_fwd"]["build"],
              "moe_gemm": kern["moe_fwd"]["build"], "decode_attention": kern["paged_decode_attention"]["build"],
              "int8_matmul": kern["int8_matmul"]["build"]}
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, "builds": builds, "whole_step": step, "train": train,
         "remat": remat, "serve": serve, "gang": gang, "async_save": async_save, "bench": bench,
         "mixtral": {"whole_step": moe_step, "train": moe_train, "remat": moe_remat, "serve": moe_serve},
         "cp": {"whole_step": cp_step, "train": cp_train}}, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
