#!/usr/bin/env python3
"""On-card smoke check of the PyTorch/CUDA port (``tony_tpu_torch``).

    python3 chip_smoke.py [--out DIR]

Needs one CUDA card. Phases, any failure exits non-zero before the result:

1. card and build: prints ``nvidia-smi``'s name and power limit, builds every
   kernel from ``tony_tpu_torch/csrc`` with ``nvcc`` and prints the seconds;
2. kernels: holds each kernel against its plain PyTorch version on the card,
   in bf16, at the Llama-3-8B serving shapes, and times the kernel, the plain
   version, the one PyTorch call that computes the same function (SDPA over a
   padded batch; ``x @ W_bf16``) and the least time the card could take;
3. serve: starts ``python -m tony_tpu_torch.models.serving_http --preset
   llama3-8b`` (full width, all 32 layers, seeded random weights, 8 slots,
   max_len 2048) three times — paged KV (the default), ``--int8``, and
   ``--kv dense --attn ragged`` — sends eight requests to each (two sharing a
   512-token prefix, two identical greedy prompts, one streamed), checks
   every request returns ``max_tokens`` tokens, the identical prompts agree,
   ``/stats`` (prefix hits on the paged runs, kernel launch counts > 0), and
   that SIGTERM drains to exit 0; then a decode-dominated batch (one 16-token
   prompt per slot, 128-token answers); prints tok/s of both batches, the
   decode step time and the time to the first streamed token;
4. prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.

Imports only ``tony_tpu_torch``, torch, numpy and the standard library.
"""

from __future__ import annotations

import argparse
import json
import os
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
INT8_REL_TOL = 2e-2  # max |kernel - plain| <= 2e-2 * max |plain|: ~2.5 bf16 ulps at the top of the range


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# -- timing ------------------------------------------------------------------

def time_ms(torch, fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` with CUDA events, L2 flushed before each
    launch (the serving caller finds weights and KV cold)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # hold the card while the host enqueues every launch, so each event pair
    # times the device work and not the host's launch latency
    torch.cuda._sleep(100_000_000)
    pairs = []
    for _ in range(iters):
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
    return {
        "ragged": dict(base, kind="ragged", ck=ck, cv=cv, window=0),
        "ragged_window": dict(base, kind="ragged", ck=ck, cv=cv, window=700),
        "paged": dict(base, kind="paged", ck=kp, cv=vp, page_table=pt, window=0),
        "paged_staged": dict(base, kind="paged", ck=kp, cv=vp, page_table=pt, window=0,
                             staged_k=sk, staged_v=sv, staged_count=count),
        "paged_staged_window": dict(base, kind="paged", ck=kp, cv=vp, page_table=pt, window=700,
                                    staged_k=sk, staged_v=sv, staged_count=count),
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
    cases = attention_cases(torch)
    att = {}
    for name, c in cases.items():
        got = run_attention(torch, DA, c, plain=False)
        torch.cuda.synchronize()
        want = run_attention(torch, DA, c, plain=True)
        check(bool(torch.isfinite(got.float()).all()), f"decode attention {name}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        rec = {"case": name, "max_abs_err": err, "tol": ATTN_TOL}
        print(f"[kernel] decode_attention {name:20s} max_abs_err {err:.3e} (tol {ATTN_TOL})", flush=True)
        check(err <= ATTN_TOL, f"decode attention {name}: error {err} > {ATTN_TOL}")
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
        print(f"[kernel]   ms {rec['ms']:.4f} plain {rec['plain_ms']:.4f} sdpa {rec['library_ms']:.4f} "
              f"bound {rec['bound_ms']:.4f} ({rec['bound_by']}); sdpa err {rec['library_max_abs_err']:.3e}",
              flush=True)
        att[name] = rec
        del qq, kk, vv, mm
    out["ragged_decode_attention"] = dict(att["ragged"], cases=[att["ragged"], att["ragged_window"]])
    out["paged_decode_attention"] = dict(
        att["paged_staged"], cases=[att["paged"], att["paged_staged"], att["paged_staged_window"]])
    del cases
    torch.cuda.empty_cache()

    g = torch.Generator(device="cuda").manual_seed(1)
    mm_recs = []
    for K, N in INT8_SHAPES:
        w = torch.randn(K, N, generator=g, device="cuda") / K ** 0.5
        qt = Q.quantize_int8(w)
        del w
        w_bf16 = Q.dequantize(qt, torch.bfloat16)
        for M in (8, 128):
            x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
            got = Q.int8_matmul(x, qt)
            torch.cuda.synchronize()
            want = Q.int8_matmul_plain(x, qt)
            check(bool(torch.isfinite(got.float()).all()), f"int8_matmul {M}x{K}x{N}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            tol = INT8_REL_TOL * want.float().abs().max().item()
            name = f"M{M}_K{K}_N{N}"
            print(f"[kernel] int8_matmul {name:22s} max_abs_err {err:.3e} (tol {tol:.3e})", flush=True)
            check(err <= tol, f"int8_matmul {name}: error {err} > {tol}")
            rec = {"case": name, "max_abs_err": err, "tol": tol}
            rec["ms"] = time_ms(torch, lambda: Q.int8_matmul(x, qt), flush)
            rec["plain_ms"] = time_ms(torch, lambda: Q.int8_matmul_plain(x, qt), flush, iters=5)
            rec["library_ms"] = time_ms(torch, lambda: x @ w_bf16, flush)
            b = K * N + 4 * N + 2 * M * K + 2 * M * N
            f = 2 * M * K * N
            rec["bound_ms"] = max(b / HBM_BYTES_PER_S, f / BF16_FLOPS) * 1e3
            rec["bound_by"] = "bytes" if b / HBM_BYTES_PER_S >= f / BF16_FLOPS else "operations"
            print(f"[kernel]   ms {rec['ms']:.4f} plain {rec['plain_ms']:.4f} x@W_bf16 {rec['library_ms']:.4f} "
                  f"bound {rec['bound_ms']:.4f} ({rec['bound_by']})", flush=True)
            mm_recs.append(rec)
        del qt, w_bf16
        torch.cuda.empty_cache()
    head = next(r for r in mm_recs if r["case"] == "M8_K4096_N14336")
    out["int8_matmul"] = dict(head, cases=mm_recs)
    return out


# -- serve phase ---------------------------------------------------------------

def _post(url: str, body: dict, timeout: float = 600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _get(url: str, timeout: float = 60) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def serve_requests():
    """Eight requests: two sharing a 512-token prefix, two identical greedy
    prompts (shorter than a page, so neither is a prefix hit of the other
    and both run the same computation), four of other lengths; the last is
    streamed. Tokens come from a seeded numpy generator."""
    import numpy as np

    rng = np.random.default_rng(0)
    tok = lambda n: rng.integers(1, 128_000, n).tolist()  # noqa: E731
    prefix = tok(512)
    same = tok(100)
    prompts = [prefix + tok(40), prefix + tok(70), same, list(same), tok(17), tok(300), tok(1000), tok(200)]
    return [{"prompt_tokens": p, "max_tokens": 32, "stream": i == 7} for i, p in enumerate(prompts)]


DECODE_TOKENS = 128


def decode_requests():
    """Eight short prompts (16 tokens) with 128-token answers: one per slot,
    so the run is dominated by full-batch decode steps."""
    import numpy as np

    rng = np.random.default_rng(1)
    return [{"prompt_tokens": rng.integers(1, 128_000, 16).tolist(), "max_tokens": DECODE_TOKENS,
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


# -- main ----------------------------------------------------------------------

KERNELS = {
    "ragged_decode_attention": ("tony_tpu_torch/csrc/decode_attention.cu",
                                "tony_tpu/ops/decode_attention.py:49 (_kernel via ragged_decode_attention :185)",
                                "dense_ragged"),
    "paged_decode_attention": ("tony_tpu_torch/csrc/decode_attention.cu",
                               "tony_tpu/ops/decode_attention.py:49 (_kernel via paged_decode_attention :263)",
                               "paged"),
    "int8_matmul": ("tony_tpu_torch/csrc/int8_matmul.cu",
                    "tony_tpu/ops/quant.py:54 (_quant_matmul_kernel via int8_matmul :78)",
                    "int8"),
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
    from tony_tpu_torch.ops import _build
    from tony_tpu_torch.ops import decode_attention as DA
    from tony_tpu_torch.ops import quant as Q

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
        del flush
        torch.cuda.empty_cache()
        serve = {name: run_server(name, extra, out_dir) for name, extra in SERVE_RUNS}
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    kernels = []
    for name, (source, replaces, run) in KERNELS.items():
        k = kern[name]
        launches = serve[run]["kernel_launches"][name]
        if not launches:
            print(f"chip_smoke FAILED: {name} was not launched by the {run} serve run", file=sys.stderr)
            return 1
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_run": run, "case": k["case"],
            "max_abs_err": k["max_abs_err"], "tol": k["tol"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"], "cases": k["cases"],
        })
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, "serve": serve}, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
