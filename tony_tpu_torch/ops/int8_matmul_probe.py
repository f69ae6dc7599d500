"""Where B6's time goes on the card: variants of ``csrc/int8_matmul.cu``.

    python -m tony_tpu_torch.ops.int8_matmul_probe [--out FILE]

Needs one CUDA card. Builds copies of the kernel source under
``build/int8_matmul_probe/``, each with one change:

- ``as built``: the source unchanged;
- the decode path's ring (``DSTAGES`` stages of ``DBK`` k rows) and its K
  splits (at most ``MAX_SPLITS``);
- ``decode loads only``: the decode consumers wait for each stage and hand it
  back without computing (the streaming rate alone);
- ``decode math only``: the decode producer loads the first ring of stages,
  then only flips the barriers, so the math runs on what the stages hold;
- ``prefill no convert``: the prefill consumers skip the int8 -> bf16
  conversion of their fragments (the loads and the products alone);
- ``f32 magic``: both paths convert through f32 (each byte into the low byte
  of 2^23, less 2^23 + 128, the pair packed) instead of the bf16x2 add;
- ``q L2 promotion``: the weight's tensor map promotes L2 fills to 128 bytes,
  or not at all, instead of 256;

and times each with the event pair, L2 flushed, as ``chip_smoke.py`` times
(and flushed clean, by a read, beside it),
on B6's serving cases: M 8 at the five Llama-3-8B weights of
``chip_smoke.INT8_SHAPES``, and M 16, 32, 64, 128 and 1024 at the gate/up
weight (K 4096, N 14336), each against ``x @ W_bf16`` and with its largest
error against the plain version (the diagnostic cuts compute garbage by
design). Prints one line a (variant, case).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "tony_tpu_torch" / "csrc" / "int8_matmul.cu"
OUT = ROOT / "build" / "int8_matmul_probe"

_PRODUCE = """        bar_arrive_tx(&full[s], G::STAGE);
        tma_load(st, &tq, &full[s], n0, k0, 0);"""

_BF2 = """  const uint32_t hi = (p & 0x007F007Fu) | 0x43004300u, lo = (p & 0x00800080u) | 0xC300C300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\\n" : "=r"(d) : "r"(hi), "r"(0x3F803F80u), "r"(lo));
  return d;"""
# the magic number in f32: each byte, sign flipped, into the low byte of 2^23, less 2^23 + 128,
# the pair packed from the floats' upper halves
_BF2_F32 = """  const uint32_t u = p ^ 0x00800080u;
  const float f0 = __uint_as_float(prmt(u, 0x4B000000u, 0x7540u)) - 8388736.f;
  const float f1 = __uint_as_float(prmt(u, 0x4B000000u, 0x7542u)) - 8388736.f;
  return prmt(__float_as_uint(f0), __float_as_uint(f1), 0x7632u);"""

_CONVERT = """__device__ __forceinline__ void convert_slab(uint32_t (&f)[4][4], const unsigned char* src,
                                             int chunk, int r, int c) {
"""

_PROMO = "unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,\n            CU_TENSOR_MAP_L2_PROMOTION_L2_256B"

# (name, [(text in the source, its replacement)])
VARIANTS = [
    ("as built", []),
    ("decode 4 stages", [("constexpr int DSTAGES = 6;", "constexpr int DSTAGES = 4;")]),
    ("decode 12 stages of 64", [("constexpr int DSTAGES = 6;", "constexpr int DSTAGES = 12;"),
                                ("constexpr int DBK = 128;", "constexpr int DBK = 64;")]),
    ("decode 16 splits", [("constexpr int MAX_SPLITS = 8;", "constexpr int MAX_SPLITS = 16;")]),
    ("decode loads only", [("    for (int j = 0; j < DBK / 64; ++j) {",
                            "    for (int j = 0; j < DBK / 64 && M < 0; ++j) {")]),
    ("decode math only", [(_PRODUCE, "        if (i >= DSTAGES) {\n          bar_arrive(&full[s]);\n"
                           "          continue;\n        }\n" + _PRODUCE)]),
    ("prefill no convert", [(_CONVERT, _CONVERT + "  if (r >= 0) return;\n")]),
    ("f32 magic", [(_BF2, _BF2_F32)]),
    ("q L2 promotion 128B", [(_PROMO, _PROMO.replace("L2_256B", "L2_128B"))]),
    ("q L2 promotion none", [(_PROMO, _PROMO.replace("L2_256B", "NONE"))]),
]

CASES = ([(8, K, N) for K, N in [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]]
         + [(M, 4096, 14336) for M in (16, 32, 64, 128, 1024)])


def variant_source(name: str, subs: list) -> str:
    src = SRC.read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"variant {name!r}: its text is no longer in {SRC.name}")
        src = src.replace(old, new, 1)
    return src


def build(name: str, src: str, nvcc: str, flags: list) -> subprocess.Popen:
    d = OUT / name.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    (d / "k.cu").write_text(src)
    (d / "hopper.cuh").write_text((SRC.parent / "hopper.cuh").read_text())
    return subprocess.Popen([nvcc, *flags, "-o", str(d / "k.so"), str(d / "k.cu")],
                            stdout=(d / "log").open("w"), stderr=subprocess.STDOUT)


def launch(torch, Q, entry, x, qt):
    """One call of a variant's C entry, as ``quant._launch`` makes it."""
    from tony_tpu_torch.ops import _build

    fn, plan = entry
    (M, K), N = x.shape, qt.q.shape[1]
    splits = plan(M, N, K, torch.cuda.get_device_properties(0).multi_processor_count, -1)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
    tickets = None
    if splits > 1:
        tickets = _build.tickets(x.device, -(-M // 128) * -(-N // 128), "int8_matmul probe")
    P = _build.ptr
    _build.check(fn(P(x), P(qt.q), P(qt.scale), P(out), P(ws), P(tickets), M, N, K, splits, -1,
                    _build.stream(x.device)), "int8_matmul probe")
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="", help="also write the results to this JSON file")
    p.add_argument("--variants", default="", help="comma-separated variant names (default: all)")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("int8_matmul_probe: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tony_tpu_torch.ops import _build
    from tony_tpu_torch.ops import quant as Q

    chosen = [v for v in VARIANTS if not args.variants or v[0] in args.variants.split(",")]
    sources = {name: variant_source(name, subs) for name, subs in chosen}  # all checked before any build
    procs = {name: build(name, src, _build._nvcc(), _build.NVCC_FLAGS) for name, src in sources.items()}
    entries = {}
    for name, proc in procs.items():
        d = OUT / name.replace(" ", "_")
        if proc.wait() != 0:
            raise SystemExit(f"variant {name!r} did not build:\n{(d / 'log').read_text()[-3000:]}")
        lib = ctypes.CDLL(str(d / "k.so"))
        fn, plan = lib.tt_int8_matmul, lib.tt_int8_matmul_splits
        fn.restype, fn.argtypes = ctypes.c_int, Q._ARGTYPES
        plan.restype, plan.argtypes = ctypes.c_int, [ctypes.c_int] * 5
        entries[name] = (fn, plan)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    weights = {}
    for _, K, N in CASES:
        if (K, N) not in weights:
            weights[K, N] = Q.quantize_int8(torch.randn(K, N, generator=g, device="cuda") / K ** 0.5)
    results = []
    for M, K, N in CASES:
        qt = weights[K, N]
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        want = Q.int8_matmul_plain(x, qt).float()
        w_bf16 = Q.dequantize(qt, torch.bfloat16)
        lib_ms = cs.time_ms(torch, lambda: x @ w_bf16, flush)
        del w_bf16
        b, f = K * N + 4 * N + 2 * M * K + 2 * M * N, 2 * M * K * N
        bound = max(b / cs.HBM_BYTES_PER_S, f / cs.BF16_FLOPS) * 1e3
        for name, entry in entries.items():
            ms = cs.time_ms(torch, lambda: launch(torch, Q, entry, x, qt), flush)
            ms_clean = cs.time_ms(torch, lambda: launch(torch, Q, entry, x, qt), flush, clean=True)
            err = (launch(torch, Q, entry, x, qt).float() - want).abs().max().item()
            results.append({"variant": name, "M": M, "K": K, "N": N, "ms": ms, "ms_clean_l2": ms_clean,
                            "library_ms": lib_ms,
                            "bound_ms": bound, "max_abs_err": err})
            print(f"{name:24s} M{M:<5d} K{K:<6d} N{N:<7d} ms {ms:.4f} (x@W_bf16 {lib_ms:.4f}, bound "
                  f"{bound:.4f}, {bound / ms:.0%}; L2 flushed clean {ms_clean:.4f}) max_abs_err {err:.2e}",
                  flush=True)
        del x, want
    if args.out:
        Path(args.out).write_text(json.dumps({"card": card, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
