"""Where B4/B5's time goes on the card: variants of ``csrc/decode_attention.cu``.

    python -m tony_tpu_torch.ops.decode_attention_probe [--out FILE]

Needs one CUDA card. Builds copies of the kernel source under
``build/decode_attention_probe/``, each with one change:

- ``as built``: the source unchanged;
- other block shapes: the warps a block (``NW``) and the positions a split
  (``SPLIT``);
- ``loads only``: the tiles are loaded and waited for, never computed on;
- ``math only``: no tile is loaded past the ring's prologue, the math runs
  on whatever the stages hold;
- ``bf16 P``: P . V from P rounded to bf16, without its low-order term.

and times each on ``chip_smoke.py``'s decode cases (Llama-3-8B widths):
the event pair with L2 flushed as ``chip_smoke.py`` times, the kernel's
device time from ``torch.profiler``, and its largest error against the
plain version (the diagnostic cuts compute garbage by design). Prints the
event-pair floor (a 16-byte memset) and one line a (variant, case).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "tony_tpu_torch" / "csrc" / "decode_attention.cu"
OUT = ROOT / "build" / "decode_attention_probe"

_LOOP_HEAD = """      const unsigned char* ks_ = ring + (i % NST) * G::STAGE;
      const unsigned char* vs_ = ks_ + G::TILE;
      const int t = warp + i * NW;
      const bool tail = t >= n_pool;
      const int x0 = tile_x0(t);
      // scores"""
_NEXT_LOAD = "      if (i + NST - 1 < my_tiles) load(i + NST - 1);\n      cp_commit();\n      cp_wait<NST - 1>();"
_PV = """        mma(o[2 * nv], pl0, pl2, bv[0], bv[1]);
        mma(o[2 * nv + 1], ph0, ph2, bv[2], bv[3]);
        mma(o[2 * nv + 1], pl0, pl2, bv[2], bv[3]);"""

# (name, [(text in the source, its replacement)]); the bf16 loop's text comes first
VARIANTS = [
    ("as built", []),
    ("8 warps, split 256", [("constexpr int NW = 4;", "constexpr int NW = 8;")]),
    ("4 warps, split 128", [("constexpr int SPLIT = 256;", "constexpr int SPLIT = 128;")]),
    ("2 warps, split 256", [("constexpr int NW = 4;", "constexpr int NW = 2;")]),
    ("loads only", [(_LOOP_HEAD, "      if (lane < 32) {\n        __syncwarp();\n        continue;\n      }\n"
                     + _LOOP_HEAD)]),
    ("math only", [(_NEXT_LOAD, "      cp_commit();\n      cp_wait<NST - 1>();")]),
    ("bf16 P", [(_PV, "        mma(o[2 * nv + 1], ph0, ph2, bv[2], bv[3]);")]),
]


def build(name: str, subs: list, nvcc: str, flags: list) -> subprocess.Popen:
    src = SRC.read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"variant {name!r}: its text is no longer in {SRC.name}")
        src = src.replace(old, new, 1)
    d = OUT / name.replace(" ", "_").replace(",", "")
    d.mkdir(parents=True, exist_ok=True)
    (d / "k.cu").write_text(src)
    return subprocess.Popen([nvcc, *flags, "-o", str(d / "k.so"), str(d / "k.cu")],
                            stdout=(d / "log").open("w"), stderr=subprocess.STDOUT)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="", help="also write the results to this JSON file")
    args = p.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("decode_attention_probe: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tony_tpu_torch.ops import _build
    from tony_tpu_torch.ops import decode_attention as DA

    procs = {name: build(name, subs, _build._nvcc(), _build.NVCC_FLAGS) for name, subs in VARIANTS}
    entries = {}
    for name, proc in procs.items():
        d = OUT / name.replace(" ", "_").replace(",", "")
        if proc.wait() != 0:
            raise SystemExit(f"variant {name!r} did not build:\n{(d / 'log').read_text()[-3000:]}")
        lib = ctypes.CDLL(str(d / "k.so"))
        fn = lib.tt_decode_attention
        fn.restype, fn.argtypes = ctypes.c_int, DA._ARGTYPES
        lib.tt_decode_split_rows.restype = ctypes.c_int
        entries[name] = (fn, lib.tt_decode_split_rows())

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    tiny = torch.empty(16, dtype=torch.int8, device="cuda")
    floor = cs.time_ms(torch, tiny.zero_, flush)
    print(f"event-pair floor (a 16-byte memset, L2 flushed): {floor:.4f} ms", flush=True)
    cases = cs.attention_cases(torch)
    results = []
    for name, entry in entries.items():
        DA._bound["entry"] = entry
        for case, c in cases.items():
            def run(c=c):
                return cs.run_attention(torch, DA, c, plain=False)

            err = (run().float() - cs.run_attention(torch, DA, c, plain=True).float()).abs().max().item()
            ms = cs.time_ms(torch, run, flush)
            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    flush.zero_()
                    run()
                torch.cuda.synchronize()
            dev = sorted((e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA and "decode_attention_kernel" in e.name)
            kernel_ms = dev[len(dev) // 2] if dev else None
            results.append({"variant": name, "case": case, "ms": ms, "kernel_ms": kernel_ms, "max_abs_err": err})
            print(f"{name:20s} {case:20s} ms {ms:.4f} kernel "
                  + (f"{kernel_ms:.4f}" if kernel_ms is not None else "not measured") + f" max_abs_err {err:.2e}",
                  flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps({"card": card, "event_floor_ms": floor, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
