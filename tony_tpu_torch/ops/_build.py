"""Builds the CUDA kernels: ``nvcc`` over ``tony_tpu_torch/csrc/*.cu`` at first use.

Each source compiles on its own (all ``nvcc`` processes start together)
into a shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/tony_tpu_torch/<stem>-<hash>.so csrc/<stem>.cu

The library name carries a hash of the sources, so an edit rebuilds and an
unchanged tree reuses what an earlier process built (``chip_smoke.py``
builds once; the server it starts finds the libraries ready). ``ptxas``'s
register and shared-memory report lands beside each library as ``.log``,
which ends with the ``nvcc``'s wall seconds.
The kernels are built from this package's own sources only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tony_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

#: the last line of each build's ``.log``: this, then the ``nvcc``'s wall seconds
NVCC_WALL = "nvcc wall seconds:"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels cannot be built")


def _sources() -> dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(stem: str, digest: str) -> Path:
    return BUILD_DIR / f"{stem}-{digest}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing; returns {stem: path}.

    Raises with the compiler's output when any ``nvcc`` fails."""
    with _lock:
        digest = _digest()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = {stem: _lib_path(stem, digest) for stem in _sources()}
        todo = {stem: src for stem, src in _sources().items() if not out[stem].exists()}
        running = {}
        t0 = time.perf_counter()
        for stem, src in todo.items():
            # write to private names, publish by rename: two processes
            # building at once never load a half-written library
            tmp = out[stem].with_suffix(f".{os.getpid()}.tmp")
            log = out[stem].with_suffix(f".{os.getpid()}.log.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            with log.open("w") as f:
                running[stem] = (tmp, log, subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT))
        errors = []
        while running:
            for stem in [s for s, (_, _, p) in running.items() if p.poll() is not None]:
                tmp, log, proc = running.pop(stem)
                with log.open("a") as f:
                    f.write(f"{NVCC_WALL} {time.perf_counter() - t0:.1f}\n")
                os.replace(log, out[stem].with_suffix(".log"))
                if proc.returncode != 0:
                    text = out[stem].with_suffix(".log").read_text()
                    errors.append(f"nvcc {stem}.cu failed ({proc.returncode}):\n{text}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, out[stem])
            if running:
                time.sleep(0.05)
        if errors:
            raise RuntimeError("\n".join(errors))
        return out


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use)."""
    lib = _libs.get(stem)
    if lib is None:
        path = build_all()[stem]
        with _lock:
            lib = _libs.get(stem)
            if lib is None:
                lib = _libs[stem] = ctypes.CDLL(str(path))
    return lib


_tickets: dict = {}


def tickets(device, n: int, what: str) -> torch.Tensor:
    """The device's ticket buffer, at least ``n`` int32 zeros, for the kernels
    whose last block to finish merges the others' partials (decode attention,
    the int8 matmul's K splits): each merging block resets its ticket, so the
    buffer is zero between calls. The kernels share it, so their calls must not
    overlap on two streams (the port launches every kernel on the current
    stream). It is made (or grown, keeping the old one alive for any CUDA graph
    that holds it) outside a graph capture, so a captured call reuses it."""
    bufs = _tickets.setdefault(device, [])
    if not bufs or bufs[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{what}: call it once outside the CUDA graph capture "
                               f"(its ticket buffer of {n} does not exist yet)")
        bufs.append(torch.zeros(max(n, 4096), dtype=torch.int32, device=device))
    return bufs[-1]


def check(rc: int, what: str) -> None:
    """Raise when a C entry returned a non-zero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address (None → NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, where every kernel launches."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
