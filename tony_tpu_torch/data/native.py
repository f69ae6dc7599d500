"""``TokenLoader``: (seq+1)-token windows drawn from TONYTOK shards.

Own copy of ``tony_tpu/data/native.py``'s loader. The native path binds
the repository's C++ loader (``native/tonyio.cc``: mmapped shards,
prefetch threads off the interpreter lock) with ``ctypes``; ``make -C
native`` builds ``native/libtonyio.so`` at first use. Where it cannot be
built or loaded, ``draw_batch`` computes the same batches with numpy. Both
draw window ``splitmix(splitmix(seed ^ splitmix(epoch)) ^ pos) % windows``
for global slot ``epoch * windows + pos``, so the two paths, and the JAX
package's loader, give the same batches in the same order.

Global-order contract (the exactly-once replay rule): the stream is one
sequence of samples, a pure function of (seed, global slot). Shard ``k`` of
``K`` produces rows ``[k*batch, (k+1)*batch)`` of each global batch of
``G = batch * K`` rows (``dataset.global_slots``), so a resume at another
``K`` that keeps ``G`` and the seed, and starts at ``start_index`` = the
global batch index, replays the uninterrupted stream.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

from tony_tpu_torch.data.dataset import open_shard

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libtonyio.so"
_lib_lock = threading.Lock()
_lib: list = []  # [library or None] once the first load was tried
#: the C++ loader's lookahead (batches) and reader threads, as the JAX loader's defaults
_PREFETCH_DEPTH, _THREADS = 4, 2


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u32, u64, vp = ctypes.c_uint32, ctypes.c_uint64, ctypes.c_void_p
    lib.tony_loader_open_at.restype = ctypes.c_int
    lib.tony_loader_open_at.argtypes = [ctypes.c_char_p, u32, u32, u32, u32, u64, u32, u32, u64,
                                        ctypes.POINTER(vp)]
    lib.tony_loader_next.restype = ctypes.c_int
    lib.tony_loader_next.argtypes = [vp, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(u64)]
    lib.tony_loader_total_tokens.restype = u64
    lib.tony_loader_total_tokens.argtypes = [vp]
    lib.tony_loader_close.restype = None
    lib.tony_loader_close.argtypes = [vp]
    return lib


def load_library() -> ctypes.CDLL | None:
    """The C++ loader, built with ``make -C native`` on the first call (make
    skips an up-to-date library); None when it cannot be built or loaded."""
    with _lib_lock:
        if not _lib:
            try:
                try:
                    # under the lock: concurrent first callers wait for the one build
                    subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                                   capture_output=True, timeout=120)
                except (OSError, subprocess.SubprocessError):
                    if not _LIB_PATH.exists():
                        raise
                _lib.append(_bind(ctypes.CDLL(str(_LIB_PATH))))
            except (OSError, subprocess.SubprocessError, AttributeError):
                _lib.append(None)  # no toolchain or a stale library: the numpy path
        return _lib[0]


def _splitmix(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def draw_batch(shards: list[np.ndarray], batch: int, seq: int, shard_id: int, num_shards: int,
               seed: int, index: int) -> np.ndarray:
    """Local batch ``index`` of shard ``shard_id``: [batch, seq+1] int32, the
    numpy path of ``TokenLoader`` (the same draw as the C++ loader's)."""
    stride = seq + 1
    per_shard = [s.size // stride for s in shards]
    nw = sum(per_shard)
    if nw < 1:
        raise ValueError("not enough data for a single (seq+1)-token window")
    out = np.empty((batch, stride), np.int32)
    for i in range(batch):
        g = index * batch * num_shards + shard_id * batch + i
        epoch, pos = divmod(g, nw)
        w = _splitmix(_splitmix(seed ^ _splitmix(epoch)) ^ pos) % nw
        for s, here in zip(shards, per_shard):
            if w < here:
                out[i] = s[w * stride:(w + 1) * stride]
                break
            w -= here
    return out


class TokenLoader:
    """Local batches ``start_index, start_index + 1, ...`` of shard
    ``shard_id`` of ``num_shards``: [batch, seq+1] int32 (tokens and the
    shifted targets), from the C++ loader or, without it, ``draw_batch``."""

    def __init__(self, shard_paths: list[str | Path], batch: int, seq: int, *, shard_id: int = 0,
                 num_shards: int = 1, seed: int = 0, start_index: int = 0):
        if not shard_paths:
            raise ValueError("no shard paths")
        if num_shards < 1 or not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} out of range for num_shards {num_shards}")
        if start_index < 0:
            raise ValueError(f"start_index must be >= 0, got {start_index}")
        self.batch, self.seq = batch, seq
        self.shard_id, self.num_shards, self.seed = shard_id, num_shards, seed
        self._index = start_index
        self._handle = None
        self._lib = load_library()
        if self._lib is not None:
            blob = b"".join(str(Path(p)).encode() + b"\0" for p in shard_paths) + b"\0"
            handle = ctypes.c_void_p()
            rc = self._lib.tony_loader_open_at(blob, batch, seq, shard_id, num_shards, seed,
                                               _PREFETCH_DEPTH, _THREADS, start_index,
                                               ctypes.byref(handle))
            if rc != 0:
                raise ValueError(f"tony_loader_open failed (rc={rc}) for {shard_paths}")
            self._handle = handle
            self._out = np.empty((batch, seq + 1), np.int32)
            self.total_tokens = int(self._lib.tony_loader_total_tokens(handle))
        else:
            self._shards = [open_shard(p) for p in shard_paths]
            self.total_tokens = int(sum(s.size for s in self._shards))

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def next(self) -> np.ndarray:
        """The next [batch, seq+1] int32 batch."""
        if self._handle is None:
            out = draw_batch(self._shards, self.batch, self.seq, self.shard_id, self.num_shards,
                             self.seed, self._index)
            self._index += 1
            return out
        idx = ctypes.c_uint64()
        rc = self._lib.tony_loader_next(self._handle,
                                        self._out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                        ctypes.byref(idx))
        if rc != 0:
            raise RuntimeError(f"tony_loader_next failed (rc={rc})")
        return self._out.copy()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.tony_loader_close(self._handle)
            self._handle = None
