"""TONYTOK shards and the exactly-once replay primitives.

Own copy of ``tony_tpu/data/dataset.py``'s shard format and replay rules,
byte- and file-compatible with it: a shard written by either package is
read by the other, and so is a consumption cursor.

Layout (little-endian): 8-byte magic ``TONYTOK1``, u32 dtype (0=uint16,
1=int32), u64 token count, then the flat token payload. ``global_slots``
is the rule of which global sample slots a rank owns in a global batch;
``ConsumptionCursor`` is how far the stream was consumed, written beside
each checkpoint. Together they make "no sample dropped or consumed twice
across a resume at another world size" a property a test can check.
``pack_sequences`` lays variable-length documents into fixed rows with
segment ids, as the JAX package's does.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np

MAGIC = b"TONYTOK1"
HEADER_SIZE = 20  # 8-byte magic + u32 dtype + u64 count

_DTYPES = {0: np.dtype("<u2"), 1: np.dtype("<i4")}


def write_token_shard(path: str | Path, tokens: np.ndarray) -> Path:
    """Write one shard; uint16 when every id fits, else int32."""
    path = Path(path)
    tokens = np.asarray(tokens).ravel()
    if tokens.size and int(tokens.min()) < 0:
        raise ValueError("negative token ids")
    code = 0 if (tokens.size == 0 or int(tokens.max()) <= 0xFFFF) else 1
    payload = tokens.astype(_DTYPES[code])
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<IQ", code, payload.size))
        f.write(payload.tobytes())
    return path


def open_shard(path: str | Path) -> np.memmap:
    """Memory-map a shard's payload in its stored dtype (no copy)."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(HEADER_SIZE)
    if len(head) < HEADER_SIZE or head[:8] != MAGIC:
        raise ValueError(f"{path}: not a TONYTOK1 shard")
    code, count = struct.unpack_from("<IQ", head, 8)
    if code not in _DTYPES:
        raise ValueError(f"{path}: unknown dtype code {code}")
    return np.memmap(path, dtype=_DTYPES[code], mode="r", offset=HEADER_SIZE, shape=(count,))


def global_slots(batch_index: int, global_batch: int, shard_id: int, num_shards: int) -> range:
    """The global sample slots rank ``shard_id`` of ``num_shards`` consumes
    in global batch ``batch_index``: the contiguous rows
    ``[t*G + k*b, t*G + (k+1)*b)`` with ``G = global_batch``, ``b = G / K``.

    A pure function of (batch index, world size), so over any history of
    world sizes that covers global batches ``[0, T)`` at a constant ``G``
    the ranks' slots are ``range(0, T*G)``, each once."""
    if num_shards < 1 or not 0 <= shard_id < num_shards:
        raise ValueError(f"shard_id {shard_id} out of range for num_shards {num_shards}")
    if global_batch % num_shards:
        raise ValueError(f"global batch {global_batch} must divide by num_shards {num_shards}")
    b = global_batch // num_shards
    start = batch_index * global_batch + shard_id * b
    return range(start, start + b)


@dataclass
class ConsumptionCursor:
    """The data-consumption position saved with checkpoint step
    ``global_batch_index`` (one global batch a step). It pins the draw
    ``seed`` and the global batch size, the two knobs exact replay depends
    on; ``world_size`` records who wrote it, the one thing allowed to
    change across a resume."""

    global_batch_index: int
    global_batch_size: int
    seed: int
    world_size: int = 1

    def save(self, ckpt_dir: str | Path) -> Path:
        """Atomic write to ``<ckpt_dir>/cursor-<index>.json``."""
        path = Path(ckpt_dir) / f"cursor-{self.global_batch_index}.json"
        tmp = str(path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(asdict(self), f)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, ckpt_dir: str | Path, global_batch_index: int) -> "ConsumptionCursor | None":
        """The cursor saved with step ``global_batch_index``, or None."""
        path = Path(ckpt_dir) / f"cursor-{global_batch_index}.json"
        try:
            with open(path) as f:
                d = json.load(f)
            return cls(global_batch_index=int(d["global_batch_index"]),
                       global_batch_size=int(d["global_batch_size"]),
                       seed=int(d["seed"]), world_size=int(d.get("world_size", 1)))
        except (OSError, ValueError, KeyError):
            return None

    def validate_resume(self, global_batch_size: int, seed: int, start_index: int) -> None:
        """Raise unless a resume with this global batch, seed and loader
        start continues the checkpointed stream (no sample twice or lost)."""
        if global_batch_size != self.global_batch_size:
            raise ValueError(
                f"global batch changed across resume: checkpointed stream "
                f"consumed {self.global_batch_size} rows/step, resuming with "
                f"{global_batch_size} — the replay contract requires a "
                "constant GLOBAL batch (per-rank batch adapts instead)")
        if seed != self.seed:
            raise ValueError(
                f"data seed changed across resume: {self.seed} → {seed} — "
                "the resumed draw would be a different stream")
        if start_index != self.global_batch_index:
            raise ValueError(
                f"loader resume position {start_index} disagrees with the "
                f"checkpoint's consumption cursor {self.global_batch_index}")


def pack_sequences(sequences, seq_len: int, pad_id: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """First-fit pack variable-length sequences into [N, seq_len] rows.

    Returns (tokens, segment_ids), both [N, seq_len] int32. Each row holds
    one or more whole sequences back to back; segment_ids number them 1, 2,
    ... within the row, with 0 marking trailing padding. Sequences longer
    than seq_len are split into seq_len-sized pieces."""
    rows: list[tuple[list[int], list[int]]] = []  # (tokens, segs), filled in place
    for seq in sequences:
        seq = [int(t) for t in np.asarray(seq, dtype=np.int32)]
        for off in range(0, len(seq), seq_len):
            piece = seq[off:off + seq_len]
            for toks, segs in rows:
                if len(toks) + len(piece) <= seq_len:
                    segs.extend([segs[-1] + 1] * len(piece))
                    toks.extend(piece)
                    break
            else:
                rows.append((list(piece), [1] * len(piece)))
    tokens = np.full((len(rows), seq_len), pad_id, dtype=np.int32)
    segment_ids = np.zeros((len(rows), seq_len), dtype=np.int32)
    for i, (toks, segs) in enumerate(rows):
        tokens[i, :len(toks)] = toks
        segment_ids[i, :len(segs)] = segs
    return tokens, segment_ids
