"""The context ring's transport: the shards a process holds and how they move.

Counterpart of ``tony_tpu/parallel/collectives.py`` for the ring code
(``rotate`` :25, ``all_to_all`` :45, ``all_gather`` :33 and
``stop_transfer_if_single`` :73). JAX runs one program per device inside
``shard_map`` and moves shards with ``ppermute``; here one interface has two
implementations, and the ring code (``ops/ring.py``, ``parallel/context.py``)
calls only the interface:

- ``DeviceRing(n, device)``: one process holds all ``n`` context shards on one
  device, the counterpart of the JAX package's single-process mesh over
  virtual devices. A rotation is a real copy into the neighbour shard's
  buffer; on a CUDA device it is issued on a side stream and ordered with
  CUDA events, so the double-buffer protocol the TPU kernel runs with
  semaphores (``ops/ring.py:143-166``, ``:274-286``) runs on the card too.
- ``ProcessRing(group)``: one shard per process of a ``torch.distributed``
  group (gloo on the CPU, nccl on cards), with point-to-point sends to rank
  + 1 and receives from rank - 1.

The interface: ``n`` (ring size), ``positions`` (the ring positions this
process holds, in order along the sequence), ``split``/``join`` (a tensor
of the held shards, concatenated along the sequence, to and from a list of
shards), ``send_recv`` (every held shard sends a buffer right and receives
its left neighbour's into another; returns something to ``wait()`` on),
``rotate`` (the same as a differentiable function of a list),
``all_gather`` and ``all_to_all``. A size-1 ring moves nothing: its
``rotate`` and ``all_to_all`` return their input, as
``stop_transfer_if_single`` does.

The data axis's reduction is ``all_reduce_mean`` (JAX's ``psum`` :37 over
the gang, divided by its size): the gradients of every rank, packed into
flat f32 buckets so a step makes a few calls instead of one a tensor.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _check_split(x: torch.Tensor, dim: int, n: int) -> None:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split into {n} shards")


class _Done:
    """A transfer that has completed (the CPU's copies are synchronous)."""

    def wait(self) -> None:
        pass


class _EventWait:
    """A side-stream copy: ``wait()`` orders the current stream after it."""

    def __init__(self, event: torch.cuda.Event, device: torch.device):
        self.event, self.device = event, device

    def wait(self) -> None:
        torch.cuda.current_stream(self.device).wait_event(self.event)


class _Works:
    def __init__(self, works):
        self.works = works

    def wait(self) -> None:
        for w in self.works:
            w.wait()


class DeviceRing:
    """All ``n`` shards of the context ring in this process, on one device."""

    def __init__(self, n: int, device: torch.device | str):
        if n < 1:
            raise ValueError(f"ring size must be >= 1, got {n}")
        self.n = n
        self.device = torch.device(device)
        self.positions = tuple(range(n))
        self._stream = None

    def split(self, x: torch.Tensor, dim: int) -> list[torch.Tensor]:
        if x.shape[dim] % self.n:
            raise ValueError(f"length {x.shape[dim]} does not split into {self.n} context shards")
        return list(x.chunk(self.n, dim))

    def join(self, xs: list[torch.Tensor], dim: int) -> torch.Tensor:
        return torch.cat(xs, dim) if len(xs) > 1 else xs[0]

    def send_recv(self, src, dst):
        """``dst[j] ← src[j - 1]`` (mod n) for each pair of buffers ``[held, ...]``.

        On a CUDA device the copies run on a side stream that first waits for
        everything already enqueued on the current stream (the producers of
        ``src`` and the last readers of ``dst``); kernels enqueued after this
        call run beside them, and ``wait()`` makes the current stream wait for
        the copies. On the CPU they run here."""
        pairs = list(zip(src, dst))
        if self.device.type != "cuda":
            for s, d in pairs:
                self._shift(s, d)
            return _Done()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            for s, d in pairs:
                self._shift(s, d)
            event = torch.cuda.Event()
            event.record(self._stream)
        return _EventWait(event, self.device)

    def _shift(self, s: torch.Tensor, d: torch.Tensor) -> None:
        d[1:].copy_(s[:-1])
        d[:1].copy_(s[-1:])

    def rotate(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each shard's tensor moves to the next position (a copy; autograd
        sends its gradient back)."""
        if self.n == 1:
            return xs
        return [xs[-1].clone()] + [x.clone() for x in xs[:-1]]

    def all_gather(self, xs: list[torch.Tensor], dim: int) -> torch.Tensor:
        """The whole sequence from every shard's piece (concatenated along ``dim``)."""
        return self.join(list(xs), dim)

    def all_to_all(self, xs: list[torch.Tensor], split_dim: int, concat_dim: int) -> list[torch.Tensor]:
        """Shard j receives chunk j (of n along ``split_dim``) of every shard's
        tensor, concatenated in ring order along ``concat_dim`` (differentiable)."""
        _check_split(xs[0], split_dim, self.n)
        if self.n == 1:
            return xs
        chunks = [x.chunk(self.n, split_dim) for x in xs]
        return [torch.cat([chunks[i][j] for i in range(self.n)], concat_dim) for j in range(self.n)]


class ProcessRing:
    """One shard of the context ring per process of ``group``."""

    def __init__(self, group=None):
        self.group = group if group is not None else dist.group.WORLD
        self.n = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.positions = (self.rank,)
        self._right = dist.get_global_rank(self.group, (self.rank + 1) % self.n)
        self._left = dist.get_global_rank(self.group, (self.rank - 1) % self.n)

    def split(self, x: torch.Tensor, dim: int) -> list[torch.Tensor]:
        return [x]

    def join(self, xs: list[torch.Tensor], dim: int) -> torch.Tensor:
        return xs[0]

    def _p2p(self, src, dst, to_right: bool = True):
        send_to, recv_from = (self._right, self._left) if to_right else (self._left, self._right)
        ops = []
        for s, d in zip(src, dst):
            ops.append(dist.P2POp(dist.isend, s.contiguous(), send_to, self.group))
            ops.append(dist.P2POp(dist.irecv, d, recv_from, self.group))
        return _Works(dist.batch_isend_irecv(ops))

    def send_recv(self, src, dst):
        """``dst[0] ←`` rank - 1's ``src[0]`` for each pair of buffers ``[1, ...]``."""
        if self.n == 1:
            for s, d in zip(src, dst):
                d.copy_(s)
            return _Done()
        return self._p2p(src, dst)

    def rotate(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        if self.n == 1:
            return xs
        return [_Rotate.apply(xs[0], self)]

    def all_gather(self, xs: list[torch.Tensor], dim: int) -> torch.Tensor:
        x = xs[0].contiguous()
        out = [torch.empty_like(x) for _ in range(self.n)]
        dist.all_gather(out, x, group=self.group)
        return torch.cat(out, dim)

    def all_to_all(self, xs: list[torch.Tensor], split_dim: int, concat_dim: int) -> list[torch.Tensor]:
        _check_split(xs[0], split_dim, self.n)
        if self.n == 1:
            return xs
        return [_AllToAll.apply(xs[0], self, split_dim, concat_dim)]

    def _all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        inp = torch.stack(x.chunk(self.n, split_dim)).contiguous()
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp, group=self.group)
        return torch.cat(out.unbind(0), concat_dim)


class _Rotate(torch.autograd.Function):
    """Send right, receive from the left; the gradient goes the other way."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        x = x.contiguous()
        out = torch.empty_like(x)
        ring._p2p([x], [out]).wait()
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        ctx.ring._p2p([g], [out], to_right=False).wait()
        return out, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, split_dim, concat_dim):
        ctx.ring, ctx.dims = ring, (split_dim, concat_dim)
        return ring._all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return ctx.ring._all_to_all(g, concat_dim, split_dim), None, None, None


#: elements of one flat f32 bucket of ``all_reduce_mean`` (64 MiB)
BUCKET_NUMEL = 16 << 20


def all_reduce_mean(tensors: list[torch.Tensor], group=None) -> None:
    """Replace each tensor, in place, by its mean over the ``group``'s ranks.

    The tensors are packed in order into flat f32 buckets of at most
    ``BUCKET_NUMEL`` elements (a larger tensor is a bucket of its own), one
    collective a bucket; the mean is written back in each tensor's dtype.
    nccl averages in the collective; gloo has no AVG, so it sums and
    divides by the world size. Call it from the thread that runs the step:
    collectives of one group must be issued in the same order on every
    rank."""
    world = dist.get_world_size(group)
    nccl = dist.get_backend(group) == dist.Backend.NCCL
    bucket: list[torch.Tensor] = []
    filled = 0
    for t in [*tensors, None]:
        if bucket and (t is None or filled + t.numel() > BUCKET_NUMEL):
            flat = torch.cat([b.reshape(-1).float() for b in bucket])
            if nccl:
                dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=group)
            else:
                dist.all_reduce(flat, group=group)
                flat /= world
            for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                b.copy_(part.view_as(b))
            bucket, filled = [], 0
        if t is not None:
            bucket.append(t)
            filled += t.numel()
