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
  group, each sending to rank + 1 and receiving from rank - 1 through an
  ``all_to_all_single`` whose only non-empty splits are the right
  neighbour's send and the left neighbour's receive. That collective runs
  on gloo (CPU tensors, and CUDA tensors of ranks that share a card, which
  nccl refuses) and on nccl alike, while gloo's point-to-point hands its
  TCP transport the tensor's data pointer and has no CUDA path. The work's
  ``wait()`` orders the current stream after the transfer, and the
  transfer starts after everything already enqueued on it (gloo stages
  CUDA tensors through pinned host buffers on a side stream that first
  waits for the current one; nccl's stream does the same), so the
  double-buffer protocol of ``DeviceRing`` holds across processes.

The interface: ``n`` (ring size), ``positions`` (the ring positions this
process holds, in order along the sequence), ``split``/``join`` (a tensor
of the held shards, concatenated along the sequence, to and from a list of
shards), ``send_recv`` (every held shard sends a buffer right and receives
its left neighbour's into another; returns something to ``wait()`` on),
``rotate`` (the same as a differentiable function of a list),
``all_gather`` and ``all_to_all``. A size-1 ring moves nothing: its
``rotate`` and ``all_to_all`` return their input, as
``stop_transfer_if_single`` does.

The gang's axes (``data``, ``fsdp``) move tensors over a mesh axis's
process group (``Mesh.axis_group``): ``all_gather`` (:33; its backward is
the reduce-scatter), ``psum_scatter`` (:41; its backward is the
all-gather), ``psum`` (:37; its backward is ``psum``) and
``ring_all_reduce_sum`` (:50, the scatter then the gather). Sums run in
f32 and return the input's dtype.

The ``model`` axis runs Megatron's pair over the model line's group:
``copy_to_model`` (identity forward, ``psum`` backward) at the input of a
column-parallel product, and ``reduce_from_model`` (``psum`` forward,
identity backward) at the output of a row-parallel one. Unlike ``psum``,
whose ``psum`` backward is right for a value every rank differentiates
alone (the norm's scalar), the row-parallel output's upstream gradient is
already the whole one on every rank, so a ``psum`` there would multiply it
by the axis's size. ``pmax`` (no gradient) is the max the vocab-parallel
logsumexp shifts by. ``DeviceModel`` is the same pair for shards held in
one process (the serving engine's), each on its own device:
``copy_to_model`` puts a tensor on every shard's device and
``reduce_from_model`` sums the shards' partials on the first.
``moe_all_to_all`` (:67) exchanges an expert group's token blocks with
``all_to_all_single`` (its backward the same exchange); no path calls it,
as none does in JAX: the expert axis's MoE shares its rows over the line
and sums its output (``parallel/expert.py``). The data axis's reduction of the gradients is
``all_reduce_mean`` (``psum`` over the gang, divided by its size), packed
into flat f32 buckets so a step makes a few calls instead of one a tensor;
``all_reduce_sum`` is the same sum without the division (the pipeline's
f32 accumulators over the data × fsdp ranks).

The ``stage`` axis's hand-off is ``ProcessRing.exchange`` over the stage
line: each tick of the 1F1B schedule sends its activation to the next
stage and its gradient to the previous one, both rings whole (JAX's two
``ppermute`` rings, ``pipeline.py:336-341``, wrap-arounds included), on
every tick, bubbles too, so no rank of the line waits on one that skipped.
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
    """Collective works in flight: ``wait()`` returns once each has run and,
    for CUDA tensors, has made the current stream wait for its copies."""

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
    """One shard of the context ring per process of ``group`` (its rank r at
    ring position r)."""

    def __init__(self, group=None):
        self.group = group if group is not None else dist.group.WORLD
        self.n = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.positions = (self.rank,)

    def split(self, x: torch.Tensor, dim: int) -> list[torch.Tensor]:
        return [x]

    def join(self, xs: list[torch.Tensor], dim: int) -> torch.Tensor:
        return xs[0]

    def _p2p(self, src, dst, to_right: bool = True):
        """Each ``src`` buffer to the neighbour on one side, each ``dst``
        (contiguous) from the other's, in flight until ``wait()``."""
        step = 1 if to_right else -1
        works = []
        for s, d in zip(src, dst):
            sends, recvs = [0] * self.n, [0] * self.n
            sends[(self.rank + step) % self.n] = recvs[(self.rank - step) % self.n] = s.numel()
            works.append(dist.all_to_all_single(d.view(-1), s.reshape(-1), output_split_sizes=recvs,
                                                input_split_sizes=sends, group=self.group, async_op=True))
        return _Works(works)

    def exchange(self, right: torch.Tensor, left: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One pipeline tick's hand-off: ``right`` to rank + 1 and ``left``
        to rank - 1 (mod n), both in flight at once; returns (rank - 1's
        ``right``, rank + 1's ``left``), ordered on the current stream."""
        got_right, got_left = torch.empty_like(right), torch.empty_like(left)
        works = [self._p2p([right.contiguous()], [got_right]),
                 self._p2p([left.contiguous()], [got_left], to_right=False)]
        for w in works:
            w.wait()
        return got_right, got_left

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
        """The ranks' shards concatenated along ``dim`` in ring order (no
        gradient: the segment ids' table)."""
        return _gather(xs[0], self.group, dim)

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


def _dim_first(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.movedim(dim, 0).contiguous()


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    xt = _dim_first(x, dim)
    out = torch.empty((n * xt.shape[0], *xt.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def _scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    _check_split(x, dim, n)
    xt = _dim_first(x, dim).float()
    out = torch.empty((xt.shape[0] // n, *xt.shape[1:]), dtype=torch.float32, device=x.device)
    dist.reduce_scatter_tensor(out, xt, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).to(x.dtype).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.group, ctx.dim), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _psum_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return _Psum.apply(g, ctx.group), None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (tiled,
    as JAX's ``all_gather(tiled=True)``); the gradient is reduce-scattered."""
    return _AllGather.apply(x, group, dim)


def psum_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Block r (of the group's size, along ``dim``) of the ranks' sum, on
    rank r; the gradient is all-gathered."""
    return _PsumScatter.apply(x, group, dim)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, on every rank."""
    return _Psum.apply(x, group)


def _psum_f32(x: torch.Tensor, group) -> torch.Tensor:
    out = x.float().clone()
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum_f32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _psum_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself forward; the backward sums its gradient over the model
    line (the input of a column-parallel product, whose ranks each
    differentiate their own columns). ``group`` None: the identity."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' ``x`` over the model line forward (a
    row-parallel product's partials); the gradient passes through as it
    is. ``group`` None: the identity."""
    return x if group is None else _ReduceFromModel.apply(x, group)


class _MoEAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def moe_all_to_all(tokens: torch.Tensor, group) -> torch.Tensor:
    """Expert-dispatch all-to-all: ``tokens`` [n·c, ...] grouped by target
    rank (block j of dim 0 for rank j of ``group``) → block i of the result
    is rank i's block for this rank (JAX's ``all_to_all(split 0, concat
    0)``). The backward sends each gradient block back the same way."""
    _check_split(tokens, 0, dist.get_world_size(group))
    return _MoEAllToAll.apply(tokens, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over the group's ranks (no gradient)."""
    out = x.detach().float().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


class DeviceModel:
    """All ``n`` shards of the model axis in this process, shard s on
    ``devices[s]`` (a device may repeat: shards then share it). The first
    device is home: the residual stream, the norms' outputs and the joined
    logits live there."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.n = len(self.devices)
        if self.n < 1:
            raise ValueError("a model axis needs at least one shard")

    def copy_to_model(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x`` on every shard's device (itself where it is already there)."""
        return [x.to(d) for d in self.devices]

    def reduce_from_model(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The shards' partials summed in f32 on the home device, in shard
        order, in their dtype (one shard: its partial itself)."""
        if len(parts) == 1:
            return parts[0]
        home = self.devices[0]
        out = parts[0].to(home, torch.float32)
        for p in parts[1:]:
            out = out + p.to(home, torch.float32)
        return out.to(parts[0].dtype)

    def join(self, parts: list[torch.Tensor], dim: int = -1) -> torch.Tensor:
        """The shards' blocks concatenated along ``dim`` on the home device
        (the vocab-parallel head's logits, whole)."""
        return torch.cat([p.to(self.devices[0]) for p in parts], dim) if len(parts) > 1 else parts[0]


def ring_all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``psum`` as a reduce-scatter then an all-gather along dim 0 (a plain
    ``psum`` when dim 0 does not split over the group)."""
    if x.shape[0] % dist.get_world_size(group):
        return psum(x, group)
    return all_gather(psum_scatter(x, group), group)


#: elements of one flat f32 bucket of ``all_reduce_mean`` (64 MiB)
BUCKET_NUMEL = 16 << 20


def all_reduce_mean(tensors: list[torch.Tensor], group=None, scale: torch.Tensor | None = None) -> None:
    """Replace each tensor, in place, by its mean over the ``group``'s ranks.

    The tensors are packed in order into flat f32 buckets of at most
    ``BUCKET_NUMEL`` elements (a larger tensor is a bucket of its own), one
    collective a bucket; the mean is written back in each tensor's dtype.
    ``scale`` (a 0-dim f32 tensor, this rank's own) multiplies the bucket
    before the collective: the mean of the ranks' scaled tensors.
    nccl averages in the collective; gloo has no AVG, so it sums and
    divides by the world size. Call it from the thread that runs the step:
    collectives of one group must be issued in the same order on every
    rank."""
    _bucketed(tensors, group, scale, mean=True)


def all_reduce_sum(tensors: list[torch.Tensor], group=None) -> None:
    """Replace each tensor, in place, by its sum over the ``group``'s ranks
    (``all_reduce_mean``'s f32 buckets, without the division)."""
    _bucketed(tensors, group, None, mean=False)


def _bucketed(tensors: list[torch.Tensor], group, scale: torch.Tensor | None, mean: bool) -> None:
    world = dist.get_world_size(group)
    nccl = dist.get_backend(group) == dist.Backend.NCCL
    bucket: list[torch.Tensor] = []
    filled = 0
    for t in [*tensors, None]:
        if bucket and (t is None or filled + t.numel() > BUCKET_NUMEL):
            flat = torch.cat([b.reshape(-1).float() for b in bucket])
            if scale is not None:
                flat *= scale
            if mean and nccl:
                dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=group)
            else:
                dist.all_reduce(flat, group=group)
                if mean:
                    flat /= world
            for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                b.copy_(part.view_as(b))
            bucket, filled = [], 0
        if t is not None:
            bucket.append(t)
            filled += t.numel()
