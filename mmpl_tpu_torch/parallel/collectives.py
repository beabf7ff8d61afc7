"""The group moves of sequence parallelism, on two substrates.

The attention code (`ops/attention.ring_flash_attention`,
`parallel/sequence_parallel.py`) is written once against a small group
interface: `size`, `rotate` (the ring's send-to-next, receive-from-
previous) and `all_to_all` over a dim.  Two implementations provide it:

  * `DistGroup` runs on a `torch.distributed` process group (NCCL on
    cards, gloo on the CPU); each rank holds its own shard.  It also
    makes the moves of the sharded model's tensor and data parallelism:
    Megatron's *f* and *g* (`copy_to`: identity forward, the gradient
    summed; `all_reduce`: the sum forward, the gradient passed through),
    `all_reduce_shared` (a sum that every rank uses for its own slice,
    its gradient summed too), `all_reduce_max` (no gradient), `all_gather`,
    and `send` / `recv` between stages;
  * `LocalGroup` holds every rank's shard on one device, stacked along the
    batch dim in rank order, and makes the same moves as tensor ops.  It is
    the port's counterpart of the JAX tests' virtual CPU mesh and how the
    sequence-parallel path runs on one card: a K1 call then covers every
    rank's shard at once.

The one-card transport: NCCL takes no two ranks on one card, so ranks
sharing a card run over gloo, and gloo takes CUDA tensors for its
collectives but not for point-to-point moves (`GLOO_HOST_MOVES`).  Under
a gloo group those moves carry a CUDA tensor through host memory; under
NCCL every move stays on the device.
A move that fails raises: nothing falls back.

A mesh bundles named groups: `LocalMesh` (in process) or `ProcessMesh`
(around a `torch.distributed.device_mesh.DeviceMesh`).  `as_mesh` wraps a
DeviceMesh and never substitutes the in-process mesh for it.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist


#: the moves for which gloo takes no CUDA tensor: under a gloo group they
#: carry a CUDA tensor through host memory (the one-card transport).  On
#: the card's torch 2.11 gloo's collectives (all_reduce, all_gather,
#: all_to_all, broadcast, reduce_scatter) take CUDA tensors and its
#: point-to-point moves do not: a CUDA isend aborts the process
#: ("writev: Bad address") instead of raising
GLOO_HOST_MOVES = frozenset({"send", "recv", "rotate"})


def via_host(pg, move: str, x: torch.Tensor) -> bool:
    """Whether `move` of x runs on a host copy: x on a card and `pg`
    (None: the default group) a gloo group that takes no CUDA tensor for
    that move."""
    return (x.is_cuda and move in GLOO_HOST_MOVES
            and dist.get_backend(pg) == "gloo")


def _sum_(t: torch.Tensor, pg, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """all_reduce of t in place (SUM or MAX over the group)."""
    dist.all_reduce(t, op=op, group=pg)
    return t


def _p2p_rotate(x: torch.Tensor, pg, send_to: int,
                recv_from: int) -> torch.Tensor:
    host = via_host(pg, "rotate", x)
    src = x.contiguous().cpu() if host else x.contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, send_to, pg),
           dist.P2POp(dist.irecv, out, recv_from, pg)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device) if host else out


class _Rotate(torch.autograd.Function):
    """Send to the next rank, receive from the previous; the gradient
    travels the other way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _p2p_rotate(x, group.pg, group.next, group.prev)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        return _p2p_rotate(g, group.pg, group.prev, group.next), None


class _AllToAll(torch.autograd.Function):
    """all_to_all_single over dim 0 ([size, ...]); its own inverse moves
    the gradient back."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=pg)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.pg)
        return out, None


class _AllGather(torch.autograd.Function):
    """Every rank's x concatenated along dim.  The backward takes every
    rank's loss to be the same function of the gathered tensor (SPMD), so
    this rank's x gets its own slice of the gradient."""

    @staticmethod
    def forward(ctx, x, pg, size, rank, dim):
        ctx.size, ctx.rank, ctx.dim = size, rank, dim
        outs = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(outs, x.contiguous(), group=pg)
        return torch.cat(outs, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, ctx.dim)[ctx.rank], None, None, None, None


class _AllReduce(torch.autograd.Function):
    """The sum over the group; the backward passes the gradient through
    (every rank's loss the same function of the sum, as `_AllGather`):
    Megatron's *g*, after a row-parallel projection."""

    @staticmethod
    def forward(ctx, x, pg):
        return _sum_(x.clone(), pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceShared(torch.autograd.Function):
    """The sum over the group, used by every rank for its own slice (the
    QK-norms' sum of squares over the heads of every rank): each rank's
    loss depends on the sum through its own slice only, so the gradient is
    summed over the group too."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return _sum_(x.clone(), pg)

    @staticmethod
    def backward(ctx, g):
        return _sum_(g.clone(), ctx.pg), None


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient summed over the group: Megatron's
    *f*, the replicated input of a column-parallel projection, whose
    ranks each take the gradient of their own output columns."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_(g.clone(), ctx.pg), None


class DistGroup:
    """A process group's moves; tensors are this rank's shard.  Every float
    move is differentiable (the dense ring and Ulysses train through them,
    and so does tensor parallelism)."""

    def __init__(self, pg=None):
        self.pg = pg
        self.size = dist.get_world_size(pg)
        self.rank = dist.get_rank(pg)
        ranks = dist.get_process_group_ranks(
            pg if pg is not None else dist.group.WORLD)
        self.next = ranks[(self.rank + 1) % self.size]
        self.prev = ranks[(self.rank - 1) % self.size]

    def rotate(self, x: torch.Tensor) -> torch.Tensor:
        """Send x to the next rank, return the previous rank's."""
        return x if self.size == 1 else _Rotate.apply(x, self)

    def all_to_all(self, x: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """Chunk r of x along split_dim goes to rank r; the chunks received
        are concatenated along concat_dim in rank order."""
        if self.size == 1:
            return x
        out = _AllToAll.apply(torch.stack(x.chunk(self.size, split_dim)),
                              self.pg)
        return torch.cat(out.unbind(0), dim=concat_dim)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group, the gradient passed through; an int32
        tensor (the int8 products' accumulators) sums exactly."""
        if not x.is_floating_point():
            return _sum_(x.clone(), self.pg)
        return _AllReduce.apply(x, self.pg)

    def all_reduce_shared(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group, the gradient summed too."""
        return _AllReduceShared.apply(x, self.pg)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the group (no gradient): the
        per-token amax of an int8 code whose row is split over ranks."""
        return _sum_(x.detach().clone(), self.pg, dist.ReduceOp.MAX)

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """x itself, its gradient summed over the group."""
        return _CopyTo.apply(x, self.pg)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _AllGather.apply(x, self.pg, self.size, self.rank, dim)

    def send(self, x: torch.Tensor, dst: int):
        """Send x to global rank `dst` without blocking; returns the
        request (`wait()`).  A CUDA x under gloo is copied to the host
        first, which waits for the work that makes x."""
        src = x.detach().contiguous()
        if via_host(self.pg, "send", src):
            src = src.cpu()
        return dist.isend(src, dst, group=self.pg)

    def recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        """A tensor of `like`'s shape, dtype and device from global rank
        `src`; blocks until it has arrived (on a card under NCCL, the
        current stream waits for it instead)."""
        host = via_host(self.pg, "recv", like)
        out = torch.empty_like(like, device="cpu" if host else like.device)
        dist.irecv(out, src, group=self.pg).wait()
        return out.to(like.device) if host else out


class LocalGroup:
    """One axis of an in-process mesh: x holds the shards of every rank of
    the mesh, [prod(mesh) * B, ...] with the mesh's first axis major."""

    def __init__(self, mesh_shape: Tuple[int, ...], axis: int):
        self.mesh_shape = tuple(mesh_shape)
        self.axis = axis
        self.size = self.mesh_shape[axis]

    def _view(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*self.mesh_shape, -1, *x.shape[1:])

    def rotate(self, x: torch.Tensor) -> torch.Tensor:
        return torch.roll(self._view(x), 1, self.axis).reshape(x.shape)

    def all_to_all(self, x: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        if split_dim == concat_dim or 0 in (split_dim, concat_dim):
            raise ValueError("all_to_all moves two distinct non-batch dims")
        M = len(self.mesh_shape)
        xv = self._view(x)
        p = M + split_dim
        # chunk index (the destination) beside the source axis, swapped
        t = xv.unflatten(p, (self.size, -1)).transpose(self.axis, p)
        # the source index (now at p) joins the concat dim, source major
        t = t.movedim(p, M + concat_dim).flatten(M + concat_dim,
                                                 M + concat_dim + 1)
        return t.reshape(-1, *t.shape[M + 1:])


class LocalMesh:
    """Named axes over in-process shards on one device (see module doc);
    its tensors live where the caller puts them."""

    def __init__(self, shape: Dict[str, int]):
        self.names = tuple(shape)
        self.sizes = tuple(int(s) for s in shape.values())
        self.ranks = math.prod(self.sizes)

    def size(self, name: str) -> int:
        return self.sizes[self.names.index(name)]

    def get_group(self, name: str) -> LocalGroup:
        return LocalGroup(self.sizes, self.names.index(name))

    def shard(self, x: torch.Tensor, dim: int,
              axes: Sequence[str]) -> torch.Tensor:
        """Every rank's shard of the full x: `dim` split over `axes` (in
        mesh order, the first major), replicated over the other axes."""
        sizes = [self.size(a) for a in axes]
        t = x.unflatten(dim, (*sizes, -1)).movedim(
            list(range(dim, dim + len(axes))), list(range(len(axes))))
        for j, name in enumerate(self.names):
            if name not in axes:
                t = t.unsqueeze(j)
        M = len(self.sizes)
        t = t.expand(*self.sizes, *t.shape[M:])
        return t.reshape(-1, *t.shape[M + 1:])

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        return x.repeat(self.ranks, *([1] * (x.ndim - 1)))

    def gather(self, x: torch.Tensor, dim: int,
               axes: Sequence[str]) -> torch.Tensor:
        """The full tensor from the shards of `shard(..., dim, axes)`."""
        M = len(self.sizes)
        t = x.reshape(*self.sizes, -1, *x.shape[1:])
        for i in reversed(range(M)):
            if self.names[i] not in axes:
                t = t.select(i, 0)
        k = len(axes)
        # [*axes, B, ...] -> [B, ..., *axes, L_local, ...], axes major
        t = t.movedim(list(range(k)), list(range(dim, dim + k)))
        return t.flatten(dim, dim + k)


class ProcessMesh:
    """The same interface around a `DeviceMesh`; tensors are this rank's."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.names = tuple(device_mesh.mesh_dim_names)
        self.sizes = tuple(device_mesh.mesh.shape)

    def size(self, name: str) -> int:
        return self.sizes[self.names.index(name)]

    def get_group(self, name: str) -> DistGroup:
        return DistGroup(self.device_mesh.get_group(name))

    def coordinate(self, name: str) -> int:
        return self.device_mesh.get_local_rank(name)

    def shard(self, x: torch.Tensor, dim: int,
              axes: Sequence[str]) -> torch.Tensor:
        idx = 0
        for a in axes:
            idx = idx * self.size(a) + self.coordinate(a)
        n = x.shape[dim] // math.prod(self.size(a) for a in axes)
        return x.narrow(dim, idx * n, n)

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def gather(self, x: torch.Tensor, dim: int,
               axes: Sequence[str]) -> torch.Tensor:
        for a in reversed(list(axes)):
            x = self.get_group(a).all_gather(x, dim)
        return x


def as_mesh(mesh):
    """A `LocalMesh` or `ProcessMesh` as it is; a `DeviceMesh` wrapped in a
    `ProcessMesh` (its process groups, never the in-process substitute)."""
    if isinstance(mesh, (LocalMesh, ProcessMesh)):
        return mesh
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(mesh, DeviceMesh):
        return ProcessMesh(mesh)
    raise TypeError(f"not a mesh: {type(mesh).__name__}")
