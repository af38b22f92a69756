"""The port's collectives: the one module that moves tensors between ranks.

The JAX package never writes a collective by hand: XLA inserts them from
shardings, and ``shard_map`` bodies call ``jax.lax.ppermute``,
``all_gather``, ``all_to_all`` and ``psum`` over a mesh axis. Here they
are ``torch.distributed`` calls, one process per rank, over a ``group``:
the process group of one mesh axis line (``parallel/mesh.py`` ``Mesh.group``),
or the default group, every rank, when none is given:

- :func:`ppermute` (``jax.lax.ppermute`` on a ring shift, through
  ``dist.batch_isend_irecv``), :func:`all_gather` and :func:`all_to_all`
  (the ``tiled=True`` forms) and :func:`all_reduce_sum_grad` (``psum``)
  are differentiable, each backward the transpose JAX takes:
  ``ppermute(g, -shift)``; this rank's block of the cotangent summed over
  the group (a reduce-scatter); ``all_to_all(g, concat, split)``; the
  cotangent all-reduced. :func:`replicated` is the identity whose
  backward sums the cotangent over the group: the transpose of a value
  every rank of an axis holds alike (a ``shard_map`` input that the axis
  does not shard);
- :func:`all_reduce` and :func:`broadcast` carry no gradient.

Autograd runs the backward collectives in each rank's own graph order.
Every rank of a group must therefore build the same graph of collectives
and hand each of them a cotangent: a collective whose output a rank leaves
unused is skipped by that rank's backward while its peers wait for it.

With no process group (a world of one), or a group of one rank, every
function is the identity, or its one-rank result, and launches nothing.

NCCL carries CUDA tensors and gloo CPU ones. gloo also carries the
collectives of CUDA tensors (all-reduce, broadcast, all-gather and
all-to-all, each tried with its values checked on an H100 by
``chip_smoke.py``'s ``serve_spatial_phase``), but its point-to-point
transport reads host memory: :func:`ppermute` copies a CUDA tensor to the
host under gloo, sends it there and copies the result back, in the forward
and in the backward. :data:`staged` counts those calls. Nothing falls back
from NCCL to gloo: the backend is the group's, chosen when it was made
(``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

__all__ = [
    "staged", "SELF", "world", "rank", "backend", "data_rank", "data_world", "set_data_axis", "ppermute", "all_gather", "all_to_all",
    "all_reduce", "all_reduce_sum_grad", "replicated", "broadcast", "barrier",
]

staged = 0  # ppermute calls whose CUDA tensor gloo sent through host memory; reset by assigning 0

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}

Group = Any  # a torch.distributed ProcessGroup, SELF, or None for the default group
SELF = "self"  # the group of this rank alone (a mesh axis of length 1): every collective is the identity

_data_axis: tuple[int, int] | None = None  # (index, size) on the last mesh's data axis


def _up() -> bool:
    return dist.is_available() and dist.is_initialized()


def world(group: Group = None) -> int:
    """Ranks in ``group`` (the default group when None), 1 without one."""
    return 1 if group is SELF or not _up() else dist.get_world_size(group)


def rank(group: Group = None) -> int:
    """This process's rank in ``group`` (the default group when None), 0
    without one."""
    return 0 if group is SELF or not _up() else dist.get_rank(group)


def set_data_axis(index: int, size: int) -> None:
    """Record this rank's place on the ``data`` axis of the mesh just made
    (``parallel/mesh.py`` ``make_mesh``): the shard of the data it reads."""
    global _data_axis
    _data_axis = (index, size)


def data_rank() -> int:
    """This rank's index on the data axis: its shard of the files and the
    key of its degradation draws. Without a mesh every rank is its own
    data row: :func:`rank`."""
    return rank() if _data_axis is None else _data_axis[0]


def data_world() -> int:
    """The data axis's length: :func:`world` without a mesh."""
    return world() if _data_axis is None else _data_axis[1]


def backend() -> str | None:
    """The default group's backend (``"nccl"`` or ``"gloo"``), None without one."""
    return dist.get_backend() if _up() else None


def _global(group: Group, r: int) -> int:
    """The default group's rank of ``group``'s rank ``r``."""
    return r if group is None else dist.get_global_rank(group, r)


def _ppermute(t: torch.Tensor, shift: int, group: Group) -> torch.Tensor:
    global staged
    n = world(group)
    if n == 1 or shift % n == 0:
        return t.clone()
    host = t.is_cuda and backend() == "gloo"
    x = (t.cpu() if host else t).contiguous()
    out = torch.empty_like(x)
    r = rank(group)
    ops = [dist.P2POp(dist.isend, x, _global(group, (r + shift) % n), group=group),
           dist.P2POp(dist.irecv, out, _global(group, (r - shift) % n), group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if host:
        staged += 1
        return out.to(t.device)
    return out


def _all_gather(t: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    x = t.contiguous()
    parts = [torch.empty_like(x) for _ in range(world(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _all_to_all(t: torch.Tensor, split_dim: int, concat_dim: int, group: Group) -> torch.Tensor:
    n = world(group)
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} does not split into {n} ranks")
    send = torch.stack(t.chunk(n, split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), concat_dim)


def _sum(t: torch.Tensor, group: Group) -> torch.Tensor:
    x = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, shift, group):
        ctx.shift, ctx.group = shift, group
        return _ppermute(t, shift, group)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, -ctx.shift, ctx.group), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        block = _sum(g, ctx.group).chunk(world(ctx.group), ctx.dim)[rank(ctx.group)]
        return block.contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(t, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, concat_dim, split_dim, ctx.group), None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def ppermute(t: torch.Tensor, shift: int, group: Group = None) -> torch.Tensor:
    """Every rank of ``group`` sends ``t`` to its rank ``(r + shift) % n``
    and returns what its rank ``(r - shift) % n`` sent: ``jax.lax.ppermute``
    over the permutation ``[(i, (i + shift) % n)]``. Differentiable: the
    cotangent travels back by ``-shift``. gloo's point-to-point transport
    reads host memory, so a CUDA tensor is staged through it under gloo."""
    return _PPermute.apply(t, shift, group)


def all_gather(t: torch.Tensor, dim: int = 0, group: Group = None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order
    (``jax.lax.all_gather(tiled=True)``). Differentiable: each rank gets its
    own block of the cotangent summed over the group."""
    if world(group) == 1:
        return t.clone()
    return _AllGather.apply(t, dim, group)


def all_to_all(t: torch.Tensor, split_dim: int, concat_dim: int, group: Group = None) -> torch.Tensor:
    """``jax.lax.all_to_all(split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)``: ``t`` split into ``n`` equal blocks along ``split_dim``,
    block ``j`` sent to rank ``j``; the blocks received from ranks 0..n-1
    concatenated along ``concat_dim``. Differentiable: the cotangent goes
    back by ``all_to_all(g, concat_dim, split_dim)``."""
    if world(group) == 1:
        return t.clone()
    return _AllToAll.apply(t, split_dim, concat_dim, group)


def all_reduce(t: torch.Tensor, op: str = "sum", group: Group = None) -> torch.Tensor:
    """A new tensor: ``t`` reduced over ``group`` by ``op`` (``"sum"``,
    ``"max"`` or ``"min"``); no gradient flows through it."""
    if world(group) == 1:
        return t.clone()

    x = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=_REDUCE_OPS[op], group=group)
    return x


def all_reduce_sum_grad(t: torch.Tensor, group: Group = None) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (``jax.lax.psum``), differentiable:
    the cotangent of the sum is all-reduced back to every rank's ``t``, so a
    loss that each rank differentiates on its own shard gets the gradient
    of the sum of all ranks' losses through it (BatchNorm's statistics and
    the relativistic means under data parallelism)."""
    if world(group) == 1:
        return t
    return _AllReduceSum.apply(t, group)


def replicated(t: torch.Tensor, group: Group = None) -> torch.Tensor:
    """``t``, which every rank of ``group`` holds alike, as the identity
    whose backward sums the ranks' cotangents: each rank then holds the
    gradient of everything the group computed from ``t``, as JAX transposes
    a ``shard_map`` input that the axis does not shard."""
    if world(group) == 1:
        return t
    return _Replicated.apply(t, group)


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (a new tensor on the others;
    ``t`` must have the shape and dtype of ``src``'s)."""
    if world() == 1:
        return t

    x = t.contiguous()
    dist.broadcast(x, src)
    return x


def barrier() -> None:
    """Every rank waits here for the others (a no-op in a world of one)."""
    if world() > 1:
        dist.barrier()
