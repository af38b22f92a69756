"""The port's collectives: the one module that moves tensors between ranks.

The JAX package never writes a collective by hand: XLA inserts them from
shardings, and ``shard_map`` bodies call ``jax.lax.ppermute``,
``all_gather`` and ``all_to_all``. Here they are ``torch.distributed``
calls over the default process group, one process per rank:

- :func:`ppermute` (``jax.lax.ppermute`` on a ring shift, through
  ``dist.batch_isend_irecv``), :func:`all_gather` and :func:`all_to_all`
  (the ``tiled=True`` forms), :func:`all_reduce` and :func:`broadcast`;
- :func:`all_reduce_sum_grad`, the differentiable all-reduce of
  ``torch.distributed.nn.functional`` (its backward all-reduces the
  cotangent), for sums that autograd must follow across ranks: BatchNorm's
  batch statistics and the relativistic losses' means under data
  parallelism.

With no process group (a world of one) every function is the identity, or
its one-rank result, and launches nothing.

NCCL carries CUDA tensors and gloo CPU ones. gloo also carries the
collectives of CUDA tensors (all-reduce, broadcast, all-gather and
all-to-all, each tried with its values checked on an H100 by
``chip_smoke.py``'s ``serve_spatial_phase``), but its point-to-point
transport reads host memory: :func:`ppermute` copies a CUDA tensor to the
host under gloo, sends it there and copies the result back. :data:`staged`
counts those calls. Nothing falls back from NCCL to gloo: the backend is
the group's, chosen when it was made (``parallel/mesh.py``).
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

__all__ = [
    "staged", "world", "rank", "backend", "ppermute", "all_gather", "all_to_all",
    "all_reduce", "all_reduce_sum_grad", "broadcast", "barrier", "forward_only",
]

staged = 0  # ppermute calls whose CUDA tensor gloo sent through host memory; reset by assigning 0

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def world() -> int:
    """Ranks in the default group, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group, 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def backend() -> str | None:
    """The default group's backend (``"nccl"`` or ``"gloo"``), None without one."""
    return dist.get_backend() if dist.is_available() and dist.is_initialized() else None


def ppermute(t: torch.Tensor, shift: int) -> torch.Tensor:
    """Every rank sends ``t`` to rank ``(r + shift) % n`` and returns what
    rank ``(r - shift) % n`` sent: ``jax.lax.ppermute`` over the
    permutation ``[(i, (i + shift) % n)]``. gloo's point-to-point transport
    reads host memory, so a CUDA tensor is staged through it under gloo."""
    global staged
    n = world()
    if n == 1 or shift % n == 0:
        return t.clone()
    host = t.is_cuda and backend() == "gloo"
    x = (t.cpu() if host else t).contiguous()
    out = torch.empty_like(x)
    r = rank()
    ops = [dist.P2POp(dist.isend, x, (r + shift) % n), dist.P2POp(dist.irecv, out, (r - shift) % n)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if host:
        staged += 1
        return out.to(t.device)
    return out


def all_gather(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order
    (``jax.lax.all_gather(tiled=True)``)."""
    n = world()
    if n == 1:
        return t.clone()

    x = t.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim)


def all_to_all(t: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)``: ``t`` split into ``n`` equal blocks along ``split_dim``,
    block ``j`` sent to rank ``j``; the blocks received from ranks 0..n-1
    concatenated along ``concat_dim``."""
    n = world()
    if n == 1:
        return t.clone()
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} does not split into {n} ranks")

    send = torch.stack(t.chunk(n, split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    return torch.cat(recv.unbind(0), concat_dim)


def all_reduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``t`` reduced over the ranks by ``op`` (``"sum"``,
    ``"max"`` or ``"min"``); no gradient flows through it."""
    if world() == 1:
        return t.clone()

    x = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=_REDUCE_OPS[op])
    return x


def all_reduce_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable: the cotangent of
    the sum is all-reduced back to every rank's ``t``, so a loss that each
    rank differentiates on its own shard gets the gradient of the sum of
    all ranks' losses through it: ``torch.distributed.nn.functional``'s
    ``all_reduce``."""
    if world() == 1:
        return t
    from torch.distributed.nn import functional as dist_nn

    return dist_nn.all_reduce(t)


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


def forward_only(fn):
    """Run ``fn`` (a context-parallel attention) without a graph, and refuse
    a call that autograd would have to differentiate: gradients through
    ring and Ulysses attention are not ported."""

    @functools.wraps(fn)
    def run(*tensors, **kw):
        flat = [t for a in tensors for t in (a if isinstance(a, list) else [a])]
        if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in flat):
            raise NotImplementedError(
                f"gradients through {fn.__name__} are not ported to srganfd_tpu_torch yet: see ROADMAP.md A11"
            )
        with torch.no_grad():
            return fn(*tensors, **kw)

    return run
