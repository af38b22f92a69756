"""Pipeline parallelism over the RRDB trunk (counterpart of
``srganfd_tpu/parallel/pipeline.py``).

The ``pipe`` axis of a mesh (``parallel/mesh.py``) stages the trunk's
depth. With S ranks on the axis and B blocks, rank ``p`` owns blocks
``[p * L, (p + 1) * L)``, ``L = ceil(B / S)``; the slots past B
(:func:`pad_stages`) are skipped, so any (B, S) works (the flagship's
B = 23 is prime). Every rank holds the whole generator, as the JAX
Trainer keeps the Flax tree whole: the convs around the trunk run on
every rank of the axis alike, and only the trunk's blocks are divided.

GPipe over ``T = M + S - 1`` ticks, as the JAX ``lax.scan``: at tick ``t``
stage 0 takes microbatch ``t``, every rank runs its blocks on what it
holds, :func:`comm.ppermute` passes the result one stage on, and stage
``S - 1`` keeps microbatch ``t - (S - 1)``; a psum over the axis gives
every rank the assembled output. A rank skips the blocks of a tick in
which it holds no microbatch (what it passes on then is never read) but
takes part in every collective of that tick.

The backward is autograd through the differentiable collectives, as JAX's
``jax.grad`` transposes the scan: the ``ppermute`` ring runs backwards,
each block's backward is the port's ``rdb_apply`` backward
(``ops/cuda/rdb.py``: autograd through the recomputed plain version), and
each block's gradient lands on its owner rank alone. The trunk's input is
marked :func:`comm.replicated` and its output's cotangent divided by S,
the transposes JAX takes at the ``shard_map`` boundary for a value the
axis does not shard: every rank of the axis then holds the whole
gradient of the convs around the trunk, and the owner of each block that
block's. A trainer sums the trunk's gradients over the axis
(``train/loop.py``). So that every rank's backward runs the same
collectives, each tick's received activation and each rank's output take
part in its graph (through a select where the rank does not read them).

Each stage's RRDBs run their forward on the hand-written RDB kernel on a
CUDA tensor (``csrc/rdb.cu``), the plain version on a CPU one.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
from torch import nn

from srganfd_tpu_torch.parallel import comm

__all__ = [
    "pad_stages",
    "pipelined_trunk_apply",
    "split_trunk_params",
    "pipelined_generator_apply",
    "pipelined_full_apply",
]

Block = Callable[[nn.Module, torch.Tensor], torch.Tensor]


def _apply_block(block: nn.Module, h: torch.Tensor) -> torch.Tensor:
    return block(h)


def split_trunk_params(model: nn.Module) -> tuple[list[nn.Parameter], list[nn.Module]]:
    """(the parameters outside the trunk, the trunk's blocks in order) of a
    generator built with ``scan_blocks=True``, the layout the JAX function
    asks for; any other raises its ValueError."""
    if not getattr(model, "scan_blocks", False):
        raise ValueError(
            "pipeline parallelism needs the scanned trunk layout "
            "(create the model with scan_blocks=True, or convert with "
            "models.blocks.stack_trunk_params)"
        )
    blocks = list(model.trunk)
    in_trunk = {id(p) for b in blocks for p in b.parameters()}
    return [p for p in model.parameters() if id(p) not in in_trunk], blocks


def pad_stages(blocks: list[nn.Module], n_stages: int) -> tuple[list[nn.Module | None], torch.Tensor]:
    """The blocks padded with None up to a multiple of ``n_stages``, and the
    mask of the real ones (the JAX ``pad_stages``' zeros and mask): a
    padded slot is skipped, so the padded trunk is the trunk."""
    total = math.ceil(len(blocks) / n_stages) * n_stages
    padded = list(blocks) + [None] * (total - len(blocks))
    return padded, torch.arange(total) < len(blocks)


class _SplitCotangent(torch.autograd.Function):
    """The identity, whose backward divides the cotangent by ``n``: the
    transpose ``shard_map`` takes of an output its ``n`` ranks hold alike,
    before the psum's transpose sums the ranks' cotangents."""

    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def pipelined_trunk_apply(
    block_apply: Block,
    stacked: list[nn.Module | None],
    mask: torch.Tensor,
    x: torch.Tensor,
    mesh: Any,
    *,
    axis: str = "pipe",
    microbatches: int | None = None,
) -> torch.Tensor:
    """Run ``block_apply(block, h)`` over the padded blocks as an S-stage
    pipeline on the mesh's ``axis``. ``stacked``/``mask``: from
    :func:`pad_stages` (every rank passes the whole list; rank ``p`` runs
    its slice); ``x``: this rank's trunk input (N, C, H, W), alike on the
    axis's ranks; ``microbatches``: M, which must divide N (default: the
    stage count). On a ``(data, pipe)`` mesh each data row runs its own
    ring on its own shard. Returns the trunk's output on every rank."""
    group, n_stages, p = mesh.group(axis), mesh.size(axis), mesh.index(axis)
    m = microbatches or n_stages
    n = x.shape[0]
    if n % m:
        raise ValueError(f"batch {n} not divisible by microbatches {m}")
    per_stage = len(stacked) // n_stages
    mine = [b for b, keep in zip(stacked[p * per_stage:(p + 1) * per_stage],
                                 mask[p * per_stage:(p + 1) * per_stage].tolist()) if keep]
    if torch.is_grad_enabled() and not x.requires_grad and any(
            q.requires_grad for b in stacked if b is not None for q in b.parameters()):
        # every rank must record the same graph: the ticks' activations are
        # made to hang off x on each of them (the parameters are alike)
        x = x.detach().requires_grad_()
    xs = comm.replicated(x, group).split(n // m)
    ticks = m + n_stages - 1
    always = torch.ones((), dtype=torch.bool, device=x.device)
    last = always if p == n_stages - 1 else ~always
    carry = xs[0] * 0  # what a rank holds before its first microbatch
    outs = []
    for t in range(ticks):
        h = torch.where(always, xs[t], carry) if p == 0 and t < m else carry
        y = h
        if 0 <= t - p < m:  # this stage holds microbatch t - p
            for b in mine:
                y = block_apply(b, y).to(h.dtype)
        if t >= n_stages - 1:  # stage S-1 finished microbatch t - (S-1)
            outs.append(torch.where(last, y, 0.0))
        if t + 1 < ticks:  # the rotation after the last tick is never read (JAX runs it)
            carry = comm.ppermute(y, 1, group)
    out = comm.all_reduce_sum_grad(torch.cat(outs), group)
    return out if n_stages == 1 else _SplitCotangent.apply(out, n_stages)


def pipelined_full_apply(
    model: nn.Module,
    mesh: Any,
    *,
    axis: str = "pipe",
    microbatches: int | None = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``apply(x) -> sr``: the generator's forward with its trunk pipelined
    over the mesh's ``axis``, the parameters left where the module holds
    them (the form the Trainer uses)."""
    _, blocks = split_trunk_params(model)
    padded, mask = pad_stages(blocks, mesh.size(axis))

    def trunk_fn(out1: torch.Tensor) -> torch.Tensor:
        return pipelined_trunk_apply(_apply_block, padded, mask, out1, mesh, axis=axis, microbatches=microbatches)

    return lambda x: model(x, trunk_fn=trunk_fn)


def pipelined_generator_apply(
    model: nn.Module,
    mesh: Any,
    *,
    axis: str = "pipe",
    microbatches: int | None = None,
) -> tuple[Callable[[torch.Tensor], torch.Tensor], list[nn.Parameter], list[nn.Module | None], torch.Tensor]:
    """``(apply_fn, nontrunk_params, padded_blocks, mask)``: the pipelined
    forward of :func:`pipelined_full_apply` with the split it runs on, so
    that a caller reads each stage's gradients from its own blocks
    (``padded_blocks[p * L:(p + 1) * L]`` on rank ``p``) and the replicated
    convs' from ``nontrunk_params``."""
    nontrunk, blocks = split_trunk_params(model)
    padded, mask = pad_stages(blocks, mesh.size(axis))
    return pipelined_full_apply(model, mesh, axis=axis, microbatches=microbatches), nontrunk, padded, mask
