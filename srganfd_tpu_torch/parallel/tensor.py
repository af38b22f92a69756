"""Tensor parallelism for the conv generators: channel-sharded weights
(counterpart of ``srganfd_tpu/parallel/tensor.py``).

The JAX function places each conv kernel and bias sharded on its
output-feature axis over a ``model`` mesh axis, and XLA's partitioner
computes each device's filter slice and inserts the all-gathers where the
next layer reads the whole feature axis. Here the same is written out on
the ranks of the mesh's ``model`` axis (``parallel/mesh.py``): each rank
keeps its slice of the output channels of every conv whose ``Cout`` the
axis divides, computes that slice, and an :func:`comm.all_gather` along
the channels over the axis's group joins the slices (column
parallelism). Every other parameter stays replicated: the 3-channel
output head, and the layers that are not convs.

A Residual Dense Block cannot be split conv by conv without leaving its
fused kernel (``csrc/rdb.cu``): it gathers its five convs' weight shards
once per forward, in one all-gather, and runs the kernel whole, as XLA
must gather a ``pallas_call`` operand it cannot partition. The forward
equals the replicated model's. Forward only, as in JAX; no CLI of either
package reaches it.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from srganfd_tpu_torch.models.blocks import ResidualDenseBlock
from srganfd_tpu_torch.parallel import comm

__all__ = ["channel_sharded_params"]


def _shard(conv: nn.Conv2d, n: int, r: int) -> None:
    """Keep rank ``r``'s block of ``n`` of the conv's output channels."""
    c = conv.out_channels // n
    with torch.no_grad():
        conv.weight = nn.Parameter(conv.weight[r * c:(r + 1) * c].clone())
        if conv.bias is not None:
            conv.bias = nn.Parameter(conv.bias[r * c:(r + 1) * c].clone())
    conv.out_channels = c


def _gatherer(rdb: ResidualDenseBlock, group: comm.Group, n: int):
    """The five whole HWIO kernels and biases of ``rdb``, from its convs'
    shards in one all-gather of their concatenation."""
    convs = rdb._convs()

    def gather() -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        mine = [t for c in convs for t in (c.weight, c.bias)]
        parts = comm.all_gather(torch.cat([t.reshape(-1) for t in mine]), 0, group).chunk(n)
        split = [part.split([t.numel() for t in mine]) for part in parts]
        whole = [torch.cat([s[i].view_as(t) for s in split]) for i, t in enumerate(mine)]
        return [w.permute(2, 3, 1, 0) for w in whole[0::2]], whole[1::2]

    return gather


def channel_sharded_params(model: nn.Module, mesh: Any, axis: str = "model") -> nn.Module:
    """Shard ``model`` (a generator or discriminator of the port, in place)
    over the mesh's ``axis``: each conv whose output channels the axis's
    size divides keeps this rank's slice of its kernel and bias, and its
    output is all-gathered along the channels after it (a forward hook); an
    RDB whose five convs all divide keeps their slices and gathers them
    into its kernel's weights. Returns ``model``."""
    group, n, r = mesh.group(axis), mesh.size(axis), mesh.index(axis)
    if n == 1:
        return model
    in_rdb = set()
    for m in model.modules():
        if isinstance(m, ResidualDenseBlock):
            convs = m._convs()
            in_rdb.update(id(c) for c in convs)
            if all(c.out_channels % n == 0 for c in convs):
                for c in convs:
                    _shard(c, n, r)
                m.gather_weights = _gatherer(m, group, n)
    for m in model.modules():
        if isinstance(m, nn.Conv2d) and id(m) not in in_rdb and m.out_channels % n == 0:
            _shard(m, n, r)
            m.register_forward_hook(
                lambda _m, _args, y: comm.all_gather(y, 1, group).contiguous(memory_format=torch.channels_last))
    return model
