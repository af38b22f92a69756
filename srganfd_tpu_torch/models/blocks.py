"""Building blocks of the RRDB generators (counterpart of
``srganfd_tpu/models/blocks.py``: ``lrelu``, ``Conv``,
``ResidualDenseBlock``, ``RRDB`` and the trunk).

Layout: the modules take and return NCHW tensors, kept in
``torch.channels_last`` memory format, so that ``x.permute(0, 2, 3, 1)``
is the contiguous NHWC tensor the RDB kernel takes, with no copy.

Parameters are f32, named as in the reference state dicts
(``trunk.{i}.rdb{j}.conv{k}``); the compute dtype is the input's, and each
conv casts its parameters to it at call time, like the JAX ``Conv`` with
``param_dtype=f32``. Initialisation is kaiming-normal x0.1 with zero
biases (``blocks.py:26-28`` of the JAX package), drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from srganfd_tpu_torch.ops.cuda.rdb import pack_rdb_weights, rdb_forward

__all__ = ["lrelu", "Conv", "ResidualDenseBlock", "RRDB", "make_trunk", "init_kaiming_x01"]


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class Conv(nn.Conv2d):
    """3x3/s1 'same' conv with f32 parameters cast to the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int) -> None:
        super().__init__(in_channels, out_channels, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), padding=1)


def init_kaiming_x01(module: nn.Module, generator: torch.Generator | None = None) -> None:
    """Kaiming-normal (gain sqrt(2), fan_in) x0.1 weights, zero biases, for
    every conv of ``module`` in registration order."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator, dtype=torch.float32)
                m.weight.copy_(w * (0.02 / fan_in) ** 0.5)
                m.bias.zero_()


class ResidualDenseBlock(nn.Module):
    """5-conv dense block, LeakyReLU(0.2), 0.2-scaled residual
    (ESRGAN/model.py:29-60), through ``ops/cuda/rdb.py`` ``rdb_forward``:
    the hand-written kernel on a CUDA tensor, the plain version on a CPU
    tensor; both take any H x W."""

    def __init__(self, channels: int, growth_channels: int) -> None:
        super().__init__()
        self.channels, self.growth_channels = channels, growth_channels
        for k in range(5):
            cout = growth_channels if k < 4 else channels
            setattr(self, f"conv{k + 1}", Conv(channels + k * growth_channels, cout))
        self._packed: tuple | None = None  # (key, packed weights, packed biases)

    def _convs(self) -> list[Conv]:
        return [getattr(self, f"conv{k + 1}") for k in range(5)]

    def kernels_biases(self) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """The five convs as HWIO kernels (views) and biases."""
        convs = self._convs()
        return [c.weight.permute(2, 3, 1, 0) for c in convs], [c.bias for c in convs]

    def packed(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """The kernel's packed weights for ``dtype``, rebuilt only when the
        dtype, the device or a parameter (its version counter, which
        ``load_state_dict`` and optimisers bump) changed."""
        params = [p for c in self._convs() for p in (c.weight, c.bias)]
        key = (dtype, params[0].device, tuple((p.data_ptr(), p._version) for p in params))
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, *pack_rdb_weights(*self.kernels_biases(), dtype))
        return self._packed[1], self._packed[2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        packed = self.packed(x.dtype) if x.is_cuda else None  # the CPU path takes HWIO
        y = rdb_forward(x.permute(0, 2, 3, 1).contiguous(), *self.kernels_biases(), packed=packed)
        return y.permute(0, 3, 1, 2)


class RRDB(nn.Module):
    """Residual-in-residual dense block: 3 RDBs + 0.2-scaled residual
    (ESRGAN/model.py:63-86)."""

    def __init__(self, channels: int, growth_channels: int) -> None:
        super().__init__()
        self.rdb1 = ResidualDenseBlock(channels, growth_channels)
        self.rdb2 = ResidualDenseBlock(channels, growth_channels)
        self.rdb3 = ResidualDenseBlock(channels, growth_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


def make_trunk(channels: int, growth_channels: int, num_blocks: int) -> nn.Sequential:
    """The RRDB trunk (``run_trunk`` in JAX, unrolled): ``trunk.{i}``."""
    return nn.Sequential(*[RRDB(channels, growth_channels) for _ in range(num_blocks)])
