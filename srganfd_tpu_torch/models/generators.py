"""RRDB generator family (counterpart of ``srganfd_tpu/models/generators.py``
``RRDBNet`` and ``BSRGAN`` with their registered names).

- ``RRDBNet`` x1/x2/x4/x8: ``ESRGAN/model.py:144-243,301-322``; one
  nearest-upsample + conv stage per factor of 2.
- ``BSRGAN`` x2/x4: ``BSRGAN/model.py:311-384``; upsampling1 always runs,
  upsampling2 only at x4.

``forward`` takes and returns NHWC float tensors, as ``model.apply`` does
in JAX; inside, the network runs NCHW channels-last in the compute
``dtype`` (f32, or bf16 for ``--half``) and emits f32 clamped to [0, 1].
State-dict names are the reference's: ``conv1``, ``trunk.{i}.rdb{j}.conv{k}``,
``conv2``, ``upsampling{n}.0``, ``conv3.0``, ``conv4``.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from srganfd_tpu_torch.models.blocks import Conv, init_kaiming_x01, lrelu, make_trunk
from srganfd_tpu_torch.models.registry import register
from srganfd_tpu_torch.ops.resize import upsample_nearest

__all__ = ["RRDBNet", "BSRGAN"]


class RRDBNet(nn.Module):
    """ESRGAN generator: conv1 -> RRDB trunk -> conv2 + skip -> per-x2
    nearest-upsample+conv stages -> conv3 -> conv4 -> clamp."""

    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 3,
        channels: int = 64,
        growth_channels: int = 32,
        num_blocks: int = 23,
        upscale_factor: int = 4,
        dtype: torch.dtype = torch.float32,
        device: Any = None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.num_upsample = self._num_upsample(upscale_factor)
        self.upscale = 2**self.num_upsample
        # built and initialised on the CPU (the generator is a CPU one),
        # then moved
        self.conv1 = Conv(in_channels, channels)
        self.trunk = make_trunk(channels, growth_channels, num_blocks)
        self.conv2 = Conv(channels, channels)
        for i in range(self.num_upsample):
            setattr(self, f"upsampling{i + 1}", nn.Sequential(Conv(channels, channels)))
        self.conv3 = nn.Sequential(Conv(channels, channels))
        self.conv4 = Conv(channels, out_channels)
        init_kaiming_x01(self, generator)
        if device is not None:
            self.to(device)

    @staticmethod
    def _num_upsample(upscale_factor: int) -> int:
        return int(math.log2(upscale_factor)) if upscale_factor > 1 else 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        out1 = self.conv1(x)
        out = out1 + self.conv2(self.trunk(out1))
        for i in range(self.num_upsample):
            out = lrelu(getattr(self, f"upsampling{i + 1}")(upsample_nearest(out, 2)))
        out = lrelu(self.conv3(out))
        out = self.conv4(out)
        return out.clamp(0.0, 1.0).float().permute(0, 2, 3, 1)


class BSRGAN(RRDBNet):
    """BSRGAN generator: RRDBNet topology where upsampling1 always runs and
    upsampling2 only at x4."""

    def __init__(self, *, num_rrdb: int = 23, **kwargs: Any) -> None:
        super().__init__(num_blocks=num_rrdb, **kwargs)

    @staticmethod
    def _num_upsample(upscale_factor: int) -> int:
        return 2 if upscale_factor == 4 else 1


def _rrdbnet(upscale: int):
    def factory(**kw: Any) -> RRDBNet:
        return RRDBNet(upscale_factor=upscale, **kw)

    return factory


register("rrdbnet_x1")(_rrdbnet(1))
register("rrdbnet_x2")(_rrdbnet(2))
register("rrdbnet_x4")(_rrdbnet(4))
register("rrdbnet_x8")(_rrdbnet(8))


@register("bsrgan_x2")
def bsrgan_x2(**kw: Any) -> BSRGAN:
    return BSRGAN(upscale_factor=2, **kw)


@register("bsrgan_x4")
def bsrgan_x4(**kw: Any) -> BSRGAN:
    return BSRGAN(upscale_factor=4, **kw)
