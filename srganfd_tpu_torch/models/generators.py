"""Generator families (counterpart of ``srganfd_tpu/models/generators.py``
``RRDBNet``, ``BSRGAN``, ``BSRGANtrans``, ``RealESRGANNet``,
``GeneratorRPA`` and ``GeneratorRRDB`` with their registered names).

- ``RRDBNet`` x1/x2/x4/x8: ``ESRGAN/model.py:144-243,301-322``; one
  nearest-upsample + conv stage per factor of 2.
- ``BSRGAN`` x2/x4: ``BSRGAN/model.py:311-384``; upsampling1 always runs,
  upsampling2 only at x4. ``bsrgansa_x2`` is BSRGAN x2: the reference's
  ``BSRGANsa`` never inserts its attention modules.
- ``BSRGANtrans`` x2: ``A-ESRGAN/model.py:643-753``, BSRGAN with a
  transformer bottleneck between the trunk and ``conv2``.
- ``RealESRGANNet`` x4/x2: ``Real_ESRGAN/model.py:179-263,331-334``; a
  pixel-unshuffle front (by 2 at x2, by 4 at x1), then always two
  nearest-upsample + conv stages.
- ``GeneratorRPA`` (``gen_rpa2x``): A-ESRGAN's residual pixel-attention
  generator (``A-ESRGAN/model.py:87-175``): 1x1 convs, sigmoid gates, no
  RDB and no output clamp.
- ``GeneratorRRDB`` (``gen_rrdb2x``): A-ESRGAN's pixel-unshuffle RRDB
  generator (``A-ESRGAN/model.py:180-215``): unshuffle by 4 / scale, the
  RRDB trunk on the RDB kernel, two nearest-x2 stages, no clamp.

``forward`` takes and returns NHWC float tensors, as ``model.apply`` does
in JAX; inside, the network runs NCHW channels-last in the compute
``dtype`` (f32, or bf16 for ``--half``) and emits f32 clamped to [0, 1]
(f64 under f64 compute, a CPU-only dtype of parity tests).
``quant=True`` (``RRDBNet``, ``BSRGAN``, ``BSRGANtrans`` and
``RealESRGANNet``, as in JAX) serves the trunk in int8
(``ResidualDenseBlock``'s quant path); the other convs keep the compute
dtype. State-dict names are the reference's: ``conv1``, ``trunk.{i}.rdb{j}.conv{k}``,
``conv2``, ``upsampling{n}.0``, ``conv3.0``, ``conv4`` (``RealESRGANNet``
too: its conv1 takes the unshuffled channels); ``BSRGANtrans``
adds ``down_conv``, ``transformer.{0,1}`` and ``up_conv``. The two
A-ESRGAN generators take the names listed in their docstrings (see
``convert.py``). Neither of them clamps, so their outputs are unbounded.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from srganfd_tpu_torch.models.blocks import (
    Conv,
    TransformerEncoderLayer,
    init_kaiming_x01,
    init_lecun_normal,
    lrelu,
    make_trunk,
    out_dtype,
    pixel_unshuffle,
)
from srganfd_tpu_torch.models.registry import register
from srganfd_tpu_torch.ops.resize import upsample_nearest

__all__ = ["RRDBNet", "BSRGAN", "BSRGANtrans", "RealESRGANNet", "GeneratorRPA", "GeneratorRRDB"]


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
        quant: bool = False,
        device: Any = None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.quant = quant
        self.num_upsample = self._num_upsample(upscale_factor)
        self.upscale = 2**self.num_upsample
        # built and initialised on the CPU (the generator is a CPU one),
        # then moved
        self.conv1 = Conv(in_channels, channels)
        self.trunk = make_trunk(channels, growth_channels, num_blocks, quant)
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
        out1 = self._head(x)
        return self._tail(out1, self._bottleneck(self.trunk(out1)))

    def forward_shards(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """``forward`` of every rank's shard under ``--spatial-shard``, in one
        process: the shards meet only in the bottleneck (the
        context-parallel attention of ``BSRGANtrans``), run here by a loop
        with no collective. The plain version of the sharded forward."""
        out1 = [self._head(x) for x in xs]
        mids = self._bottleneck_shards([self.trunk(o) for o in out1])
        return [self._tail(o, m) for o, m in zip(out1, mids)]

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self.conv1(x)

    def _tail(self, out1: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
        out = out1 + self.conv2(mid)
        for i in range(self.num_upsample):
            out = lrelu(getattr(self, f"upsampling{i + 1}")(upsample_nearest(out, 2)))
        out = lrelu(self.conv3(out))
        out = self.conv4(out)
        return out.clamp(0.0, 1.0).to(out_dtype(self.dtype)).permute(0, 2, 3, 1)

    def _bottleneck(self, x: torch.Tensor) -> torch.Tensor:
        """What runs between the trunk and ``conv2``: nothing here."""
        return x

    def _bottleneck_shards(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        return [self._bottleneck(x) for x in xs]


class BSRGAN(RRDBNet):
    """BSRGAN generator: RRDBNet topology where upsampling1 always runs and
    upsampling2 only at x4."""

    def __init__(self, *, num_rrdb: int = 23, quant: bool = False, **kwargs: Any) -> None:
        super().__init__(num_blocks=num_rrdb, quant=quant, **kwargs)

    @staticmethod
    def _num_upsample(upscale_factor: int) -> int:
        return 2 if upscale_factor == 4 else 1


class _EncoderStack(nn.Sequential):
    """The encoder layers in order, each given the same key mask."""

    def forward(self, x: torch.Tensor, kv_valid: torch.Tensor | None = None) -> torch.Tensor:
        for layer in self:
            x = layer(x, kv_valid)
        return x


class BSRGANtrans(BSRGAN):
    """BSRGAN with a transformer bottleneck: after the trunk, lrelu(stride-2
    conv), 2 encoder layers (d_model = channels, 4 heads, FFN 2048) over the
    H/2 x W/2 tokens, then lrelu(conv(nearest x2)) back to full size before
    ``conv2`` and the skip. Full O((HW/4)^2) attention by default;
    ``attn_chunk`` > 0 runs it exactly in query chunks through
    ``attn_backend`` (``"chunked"`` or ``"flash"``, the hand-written kernel).
    H and W must be even: the stride-2 conv and the x2 upsample must give
    back conv1's size.

    ``ring_axis="data"`` / ``ring_halo`` / ``cp_backend``: context-parallel
    serving under ``--spatial-shard``. Each rank holds a slice of the
    frame's rows with ``ring_halo`` halo rows on each side; the attention
    runs over every rank's tokens (``"ring"`` or ``"ulysses"``), and the
    tokens of the ``ring_halo // 2`` halo rows of the stride-2 grid, copies
    of a neighbour's interior tokens, are masked out of the keys
    (``kv_valid``, JAX ``generators.py:186-197``). ``ring_halo`` and each
    rank's row count must be even."""

    def __init__(
        self,
        *,
        attn_chunk: int = 0,
        attn_backend: str | None = None,
        ring_axis: str | None = None,
        ring_halo: int = 0,
        cp_backend: str = "ring",
        quant: bool = False,
        device: Any = None,
        generator: torch.Generator | None = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(generator=generator, quant=quant, **kwargs)
        c = self.conv1.out_channels
        self.ring_axis, self.ring_halo = ring_axis, int(ring_halo)
        self.down_conv = Conv(c, c, stride=2)
        self.transformer = _EncoderStack(*[
            TransformerEncoderLayer(c, 4, 2048, attn_chunk, attn_backend, ring_axis, cp_backend) for _ in range(2)
        ])
        self.up_conv = Conv(c, c)
        for conv in (self.down_conv, self.up_conv):
            init_kaiming_x01(conv, generator)
        for layer in self.transformer:
            layer.reset_parameters(generator)
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % 2 or x.shape[2] % 2:
            raise ValueError(
                f"bsrgantrans needs even frame sizes, got {x.shape[1]}x{x.shape[2]}: the "
                "stride-2 bottleneck would not give back the trunk's size (serve with "
                "--bucket 2 to pad odd frames)"
            )
        return super().forward(x)

    def _kv_valid(self, h2: int, w2: int, device: torch.device) -> torch.Tensor | None:
        """The keys this rank contributes: every token but those of the halo
        rows of the stride-2 grid (None without a ring axis)."""
        if self.ring_axis is None:
            return None
        hf = self.ring_halo // 2
        row = torch.arange(h2 * w2, device=device) // w2
        return (row >= hf) & (row < h2 - hf)

    def _to_tokens(self, x: torch.Tensor) -> torch.Tensor:
        y = lrelu(self.down_conv(x))
        n, c, h2, w2 = y.shape
        return y.permute(0, 2, 3, 1).reshape(n, h2 * w2, c)

    def _from_tokens(self, tokens: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        n, c, h, w = like.shape
        y = tokens.reshape(n, h // 2, w // 2, c).permute(0, 3, 1, 2)
        return lrelu(self.up_conv(upsample_nearest(y, 2)))

    def _bottleneck(self, x: torch.Tensor) -> torch.Tensor:
        kv_valid = self._kv_valid(x.shape[2] // 2, x.shape[3] // 2, x.device)
        return self._from_tokens(self.transformer(self._to_tokens(x), kv_valid), x)

    def _bottleneck_shards(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        if self.ring_axis is None:
            return super()._bottleneck_shards(xs)
        tokens = [self._to_tokens(x) for x in xs]
        masks = [self._kv_valid(x.shape[2] // 2, x.shape[3] // 2, x.device) for x in xs]
        for layer in self.transformer:
            tokens = layer.forward_shards(tokens, masks)
        return [self._from_tokens(t, x) for t, x in zip(tokens, xs)]


class RealESRGANNet(RRDBNet):
    """Real-ESRGAN generator: pixel-unshuffle by 4 / upscale_factor (x4:
    none, x2: by 2, so conv1 takes 12 channels), the RRDB trunk, then
    always two nearest-x2 upsample stages, the HR conv (``conv3``), the
    last conv (``conv4``) and the clamp. At x2 H and W must be even (the
    JAX module's reshape fails on an odd frame; serve with ``--bucket 2``)."""

    _UNSHUFFLE = {4: 1, 2: 2, 1: 4}

    def __init__(
        self, *, in_channels: int = 3, num_rrdb: int = 23, upscale_factor: int = 4, quant: bool = False,
        **kwargs: Any
    ) -> None:
        if upscale_factor not in self._UNSHUFFLE:
            raise ValueError(f"RealESRGANNet takes upscale_factor 1, 2 or 4, got {upscale_factor}")
        self.unshuffle = self._UNSHUFFLE[upscale_factor]
        super().__init__(in_channels=in_channels * self.unshuffle**2, num_blocks=num_rrdb,
                         upscale_factor=upscale_factor, quant=quant, **kwargs)
        self.upscale = upscale_factor

    @staticmethod
    def _num_upsample(upscale_factor: int) -> int:
        return 2

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return super()._head(pixel_unshuffle(x, self.unshuffle))


def _to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _init_lecun(module: nn.Module, generator: torch.Generator | None) -> None:
    """Flax's default init for every conv of ``module`` (the JAX ``Conv``
    without ``scaled_init``), in registration order."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            init_lecun_normal(m, generator)


class _RPABlock(nn.Module):
    """Residual pixel-attention block (``A-ESRGAN/model.py:112-140``):
    lrelu(1x1 conv to 2F), lrelu(1x1 conv to 4F), a 3x3 conv to F and its
    sigmoid z, then lrelu(conv(x * z + x)). ``conv1``..``conv3`` take the
    kaiming x0.1 init, ``conv4`` Flax's default, as in the JAX block."""

    def __init__(self, num_feat: int, generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.conv1 = Conv(num_feat, num_feat * 2, kernel=1, padding=0)
        self.conv2 = Conv(num_feat * 2, num_feat * 4, kernel=1, padding=0)
        self.conv3 = Conv(num_feat * 4, num_feat)
        self.conv4 = Conv(num_feat, num_feat)
        init_kaiming_x01(nn.ModuleList([self.conv1, self.conv2, self.conv3]), generator)
        init_lecun_normal(self.conv4, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = torch.sigmoid(self.conv3(lrelu(self.conv2(lrelu(self.conv1(x))))))
        return lrelu(self.conv4(x * z + x))


class _PAUpsample(nn.Module):
    """Pixel-attention upsampling block ``US`` (``A-ESRGAN/model.py:87-109``):
    x_ = lrelu(1x1 conv(nearest x2)), z = sigmoid(1x1 ``pa_conv``(x_)), then
    lrelu(conv(x_ * z + x_)). Flax's default init throughout."""

    def __init__(self, num_feat: int, scale: int = 2, generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.scale = scale
        self.conv1 = Conv(num_feat, num_feat, kernel=1, padding=0)
        self.pa_conv = Conv(num_feat, num_feat, kernel=1, padding=0)
        self.conv2 = Conv(num_feat, num_feat)
        _init_lecun(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_ = lrelu(self.conv1(upsample_nearest(x, self.scale)))
        z = torch.sigmoid(self.pa_conv(x_))
        return lrelu(self.conv2(x_ * z + x_))


class GeneratorRPA(nn.Module):
    """A-ESRGAN's residual pixel-attention generator (``gen_rpa2x``;
    ``A-ESRGAN/model.py:143-175``): z = lrelu(``conv1``(x)), z + the
    ``rpa`` blocks' chain over z, ceil(log2 scale) ``us`` stages, then
    lrelu(``conv2``) to F/2 and ``conv3`` to the output. No output clamp,
    as the reference. State-dict names: ``conv1``, ``rpa.{i}.conv{1..4}``,
    ``us.{i}.{conv1,pa_conv,conv2}``, ``conv2``, ``conv3``."""

    def __init__(
        self,
        num_in_ch: int = 3,
        num_out_ch: int = 3,
        scale: int = 2,
        num_feat: int = 64,
        num_block: int = 20,
        dtype: torch.dtype = torch.float32,
        device: Any = None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        n_up = math.ceil(math.log2(scale)) if scale > 1 else 0
        self.upscale = 2**n_up
        self.conv1 = Conv(num_in_ch, num_feat)
        init_lecun_normal(self.conv1, generator)
        self.rpa = nn.Sequential(*[_RPABlock(num_feat, generator) for _ in range(num_block)])
        self.us = nn.Sequential(*[_PAUpsample(num_feat, 2, generator) for _ in range(n_up)])
        self.conv2 = Conv(num_feat, num_feat // 2)
        self.conv3 = Conv(num_feat // 2, num_out_ch)
        _init_lecun(nn.ModuleList([self.conv2, self.conv3]), generator)
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = lrelu(self.conv1(_to_nchw(x, self.dtype)))
        z = self.us(z + self.rpa(z))
        out = self.conv3(lrelu(self.conv2(z)))
        return out.to(out_dtype(self.dtype)).permute(0, 2, 3, 1)


class GeneratorRRDB(nn.Module):
    """A-ESRGAN's pixel-unshuffle RRDB generator (``gen_rrdb2x``;
    ``A-ESRGAN/model.py:180-215``, BasicSR's layout): pixel-unshuffle by
    4 // scale (at x2 ``conv_first`` takes 12 channels; H and W must then be
    even, ``--bucket 2`` pads), the ``body`` of RRDBs (every RDB through
    ``rdb_apply``: the RDB kernel on a CUDA tensor), ``conv_body`` and the
    skip, lrelu(``conv_up1``) and lrelu(``conv_up2``) each after a nearest
    x2, then ``conv_last``(lrelu(``conv_hr``)). No clamp. The trunk takes
    the kaiming x0.1 init, the other convs Flax's default, as the JAX
    module. State-dict names are BasicSR's: ``conv_first``,
    ``body.{i}.rdb{j}.conv{k}``, ``conv_body``, ``conv_up1``, ``conv_up2``,
    ``conv_hr``, ``conv_last``."""

    def __init__(
        self,
        num_in_ch: int = 3,
        num_out_ch: int = 3,
        scale: int = 4,
        num_feat: int = 64,
        num_block: int = 23,
        num_grow_ch: int = 32,
        dtype: torch.dtype = torch.float32,
        device: Any = None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        if 4 % scale:
            raise ValueError(f"GeneratorRRDB takes scale 1, 2 or 4, got {scale}")
        self.dtype = dtype
        self.unshuffle = 4 // scale
        self.upscale = scale
        self.conv_first = Conv(num_in_ch * self.unshuffle**2, num_feat)
        self.body = make_trunk(num_feat, num_grow_ch, num_block)
        self.conv_body = Conv(num_feat, num_feat)
        self.conv_up1 = Conv(num_feat, num_feat)
        self.conv_up2 = Conv(num_feat, num_feat)
        self.conv_hr = Conv(num_feat, num_feat)
        self.conv_last = Conv(num_feat, num_out_ch)
        _init_lecun(self, generator)
        init_kaiming_x01(self.body, generator)
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.conv_first(_to_nchw(pixel_unshuffle(x, self.unshuffle), self.dtype))
        z = z + self.conv_body(self.body(z))
        z = lrelu(self.conv_up1(upsample_nearest(z, 2)))
        z = lrelu(self.conv_up2(upsample_nearest(z, 2)))
        out = self.conv_last(lrelu(self.conv_hr(z)))
        return out.to(out_dtype(self.dtype)).permute(0, 2, 3, 1)


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


@register("bsrgansa_x2")
def bsrgansa_x2(**kw: Any) -> BSRGAN:
    """The reference's ``BSRGANsa`` never inserts its attention modules
    (``BSRGAN/model.py:405-496``): numerically it is BSRGAN x2."""
    return BSRGAN(upscale_factor=2, **kw)


@register("bsrgantrans_x2")
def bsrgantrans_x2(**kw: Any) -> BSRGANtrans:
    return BSRGANtrans(upscale_factor=2, **kw)


@register("realesrgan_x4")
@register("rrdbnet_realesrgan_x4")
def realesrgan_x4(**kw: Any) -> RealESRGANNet:
    return RealESRGANNet(upscale_factor=4, **kw)


@register("realesrgan_x2")
def realesrgan_x2(**kw: Any) -> RealESRGANNet:
    return RealESRGANNet(upscale_factor=2, **kw)


@register("gen_rpa2x")
def gen_rpa2x(**kw: Any) -> GeneratorRPA:
    return GeneratorRPA(scale=2, **kw)


@register("gen_rrdb2x")
def gen_rrdb2x(**kw: Any) -> GeneratorRRDB:
    return GeneratorRRDB(scale=2, **kw)
