"""Discriminators of the port (counterpart of
``srganfd_tpu/models/discriminators.py``).

Ported:

- ``DiscriminatorUNet``, registered as ``discriminator_unet``, the U-Net
  with spectral norm of ``Real_ESRGAN/model.py:29-105`` (clone
  ``BSRGAN/model.py:91-167``) that the ``bsrgan`` and ``realesrgan``
  configs train against;
- ``AttentionUNetDiscriminator``, registered as ``uNetDiscriminatorAesrgan``
  and ``discriminator_attention_unet``, A-ESRGAN's attention-gated U-Net
  (``A-ESRGAN/model.py:228-352``) that the ``aesrgan`` config trains
  against, its gates (``_AddAttn``) with BatchNorm;
- ``MultiScaleAttentionDiscriminator``, ``discriminator_attention_unet_ms``,
  the A-ESRGAN paper's ensemble of such U-Nets over 1x, 1/2x, ...

The other discriminators of the JAX package raise in ``create_model`` with
the ROADMAP.md item that ports them.

``forward`` takes NHWC float tensors, as ``model.apply`` does in JAX, and
returns what the JAX module returns, NHWC: the per-pixel logit map (N, H,
W, 1) in f32 (f64 under f64 compute, a CPU-only dtype of parity tests);
for the attention U-Net ``(logit map, (ly1, ly2, ly3))``, its three
attention maps in the compute dtype; for the ensemble ``(per-scale logit
maps, scale 0's attention maps)``. Inside, the network runs NCHW
channels-last in the compute ``dtype``. ``update_stats`` is the JAX
module's ``train`` with the mutable collections kept: each spectral-norm
conv runs its power iteration on every call and each BatchNorm normalises
with the batch's statistics, and they write ``u`` and the running
statistics only when it is set. State-dict names are the reference's
(``tools/port_torch_weights.py``); ``convert.py`` maps the Flax trees onto
them.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

import torch.nn.functional as F

from srganfd_tpu_torch.models.blocks import BatchNorm, Conv, SNConv, init_lecun_normal, lrelu, out_dtype
from srganfd_tpu_torch.models.registry import register
from srganfd_tpu_torch.ops.resize import resize_bilinear

__all__ = ["DiscriminatorUNet", "AttentionUNetDiscriminator", "MultiScaleAttentionDiscriminator"]


def _resize(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with half-pixel centers (align_corners=False) of an
    NCHW tensor to ``hw``, through the port's ``resize_bilinear`` on its
    NHWC view."""
    return resize_bilinear(x.permute(0, 2, 3, 1), hw).permute(0, 3, 1, 2)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return _resize(x, (2 * x.shape[2], 2 * x.shape[3]))


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class DiscriminatorUNet(nn.Module):
    """U-Net discriminator with spectral norm: 3 SN-conv /2 down blocks,
    bilinear-up + SN-conv with skip adds, 2 more SN convs, a per-pixel
    logit map (``Real_ESRGAN/model.py:29-105``)."""

    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 1,
        channels: int = 64,
        dtype: torch.dtype = torch.float32,
        device: Any = None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        c = channels
        self.conv0 = Conv(in_channels, c)
        self.conv1 = SNConv(c, c * 2, 4, 2)
        self.conv2 = SNConv(c * 2, c * 4, 4, 2)
        self.conv3 = SNConv(c * 4, c * 8, 4, 2)
        self.conv4 = SNConv(c * 8, c * 4, 3, 1)
        self.conv5 = SNConv(c * 4, c * 2, 3, 1)
        self.conv6 = SNConv(c * 2, c, 3, 1)
        self.conv7 = SNConv(c, c, 3, 1)
        self.conv8 = SNConv(c, c, 3, 1)
        self.conv9 = Conv(c, out_channels)
        # the JAX module's call order: Conv_0, SNConv_0..7, Conv_1
        init_lecun_normal(self.conv0, generator)
        for i in range(1, 9):
            getattr(self, f"conv{i}").reset_parameters(generator)
        init_lecun_normal(self.conv9, generator)
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        x = _nchw(x, self.dtype)
        out1 = self.conv0(x)
        down1 = lrelu(self.conv1(out1, update_stats))
        down2 = lrelu(self.conv2(down1, update_stats))
        down3 = lrelu(self.conv3(down2, update_stats))
        up1 = lrelu(self.conv4(_upsample2(down3), update_stats)) + down2
        up2 = lrelu(self.conv5(_upsample2(up1), update_stats)) + down1
        up3 = lrelu(self.conv6(_upsample2(up2), update_stats)) + out1
        out = lrelu(self.conv7(up3, update_stats))
        out = lrelu(self.conv8(out, update_stats))
        return self.conv9(out).to(out_dtype(self.dtype)).permute(0, 2, 3, 1)


class _AddAttn(nn.Module):
    """A-ESRGAN's attention gate (``A-ESRGAN/model.py:228-254``): theta(x),
    a 2x2 stride-2 conv, plus phi(g), a 1x1 conv resized to theta's size;
    ReLU; psi, a 1x1 conv to one channel, through a sigmoid and resized to
    x's size, gates x; then the 1x1 conv ``W.0`` and BatchNorm ``W.1``.
    Returns (the gated features, the attention map psi)."""

    def __init__(self, x_channels: int, g_channels: int) -> None:
        super().__init__()
        self.theta = Conv(x_channels, x_channels, kernel=2, stride=2, padding=0, use_bias=False)
        self.phi = Conv(g_channels, x_channels, kernel=1, padding=0)
        self.psi = Conv(x_channels, 1, kernel=1, padding=0)
        self.W = nn.ModuleList([Conv(x_channels, x_channels, kernel=1, padding=0), BatchNorm(x_channels)])

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        for conv in (self.theta, self.phi, self.psi, self.W[0]):
            init_lecun_normal(conv, generator)

    def forward(self, x: torch.Tensor, g: torch.Tensor, update_stats: bool) -> tuple[torch.Tensor, torch.Tensor]:
        theta = self.theta(x)
        phi = _resize(self.phi(g), tuple(theta.shape[2:]))
        psi = torch.sigmoid(self.psi(F.relu(theta + phi)))
        psi = _resize(psi, tuple(x.shape[2:]))
        return self.W[1](self.W[0](psi * x), update_stats), psi


class _UNetCat(nn.Module):
    """Upsample-then-concat merge (``A-ESRGAN/model.py:258-275``): the deep
    map bilinear x2 through the spectral-norm ``convU``, then [skip, deep]
    on channels; the skip zero-padded by half the height difference where
    the sizes differ, as the JAX module pads."""

    def __init__(self, dim_in: int, dim_out: int) -> None:
        super().__init__()
        self.convU = SNConv(dim_in, dim_out, 3, 1)

    def forward(self, skip: torch.Tensor, deep: torch.Tensor, update_stats: bool) -> torch.Tensor:
        deep = lrelu(self.convU(_upsample2(deep), update_stats))
        offset = deep.shape[2] - skip.shape[2]
        if offset:
            pad = offset // 2
            skip = F.pad(skip, (pad, pad, pad, pad))
        if skip.shape[2:] != deep.shape[2:]:
            # the JAX module fails here too (jnp.concatenate): an odd side
            # at a stride-2 stage upsamples one pixel past its skip
            raise ValueError(
                f"attention U-Net discriminator: skip {tuple(skip.shape[2:])} and upsampled "
                f"{tuple(deep.shape[2:])} differ: each scale's input sides must be multiples of 8"
            )
        return torch.cat([skip, deep], 1)


class AttentionUNetDiscriminator(nn.Module):
    """A-ESRGAN's attention-gated U-Net discriminator with spectral norm
    (``A-ESRGAN/model.py:279-352``): three stride-2 SN convs, a gating
    signal from the deepest map, three attention gates on the skips, three
    upsample-and-concat merges, two more SN convs, a per-pixel logit map.
    Returns ``(logit_map, (ly1, ly2, ly3))``, the gates' attention maps.

    It keeps the reference's ``gating``, a 1x1 SN conv with padding 1,
    which grows the deepest map by 2 pixels (15 x 15 to 17 x 17 at GT
    120); every consumer resizes it. Sides must be multiples of 8 (see
    ``_UNetCat``)."""

    def __init__(
        self,
        num_in_ch: int = 3,
        num_feat: int = 64,
        dtype: torch.dtype = torch.float32,
        device: Any = None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        f = num_feat
        self.conv0 = Conv(num_in_ch, f)
        self.conv1 = SNConv(f, f * 2, 3, 2)
        self.conv2 = SNConv(f * 2, f * 4, 3, 2)
        self.conv3 = SNConv(f * 4, f * 8, 3, 2)
        self.gating = SNConv(f * 8, f * 4, 1, 1, padding=1)
        self.attn_1 = _AddAttn(f * 4, f * 4)
        self.attn_2 = _AddAttn(f * 2, f * 4)
        self.attn_3 = _AddAttn(f, f * 4)
        self.cat_1 = _UNetCat(f * 8, f * 4)
        self.conv4 = SNConv(f * 8, f * 4, 3, 1)
        self.cat_2 = _UNetCat(f * 4, f * 2)
        self.conv5 = SNConv(f * 4, f * 2, 3, 1)
        self.cat_3 = _UNetCat(f * 2, f)
        self.conv6 = SNConv(f * 2, f, 3, 1)
        self.conv7 = SNConv(f, f, 3, 1)
        self.conv8 = SNConv(f, f, 3, 1)
        self.conv9 = Conv(f, 1)
        # the JAX module's call order: Conv_0, SNConv_0..3, _AddAttn_0..2,
        # then each _UNetCat before the SN conv after it, SNConv_7..8, Conv_1
        init_lecun_normal(self.conv0, generator)
        for m in (self.conv1, self.conv2, self.conv3, self.gating, self.attn_1, self.attn_2, self.attn_3,
                  self.cat_1.convU, self.conv4, self.cat_2.convU, self.conv5, self.cat_3.convU, self.conv6,
                  self.conv7, self.conv8):
            m.reset_parameters(generator)
        init_lecun_normal(self.conv9, generator)
        if device is not None:
            self.to(device)

    def forward(
        self, x: torch.Tensor, update_stats: bool = False
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        us = update_stats
        x0 = lrelu(self.conv0(_nchw(x, self.dtype)))
        x1 = lrelu(self.conv1(x0, us))
        x2 = lrelu(self.conv2(x1, us))
        x3 = lrelu(self.conv3(x2, us))
        gated = lrelu(self.gating(x3, us))
        attn1, ly1 = self.attn_1(x2, gated, us)
        attn2, ly2 = self.attn_2(x1, gated, us)
        attn3, ly3 = self.attn_3(x0, gated, us)
        y = lrelu(self.conv4(self.cat_1(attn1, x3, us), us))
        y = lrelu(self.conv5(self.cat_2(attn2, y, us), us))
        y = lrelu(self.conv6(self.cat_3(attn3, y, us), us))
        y = lrelu(self.conv7(y, us))
        y = lrelu(self.conv8(y, us))
        out = self.conv9(y).to(out_dtype(self.dtype)).permute(0, 2, 3, 1)
        return out, tuple(ly.permute(0, 2, 3, 1) for ly in (ly1, ly2, ly3))


class MultiScaleAttentionDiscriminator(nn.Module):
    """The A-ESRGAN paper's ensemble (arXiv:2112.10046, section 3.2):
    ``num_scales`` independent attention U-Nets, ``D0``, ``D1``, ...,
    judge the image at 1x, 1/2x, ... (2x2 average pooling, stride 2,
    between scales); the caller sums the per-scale losses. Returns (the
    tuple of per-scale logit maps, scale 0's attention maps). Every
    scale's sides must be multiples of 8: GT sides of 16k at two scales."""

    def __init__(
        self,
        num_in_ch: int = 3,
        num_feat: int = 64,
        num_scales: int = 2,
        dtype: torch.dtype = torch.float32,
        device: Any = None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.dtype, self.num_scales = dtype, num_scales
        for s in range(num_scales):
            setattr(self, f"D{s}", AttentionUNetDiscriminator(num_in_ch, num_feat, dtype, generator=generator))
        if device is not None:
            self.to(device)

    def forward(
        self, x: torch.Tensor, update_stats: bool = False
    ) -> tuple[tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
        cur = x.to(self.dtype)
        outs, attns0 = [], ()
        for s in range(self.num_scales):
            out, attns = getattr(self, f"D{s}")(cur, update_stats)
            outs.append(out)
            if s == 0:
                attns0 = attns
            if s + 1 < self.num_scales:
                cur = F.avg_pool2d(cur.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return tuple(outs), attns0


@register("discriminator_unet")
def discriminator_unet(**kw: Any) -> DiscriminatorUNet:
    return DiscriminatorUNet(**kw)


@register("uNetDiscriminatorAesrgan")
@register("discriminator_attention_unet")
def discriminator_attention_unet(**kw: Any) -> AttentionUNetDiscriminator:
    return AttentionUNetDiscriminator(**kw)


@register("discriminator_attention_unet_ms")
def discriminator_attention_unet_ms(**kw: Any) -> MultiScaleAttentionDiscriminator:
    return MultiScaleAttentionDiscriminator(**kw)
