"""Discriminators of the port (counterpart of
``srganfd_tpu/models/discriminators.py``).

Ported:

- ``DiscriminatorVGG128``, registered as ``discriminator``, ESRGAN's
  VGG-style 128 x 128 discriminator (``ESRGAN/model.py:89-141``) that the
  ``esrgan`` config trains against, its nine stages with BatchNorm;
- ``DiscriminatorUNet``, registered as ``discriminator_unet``, the U-Net
  with spectral norm of ``Real_ESRGAN/model.py:29-105`` (clone
  ``BSRGAN/model.py:91-167``) that the ``bsrgan`` and ``realesrgan``
  configs train against;
- ``DiscriminatorUNetSA``, registered as ``discriminator_unet_sa``, that
  U-Net with token self-attention after down2, after down3 and on up1
  (``BSRGAN/model.py:170-279``), which ``--d-arch discriminator_unet_sa``
  trains in the ``bsrgan`` recipe;
- ``AttentionUNetDiscriminator``, registered as ``uNetDiscriminatorAesrgan``
  and ``discriminator_attention_unet``, A-ESRGAN's attention-gated U-Net
  (``A-ESRGAN/model.py:228-352``) that the ``aesrgan`` config trains
  against, its gates (``_AddAttn``) with BatchNorm;
- ``MultiScaleAttentionDiscriminator``, ``discriminator_attention_unet_ms``,
  the A-ESRGAN paper's ensemble of such U-Nets over 1x, 1/2x, ...

Every discriminator of the JAX package is ported.

``forward`` takes NHWC float tensors, as ``model.apply`` does in JAX, and
returns what the JAX module returns: for the VGG-128 D one logit per
image, (N, 1); for the U-Nets NHWC, the per-pixel logit map (N, H,
W, 1); in f32 (f64 under f64 compute, a CPU-only dtype of parity tests);
for the self-attention U-Net ``(logit map, up1 attention map)``, the map
(N, Q, K) averaged over heads; for the attention U-Net ``(logit map, (ly1, ly2, ly3))``, its three
attention maps in the compute dtype; for the ensemble ``(per-scale logit
maps, scale 0's attention maps)``. Inside, the network runs NCHW
channels-last in the compute ``dtype``. ``update_stats`` is the JAX
module's ``train`` with the mutable collections kept: each spectral-norm
conv runs its power iteration on every call and each BatchNorm normalises
with the batch's statistics, and they write ``u`` and the running
statistics only when it is set. Every D also takes ``train``, the JAX
module's own switch between its BatchNorms' batch statistics
(``train=True``, what every training step runs) and their running
statistics (``train=False``, eval mode, the JAX module's default and so
the port's, what ``cli.test`` runs); a D without BatchNorm runs alike in
both modes. State-dict names are the reference's
(``tools/port_torch_weights.py``); ``convert.py`` maps the Flax trees onto
them.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

import torch.nn.functional as F

from srganfd_tpu_torch.models.blocks import (
    BatchNorm,
    Conv,
    SNConv,
    TokenSelfAttention,
    init_lecun_normal,
    lrelu,
    out_dtype,
)
from srganfd_tpu_torch.models.registry import register
from srganfd_tpu_torch.ops.resize import resize_bilinear

__all__ = ["DiscriminatorVGG128", "DiscriminatorUNet", "DiscriminatorUNetSA", "AttentionUNetDiscriminator",
           "MultiScaleAttentionDiscriminator"]


def _resize(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with half-pixel centers (align_corners=False) of an
    NCHW tensor to ``hw``, through the port's ``resize_bilinear`` on its
    NHWC view."""
    return resize_bilinear(x.permute(0, 2, 3, 1), hw).permute(0, 3, 1, 2)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return _resize(x, (2 * x.shape[2], 2 * x.shape[3]))


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class DiscriminatorVGG128(nn.Module):
    """ESRGAN's VGG-style discriminator (``ESRGAN/model.py:89-141``): a
    3 x 3 conv with bias, then nine bias-free convs, alternately 4 x 4
    stride 2 and 3 x 3 stride 1 (torch padding 1 for both), each followed
    by BatchNorm, with LeakyReLU 0.2 after each stage, from 128 x 128 down
    to 4 x 4; flattened channel-major as torch's ``flatten(1)`` of NCHW
    (the JAX module transposes to NCHW before its reshape); Linear(8c * 16
    -> 100), LeakyReLU, Linear(100 -> 1): one logit per image.

    Names are the reference's: ``features.{0, 2, 5, ..., 26}`` the convs,
    ``features.{3, 6, ..., 27}`` the BatchNorms (the other indices are
    LeakyReLUs), ``classifier.0`` and ``classifier.2`` the Linears.
    ``channels`` scales the 64-base ladder (c, 2c, 4c, 8c) as the JAX
    module's does; widths other than 64 are for tests. Init as Flax's:
    lecun-normal convs and Linears, zero biases, BatchNorm scale 1 and
    bias 0, in the JAX module's call order, from ``generator``.

    ``update_stats`` writes the BatchNorms' running statistics (with
    ``train``); ``train`` is the JAX module's argument, False by default
    as there: eval mode normalises with the running statistics."""

    size = 128
    stages = ((1, 4, 2), (2, 3, 1), (2, 4, 2), (4, 3, 1), (4, 4, 2), (8, 3, 1), (8, 4, 2), (8, 3, 1), (8, 4, 2))

    def __init__(
        self,
        channels: int = 64,
        dtype: torch.dtype = torch.float32,
        device: Any = None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        c = channels
        layers: list[nn.Module] = [Conv(3, c), nn.LeakyReLU(0.2)]
        cin = c
        for mult, k, s in self.stages:
            layers += [Conv(cin, c * mult, kernel=k, stride=s, use_bias=False), BatchNorm(c * mult),
                       nn.LeakyReLU(0.2)]
            cin = c * mult
        self.features = nn.ModuleList(layers)
        self.classifier = nn.ModuleList([nn.Linear(cin * 4 * 4, 100), nn.LeakyReLU(0.2), nn.Linear(100, 1)])
        for m in (*self.features, *self.classifier):  # the JAX module's call order
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                init_lecun_normal(m, generator)
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor, update_stats: bool = False, train: bool = False) -> torch.Tensor:
        if tuple(x.shape[1:3]) != (self.size, self.size):
            raise ValueError(f"DiscriminatorVGG128 takes {self.size} x {self.size} inputs (its classifier reads a "
                             f"4 x 4 map), got {tuple(x.shape[1:3])}")
        h = lrelu(self.features[0](_nchw(x, self.dtype)))
        for i in range(len(self.stages)):
            conv, bn = self.features[2 + 3 * i], self.features[3 + 3 * i]
            h = lrelu(bn(conv(h), update_stats, train))
        h = h.flatten(1)  # NCHW order: channel-major
        fc0, _, fc1 = self.classifier
        h = lrelu(F.linear(h, fc0.weight.to(h.dtype), fc0.bias.to(h.dtype)))
        return F.linear(h, fc1.weight.to(h.dtype), fc1.bias.to(h.dtype)).to(out_dtype(self.dtype))


def _add_unet_convs(m: nn.Module, in_channels: int, out_channels: int, c: int) -> None:
    """The spectral-norm U-Net's convs (``Real_ESRGAN/model.py:29-105``):
    ``conv0``, the stride-2 ``conv1..3``, ``conv4..8`` and ``conv9``."""
    m.conv0 = Conv(in_channels, c)
    m.conv1 = SNConv(c, c * 2, 4, 2)
    m.conv2 = SNConv(c * 2, c * 4, 4, 2)
    m.conv3 = SNConv(c * 4, c * 8, 4, 2)
    m.conv4 = SNConv(c * 8, c * 4, 3, 1)
    m.conv5 = SNConv(c * 4, c * 2, 3, 1)
    m.conv6 = SNConv(c * 2, c, 3, 1)
    m.conv7 = SNConv(c, c, 3, 1)
    m.conv8 = SNConv(c, c, 3, 1)
    m.conv9 = Conv(c, out_channels)


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
        _add_unet_convs(self, in_channels, out_channels, channels)
        # the JAX module's call order: Conv_0, SNConv_0..7, Conv_1
        init_lecun_normal(self.conv0, generator)
        for i in range(1, 9):
            getattr(self, f"conv{i}").reset_parameters(generator)
        init_lecun_normal(self.conv9, generator)
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor, update_stats: bool = False, train: bool = False) -> torch.Tensor:
        del train  # no BatchNorm: the spectral-norm convs run alike in both modes
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


class DiscriminatorUNetSA(nn.Module):
    """The spectral-norm U-Net of ``DiscriminatorUNet`` with token
    self-attention (``TokenSelfAttention``, 8 heads) after down2, after
    down3, and on up1 before its ``+ down2`` skip
    (``BSRGAN/model.py:170-279``; JAX
    ``srganfd_tpu/models/discriminators.py:119-157``). Returns ``(logit
    map, attn_map_up1)``: the up1 attention's head-averaged weights, (N,
    Q, K) in the compute dtype, or None with ``attn_chunk`` > 0, whose
    attentions run exactly in query chunks through ``attn_backend`` (see
    ``TokenSelfAttention``).

    Names: the U-Net's (``conv0``..``conv9``), and ``attn_down2``,
    ``attn_down3``, ``attn_up1`` for the attentions in the layout of
    torch's ``nn.MultiheadAttention`` (``in_proj_weight``,
    ``in_proj_bias``, ``out_proj``). The reference's module file is not in
    this repository, so the attentions' names are the port's choice, as
    for ``bsrgantrans_x2``'s transformer."""

    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 1,
        channels: int = 64,
        attn_chunk: int = 0,
        attn_backend: str | None = None,
        dtype: torch.dtype = torch.float32,
        device: Any = None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        c = channels
        _add_unet_convs(self, in_channels, out_channels, c)
        self.attn_down2 = TokenSelfAttention(c * 4, chunk_size=attn_chunk, attn_backend=attn_backend)
        self.attn_down3 = TokenSelfAttention(c * 8, chunk_size=attn_chunk, attn_backend=attn_backend)
        self.attn_up1 = TokenSelfAttention(c * 4, chunk_size=attn_chunk, attn_backend=attn_backend)
        # the JAX module's call order: Conv_0, SNConv_0..1, TokenSelfAttention_0,
        # SNConv_2, TokenSelfAttention_1, SNConv_3, TokenSelfAttention_2, SNConv_4..7, Conv_1
        init_lecun_normal(self.conv0, generator)
        for m in (self.conv1, self.conv2, self.attn_down2, self.conv3, self.attn_down3, self.conv4,
                  self.attn_up1, self.conv5, self.conv6, self.conv7, self.conv8):
            m.reset_parameters(generator)
        init_lecun_normal(self.conv9, generator)
        if device is not None:
            self.to(device)

    def forward(
        self, x: torch.Tensor, update_stats: bool = False, train: bool = False
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        del train  # no BatchNorm: the spectral-norm convs run alike in both modes
        us = update_stats
        x = _nchw(x, self.dtype)
        out1 = self.conv0(x)
        down1 = lrelu(self.conv1(out1, us))
        down2, _ = self.attn_down2(lrelu(self.conv2(down1, us)))
        down3, _ = self.attn_down3(lrelu(self.conv3(down2, us)))
        up1, attn_map_up1 = self.attn_up1(lrelu(self.conv4(_upsample2(down3), us)))
        up1 = up1 + down2
        up2 = lrelu(self.conv5(_upsample2(up1), us)) + down1
        up3 = lrelu(self.conv6(_upsample2(up2), us)) + out1
        out = lrelu(self.conv7(up3, us))
        out = lrelu(self.conv8(out, us))
        return self.conv9(out).to(out_dtype(self.dtype)).permute(0, 2, 3, 1), attn_map_up1


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

    def forward(self, x: torch.Tensor, g: torch.Tensor, update_stats: bool,
                train: bool) -> tuple[torch.Tensor, torch.Tensor]:
        theta = self.theta(x)
        phi = _resize(self.phi(g), tuple(theta.shape[2:]))
        psi = torch.sigmoid(self.psi(F.relu(theta + phi)))
        psi = _resize(psi, tuple(x.shape[2:]))
        return self.W[1](self.W[0](psi * x), update_stats, train), psi


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
        self, x: torch.Tensor, update_stats: bool = False, train: bool = False
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        us = update_stats
        x0 = lrelu(self.conv0(_nchw(x, self.dtype)))
        x1 = lrelu(self.conv1(x0, us))
        x2 = lrelu(self.conv2(x1, us))
        x3 = lrelu(self.conv3(x2, us))
        gated = lrelu(self.gating(x3, us))
        attn1, ly1 = self.attn_1(x2, gated, us, train)
        attn2, ly2 = self.attn_2(x1, gated, us, train)
        attn3, ly3 = self.attn_3(x0, gated, us, train)
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
        self, x: torch.Tensor, update_stats: bool = False, train: bool = False
    ) -> tuple[tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
        cur = x.to(self.dtype)
        outs, attns0 = [], ()
        for s in range(self.num_scales):
            out, attns = getattr(self, f"D{s}")(cur, update_stats, train)
            outs.append(out)
            if s == 0:
                attns0 = attns
            if s + 1 < self.num_scales:
                cur = F.avg_pool2d(cur.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return tuple(outs), attns0


@register("discriminator")
def discriminator(**kw: Any) -> DiscriminatorVGG128:
    return DiscriminatorVGG128(**kw)


@register("discriminator_unet")
def discriminator_unet(**kw: Any) -> DiscriminatorUNet:
    return DiscriminatorUNet(**kw)


@register("discriminator_unet_sa")
def discriminator_unet_sa(**kw: Any) -> DiscriminatorUNetSA:
    return DiscriminatorUNetSA(**kw)


@register("uNetDiscriminatorAesrgan")
@register("discriminator_attention_unet")
def discriminator_attention_unet(**kw: Any) -> AttentionUNetDiscriminator:
    return AttentionUNetDiscriminator(**kw)


@register("discriminator_attention_unet_ms")
def discriminator_attention_unet_ms(**kw: Any) -> MultiScaleAttentionDiscriminator:
    return MultiScaleAttentionDiscriminator(**kw)
