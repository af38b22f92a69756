"""Differentiable JPEG compression (DiffJPEG) in PyTorch (counterpart of
``srganfd_tpu/ops/jpeg.py``).

Parity target: the DiffJPEG stack of ``Real_ESRGAN/imgproc.py:1183-1497``
(RGB->YCbCr, 2x2 chroma subsample, 8x8 block DCT, quality-scaled
quantization with optional differentiable rounding, dequantize, IDCT,
chroma upsample, merge), which models the BSRGAN chain's cv2 JPEG
(``BSRGAN/imgproc.py:284-293``): entropy coding is lossless, so
quantization is the only stage that changes the signal.

``quality`` is a per-sample tensor. Input NHWC in [0, 1]; H and W must be
multiples of 16 (callers pad). Rounding is ``torch.round``, half to even,
as ``jnp.round``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["diff_jpeg", "jpeg_quality_to_factor"]

# standard JPEG luminance / chrominance quantization tables
_Y_TABLE = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
)
_C_TABLE = np.full((8, 8), 99, dtype=np.float32)
_C_TABLE[:4, :4] = np.array(
    [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]], dtype=np.float32
)

_RGB2YCBCR = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ],
    dtype=np.float32,
).T
_YCBCR2RGB = np.array(
    [[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136], [1.0, 1.772, 0.0]], dtype=np.float32
).T


def _dct_matrix() -> np.ndarray:
    """8x8 orthonormal DCT-II matrix."""
    m = np.zeros((8, 8), dtype=np.float64)
    for k in range(8):
        for n in range(8):
            m[k, n] = np.cos(np.pi * k * (2 * n + 1) / 16.0)
        m[k] *= np.sqrt(0.25 if k else 0.125)
    return m.astype(np.float32)


_DCT = _dct_matrix()


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device)


def jpeg_quality_to_factor(quality: torch.Tensor) -> torch.Tensor:
    """JPEG quality in [1, 100] -> quantization scale factor (libjpeg rule)."""
    quality = quality.float()
    factor = torch.where(quality < 50.0, 5000.0 / quality, 200.0 - 2.0 * quality)
    return factor / 100.0


def _to_blocks(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> (N, H/8*W/8, 8, 8)."""
    n, h, w = x.shape
    return x.reshape(n, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4).reshape(n, -1, 8, 8)


def _from_blocks(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    n = x.shape[0]
    return x.reshape(n, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4).reshape(n, h, w)


def _codec_channel(
    chan: torch.Tensor,
    table: np.ndarray,
    factor: torch.Tensor,
    differentiable: bool,
    transpose_tables: bool,
) -> torch.Tensor:
    """DCT -> quantize -> round -> dequantize -> IDCT for one plane.
    chan: (N, H, W) centred at 0 (value - 128); factor: (N,)."""
    n, h, w = chan.shape
    dct = _const(_DCT, chan)
    coefs = torch.einsum("ij,nbjk,lk->nbil", dct, _to_blocks(chan), dct)
    if transpose_tables:
        table = table.T
    q = _const(np.ascontiguousarray(table), chan)[None, None] * factor[:, None, None, None]
    scaled = coefs / q
    r = torch.round(scaled)
    # the reference's differentiable rounding: round(x) + (x - round(x))^3
    rounded = r + (scaled - r) ** 3 if differentiable else r
    back = torch.einsum("ji,nbjk,kl->nbil", dct, rounded * q, dct)
    return _from_blocks(back, h, w)


def diff_jpeg(
    images: torch.Tensor,
    quality: torch.Tensor,
    differentiable: bool = True,
    transpose_tables: bool = False,
) -> torch.Tensor:
    """JPEG-compress a batch at per-sample quality.

    images: (N, H, W, 3) RGB in [0, 1], H and W multiples of 16; quality:
    (N,) in [1, 100]. ``transpose_tables`` reproduces the reference
    DiffJPEG's transposed Y/C tables (``Real_ESRGAN/imgproc.py:43-51``); the
    default follows the JPEG standard. Returns (N, H, W, 3) in [0, 1].
    """
    n, h, w, _ = images.shape
    if h % 16 or w % 16:
        raise ValueError(f"pad to multiples of 16 before diff_jpeg, got {h}x{w}")
    x = images.float() * 255.0
    ycc = x @ _const(_RGB2YCBCR, x) + torch.tensor([0.0, 128.0, 128.0], device=x.device)
    y, cb, cr = ycc[..., 0], ycc[..., 1], ycc[..., 2]

    def down(c: torch.Tensor) -> torch.Tensor:  # 4:2:0 chroma, 2x2 mean
        return c.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    def up(c: torch.Tensor) -> torch.Tensor:
        return c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    factor = jpeg_quality_to_factor(quality.to(x.device))
    tt = transpose_tables
    y_out = _codec_channel(y - 128.0, _Y_TABLE, factor, differentiable, tt) + 128.0
    cb_out = up(_codec_channel(down(cb) - 128.0, _C_TABLE, factor, differentiable, tt) + 128.0)
    cr_out = up(_codec_channel(down(cr) - 128.0, _C_TABLE, factor, differentiable, tt) + 128.0)

    ycc_out = torch.stack([y_out, cb_out - 128.0, cr_out - 128.0], dim=-1)
    rgb = ycc_out @ _const(_YCBCR2RGB, x)
    return torch.clamp(rgb / 255.0, 0.0, 1.0).to(images.dtype)
