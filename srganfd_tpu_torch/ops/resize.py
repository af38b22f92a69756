"""Resampling ops of the port (counterpart of ``srganfd_tpu/ops/resize.py``).

- ``upsample_nearest``: the generators' integer-factor nearest upsample
  (NCHW, the models' inner layout).
- ``imresize``: MATLAB-faithful bicubic (``ESRGAN/imgproc.py:202-288``).
- ``resize_bilinear`` / ``resize_cubic`` / ``resize_area`` and their
  dispatcher ``cv2_style_resize``: the OpenCV interpolation flags 1/2/3
  the BSRGAN chain draws for its x4 pre-downscale
  (``BSRGAN/imgproc.py:505-560``).

Each resample plan (weights and source indices per output row or column)
is numpy, computed once per shape on the host; the apply is a gather and an
einsum in f32 over one spatial axis at a time. Images are ``(..., H, W, C)``
as in the JAX package.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from srganfd_tpu_torch.ops.consts import device_const

__all__ = [
    "upsample_nearest",
    "imresize",
    "matlab_resize_plan",
    "resize_bilinear",
    "resize_cubic",
    "resize_area",
    "cv2_style_resize",
]


def upsample_nearest(image: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor nearest upsample of an NCHW tensor (the models' inner
    layout; the JAX op takes NHWC). Output pixel (y, x) copies input pixel
    (y // factor, x // factor), as torch ``F.interpolate`` nearest does;
    the memory format (channels_last) is kept."""
    return F.interpolate(image, scale_factor=factor, mode="nearest")


def _matlab_cubic(x: np.ndarray) -> np.ndarray:
    """MATLAB's bicubic interpolation kernel (Keys, a = -0.5)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    inner = 1.5 * ax3 - 2.5 * ax2 + 1.0
    outer = -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0
    return np.where(ax <= 1.0, inner, np.where(ax <= 2.0, outer, 0.0))


@functools.lru_cache(maxsize=512)
def matlab_resize_plan(
    in_size: int, out_size: int, antialias: bool = True, scale: float | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side resample plan: ``(weights, indices)``, both (out_size, P);
    indices symmetric-reflected into ``[0, in_size)``. MATLAB's contribution
    computation: 1-based pixel centers, kernel width 4, antialiased kernel
    ``scale*k(scale*x)`` when downscaling. ``scale`` is the requested scale
    factor, on which MATLAB keys the kernel math (it differs from
    ``out_size/in_size`` whenever ``ceil(in*scale) != in*scale``)."""
    if scale is None:
        scale = out_size / in_size
    kernel_width = 4.0
    if antialias and scale < 1.0:
        kernel_width /= scale

    i = np.arange(1, out_size + 1, dtype=np.float64)
    u = i / scale + 0.5 * (1.0 - 1.0 / scale)

    left = np.floor(u - kernel_width / 2.0)
    p = int(math.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p, dtype=np.float64)[None, :]  # 1-based

    dist = u[:, None] - indices
    if antialias and scale < 1.0:
        weights = scale * _matlab_cubic(scale * dist)
    else:
        weights = _matlab_cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)

    # symmetric reflection: aux = [1..n, n..1]; idx -> aux[mod(idx-1, 2n)]
    idx0 = indices.astype(np.int64) - 1
    m = np.mod(idx0, 2 * in_size)
    reflected = np.where(m < in_size, m, 2 * in_size - 1 - m)

    # drop all-zero leading/trailing weight columns (MATLAB trims them too)
    nz = np.nonzero(np.any(weights != 0.0, axis=0))[0]
    lo, hi = int(nz[0]), int(nz[-1]) + 1
    weights = np.ascontiguousarray(weights[:, lo:hi])
    reflected = np.ascontiguousarray(reflected[:, lo:hi])
    return weights.astype(np.float32), reflected.astype(np.int32)


def _apply_plan_axis(
    x: torch.Tensor, weights: np.ndarray, indices: np.ndarray, axis: int
) -> torch.Tensor:
    """Contract one axis with a plan: gather (out, P, ...) rows, then sum
    them against the weights in f32."""
    x = x.movedim(axis, 0)
    idx = device_const(np.asarray(indices, np.int64), x.device)
    gathered = x.index_select(0, idx.reshape(-1)).reshape(*idx.shape, *x.shape[1:])
    w = device_const(weights, x.device, x.dtype)
    return torch.einsum("op,op...->o...", w, gathered).movedim(0, axis)


def imresize(
    image: torch.Tensor,
    scale_factor: float | None = None,
    out_shape: tuple[int, int] | None = None,
    antialiasing: bool = True,
) -> torch.Tensor:
    """MATLAB-faithful bicubic resize of ``(..., H, W, C)`` (or ``(H, W)``)
    float images: output ``ceil(size * scale)`` per axis, or ``out_shape``."""
    h_axis, w_axis = (0, 1) if image.dim() == 2 else (image.dim() - 3, image.dim() - 2)
    in_h, in_w = image.shape[h_axis], image.shape[w_axis]
    if out_shape is not None:
        out_h, out_w = out_shape
        scale_h, scale_w = out_h / in_h, out_w / in_w
    else:
        if scale_factor is None:
            raise ValueError("imresize needs scale_factor or out_shape")
        out_h, out_w = math.ceil(in_h * scale_factor), math.ceil(in_w * scale_factor)
        scale_h = scale_w = scale_factor
    wh, ih = matlab_resize_plan(in_h, out_h, antialiasing, scale_h)
    ww, iw = matlab_resize_plan(in_w, out_w, antialiasing, scale_w)
    out = _apply_plan_axis(image, wh, ih, h_axis)
    return _apply_plan_axis(out, ww, iw, w_axis)


def _separable(image: torch.Tensor, plan, out_shape: tuple[int, int]) -> torch.Tensor:
    wh, ih = plan(image.shape[-3], out_shape[0])
    ww, iw = plan(image.shape[-2], out_shape[1])
    out = _apply_plan_axis(image, wh, ih, image.dim() - 3)
    return _apply_plan_axis(out, ww, iw, image.dim() - 2)


def _linear_plan(in_size: int, out_size: int):
    """cv2 INTER_LINEAR / torch bilinear align_corners=False."""
    d = np.arange(out_size, dtype=np.float64)
    src = np.clip((d + 0.5) * in_size / out_size - 0.5, 0, in_size - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_size - 1)
    frac = src - i0
    idx = np.stack([i0, i1], axis=1).astype(np.int32)
    w = np.stack([1.0 - frac, frac], axis=1).astype(np.float32)
    return w, idx


def resize_bilinear(image: torch.Tensor, out_shape: tuple[int, int]) -> torch.Tensor:
    """Separable bilinear resize, cv2 INTER_LINEAR (half-pixel centers)."""
    return _separable(image, _linear_plan, out_shape)


def _area_plan(in_size: int, out_size: int):
    """cv2 INTER_AREA (box average over the source footprint)."""
    scale = in_size / out_size
    starts = np.arange(out_size, dtype=np.float64) * scale
    ends = starts + scale
    p = int(math.ceil(scale)) + 1
    base = np.floor(starts).astype(np.int64)
    idx = base[:, None] + np.arange(p, dtype=np.int64)[None, :]
    left = np.maximum(idx.astype(np.float64), starts[:, None])
    right = np.minimum(idx + 1.0, ends[:, None])
    w = np.clip(right - left, 0.0, None) / scale
    idx = np.clip(idx, 0, in_size - 1)
    return w.astype(np.float32), idx.astype(np.int32)


def resize_area(image: torch.Tensor, out_shape: tuple[int, int]) -> torch.Tensor:
    """cv2 INTER_AREA-style resize (exact box filter when downscaling)."""
    return _separable(image, _area_plan, out_shape)


def _cubic_plan(in_size: int, out_size: int):
    """cv2 INTER_CUBIC (Keys a = -0.75, half-pixel centers, no antialias)."""
    d = np.arange(out_size, dtype=np.float64)
    src = (d + 0.5) * in_size / out_size - 0.5
    base = np.floor(src).astype(np.int64) - 1
    idx = base[:, None] + np.arange(4, dtype=np.int64)[None, :]
    t = src[:, None] - idx
    a = -0.75
    ax = np.abs(t)
    w = np.where(
        ax <= 1.0,
        (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0,
        np.where(ax < 2.0, a * ax**3 - 5.0 * a * ax**2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )
    w = w / np.sum(w, axis=1, keepdims=True)
    idx = np.clip(idx, 0, in_size - 1)
    return w.astype(np.float32), idx.astype(np.int32)


def resize_cubic(image: torch.Tensor, out_shape: tuple[int, int]) -> torch.Tensor:
    """cv2 INTER_CUBIC-style resize (a = -0.75 Keys kernel, no antialias)."""
    return _separable(image, _cubic_plan, out_shape)


def cv2_style_resize(
    image: torch.Tensor, out_shape: tuple[int, int], interpolation: int
) -> torch.Tensor:
    """Dispatch on the OpenCV flags the reference draws
    (``random.choice([1, 2, 3])``): 1 = linear, 2 = cubic, 3 = area."""
    if interpolation == 1:
        return resize_bilinear(image, out_shape)
    if interpolation == 2:
        return resize_cubic(image, out_shape)
    if interpolation == 3:
        return resize_area(image, out_shape)
    raise ValueError(f"unsupported interpolation flag {interpolation}")
