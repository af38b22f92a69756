"""PSNR / SSIM of the port (counterpart of ``srganfd_tpu/metrics/psnr_ssim.py``
``psnr_tensor``, ``ssim_tensor``, ``psnr``, ``ssim`` and the masked
``psnr_tensor_padded``/``ssim_tensor_padded`` that ``cli.test`` runs on
bucket-padded frames).

Parity target: the reference's torch ``PSNR``/``SSIM`` modules
(``ESRGAN/image_quality_assessment.py:361-541``): RGB [0,1] inputs (NHWC
here), optional border crop, optional Y-channel conversion, float64
accumulation in the x255 domain. Both of the reference's epsilon
conventions are kept: the tensor path adds 1e-8 to the MSE, the numpy path (``psnr``,
``ssim``: one BGR [0, 255] image) to the ratio inside the log. The JAX package
accumulates in float64 under ``jax_enable_x64``; the port always does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from srganfd_tpu_torch.ops import color

__all__ = ["gaussian_window", "psnr_tensor", "ssim_tensor", "psnr", "ssim", "psnr_tensor_padded",
           "ssim_tensor_padded"]


def gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel outer product (the SSIM window)."""
    i = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((i - (window_size - 1) / 2.0) ** 2) / (2.0 * sigma * sigma))
    g /= g.sum()
    return np.outer(g, g)


def _crop_border(x: torch.Tensor, border: int) -> torch.Tensor:
    if border > 0:
        return x[..., border:-border, border:-border, :]
    return x


def _prepare(raw: torch.Tensor, dst: torch.Tensor, crop_border: int, y_only: bool):
    raw, dst = _crop_border(raw, crop_border), _crop_border(dst, crop_border)
    if y_only:
        raw, dst = color.rgb_to_y(raw), color.rgb_to_y(dst)
    return raw.double(), dst.double()


def psnr_tensor(
    raw: torch.Tensor, dst: torch.Tensor, crop_border: int = 0, only_test_y_channel: bool = True
) -> torch.Tensor:
    """Batched PSNR over NHWC RGB [0,1] images -> (N,) float64
    (``_psnr_torch``, ``ESRGAN/image_quality_assessment.py:361-396``)."""
    raw, dst = _prepare(raw, dst, crop_border, only_test_y_channel)
    mse = ((raw * 255.0 - dst * 255.0) ** 2).mean(dim=(1, 2, 3)) + 1e-8
    return 10.0 * torch.log10(255.0**2 / mse)


def _valid_gauss_filter(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Per-channel valid convolution with the SSIM window; NHWC in and out."""
    c = x.shape[-1]
    weight = window.to(x.dtype)[None, None].expand(c, 1, *window.shape).contiguous()
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, groups=c)
    return out.permute(0, 2, 3, 1)


def _ssim_map_x255(raw: torch.Tensor, dst: torch.Tensor, window_size: int,
                   gaussian_sigma: float) -> torch.Tensor:
    """The SSIM map of float64 NHWC images in the x255 domain, (N, H - win
    + 1, W - win + 1, C): valid-conv Gaussian window, c1/c2 =
    (0.01*255)^2 / (0.03*255)^2."""
    c1 = (0.01 * 255.0) ** 2
    c2 = (0.03 * 255.0) ** 2
    window = torch.from_numpy(gaussian_window(window_size, gaussian_sigma)).to(raw.device)
    mu_r = _valid_gauss_filter(raw, window)
    mu_d = _valid_gauss_filter(dst, window)
    mu_r2, mu_d2, mu_rd = mu_r * mu_r, mu_d * mu_d, mu_r * mu_d
    var_r = _valid_gauss_filter(raw * raw, window) - mu_r2
    var_d = _valid_gauss_filter(dst * dst, window) - mu_d2
    cov = _valid_gauss_filter(raw * dst, window) - mu_rd
    num = (2.0 * mu_rd + c1) * (2.0 * cov + c2)
    den = (mu_r2 + mu_d2 + c1) * (var_r + var_d + c2)
    return num / den


def _ssim_x255(raw: torch.Tensor, dst: torch.Tensor, window_size: int,
               gaussian_sigma: float) -> torch.Tensor:
    """(N,) SSIM of float64 NHWC images in the x255 domain."""
    return _ssim_map_x255(raw, dst, window_size, gaussian_sigma).mean(dim=(1, 2, 3))


def ssim_tensor(
    raw: torch.Tensor,
    dst: torch.Tensor,
    crop_border: int = 0,
    only_test_y_channel: bool = True,
    window_size: int = 11,
    gaussian_sigma: float = 1.5,
) -> torch.Tensor:
    """Batched SSIM over NHWC RGB [0,1] images -> (N,) float32
    (``_ssim_torch``, ``ESRGAN/image_quality_assessment.py:421-505``),
    computed in float64."""
    raw, dst = _prepare(raw, dst, crop_border, only_test_y_channel)
    return _ssim_x255(raw * 255.0, dst * 255.0, window_size, gaussian_sigma).float()


# masked variants: the metrics over the top-left (h, w) valid region of
# bucket-padded images, equal to the unpadded ones on the cropped images
# (the Y conversion is pointwise; a valid-conv window inside the mask sees
# valid pixels only)


def _region_mask(valid_hw: torch.Tensor, height: int, width: int, border: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """(N, H, W) 0/1 mask of the rows and columns in [border, valid - border)."""
    valid_hw = valid_hw.to(torch.int64)
    rows = torch.arange(height, device=valid_hw.device)[None, :]
    cols = torch.arange(width, device=valid_hw.device)[None, :]
    ok_r = (rows >= border) & (rows < valid_hw[:, 0:1] - border)
    ok_c = (cols >= border) & (cols < valid_hw[:, 1:2] - border)
    return (ok_r[:, :, None] & ok_c[:, None, :]).to(dtype)


def psnr_tensor_padded(
    raw: torch.Tensor, dst: torch.Tensor, valid_hw: torch.Tensor, crop_border: int = 0,
    only_test_y_channel: bool = True,
) -> torch.Tensor:
    """PSNR over the valid region of padded NHWC images -> (N,) float64.
    ``valid_hw``: (N, 2) integer (h, w) of each image; equals
    ``psnr_tensor(raw[:, :h, :w], dst[:, :h, :w], ...)``."""
    if only_test_y_channel:
        raw, dst = color.rgb_to_y(raw), color.rgb_to_y(dst)
    raw, dst = raw.double(), dst.double()
    mask = _region_mask(valid_hw.to(raw.device), raw.shape[1], raw.shape[2], crop_border, raw.dtype)[..., None]
    err = ((raw - dst) * 255.0) ** 2 * mask
    count = mask.sum(dim=(1, 2, 3)) * raw.shape[-1]
    mse = err.sum(dim=(1, 2, 3)) / count + 1e-8
    return 10.0 * torch.log10(255.0**2 / mse)


def ssim_tensor_padded(
    raw: torch.Tensor, dst: torch.Tensor, valid_hw: torch.Tensor, crop_border: int = 0,
    only_test_y_channel: bool = True, window_size: int = 11, gaussian_sigma: float = 1.5,
) -> torch.Tensor:
    """SSIM over the valid region of padded NHWC images -> (N,) float32: the
    SSIM map of the whole padded image, averaged over the window positions
    i with ``border <= i < h - border - window_size + 1`` (each axis), the
    unpadded kernel's outputs."""
    if only_test_y_channel:
        raw, dst = color.rgb_to_y(raw), color.rgb_to_y(dst)
    raw, dst = raw.double() * 255.0, dst.double() * 255.0
    ssim_map = _ssim_map_x255(raw, dst, window_size, gaussian_sigma)
    win_hw = valid_hw.to(raw.device).to(torch.int64) - (window_size - 1)
    mask = _region_mask(win_hw, ssim_map.shape[1], ssim_map.shape[2], crop_border, ssim_map.dtype)[..., None]
    count = mask.sum(dim=(1, 2, 3)) * ssim_map.shape[-1]
    return ((ssim_map * mask).sum(dim=(1, 2, 3)) / count).float()


# the reference's numpy convention: one BGR [0, 255] HWC image


def _numpy_prepare(raw: np.ndarray, dst: np.ndarray, crop_border: int, y_only: bool):
    if crop_border > 0:
        raw = raw[crop_border:-crop_border, crop_border:-crop_border, ...]
        dst = dst[crop_border:-crop_border, crop_border:-crop_border, ...]
    if y_only:  # imgproc.expand_y: the Y of BGR in [0, 255], float64

        def expand_y(image: np.ndarray) -> np.ndarray:
            x = torch.from_numpy(image.astype(np.float32) / 255.0)
            return color.bgr_to_ycbcr(x, only_use_y_channel=True).double().numpy() * 255.0

        raw, dst = expand_y(raw), expand_y(dst)
    return raw.astype(np.float64), dst.astype(np.float64)


def psnr(raw_image: np.ndarray, dst_image: np.ndarray, crop_border: int,
         only_test_y_channel: bool) -> float:
    """BGR [0,255] HWC single-image PSNR (``ESRGAN/image_quality_assessment.py:60-93``):
    this convention adds 1e-8 to the ratio inside the log, not to the MSE."""
    raw, dst = _numpy_prepare(raw_image, dst_image, crop_border, only_test_y_channel)
    return float(10.0 * np.log10(255.0**2 / np.mean((raw - dst) ** 2) + 1e-8))


def ssim(raw_image: np.ndarray, dst_image: np.ndarray, crop_border: int,
         only_test_y_channel: bool) -> float:
    """BGR [0,255] HWC single-image SSIM, the mean of the per-channel SSIMs
    (``ESRGAN/image_quality_assessment.py:96-166``)."""
    raw, dst = _numpy_prepare(raw_image, dst_image, crop_border, only_test_y_channel)
    r, d = torch.from_numpy(raw)[None], torch.from_numpy(dst)[None]
    vals = [_ssim_x255(r[..., c:c + 1], d[..., c:c + 1], 11, 1.5).item() for c in range(r.shape[-1])]
    return float(np.mean(vals))
