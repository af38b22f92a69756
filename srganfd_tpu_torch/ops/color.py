"""MATLAB-convention RGB -> YCbCr (BT.601) for the metrics (counterpart of
``srganfd_tpu/ops/color.py`` ``rgb_to_ycbcr``, ``bgr_to_ycbcr`` and
``rgb_to_y``).

Channel-last float images in [0, 1] in, [0, 1]-scaled out, computed in f32
and returned in the input's dtype (``ESRGAN/imgproc.py:291-462``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["rgb_to_ycbcr", "bgr_to_ycbcr", "rgb_to_y"]

# MATLAB rgb2ycbcr: Y/Cb/Cr = M @ rgb*255 + [16, 128, 128]
_RGB2YCBCR = np.array(
    [[65.481, -37.797, 112.0],
     [128.553, -74.203, -93.786],
     [24.966, 112.0, -18.214]],
    dtype=np.float32,
)
_YCBCR_BIAS = np.array([16.0, 128.0, 128.0], dtype=np.float32)


def rgb_to_ycbcr(image: torch.Tensor, only_use_y_channel: bool = False) -> torch.Tensor:
    """RGB [0,1] -> YCbCr [0,1] (MATLAB constants). With
    ``only_use_y_channel`` the channel axis collapses to size 1."""
    x = image.float()
    m = torch.from_numpy(_RGB2YCBCR).to(x.device)
    if only_use_y_channel:
        out = x @ m[:, :1] + 16.0
    else:
        out = x @ m + torch.from_numpy(_YCBCR_BIAS).to(x.device)
    return (out / 255.0).to(image.dtype)


def bgr_to_ycbcr(image: torch.Tensor, only_use_y_channel: bool = False) -> torch.Tensor:
    """BGR [0,1] -> YCbCr [0,1]: the same matrix on the flipped channels."""
    return rgb_to_ycbcr(image.flip(-1), only_use_y_channel)


def rgb_to_y(image: torch.Tensor) -> torch.Tensor:
    """Y channel only, keeping a size-1 channel axis (the reference's
    ``only_use_y_channel=True`` path of Y-channel PSNR/SSIM)."""
    return rgb_to_ycbcr(image, only_use_y_channel=True)
