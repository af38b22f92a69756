"""Resampling ops of the port (counterpart of ``srganfd_tpu/ops/resize.py``).

Only what the generators use so far: the integer-factor nearest upsample.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["upsample_nearest"]


def upsample_nearest(image: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor nearest upsample of an NCHW tensor (the models' inner
    layout; the JAX op takes NHWC). Output pixel (y, x) copies input pixel
    (y // factor, x // factor), as torch ``F.interpolate`` nearest does;
    the memory format (channels_last) is kept."""
    return F.interpolate(image, scale_factor=factor, mode="nearest")
