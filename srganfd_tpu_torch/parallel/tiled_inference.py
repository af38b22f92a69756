"""Tiled large-image inference (counterpart of
``srganfd_tpu/parallel/tiled_inference.py``, without the device mesh).

Splits an image into overlapping tiles, SRs them in batches and blends the
overlaps with linear feathering. With overlap >= the network's effective
receptive radius the result is exact; smaller overlaps give feathered
seams.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

__all__ = ["tiled_sr"]


def _feather_weights(tile_h: int, tile_w: int, overlap: int) -> np.ndarray:
    """Linear blend ramp over the overlap margins."""
    ramp = lambda n: np.minimum(np.arange(n) + 1, overlap + 1) / (overlap + 1)
    wy = np.minimum(ramp(tile_h), ramp(tile_h)[::-1])
    wx = np.minimum(ramp(tile_w), ramp(tile_w)[::-1])
    return (wy[:, None] * wx[None, :]).astype(np.float32)


def tiled_sr(
    apply_fn: Callable[[np.ndarray], np.ndarray],
    image: np.ndarray,
    upscale_factor: int,
    tile: int = 128,
    overlap: int = 16,
    batch_size: int = 8,
) -> np.ndarray:
    """SR one large HWC [0,1] image by overlapping tiles.

    ``apply_fn(lr_batch) -> sr_batch`` maps an (N, H, W, C) float32 array
    to (N, sH, sW, C). The last batch is padded to ``batch_size`` by
    repeating its last tile, so every call sees one shape.
    """
    h, w, c = image.shape
    stride = tile - 2 * overlap
    if stride <= 0:
        raise ValueError("tile must exceed 2*overlap")
    ny = max(1, math.ceil((h - 2 * overlap) / stride))
    nx = max(1, math.ceil((w - 2 * overlap) / stride))

    # reflect-pad so every tile is full size
    pad_h = (ny - 1) * stride + tile - h
    pad_w = (nx - 1) * stride + tile - w
    padded = np.pad(image, ((0, max(pad_h, 0)), (0, max(pad_w, 0)), (0, 0)), mode="reflect")

    coords = [(iy * stride, ix * stride) for iy in range(ny) for ix in range(nx)]
    tiles = np.stack([padded[y : y + tile, x : x + tile] for y, x in coords])

    sf = upscale_factor
    out = np.zeros((padded.shape[0] * sf, padded.shape[1] * sf, c), np.float32)
    acc = np.zeros(out.shape[:2], np.float32)
    weights = _feather_weights(tile * sf, tile * sf, overlap * sf)

    for start in range(0, len(tiles), batch_size):
        chunk = tiles[start : start + batch_size]
        real = len(chunk)
        if real < batch_size:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch_size - real, axis=0)])
        sr = np.asarray(apply_fn(chunk))[:real]
        for j, (y, x) in enumerate(coords[start : start + real]):
            oy, ox = y * sf, x * sf
            out[oy : oy + tile * sf, ox : ox + tile * sf] += sr[j] * weights[..., None]
            acc[oy : oy + tile * sf, ox : ox + tile * sf] += weights
    out /= np.maximum(acc, 1e-8)[..., None]
    return out[: h * sf, : w * sf]
