"""Batched image filtering, NHWC (counterpart of ``srganfd_tpu/ops/filters.py``
``filter2d`` and ``blur_separable``).

``filter2d`` is the per-sample blur of the degradation chains: one K x K
kernel per batch element, reflect-101 borders, f32 products and sums. On a
CUDA tensor it is the hand-written kernel of ``ops/cuda/filter2d.py``; on a
CPU tensor its plain version. The chains call ``filters.filter2d`` through
this module, so every blur slot reaches the kernel.

``blur_separable`` is the shared-kernel Gaussian of Real-ESRGAN's USM
sharpening: two f32 matrix products against one banded matrix, as the JAX
package computes it with two XLA GEMMs at ``Precision.HIGHEST`` (no Pallas
kernel). It refuses to run where float32 matmuls may take TF32: USM's hard
mask ``|residual| * 255 > 10`` would move on pixels near the threshold.
"""

from __future__ import annotations

import torch

from srganfd_tpu_torch.ops.cuda.filter2d import filter2d, filter2d_ref, reflect_pad

__all__ = ["filter2d", "filter2d_ref", "blur_separable"]


def _shared_banded(k1d: torch.Tensor, out_len: int) -> torch.Tensor:
    """(L + K - 1, L) banded matrix shared by all samples: B[p, h] =
    k1d[p - h] for 0 <= p - h < K, zero outside the band."""
    k = k1d.shape[0]
    idx = torch.arange(out_len + k - 1, device=k1d.device)[:, None] - torch.arange(
        out_len, device=k1d.device)[None, :]
    valid = (idx >= 0) & (idx < k)
    return torch.where(valid, k1d[idx.clamp(0, k - 1)], torch.zeros((), dtype=k1d.dtype, device=k1d.device))


def blur_separable(images: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Blur (N, H, W, C) by ``outer(k1d, k1d)`` with reflect-101 borders
    (any H and W, as ``filter2d`` pads):
    a contraction along H, then along W, each against one shared banded
    matrix, in f32. ``k1d`` (K,), K odd. Returns images' dtype."""
    if images.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "blur_separable needs full-f32 matmuls: float32 matmul precision is "
            f"{torch.get_float32_matmul_precision()!r} (TF32 would move USM's mask)"
        )
    n, h, w, c = images.shape
    pad = k1d.shape[0] // 2
    k1d = k1d.to(images.device, torch.float32)
    x = reflect_pad(images.float(), pad, (1, 2))
    y = torch.einsum("ph,npqc->nhqc", _shared_banded(k1d, h), x)
    y = torch.einsum("qw,nhqc->nhwc", _shared_banded(k1d, w), y)
    return y.to(images.dtype)
