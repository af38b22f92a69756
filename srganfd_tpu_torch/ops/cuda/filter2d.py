"""Per-sample 2-D filtering: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``srganfd_tpu/ops/pallas/filter2d.py`` (``filter2d_pallas``),
which computes ``ops.filters.filter2d``: one K x K kernel per batch element,
reflect-101 borders, f32 products and sums, a correlation (the kernel is not
flipped).

- :func:`filter2d` launches ``csrc/filter2d.cu`` for a CUDA tensor and takes
  the plain version for a CPU tensor; any other device raises. There is no
  fallback from a CUDA tensor to the plain version.
- :func:`filter2d_ref` is the plain version: ``F.pad(mode="reflect")`` and
  one grouped conv with the batch folded into channels, the literal form of
  the JAX ``filter2d_depthwise``.
- ``launches`` counts kernel calls.

No gradient: the degradation chain is not differentiated.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from srganfd_tpu_torch.ops.cuda.build import load_library

__all__ = ["filter2d", "filter2d_ref", "launches", "KMAX"]

launches = 0  # filter2d kernel calls in this process; reset by assigning 0

KMAX = 31  # the largest K the kernel is instantiated for
_lib: ctypes.CDLL | None = None


def _check_shapes(images: torch.Tensor, kernels: torch.Tensor) -> int:
    if images.dim() != 4 or kernels.dim() != 3:
        raise ValueError(
            f"images must be (N, H, W, C) and kernels (N, K, K), got "
            f"{tuple(images.shape)} and {tuple(kernels.shape)}"
        )
    n, h, w, _ = images.shape
    k = kernels.shape[-1]
    if kernels.shape != (n, k, k) or k % 2 == 0:
        raise ValueError(f"kernels must be (N, K, K) with K odd for N = {n}, got {tuple(kernels.shape)}")
    if k // 2 >= h or k // 2 >= w:
        raise ValueError(f"reflect padding by {k // 2} needs H and W above it, got {h}x{w}")
    return k


def filter2d_ref(images: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Plain version. images: (N, H, W, C); kernels: (N, K, K), K odd.
    Returns (N, H, W, C) in images' dtype, computed in f32."""
    k = _check_shapes(images, kernels)
    n, h, w, c = images.shape
    pad = k // 2
    x = images.float().permute(0, 3, 1, 2).reshape(1, n * c, h, w)
    x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    weight = kernels.float().repeat_interleave(c, dim=0)[:, None]  # (N*C, 1, K, K)
    out = F.conv2d(x, weight, groups=n * c)
    return out.reshape(n, c, h, w).permute(0, 2, 3, 1).to(images.dtype)


def filter2d(images: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """``filter2d_pallas(images, kernels)`` without the interpret flag:
    images (N, H, W, C) f32, kernels (N, K, K) f32 with K odd and
    K // 2 < H, W. Returns (N, H, W, C) f32."""
    global launches
    if images.device.type == "cpu":
        return filter2d_ref(images, kernels)
    if images.device.type != "cuda":
        raise RuntimeError(f"filter2d runs on cuda or cpu tensors, got {images.device}")
    k = _check_shapes(images, kernels)
    if images.dtype != torch.float32 or kernels.dtype != torch.float32:
        raise TypeError(f"filter2d kernel takes float32, got {images.dtype} and {kernels.dtype}")
    if kernels.device != images.device:
        raise ValueError(f"kernels on {kernels.device}, images on {images.device}")
    if k > KMAX:
        raise ValueError(f"filter2d kernel takes K <= {KMAX}, got {k}")
    images, kernels = images.contiguous(), kernels.contiguous()
    out = torch.empty_like(images)
    if out.numel() == 0:
        return out
    n, h, w, c = images.shape
    lib = _library()
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        rc = lib.filter2d_cuda(
            images.data_ptr(), kernels.data_ptr(), out.data_ptr(), n, h, w, c, k, stream
        )
    if rc != 0:
        raise RuntimeError(f"filter2d_cuda failed: {lib.filter2d_error_string(rc).decode()} ({rc})")
    launches += 1
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library("filter2d")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.filter2d_cuda.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.filter2d_cuda.restype = i
        lib.filter2d_error_string.argtypes = [i]
        lib.filter2d_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
