"""int8 3x3 'same' convolution: the hand-written CUDA kernel and its plain
PyTorch version.

The JAX package's int8 serving path (``srganfd_tpu/ops/quant.py``
``qconv2d``) is an XLA convolution of s8 operands with s32 sums; it has
no Pallas kernel. PyTorch's convolutions take no int8 tensors on CUDA, so
the port runs it through ``csrc/qconv.cu``, ``mma.sync`` on s8 operands
over the staging of the bf16 RDB kernel.

- :func:`qconv3x3` launches the kernel for CUDA tensors and takes the
  plain version for CPU tensors; any other device raises. There is no
  fallback from a CUDA tensor to the plain version.
- :func:`qconv3x3_ref` is the plain version: ``F.conv2d`` in float64 on
  the integer-valued tensors, exact (every sum is below 127^2 * 9 * cin
  < 2^53), cast to int32, then ``(float)acc * scale`` in f32.
- :func:`pack_qconv_weights` lays an int8 HWIO kernel out as the kernel
  reads it, ``[cin/32][tap][cout_pad][32]`` (cout zero-padded to 16).
- ``launches`` counts kernel calls.

x is NHWC int8 with ``cin`` a multiple of 32 (ch 64 and gc 32 in every
arch); cout a multiple of 8. The result is f32 ``(N, H, W, cout)``, or the
int32 sums when ``scale`` is None.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from srganfd_tpu_torch.ops.cuda.build import load_library

__all__ = ["CIN_MULTIPLE", "qconv3x3", "qconv3x3_ref", "pack_qconv_weights", "launches"]

launches = 0  # qconv3x3 kernel calls in this process; reset by assigning 0

CIN_MULTIPLE = 32  # int8 input channels per tensor-core k-step
_COUT_PAD = 16
_lib: ctypes.CDLL | None = None


def pack_qconv_weights(kq: torch.Tensor) -> torch.Tensor:
    """An int8 HWIO (3, 3, cin, cout) kernel as the kernel reads it:
    ``[cin/32][3*3][cout_pad][32]``, cout zero-padded to a multiple of 16;
    flat and contiguous."""
    if kq.dtype != torch.int8 or kq.dim() != 4 or kq.shape[:2] != (3, 3):
        raise ValueError(f"expected an int8 (3, 3, cin, cout) kernel, got {kq.dtype} {tuple(kq.shape)}")
    cin, cout = kq.shape[2], kq.shape[3]
    if cin % CIN_MULTIPLE:
        raise ValueError(f"qconv kernel needs cin a multiple of {CIN_MULTIPLE}, got {cin}")
    cout_p = -(-cout // _COUT_PAD) * _COUT_PAD
    k = F.pad(kq, (0, cout_p - cout))
    return k.reshape(9, cin // CIN_MULTIPLE, CIN_MULTIPLE, cout_p).permute(1, 0, 3, 2).contiguous().reshape(-1)


def qconv3x3_ref(xq: torch.Tensor, kq: torch.Tensor, scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version. xq: (N, H, W, cin) int8; kq: (3, 3, cin, cout) int8
    HWIO. The exact int32 sums, or ``sums.float() * scale`` (f32) with
    ``scale`` a (cout,) f32 tensor."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(), kq.permute(3, 2, 0, 1).double(), padding=1)
    acc = y.permute(0, 2, 3, 1).to(torch.int32)
    return acc if scale is None else acc.float() * scale


def _check(xq: torch.Tensor, kq: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None) -> None:
    if xq.dim() != 4 or xq.dtype != torch.int8:
        raise TypeError(f"qconv kernel takes x as (N, H, W, cin) int8, got {xq.dtype} {tuple(xq.shape)}")
    cin, cout = xq.shape[-1], kq.shape[-1]
    if cin % CIN_MULTIPLE:
        raise ValueError(f"qconv kernel needs cin a multiple of {CIN_MULTIPLE}, got {cin}")
    if cout % 8:
        raise ValueError(f"qconv kernel needs cout a multiple of 8, got {cout}")
    if tuple(kq.shape) != (3, 3, cin, cout) or kq.dtype != torch.int8:
        raise ValueError(f"kernel {kq.dtype} {tuple(kq.shape)}, expected int8 (3, 3, {cin}, {cout})")
    if not xq.is_contiguous() or xq.data_ptr() % 16:
        raise ValueError("x must be contiguous NHWC and 16-byte aligned")
    numel = 9 * cin * (-(-cout // _COUT_PAD) * _COUT_PAD)
    if w.device != xq.device or w.dtype != torch.int8 or w.numel() != numel or not w.is_contiguous():
        raise ValueError(f"packed weights: {w.dtype}[{w.numel()}] on {w.device}, expected contiguous "
                         f"int8[{numel}] on {xq.device}")
    if scale is not None and (scale.device != xq.device or scale.dtype != torch.float32
                              or tuple(scale.shape) != (cout,) or not scale.is_contiguous()):
        raise ValueError(f"scale: {scale.dtype} {tuple(scale.shape)} on {scale.device}, expected "
                         f"contiguous float32 ({cout},) on {xq.device}")


def qconv3x3(
    xq: torch.Tensor,
    kq: torch.Tensor,
    scale: torch.Tensor | None = None,
    packed: torch.Tensor | None = None,
) -> torch.Tensor:
    """int8 3x3 'same' conv of ``xq`` (N, H, W, cin) by the HWIO ``kq``;
    f32 ``(float)sums * scale`` per output channel, or the int32 sums when
    ``scale`` is None. ``packed`` is :func:`pack_qconv_weights` of ``kq``,
    made once by a caller that runs many times; without it the weights
    are packed on every call."""
    global launches
    if xq.device.type == "cpu":
        return qconv3x3_ref(xq, kq, scale)
    if xq.device.type != "cuda":
        raise RuntimeError(f"qconv3x3 runs on cuda or cpu tensors, got {xq.device}")
    w = packed if packed is not None else pack_qconv_weights(kq)
    _check(xq, kq, w, scale)
    n, h, wd, cin = xq.shape
    cout = kq.shape[-1]
    out = torch.empty((n, h, wd, cout), dtype=torch.int32 if scale is None else torch.float32, device=xq.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        rc = lib.qconv3x3_s8_cuda(xq.data_ptr(), w.data_ptr(), None if scale is None else scale.data_ptr(),
                                  out.data_ptr(), n, h, wd, cin, cout, stream)
    if rc != 0:
        raise RuntimeError(f"qconv3x3_s8_cuda failed: {lib.qconv_error_string(rc).decode()} ({rc})")
    launches += 1
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library("qconv")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qconv3x3_s8_cuda.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.qconv3x3_s8_cuda.restype = i
        lib.qconv_error_string.argtypes = [i]
        lib.qconv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
