"""Post-training int8 quantization for generator serving (counterpart of
``srganfd_tpu/ops/quant.py``, operation for operation).

Symmetric PTQ of the RDB trunk (``--quant-int8``):

- weights: per-output-channel int8, scale = absmax / 127 over the
  (kh, kw, cin) fan-in;
- activations: dynamic per-tensor int8, the scale from the live tensor's
  absmax.

The conv sums exactly in int32 (``ops/cuda/qconv.py``: the hand-written
s8 tensor-core kernel on the card, an exact float64 conv on the CPU);
the only error is the two quantization roundings. Only the trunk is
quantized; the head, upsampling and tail convs stay in the compute
dtype. The PSNR cost is a fact of the workload, to be measured on it.
"""

from __future__ import annotations

import torch

from srganfd_tpu_torch.ops.cuda.qconv import qconv3x3

__all__ = ["quantize_symmetric", "dequantize", "qconv2d", "qconv2d_prequantized"]

_EPS = 1e-12


def quantize_symmetric(x: torch.Tensor, channel_axis: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)`` with ``q = clip(round(x / scale), -127, 127)`` int8 and
    ``scale = max(absmax, 1e-12) / 127`` in f32 (a division, as ``jnp``
    computes it; ``torch.round`` rounds half to even, as ``jnp.round``).

    ``channel_axis=None`` gives one per-tensor scale (shape ``()``);
    otherwise one scale per index of ``channel_axis``, the other axes kept
    at size 1 so that ``q * scale`` broadcasts back."""
    xf = x.float()
    if channel_axis is None:
        absmax = xf.abs().amax()
    else:
        axes = tuple(a for a in range(x.dim()) if a != channel_axis % x.dim())
        absmax = xf.abs().amax(dim=axes, keepdim=True)
    scale = torch.maximum(absmax, torch.tensor(_EPS, dtype=torch.float32, device=x.device)) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_symmetric` (up to rounding)."""
    return q.float() * scale


def qconv2d_prequantized(
    x: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor, packed: torch.Tensor | None = None
) -> torch.Tensor:
    """:func:`qconv2d` with the kernel already quantized (``kq`` int8 HWIO,
    ``ks`` its (cout,) scales) and, for the card, packed: x is quantized
    per tensor on the fly, the conv sums in int32 and the output is
    ``sums.float() * (xs * ks)`` in f32."""
    xq, xs = quantize_symmetric(x)
    return qconv3x3(xq.contiguous(), kq, (xs * ks).contiguous(), packed)


def qconv2d(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """int8 x int8 -> int32 3x3 'same' convolution with f32 dequantized
    output. ``x``: NHWC activations (any float dtype), quantized per tensor;
    ``kernel``: HWIO f32 weights, quantized per output channel. Stride 1
    and padding 1 only: the trunk's convs."""
    if stride != 1 or padding != 1 or tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError(f"qconv2d takes 3x3 kernels at stride 1, padding 1; got {tuple(kernel.shape[:2])}, "
                         f"stride {stride}, padding {padding}")
    kq, ks = quantize_symmetric(kernel, channel_axis=3)
    return qconv2d_prequantized(x, kq, ks.reshape(-1))
