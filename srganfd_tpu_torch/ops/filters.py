"""Batched image filtering with per-sample kernels, NHWC (counterpart of
``srganfd_tpu/ops/filters.py`` ``filter2d``).

``filter2d`` is the blur of the BSRGAN degradation chain: one K x K kernel
per batch element, reflect-101 borders, f32 products and sums. On a CUDA
tensor it is the hand-written kernel of ``ops/cuda/filter2d.py``; on a CPU
tensor its plain version. The chain calls ``filters.filter2d`` through this
module, so both of its blur slots reach the kernel.
"""

from __future__ import annotations

from srganfd_tpu_torch.ops.cuda.filter2d import filter2d, filter2d_ref

__all__ = ["filter2d", "filter2d_ref"]
