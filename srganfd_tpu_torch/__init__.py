"""srganfd_tpu_torch: the PyTorch/CUDA port of ``srganfd_tpu``.

The JAX package stays the reference; this package imports none of it.
Each TPU kernel of the JAX package becomes a kernel written by hand for
Hopper (``csrc/``), built with nvcc on first use and bound through ctypes,
with a plain PyTorch version beside it that the CPU tests hold against
the JAX package. Entry points run on ``cuda`` unless the caller asks for
the CPU.

Ported so far: the RRDB generator family (``rrdbnet_x*``, ``bsrgan_x*``,
``bsrgansa_x2``) and the transformer-bottleneck ``bsrgantrans_x2``, served
through ``cli.serve`` (stdio and watch transports) and ``cli.infer``;
training of ``bsrgan_x2`` through ``cli.train --config bsrnet`` with the
BSRGAN degradation chain; the RDB, flash-attention and filter2d kernels
(``csrc/rdb.cu``, ``csrc/flash_attention.cu``, ``csrc/filter2d.cu``).
"""

__version__ = "0.1.0"
