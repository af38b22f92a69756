"""srganfd_tpu_torch: the PyTorch/CUDA port of ``srganfd_tpu``.

The JAX package stays the reference; this package imports none of it.
Each TPU kernel of the JAX package becomes a kernel written by hand for
Hopper (``csrc/``), built with nvcc on first use and bound through ctypes,
with a plain PyTorch version beside it that the CPU tests hold against
the JAX package. Entry points run on ``cuda`` unless the caller asks for
the CPU.

Ported: every arch, config and single-device entry point of the JAX
package (``cli.train``, ``cli.test``, ``cli.infer``, ``cli.serve`` with its
stdio, watch and HTTP transports and ``--quant-int8``, ``cli.export``,
``cli.summary``, ``cli.test_degradations``, ``cli.prepare_dataset``,
``cli.split_dataset``), on four kernels: the RDB, flash attention,
filter2d and the int8 serving path's s8 conv (``csrc/rdb.cu``,
``csrc/flash_attention.cu``, ``csrc/filter2d.cu``, ``csrc/qconv.cu``).
Not ported: the multi-device modes (``parallel/`` but tiled inference) and
the native loader.
"""

__version__ = "0.1.0"
