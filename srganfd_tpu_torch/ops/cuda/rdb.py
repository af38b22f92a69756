"""Residual Dense Block forward: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``srganfd_tpu/ops/pallas/rdb.py``. Both TPU entry points
(``rdb_forward_pallas`` with H tiles, ``rdb_forward_pallas_v2`` with whole
images per grid cell) compute one function; on Hopper one kernel,
``csrc/rdb.cu``, serves both, so the tiling arguments are gone.

- :func:`rdb_forward` launches the kernel for a CUDA tensor and takes the
  plain version for a CPU tensor; any other device raises. There is no
  fallback from a CUDA tensor to the plain version.
- :func:`rdb_forward_ref` is the plain version, with the kernel's rounding
  points (operands in x's dtype, f32 sums, ``out_k`` rounded to x's dtype,
  ``y * 0.2 + x`` in f32).
- :func:`rdb_apply` is the trainable RDB, a ``torch.autograd.Function``
  (the counterpart of the JAX ``rdb_apply`` custom VJP): its forward is
  :func:`rdb_forward`, the kernel on a CUDA tensor; it saves only x and
  the weights, and its backward recomputes :func:`rdb_forward_ref` and
  pulls the cotangent through it, as ``_rdb_apply_bwd``
  (``ops/pallas/rdb.py:163-166``) does through ``_rdb_xla``. The JAX
  package has no backward kernel, so neither has the port.
- ``launches`` counts kernel calls, one per RDB (the kernel itself makes
  five CUDA launches, one per conv).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from srganfd_tpu_torch.ops.cuda.build import load_library

__all__ = ["rdb_forward", "rdb_forward_ref", "rdb_apply", "pack_rdb_weights", "launches"]

launches = 0  # rdb_forward kernel calls in this process; reset by assigning 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib: ctypes.CDLL | None = None


def _conv_shapes(ch: int, gc: int) -> list[tuple[int, int, int, int]]:
    return [(3, 3, ch + k * gc, gc if k < 4 else ch) for k in range(5)]


def pack_rdb_weights(
    kernels: list[torch.Tensor], biases: list[torch.Tensor], dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """The five HWIO kernels as one flat tensor in the kernel's
    ``[cin][3*3][cout]`` order and x's dtype, and the five biases as one
    f32 tensor. Callers that run many times keep the result (see
    ``models.blocks.ResidualDenseBlock``)."""
    w = torch.cat([k.detach().permute(2, 0, 1, 3).reshape(-1) for k in kernels])
    b = torch.cat([b.detach().reshape(-1) for b in biases])
    return w.to(dtype).contiguous(), b.float().contiguous()


def rdb_forward_ref(
    x: torch.Tensor, kernels: list[torch.Tensor], biases: list[torch.Tensor]
) -> torch.Tensor:
    """Plain RDB forward. x: (N, H, W, ch); kernels[k]: (3, 3, ch + k*gc,
    gc|ch) HWIO; biases to match. Returns (N, H, W, ch) in x's dtype."""
    dt = x.dtype
    x32 = x.float().permute(0, 3, 1, 2)
    feats = [x32]
    y = x32
    for k in range(5):
        w = kernels[k].to(dt).float().permute(3, 2, 0, 1)
        y = F.conv2d(torch.cat(feats, 1), w, biases[k].float(), padding=1)
        if k < 4:
            feats.append(F.leaky_relu(y, 0.2).to(dt).float())
    return (y * 0.2 + x32).to(dt).permute(0, 2, 3, 1)


def _check(x, kernels, biases, w, b) -> tuple[int, int]:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, ch), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"rdb kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous NHWC and 16-byte aligned")
    ch, gc = x.shape[-1], kernels[0].shape[-1]
    if ch % 8 or gc % 8:
        raise ValueError(f"rdb kernel needs ch and gc multiples of 8, got {ch}, {gc}")
    if len(kernels) != 5 or len(biases) != 5:
        raise ValueError("an RDB has five convs")
    for k, (kern, bias, shape) in enumerate(zip(kernels, biases, _conv_shapes(ch, gc))):
        if tuple(kern.shape) != shape or tuple(bias.shape) != (shape[-1],):
            raise ValueError(
                f"conv{k}: kernel {tuple(kern.shape)} / bias {tuple(bias.shape)}, "
                f"expected {shape} / ({shape[-1]},)"
            )
    n_w = sum(s[0] * s[1] * s[2] * s[3] for s in _conv_shapes(ch, gc))
    n_b = 4 * gc + ch
    for name, t, dtype, numel in (("weights", w, x.dtype, n_w), ("biases", b, torch.float32, n_b)):
        if t.device != x.device or t.dtype != dtype or t.numel() != numel or not t.is_contiguous():
            raise ValueError(
                f"packed {name}: {t.dtype}[{t.numel()}] on {t.device}, "
                f"expected contiguous {dtype}[{numel}] on {x.device}"
            )
    return ch, gc


def rdb_forward(
    x: torch.Tensor,
    kernels: list[torch.Tensor],
    biases: list[torch.Tensor],
    packed: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Fused RDB forward, the signature of ``rdb_forward_pallas`` without
    the TPU tiling arguments. x: (N, H, W, ch) contiguous, f32 or bf16;
    kernels HWIO. ``packed`` is :func:`pack_rdb_weights` of the same
    weights, made once by the caller; without it the weights are packed
    on every call. The inference entry point; where grad mode is on and an
    input requires grad it goes through :func:`rdb_apply`, so the result
    is never silently cut from the graph."""
    global launches
    if torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in (*kernels, *biases))
    ):
        return rdb_apply(x, kernels, biases, packed)
    if x.device.type == "cpu":
        return rdb_forward_ref(x, kernels, biases)
    if x.device.type != "cuda":
        raise RuntimeError(f"rdb_forward runs on cuda or cpu tensors, got {x.device}")
    w, b = packed if packed is not None else pack_rdb_weights(kernels, biases, x.dtype)
    ch, gc = _check(x, kernels, biases, w, b)
    n, h, wd, _ = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    feat = torch.empty((n, h, wd, 4 * gc), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rdb_forward_cuda(
            x.data_ptr(), feat.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            n, h, wd, ch, gc, _DTYPE_CODES[x.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"rdb_forward_cuda failed: {lib.rdb_error_string(rc).decode()} ({rc})")
    launches += 1
    return out


class _RdbApply(torch.autograd.Function):
    """Kernel forward, backward by recomputing the plain version."""

    @staticmethod
    def forward(ctx, x, packed, *params):
        ctx.save_for_backward(x, *params)
        return rdb_forward(x, list(params[:5]), list(params[5:]), packed)

    @staticmethod
    def backward(ctx, grad):
        x, *params = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip([x, *params], ctx.needs_input_grad[:1] + ctx.needs_input_grad[2:])]
            y = rdb_forward_ref(inputs[0], inputs[1:6], inputs[6:])
            wanted = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(y, wanted, grad) if wanted else ())
        grads = [next(got) if t.requires_grad else None for t in inputs]
        return grads[0], None, *grads[1:]


def rdb_apply(
    x: torch.Tensor,
    kernels: list[torch.Tensor],
    biases: list[torch.Tensor],
    packed: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Trainable fused RDB, the arguments of :func:`rdb_forward`: the kernel
    (or, on the CPU, the plain version) forward; gradients for x, the five
    HWIO kernels and the five biases through the plain version, recomputed
    with the forward's rounding points (operands and ``out_k`` in x's
    dtype, f32 sums)."""
    return _RdbApply.apply(x, packed, *kernels, *biases)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library("rdb")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rdb_forward_cuda.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.rdb_forward_cuda.restype = i
        lib.rdb_error_string.argtypes = [i]
        lib.rdb_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
