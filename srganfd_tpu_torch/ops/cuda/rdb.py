"""Residual Dense Block forward: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``srganfd_tpu/ops/pallas/rdb.py``. Both TPU entry points
(``rdb_forward_pallas`` with H tiles, ``rdb_forward_pallas_v2`` with whole
images per grid cell) compute one function; on Hopper one source,
``csrc/rdb.cu``, serves both, so the tiling arguments are gone. Its conv
kernel is chosen by x's dtype; both run on the tensor cores as an implicit
GEMM over ``mma.sync``: bf16 directly, f32 as split-precision 3xTF32 (each
operand split into two TF32 halves, three products per pair).

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
- :func:`rdb_forward_op` is the custom op ``srganfd::rdb_forward``
  (``torch.library``) over :func:`rdb_forward`, with a fake (shape)
  implementation, so that ``torch.export`` keeps the ctypes launch, which
  it cannot trace, as one node of the exported program: on a CUDA tensor
  the op launches the kernel on the packed weights it is passed (the
  program's constants), on a CPU tensor it runs the plain version.
  Loading a program that holds it needs ``srganfd_tpu_torch`` imported.
- ``launches`` counts kernel calls, one per RDB (the kernel itself makes
  five CUDA launches, one per conv).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from srganfd_tpu_torch.ops.cuda.build import load_library

__all__ = [
    "lrelu", "rdb_forward", "rdb_forward_ref", "rdb_apply", "rdb_forward_op", "pack_rdb_weights", "tf32_round",
    "split_tf32", "launches",
]

launches = 0  # rdb_forward kernel calls in this process; reset by assigning 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib: ctypes.CDLL | None = None


def _conv_shapes(ch: int, gc: int) -> list[tuple[int, int, int, int]]:
    return [(3, 3, ch + k * gc, gc if k < 4 else ch) for k in range(5)]


_CHUNK = 16  # input channels per tensor-core k-step of the bf16 kernel
_F32_CHUNK = 8  # input channels per k-step of the f32 (3xTF32) kernel
_COUT_PAD = 16  # both kernels read couts in groups of 16


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 ``t`` rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero: ``cvt.rna.tf32.f32`` for finite values, and the
    integer form the f32 kernel computes (add half of the dropped 13 bits'
    range to the magnitude, then clear them). A NaN comes out as the NaN
    0x7fffe000, as the kernels' ``tf32_rna_nan`` gives it, where the carry
    would wrap one whose mantissa's top bits are all set (the card's own
    NaN is 0x7fffffff) to -0; Inf rounds to itself."""
    t = t.float().contiguous()
    rounded = (t.view(torch.int32) + 0x1000) & -0x2000
    return torch.where(torch.isnan(t), 0x7FFFE000, rounded).view(torch.float32)


def split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``t`` as hi + lo, both TF32: ``|t - hi - lo| <= 2^-22 |t|``."""
    hi = tf32_round(t)
    return hi, tf32_round(t.float() - hi)


def _pack_one(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One HWIO kernel in the order its conv reads it, the B fragments'
    order, with cout zero-padded to a multiple of 16. bf16:
    ``[cin/16][3*3][cout][16]``, cin zero-padded to a multiple of 16 (a
    half-filled last chunk reads zeros). f32: ``[cin/8][hi, lo][3*3][cout][8]``,
    the kernel split into its TF32 halves (:func:`split_tf32`)."""
    k = kernel.detach()
    cin, cout = k.shape[2], k.shape[3]
    cout_p = _round_up(cout, _COUT_PAD)
    if dtype != torch.bfloat16:
        cin_p = _round_up(cin, _F32_CHUNK)
        parts = torch.stack(split_tf32(F.pad(k.float(), (0, cout_p - cout, 0, cin_p - cin))))
        parts = parts.reshape(2, 9, cin_p // _F32_CHUNK, _F32_CHUNK, cout_p)
        return parts.permute(2, 0, 1, 4, 3).reshape(-1)
    cin_p = _round_up(cin, _CHUNK)
    k = F.pad(k.to(dtype), (0, cout_p - cout, 0, cin_p - cin))
    return k.reshape(9, cin_p // _CHUNK, _CHUNK, cout_p).permute(1, 0, 3, 2).reshape(-1)


def _packed_numel(ch: int, gc: int, dtype: torch.dtype) -> int:
    shapes = _conv_shapes(ch, gc)
    if dtype != torch.bfloat16:
        return sum(2 * 9 * _round_up(cin, _F32_CHUNK) * _round_up(cout, _COUT_PAD)
                   for _, _, cin, cout in shapes)
    return sum(9 * _round_up(cin, _CHUNK) * _round_up(cout, _COUT_PAD) for _, _, cin, cout in shapes)


def pack_rdb_weights(
    kernels: list[torch.Tensor], biases: list[torch.Tensor], dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """The five HWIO kernels as one flat tensor in x's dtype, each in the
    order the kernel for that dtype reads it (see :func:`_pack_one`), and
    the five biases as one f32 tensor. Callers that run many times keep the
    result (see ``models.blocks.ResidualDenseBlock``)."""
    w = torch.cat([_pack_one(k, dtype) for k in kernels])
    b = torch.cat([b.detach().reshape(-1) for b in biases])
    return w.contiguous(), b.float().contiguous()


def lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU 0.2 as the JAX package's (``jax.nn.leaky_relu``:
    ``where(x >= 0, x, 0.2 * x)``), whose derivative at an exactly-zero
    input is 1, where ``F.leaky_relu``'s is 0.2. The values are the same;
    the gradients differ where a layer sees an exactly-zero input, as a
    discriminator's first layers do on an all-zero (clamped) SR batch while
    their biases are still zero."""
    return torch.where(x >= 0, x, x * 0.2)


def rdb_forward_ref(
    x: torch.Tensor, kernels: list[torch.Tensor], biases: list[torch.Tensor]
) -> torch.Tensor:
    """Plain RDB forward. x: (N, H, W, ch); kernels[k]: (3, 3, ch + k*gc,
    gc|ch) HWIO; biases to match. Returns (N, H, W, ch) in x's dtype. Sums
    in f32 for f32 and bf16 x, in f64 for f64 x (the CPU-only dtype of
    lockstep parity tests; the kernel takes f32 and bf16)."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    x32 = x.to(acc).permute(0, 3, 1, 2)
    feats = [x32]
    y = x32
    for k in range(5):
        w = kernels[k].to(dt).to(acc).permute(3, 2, 0, 1)
        y = F.conv2d(torch.cat(feats, 1), w, biases[k].to(acc), padding=1)
        if k < 4:
            feats.append(lrelu(y).to(dt).to(acc))
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
    n_w = _packed_numel(ch, gc, x.dtype)
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


@torch.library.custom_op("srganfd::rdb_forward", mutates_args=())
def rdb_forward_op(
    x: torch.Tensor, kernels: list[torch.Tensor], biases: list[torch.Tensor], w_packed: torch.Tensor,
    b_packed: torch.Tensor,
) -> torch.Tensor:
    """:func:`rdb_forward` as an opaque op (inference only): the kernel on
    a CUDA tensor, with ``w_packed``/``b_packed`` the
    :func:`pack_rdb_weights` of the same weights for x's dtype (an exported
    program holds them as constants, packed once at export); the plain
    version, which reads the HWIO kernels, on a CPU tensor."""
    x = x.contiguous()
    if x.is_cuda:
        return rdb_forward(x, kernels, biases, (w_packed, b_packed))
    return rdb_forward(x, kernels, biases)


@rdb_forward_op.register_fake
def _(x: torch.Tensor, kernels: list[torch.Tensor], biases: list[torch.Tensor], w_packed: torch.Tensor,
      b_packed: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


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
