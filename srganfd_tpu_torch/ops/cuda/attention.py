"""Flash (online-softmax) attention: the hand-written CUDA forward, its
backward, and its plain PyTorch version.

Counterpart of ``srganfd_tpu/ops/pallas/attention.py``. The TPU kernel
(``_flash_forward``) folds (batch, heads), pads T to its blocks and walks
the K blocks on a sequential grid axis; on Hopper ``csrc/flash_attention.cu``
computes the same function with a loop over K tiles inside each block,
reads (N, T, H, D) through strides and masks the ragged tiles itself, so
the block sizes and the padding copies are gone. The kernel is chosen by
dtype; both run on the tensor cores. bf16: ``wgmma`` with K and V brought
in by tensor-map boxes from a producer warp, P split into two bf16 halves
in registers and the normaliser taken by the same products from a block of
ones beside V. f32: ``mma.sync`` as split-precision 3xTF32 (every operand
split into two TF32 halves, three products per pair).

- :func:`flash_attention` launches the kernel for a CUDA tensor and takes
  the plain version for a CPU tensor; any other device raises. There is no
  fallback from a CUDA tensor to the plain version. It is an
  ``autograd.Function`` that saves only q, k and v: its backward is the
  JAX ``_flash_bwd`` (``srganfd_tpu/ops/pallas/attention.py:164-187``), exact
  attention recomputed in f32 query block by query block, each block
  differentiated on its own so that O(block_q * T) scores live at a time,
  the gradients in q's dtype. The JAX backward is XLA, not Pallas; so is
  this one PyTorch (a hand-written backward kernel is ROADMAP.md B4).
- :func:`flash_attention_ref` is the plain version: exact attention in
  query chunks, in f32, the math of ``_exact_chunked``
  (``srganfd_tpu/ops/pallas/attention.py:136-160``).
- ``launches`` counts kernel calls.

"""

from __future__ import annotations

import ctypes
import math

import torch

from srganfd_tpu_torch.ops.cuda.build import load_library

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_ref", "flash_block_q", "HEAD_DIMS", "launches"]

launches = 0  # flash_attention kernel calls in this process; reset by assigning 0

HEAD_DIMS = (16, 32)  # head dims the kernel is built for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib: ctypes.CDLL | None = None


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, chunk: int = 1024
) -> torch.Tensor:
    """Exact softmax attention, 1/sqrt(D) scale, no mask, computed in f32
    over query chunks of ``chunk`` rows (O(chunk * T) score memory); the
    result in q's dtype. q/k/v: (N, T, H, D)."""
    d = q.shape[-1]
    k32, v32 = k.float(), v.float()
    out = []
    for start in range(0, q.shape[1], chunk):
        logits = torch.einsum("nqhd,nkhd->nhqk", q[:, start : start + chunk].float(), k32)
        w = (logits / math.sqrt(d)).softmax(-1)
        out.append(torch.einsum("nhqk,nkhd->nqhd", w, v32))
    if not out:
        return torch.empty_like(q)
    return torch.cat(out, 1).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must be (N, T, H, D) of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash attention takes float32 or bfloat16, one dtype for q, k, v; "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {q.shape[-1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along D, got strides {t.stride()}")
        # both kernels move rows with 16-byte loads; a stride of a size-1
        # axis is never used
        per = 16 // t.element_size()
        if t.data_ptr() % 16 or any(
            st % per for st, size in zip(t.stride()[:3], t.shape[:3]) if size > 1
        ):
            raise ValueError(
                f"{t.dtype} {name} rows must be 16-byte aligned: data_ptr % 16 = "
                f"{t.data_ptr() % 16}, element strides {t.stride()}"
            )


def flash_block_q(chunk: int) -> int:
    """The backward's query block for an ``attn_chunk`` of ``chunk``, as
    ``srganfd_tpu/models/blocks.py:493-507`` derives the JAX kernel's
    ``block_q``: a multiple of 8, at most 1024."""
    return min(1024, max(8, -(-chunk // 8) * 8))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int = 512) -> torch.Tensor:
    """Exact softmax attention, the function of the JAX ``flash_attention``
    without its TPU block sizes. q/k/v: (N, T, H, D), f32 or bf16, D
    contiguous and rows 16-byte aligned (views of one packed projection, as
    the encoder layer passes them, work as they are). Returns a contiguous
    (N, T, H, D) tensor in q's dtype. ``block_q`` is the backward's query
    block (the JAX function's, whose backward recomputes in blocks of it)."""
    return _FlashAttention.apply(q, k, v, block_q)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        ctx.block_q = block_q
        return _flash_forward(q, k, v)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, g, ctx.block_q), None)


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, block_q: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of exact attention at (q, k, v) for the output's
    cotangent ``g``: the scores recomputed in f32 by blocks of ``block_q``
    queries, each block differentiated alone (the JAX ``_flash_bwd``, whose
    ``jax.checkpoint`` per block keeps its residuals O(T)); dk and dv summed
    over the blocks in f32; each gradient in its input's dtype."""
    k32 = k.detach().float().requires_grad_()
    v32 = v.detach().float().requires_grad_()
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    with torch.enable_grad():
        for start in range(0, q.shape[1], block_q):
            stop = min(start + block_q, q.shape[1])
            qi = q[:, start:stop].detach().float().requires_grad_()
            out = flash_attention_ref(qi, k32, v32, block_q)
            dqi, dki, dvi = torch.autograd.grad(out, (qi, k32, v32), g[:, start:stop].float())
            dq[:, start:stop] = dqi.to(q.dtype)
            dk += dki
            dv += dvi
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    _check(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    n, t, h, d = q.shape
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out) for s in x.stride()[:3]))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_cuda(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            n, t, h, d, strides, _DTYPE_CODES[q.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_cuda failed: {lib.flash_attention_error_string(rc).decode()} ({rc})"
        )
    launches += 1
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_cuda.argtypes = [
            p, p, p, p, i, i, i, i, ctypes.POINTER(ctypes.c_longlong), i, p,
        ]
        lib.flash_attention_cuda.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
