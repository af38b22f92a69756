"""Residual Dense Block forward and backward: the hand-written CUDA kernels
and their plain PyTorch versions.

Counterpart of ``srganfd_tpu/ops/pallas/rdb.py``. Both TPU entry points
(``rdb_forward_pallas`` with H tiles, ``rdb_forward_pallas_v2`` with whole
images per grid cell) compute one function; on Hopper one source,
``csrc/rdb.cu``, serves both, so the tiling arguments are gone. Its conv
kernel is chosen by x's dtype; both run on the tensor cores as an implicit
GEMM. bf16: ``wgmma`` in persistent blocks that hold a conv's weights, over
8x8 pixel tiles whose halos a producer warp brings in by tensor-map boxes
(cp.async where ch is not a multiple of 64 or gc of 16), one K-major A
descriptor per tap over the shifted window; :func:`_fwd_plan` sizes its
launches. f32: ``mma.sync`` as split-precision 3xTF32 (each operand split
into two TF32 halves, three products per pair).

- :func:`rdb_forward` launches the kernel for a CUDA tensor and takes the
  plain version for a CPU tensor; any other device raises. There is no
  fallback from a CUDA tensor to the plain version.
- :func:`rdb_forward_ref` is the plain version, with the kernel's rounding
  points (operands in x's dtype, f32 sums, ``out_k`` rounded to x's dtype,
  ``y * 0.2 + x`` in f32).
- :func:`rdb_apply` is the trainable RDB, a ``torch.autograd.Function``
  (the counterpart of the JAX ``rdb_apply`` custom VJP, whose backward
  ``_rdb_apply_bwd``, ``ops/pallas/rdb.py:163-166``, is ``jax.vjp`` of the
  recomputed XLA block): its forward keeps the kernel's scratch ``feat``
  (out_1..out_4 in x's dtype) beside x and the packed weights, and its
  backward recomputes nothing. On a CUDA tensor it launches the backward
  kernels of ``csrc/rdb_bwd.cu`` (:func:`rdb_backward`: dgrad and wgrad on
  the tensor cores, bf16 or 3xTF32), and nothing else; on a CPU tensor it
  runs :func:`rdb_backward_ref` from the same saved ``feat``.
- :func:`rdb_backward_ref` is the backward's plain version: autograd's own
  operations through :func:`rdb_forward_ref` (its casts, convolution
  backwards and sums, in autograd's order), taken from the saved
  activations, so that it equals autograd through the plain version bit
  for bit on the CPU.
- :func:`rdb_forward_op` is the custom op ``srganfd::rdb_forward``
  (``torch.library``) with a fake (shape) implementation, so that
  ``torch.export`` keeps the ctypes launch, which it cannot trace, as one
  node of the exported program. It takes the weights as the device reads
  them (:meth:`ResidualDenseBlock.pack_for_export`): on a CUDA tensor the
  kernel's packed layout, on a CPU tensor the five HWIO kernels flattened,
  for the plain version; a program holds each weight once. Loading a
  program that holds it needs ``srganfd_tpu_torch`` imported.
- ``launches`` counts forward kernel calls, one per RDB (the kernel itself
  makes five CUDA launches, one per conv); ``launches_bwd`` backward
  kernel calls, one per RDB backward (eight CUDA launches, seven without dx).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from srganfd_tpu_torch.ops.cuda.build import load_library

__all__ = [
    "lrelu", "rdb_forward", "rdb_forward_ref", "rdb_apply", "rdb_backward", "rdb_backward_ref", "rdb_forward_op",
    "pack_rdb_weights", "flat_rdb_weights", "tf32_round", "split_tf32", "launches", "launches_bwd",
]

launches = 0  # rdb_forward kernel calls in this process; reset by assigning 0
launches_bwd = 0  # rdb_backward kernel calls (one per RDB backward); reset by assigning 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib: ctypes.CDLL | None = None
_bwd_lib: ctypes.CDLL | None = None


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
    x: torch.Tensor, kernels: list[torch.Tensor], biases: list[torch.Tensor], with_feat: bool = False
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Plain RDB forward. x: (N, H, W, ch); kernels[k]: (3, 3, ch + k*gc,
    gc|ch) HWIO; biases to match. Returns (N, H, W, ch) in x's dtype. Sums
    in f32 for f32 and bf16 x, in f64 for f64 x (the CPU-only dtype of
    lockstep parity tests; the kernel takes f32 and bf16). With
    ``with_feat`` also out_1..out_4 as the kernel's ``feat`` holds them,
    (N, H, W, 4*gc) in x's dtype."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    x32 = x.to(acc).permute(0, 3, 1, 2)
    feats, outs = [x32], []
    y = x32
    for k in range(5):
        w = kernels[k].to(dt).to(acc).permute(3, 2, 0, 1)
        y = F.conv2d(torch.cat(feats, 1), w, biases[k].to(acc), padding=1)
        if k < 4:
            outs.append(lrelu(y).to(dt))
            feats.append(outs[-1].to(acc))
    out = (y * 0.2 + x32).to(dt).permute(0, 2, 3, 1)
    if not with_feat:
        return out
    return out, torch.cat([o.detach() for o in outs], 1).permute(0, 2, 3, 1).contiguous()


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
    if torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in (*kernels, *biases))
    ):
        return rdb_apply(x, kernels, biases, packed)
    if x.device.type == "cpu":
        return rdb_forward_ref(x, kernels, biases)
    if x.device.type != "cuda":
        raise RuntimeError(f"rdb_forward runs on cuda or cpu tensors, got {x.device}")
    w, b = packed if packed is not None else pack_rdb_weights(kernels, biases, x.dtype)
    _check(x, kernels, biases, w, b)
    return _forward_cuda(x, w, b, kernels[0].shape[-1])[0]


# csrc/rdb.cu's bf16 kernel (``FwdSmem`` and its constants there): 8x8
# pixel tiles, couts in tiles of 32 (the wgmma N), a tile's 10x10 halo in
# tensor-map boxes of 64 channels (each 1024-byte aligned) or, with
# cp.async, [cin / 8][halo pixel][8 channels]; one (16-channel step, tap)'s
# weights in 1024 bytes; at most 4 ring slots; 232,448 bytes of shared
# memory a block. Change both.
_FWD_TILE, _FWD_N, _FWD_BOX_C, _FWD_BOX_SLOT, _FWD_TAP = 8, 32, 64, 13312, 1024
_FWD_RING, _FWD_SMEM = 4, 232448


@functools.lru_cache(maxsize=256)
def _fwd_plan(n: int, h: int, w: int, ch: int, gc: int, sms: int) -> dict:
    """The bf16 forward's five launches: whether the halos come by tensor-map
    boxes (``tma``: ch a multiple of 64 and gc of 16, so that every
    16-channel step lies in one box of x or of ``feat``) or cp.async, the
    8x8 pixel ``tiles``, and per conv its ``cin``, ``cout``, cout tiles of 32
    (``co_tiles``), a ring slot's ``halo`` bytes, the ``w`` bytes of its
    weights, the ``ring`` slots that fit beside them (up to 4), the block's
    shared memory (``smem``) and its persistent ``blocks``: about one a
    multiprocessor, a multiple of ``co_tiles``, no more than the tiles.
    ``args`` is what ``rdb_forward_cuda`` reads: [tma, blocks x 5, ring x 5].
    Raises where two slots do not fit (ch + 4 gc above ~500)."""
    tma = ch % _FWD_BOX_C == 0 and gc % 16 == 0
    tiles = n * -(-h // _FWD_TILE) * -(-w // _FWD_TILE)
    convs = []
    for k in range(5):
        cin, cout = ch + k * gc, gc if k < 4 else ch
        steps, co_tiles = -(-cin // 16), -(-cout // _FWD_N)
        if tma:
            halo = (ch // _FWD_BOX_C + -(-(cin - ch) // _FWD_BOX_C)) * _FWD_BOX_SLOT
        else:
            halo = _round_up(steps * 2 * 100 * 16, 1024)
        w_bytes = steps * 9 * _FWD_TAP
        ring = min(_FWD_RING, (_FWD_SMEM - 1024 - w_bytes) // (halo + 16))
        if ring < 2:
            raise ValueError(f"rdb bf16 kernel: conv {k}'s weights ({w_bytes} B) and two halo slots "
                             f"({halo} B each) exceed a block's shared memory")
        blocks = co_tiles * min(tiles, max(1, sms // co_tiles))
        convs.append({"cin": cin, "cout": cout, "co_tiles": co_tiles, "halo": halo, "w": w_bytes, "ring": ring,
                      "smem": 1024 + ring * (halo + 16) + w_bytes, "blocks": blocks})
    args = (ctypes.c_int * 11)(int(tma), *(c["blocks"] for c in convs), *(c["ring"] for c in convs))
    return {"tma": tma, "tiles": tiles, "convs": convs, "args": args}


def _forward_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gc: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on checked arguments: (out, feat)."""
    global launches
    n, h, wd, ch = x.shape
    out = torch.empty_like(x)
    feat = torch.empty((n, h, wd, 4 * gc), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out, feat
    lib = _library()
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    plan = None
    if x.dtype == torch.bfloat16:
        if dev not in _sm_count:
            _sm_count[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _fwd_plan(n, h, wd, ch, gc, _sm_count[dev])["args"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rdb_forward_cuda(
            x.data_ptr(), feat.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            n, h, wd, ch, gc, _DTYPE_CODES[x.dtype], plan, stream,
        )
    if rc != 0:
        raise RuntimeError(f"rdb_forward_cuda failed: {lib.rdb_error_string(rc).decode()} ({rc})")
    launches += 1
    return out, feat


_sm_count: dict[int, int] = {}  # multiprocessors of each card, asked once


def rdb_backward_ref(
    x: torch.Tensor, kernels: list[torch.Tensor], biases: list[torch.Tensor], feat: torch.Tensor,
    g: torch.Tensor, want_dx: bool = True,
) -> tuple[torch.Tensor | None, list[torch.Tensor], list[torch.Tensor]]:
    """Plain RDB backward from the forward's saved ``feat`` (out_1..out_4,
    (N, H, W, 4*gc) in x's dtype) and the cotangent ``g`` of the output:
    ``(dx, dkernels, dbiases)`` in the inputs' dtypes (dx None unless
    ``want_dx``). The operations, their order and rounding points are
    autograd's through :func:`rdb_forward_ref`: dy_4 = 0.2 g in f32; for
    conv k = 4 .. 0, ``aten.convolution_backward`` of dy_k against the
    concat [x | out_1 .. out_k] in f32; each source's gradient summed in
    the order autograd's buffers take the pieces (x's: g first, then conv
    4's, .., conv 0's; out_j's: conv 4's, .., conv j's); out_k's gradient
    rounded to x's dtype, then dy_{k-1} = slope * it in f32, the slope 1
    where out_k >= 0 (JAX's ``where(x >= 0, ...)``) else 0.2; dx rounded to
    x's dtype once; dW rounded to x's dtype and then to the kernel's; db in
    f32. The kernels of ``csrc/rdb_bwd.cu`` follow this order, with one
    difference in bf16 (their header): the tensor cores take dy_k rounded to
    bf16."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    ch, gc = x.shape[-1], kernels[0].shape[-1]
    x32 = x.to(acc).permute(0, 3, 1, 2)
    outs = [feat[..., k * gc:(k + 1) * gc].to(acc).permute(0, 3, 1, 2) for k in range(4)]
    g32 = g.to(acc).permute(0, 3, 1, 2)
    bufs: list[torch.Tensor | None] = [g32, None, None, None, None]  # x, out_1..out_4, in arrival order
    widths = [ch, gc, gc, gc, gc]
    dy = g32 * 0.2
    dks: list[torch.Tensor] = [None] * 5  # type: ignore[list-item]
    dbs: list[torch.Tensor] = [None] * 5  # type: ignore[list-item]
    for k in range(4, -1, -1):
        w = kernels[k].to(dt).to(acc).permute(3, 2, 0, 1)
        src = torch.cat([x32, *outs[:k]], 1)
        gi, gw, gb = torch.ops.aten.convolution_backward(
            dy, src, w, [w.shape[0]], [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [k > 0 or want_dx, True, True])
        dks[k] = gw.permute(2, 3, 1, 0).to(dt).to(kernels[k].dtype)
        dbs[k] = gb.to(biases[k].dtype)
        if gi is not None:
            for j, piece in enumerate(gi.split(widths[:k + 1], 1)):
                bufs[j] = piece if bufs[j] is None else bufs[j] + piece
        if k > 0:
            d = bufs[k].to(dt).to(acc)
            dy = torch.where(outs[k - 1] >= 0, d, d * 0.2)
    dx = bufs[0].permute(0, 2, 3, 1).to(dt) if want_dx else None
    return dx, dks, dbs


_BWD_TILE = {torch.bfloat16: (8, 8), torch.float32: (16, 8)}  # csrc/rdb_bwd.cu's pixel tiles (rows, columns)


def _wgrad_jobs(ch: int, gc: int, dtype: torch.dtype) -> int:
    """The wgrad launch's jobs in ``csrc/rdb_bwd.cu``. bf16: the (64 source,
    64 DY channel) pairs that some conv reads, DY holding dy_4 in its first
    ch channels and dy_0..dy_3 after them (``wgrad_jobs`` there); f32: each
    conv in (32 input x 32 output channel) tiles."""
    shapes = _conv_shapes(ch, gc)
    if dtype != torch.bfloat16:
        return sum(-(-cin // 32) * -(-cout // 32) for _, _, cin, cout in shapes)
    cd = ch + 4 * gc
    cin_of = [shapes[4][2] if c < ch else shapes[(c - ch) // gc][2] for c in range(cd)]
    return sum(max(cin_of[b:b + 64]) > a for a in range(0, cd, 64) for b in range(0, cd, 64))


@functools.lru_cache(maxsize=256)
def _bwd_layout(n: int, h: int, w: int, ch: int, gc: int, dtype: torch.dtype, sms: int) -> dict[str, int]:
    """The backward's sizes and its one scratch allocation: pixel ``tiles``
    (8x8 in bf16, 16x8 in f32), wgrad ``jobs`` and pixel ``slices`` (bf16:
    about one block a multiprocessor in all; f32: about four), ``elems`` (dW)
    and ``n_bias``, and the byte offsets of D (f32), DY (x's dtype), the
    slices' dW partials and the tiles' db partials (f32) in ``bytes``."""
    th, tw = _BWD_TILE[dtype]
    shapes = _conv_shapes(ch, gc)
    tiles = n * -(-h // th) * -(-w // tw)
    jobs = _wgrad_jobs(ch, gc, dtype)
    per_block = 1 if dtype == torch.bfloat16 else 4
    slices = max(1, min(tiles, per_block * sms // jobs))
    elems = sum(9 * cin * cout for _, _, cin, cout in shapes)
    n_bias = sum(s[-1] for s in shapes)
    px, cd, esize = n * h * w, ch + 4 * gc, torch.finfo(dtype).bits // 8
    lay = {"tiles": tiles, "jobs": jobs, "slices": slices, "elems": elems, "n_bias": n_bias}
    at = 0
    for name, size in (("D", 4 * px * cd), ("DY", esize * px * cd), ("part", 4 * slices * elems),
                       ("dbp", 4 * tiles * n_bias)):
        lay[name] = at
        at += _round_up(size, 256)
    lay["bytes"] = at
    return lay


def rdb_backward(
    x: torch.Tensor, feat: torch.Tensor, g: torch.Tensor, packed: tuple[torch.Tensor, torch.Tensor], gc: int,
    want_dx: bool = True, only: int = -1,
) -> tuple[torch.Tensor | None, list[torch.Tensor], list[torch.Tensor]]:
    """The backward kernels of ``csrc/rdb_bwd.cu`` on CUDA tensors: x and
    ``feat`` as the forward kernel saw and wrote them, the cotangent ``g``
    (N, H, W, ch), ``packed`` the forward's :func:`pack_rdb_weights`, all in
    x's dtype. Returns ``(dx, dW, db)``: dx (N, H, W, ch) in x's dtype (None
    unless ``want_dx``), the five HWIO dW (rounded to x's dtype) and the five
    db, f32. Raises where a kernel does not build or launch. ``only`` runs one
    piece alone on scratch it leaves unset (0-4 a conv's dgrad, 4 with dy_4's
    pass; 5 the wgrad; 6 the sums), for timing, and counts no call."""
    global launches_bwd
    if x.device.type != "cuda":
        raise RuntimeError(f"rdb_backward launches on cuda tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"rdb backward kernel takes float32 or bfloat16, got {x.dtype}")
    n, h, wd, ch = x.shape
    if ch % 8 or gc % 8:
        raise ValueError(f"rdb backward kernel needs ch and gc multiples of 8, got {ch}, {gc}")
    g = g.contiguous()
    for name, t, c in (("x", x, ch), ("feat", feat, 4 * gc), ("g", g, ch)):
        if (t.shape != (n, h, wd, c) or t.dtype != x.dtype or t.device != x.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: {t.dtype}{tuple(t.shape)} on {t.device}, expected contiguous 16-byte "
                             f"aligned {x.dtype}{(n, h, wd, c)} on {x.device}")
    w = packed[0]
    if w.dtype != x.dtype or w.device != x.device or w.numel() != _packed_numel(ch, gc, x.dtype):
        raise ValueError(f"packed weights: {w.dtype}[{w.numel()}] on {w.device}, expected "
                         f"{x.dtype}[{_packed_numel(ch, gc, x.dtype)}] on {x.device}")
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if dev not in _sm_count:
        _sm_count[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    lay = _bwd_layout(n, h, wd, ch, gc, x.dtype, _sm_count[dev])
    elems = lay["elems"]
    scratch = torch.empty(lay["bytes"], dtype=torch.uint8, device=x.device)
    out = torch.empty(elems + lay["n_bias"], dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x) if want_dx else None
    if x.numel():
        lib = _backward_library()
        base = scratch.data_ptr()
        with torch.cuda.device(dev):
            rc = lib.rdb_backward_cuda(
                x.data_ptr(), feat.data_ptr(), g.data_ptr(), w.data_ptr(), base + lay["D"], base + lay["DY"],
                base + lay["part"], base + lay["dbp"], out.data_ptr(), dx.data_ptr() if want_dx else None,
                n, h, wd, ch, gc, _DTYPE_CODES[x.dtype], int(want_dx), lay["slices"], _sm_count[dev], only,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"rdb_backward_cuda failed: {lib.rdb_backward_error_string(rc).decode()} ({rc})")
        if only < 0:
            launches_bwd += 1
    else:
        out.zero_()
    dks, dbs = _unflat(out[:elems], out[elems:], ch, gc)
    return dx, dks, dbs


class _RdbApply(torch.autograd.Function):
    """The forward kernel (the plain version on the CPU), saving its
    ``feat``; the backward kernels (the plain backward on the CPU) from it."""

    @staticmethod
    def forward(ctx, x, packed, *params):
        kernels, biases = list(params[:5]), list(params[5:])
        ctx.gc = kernels[0].shape[-1]
        if x.device.type == "cpu":
            y, feat = rdb_forward_ref(x, kernels, biases, with_feat=True)
            ctx.save_for_backward(x, feat, *params)
            return y
        if x.device.type != "cuda":
            raise RuntimeError(f"rdb_apply runs on cuda or cpu tensors, got {x.device}")
        w, b = packed if packed is not None else pack_rdb_weights(kernels, biases, x.dtype)
        _check(x, kernels, biases, w, b)
        y, feat = _forward_cuda(x, w, b, ctx.gc)
        ctx.dtypes = [t.dtype for t in params]
        # the packed weights are no input of the graph and may come from a
        # cache filled under inference mode: held beside the saved tensors
        ctx.packed = (w, b)
        ctx.save_for_backward(x, feat)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        want_dx = ctx.needs_input_grad[0]
        x, feat, *rest = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dks, dbs = rdb_backward_ref(x, rest[:5], rest[5:], feat, grad, want_dx)
        else:
            dx, dks, dbs = rdb_backward(x, feat, grad, ctx.packed, ctx.gc, want_dx)
            dks = [t if t.dtype == dt else t.to(dt) for t, dt in zip(dks, ctx.dtypes[:5])]
            dbs = [t if t.dtype == dt else t.to(dt) for t, dt in zip(dbs, ctx.dtypes[5:])]
        grads = [g if need else None for g, need in zip([*dks, *dbs], ctx.needs_input_grad[2:])]
        return dx, None, *grads


def rdb_apply(
    x: torch.Tensor,
    kernels: list[torch.Tensor],
    biases: list[torch.Tensor],
    packed: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Trainable fused RDB, the arguments of :func:`rdb_forward`: the kernel
    (or, on the CPU, the plain version) forward; gradients for x, the five
    HWIO kernels and the five biases from the forward's saved ``feat``, by
    the backward kernels on a CUDA tensor (:func:`rdb_backward`) and by
    :func:`rdb_backward_ref` on a CPU tensor."""
    return _RdbApply.apply(x, packed, *kernels, *biases)


def flat_rdb_weights(kernels: list[torch.Tensor], biases: list[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """The five HWIO kernels and the five biases, each flattened and
    concatenated: what :func:`rdb_forward_op` reads on the CPU."""
    return (torch.cat([k.detach().reshape(-1) for k in kernels]),
            torch.cat([b.detach().reshape(-1) for b in biases]))


def _unflat(w: torch.Tensor, b: torch.Tensor, ch: int, gc: int) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """:func:`flat_rdb_weights` back into the five kernels and biases."""
    shapes = _conv_shapes(ch, gc)
    kernels = w.split([math.prod(s) for s in shapes])
    return [k.view(s) for k, s in zip(kernels, shapes)], list(b.split([s[-1] for s in shapes]))


@torch.library.custom_op("srganfd::rdb_forward", mutates_args=())
def rdb_forward_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gc: int) -> torch.Tensor:
    """:func:`rdb_forward` as an opaque op (inference only), on the weights
    as the device reads them: on a CUDA tensor ``w``/``b`` are
    :func:`pack_rdb_weights` for x's dtype and the kernel launches on them;
    on a CPU tensor they are :func:`flat_rdb_weights` and the plain version
    runs. An exported program holds them as constants, made once at export,
    and no other copy of the weights."""
    x = x.contiguous()
    if not x.is_cuda:
        return rdb_forward(x, *_unflat(w, b, x.shape[-1], gc))
    n_w, n_b = _packed_numel(x.shape[-1], gc, x.dtype), x.shape[-1] + 4 * gc
    if w.dtype != x.dtype or w.numel() != n_w or b.dtype != torch.float32 or b.numel() != n_b:
        raise ValueError(f"packed weights {w.dtype}[{w.numel()}] / {b.dtype}[{b.numel()}], expected "
                         f"{x.dtype}[{n_w}] / float32[{n_b}]: export for the device that runs the program")
    if x.dtype not in _DTYPE_CODES or x.data_ptr() % 16 or x.shape[-1] % 8 or gc % 8:
        raise ValueError(f"rdb kernel takes f32 or bf16 x with ch and gc multiples of 8, got {x.dtype}, "
                         f"{x.shape[-1]}, {gc}")
    return _forward_cuda(x, w.contiguous(), b.contiguous(), gc)[0]


@rdb_forward_op.register_fake
def _(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gc: int) -> torch.Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library("rdb")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rdb_forward_cuda.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_int), p]
        lib.rdb_forward_cuda.restype = i
        lib.rdb_error_string.argtypes = [i]
        lib.rdb_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _backward_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = load_library("rdb_bwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rdb_backward_cuda.argtypes = [p] * 10 + [i] * 10 + [p]
        lib.rdb_backward_cuda.restype = i
        lib.rdb_backward_error_string.argtypes = [i]
        lib.rdb_backward_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib
