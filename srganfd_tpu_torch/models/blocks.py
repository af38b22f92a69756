"""Building blocks of the models (counterpart of
``srganfd_tpu/models/blocks.py``: ``lrelu``, ``Conv``, ``SNConv``,
Flax's ``BatchNorm`` (training and eval modes),
``ResidualDenseBlock``, ``RRDB`` and the trunk; ``pixel_unshuffle``; the
attention functions and ``TransformerEncoderLayer`` of the transformer
bottleneck; ``TokenSelfAttention`` of the self-attention discriminator).

Layout: the modules take and return NCHW tensors, kept in
``torch.channels_last`` memory format, so that ``x.permute(0, 2, 3, 1)``
is the contiguous NHWC tensor the RDB kernel takes, with no copy.

Parameters are f32, named as in the reference state dicts
(``trunk.{i}.rdb{j}.conv{k}``); the compute dtype is the input's, and each
conv casts its parameters to it at call time, like the JAX ``Conv`` with
``param_dtype=f32``. Initialisation is kaiming-normal x0.1 with zero
biases (``blocks.py:26-28`` of the JAX package), drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Any, Iterator

import torch
import torch.nn.functional as F
from torch import nn

from srganfd_tpu_torch.ops.cuda.attention import HEAD_DIMS as FLASH_HEAD_DIMS
from srganfd_tpu_torch.ops.cuda.attention import flash_attention, flash_attention_ref, flash_block_q
from srganfd_tpu_torch.ops.cuda.qconv import pack_qconv_weights
from srganfd_tpu_torch.ops.cuda.rdb import flat_rdb_weights, lrelu, pack_rdb_weights, rdb_apply, rdb_forward_op
from srganfd_tpu_torch.ops.quant import qconv2d_prequantized, quantize_symmetric
from srganfd_tpu_torch.parallel import comm
from srganfd_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_loop
from srganfd_tpu_torch.parallel.ulysses import ulysses_attention, ulysses_attention_loop

__all__ = [
    "lrelu", "out_dtype", "Conv", "repack_always", "drop_packed", "init_lecun_normal", "BatchNorm", "SNConv", "ResidualDenseBlock", "RRDB", "make_trunk", "init_kaiming_x01",
    "pixel_unshuffle",
    "ATTN_BACKENDS", "attention_backend", "chunked_attention", "large_attention",
    "dot_product_attention", "CP_BACKENDS", "check_cp_backend", "TransformerEncoderLayer", "TokenSelfAttention",
]


def out_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    """The models emit f32 (bf16 compute upcasts for the losses and
    metrics), and f64 under f64 compute, as the JAX ``out_dtype`` does: f64
    exists for lockstep parity tests on the CPU."""
    return torch.float64 if compute_dtype == torch.float64 else torch.float32


class Conv(nn.Conv2d):
    """The JAX ``Conv``: a ``kernel`` x ``kernel`` conv at ``stride`` with
    torch-style explicit padding (``padding`` None: 1 for kernels of 3 and
    4, ``kernel // 2`` otherwise), a bias unless ``use_bias`` is False, f32
    parameters cast to the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3, stride: int = 1,
                 padding: int | None = None, use_bias: bool = True) -> None:
        if padding is None:
            padding = 1 if kernel in (3, 4) else kernel // 2
        super().__init__(in_channels, out_channels, kernel, stride, padding, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, stride=self.stride, padding=self.padding)


def init_kaiming_x01(module: nn.Module, generator: torch.Generator | None = None) -> None:
    """Kaiming-normal (gain sqrt(2), fan_in) x0.1 weights, zero biases, for
    every conv of ``module`` in registration order."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator, dtype=torch.float32)
                m.weight.copy_(w * (0.02 / fan_in) ** 0.5)
                m.bias.zero_()


def init_lecun_normal(conv: nn.Conv2d | nn.Linear, generator: torch.Generator | None = None) -> None:
    """Flax ``nn.Conv``'s and ``nn.Dense``'s default init: lecun-normal
    weights (variance 1/fan_in, normal truncated at 2 standard deviations)
    and zero biases."""
    with torch.no_grad():
        std = (1.0 / conv.weight[0].numel()) ** 0.5 / 0.87962566103423978
        w = torch.empty(conv.weight.shape, dtype=torch.float32)
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
        conv.weight.copy_(w)
        if conv.bias is not None:
            conv.bias.zero_()


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, param_dtype=f32,
    use_fast_variance=True)`` over NCHW's channels. With ``train`` (the
    default: the mode every training step runs, ``use_running_average=
    False``):

    - it normalises with the batch's mean and biased "fast" variance
      ``max(0, E[x^2] - E[x]^2)``, both taken in f32 (f64 under f64) for
      any input dtype, as Flax's ``_compute_stats`` promotes, the gradient
      flowing through them to the input;
    - y = (x - mean) * (rsqrt(var + eps) * weight) + bias in that dtype,
      rounded to the input's dtype, as Flax's ``_normalize``;
    - with ``update_stats`` it writes ``running = 0.9 running + 0.1 batch``
      for the mean and the biased variance (``SNConv``'s switch); without,
      it writes nothing, as the JAX step discards the collection.

    With ``train=False`` (Flax's ``use_running_average=True``, what a JAX
    module called with ``train=False`` runs) it normalises with the
    running mean and variance and writes nothing; ``update_stats`` then
    raises, since there are no batch statistics to write.

    ``nn.BatchNorm2d`` and ``F.batch_norm(training=True)`` differ: both
    write the unbiased running variance (n/(n-1) times the batch's), and on
    every training call. Parameters and buffers take the reference's names:
    ``weight``, ``bias``, ``running_mean``, ``running_var``.

    Under data parallelism the batch statistics are the global batch's
    (:meth:`_batch_moments`); the running variance is the biased one, so
    there is no n/(n-1) to take over the global count."""

    momentum = 0.9
    eps = 1e-5

    def __init__(self, features: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    @staticmethod
    def _batch_moments(xs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """E[x] and E[x^2] per channel over the global batch. In a world of
        one, the local means. Under data parallelism the JAX step's batch
        is the global one, so the sums, sums of squares and counts of every
        rank are all-reduced, differentiably: each rank's backward then
        carries every rank's share of the statistics' gradient."""
        if comm.world() == 1:
            return xs.mean((0, 2, 3)), (xs * xs).mean((0, 2, 3))
        count = torch.full((1,), xs.numel() // xs.shape[1], dtype=xs.dtype, device=xs.device)
        total = comm.all_reduce_sum_grad(torch.cat([xs.sum((0, 2, 3)), (xs * xs).sum((0, 2, 3)), count]))
        c = xs.shape[1]
        return total[:c] / total[-1], total[c:2 * c] / total[-1]

    def forward(self, x: torch.Tensor, update_stats: bool = False, train: bool = True) -> torch.Tensor:
        acc = torch.promote_types(x.dtype, torch.float32)
        xs = x.to(acc)
        if not train:
            if update_stats:
                raise ValueError("BatchNorm: update_stats needs train=True (eval mode has no batch statistics)")
            mean, var = self.running_mean.to(acc), self.running_var.to(acc)
        else:
            mean, mean_sq = self._batch_moments(xs)
            # max(0, .) as jnp.maximum: half the gradient at a tie (a constant channel)
            var = torch.maximum(mean_sq - mean * mean, torch.zeros((), dtype=acc))
        if update_stats:
            with torch.no_grad():
                for buf, batch in ((self.running_mean, mean), (self.running_var, var)):
                    buf.copy_(self.momentum * buf.to(acc) + (1 - self.momentum) * batch.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight.to(acc)
        y = (xs - mean[:, None, None]) * mul[:, None, None] + self.bias.to(acc)[:, None, None]
        return y.to(x.dtype)


class SNConv(nn.Module):
    """Conv without bias whose weight is divided by its spectral norm, as
    the JAX ``SNConv`` computes it (``srganfd_tpu/models/blocks.py:117-166``,
    after torch's ``spectral_norm`` with one power iteration).

    ``weight`` is f32 OIHW; the buffer ``u`` (out,) is the estimate of the
    left singular vector. Every call, in train and eval mode alike, runs one
    power iteration from the stored ``u`` with W = ``weight`` viewed as
    (out, in*k*k): v = W^T u / (|W^T u| + 1e-12), u' = W v / (|W v| + 1e-12),
    sigma = u'^T W v with u' and v constants, so the gradient flows through
    W alone. ``u'`` is written back only with ``update_stats=True``. W /
    sigma is cast to the input's dtype for the conv.

    ``torch.nn.utils.spectral_norm`` computes something else: it stores v,
    writes u on every training-mode call and skips the iteration in eval.
    The JAX kernel is HWIO, so its W has the columns in (kh, kw, in) order
    where this one has (in, kh, kw): sigma and u do not depend on the
    column order, and v is never stored, so ``u`` carries over as it is.
    """

    def __init__(
        self, in_channels: int, out_channels: int, kernel: int, stride: int, padding: int = 1
    ) -> None:
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel))
        self.register_buffer("u", torch.empty(out_channels))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """He-uniform weight (Flax's ``he_uniform``: bound sqrt(6/fan_in))
        and a standard normal ``u``."""
        with torch.no_grad():
            bound = (6.0 / self.weight[0].numel()) ** 0.5
            w = torch.rand(self.weight.shape, generator=generator, dtype=torch.float32)
            self.weight.copy_(w * (2 * bound) - bound)
            self.u.copy_(torch.randn(self.u.shape, generator=generator, dtype=torch.float32))

    def sigma(self, update_stats: bool, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """One power iteration from ``u``; the spectral norm estimate, in f32
        (f64 when ``dtype`` is f64)."""
        acc = torch.promote_types(self.weight.dtype, dtype)
        w = self.weight.to(acc).reshape(self.weight.shape[0], -1)
        with torch.no_grad():
            v = w.t().mv(self.u.to(acc))
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = w.mv(v)
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
            if update_stats:
                self.u.copy_(u)
        return torch.dot(u @ w, v)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        w = (self.weight / self.sigma(update_stats, x.dtype)).to(x.dtype)
        return F.conv2d(x, w, None, stride=self.stride, padding=self.padding)


_repack = [False]  # set inside repack_always()


@contextlib.contextmanager
def repack_always() -> Iterator[None]:
    """Inside the block every RDB forward packs its weights anew instead of
    reading its cache: the cache's check runs on the host, so a CUDA graph
    captured here packs the weights on every replay, after each update."""
    _repack[0] = True
    try:
        yield
    finally:
        _repack[0] = False


def drop_packed(model: nn.Module) -> None:
    """Forget every RDB's packed weights: a graph replay updates the
    parameters without bumping the version counters the cache is keyed on."""
    for m in model.modules():
        if isinstance(m, ResidualDenseBlock):
            m._packed = None


class ResidualDenseBlock(nn.Module):
    """5-conv dense block, LeakyReLU(0.2), 0.2-scaled residual
    (ESRGAN/model.py:29-60), through ``ops/cuda/rdb.py`` ``rdb_apply``:
    the hand-written kernel on a CUDA tensor, the plain version on a CPU
    tensor, both taking any H x W; gradients from the forward's saved
    out_1..out_4, by the backward kernels on a CUDA tensor and the plain
    backward on a CPU one. While ``torch.export`` traces the block it calls
    the custom op ``srganfd::rdb_forward`` instead (``ops/cuda/rdb.py``),
    which the exported program keeps as one node, on the weights that
    :meth:`pack_for_export` registered as buffers.

    ``quant=True`` is the int8 serving path (``--quant-int8``), the JAX
    block's fused int8 form (``srganfd_tpu/models/blocks.py:263-300``):
    each source (x, then out_1..out_4) is quantized per tensor on its own
    and convolved once against the stacked input rows of every later conv
    it feeds (``ops/quant.py``: the s8 kernel on the card), whose weight
    scales are per output channel over that slice's fan-in; the
    contributions are summed into each conv's accumulator in the compute
    dtype, in source order, and the bias is added after the sum. It serves
    only: under grad it raises."""

    def __init__(self, channels: int, growth_channels: int, quant: bool = False) -> None:
        super().__init__()
        self.channels, self.growth_channels = channels, growth_channels
        self.quant = quant
        for k in range(5):
            cout = growth_channels if k < 4 else channels
            setattr(self, f"conv{k + 1}", Conv(channels + k * growth_channels, cout))
        self._packed: tuple | None = None  # (key, packed weights, packed biases)
        self._quantized: tuple | None = None  # (key, [(kq, ks, packed) per source])
        # tensor parallelism (parallel/tensor.py): the convs hold output-channel
        # shards, and this returns the five whole HWIO kernels and biases
        self.gather_weights: Any = None

    def _convs(self) -> list[Conv]:
        return [getattr(self, f"conv{k + 1}") for k in range(5)]

    def _params_key(self) -> tuple:
        params = [p for c in self._convs() for p in (c.weight, c.bias)]
        return params[0].device, tuple((p.data_ptr(), p._version) for p in params)

    def kernels_biases(self) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """The five convs as HWIO kernels (views) and biases."""
        convs = self._convs()
        return [c.weight.permute(2, 3, 1, 0) for c in convs], [c.bias for c in convs]

    def packed(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """The kernel's packed weights for ``dtype``, rebuilt only when the
        dtype, the device or a parameter (its version counter, which
        ``load_state_dict`` and optimisers bump) changed."""
        key = (dtype, *self._params_key())
        if _repack[0] or self._packed is None or self._packed[0] != key:
            self._packed = (key, *pack_rdb_weights(*self.kernels_biases(), dtype))
        return self._packed[1], self._packed[2]

    def pack_for_export(self, dtype: torch.dtype) -> None:
        """Register the weights as the device reads them, as the
        non-persistent buffers ``packed_w`` and ``packed_b``: on the card
        :meth:`packed` for ``dtype``, on the CPU ``flat_rdb_weights``.
        ``torch.export`` keeps them as constants of the program, which passes
        them to ``srganfd::rdb_forward``. The five convs' parameters are
        removed, so that the program holds each weight once; the block then
        runs only under export. Call it before tracing."""
        if self._convs()[0].weight.is_cuda:
            w, b = self.packed(dtype)
        else:
            w, b = flat_rdb_weights(*self.kernels_biases())
        self.register_buffer("packed_w", w, persistent=False)
        self.register_buffer("packed_b", b, persistent=False)
        for conv in self._convs():
            del conv.weight, conv.bias

    def quantized(self) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]]:
        """Per source s (x, out_1..out_4): the int8 HWIO wide kernel that
        stacks conv_k's input rows ``[off_s, off_s + width_s)`` for k >= s
        along the output channels, its per-output-channel scales and, on
        the card, its packed layout; rebuilt only when a parameter
        changed, as :meth:`packed` is."""
        key = self._params_key()
        if self._quantized is None or self._quantized[0] != key:
            ch, gc = self.channels, self.growth_channels
            offsets, widths = [0, ch, ch + gc, ch + 2 * gc, ch + 3 * gc], [ch, gc, gc, gc, gc]
            kernels, _ = self.kernels_biases()
            per_source = []
            with torch.no_grad():
                for s in range(5):
                    wide = torch.cat([kernels[k][:, :, offsets[s]:offsets[s] + widths[s]] for k in range(s, 5)], 3)
                    kq, ks = quantize_symmetric(wide.float(), channel_axis=3)
                    per_source.append((kq.contiguous(), ks.reshape(-1).contiguous(),
                                       pack_qconv_weights(kq) if kq.is_cuda else None))
            self._quantized = (key, per_source)
        return self._quantized[1]

    def _forward_quant(self, x: torch.Tensor) -> torch.Tensor:
        """The int8 fused form on NHWC ``x``, in x's dtype."""
        if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in self.parameters())):
            raise RuntimeError("the int8 RDB (quant=True) serves only: run it under torch.no_grad or "
                               "inference_mode with parameters that do not require grad")
        dt = x.dtype
        ch, gc = self.channels, self.growth_channels
        splits = [gc, gc, gc, gc, ch]  # output widths of conv1..conv5
        quantized = self.quantized()
        biases = [c.bias for c in self._convs()]

        def contributions(s: int, inp: torch.Tensor) -> list[torch.Tensor | None]:
            kq, ks, packed = quantized[s]
            y = qconv2d_prequantized(inp, kq, ks, packed).to(dt)
            out: list[torch.Tensor | None] = [None] * 5
            start = 0
            for k in range(s, 5):
                out[k] = y[..., start:start + splits[k]]
                start += splits[k]
            return out

        acc = contributions(0, x)
        for k in range(4):
            out_k = lrelu(acc[k] + biases[k].to(dt))
            contrib = contributions(k + 1, out_k)
            for t in range(k + 1, 5):
                acc[t] = acc[t] + contrib[t]
        return (acc[4] + biases[4].to(dt)) * 0.2 + x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xh = x.permute(0, 2, 3, 1)
        if self.quant:
            return self._forward_quant(xh.contiguous()).permute(0, 3, 1, 2)
        if torch.compiler.is_exporting():
            if not hasattr(self, "packed_w"):
                raise RuntimeError("export an RDB after its pack_for_export(dtype)")
            y = rdb_forward_op(xh.contiguous(), self.packed_w, self.packed_b, self.growth_channels)
            return y.permute(0, 3, 1, 2)
        if self.gather_weights is not None:  # the kernel runs whole on the gathered weights
            kernels, biases = self.gather_weights()
            packed = pack_rdb_weights(kernels, biases, x.dtype) if x.is_cuda else None
            return rdb_apply(xh.contiguous(), kernels, biases, packed=packed).permute(0, 3, 1, 2)
        packed = self.packed(x.dtype) if x.is_cuda else None  # the CPU path takes HWIO
        y = rdb_apply(xh.contiguous(), *self.kernels_biases(), packed=packed)
        return y.permute(0, 3, 1, 2)


class RRDB(nn.Module):
    """Residual-in-residual dense block: 3 RDBs + 0.2-scaled residual
    (ESRGAN/model.py:63-86)."""

    def __init__(self, channels: int, growth_channels: int, quant: bool = False) -> None:
        super().__init__()
        self.rdb1 = ResidualDenseBlock(channels, growth_channels, quant)
        self.rdb2 = ResidualDenseBlock(channels, growth_channels, quant)
        self.rdb3 = ResidualDenseBlock(channels, growth_channels, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


def make_trunk(channels: int, growth_channels: int, num_blocks: int, quant: bool = False) -> nn.Sequential:
    """The RRDB trunk (``run_trunk`` in JAX, unrolled): ``trunk.{i}``;
    ``quant`` runs each RDB's int8 serving path."""
    return nn.Sequential(*[RRDB(channels, growth_channels, quant) for _ in range(num_blocks)])


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NHWC pixel-unshuffle: (N, H, W, C) -> (N, H/f, W/f, C*f*f) with the
    output channels in (c, fh, fw) order, torch ``nn.PixelUnshuffle``'s
    order, as the JAX ``pixel_unshuffle`` orders them. H and W must be
    multiples of ``factor``."""
    if factor == 1:
        return x
    if x.shape[1] % factor or x.shape[2] % factor:
        raise ValueError(
            f"pixel_unshuffle by {factor} needs H and W divisible by it, got {x.shape[1]}x{x.shape[2]} "
            f"(serve with --bucket {factor} to pad odd frames)"
        )
    return F.pixel_unshuffle(x.permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)


# -- attention ---------------------------------------------------------------

ATTN_BACKENDS = ("chunked", "flash")


def attention_backend(name: str | None = None) -> str:
    """The backend of ``attn_chunk`` attention: ``name``, else
    ``$SRGANFD_ATTN_BACKEND``, else ``"chunked"`` (the JAX package's
    default, ``blocks.py:472``)."""
    name = name or os.environ.get("SRGANFD_ATTN_BACKEND") or "chunked"
    if name not in ATTN_BACKENDS:
        raise ValueError(f"unknown attention backend {name!r}: expected one of {ATTN_BACKENDS}")
    return name


def chunked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, chunk: int
) -> torch.Tensor:
    """Exact softmax attention in query blocks of ``chunk`` rows: O(chunk * T)
    score memory, f32 scores, the result in q's dtype. Plain PyTorch, as the
    JAX package runs it in XLA; its math is the flash kernel's plain
    version, so it is that function. q/k/v: (N, T, H, D)."""
    return flash_attention_ref(q, k, v, chunk)


def large_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, chunk: int, backend: str
) -> torch.Tensor:
    """Exact attention for large token counts through ``backend``:
    ``"flash"`` is the hand-written kernel (``ops/cuda/attention.py``),
    whose backward recomputes in query blocks derived from ``chunk`` as the
    JAX ``large_attention`` derives them, ``"chunked"`` the query-block
    sweep."""
    if backend == "flash":
        return flash_attention(q, k, v, flash_block_q(chunk))
    return chunked_attention(q, k, v, chunk)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full softmax attention in q's dtype, as Flax's
    ``nn.dot_product_attention`` computes it: q scaled by 1/sqrt(D) first,
    O(T^2) scores. q/k/v: (N, T, H, D)."""
    q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype)
    w = torch.einsum("nqhd,nkhd->nhqk", q, k).softmax(-1)
    return torch.einsum("nhqk,nkhd->nqhd", w, v)


def _linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Flax ``Dense`` in x's dtype: the product is rounded to x's dtype
    before the bias is added in that dtype."""
    return torch.matmul(x, weight.to(x.dtype).t()) + bias.to(x.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` with f32 parameters, computed as Flax ``Dense``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(x, self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    """Flax ``nn.LayerNorm`` (epsilon 1e-6): mean and E[x^2] - mean^2 in
    f32, the affine map in f32, the result rounded to x's dtype."""

    def __init__(self, features: int) -> None:
        super().__init__(features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


class SelfAttention(nn.Module):
    """Flax ``nn.MultiHeadDotProductAttention`` over one token set, in the
    parameter layout of torch's ``nn.MultiheadAttention``: ``in_proj_weight``
    (3C, C) stacks the q, k, v projections, each with its output features
    head-major (feature h * D + d), and ``out_proj`` maps the H * D features
    back to C. The attention itself is full softmax when ``attn_chunk`` is 0,
    else ``large_attention`` through ``backend``. With ``cp_backend`` set
    (``"ring"`` or ``"ulysses"``) the token axis is sharded over the ranks
    and the attention is ``parallel/ring_attention.py`` or
    ``parallel/ulysses.py`` over them, ``kv_valid`` masking this rank's keys;
    ``attn_chunk`` and ``backend`` are then not read, as the JAX layer's
    branch order has it."""

    def __init__(self, d_model: int, nhead: int, attn_chunk: int, backend: str, cp_backend: str | None = None) -> None:
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} is not divisible by {nhead} heads")
        self.nhead, self.attn_chunk, self.backend, self.cp_backend = nhead, attn_chunk, backend, cp_backend
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = Linear(d_model, d_model)

    def _qkv(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        n, t, _ = x.shape
        qkv = _linear(x, self.in_proj_weight, self.in_proj_bias).view(n, t, 3, self.nhead, -1)
        return qkv.unbind(2)  # strided (N, T, H, D) views, D contiguous

    def _out(self, out: torch.Tensor) -> torch.Tensor:
        n, t = out.shape[:2]
        return self.out_proj(out.reshape(n, t, -1))

    def forward(self, x: torch.Tensor, kv_valid: torch.Tensor | None = None) -> torch.Tensor:
        q, k, v = self._qkv(x)
        if self.cp_backend == "ulysses":
            out = ulysses_attention(q, k, v, kv_valid)
        elif self.cp_backend == "ring":
            out = ring_attention(q, k, v, kv_valid)
        elif self.attn_chunk:
            out = large_attention(q, k, v, self.attn_chunk, self.backend)
        else:
            out = dot_product_attention(q, k, v)
        return self._out(out)

    def forward_shards(self, xs: list[torch.Tensor], kv_valid: list[torch.Tensor]) -> list[torch.Tensor]:
        """The context-parallel forward of every rank's tokens in one process
        (``ring_attention_loop`` or ``ulysses_attention_loop``, no collective)."""
        qkv = [self._qkv(x) for x in xs]
        loop = ulysses_attention_loop if self.cp_backend == "ulysses" else ring_attention_loop
        outs = loop([t[0] for t in qkv], [t[1] for t in qkv], [t[2] for t in qkv], kv_valid)
        return [self._out(o) for o in outs]


CP_BACKENDS = ("ring", "ulysses")


def check_cp_backend(name: str) -> str:
    """A typo must not run ring attention silently (the JAX layer's check)."""
    if name not in CP_BACKENDS:
        raise ValueError(f"unknown cp_backend {name!r}: expected 'ring' or 'ulysses'")
    return name


class TransformerEncoderLayer(nn.Module):
    """torch ``nn.TransformerEncoderLayer`` defaults as the JAX layer runs
    them in eval (``blocks.py:563-627``): post-LN, multi-head
    self-attention, ReLU feed-forward of ``dim_feedforward`` units, dropout
    off. ``attn_chunk`` > 0 runs the attention exactly in query chunks
    through ``attn_backend`` (``"chunked"`` or ``"flash"``; None reads
    ``$SRGANFD_ATTN_BACKEND``, else ``"chunked"``). ``ring_axis="data"``
    shards the token axis over the ranks, the attention running as
    ``cp_backend`` (``"ring"`` or ``"ulysses"``; another name raises), with
    ``kv_valid`` this rank's key mask; it then ignores ``attn_chunk`` and
    ``attn_backend``, as the JAX layer does. Takes and returns (N, T, C) in
    the compute dtype; parameters are f32 and named as torch's layer names
    them."""

    def __init__(
        self,
        d_model: int,
        nhead: int,
        dim_feedforward: int = 2048,
        attn_chunk: int = 0,
        attn_backend: str | None = None,
        ring_axis: str | None = None,
        cp_backend: str = "ring",
    ) -> None:
        super().__init__()
        cp = None
        if ring_axis is not None:
            if ring_axis != "data":
                raise ValueError(f"ring_axis {ring_axis!r}: --spatial-shard splits the frame's rows over the 'data' "
                                 "axis of every rank (parallel/spatial.py)")
            cp = check_cp_backend(cp_backend)
        self.self_attn = SelfAttention(d_model, nhead, attn_chunk, attention_backend(attn_backend), cp)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Flax's initialisers: lecun-normal kernels (variance 1/fan_in, here
        untruncated), zero biases, unit LayerNorm scales."""
        with torch.no_grad():
            for w in (self.self_attn.in_proj_weight, self.self_attn.out_proj.weight,
                      self.linear1.weight, self.linear2.weight):
                w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(w.shape[1]))
            for b in (self.self_attn.in_proj_bias, self.self_attn.out_proj.bias,
                      self.linear1.bias, self.linear2.bias, self.norm1.bias, self.norm2.bias):
                b.zero_()
            self.norm1.weight.fill_(1.0)
            self.norm2.weight.fill_(1.0)

    def _rest(self, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + attn)
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))

    def forward(self, x: torch.Tensor, kv_valid: torch.Tensor | None = None) -> torch.Tensor:
        return self._rest(x, self.self_attn(x, kv_valid))

    def forward_shards(self, xs: list[torch.Tensor], kv_valid: list[torch.Tensor]) -> list[torch.Tensor]:
        """Every rank's ``forward`` of the context-parallel layer in one process."""
        return [self._rest(x, a) for x, a in zip(xs, self.self_attn.forward_shards(xs, kv_valid))]


class TokenSelfAttention(nn.Module):
    """Multi-head self-attention over the flattened H x W tokens of an NCHW
    map (``srganfd_tpu/models/blocks.py:522-562``, after torch's
    ``nn.MultiheadAttention`` in ``BSRGAN/model.py:388-402``): q, k, v are
    Flax ``DenseGeneral`` projections C -> (H, D) with biases, the logits
    ``einsum(q, k) / sqrt(D)`` (divided after the product, where
    ``dot_product_attention`` scales q first: the two round differently),
    a softmax over the keys, and ``DenseGeneral`` (H, D) -> C on the
    result, all in the input's dtype.

    Returns ``(output, map)``: the output NCHW as the input, and the
    softmax weights averaged over heads, (N, Q, K), torch's
    ``average_attn_weights``. With ``chunk_size`` > 0 the attention is
    exact in query chunks through ``large_attention`` and the map, itself
    O((HW)^2), is None, as in JAX. The parameters take the layout of
    torch's ``nn.MultiheadAttention``: ``in_proj_weight`` (3C, C) stacks q,
    k, v with the output features head-major (h * D + d), ``out_proj``
    maps the H * D features back to C."""

    def __init__(self, channels: int, num_heads: int = 8, chunk_size: int = 0,
                 attn_backend: str | None = None) -> None:
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels are not divisible by {num_heads} heads")
        self.num_heads, self.chunk_size = num_heads, chunk_size
        self.backend = attention_backend(attn_backend)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * channels, channels))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * channels))
        self.out_proj = Linear(channels, channels)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Flax ``DenseGeneral``'s initialiser: lecun-normal kernels over
        the contracted axes (variance 1/C for q, k, v and 1/(H D) for the
        output), truncated at 2 standard deviations; zero biases."""
        with torch.no_grad():
            for w in (self.in_proj_weight, self.out_proj.weight):
                std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
                t = torch.empty(w.shape, dtype=torch.float32)
                nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
                w.copy_(t)
            self.in_proj_bias.zero_()
            self.out_proj.bias.zero_()

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        n, c, h, w = x.shape
        tokens = x.permute(0, 2, 3, 1).reshape(n, h * w, c)
        qkv = _linear(tokens, self.in_proj_weight, self.in_proj_bias).view(n, h * w, 3, self.num_heads, -1)
        q, k, v = qkv.unbind(2)  # (N, T, H, D)
        d = q.shape[-1]
        if self.chunk_size:
            if self.backend == "flash" and d not in FLASH_HEAD_DIMS:
                raise NotImplementedError(
                    f"TokenSelfAttention with chunk_size > 0 on the flash backend: the flash kernel "
                    f"takes head dims {FLASH_HEAD_DIMS}, this layer's is {d}; use the chunked backend"
                )
            out, avg = large_attention(q, k, v, self.chunk_size, self.backend), None
        else:
            logits = torch.einsum("nqhd,nkhd->nhqk", q, k) / torch.tensor(math.sqrt(d), dtype=q.dtype)
            weights = logits.softmax(-1)
            out = torch.einsum("nhqk,nkhd->nqhd", weights, v)
            avg = weights.mean(1)  # (N, Q, K)
        out = self.out_proj(out.reshape(n, h * w, c))
        return out.reshape(n, h, w, c).permute(0, 3, 1, 2), avg
