"""Per-sample Gaussian and Poisson noise of the Real-ESRGAN chain
(counterpart of ``srganfd_tpu/ops/degrade.py`` ``add_gaussian_noise``,
``poisson_noise_vals`` and ``add_poisson_noise``).

Parity target: ``Real_ESRGAN/imgproc.py:832-919`` (the torch reference's
noise). The noise is drawn from an explicit ``torch.Generator`` on the
images' device, so it cannot equal the JAX package's ``jax.random`` bits:
the tests hold it at the zero-noise limit against the JAX chain and by its
statistics. ``poisson_noise_vals`` is deterministic and equals the JAX
function's integer for integer.

Not ported: ``add_poisson_noise``'s ``vals`` branch (the numpy
reference's semantics of the BSRGAN plus chain) and the correlated
Gaussian branch (ROADMAP.md A9).
"""

from __future__ import annotations

import torch

__all__ = ["add_gaussian_noise", "poisson_noise_vals", "add_poisson_noise"]

# the torchvision rgb_to_grayscale weights the torch reference uses
_LUMA = (0.2989, 0.587, 0.114)


def _per_sample(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None]


def add_gaussian_noise(
    x: torch.Tensor, sigma: torch.Tensor, gray_mask: torch.Tensor, generator: torch.Generator
) -> torch.Tensor:
    """Per-sample Gaussian noise, clipped to [0, 1]. x (N, H, W, C);
    ``sigma`` (N,) in [0, 1] units; ``gray_mask`` (N,) 1.0 => one noise
    channel broadcast over the colours. The colour and gray draws are both
    made, colour first, as the JAX function makes them."""
    n, h, w, c = x.shape
    color = torch.randn((n, h, w, c), generator=generator, device=x.device, dtype=x.dtype)
    gray = torch.randn((n, h, w, 1), generator=generator, device=x.device, dtype=x.dtype)
    noise = torch.where(_per_sample(gray_mask) > 0.5, gray, color) * _per_sample(sigma)
    return (x + noise).clamp(0.0, 1.0)


def poisson_noise_vals(rounded: torch.Tensor) -> torch.Tensor:
    """The torch reference's per-sample shot-noise level
    ``2**ceil(log2(#unique values))`` of an 8-bit-rounded image (N, H, W, C)
    (``Real_ESRGAN/imgproc.py:894-897,905-908``). The unique count is the
    number of occupied bins of the per-sample 256-level histogram (one
    ``bincount`` over sample-offset levels, no loop of ``torch.unique``);
    the power of two is an integer table lookup. Returns (N,) in
    ``rounded``'s dtype."""
    n = rounded.shape[0]
    levels = torch.round(rounded * 255.0).clamp(0, 255).to(torch.int64).reshape(n, -1)
    offsets = 256 * torch.arange(n, device=rounded.device)[:, None]
    hist = torch.bincount((levels + offsets).reshape(-1), minlength=256 * n).reshape(n, 256)
    nuniq = (hist > 0).sum(-1).clamp_min(1)
    powers = 2 ** torch.arange(9, device=rounded.device)  # 1 .. 256
    return powers[torch.searchsorted(powers, nuniq)].to(rounded.dtype)


def add_poisson_noise(
    x: torch.Tensor, scale: torch.Tensor, gray_mask: torch.Tensor, generator: torch.Generator
) -> torch.Tensor:
    """Poisson (shot) noise with the torch reference's semantics
    (``Real_ESRGAN/imgproc.py:869-919``), clipped to [0, 1]: the colour
    source is the 8-bit-rounded image, the gray source the rounded luma
    (0.2989/0.587/0.114) of the UNROUNDED image, each with its own level
    :func:`poisson_noise_vals`; the noise, times ``scale`` (N,), is added to
    the unrounded input. ``gray_mask`` (N,) picks the gray noise per
    sample. Both draws are made, colour first."""
    rounded = torch.round(x * 255.0).clamp(0, 255) / 255.0
    luma = torch.tensor(_LUMA, dtype=x.dtype, device=x.device)
    gray_src = torch.round((x * luma).sum(-1, keepdim=True) * 255.0).clamp(0, 255) / 255.0
    v_color = _per_sample(poisson_noise_vals(rounded))
    v_gray = _per_sample(poisson_noise_vals(gray_src))
    noise_color = torch.poisson(rounded * v_color, generator=generator) / v_color - rounded
    noise_gray = torch.poisson(gray_src * v_gray, generator=generator) / v_gray - gray_src
    noise = torch.where(_per_sample(gray_mask) > 0.5, noise_gray.expand_as(x), noise_color)
    return (x + noise * _per_sample(scale)).clamp(0.0, 1.0)
