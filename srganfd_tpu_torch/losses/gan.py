"""Adversarial losses (counterpart of ``srganfd_tpu/losses/gan.py``).

- plain BCE-with-logits on real/fake label maps (BSRGAN/Real-ESRGAN/
  A-ESRGAN: ``BSRGAN/train_bsrgan.py:403-427``: the labels are full
  ``[N, H, W, 1]`` maps for the U-Net discriminators);
- ESRGAN's relativistic average form ``C(x_r) - E[C(x_f)]``
  (``ESRGAN/train_esrgan.py:379-381,407-415``), which the trainer runs for
  the ``esrgan`` config. Its means ``E[C(x)]`` are over the global batch,
  as in the JAX step's one program over the data-sharded batch: under data
  parallelism they are all-reduced (:func:`batch_mean`), differentiably.
"""

from __future__ import annotations

import torch

from srganfd_tpu_torch.parallel import comm

__all__ = ["bce_with_logits", "batch_mean", "relativistic_d_loss", "relativistic_g_loss"]


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits (torch ``BCEWithLogitsLoss``
    semantics) in the JAX package's form,
    ``max(x, 0) - x * t + log1p(exp(-|x|))``, computed in at least f32 (bf16
    logits are promoted)."""
    dt = torch.promote_types(logits.dtype, torch.float32)
    x, t = logits.to(dt), targets.to(dt)
    return torch.mean(torch.clamp_min(x, 0.0) - x * t + torch.log1p(torch.exp(-torch.abs(x))))


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over every rank's batch: ``torch.mean`` in a world
    of one; under data parallelism the ranks' sums and counts all-reduced
    by the differentiable all-reduce, so the gradient reaches every rank's
    logits."""
    if comm.world() == 1:
        return torch.mean(x)
    count = torch.full((1,), x.numel(), dtype=x.dtype, device=x.device)
    total = comm.all_reduce_sum_grad(torch.cat([x.sum().reshape(1), count]))
    return total[0] / total[1]


def relativistic_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """ESRGAN discriminator loss: ``BCE(real - mean(fake), 1)`` and
    ``BCE(fake - mean(real), 0)``, each halved (``ESRGAN/train_esrgan.py:400-420``).
    The caller detaches the generator output."""
    loss_real = bce_with_logits(real_logits - batch_mean(fake_logits), torch.ones_like(real_logits))
    loss_fake = bce_with_logits(fake_logits - batch_mean(real_logits), torch.zeros_like(fake_logits))
    return 0.5 * (loss_real + loss_fake)


def relativistic_g_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """ESRGAN generator adversarial term: the symmetric relativistic BCE with
    the labels flipped (``ESRGAN/train_esrgan.py:379-381``); the caller
    detaches the real branch."""
    loss_real = bce_with_logits(real_logits - batch_mean(fake_logits), torch.zeros_like(real_logits))
    loss_fake = bce_with_logits(fake_logits - batch_mean(real_logits), torch.ones_like(fake_logits))
    return 0.5 * (loss_real + loss_fake)
