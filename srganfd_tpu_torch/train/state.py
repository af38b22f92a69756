"""Training state of the port (counterpart of ``srganfd_tpu/train/state.py``).

The JAX package keeps step, parameters, optimizer states, the EMA copy and
the discriminator's mutable collections in one pytree that jit donates;
here they are one dataclass of the generator module, its optimizer, the
EMA tensors and, for a GAN, the discriminator module (its spectral-norm
``u`` vectors are buffers of it) and its optimizer, updated in place.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

__all__ = ["TrainState", "ema_update"]


@dataclasses.dataclass
class TrainState:
    step: int  # train steps taken so far, skipped updates included
    g_model: nn.Module  # the generator: its parameters are G
    g_opt: torch.optim.Optimizer  # G's Adam state
    ema_g: dict[str, torch.Tensor]  # EMA copy of G's parameters, by state-dict name
    d_model: nn.Module | None = None  # the discriminator, None for generator-only configs
    d_opt: torch.optim.Optimizer | None = None  # D's Adam state
    # updates applied to G and to D: optax's counts, which drive the
    # schedules; below ``step`` only where skip_nonfinite_updates skipped one
    g_count: int = 0
    d_count: int = 0


@torch.no_grad()
def ema_update(
    ema_params: dict[str, torch.Tensor],
    new_params: dict[str, torch.Tensor],
    decay: float,
    reference_semantics: bool = False,
    step: int | torch.Tensor | None = None,
) -> None:
    """EMA lerp, in place on ``ema_params`` (one multi-tensor op per term,
    not one launch per parameter). Default: the conventional
    ``decay*avg + (1-decay)*p``. ``reference_semantics`` reproduces the
    reference's ``AveragedModel`` as the JAX package does: the inverted
    ``(1-decay)*avg + decay*p`` (``ESRGAN/train_esrgan.py:249``) and, at
    ``step == 0`` (the pre-update step counter), a copy of the model. A
    ``step`` tensor on the device selects the copy there (no host read)."""
    ema = list(ema_params.values())
    new = [new_params[name].detach() for name in ema_params]
    first = reference_semantics and isinstance(step, torch.Tensor)
    if reference_semantics and not first and step == 0:
        torch._foreach_copy_(ema, new)
        return
    keep, take = (1.0 - decay, decay) if reference_semantics else (decay, 1.0 - decay)
    torch._foreach_mul_(ema, keep)
    torch._foreach_add_(ema, new, alpha=take)
    if first:
        for e, n in zip(ema, new):
            e.copy_(torch.where(step == 0, n, e))
