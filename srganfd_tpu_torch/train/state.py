"""Training state of the port (counterpart of ``srganfd_tpu/train/state.py``).

The JAX package keeps step, parameters, optimizer state and the EMA copy in
one pytree that jit donates; here they are one dataclass of the generator
module, its optimizer and the EMA tensors, updated in place.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

__all__ = ["TrainState", "ema_update"]


@dataclasses.dataclass
class TrainState:
    step: int  # optimizer steps applied so far
    g_model: nn.Module  # the generator: its parameters are G
    g_opt: torch.optim.Optimizer  # G's Adam state
    ema_g: dict[str, torch.Tensor]  # EMA copy of G's parameters, by state-dict name


@torch.no_grad()
def ema_update(
    ema_params: dict[str, torch.Tensor],
    new_params: dict[str, torch.Tensor],
    decay: float,
    reference_semantics: bool = False,
    step: int | None = None,
) -> None:
    """EMA lerp, in place on ``ema_params`` (one multi-tensor op per term,
    not one launch per parameter). Default: the conventional
    ``decay*avg + (1-decay)*p``. ``reference_semantics`` reproduces the
    reference's ``AveragedModel`` as the JAX package does: the inverted
    ``(1-decay)*avg + decay*p`` (``ESRGAN/train_esrgan.py:249``) and, at
    ``step == 0`` (the pre-update step counter), a copy of the model."""
    ema = list(ema_params.values())
    new = [new_params[name].detach() for name in ema_params]
    if reference_semantics and step == 0:
        torch._foreach_copy_(ema, new)
        return
    keep, take = (1.0 - decay, decay) if reference_semantics else (decay, 1.0 - decay)
    torch._foreach_mul_(ema, keep)
    torch._foreach_add_(ema, new, alpha=take)
