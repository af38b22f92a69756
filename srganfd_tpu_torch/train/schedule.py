"""Learning-rate schedules (counterpart of ``srganfd_tpu/train/schedule.py``).

Parity target: torch ``MultiStepLR`` stepped once per epoch in the reference
scripts: lr = base * gamma^(milestones passed), here over the optimizer step
count with milestones in steps (epoch milestones x steps per epoch).
"""

from __future__ import annotations

from typing import Callable

__all__ = ["multistep_lr"]


def multistep_lr(
    base_lr: float, milestones_steps: tuple[int, ...], gamma: float
) -> Callable[[int], float]:
    """``count -> lr``, ``count`` being the number of updates applied before
    this one (optax's count)."""
    ms = sorted(int(m) for m in milestones_steps)

    def schedule(count: int) -> float:
        return base_lr * gamma ** sum(count >= m for m in ms)

    return schedule
