"""Where ``chip_smoke.py``'s ``dp2_phase`` references spread, on the CPU.

``dp2_phase`` holds two ranks' synced first-step gradients to one process
on both ranks' pairs, within 10x that reference's own spread between the
two orders of the pairs. This script reads, per update phase of the step
(``||a - b|| / ||b||`` over the phase's gradients, in the step's order),
at tiny widths in f32 on the CPU, from one seeded state:

- ``bsrgan``: the two orders of a batch of 4 at one epoch (the ranks'
  ``cli.train --epochs 1``), and one epoch against the config's default
  15 on one order. The LR milestones are fractions of the epochs, so one
  epoch puts both at step 0: D's first update then runs at gamma^2 of its
  rate, which moves the G update that follows it (D-first), not D's;
- ``esrgan``: the two orders of a batch of 4 as it is, and with only
  BatchNorm's batch moments summed in f64 (the step's own code on an f64
  copy): its f32 fast variance E[x^2] - E[x]^2 cancels.

    python3 dp_spread_study.py

Prints one JSON object; a few tens of seconds on 4 threads.
"""

import json
import math

import numpy as np
import torch

from srganfd_tpu_torch import configs
from srganfd_tpu_torch.models import blocks
from srganfd_tpu_torch.train import loop

TINY_G = {"bsrgan": {"channels": 16, "growth_channels": 8, "num_rrdb": 2},
          "esrgan": {"channels": 16, "growth_channels": 8, "num_blocks": 2}}
GT = {"bsrgan": 64, "esrgan": 128}
SF = {"bsrgan": 2, "esrgan": 4}
SWAPPED = [2, 3, 0, 1]  # rank 1's pairs first


def first_step_grads(name: str, order: list[int], epochs: int, bn64: bool = False) -> list[list[torch.Tensor]]:
    """The gradients of each update phase of the first f32 step on the
    batch in ``order``, from the state seeded by 0."""
    cfg = configs.get_config(name, batch_size=4, compute_dtype="float32", epochs=epochs, g_kwargs=TINY_G[name])
    gts = torch.from_numpy(np.random.default_rng(1).uniform(size=(4, GT[name], GT[name], 3)).astype(np.float32))
    lrs = gts[:, ::SF[name], ::SF[name], :].contiguous()
    tr = loop.Trainer(cfg, steps_per_epoch=1, device="cpu")
    real, moments = loop.Trainer._apply_update, blocks.BatchNorm.__dict__["_batch_moments"]
    grads = []

    def apply_update(self, opt, params):
        grads.append([p.grad.detach().clone() for p in params if p.grad is not None])
        return real(self, opt, params)

    torch.manual_seed(0)
    state = tr.init_state()
    loop.Trainer._apply_update = apply_update
    if bn64:
        f = moments.__func__
        blocks.BatchNorm._batch_moments = staticmethod(lambda xs: tuple(m.to(xs.dtype) for m in f(xs.double())))
    try:
        tr.train_step(state, gts[order], lrs[order])
    finally:
        loop.Trainer._apply_update, blocks.BatchNorm._batch_moments = real, moments
    return grads


def phase_rel(a: list, b: list) -> list[float]:
    out = []
    for xs, ys in zip(a, b):
        diff = math.sqrt(sum(float((x.double() - y.double()).square().sum()) for x, y in zip(xs, ys)))
        out.append(diff / math.sqrt(sum(float(y.double().square().sum()) for y in ys)))
    return out


def main() -> None:
    torch.set_num_threads(4)
    ident = [0, 1, 2, 3]
    bs = first_step_grads("bsrgan", ident, 1)
    es = first_step_grads("esrgan", ident, 1)
    es64 = first_step_grads("esrgan", ident, 1, bn64=True)
    print(json.dumps({
        "bsrgan_reorder_spread": phase_rel(first_step_grads("bsrgan", SWAPPED, 1), bs),
        "bsrgan_15_epochs_vs_1": phase_rel(first_step_grads("bsrgan", ident, 15), bs),
        "esrgan_reorder_spread": phase_rel(first_step_grads("esrgan", SWAPPED, 1), es),
        "esrgan_reorder_spread_bn_moments_f64": phase_rel(first_step_grads("esrgan", SWAPPED, 1, bn64=True), es64),
    }))


if __name__ == "__main__":
    main()
