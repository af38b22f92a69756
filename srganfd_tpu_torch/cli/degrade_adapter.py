"""Batch adapter: host GT batches -> device (gt, lr) pairs (counterpart of
``srganfd_tpu/cli/degrade_adapter.py``).

Ported: the ``bsrgan`` branch, the fork's chain on the 320 pre-crop
followed, in training, by the aligned random crop to ``gt_image_size``
(``BSRGAN/train_bsrgan.py:399``). The other degradations raise with the
ROADMAP.md item that ports them.
"""

from __future__ import annotations

import numpy as np
import torch

from srganfd_tpu_torch.configs.base import ExperimentConfig
from srganfd_tpu_torch.ops.degrade import (
    apply_bsrgan_batch,
    apply_bsrgan_batch_cropped,
    bsrgan_lr_size,
    plan_bsrgan_batch,
)

__all__ = ["DegradationAdapter"]

_NOT_PORTED = {
    "bicubic": "A8 (other families)",
    "realesrgan": "A8 (other families)",
    "paired": "A8 (other families)",
}


class DegradationAdapter:
    def __init__(
        self,
        cfg: ExperimentConfig,
        seed: int = 0,
        train: bool = True,
        device: torch.device | str = "cpu",
    ) -> None:
        if cfg.degradation in _NOT_PORTED:
            raise NotImplementedError(
                f"degradation {cfg.degradation!r} is not ported to srganfd_tpu_torch yet: "
                f"see ROADMAP.md {_NOT_PORTED[cfg.degradation]}"
            )
        if cfg.degradation != "bsrgan":
            raise ValueError(f"unknown degradation {cfg.degradation!r}")
        self.cfg = cfg
        self.seed = seed
        self.train = train
        self.device = torch.device(device)

    def step_rng(self, step: int) -> np.random.Generator:
        """Degradation randomness keyed by (seed, tag, host, step), as the JAX
        adapter keys it: stateless, so a run resumed at step N draws the
        plans the uninterrupted run drew. The tag keeps the key disjoint
        from ``BatchLoader``'s per-record (seed, batch_no, j) keys. One
        process, so host 0."""
        return np.random.default_rng((self.seed, 0xDE64ADE, 0, step))

    def __call__(self, host_batch: dict[str, np.ndarray], step: int) -> dict[str, torch.Tensor]:
        cfg = self.cfg
        rng = self.step_rng(step)
        n = int(np.shape(host_batch["gt"])[0])
        params = cfg.degradation_params
        plan = plan_bsrgan_batch(
            rng,
            n,
            cfg.upscale_factor,
            jpeg_prob=params.get("jpeg_prob", 0.9),
            scale2_prob=params.get("scale2_prob", 0.25),
            per_sample_order=params.get("per_sample_order", True),
        )
        gt = torch.from_numpy(np.ascontiguousarray(host_batch["gt"])).to(self.device)
        if not self.train:
            return {"gt": gt, "lr": apply_bsrgan_batch(gt, plan)}
        # GT stays at full scale when the chain pre-halves internally: the
        # reference crops gt/lr with the config's factor
        # (train_bsrgan.py:399), so a pair is always gt : gt/upscale_factor
        sf = cfg.upscale_factor
        lr_limit = bsrgan_lr_size(int(np.shape(host_batch["gt"])[1]), plan) - cfg.gt_image_size // sf
        tops = rng.integers(0, lr_limit + 1, n)
        lefts = rng.integers(0, lr_limit + 1, n)
        gt_c, lr_c = apply_bsrgan_batch_cropped(gt, plan, tops, lefts, cfg.gt_image_size, sf)
        return {"gt": gt_c, "lr": lr_c}
