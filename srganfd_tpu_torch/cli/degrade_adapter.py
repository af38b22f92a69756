"""Batch adapter: host GT batches -> device (gt, lr[, gt_pixel]) batches
(counterpart of ``srganfd_tpu/cli/degrade_adapter.py``).

Ported:

- ``bsrgan``: the fork's chain on the 320 pre-crop followed, in training,
  by the aligned random crop to ``gt_image_size``
  (``BSRGAN/train_bsrgan.py:399``);
- ``realesrgan``: USM, the second-order chain on the sharpened GT, then in
  training aligned crops and paired flips/rotation
  (``Real_ESRGAN/train_realesrgan.py:392-405``); ``gt_pixel`` is the
  sharpened GT that the pixel and content losses target;
- ``bicubic`` (ESRGAN): the GT crop as it comes (uint8 scaled by 1/255)
  and its MATLAB-bicubic downscale by ``1 / upscale_factor``, clipped to
  [0, 1] (``ESRGAN/dataset.py``, ``imresize``), the same in training and
  evaluation;
- ``paired``: the LR comes from the dataset (``PairedImageDataset``); GT
  and LR go to the device exactly as read, with no crop, flip or rounding.
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
from srganfd_tpu_torch.ops.resize import imresize
from srganfd_tpu_torch.ops.realesrgan_degrade import (
    apply_realesrgan_batch,
    apply_realesrgan_train_batch,
    plan_realesrgan_batch,
    usm_sharp,
)
from srganfd_tpu_torch.parallel import comm

__all__ = ["DegradationAdapter"]


def _tensor(x, device: torch.device) -> torch.Tensor:
    """A host batch's array (numpy, or a tensor from ``prefetch_to_device``
    or the native loader) on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device)


class DegradationAdapter:
    def __init__(
        self,
        cfg: ExperimentConfig,
        seed: int = 0,
        train: bool = True,
        device: torch.device | str = "cpu",
        eval_codec: str = "diffjpeg",
    ) -> None:
        """``eval_codec`` is the JPEG of the BSRGAN chain in evaluation
        (``train=False``): ``"diffjpeg"``, the chain's own, or ``"cv2"``,
        the reference's entropy-coded round trip on the host
        (``BSRGAN/imgproc.py:284-293``); training keeps DiffJPEG."""
        if eval_codec not in ("diffjpeg", "cv2"):
            raise ValueError(f"unknown codec {eval_codec!r}: expected 'diffjpeg' or 'cv2'")
        if cfg.degradation not in ("bsrgan", "realesrgan", "bicubic", "paired"):
            raise ValueError(f"unknown degradation {cfg.degradation!r}")
        self.cfg = cfg
        self.seed = seed
        self.train = train
        self.device = torch.device(device)
        self.eval_codec = eval_codec
        self.rank = comm.data_rank()  # the ranks of one data row draw alike

    def step_rng(self, step: int) -> np.random.Generator:
        """Degradation randomness keyed by (seed, tag, rank, step), as the
        JAX adapter keys it by ``jax.process_index()``: stateless, so a run
        resumed at step N draws the plans the uninterrupted run drew. The
        tag keeps the key disjoint from ``BatchLoader``'s per-record (seed,
        batch_no, j) keys. Every draw of a step comes from it (the plans,
        the crops, the flips and the Real-ESRGAN noise's seed), so under
        data parallelism each rank degrades its shard with its own draws;
        rank 0's are the single process's."""
        return np.random.default_rng((self.seed, 0xDE64ADE, self.rank, step))

    def __call__(self, host_batch: dict[str, np.ndarray | torch.Tensor], step: int) -> dict[str, torch.Tensor]:
        if self.cfg.degradation == "paired":
            return {k: _tensor(host_batch[k], self.device) for k in ("gt", "lr")}
        if self.cfg.degradation == "realesrgan":
            return self._realesrgan(host_batch, step)
        if self.cfg.degradation == "bicubic":
            return self._bicubic(host_batch["gt"])
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
        gt = _tensor(host_batch["gt"], self.device)
        if not self.train:
            return {"gt": gt, "lr": apply_bsrgan_batch(gt, plan, codec=self.eval_codec)}
        # GT stays at full scale when the chain pre-halves internally: the
        # reference crops gt/lr with the config's factor
        # (train_bsrgan.py:399), so a pair is always gt : gt/upscale_factor
        sf = cfg.upscale_factor
        lr_limit = bsrgan_lr_size(int(np.shape(host_batch["gt"])[1]), plan) - cfg.gt_image_size // sf
        tops = rng.integers(0, lr_limit + 1, n)
        lefts = rng.integers(0, lr_limit + 1, n)
        gt_c, lr_c = apply_bsrgan_batch_cropped(gt, plan, tops, lefts, cfg.gt_image_size, sf)
        return {"gt": gt_c, "lr": lr_c}

    def _bicubic(self, gt_host: np.ndarray) -> dict[str, torch.Tensor]:
        """GT in f32 (uint8 scaled by 1/255) and its MATLAB-bicubic LR, as
        the JAX adapter's ``_bicubic_pair``; no randomness."""
        gt = _tensor(gt_host, self.device)
        # uint8: the f32 reciprocal's product, as the jitted JAX pair computes it (ops/degrade.py _to_float)
        gt = gt.to(torch.float32) * (1.0 / 255.0) if not gt.is_floating_point() else gt.to(torch.float32)
        return {"gt": gt, "lr": imresize(gt, 1.0 / self.cfg.upscale_factor).clamp(0.0, 1.0)}

    def _realesrgan(self, host_batch: dict[str, np.ndarray], step: int) -> dict[str, torch.Tensor]:
        """The host draws in the JAX adapter's order: the plan, one integer
        that seeds the device generator of the noise (where JAX draws its
        PRNG key), then tops, lefts and the three flip flags."""
        cfg = self.cfg
        rng = self.step_rng(step)
        n, h, w = (int(v) for v in np.shape(host_batch["gt"])[:3])
        plan = plan_realesrgan_batch(rng, n, (h, w), cfg.upscale_factor, cfg.degradation_params["process"])
        generator = torch.Generator(device=self.device).manual_seed(int(rng.integers(0, 2**31)))
        dev = lambda k: _tensor(host_batch[k], self.device)  # noqa: E731
        k1, k2, sinc = dev("kernel1"), dev("kernel2"), dev("sinc_kernel")
        if not self.train:
            gt = dev("gt")
            gt_usm = usm_sharp(gt)
            return {"gt": gt, "gt_pixel": gt_usm,
                    "lr": apply_realesrgan_batch(gt_usm, k1, k2, sinc, generator, plan)}
        sf = cfg.upscale_factor
        lr_limit_h = plan.final_size[0] - cfg.gt_image_size // sf
        lr_limit_w = plan.final_size[1] - cfg.gt_image_size // sf
        tops = rng.integers(0, max(lr_limit_h, 0) + 1, n)
        lefts = rng.integers(0, max(lr_limit_w, 0) + 1, n)
        hf = (rng.random(n) < 0.5).astype(np.float32)
        vf = (rng.random(n) < 0.5).astype(np.float32)
        rot = (rng.random(n) < 0.5).astype(np.float32)
        gt_c, usm_c, lr_c = apply_realesrgan_train_batch(
            dev("gt"), k1, k2, sinc, generator, plan, tops, lefts, hf, vf, rot, cfg.gt_image_size, sf)
        return {"gt": gt_c, "gt_pixel": usm_c, "lr": lr_c}
