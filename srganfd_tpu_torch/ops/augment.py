"""Crop / flip / rotate augmentations (counterpart of the parts of
``srganfd_tpu/ops/augment.py`` that the BSRGAN training path uses).

- host-side numpy crops, flips and rot90 of the datasets
  (``ESRGAN/imgproc.py:465-575``, ``BSRGAN/dataset.py:64-80``); the draws
  are the JAX package's, call for call;
- ``paired_random_crop``: the aligned (gt, lr) crop of the BSRGAN train loop
  (``BSRGAN/imgproc.py:846-886``) on tensors;
- ``paired_flip_rotate``: the per-sample paired flips and rot90 of the
  Real-ESRGAN train batch on tensors.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "random_crop_np",
    "center_crop_np",
    "random_rotate_flip_np",
    "paired_random_crop",
    "paired_flip_rotate",
]


def random_crop_np(image: np.ndarray, size: int, rng: np.random.Generator) -> np.ndarray:
    h, w = image.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return image[top : top + size, left : left + size, ...]


def center_crop_np(image: np.ndarray, size: int) -> np.ndarray:
    h, w = image.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return image[top : top + size, left : left + size, ...]


_REFERENCE_ROTATE_SHIFT = {1: (1, 0), 2: (1, 1), 3: (0, 1)}


def random_rotate_flip_np(
    image: np.ndarray,
    rng: np.random.Generator,
    reference_rotate_quirk: bool = False,
) -> np.ndarray:
    """The reference Train-mode augmentation: always rotate by a uniform
    choice of {90, 180, 270} (0 is not in the reference's angle list,
    ``BSRGAN/dataset.py:71``), then horizontal and vertical flips with
    p = 0.5 each. ``reference_rotate_quirk`` adds the reference's one-pixel
    shift on even-sized square crops (its rotation matrix is centred at
    ``(s//2, s//2)``), zero-filling the entering border."""
    k = int(rng.integers(1, 4))
    image = np.rot90(image, k)
    if reference_rotate_quirk and image.shape[0] == image.shape[1] and image.shape[0] % 2 == 0:
        dy, dx = _REFERENCE_ROTATE_SHIFT[k]
        shifted = np.zeros_like(image)
        shifted[dy:, dx:] = image[: image.shape[0] - dy, : image.shape[1] - dx]
        image = shifted
    if rng.random() < 0.5:
        image = image[:, ::-1, ...]
    if rng.random() < 0.5:
        image = image[::-1, :, ...]
    return np.ascontiguousarray(image)


def paired_random_crop(
    gt: torch.Tensor,
    lr: torch.Tensor,
    top_lr,
    left_lr,
    gt_patch: int,
    upscale_factor: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Aligned (gt, lr) crop of NHWC batches: LR offsets (N,) given on the
    host, GT offsets = LR offsets * sf. Returns (gt (N, P, P, C), lr (N,
    P/sf, P/sf, C)). A start that would run past the edge is clamped, as
    ``jax.lax.dynamic_slice`` clamps it."""
    lr_patch = gt_patch // upscale_factor

    def crop(img: torch.Tensor, top: int, left: int, patch: int) -> torch.Tensor:
        top = min(max(top, 0), img.shape[0] - patch)
        left = min(max(left, 0), img.shape[1] - patch)
        return img[top : top + patch, left : left + patch]

    gts, lrs = [], []
    for i, (t, l) in enumerate(zip(np.asarray(top_lr).tolist(), np.asarray(left_lr).tolist())):
        lrs.append(crop(lr[i], t, l, lr_patch))
        gts.append(crop(gt[i], t * upscale_factor, l * upscale_factor, gt_patch))
    return torch.stack(gts), torch.stack(lrs)


def paired_flip_rotate(
    gt: torch.Tensor, lr: torch.Tensor, hflip: torch.Tensor, vflip: torch.Tensor, rot90: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample paired flips, then a 90-degree rotation, of NHWC batches;
    flags (N,) in {0, 1}, the same transform for both members of a pair.
    The rotation (``jnp.rot90(axes=(1, 2))``, towards W) applies only to
    square patches, as in JAX."""

    def flip(img: torch.Tensor) -> torch.Tensor:
        h = hflip.to(img.device)[:, None, None, None] > 0.5
        v = vflip.to(img.device)[:, None, None, None] > 0.5
        img = torch.where(h, img.flip(2), img)
        return torch.where(v, img.flip(1), img)

    gt, lr = flip(gt), flip(lr)
    if gt.shape[1] == gt.shape[2]:
        r = rot90.to(gt.device)[:, None, None, None] > 0.5
        gt = torch.where(r, torch.rot90(gt, 1, dims=(1, 2)), gt)
        lr = torch.where(r, torch.rot90(lr, 1, dims=(1, 2)), lr)
    return gt, lr
