"""BSRGAN degradation chain of the port (counterpart of
``srganfd_tpu/ops/degrade.py``: ``BsrganPlan``, ``plan_bsrgan_batch``, the
DiffJPEG chain ``_apply_chain`` and its cropped form).

Parity target: ``degradation_process`` (``BSRGAN/imgproc.py:492-562``) as
this fork ships it, ops 2/3/4 disabled:

  [optional 1/2 pre-downscale when sf == 4, p = scale2_prob]
  -> {blur, blur, maybe-JPEG (p = jpeg_prob)} with the JPEG's slot drawn
  -> final JPEG (always) -> final MATLAB bicubic 1/sf

Every random decision is drawn on the host into a ``BsrganPlan``, with the
JAX package's calls in its order, so one ``np.random.Generator`` state gives
the same plan field by field. The image math runs on the images' device:
both blurs through ``filters.filter2d`` (the hand-written CUDA kernel on a
CUDA tensor), DiffJPEG with a per-sample quality and apply mask, and the
MATLAB bicubic. The two blur slots commute, so only the JPEG's slot among
the three matters; ``per_sample_order`` draws it per sample (three masked
DiffJPEG passes) or once per batch (one pass).

The cv2 codec (``codec="cv2"``) and the plus chain are not ported yet
(ROADMAP.md A9).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from srganfd_tpu_torch.ops import filters, kernels
from srganfd_tpu_torch.ops.augment import paired_random_crop
from srganfd_tpu_torch.ops.jpeg import diff_jpeg
from srganfd_tpu_torch.ops.resize import cv2_style_resize, imresize

__all__ = [
    "BsrganPlan",
    "plan_bsrgan_batch",
    "apply_bsrgan_batch",
    "bsrgan_lr_size",
    "apply_bsrgan_batch_cropped",
]

_KPAD = 25  # the largest BSRGAN kernel (2*11+3)


@dataclasses.dataclass(frozen=True)
class BsrganPlan:
    """One batch's degradation decisions, drawn on the host."""

    kernels_a: np.ndarray  # (N, 25, 25)
    kernels_b: np.ndarray  # (N, 25, 25)
    jpeg_quality: np.ndarray  # (N,) mid-chain quality
    jpeg_apply: np.ndarray  # (N,) float mask {0,1}
    jpeg_pos: int | np.ndarray  # slot of the mid JPEG: int (per batch) or (N,) per sample
    final_jpeg_quality: np.ndarray  # (N,); <= 0 skips the final JPEG of that sample
    scale2: bool  # per-batch 1/2 pre-downscale (sf == 4 only)
    scale2_interp: int  # 0 = MATLAB bicubic, else cv2 flag 1/2/3
    effective_upscale: int
    blur_params: tuple = ()  # the sampled blur decisions behind kernels_a/b


def plan_bsrgan_batch(
    rng: np.random.Generator,
    batch_size: int,
    upscale_factor: int,
    jpeg_prob: float = 0.9,
    scale2_prob: float = 0.25,
    per_sample_order: bool = True,
    **_unused,
) -> BsrganPlan:
    """Draw all chain randomness for one batch. The blur widths scale with
    the effective factor: the reference rebinds sf to 2 after the
    pre-downscale (``BSRGAN/imgproc.py:511``) before the shuffle runs."""
    scale2 = bool(upscale_factor == 4 and rng.random() < scale2_prob)
    scale2_interp = int(rng.choice([1, 2, 3])) if (scale2 and rng.random() < 0.5) else 0
    effective = 2 if scale2 else upscale_factor
    pa = tuple(kernels.sample_bsrgan_blur_params(rng, effective) for _ in range(batch_size))
    pb = tuple(kernels.sample_bsrgan_blur_params(rng, effective) for _ in range(batch_size))
    ka = np.stack(
        [kernels.pad_kernel(kernels.build_bsrgan_blur_kernel(p), _KPAD) for p in pa]
    ).astype(np.float32)
    kb = np.stack(
        [kernels.pad_kernel(kernels.build_bsrgan_blur_kernel(p), _KPAD) for p in pb]
    ).astype(np.float32)
    return BsrganPlan(
        kernels_a=ka,
        kernels_b=kb,
        jpeg_quality=rng.integers(30, 96, size=batch_size).astype(np.float32),
        jpeg_apply=(rng.random(batch_size) < jpeg_prob).astype(np.float32),
        jpeg_pos=(
            rng.integers(0, 3, size=batch_size).astype(np.int32)
            if per_sample_order
            else int(rng.integers(0, 3))
        ),
        final_jpeg_quality=rng.integers(30, 96, size=batch_size).astype(np.float32),
        scale2=scale2,
        scale2_interp=scale2_interp,
        effective_upscale=effective,
        blur_params=(pa, pb),
    )


def _pad16(x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """Reflect-pad H and W of an NHWC batch up to multiples of 16 (at the
    bottom and right, as ``jnp.pad(mode="reflect")`` pads)."""
    h, w = x.shape[1], x.shape[2]
    ph, pw = (-h) % 16, (-w) % 16
    if ph:
        idx = np.pad(np.arange(h), (0, ph), mode="reflect")
        x = x.index_select(1, torch.from_numpy(idx).to(x.device))
    if pw:
        idx = np.pad(np.arange(w), (0, pw), mode="reflect")
        x = x.index_select(2, torch.from_numpy(idx).to(x.device))
    return x, h, w


def _masked_jpeg(x: torch.Tensor, quality: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    padded, h, w = _pad16(x)
    out = diff_jpeg(padded, quality, differentiable=False)[:, :h, :w, :]
    if mask is None:
        return out
    m = mask[:, None, None, None]
    return m * out + (1.0 - m) * x


def _to_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 transport or float [0, 1] -> f32 [0, 1]."""
    x = images.float()
    if not images.dtype.is_floating_point:
        x = x / 255.0
    return x


def _apply_chain(images: torch.Tensor, plan: BsrganPlan) -> torch.Tensor:
    dev = images.device

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(dev)

    x = _to_float(images)
    if plan.scale2:
        h, w = x.shape[1], x.shape[2]
        if plan.scale2_interp == 0:
            x = imresize(x, 0.5)
        else:
            x = cv2_style_resize(x, (int(0.5 * h), int(0.5 * w)), plan.scale2_interp)
        x = x.clamp(0.0, 1.0)

    ka, kb = t(plan.kernels_a), t(plan.kernels_b)
    quality, apply = t(plan.jpeg_quality), t(plan.jpeg_apply)
    if isinstance(plan.jpeg_pos, int):
        # per-batch slot: one DiffJPEG pass
        if plan.jpeg_pos == 0:
            x = _masked_jpeg(x, quality, apply)
        x = filters.filter2d(x, ka)
        if plan.jpeg_pos == 1:
            x = _masked_jpeg(x, quality, apply)
        x = filters.filter2d(x, kb)
        if plan.jpeg_pos == 2:
            x = _masked_jpeg(x, quality, apply)
    else:
        # per-sample slot (the reference's per-sample shuffle): a masked
        # DiffJPEG pass at every slot, selected per sample
        pos = t(plan.jpeg_pos)
        x = _masked_jpeg(x, quality, apply * (pos == 0))
        x = filters.filter2d(x, ka)
        x = _masked_jpeg(x, quality, apply * (pos == 1))
        x = filters.filter2d(x, kb)
        x = _masked_jpeg(x, quality, apply * (pos == 2))

    # final JPEG, always (``BSRGAN/imgproc.py:558``); a non-positive quality
    # skips it for that sample (the chain goldens' JPEG-free scenarios)
    final_q = t(plan.final_jpeg_quality)
    x = _masked_jpeg(x, final_q.clamp_min(1.0), (final_q > 0.0).to(x.dtype))
    return imresize(x, 1.0 / plan.effective_upscale)


def apply_bsrgan_batch(
    images: torch.Tensor, plan: BsrganPlan, codec: str = "diffjpeg"
) -> torch.Tensor:
    """Run the chain on the images' device. images: (N, H, W, 3) RGB [0, 1]
    (or uint8). Output edge: ceil(H' / effective_upscale), H' being H or,
    after the pre-downscale, H/2."""
    if codec == "cv2":
        raise NotImplementedError(
            "codec='cv2' is not ported to srganfd_tpu_torch yet: see ROADMAP.md A9"
        )
    if codec != "diffjpeg":
        raise ValueError(f"unknown codec {codec!r}: expected 'diffjpeg' or 'cv2'")
    return _apply_chain(images, plan)


def bsrgan_lr_size(h: int, plan: BsrganPlan) -> int:
    """The chain's LR edge for an H-px square GT: the optional pre-halve
    (ceil for the MATLAB branch, floor for cv2), then 1/effective_upscale
    with ceil rounding."""
    hp = h
    if plan.scale2:
        hp = (h + 1) // 2 if plan.scale2_interp == 0 else h // 2
    return -(-hp // plan.effective_upscale)


def apply_bsrgan_batch_cropped(
    images: torch.Tensor,
    plan: BsrganPlan,
    tops: np.ndarray,
    lefts: np.ndarray,
    gt_size: int,
    upscale_factor: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chain, then the aligned (gt, lr) random crop. ``tops``/``lefts`` are
    (N,) LR-space offsets in ``[0, bsrgan_lr_size(H, plan) - gt_size //
    upscale_factor]``. Returns (gt (N, gt_size, gt_size, 3), lr)."""
    gt = _to_float(images)
    lr = _apply_chain(gt, plan)
    return paired_random_crop(gt, lr, tops, lefts, gt_size, upscale_factor)
