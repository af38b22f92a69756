"""Real-ESRGAN second-order degradation of the port (counterpart of
``srganfd_tpu/ops/realesrgan_degrade.py``).

Parity target: ``degradation_process`` in ``Real_ESRGAN/imgproc.py:2323-2462``
(the per-batch chain) plus ``USMSharp`` (:1517-1540):

  1st order: blur(k1) -> random resize (up/down/keep, random mode)
             -> Gaussian|Poisson noise (gray prob) -> JPEG
  2nd order: [blur(k2) w/ prob] -> random resize (relative to out size)
             -> noise -> {resize-to-final + sinc + JPEG | JPEG +
             resize-to-final + sinc}  -> quantize (round/255)

Host side, numpy, with the JAX package's draws in its order, so one
``np.random.Generator`` state gives the same values field by field: the
per-sample kernel triple (``sample_kernel_triple``) and the per-batch plan
(``plan_realesrgan_batch``, resize targets snapped to multiples of 8).

Device side: every blur (k1, k2 and the sinc) goes through
``filters.filter2d``, the hand-written kernel on a CUDA tensor; the
resizes are ``cv2_style_resize``; the JPEGs ``diff_jpeg``; the noise is
drawn from an explicit ``torch.Generator`` on the images' device (so it
cannot equal the JAX ``jax.random`` bits; the chain equals JAX's at the
zero-noise limit). USM's Gaussian is ``filters.blur_separable``, two f32
matrix products.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from srganfd_tpu_torch.ops import filters, kernels
from srganfd_tpu_torch.ops.augment import paired_flip_rotate, paired_random_crop
from srganfd_tpu_torch.ops.degrade import _masked_jpeg, _to_float
from srganfd_tpu_torch.ops.noise import add_gaussian_noise, add_poisson_noise
from srganfd_tpu_torch.ops.resize import cv2_style_resize

__all__ = [
    "RealEsrganPlan",
    "sample_kernel_triple_params",
    "build_kernel_triple",
    "sample_kernel_triple",
    "plan_realesrgan_batch",
    "apply_realesrgan_batch",
    "usm_sharp",
    "apply_realesrgan_train_batch",
]


def sample_kernel_triple_params(rng: np.random.Generator, p: dict) -> dict:
    """Per-sample kernel decisions (``Real_ESRGAN/dataset.py:55-133``): a
    random odd size from ``gaussian_kernel_range``; a sinc with probability
    ``sinc_kernel_probability{stage}`` (omega from pi/3 below the range's
    median size, pi/5 at or above it) else a mixed Gaussian; a final sinc
    at a fresh random size with probability ``sinc_kernel_probability3``,
    else None (the identity pulse)."""
    krange = list(p["gaussian_kernel_range"])
    median = int(np.median(krange))

    def one(stage: int) -> dict:
        size = int(rng.choice(krange))
        if rng.random() < p[f"sinc_kernel_probability{stage}"]:
            omega = rng.uniform(np.pi / 3 if size < median else np.pi / 5, np.pi)
            return {"size": size, "sinc": True, "omega": float(omega)}
        return {
            "size": size,
            "sinc": False,
            "mixed": kernels.sample_mixed_kernel_params(
                rng,
                size,
                tuple(p["gaussian_kernel_type"]),
                tuple(p[f"gaussian_kernel_probability{stage}"]),
                tuple(p[f"gaussian_sigma_range{stage}"]),
                tuple(p[f"generalized_kernel_beta_range{stage}"]),
                tuple(p[f"plateau_kernel_beta_range{stage}"]),
            ),
        }

    out = {"k1": one(1), "k2": one(2), "sinc3": None}
    if rng.random() < p["sinc_kernel_probability3"]:
        out["sinc3"] = {
            "size": int(rng.choice(krange)),
            "omega": float(rng.uniform(np.pi / 3, np.pi)),
        }
    return out


def build_kernel_triple(params: dict, pad: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic build from :func:`sample_kernel_triple_params`, every
    kernel centre-padded to ``pad`` x ``pad``, f32. The final sinc is
    synthesised at its drawn size and then padded (``dataset.py:120-126``)."""

    def one(d: dict) -> np.ndarray:
        k = kernels.sinc_kernel(d["omega"], d["size"]) if d["sinc"] else kernels.build_mixed_kernel(d["mixed"])
        return kernels.pad_kernel(k, pad).astype(np.float32)

    if params["sinc3"] is not None:
        sinc = kernels.sinc_kernel(params["sinc3"]["omega"], params["sinc3"]["size"], pad_to=pad).astype(np.float32)
    else:
        sinc = np.zeros((pad, pad), np.float32)
        sinc[pad // 2, pad // 2] = 1.0
    return one(params["k1"]), one(params["k2"]), sinc


def sample_kernel_triple(rng: np.random.Generator, p: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-sample (kernel1, kernel2, sinc_kernel), padded to
    ``sinc_kernel_size``."""
    return build_kernel_triple(sample_kernel_triple_params(rng, p), int(p["sinc_kernel_size"]))


def _snap(v: float, lo: int = 16) -> int:
    return max(lo, int(round(v / 8.0)) * 8)


@dataclasses.dataclass(frozen=True)
class RealEsrganPlan:
    """One batch's chain decisions, drawn on the host."""

    size1: tuple[int, int]
    interp1: int
    size2: tuple[int, int]
    interp2: int
    final_size: tuple[int, int]
    final_interp: int
    second_blur: bool
    jpeg_first_in_stage2: bool
    # per-sample operands, (N,)
    noise1_sigma: np.ndarray
    noise1_poisson_scale: np.ndarray
    noise1_is_poisson: np.ndarray
    noise1_gray: np.ndarray
    jpeg1_quality: np.ndarray  # <= 0 skips that sample's JPEG
    noise2_sigma: np.ndarray
    noise2_poisson_scale: np.ndarray
    noise2_is_poisson: np.ndarray
    noise2_gray: np.ndarray
    jpeg2_quality: np.ndarray
    # the sampled resize decisions before snapping; updown in {0: up, 1: down, 2: keep}
    updown1: int = 2
    scale1: float = 1.0
    updown2: int = 2
    scale2: float = 1.0


def plan_realesrgan_batch(
    rng: np.random.Generator,
    batch_size: int,
    gt_size: tuple[int, int],
    upscale_factor: int,
    p: dict,
) -> RealEsrganPlan:
    """The per-batch chain decisions, mirroring
    ``Real_ESRGAN/imgproc.py:2323-2462``'s draws in the JAX package's order."""
    h, w = gt_size

    def pick_scale(probs, rng_range):
        kind = int(rng.choice(3, p=np.asarray(probs) / np.sum(probs)))
        if kind == 0:  # up
            return kind, float(rng.uniform(1.0, rng_range[1]))
        if kind == 1:  # down
            return kind, float(rng.uniform(rng_range[0], 1.0))
        return kind, 1.0

    ud1, s1 = pick_scale(p["resize_probability1"], p["resize_range1"])
    size1 = (_snap(h * s1), _snap(w * s1))
    ud2, s2 = pick_scale(p["resize_probability2"], p["resize_range2"])
    out_h, out_w = h // upscale_factor, w // upscale_factor
    size2 = (_snap(out_h * upscale_factor * s2), _snap(out_w * upscale_factor * s2))

    def noise_stage(stage: int):
        nr = p[f"noise_range{stage}"]
        ps = p[f"poisson_scale_range{stage}"]
        sigma = rng.uniform(nr[0], nr[1], batch_size).astype(np.float32) / 255.0
        pscale = rng.uniform(ps[0], ps[1], batch_size).astype(np.float32)
        is_poisson = (rng.random(batch_size) >= p[f"gaussian_noise_probability{stage}"]).astype(np.float32)
        gray = (rng.random(batch_size) < p[f"gray_noise_probability{stage}"]).astype(np.float32)
        return sigma, pscale, is_poisson, gray

    n1 = noise_stage(1)
    n2 = noise_stage(2)
    jq1 = rng.uniform(*p["jpeg_range1"], size=batch_size).astype(np.float32)
    jq2 = rng.uniform(*p["jpeg_range2"], size=batch_size).astype(np.float32)
    return RealEsrganPlan(
        size1=size1,
        interp1=int(rng.choice([1, 2, 3])),
        size2=size2,
        interp2=int(rng.choice([1, 2, 3])),
        final_size=(out_h, out_w),
        final_interp=int(rng.choice([1, 2, 3])),
        second_blur=bool(rng.random() < p["second_blur_probability"]),
        jpeg_first_in_stage2=bool(rng.random() < 0.5),
        noise1_sigma=n1[0],
        noise1_poisson_scale=n1[1],
        noise1_is_poisson=n1[2],
        noise1_gray=n1[3],
        jpeg1_quality=jq1,
        noise2_sigma=n2[0],
        noise2_poisson_scale=n2[1],
        noise2_is_poisson=n2[2],
        noise2_gray=n2[3],
        jpeg2_quality=jq2,
        updown1=ud1,
        scale1=s1,
        updown2=ud2,
        scale2=s2,
    )


def _noise(x, generator, sigma, pscale, is_poisson, gray):
    """Gaussian or Poisson per sample: both are drawn (Gaussian first) and
    ``is_poisson`` blends them, as the JAX chain does."""
    gauss = add_gaussian_noise(x, sigma, gray, generator)
    poisson = add_poisson_noise(x, pscale, gray, generator)
    m = is_poisson[:, None, None, None]
    return m * poisson + (1.0 - m) * gauss


def _jpeg16(x: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """DiffJPEG on the reflect-padded-to-16 batch, cropped back; a quality
    <= 0 skips that sample (the chain goldens' sentinel; production
    qualities are drawn from jpeg_range >= 30)."""
    return _masked_jpeg(x, quality.clamp_min(1.0), (quality > 0.0).to(x.dtype))


def apply_realesrgan_batch(
    gt: torch.Tensor,
    k1: torch.Tensor,
    k2: torch.Tensor,
    sinc: torch.Tensor,
    generator: torch.Generator,
    plan: RealEsrganPlan,
) -> torch.Tensor:
    """Run the second-order chain on gt's device. gt: (N, H, W, 3) [0, 1];
    k1, k2, sinc: (N, K, K) per-sample kernels on that device; the noise
    is drawn from ``generator`` (a generator of that device). Returns LR
    (N, H/sf, W/sf, 3) on 8-bit levels. Every stage must be above K // 2
    pixels: the blurs pad by reflection."""

    def t(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=gt.device)

    x = _to_float(gt)
    # ---- first order
    x = filters.filter2d(x, k1)
    x = cv2_style_resize(x, plan.size1, plan.interp1).clamp(0.0, 1.0)
    x = _noise(x, generator, t(plan.noise1_sigma), t(plan.noise1_poisson_scale),
               t(plan.noise1_is_poisson), t(plan.noise1_gray))
    x = _jpeg16(x.clamp(0.0, 1.0), t(plan.jpeg1_quality))
    # ---- second order
    if plan.second_blur:
        x = filters.filter2d(x, k2)
    x = cv2_style_resize(x, plan.size2, plan.interp2).clamp(0.0, 1.0)
    x = _noise(x, generator, t(plan.noise2_sigma), t(plan.noise2_poisson_scale),
               t(plan.noise2_is_poisson), t(plan.noise2_gray)).clamp(0.0, 1.0)
    q2 = t(plan.jpeg2_quality)
    if plan.jpeg_first_in_stage2:
        x = _jpeg16(x, q2)
        x = filters.filter2d(cv2_style_resize(x, plan.final_size, plan.final_interp), sinc)
    else:
        x = filters.filter2d(cv2_style_resize(x, plan.final_size, plan.final_interp), sinc)
        x = _jpeg16(x.clamp(0.0, 1.0), q2)
    # final quantisation to 8-bit levels (imgproc.py:2455-2460); torch.round
    # rounds half to even, as jnp.round does
    return (torch.round(x.clamp(0.0, 1.0) * 255.0) / 255.0).clamp(0.0, 1.0)


def usm_sharp(
    images: torch.Tensor, weight: float = 0.5, radius: int = 51, threshold: float = 10.0
) -> torch.Tensor:
    """Unsharp masking (``Real_ESRGAN/imgproc.py:1517-1540``): Gaussian
    blur residual, soft threshold mask, blend. ``radius`` is odd; sigma as
    cv2.GaussianBlur derives it from the size, 0.3*((k-1)*0.5-1)+0.8."""
    sigma = 0.3 * ((radius - 1) * 0.5 - 1) + 0.8
    k1d = np.exp(-0.5 * ((np.arange(radius) - (radius - 1) / 2.0) / sigma) ** 2)
    k1d = torch.from_numpy((k1d / k1d.sum()).astype(np.float32))
    residual = images - filters.blur_separable(images, k1d)
    mask = (residual.abs() * 255.0 > threshold).to(images.dtype)
    soft_mask = filters.blur_separable(mask, k1d)
    sharp = (images + weight * residual).clamp(0.0, 1.0)
    return soft_mask * sharp + (1.0 - soft_mask) * images


def apply_realesrgan_train_batch(
    gt_raw: torch.Tensor,
    k1: torch.Tensor,
    k2: torch.Tensor,
    sinc: torch.Tensor,
    generator: torch.Generator,
    plan: RealEsrganPlan,
    tops,
    lefts,
    hflips,
    vflips,
    rots,
    gt_size: int,
    upscale_factor: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """USM, the chain on the sharpened GT, aligned crops and paired
    flips/rotation (``Real_ESRGAN/train_realesrgan.py:392-405``). Takes
    uint8 or float GT; the offsets (N,) are LR-space, the flags (N,) in
    {0, 1}. Returns (gt_crop, gt_usm_crop, lr_crop)."""
    gt = _to_float(gt_raw)
    gt_usm = usm_sharp(gt)
    lr = apply_realesrgan_batch(gt_usm, k1, k2, sinc, generator, plan)
    gt_c, lr_c = paired_random_crop(gt, lr, tops, lefts, gt_size, upscale_factor)
    usm_c, _ = paired_random_crop(gt_usm, lr, tops, lefts, gt_size, upscale_factor)
    flags = [torch.as_tensor(np.asarray(f, np.float32), device=gt.device) for f in (hflips, vflips, rots)]
    usm_c, _ = paired_flip_rotate(usm_c, lr_c, *flags)
    gt_c, lr_c = paired_flip_rotate(gt_c, lr_c, *flags)
    return gt_c, usm_c, lr_c
