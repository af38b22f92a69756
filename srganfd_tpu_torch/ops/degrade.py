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

``codec="cv2"`` (evaluation) runs every JPEG stage as the reference's
entropy-coded cv2 round trip on the host, the blurs and resizes on the
device in between (``_apply_chain_cv2``).

The plus chain, ``degradation_process_plus`` (``BSRGAN/imgproc.py:565-623``):
``plan_bsrgan_plus`` draws every decision on the host with the JAX
package's calls in its order (the same plan, field by field, from one
generator state); ``apply_bsrgan_plus`` runs it on the device, USM first,
both blur slots through ``filters.filter2d``, the noise from an explicit
``torch.Generator`` drawn slot after slot (each noise slot's draws
together, in the slot order; the JAX chain splits its key once a slot).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from srganfd_tpu_torch.ops import filters, kernels
from srganfd_tpu_torch.ops.augment import paired_random_crop
from srganfd_tpu_torch.ops.consts import device_const
from srganfd_tpu_torch.ops.jpeg import diff_jpeg
from srganfd_tpu_torch.ops.noise import (
    add_gaussian_noise,
    add_poisson_noise,
    add_speckle_noise,
    sample_correlated_noise_chol,
)
from srganfd_tpu_torch.ops.resize import cv2_style_resize, imresize

__all__ = [
    "BsrganPlan",
    "plan_bsrgan_batch",
    "apply_bsrgan_batch",
    "bsrgan_lr_size",
    "apply_bsrgan_batch_cropped",
    "plan_operands",
    "apply_chain_cropped",
    "plan_bsrgan_plus",
    "apply_bsrgan_plus",
    "bsrgan_degradation_plus",
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
        x = x.index_select(1, device_const(np.pad(np.arange(h), (0, ph), mode="reflect"), x.device))
    if pw:
        x = x.index_select(2, device_const(np.pad(np.arange(w), (0, pw), mode="reflect"), x.device))
    return x, h, w


def _masked_jpeg(x: torch.Tensor, quality: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    padded, h, w = _pad16(x)
    out = diff_jpeg(padded, quality, differentiable=False)[:, :h, :w, :]
    if mask is None:
        return out
    m = mask[:, None, None, None]
    return m * out + (1.0 - m) * x


def _to_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 transport or float [0, 1] -> f32 [0, 1]. uint8 is scaled by the
    f32 reciprocal of 255: under jit XLA turns the JAX chain's ``/ 255.0``
    into that product, which rounds apart from the division in 126 of the
    256 values."""
    x = images.float()
    if not images.dtype.is_floating_point:
        x = x * (1.0 / 255.0)
    return x


def _chain(
    images: torch.Tensor,
    kernels_a: torch.Tensor,
    kernels_b: torch.Tensor,
    quality: torch.Tensor,
    apply: torch.Tensor,
    final_q: torch.Tensor,
    jpeg_pos: int | torch.Tensor,
    scale2: bool,
    scale2_interp: int,
    effective_upscale: int,
) -> torch.Tensor:
    """The chain on operands already on the images' device (the JAX
    ``_apply_chain``): ``jpeg_pos`` an int slot for the batch, or an (N,)
    tensor of per-sample slots. Only the pre-downscale branch and the
    per-batch slot are host decisions, so with a per-sample slot every
    step of one branch runs the same device work, which a CUDA graph can
    replay."""
    x = _to_float(images)
    if scale2:
        h, w = x.shape[1], x.shape[2]
        if scale2_interp == 0:
            x = imresize(x, 0.5)
        else:
            x = cv2_style_resize(x, (int(0.5 * h), int(0.5 * w)), scale2_interp)
        x = x.clamp(0.0, 1.0)

    if isinstance(jpeg_pos, int):
        # per-batch slot: one DiffJPEG pass
        if jpeg_pos == 0:
            x = _masked_jpeg(x, quality, apply)
        x = filters.filter2d(x, kernels_a)
        if jpeg_pos == 1:
            x = _masked_jpeg(x, quality, apply)
        x = filters.filter2d(x, kernels_b)
        if jpeg_pos == 2:
            x = _masked_jpeg(x, quality, apply)
    else:
        # per-sample slot (the reference's per-sample shuffle): a masked
        # DiffJPEG pass at every slot, selected per sample
        x = _masked_jpeg(x, quality, apply * (jpeg_pos == 0))
        x = filters.filter2d(x, kernels_a)
        x = _masked_jpeg(x, quality, apply * (jpeg_pos == 1))
        x = filters.filter2d(x, kernels_b)
        x = _masked_jpeg(x, quality, apply * (jpeg_pos == 2))

    # final JPEG, always (``BSRGAN/imgproc.py:558``); a non-positive quality
    # skips it for that sample (the chain goldens' JPEG-free scenarios)
    x = _masked_jpeg(x, final_q.clamp_min(1.0), (final_q > 0.0).to(x.dtype))
    return imresize(x, 1.0 / effective_upscale)


def plan_operands(plan: BsrganPlan) -> dict[str, np.ndarray]:
    """A per-sample-order plan's per-sample draws as host arrays, the
    operands of :func:`apply_chain_cropped` (its branch key
    ``(scale2, scale2_interp, effective_upscale)`` stays on the host)."""
    if isinstance(plan.jpeg_pos, int):
        raise ValueError("operand form needs a per-sample-order plan (plan_bsrgan_batch(..., per_sample_order=True))")
    return {"kernels_a": plan.kernels_a, "kernels_b": plan.kernels_b, "jpeg_quality": plan.jpeg_quality,
            "jpeg_apply": plan.jpeg_apply, "final_jpeg_quality": plan.final_jpeg_quality,
            "jpeg_pos": np.asarray(plan.jpeg_pos, np.int64)}


def _apply_chain(images: torch.Tensor, plan: BsrganPlan) -> torch.Tensor:
    dev = images.device

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(dev)

    pos = plan.jpeg_pos if isinstance(plan.jpeg_pos, int) else t(plan.jpeg_pos)
    return _chain(images, t(plan.kernels_a), t(plan.kernels_b), t(plan.jpeg_quality), t(plan.jpeg_apply),
                  t(plan.final_jpeg_quality), pos, plan.scale2, plan.scale2_interp, plan.effective_upscale)


def _cv2_jpeg(img_rgb: np.ndarray, quality: float) -> np.ndarray:
    """The reference's entropy-coded JPEG round trip of one image
    (``BSRGAN/imgproc.py:284-293`` without its own quality draw): round to
    uint8, RGB -> BGR, ``cv2.imencode``/``imdecode`` at ``quality``, /255,
    BGR -> RGB."""
    import cv2

    u8 = np.uint8((img_rgb.clip(0, 1) * 255.0).round())
    bgr = cv2.cvtColor(u8, cv2.COLOR_RGB2BGR)
    _, enc = cv2.imencode(".jpg", bgr, [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)])
    return cv2.cvtColor(np.float32(cv2.imdecode(enc, 1)) / 255.0, cv2.COLOR_BGR2RGB)


def _apply_chain_cv2(images: torch.Tensor, plan: BsrganPlan) -> torch.Tensor:
    """``_apply_chain`` with every JPEG stage a cv2 round trip on the host
    (the JAX ``_apply_chain_cv2``): the pre-downscale, both blurs and the
    final bicubic run on the images' device, each JPEG stage copies the
    batch to the host and back."""
    dev = images.device
    x = _to_float(images)
    if plan.scale2:
        h, w = x.shape[1], x.shape[2]
        if plan.scale2_interp == 0:
            x = imresize(x, 0.5)
        else:
            x = cv2_style_resize(x, (int(0.5 * h), int(0.5 * w)), plan.scale2_interp)
        x = x.clamp(0.0, 1.0)
    per_sample = not isinstance(plan.jpeg_pos, int)
    pos, apply, quality = np.asarray(plan.jpeg_pos), np.asarray(plan.jpeg_apply), np.asarray(plan.jpeg_quality)

    def jpeg(x: torch.Tensor, qualities: np.ndarray, fires: np.ndarray) -> torch.Tensor:
        if not fires.any():
            return x
        host = x.cpu().numpy().copy()
        for i in np.flatnonzero(fires):
            host[i] = _cv2_jpeg(host[i], qualities[i])
        return torch.from_numpy(host).to(dev)

    def slot(x: torch.Tensor, k: int) -> torch.Tensor:
        here = pos == k if per_sample else np.full(x.shape[0], k == int(plan.jpeg_pos))
        return jpeg(x, quality, (apply > 0) & here)

    x = slot(x, 0)
    x = filters.filter2d(x, torch.from_numpy(plan.kernels_a).to(dev))
    x = slot(x, 1)
    x = filters.filter2d(x, torch.from_numpy(plan.kernels_b).to(dev))
    x = slot(x, 2)
    final_q = np.asarray(plan.final_jpeg_quality)
    x = jpeg(x, final_q, final_q > 0)  # the same skip sentinel as _apply_chain
    return imresize(x, 1.0 / plan.effective_upscale)


def apply_bsrgan_batch(
    images: torch.Tensor, plan: BsrganPlan, codec: str = "diffjpeg"
) -> torch.Tensor:
    """Run the chain on the images' device. images: (N, H, W, 3) RGB [0, 1]
    (or uint8). Output edge: ceil(H' / effective_upscale), H' being H or,
    after the pre-downscale, H/2. ``codec="cv2"`` (evaluation) takes every
    JPEG stage through the reference's cv2 round trip on the host."""
    if codec == "cv2":
        return _apply_chain_cv2(images, plan)
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


def apply_chain_cropped(
    images: torch.Tensor,
    kernels_a: torch.Tensor,
    kernels_b: torch.Tensor,
    jpeg_quality: torch.Tensor,
    jpeg_apply: torch.Tensor,
    final_jpeg_quality: torch.Tensor,
    jpeg_pos: torch.Tensor,
    tops: torch.Tensor,
    lefts: torch.Tensor,
    scale2: bool,
    scale2_interp: int,
    effective_upscale: int,
    gt_size: int,
    crop_upscale: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The operand-driven chain and aligned crop (the JAX
    ``_apply_chain_cropped``): every per-sample draw (:func:`plan_operands`,
    the per-sample JPEG slots, the LR-space ``tops``/``lefts``) a tensor on
    the images' device, the branch key and sizes static. No host copy and
    no host branch on a value that changes from step to step: the
    degradation-fused train step captures it in a CUDA graph. uint8 images
    are divided by 255 here. Returns (gt (N, gt_size, gt_size, 3), lr)."""
    gt = _to_float(images)
    lr = _chain(gt, kernels_a, kernels_b, jpeg_quality, jpeg_apply, final_jpeg_quality, jpeg_pos, scale2,
                scale2_interp, effective_upscale)
    return paired_random_crop(gt, lr, tops, lefts, gt_size, crop_upscale)


def plan_bsrgan_plus(
    rng: np.random.Generator,
    batch_size: int,
    hw: tuple[int, int],
    upscale_factor: int,
    use_sharp: bool = True,
    shuffle_prob: float = 0.1,
    poisson_prob: float = 0.1,
    speckle_prob: float = 0.1,
) -> dict:
    """Every random decision of ``degradation_process_plus``
    (``BSRGAN/imgproc.py:565-623``) in a host plan, drawn as the JAX
    ``plan_bsrgan_plus`` draws them: full (p = ``shuffle_prob``) or local
    shuffle of the 11 op slots; per slot the blur kernels, ``_add_resize``'s
    up/down/keep branch, scale and interpolation (sizes tracked through
    the order, snapped to multiples of 8), the Gaussian level and branch
    with its correlated covariance, the Poisson gate, level 10**(2U+2) and
    gray gate, the speckle gate and branch, the JPEG quality; then the
    final resize's interpolation and JPEG quality. Every slot gives one
    ``ops`` entry, a skipped gate ``("noop",)``."""
    n = batch_size
    h, w = hw
    full_shuffle = bool(rng.random() < shuffle_prob)
    if full_shuffle:
        order = [int(i) for i in rng.permutation(11)]
    else:
        order = list(range(11))
        order[2:5] = [int(i) for i in rng.permutation(order[2:5])]
        order[7:11] = [int(i) for i in rng.permutation(order[7:11])]

    def noise_branch():
        # colour 0.4 / gray 0.4 / channel-correlated 0.2 (BSRGAN/imgproc.py:229-244, 263-280)
        sigma = rng.integers(2, 26, size=n).astype(np.float32) / 255.0
        r = rng.random(n)
        gray = (r < 0.4).astype(np.float32)
        corr = (r > 0.8).astype(np.float32)
        chol = sample_correlated_noise_chol(rng, n)
        return sigma, gray, corr, chol

    ops: list[tuple] = []
    ch, cw = h, w
    for i in order:
        if i in (0, 6):
            ops.append((
                "blur",
                np.stack([kernels.pad_kernel(kernels.bsrgan_random_blur_kernel(rng, upscale_factor), _KPAD)
                          for _ in range(n)]).astype(np.float32),
            ))
        elif i in (1, 7):
            # _add_resize (BSRGAN/imgproc.py:314-328): up U(1, 2) p = 0.2,
            # down U(0.5/sf, 1) p = 0.7, keep p = 0.1; a random cv2 interpolation
            r = rng.random()
            if r > 0.8:
                s = float(rng.uniform(1.0, 2.0))
            elif r < 0.7:
                s = float(rng.uniform(0.5 / upscale_factor, 1.0))
            else:
                ops.append(("noop",))
                continue
            oh = max(16, int(round(s * ch / 8.0)) * 8)
            ow = max(16, int(round(s * cw / 8.0)) * 8)
            ops.append(("resize", oh, ow, int(rng.choice([1, 2, 3])), s))
            ch, cw = oh, ow
        elif i in (2, 8):
            ops.append(("gauss", *noise_branch()))
        elif i in (3, 9):
            if rng.random() < poisson_prob:
                # shot-noise level 10**(2U+2) in [100, 10^4] per sample (BSRGAN/imgproc.py:249)
                vals = (10.0 ** (2.0 * rng.random(n) + 2.0)).astype(np.float32)
                gray = (rng.random(n) < 0.5).astype(np.float32)
                ops.append(("poisson", vals, gray))
            else:
                ops.append(("noop",))
        elif i in (4, 10):
            if rng.random() < speckle_prob:
                ops.append(("speckle", *noise_branch()))
            else:
                ops.append(("noop",))
        elif i == 5:
            ops.append(("jpeg", rng.integers(30, 96, size=n).astype(np.float32)))
    return {
        "use_sharp": use_sharp,
        "full_shuffle": full_shuffle,
        "order": order,
        "ops": ops,
        "final_size": (h // upscale_factor, w // upscale_factor),
        "final_interp": int(rng.choice([1, 2, 3])),
        "final_jpeg_quality": rng.integers(30, 96, size=n).astype(np.float32),
    }


def apply_bsrgan_plus(images: torch.Tensor, generator: torch.Generator, plan: dict) -> torch.Tensor:
    """Run a :func:`plan_bsrgan_plus` plan on the images' device; the noise
    slots draw from ``generator`` (on that device) in the plan's order."""
    from srganfd_tpu_torch.ops.realesrgan_degrade import usm_sharp  # local: realesrgan_degrade imports this module

    dev = images.device
    n = images.shape[0]

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(dev)

    x = _to_float(images)
    if plan["use_sharp"]:
        x = usm_sharp(x)
    for op in plan["ops"]:
        kind = op[0]
        if kind == "blur":
            x = filters.filter2d(x, t(op[1]))
        elif kind == "resize":
            x = cv2_style_resize(x, (op[1], op[2]), op[3]).clamp(0.0, 1.0)
        elif kind == "gauss":
            x = add_gaussian_noise(x, t(op[1]), t(op[2]), generator, t(op[4]), t(op[3]))
        elif kind == "poisson":
            x = add_poisson_noise(x, torch.ones(n, dtype=x.dtype, device=dev), t(op[2]), generator, vals=t(op[1]))
        elif kind == "speckle":
            x = add_speckle_noise(x, t(op[1]), t(op[2]), generator, t(op[4]), t(op[3]))
        elif kind == "jpeg":
            q = t(op[1])
            # quality <= 0 skips (the forced-decision chain goldens)
            x = _masked_jpeg(x, q.clamp_min(1.0), (q > 0).to(x.dtype))
    x = cv2_style_resize(x, plan["final_size"], plan["final_interp"])
    q = t(plan["final_jpeg_quality"])
    return _masked_jpeg(x.clamp(0.0, 1.0), q.clamp_min(1.0), (q > 0).to(x.dtype))


def bsrgan_degradation_plus(
    images: torch.Tensor,
    rng: np.random.Generator,
    generator: torch.Generator,
    upscale_factor: int,
    use_sharp: bool = True,
    shuffle_prob: float = 0.1,
    poisson_prob: float = 0.1,
    speckle_prob: float = 0.1,
    **_unused,
) -> torch.Tensor:
    """``degradation_process_plus`` (``BSRGAN/imgproc.py:565-623``), plan
    and apply in one call: USM, the 11-op chain over two rounds with local
    (or, p = ``shuffle_prob``, full) shuffling, then the final resize to
    1/sf and JPEG. The op order is drawn per batch, as in the JAX chain."""
    n, h, w, _ = images.shape
    plan = plan_bsrgan_plus(rng, n, (h, w), upscale_factor, use_sharp=use_sharp, shuffle_prob=shuffle_prob,
                            poisson_prob=poisson_prob, speckle_prob=speckle_prob)
    return apply_bsrgan_plus(images, generator, plan)
