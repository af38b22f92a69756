"""The port's BSRGAN degradation chain against the JAX package's.

Host-side plans must be equal field by field for one generator state; the
device math (MATLAB bicubic, the cv2-convention resizes, DiffJPEG, the
chain, the aligned crop) must agree with the JAX functions on the same
inputs and replay the executed-reference goldens as
``tests/test_chain_goldens.py`` does.

DiffJPEG rounds ``coef / q`` to the nearest integer; a coefficient within
an ulp of .5 may round the other way in the other framework and move that
8x8 block by up to q/255. Where JPEG runs, a comparison holds every pixel
inside the DiffJPEG-vs-cv2 envelope of the goldens (0.02) and 99.9% of
them to 1e-4. In the whole chain a flip before a blur spreads over the
blur's footprint (up to 56x56 GT pixels for two 25x25 kernels), so one
flip can move a few percent of a crop: there every pixel is held to 0.02
and the mean difference to 1e-4. JPEG-free paths are held to 1e-5.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu.ops import augment as jax_augment
from srganfd_tpu.ops import degrade as jax_degrade
from srganfd_tpu.ops import jpeg as jax_jpeg
from srganfd_tpu.ops import resize as jax_resize
from srganfd_tpu_torch.ops import augment, degrade, jpeg, kernels, resize

GOLDEN = pathlib.Path(__file__).parent / "goldens" / "chain_bsrgan_process.npz"


def _assert_jpeg_close(got, want, what="", spread=False):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert diff.max() < 0.02, f"{what}: max abs {diff.max()}"
    if spread:
        assert diff.mean() <= 1e-4, f"{what}: mean abs {diff.mean()}"
    else:
        assert np.mean(diff <= 1e-4) >= 0.999, f"{what}: {np.mean(diff > 1e-4):.2%} of pixels off"


def _smooth_images(n, h, w, seed):
    """Smooth fields plus noise: blur and JPEG both change them."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for i in range(n):
        base = 0.5 + 0.3 * np.sin(2 * np.pi * (xx * (i + 1) + yy * rng.uniform(0.5, 2)))
        out.append(np.clip(base[..., None] + 0.1 * rng.standard_normal((h, w, 3)), 0, 1))
    return np.stack(out).astype(np.float32)


# -- plans --------------------------------------------------------------------


def _assert_plans_equal(a, b):
    for field in ("kernels_a", "kernels_b", "jpeg_quality", "jpeg_apply", "final_jpeg_quality"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
        assert getattr(a, field).dtype == getattr(b, field).dtype, field
    np.testing.assert_array_equal(np.asarray(a.jpeg_pos), np.asarray(b.jpeg_pos))
    assert type(a.jpeg_pos) is type(b.jpeg_pos)
    for field in ("scale2", "scale2_interp", "effective_upscale", "blur_params"):
        assert getattr(a, field) == getattr(b, field), field


@pytest.mark.parametrize("per_sample_order", [True, False], ids=["per_sample", "per_batch"])
@pytest.mark.parametrize("sf", [2, 4])
def test_plans_equal_field_by_field(sf, per_sample_order):
    for seed in range(12):  # at x4, both scale2 branches and every interp occur
        rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jax_degrade.plan_bsrgan_batch(rng_j, 4, sf, per_sample_order=per_sample_order)
        got = degrade.plan_bsrgan_batch(rng_t, 4, sf, per_sample_order=per_sample_order)
        _assert_plans_equal(got, want)
        assert rng_j.random() == rng_t.random()  # the same number of draws


def test_blur_kernels_equal_the_jax_package_bit_for_bit():
    from srganfd_tpu.ops import kernels as jax_kernels

    for seed in range(20):
        p = kernels.sample_bsrgan_blur_params(np.random.default_rng(seed), 2)
        assert p == jax_kernels.sample_bsrgan_blur_params(np.random.default_rng(seed), 2)
        np.testing.assert_array_equal(kernels.build_bsrgan_blur_kernel(p),
                                      jax_kernels.build_bsrgan_blur_kernel(p))
        np.testing.assert_array_equal(kernels.pad_kernel(kernels.build_bsrgan_blur_kernel(p), 25),
                                      jax_kernels.pad_kernel(jax_kernels.build_bsrgan_blur_kernel(p), 25))


# -- resizes ------------------------------------------------------------------


@pytest.mark.parametrize("scale,antialias", [(0.5, True), (1 / 3, True), (2.0, True), (0.5, False)],
                         ids=["half", "third", "double", "half_noaa"])
def test_imresize_matches_jax(scale, antialias):
    x = _smooth_images(2, 37, 29, seed=0)
    got = resize.imresize(torch.from_numpy(x), scale, antialiasing=antialias).numpy()
    want = np.asarray(jax_resize.imresize(jnp.asarray(x), scale, antialiasing=antialias))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["down_half", "down_quarter", "down_third", "down_odd",
                                  "up_double", "gray_down"])
def test_imresize_matches_matlab_goldens(goldens, case):
    g = goldens("matlab_resize")
    got = resize.imresize(torch.from_numpy(g[f"{case}_in"]), float(g[f"{case}_scale"])).numpy()
    want = g[f"{case}_out"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("interp", [1, 2, 3], ids=["linear", "cubic", "area"])
@pytest.mark.parametrize("out_hw", [(20, 18), (50, 47)], ids=["down", "up"])
def test_cv2_style_resize_matches_jax(interp, out_hw):
    x = _smooth_images(2, 40, 36, seed=1)
    got = resize.cv2_style_resize(torch.from_numpy(x), out_hw, interp).numpy()
    want = np.asarray(jax_resize.cv2_style_resize(jnp.asarray(x), out_hw, interp))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# -- crops and JPEG -------------------------------------------------------------


def test_paired_random_crop_matches_exactly():
    rng = np.random.default_rng(2)
    gt = rng.uniform(size=(3, 40, 40, 3)).astype(np.float32)
    lr = rng.uniform(size=(3, 20, 20, 3)).astype(np.float32)
    tops, lefts = rng.integers(0, 9, 3), rng.integers(0, 9, 3)
    got = augment.paired_random_crop(torch.from_numpy(gt), torch.from_numpy(lr), tops, lefts, 24, 2)
    want = jax_augment.paired_random_crop(jnp.asarray(gt), jnp.asarray(lr), jnp.asarray(tops),
                                          jnp.asarray(lefts), 24, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_host_augmentations_match_exactly():
    img = np.random.default_rng(3).uniform(size=(30, 34, 3)).astype(np.float32)
    from srganfd_tpu.ops.augment import center_crop_np, random_crop_np, random_rotate_flip_np

    for seed in range(8):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(augment.random_crop_np(img, 24, r1), random_crop_np(img, 24, r2))
        np.testing.assert_array_equal(augment.random_rotate_flip_np(img[:24, :24], r1),
                                      random_rotate_flip_np(img[:24, :24], r2))
    np.testing.assert_array_equal(augment.center_crop_np(img, 24), center_crop_np(img, 24))


@pytest.mark.parametrize("differentiable,transpose_tables",
                         [(False, False), (True, False), (False, True)],
                         ids=["round", "diff_round", "transposed_tables"])
def test_diff_jpeg_matches_jax(differentiable, transpose_tables):
    x = _smooth_images(3, 32, 48, seed=4)
    q = np.array([30.0, 62.0, 95.0], np.float32)
    got = jpeg.diff_jpeg(torch.from_numpy(x), torch.from_numpy(q), differentiable, transpose_tables)
    want = jax_jpeg.diff_jpeg(jnp.asarray(x), jnp.asarray(q), differentiable=differentiable,
                              transpose_tables=transpose_tables)
    assert got.shape == x.shape and got.dtype == torch.float32
    _assert_jpeg_close(got.numpy(), np.asarray(want), "diff_jpeg")
    assert np.abs(got.numpy() - x).max() > 0.01  # the codec did change the images


def test_jpeg_quality_to_factor_matches_jax():
    q = np.arange(1, 101, dtype=np.float32)
    np.testing.assert_allclose(jpeg.jpeg_quality_to_factor(torch.from_numpy(q)).numpy(),
                               np.asarray(jax_jpeg.jpeg_quality_to_factor(jnp.asarray(q))), rtol=1.2e-7)


# -- the chain -------------------------------------------------------------------


def _golden_names():
    with np.load(GOLDEN) as data:
        return sorted({k.split("/")[0] for k in data.files if "/" in k})


@pytest.mark.parametrize("name", _golden_names())
def test_chain_replays_executed_reference_goldens(name):
    data = np.load(GOLDEN)
    image = data["input"]
    sf, scale2, interp, jpeg_pos, mid_fires, mid_q, final_q = (int(v) for v in data[f"{name}/meta"])
    plan = degrade.BsrganPlan(
        kernels_a=kernels.pad_kernel(data[f"{name}/kernel_a"].astype(np.float32), 25)[None],
        kernels_b=kernels.pad_kernel(data[f"{name}/kernel_b"].astype(np.float32), 25)[None],
        jpeg_quality=np.array([mid_q if mid_fires else 50.0], np.float32),
        jpeg_apply=np.array([float(mid_fires)], np.float32),
        jpeg_pos=jpeg_pos,
        final_jpeg_quality=np.array([float(final_q) if final_q else 0.0], np.float32),
        scale2=bool(scale2),
        scale2_interp=interp,
        effective_upscale=2 if scale2 else sf,
    )
    got = degrade.apply_bsrgan_batch(torch.from_numpy(image[None]), plan)[0].numpy()
    want = data[f"{name}/lr"]
    assert got.shape == want.shape
    assert got.shape[0] == degrade.bsrgan_lr_size(image.shape[0], plan)
    err = float(np.max(np.abs(got - want)))
    if name.endswith("_exact_nojpeg"):
        assert err <= 1e-5, f"{name}: codec-free chain diverged by {err}"
    else:
        assert err < 0.02, f"{name}: JPEG chain outside the DiffJPEG envelope ({err})"


def _cropped_both(images_u8, plan, gt_size, sf, seed):
    rng = np.random.default_rng(seed)
    lim = degrade.bsrgan_lr_size(images_u8.shape[1], plan) - gt_size // sf
    tops, lefts = rng.integers(0, lim + 1, len(images_u8)), rng.integers(0, lim + 1, len(images_u8))
    gt_t, lr_t = degrade.apply_bsrgan_batch_cropped(torch.from_numpy(images_u8), plan, tops, lefts,
                                                    gt_size, sf)
    gt_j, lr_j = jax_degrade.apply_bsrgan_batch_cropped(images_u8, plan, tops, lefts, gt_size, sf)
    # uint8 / 255: XLA may multiply by the reciprocal, one f32 ulp apart
    np.testing.assert_allclose(gt_t.numpy(), np.asarray(gt_j), rtol=1.2e-7, atol=0)
    assert lr_t.shape == (len(images_u8), gt_size // sf, gt_size // sf, 3)
    return lr_t.numpy(), np.asarray(lr_j)


def _u8_batch(seed):
    return (_smooth_images(4, 64, 64, seed) * 255).round().astype(np.uint8)


@pytest.mark.parametrize("per_sample_order", [True, False], ids=["per_sample", "per_batch"])
def test_cropped_chain_matches_jax_on_uint8(per_sample_order):
    plan = degrade.plan_bsrgan_batch(np.random.default_rng(5), 4, 2, jpeg_prob=1.0,
                                     per_sample_order=per_sample_order)
    got, want = _cropped_both(_u8_batch(6), plan, 48, 2, seed=7)
    _assert_jpeg_close(got, want, "cropped chain", spread=True)


@pytest.mark.parametrize("interp", [0, 1, 2, 3], ids=["matlab", "linear", "cubic", "area"])
def test_jpeg_free_x4_chain_matches_jax_to_roundoff(interp):
    """The x4 pre-halving branch, every interpolation, with both JPEG
    stages switched off (apply mask 0, final quality 0): no rounding tie
    can hide a difference here."""
    plan = degrade.plan_bsrgan_batch(np.random.default_rng(8), 4, 4)
    plan = degrade.BsrganPlan(**{
        **plan.__dict__, "scale2": True, "scale2_interp": interp, "effective_upscale": 2,
        "jpeg_apply": np.zeros(4, np.float32), "final_jpeg_quality": np.zeros(4, np.float32),
    })
    got, want = _cropped_both(_u8_batch(9), plan, 32, 4, seed=10)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
