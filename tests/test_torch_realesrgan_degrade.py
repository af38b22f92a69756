"""The port's Real-ESRGAN degradation against the JAX package's.

Host side, equal bit for bit or field by field for one
``np.random.Generator`` state: the kernel families, the kernel triple, the
batch plan, the dataset's records. ``poisson_noise_vals`` is deterministic
and held exactly.

Device side: the noise is drawn from a ``torch.Generator``, so it cannot
equal ``jax.random``'s bits. The chain is held to the JAX package at the
zero-noise limit (sigma 0, Poisson scale 0): on the executed-reference
goldens as ``tests/test_chain_goldens.py`` holds the JAX chain (the
chain ends in round(x*255)/255, so a value on a .5 boundary may move one
8-bit level: max one level, under 1% of pixels off), and on sampled plans.
The noise itself is held by its statistics: mean and variance per sample
against their analytic values.

Sizes: GT 64 at x4, and GT 32, whose last stage (8x8) is below the K = 21
kernels' reflect pad of 10: the blurs then fold the reflection again, as
``jnp.pad(mode="reflect")`` does.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu import configs as jax_configs
from srganfd_tpu.cli.degrade_adapter import DegradationAdapter as JaxAdapter
from srganfd_tpu.data import datasets as jax_datasets
from srganfd_tpu.ops import augment as jax_augment
from srganfd_tpu.ops import degrade as jax_degrade
from srganfd_tpu.ops import filters as jax_filters
from srganfd_tpu.ops import kernels as jax_kernels
from srganfd_tpu.ops import realesrgan_degrade as jax_re
from srganfd_tpu_torch import configs
from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
from srganfd_tpu_torch.data import datasets
from srganfd_tpu_torch.ops import augment, filters, kernels, noise
from srganfd_tpu_torch.ops import realesrgan_degrade as re
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

GOLDEN_RE = pathlib.Path(__file__).parent / "goldens" / "chain_realesrgan.npz"
MODEL = jax_configs.get_config("realesrgan").degradation_params["model"]
PROCESS = jax_configs.get_config("realesrgan").degradation_params["process"]
KINDS = MODEL["gaussian_kernel_type"]


def _images(n, h, w, seed):
    """Smooth fields plus noise and a sharp edge: blur, USM and JPEG all
    change them."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for i in range(n):
        base = 0.5 + 0.3 * np.sin(2 * np.pi * (xx * (i + 1) + yy * rng.uniform(0.5, 2)))
        base += 0.15 * (xx > 0.5)
        out.append(np.clip(base[..., None] + 0.05 * rng.standard_normal((h, w, 3)), 0, 1))
    return np.stack(out).astype(np.float32)


def _assert_quantised_close(got, want, what=""):
    """The chain-golden rule: at most one 8-bit level anywhere, and under 1%
    of the pixels off a level."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    frac = float(np.mean(diff > 1e-5))
    assert diff.max() <= 1.0 / 255.0 + 1e-5 and frac < 0.01, f"{what}: max {diff.max()}, {frac:.2%} off"


# -- host: kernels, plans, records --------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_mixed_kernel_families_equal_jax_bit_for_bit(kind):
    probs = tuple(1.0 if k == kind else 0.0 for k in KINDS)
    for seed in range(6):
        rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
        args = (21, KINDS, probs, (0.2, 3.0), (0.5, 4.0), (1.0, 2.0))
        pj = jax_kernels.sample_mixed_kernel_params(rng_j, *args)
        pt = kernels.sample_mixed_kernel_params(rng_t, *args)
        assert pt == pj and pt["kind"] == kind
        np.testing.assert_array_equal(kernels.build_mixed_kernel(pt), jax_kernels.build_mixed_kernel(pj))
        assert rng_j.random() == rng_t.random()


@pytest.mark.parametrize("size,pad_to", [(7, 0), (13, 21), (21, 21)])
def test_sinc_kernel_equals_jax_bit_for_bit(size, pad_to):
    for omega in (np.pi / 5, 1.3, np.pi):
        got = kernels.sinc_kernel(omega, size, pad_to=pad_to)
        np.testing.assert_array_equal(got, jax_kernels.sinc_kernel(omega, size, pad_to=pad_to))
        if omega == np.pi:  # J1 < 0 for pi * r in (3.83, 7.02): taps at r in (1.22, 2.23)
            assert (got < 0).any()


def test_kernel_triple_equals_jax_bit_for_bit():
    """40 records: every branch (sinc or mixed in both stages, the final
    sinc or the identity pulse) occurs."""
    seen = set()
    for seed in range(40):
        rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
        pj = jax_re.sample_kernel_triple_params(rng_j, MODEL)
        pt = re.sample_kernel_triple_params(rng_t, MODEL)
        assert pt == pj
        for got, want in zip(re.build_kernel_triple(pt, 21), jax_re.build_kernel_triple(pj, 21)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        assert rng_j.random() == rng_t.random()
        seen |= {("k1", pt["k1"]["sinc"]), ("k2", pt["k2"]["sinc"]), ("sinc3", pt["sinc3"] is None)}
    assert len(seen) == 6


@pytest.mark.parametrize("gt_size,sf", [((64, 64), 4), ((256, 256), 4), ((96, 80), 2)])
def test_plan_equals_jax_field_by_field(gt_size, sf):
    for seed in range(12):
        rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jax_re.plan_realesrgan_batch(rng_j, 4, gt_size, sf, PROCESS)
        got = re.plan_realesrgan_batch(rng_t, 4, gt_size, sf, PROCESS)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b and type(a) is type(b), f.name
        assert rng_j.random() == rng_t.random()


@pytest.mark.parametrize("mode", ["Train", "Valid"])
def test_dataset_records_equal_jax(tmp_path, mode):
    import cv2

    for i in range(3):
        cv2.imwrite(str(tmp_path / f"{i}.png"), (_images(1, 70, 66, i)[0] * 255).astype(np.uint8))
    ours = datasets.DegeneratedImageDataset(str(tmp_path), 64, MODEL, mode)
    theirs = jax_datasets.DegeneratedImageDataset(str(tmp_path), 64, MODEL, mode)
    for i in range(3):
        got = ours.__getitem__(i, np.random.default_rng((5, i)))
        want = theirs.__getitem__(i, np.random.default_rng((5, i)))
        assert set(got) == set(want) == {"gt", "kernel1", "kernel2", "sinc_kernel"}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- noise ---------------------------------------------------------------------


@pytest.mark.parametrize("levels", [1, 2, 3, 5, 17, 100, 129, 256])
def test_poisson_noise_vals_equals_jax(levels):
    """Images holding exactly ``levels`` 8-bit levels (one sample with
    fewer), so the count crosses every power of two's boundary."""
    rng = np.random.default_rng(levels)
    picks = rng.choice(256, size=levels, replace=False)
    img = np.empty((3, 24, 24, 3), np.float32)
    img.reshape(3, -1)[:] = picks[rng.integers(0, levels, size=(3, 24 * 24 * 3))] / 255.0
    img.reshape(3, -1)[:, :levels] = picks / 255.0  # every level present
    img[2] = picks[0] / 255.0  # one level only
    want = np.asarray(jax_degrade.poisson_noise_vals(jnp.asarray(img)))
    got = noise.poisson_noise_vals(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[2] == 1.0


def _stat_images(n=4, h=64, w=64, seed=0):
    """[0.3, 0.7], far from the clip at 0 and 1 for the noise drawn here."""
    return torch.from_numpy(0.3 + 0.4 * np.random.default_rng(seed).uniform(size=(n, h, w, 3)).astype(np.float32))


def test_gaussian_noise_statistics():
    """Per sample: mean 0 and standard deviation sigma (4 standard errors),
    the gray samples' noise equal over the three channels, and one
    generator state giving one draw."""
    x = _stat_images()
    sigma = torch.tensor([0.01, 0.03, 0.05, 0.02])
    gray = torch.tensor([0.0, 1.0, 0.0, 1.0])
    out = noise.add_gaussian_noise(x, sigma, gray, torch.Generator().manual_seed(0))
    again = noise.add_gaussian_noise(x, sigma, gray, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    d = (out - x).double()
    m = d.numel() // 4
    for i in range(4):
        s = float(sigma[i])
        count = m if gray[i] == 0 else m // 3
        assert abs(float(d[i].mean())) < 4 * s / count**0.5, i
        assert abs(float(d[i].std()) / s - 1) < 4 * (0.5 / count) ** 0.5, i
        # (x + n) - x rounds per channel: the gray noise is equal to f32 roundoff
        same = all(torch.allclose(d[i, ..., 0], d[i, ..., c], atol=1e-6, rtol=0) for c in (1, 2))
        assert same == bool(gray[i]), i


def test_poisson_noise_statistics():
    """Per sample, the noise (out - x) / scale has mean 0 and variance
    mean(source / vals) with the source the rounded image (colour) or its
    rounded luma (gray) and vals from ``poisson_noise_vals`` (mean within
    4 standard errors, variance within 5%)."""
    x = _stat_images(seed=1)
    scale = torch.tensor([1.0, 2.0, 0.5, 1.5])
    gray = torch.tensor([0.0, 0.0, 1.0, 1.0])
    out = noise.add_poisson_noise(x, scale, gray, torch.Generator().manual_seed(3))
    d = ((out - x) / scale[:, None, None, None]).double()
    rounded = torch.round(x * 255).clamp(0, 255) / 255
    luma = torch.round((x * torch.tensor([0.2989, 0.587, 0.114])).sum(-1, keepdim=True) * 255) / 255
    for i in range(4):
        src = luma[i] if gray[i] else rounded[i]
        vals = float(noise.poisson_noise_vals(src[None])[0])
        var = float(src.double().mean()) / vals
        di = d[i, ..., :1] if gray[i] else d[i]
        assert abs(float(di.mean())) < 4 * (var / di.numel()) ** 0.5, i
        assert abs(float(di.var()) / var - 1) < 0.05, (i, float(di.var()), var)


# -- blur, USM, flips -------------------------------------------------------------


@pytest.mark.parametrize("shape,k", [((2, 40, 36, 3), 51), ((3, 17, 23, 3), 7)])
def test_blur_separable_matches_jax(shape, k):
    """Two f32 banded products in both frameworks, summed in other orders:
    1e-6 absolute on [0, 1] images."""
    x = np.random.default_rng(k).uniform(size=shape).astype(np.float32)
    k1d = np.exp(-0.5 * ((np.arange(k) - k // 2) / (k / 6)) ** 2)
    k1d = (k1d / k1d.sum()).astype(np.float32)
    want = np.asarray(jax_filters.blur_separable(jnp.asarray(x), jnp.asarray(k1d)))
    got = filters.blur_separable(torch.from_numpy(x), torch.from_numpy(k1d)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_usm_sharp_matches_jax():
    """USM at K = 51 on 64x64 images with a sharp edge (the hard mask is
    non-trivial). A pixel whose residual sits at the mask's threshold may
    fall the other way; one such pixel moves the output by at most its
    tap of the soft mask (0.0023) times 0.5 x the residual (~0.02): held
    to 1e-4 absolute, and 1e-6 on 99.9% of the pixels."""
    x = _images(2, 64, 64, 0)
    want = np.asarray(jax_re.usm_sharp(jnp.asarray(x)))
    got = re.usm_sharp(torch.from_numpy(x)).numpy()
    diff = np.abs(got - want)
    assert np.abs(got - x).max() > 0.01, "USM changed nothing: the test would see nothing"
    assert diff.max() <= 1e-4 and np.mean(diff <= 1e-6) >= 0.999, (diff.max(), np.mean(diff > 1e-6))


@pytest.mark.parametrize("shape", [(4, 8, 8, 3), (4, 8, 6, 3)], ids=["square", "not_square"])
def test_paired_flip_rotate_matches_jax(shape):
    rng = np.random.default_rng(0)
    gt = rng.uniform(size=shape).astype(np.float32)
    lr = rng.uniform(size=(shape[0], shape[1] // 2, shape[2] // 2, 3)).astype(np.float32)
    flags = [np.array(f, np.float32) for f in ([0, 1, 0, 1], [0, 0, 1, 1], [1, 0, 1, 0])]
    want = jax_augment.paired_flip_rotate(*(jnp.asarray(a) for a in (gt, lr, *flags)))
    got = augment.paired_flip_rotate(*(torch.from_numpy(a) for a in (gt, lr, *flags)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the chain ------------------------------------------------------------------


def _golden_names():
    data = np.load(GOLDEN_RE)
    return sorted({k.split("/")[0] for k in data.files if "/" in k})


def _zero_noise_plan(plan, jpeg_off):
    """The plan with sigma 0 and Poisson scale 0 (noise exactly zero in both
    frameworks), and the JAX goldens' quality-0 sentinel where asked."""
    z = np.zeros_like(plan.noise1_sigma)
    kw = dict(noise1_sigma=z, noise1_poisson_scale=z, noise2_sigma=z, noise2_poisson_scale=z)
    if jpeg_off:
        kw.update(jpeg1_quality=z - 1, jpeg2_quality=z - 1)
    return dataclasses.replace(plan, **kw)


@pytest.mark.parametrize("name", _golden_names())
def test_chain_replays_executed_reference_goldens(name):
    """``tests/test_chain_goldens.py``'s scenarios through the port's chain,
    with its tolerances: the exact ones (both JPEGs bypassed) within one
    8-bit level on under 1% of pixels; the JPEG one within the envelope
    of the standard-vs-transposed-table DiffJPEG (max 0.05, mean 1e-2)."""
    data = np.load(GOLDEN_RE)
    image = data["input"]
    sf, size1, i1, size2, i2, i_final, second_blur, jpeg_first, jpeg_on = (int(v) for v in data[f"{name}/meta"])
    q1, q2 = (float(v) for v in data[f"{name}/jpeg_q"])
    zeros = np.zeros(1, np.float32)
    plan = re.RealEsrganPlan(
        size1=(size1, size1), interp1=i1, size2=(size2, size2), interp2=i2,
        final_size=(image.shape[0] // sf, image.shape[1] // sf), final_interp=i_final,
        second_blur=bool(second_blur), jpeg_first_in_stage2=bool(jpeg_first),
        noise1_sigma=zeros, noise1_poisson_scale=np.ones(1, np.float32), noise1_is_poisson=zeros,
        noise1_gray=zeros, jpeg1_quality=np.array([q1 if jpeg_on else -1.0], np.float32),
        noise2_sigma=zeros, noise2_poisson_scale=np.ones(1, np.float32), noise2_is_poisson=zeros,
        noise2_gray=zeros, jpeg2_quality=np.array([q2 if jpeg_on else -1.0], np.float32),
    )
    t = lambda a: torch.from_numpy(np.asarray(a)[None])  # noqa: E731
    got = re.apply_realesrgan_batch(t(image), t(data["k1"]), t(data["k2"]), t(data["sinc"]),
                                    torch.Generator().manual_seed(0), plan)[0].numpy()
    want = data[f"{name}/lr"]
    assert got.shape == want.shape
    if name.endswith("_exact"):
        _assert_quantised_close(got, want, name)
    else:
        diff = np.abs(got - want)
        assert diff.max() < 0.05 and diff.mean() < 1e-2, (name, diff.max(), diff.mean())


def _batch_inputs(n, size, seed):
    rng = np.random.default_rng(seed)
    triples = [re.sample_kernel_triple(rng, MODEL) for _ in range(n)]
    ks = [np.stack([t[j] for t in triples]) for j in range(3)]
    return _images(n, size, size, seed), ks


@pytest.mark.parametrize("seed", [3, 6, 8])
def test_chain_matches_jax_at_zero_noise(seed):
    """Sampled plans at GT 64, x4, noise zero and both JPEGs off: the
    quantisation rule. The seeds' plans (first, second, final resize;
    second blur; JPEG before the final resize): (cubic, area, area; yes;
    yes), (linear, cubic, area; no; yes), (area, linear, linear; yes; no)."""
    gt, (k1, k2, sinc) = _batch_inputs(3, 64, seed)
    plan = _zero_noise_plan(re.plan_realesrgan_batch(np.random.default_rng(seed), 3, (64, 64), 4, PROCESS), True)
    want = np.asarray(jax_re.apply_realesrgan_batch(*(jnp.asarray(a) for a in (gt, k1, k2, sinc)),
                                                    jax.random.PRNGKey(0), plan))
    got = re.apply_realesrgan_batch(*(torch.from_numpy(a) for a in (gt, k1, k2, sinc)),
                                    torch.Generator().manual_seed(0), plan).numpy()
    assert got.shape == want.shape == (3, 16, 16, 3)
    _assert_quantised_close(got, want, f"seed {seed}")


def test_chain_with_noise_is_seeded_and_in_range():
    """With the plan's own noise: one generator state gives one LR, on
    8-bit levels in [0, 1]; another state gives another."""
    gt, (k1, k2, sinc) = _batch_inputs(2, 64, 9)
    plan = re.plan_realesrgan_batch(np.random.default_rng(9), 2, (64, 64), 4, PROCESS)
    run = lambda s: re.apply_realesrgan_batch(  # noqa: E731
        *(torch.from_numpy(a) for a in (gt, k1, k2, sinc)), torch.Generator().manual_seed(s), plan)
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.min() >= 0 and a.max() <= 1 and torch.equal(torch.round(a * 255), a * 255)


@pytest.mark.parametrize("seed", [0, 3])
def test_chain_matches_jax_below_the_reflect_pad(seed):
    """GT 32 at x4: the final 8x8 stage (and, where the plan draws a small
    first resize, earlier ones) is below the K = 21 kernels' pad of 10, so
    each blur folds its reflection more than once, as the JAX chain's
    ``jnp.pad(mode="reflect")`` does. Noise zero and both JPEGs off: the
    quantisation rule of ``test_chain_matches_jax_at_zero_noise``."""
    gt, (k1, k2, sinc) = _batch_inputs(2, 32, seed)
    plan = _zero_noise_plan(re.plan_realesrgan_batch(np.random.default_rng(seed), 2, (32, 32), 4, PROCESS), True)
    want = np.asarray(jax_re.apply_realesrgan_batch(*(jnp.asarray(a) for a in (gt, k1, k2, sinc)),
                                                    jax.random.PRNGKey(0), plan))
    got = re.apply_realesrgan_batch(*(torch.from_numpy(a) for a in (gt, k1, k2, sinc)),
                                    torch.Generator().manual_seed(0), plan).numpy()
    assert got.shape == want.shape == (2, 8, 8, 3)
    _assert_quantised_close(got, want, f"seed {seed}")


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
def test_train_batch_matches_jax_at_zero_noise(uint8):
    """USM, the chain, aligned crops and paired flips at GT 64 -> crops of
    32, noise zero, JPEGs off: the GT crops exact, the sharpened crops as
    ``test_usm_sharp_matches_jax``, the LR by the quantisation rule."""
    n = 4
    gt, (k1, k2, sinc) = _batch_inputs(n, 64, 4)
    if uint8:
        gt = np.round(gt * 255).astype(np.uint8)
    rng = np.random.default_rng(4)
    plan = _zero_noise_plan(re.plan_realesrgan_batch(rng, n, (64, 64), 4, PROCESS), True)
    tops, lefts = rng.integers(0, 9, n), rng.integers(0, 9, n)
    flags = [(rng.random(n) < 0.5).astype(np.float32) for _ in range(3)]
    want = jax_re.apply_realesrgan_train_batch(
        jnp.asarray(gt), *(jnp.asarray(a) for a in (k1, k2, sinc)), jax.random.PRNGKey(0), plan,
        tops, lefts, *flags, 32, 4)
    got = re.apply_realesrgan_train_batch(
        torch.from_numpy(gt), *(torch.from_numpy(a) for a in (k1, k2, sinc)),
        torch.Generator().manual_seed(0), plan, tops, lefts, *flags, 32, 4)
    assert [tuple(g.shape) for g in got] == [(n, 32, 32, 3), (n, 32, 32, 3), (n, 8, 8, 3)]
    # uint8 GT: XLA divides by 255 as a product with its reciprocal, one
    # f32 ulp off torch's division
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=0 if not uint8 else 6e-8, rtol=0)
    usm_diff = np.abs(got[1].numpy() - np.asarray(want[1]))
    assert usm_diff.max() <= 1e-4 and np.mean(usm_diff <= 1e-6) >= 0.999
    _assert_quantised_close(got[2].numpy(), np.asarray(want[2]), "lr")


def test_adapter_matches_jax_at_zero_noise(tmp_path):
    """The adapter end to end in train mode, the config's noise ranges set
    to 0: the host draws after the plan (the generator seed, tops, lefts,
    flips) are the JAX adapter's, so the GT crops are equal exactly and
    ``gt_pixel`` as USM; the LR runs both JPEGs at the drawn qualities and
    is held to the chain-with-JPEG envelope of ``tests/test_torch_degrade.py``
    (every pixel within 0.02, the mean within 1e-3)."""
    zero = {"noise_range1": (0, 0), "noise_range2": (0, 0),
            "poisson_scale_range1": (0.0, 0.0), "poisson_scale_range2": (0.0, 0.0)}
    params = lambda c: {"model": dict(c.degradation_params["model"]),  # noqa: E731
                        "process": {**c.degradation_params["process"], **zero}}
    jcfg = jax_configs.get_config("realesrnet", gt_image_size=32)
    cfg = configs.get_config("realesrnet", gt_image_size=32)
    jcfg, cfg = jcfg.replace(degradation_params=params(jcfg)), cfg.replace(degradation_params=params(cfg))
    gt, (k1, k2, sinc) = _batch_inputs(4, 64, 7)
    host = {"gt": gt, "kernel1": k1, "kernel2": k2, "sinc_kernel": sinc}
    for train in (True, False):
        want = JaxAdapter(jcfg, seed=3, train=train)(host, 5)
        got = DegradationAdapter(cfg, seed=3, train=train)(host, 5)
        assert set(got) == set(want) == {"gt", "gt_pixel", "lr"}
        np.testing.assert_array_equal(got["gt"].numpy(), np.asarray(want["gt"]))
        pix = np.abs(got["gt_pixel"].numpy() - np.asarray(want["gt_pixel"]))
        assert pix.max() <= 1e-4 and np.mean(pix <= 1e-6) >= 0.999
        lr = np.abs(got["lr"].numpy() - np.asarray(want["lr"]))
        assert got["lr"].shape == want["lr"].shape
        assert lr.max() <= 0.02 and lr.mean() <= 1e-3, (train, lr.max(), lr.mean())

