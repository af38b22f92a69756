"""The port's per-sample 2-D filter against the JAX package's.

``filter2d_ref`` (the plain version the CUDA kernel is held to on the card)
must compute what ``ops.filters.filter2d`` and the Pallas kernel
``filter2d_pallas`` (interpret mode, as ``tests/test_pallas_kernels.py``
runs it) compute: a reflect-101 correlation with one K x K kernel per
sample. The kernels here are asymmetric random ones, so that a flipped
kernel (a convolution) fails: the chain's own Gaussians are
point-symmetric and would hide a flip. Inputs are made with numpy from a
seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srganfd_tpu.ops import filters as jax_filters
from srganfd_tpu.ops.pallas.filter2d import filter2d_pallas
from srganfd_tpu_torch.ops import filters
from srganfd_tpu_torch.ops.cuda import filter2d as f2d

ATOL = 1e-5  # f32 sums of up to 625 products of values in [0, 1] x [0, 1/K^2 * 2]


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _asymmetric_kernels(n, k, seed, true_size=None):
    """Random positive kernels that sum to 1, with no symmetry; a kernel of
    ``true_size`` is centred in a zero K x K frame, as ``pad_kernel`` does."""
    size = true_size or k
    ks = np.random.default_rng(seed).uniform(size=(n, size, size))
    ks /= ks.sum(axis=(1, 2), keepdims=True)
    p = (k - size) // 2
    return np.pad(ks, ((0, 0), (p, p), (p, p))).astype(np.float32)


def _numpy_correlation(images, kernels):
    """out[n,h,w,c] = sum_{dy,dx} xpad[n,h+dy,w+dx,c] * k[n,dy,dx], xpad
    reflect-101 padded by K//2: the definition, in float64."""
    n, h, w, c = images.shape
    k = kernels.shape[-1]
    p = k // 2
    xp = np.pad(images.astype(np.float64), ((0, 0), (p, p), (p, p), (0, 0)), mode="reflect")
    out = np.zeros((n, h, w, c))
    for dy in range(k):
        for dx in range(k):
            out += xp[:, dy:dy + h, dx:dx + w, :] * kernels[:, dy, dx, None, None, None]
    return out


CASES = {
    "2x37x53_k25": ((2, 37, 53, 3), 25, None),
    "3x20x24_k7": ((3, 20, 24, 3), 7, None),
    "2x31x26_k25_true7": ((2, 31, 26, 3), 25, 7),
}


@pytest.mark.parametrize("case", CASES)
def test_filter2d_ref_matches_jax(case):
    shape, k, true_size = CASES[case]
    x = _images(shape, seed=0)
    ks = _asymmetric_kernels(shape[0], k, seed=1, true_size=true_size)
    got = f2d.filter2d_ref(torch.from_numpy(x), torch.from_numpy(ks)).numpy()
    xla = np.asarray(jax_filters.filter2d(jnp.asarray(x), jnp.asarray(ks)))
    depthwise = np.asarray(jax_filters.filter2d_depthwise(jnp.asarray(x), jnp.asarray(ks)))
    pallas = np.asarray(filter2d_pallas(jnp.asarray(x), jnp.asarray(ks), interpret=True))
    for name, want in (("filter2d", xla), ("filter2d_depthwise", depthwise),
                       ("filter2d_pallas", pallas)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(got, _numpy_correlation(x, ks), atol=ATOL, rtol=0)


def test_asymmetric_kernels_tell_correlation_from_convolution():
    """The check above would catch a kernel flipped into a convolution:
    with these kernels the two differ far beyond the tolerance."""
    shape, k, _ = CASES["3x20x24_k7"]
    x = _images(shape, seed=0)
    ks = _asymmetric_kernels(shape[0], k, seed=1)
    corr = f2d.filter2d_ref(torch.from_numpy(x), torch.from_numpy(ks)).numpy()
    conv = _numpy_correlation(x, ks[:, ::-1, ::-1])
    assert np.abs(corr - conv).max() > 100 * ATOL


@pytest.mark.parametrize("hw", [(13, 13), (13, 30), (29, 14)], ids=lambda s: "x".join(map(str, s)))
def test_reflect_101_at_every_border(hw):
    """Pads of K//2 = 12 on edges of 13 to 30: the reflected index map
    reaches deep into each border, on odd and even sizes, H != W."""
    x = _images((2, *hw, 3), seed=2)
    ks = _asymmetric_kernels(2, 25, seed=3)
    got = f2d.filter2d_ref(torch.from_numpy(x), torch.from_numpy(ks)).numpy()
    np.testing.assert_allclose(got, _numpy_correlation(x, ks), atol=ATOL, rtol=0)


def test_cpu_tensor_takes_the_plain_version():
    x = torch.from_numpy(_images((2, 16, 18, 3), seed=4))
    ks = torch.from_numpy(_asymmetric_kernels(2, 9, seed=5))
    before = f2d.launches
    got = filters.filter2d(x, ks)
    assert f2d.launches == before  # the counter counts kernel calls only
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert torch.equal(got, f2d.filter2d_ref(x, ks))


def test_filter2d_refuses_other_devices():
    x = torch.zeros((1, 8, 8, 3), device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        filters.filter2d(x, torch.zeros((1, 3, 3), device="meta"))


@pytest.mark.parametrize(
    "img_shape,k_shape,match",
    [((1, 8, 8, 3), (1, 4, 4), "K odd"),
     ((2, 8, 8, 3), (1, 3, 3), r"\(N, K, K\)"),
     ((1, 8, 8), (1, 3, 3), r"\(N, H, W, C\)"),
     ((1, 6, 20, 3), (1, 13, 13), "reflect padding")],
    ids=["even_k", "n_mismatch", "not_nhwc", "pad_too_big"],
)
def test_plain_version_rejects_bad_shapes(img_shape, k_shape, match):
    with pytest.raises(ValueError, match=match):
        f2d.filter2d_ref(torch.zeros(img_shape), torch.zeros(k_shape))
