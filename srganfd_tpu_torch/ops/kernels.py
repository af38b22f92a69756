"""Host-side blur-kernel synthesis for the BSRGAN chain (the port's own copy
of the parts of ``srganfd_tpu/ops/kernels.py`` that the chain uses).

numpy only. The draws are the same calls in the same order as the JAX
package's, so one ``np.random.Generator`` state gives the same kernels bit
for bit. Parity target: ``BSRGAN/imgproc.py:160-225``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "fspecial_gaussian",
    "anisotropic_gaussian",
    "sample_bsrgan_blur_params",
    "build_bsrgan_blur_kernel",
    "pad_kernel",
]


def fspecial_gaussian(size: int, sigma: float) -> np.ndarray:
    """MATLAB fspecial('gaussian', size, sigma)."""
    half = (size - 1) / 2.0
    y, x = np.mgrid[-half : half + 1, -half : half + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(float).eps * h.max()] = 0.0
    s = h.sum()
    return h / s if s != 0 else h


def _rotated_sigma(theta: float, l1: float, l2: float) -> np.ndarray:
    """Covariance with principal axis at angle theta and eigenvalues l1/l2
    (the BSRGAN construction via the reflection matrix V)."""
    v = np.array([np.cos(theta), np.sin(theta)])
    vmat = np.array([[v[0], v[1]], [v[1], -v[0]]])
    d = np.diag([l1, l2])
    return vmat @ d @ np.linalg.inv(vmat)


def anisotropic_gaussian(ksize: int, theta: float, l1: float, l2: float) -> np.ndarray:
    """BSRGAN anisotropic Gaussian: pdf of N(0, Sigma) sampled on the
    1-based-center grid (``BSRGAN/imgproc.py:185-208``)."""
    sigma = _rotated_sigma(theta, l1, l2)
    center = ksize / 2.0 + 0.5
    yy, xx = np.mgrid[1 : ksize + 1, 1 : ksize + 1]
    coords = np.stack([xx - center, yy - center], axis=-1).astype(np.float64)
    inv = np.linalg.inv(sigma)
    det = np.linalg.det(sigma)
    quad = np.einsum("...i,ij,...j->...", coords, inv, coords)
    k = np.exp(-0.5 * quad) / (2.0 * np.pi * np.sqrt(det))
    return k / k.sum()


def sample_bsrgan_blur_params(rng: np.random.Generator, upscale_factor: int) -> dict:
    """The ``_add_blur`` decision set (``BSRGAN/imgproc.py:211-225``): 50%
    anisotropic with eigenvalues U(0, 4+sf) and theta U(0, pi), else
    isotropic fspecial with sigma U(0, 2+0.2sf); ksize = 2*randint(2,11)+3
    in both cases."""
    wd = 2.0 + 0.2 * upscale_factor
    wd2 = 4.0 + upscale_factor
    ksize = 2 * int(rng.integers(2, 12)) + 3  # randint(2,11) inclusive
    if rng.random() < 0.5:
        return {
            "kind": "aniso",
            "ksize": ksize,
            "theta": rng.random() * np.pi,
            "l1": wd2 * rng.random(),
            "l2": wd2 * rng.random(),
        }
    return {"kind": "iso", "ksize": ksize, "sigma": wd * rng.random()}


def build_bsrgan_blur_kernel(p: dict) -> np.ndarray:
    """Deterministic kernel build from :func:`sample_bsrgan_blur_params`."""
    if p["kind"] == "aniso":
        return anisotropic_gaussian(p["ksize"], p["theta"], p["l1"], p["l2"])
    return fspecial_gaussian(p["ksize"], p["sigma"])


def pad_kernel(k: np.ndarray, size: int) -> np.ndarray:
    """Center-pad an odd-sized kernel to ``size`` x ``size`` (zero fill) so
    batches of mixed-size kernels have one shape."""
    p = (size - k.shape[0]) // 2
    if p < 0:
        raise ValueError(f"kernel {k.shape} larger than pad target {size}")
    return np.pad(k, ((p, size - k.shape[0] - p), (p, size - k.shape[1] - p)))
