"""Host-side blur-kernel synthesis for the BSRGAN and Real-ESRGAN chains
(the port's own copy of the parts of ``srganfd_tpu/ops/kernels.py`` that
the chains use).

numpy (and scipy's Bessel J1) only. The draws are the same calls in the
same order as the JAX package's, so one ``np.random.Generator`` state gives
the same kernels bit for bit. Parity targets: ``BSRGAN/imgproc.py:160-225``
and the Real-ESRGAN family (bivariate iso/aniso Gaussian, generalized
Gaussian, plateau, 2-D sinc, the ``random_mixed_kernels`` dispatcher;
``Real_ESRGAN/imgproc.py:228-606``).
"""

from __future__ import annotations

import numpy as np
from scipy import special

__all__ = [
    "fspecial_gaussian",
    "anisotropic_gaussian",
    "sample_bsrgan_blur_params",
    "build_bsrgan_blur_kernel",
    "bivariate_gaussian",
    "bivariate_generalized_gaussian",
    "bivariate_plateau",
    "sinc_kernel",
    "sample_mixed_kernel_params",
    "build_mixed_kernel",
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


# --- Real-ESRGAN kernel family ----------------------------------------------


def _mesh_grid(size: int) -> np.ndarray:
    half = (size - 1) / 2.0
    y, x = np.mgrid[-half : half + 1, -half : half + 1]
    return np.stack([x, y], axis=-1)


def _sigma_matrix(sigma_x: float, sigma_y: float, theta: float) -> np.ndarray:
    d = np.array([[sigma_x**2, 0.0], [0.0, sigma_y**2]])
    u = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def _quad_form(size: int, sigma_x: float, sigma_y: float | None, theta: float) -> np.ndarray:
    """x^T S^-1 x over the size x size grid centred at 0."""
    sigma_y = sigma_x if sigma_y is None else sigma_y
    inv = np.linalg.inv(_sigma_matrix(sigma_x, sigma_y, theta))
    xy = _mesh_grid(size)
    return np.einsum("...i,ij,...j->...", xy, inv, xy)


def bivariate_gaussian(
    size: int, sigma_x: float, sigma_y: float | None = None, theta: float = 0.0
) -> np.ndarray:
    """Iso (sigma_y=None) or anisotropic bivariate Gaussian, normalized."""
    k = np.exp(-0.5 * _quad_form(size, sigma_x, sigma_y, theta))
    return k / k.sum()


def bivariate_generalized_gaussian(
    size: int, sigma_x: float, sigma_y: float | None, theta: float, beta: float
) -> np.ndarray:
    """exp(-0.5 * (x^T S^-1 x)^beta), normalized."""
    k = np.exp(-0.5 * np.power(_quad_form(size, sigma_x, sigma_y, theta), beta))
    return k / k.sum()


def bivariate_plateau(
    size: int, sigma_x: float, sigma_y: float | None, theta: float, beta: float
) -> np.ndarray:
    """1/(1 + (x^T S^-1 x)^beta), normalized."""
    k = np.reciprocal(np.power(_quad_form(size, sigma_x, sigma_y, theta), beta) + 1.0)
    return k / k.sum()


def sinc_kernel(cutoff: float, size: int, pad_to: int = 0) -> np.ndarray:
    """2-D circular low-pass (sinc) filter via Bessel J1
    (``Real_ESRGAN/imgproc.py:579-606``): k(r) = cutoff * J1(cutoff*r) /
    (2 pi r), with the r=0 limit cutoff^2/(4 pi); normalized, then
    zero-padded to ``pad_to`` when that is larger."""
    if size % 2 != 1:
        raise ValueError(f"sinc kernel size must be odd, got {size}")
    half = (size - 1) / 2.0
    y, x = np.mgrid[-half : half + 1, -half : half + 1]
    r = np.hypot(x, y)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = cutoff * special.j1(cutoff * r) / (2.0 * np.pi * r)
    k[size // 2, size // 2] = cutoff**2 / (4.0 * np.pi)
    k = k / k.sum()
    if pad_to > size:
        p = (pad_to - size) // 2
        k = np.pad(k, ((p, p), (p, p)))
    return k


def _mixture_beta(rng: np.random.Generator, beta_range: tuple[float, float]) -> float:
    """The reference's beta draw (``Real_ESRGAN/imgproc.py:414-417,
    473-476``): a 50/50 mixture of U(beta_min, 1) and U(1, beta_max)."""
    if rng.random() < 0.5:
        return float(rng.uniform(beta_range[0], 1.0))
    return float(rng.uniform(1.0, beta_range[1]))


def sample_mixed_kernel_params(
    rng: np.random.Generator,
    kernel_size: int,
    kernel_types: tuple[str, ...],
    kernel_probs: tuple[float, ...],
    sigma_range: tuple[float, float],
    beta_g_range: tuple[float, float],
    beta_p_range: tuple[float, float],
) -> dict:
    """The ``random_mixed_kernels`` decision set
    (``Real_ESRGAN/imgproc.py:495-576``): kernel family by probability,
    sigmas and rotation uniform, beta by the two-piece mixture."""
    kind = rng.choice(len(kernel_types), p=np.asarray(kernel_probs) / np.sum(kernel_probs))
    kind = kernel_types[int(kind)]
    p = {
        "kind": kind,
        "ksize": kernel_size,
        "sigma_x": float(rng.uniform(*sigma_range)),
        "sigma_y": float(rng.uniform(*sigma_range)),
        "theta": float(rng.uniform(-np.pi, np.pi)),
    }
    if kind.startswith("generalized"):
        p["beta"] = _mixture_beta(rng, beta_g_range)
    elif kind.startswith("plateau"):
        p["beta"] = _mixture_beta(rng, beta_p_range)
    return p


def build_mixed_kernel(p: dict) -> np.ndarray:
    """Deterministic kernel build from :func:`sample_mixed_kernel_params`.
    The isotropic families use sigma_x only, as the reference does."""
    kind, size, sx = p["kind"], p["ksize"], p["sigma_x"]
    if kind == "isotropic":
        return bivariate_gaussian(size, sx)
    if kind == "anisotropic":
        return bivariate_gaussian(size, sx, p["sigma_y"], p["theta"])
    if kind == "generalized_isotropic":
        return bivariate_generalized_gaussian(size, sx, None, 0.0, p["beta"])
    if kind == "generalized_anisotropic":
        return bivariate_generalized_gaussian(size, sx, p["sigma_y"], p["theta"], p["beta"])
    if kind == "plateau_isotropic":
        return bivariate_plateau(size, sx, None, 0.0, p["beta"])
    if kind == "plateau_anisotropic":
        return bivariate_plateau(size, sx, p["sigma_y"], p["theta"], p["beta"])
    raise ValueError(f"unknown kernel type {kind}")


def pad_kernel(k: np.ndarray, size: int) -> np.ndarray:
    """Center-pad an odd-sized kernel to ``size`` x ``size`` (zero fill) so
    batches of mixed-size kernels have one shape."""
    p = (size - k.shape[0]) // 2
    if p < 0:
        raise ValueError(f"kernel {k.shape} larger than pad target {size}")
    return np.pad(k, ((p, size - k.shape[0] - p), (p, size - k.shape[1] - p)))
