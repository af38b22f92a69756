"""NIQE (Natural Image Quality Evaluator), no-reference metric: the port's
own copy of ``srganfd_tpu/metrics/niqe.py`` (numpy and scipy; the torch
Y conversion of the ``"torch"`` convention through the port's
``ops/color.py``).

Parity target: the reference's numpy/torch NIQE
(``ESRGAN/image_quality_assessment.py:169-344`` numpy;
``:944-1366`` torch): MSCN coefficients, AGGD fits over a 9801-point
gamma grid, 96x96 block features at two scales, MVG fit + Mahalanobis
distance against a pristine-corpus model loaded from ``niqe_model.mat``
or an ``.npz`` (``assets/niqe_cfd_bubbles.npz``: a model fitted on CFD
bubble frames).

NIQE is a host-side metric here as in the JAX package: ``cli.test``
computes it with ``--niqe-model`` only, on the SR frame copied to the host,
in numpy (or its bit-exact torch twin, ``niqe_torch``, on a CPU tensor).
It is not a kernel of the port and has no device path; nothing falls
back to it. Images are BGR [0,255] HWC like the reference's numpy API.
"""

from __future__ import annotations

import warnings

import numpy as np
from scipy import ndimage
from scipy.special import gamma as gamma_fn

__all__ = ["niqe", "fit_niqe_model", "load_niqe_model", "save_niqe_model", "NiqeModel"]

_GAMMA_GRID = np.arange(0.2, 10.001, 0.001)
_R_GAM = (gamma_fn(2.0 / _GAMMA_GRID) ** 2) / (
    gamma_fn(1.0 / _GAMMA_GRID) * gamma_fn(3.0 / _GAMMA_GRID)
)


class NiqeModel:
    def __init__(self, mu: np.ndarray, cov: np.ndarray) -> None:
        self.mu = np.asarray(mu, np.float64).reshape(-1)
        self.cov = np.asarray(cov, np.float64)


def _estimate_aggd(vec: np.ndarray) -> tuple[float, float, float]:
    """Asymmetric generalized Gaussian fit -> (alpha, beta_l, beta_r)
    (moment matching over the gamma grid, as the reference
    ``_estimate_aggd_parameters``, ``image_quality_assessment.py``).

    Degenerate blocks (flat / one-signed MSCN, common in real CFD frames
    with empty background) must reproduce the reference's *NaN
    arithmetic* bit-for-bit: empty-slice means and 0/0 divisions yield
    NaN, ``argmin`` over an all-NaN distance grid picks index 0 (alpha =
    0.2), and NaN betas propagate into the feature row, which nanmean /
    the NaN-row-dropping covariance then discard — guarding these with
    finite fallbacks shifts full-image scores by several percent (the JAX
    package's tests/test_realdata.py pins this on real frames)."""
    vec = vec.flatten()
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        left_std = np.sqrt(np.mean(vec[vec < 0] ** 2))
        right_std = np.sqrt(np.mean(vec[vec > 0] ** 2))
        gammahat = left_std / right_std
        rhat = (np.mean(np.abs(vec)) ** 2) / np.mean(vec**2)
        rhatnorm = (rhat * (gammahat**3 + 1) * (gammahat + 1)) / ((gammahat**2 + 1) ** 2)
        idx = int(np.argmin((_R_GAM - rhatnorm) ** 2))
        alpha = _GAMMA_GRID[idx]
    beta_l = left_std * np.sqrt(gamma_fn(1.0 / alpha) / gamma_fn(3.0 / alpha))
    beta_r = right_std * np.sqrt(gamma_fn(1.0 / alpha) / gamma_fn(3.0 / alpha))
    return float(alpha), float(beta_l), float(beta_r)


def _gaussian_window(size: int = 7, sigma: float = 7.0 / 6.0) -> np.ndarray:
    half = (size - 1) / 2.0
    y, x = np.mgrid[-half : half + 1, -half : half + 1]
    w = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    return w / w.sum()


def _mscn(image: np.ndarray) -> np.ndarray:
    w = _gaussian_window()
    mu = ndimage.convolve(image, w, mode="nearest")
    sigma = np.sqrt(np.abs(ndimage.convolve(image * image, w, mode="nearest") - mu * mu))
    return (image - mu) / (sigma + 1.0)


def _block_features(mscn: np.ndarray) -> np.ndarray:
    """18 features: AGGD of MSCN (alpha, mean-of-betas) + 4 directional
    products x (alpha, mean, beta_l, beta_r)."""
    feats = []
    alpha, bl, br = _estimate_aggd(mscn)
    feats += [alpha, (bl + br) / 2.0]
    shifts = [(0, 1), (1, 0), (1, 1), (1, -1)]
    for dy, dx in shifts:
        shifted = np.roll(np.roll(mscn, dy, axis=0), dx, axis=1)
        pair = (mscn * shifted).flatten()
        alpha, bl, br = _estimate_aggd(pair)
        mean = (br - bl) * (gamma_fn(2.0 / alpha) / gamma_fn(1.0 / alpha))
        feats += [alpha, mean, bl, br]
    return np.asarray(feats, np.float64)


def _half_resize_plan_f32(in_length: int) -> tuple[np.ndarray, np.ndarray, int, int]:
    """float32 twin of the reference's ``_calculate_weights_indices``
    (``ESRGAN/imgproc.py:53-128``) for scale=0.5 antialiased bicubic.
    Bit-equal weights vs torch (verified): torch.linspace & friends
    default to float32, so the plan must be computed in float32 too."""
    scale = np.float32(0.5)
    kernel_width = 8.0  # 4 / 0.5 (antialiasing widens the kernel)
    out_length = -(-in_length // 2)
    x = np.linspace(1, out_length, out_length, dtype=np.float32)
    u = x / scale + np.float32(0.5 * (1 - 1 / 0.5))
    left = np.floor(u - np.float32(kernel_width / 2))
    p = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.linspace(0, p - 1, p, dtype=np.float32)[None, :]
    dist = (u[:, None] - indices).astype(np.float32)
    absx = np.abs(dist * scale)
    absx2, absx3 = absx**2, absx**3
    w = scale * (
        (1.5 * absx3 - 2.5 * absx2 + 1) * (absx <= 1).astype(np.float32)
        + (-0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2)
        * ((absx > 1) & (absx <= 2)).astype(np.float32)
    )
    w = (w / w.sum(axis=1, dtype=np.float32)[:, None]).astype(np.float32)
    zero = (w == 0).sum(axis=0)
    if zero[0] != 0:
        indices, w = indices[:, 1 : p - 1], w[:, 1 : p - 1]
    if zero[-1] != 0:
        indices, w = indices[:, 0 : p - 2], w[:, 0 : p - 2]
    sym_s = int(-indices.min() + 1)
    sym_e = int(indices.max() - in_length)
    return w, (indices + sym_s - 1).astype(np.int64), sym_s, sym_e


def _matlab_downscale_half(image: np.ndarray) -> np.ndarray:
    """The reference NIQE's exact half-downscale: ``image_resize(y/255,
    0.5, antialiasing=True) * 255`` computed in float32
    (``ESRGAN/imgproc.py:131-216`` builds torch.FloatTensor buffers).

    Bit-exactness matters here: NIQE's scale-2 features fit AGGDs whose
    degenerate-block NaN pattern (flat CFD backgrounds) flips on 1-ulp
    input differences, shifting full-image scores by percents. The two
    separable passes run through the same ``mv`` kernels the reference
    uses (bit-identical end to end; the JAX package's
    ``tests/test_realdata.py`` pins this on real frames). The JAX
    package's numpy fallback for a host without torch is not carried over:
    the port always has torch."""
    import torch

    h, w = image.shape
    x = (image / 255.0).astype(np.float32)
    wh, ih, shs, she = _half_resize_plan_f32(h)
    ww, iw, sws, swe = _half_resize_plan_f32(w)
    aug = np.concatenate([x[shs - 1 :: -1, :], x, x[: h - she - 1 : -1, :]], axis=0)
    kh, kw2 = wh.shape[1], ww.shape[1]
    taug = torch.from_numpy(aug)
    twh, tww = torch.from_numpy(wh), torch.from_numpy(ww)
    out1 = torch.empty(len(ih), aug.shape[1])
    for i in range(len(ih)):
        out1[i] = taug[ih[i, 0] : ih[i, 0] + kh, :].transpose(0, 1).mv(twh[i])
    o1 = out1.numpy()
    aug2 = np.concatenate([o1[:, sws - 1 :: -1], o1, o1[:, : w - swe - 1 : -1]], axis=1)
    taug2 = torch.from_numpy(aug2)
    out2 = torch.empty(len(iw), out1.shape[0])
    for i in range(len(iw)):
        out2[i] = taug2[:, iw[i, 0] : iw[i, 0] + kw2].mv(tww[i])
    half = out2.numpy().T
    # The reference's ``image_resize(image/255., ...) * 255.`` stays
    # FLOAT32 under NEP-50 promotion (f32 array * python float), so the
    # whole scale-2 feature path (scipy convolve preserves input dtype,
    # numpy means accumulate in f32) runs in float32 — returning f64
    # here shifts degenerate-block NaN patterns on real frames.
    return half * np.float32(255.0)


def _image_features(y: np.ndarray, block_h: int = 96, block_w: int = 96) -> np.ndarray:
    """Per-block 36-dim features over two scales (reference niqe wrapper
    ``image_quality_assessment.py:301-344``)."""
    h, w = y.shape
    nbh, nbw = h // block_h, w // block_w
    y = y[: nbh * block_h, : nbw * block_w]
    scale_feats = []
    img = y.astype(np.float64)
    for scale in (1, 2):
        mscn = _mscn(img)
        bh, bw = block_h // scale, block_w // scale
        feats = [
            _block_features(mscn[i * bh : (i + 1) * bh, j * bw : (j + 1) * bw])
            for i in range(nbh)
            for j in range(nbw)
        ]
        scale_feats.append(np.asarray(feats))
        if scale == 1:
            img = _matlab_downscale_half(img)
    return np.concatenate(scale_feats, axis=1)  # (num_blocks, 36)


def _nancov(x: np.ndarray) -> np.ndarray:
    ok = ~np.isnan(x).any(axis=1)
    return np.cov(x[ok], rowvar=False)


def _y_channel(image: np.ndarray, convention: str) -> np.ndarray:
    """BGR [0,255] HWC (or pre-extracted Y HW) -> float64 luminance.

    Two reference conventions, which differ in rounding (an additive
    offset between them cancels exactly in the MSCN transform):

    - ``"torch"`` — the torch ``NIQE`` module
      (``ESRGAN/image_quality_assessment.py:1320-1326``): Y in [16, 235]
      rounded to integer luminance.
    - ``"numpy"`` — the numpy ``niqe`` function (``:301-344`` via
      ``imgproc.bgr_to_ycbcr``): ``(dot(image, coefs) + 16) / 255``
      computed on the [0,255] image, float32-quantized, NOT rounded.
    """
    if image.ndim != 3:
        return image.astype(np.float64)
    if convention == "numpy":
        y = image.astype(np.float64) @ np.array([24.966, 128.553, 65.481]) + 16.0
        return (y / 255.0).astype(np.float32).astype(np.float64)
    import torch

    from srganfd_tpu_torch.ops import color

    y = color.bgr_to_ycbcr(torch.from_numpy(image.astype(np.float32) / 255.0), True).numpy()[..., 0] * 255.0
    return np.round(y).astype(np.float64)


def niqe(
    image: np.ndarray,
    model: NiqeModel,
    crop_border: int = 0,
    convention: str = "torch",
) -> float:
    """BGR [0,255] HWC (or already-Y HW) -> NIQE score (lower = better)."""
    y = _y_channel(image, convention)
    if crop_border > 0:
        y = y[crop_border:-crop_border, crop_border:-crop_border]

    feats = _image_features(y)
    mu_dist = np.nanmean(feats, axis=0)
    cov_dist = _nancov(feats)
    cov_pinv = np.linalg.pinv((model.cov + cov_dist) / 2.0)
    d = model.mu - mu_dist
    return float(np.sqrt(d @ cov_pinv @ d))


def load_niqe_model(path: str) -> NiqeModel:
    """Load a pristine model: the reference's ``niqe_model.mat``
    (``image_quality_assessment.py:1285-1333``) or the .npz layout its
    numpy ``niqe`` consumes (``:330-335``)."""
    if path.endswith(".npz"):
        data = np.load(path)
    else:
        from scipy.io import loadmat

        data = loadmat(path)
    # known key layouts across niqe model distributions
    for mu_key, cov_key in (
        ("mu_prisparam", "cov_prisparam"),
        ("mu_pris_param", "cov_pris_param"),
        ("pop_mu", "pop_cov"),
    ):
        if mu_key in data:
            return NiqeModel(data[mu_key], data[cov_key])
    raise KeyError(f"unrecognized niqe model keys: {list(data)}")


def fit_niqe_model(images: list[np.ndarray], convention: str = "torch") -> NiqeModel:
    """Fit a pristine MVG model from BGR [0,255] images (capability the
    reference lacks — it only consumes a prebuilt .mat). ``convention``
    must match the scoring convention the model will be used with."""
    all_feats = []
    for image in images:
        all_feats.append(_image_features(_y_channel(image, convention)))
    feats = np.concatenate(all_feats, axis=0)
    return NiqeModel(np.nanmean(feats, axis=0), _nancov(feats))


def save_niqe_model(model: NiqeModel, path: str) -> None:
    """Write the .npz layout the reference's numpy ``niqe`` consumes
    (``ESRGAN/image_quality_assessment.py:330-335``:
    mu_pris_param / cov_pris_param / gaussian_window)."""
    np.savez(
        path,
        mu_pris_param=model.mu,
        cov_pris_param=model.cov,
        gaussian_window=_gaussian_window(),
    )


def niqe_from_mat(
    image: np.ndarray, crop_border: int = 0, niqe_model_path: str = ""
) -> float:
    """Reference-signature convenience wrapper
    (``ESRGAN/image_quality_assessment.py:301-344``): BGR [0,255] image +
    pristine-model path -> NIQE score."""
    return niqe(image, load_niqe_model(niqe_model_path), crop_border)
