"""Bit-exact twin of the reference's *torch* NIQE module: the port's own
copy of ``srganfd_tpu/metrics/niqe_torch.py``.

This is a host-side metric, not a kernel of the port: ``cli.test`` runs it
only with ``--niqe-model``, on the SR frame as a CPU tensor (a numpy array
in), exactly as the JAX package runs it, and pins it to the reference's
module bit for bit on the CPU. It is no plain version of any CUDA kernel
and nothing falls back to it.

The reference ships two NIQE implementations with different numerics:
the numpy one (``ESRGAN/image_quality_assessment.py:235-344``, matched
bit-for-bit by :mod:`srganfd_tpu_torch.metrics.niqe`) and the torch module its
eval scripts actually call (``BSRGAN/test_bsrgan.py:125,227``; class
``NIQE`` at ``image_quality_assessment.py:1336-1374``). The torch
pipeline differs semantically, not just in dtype:

- sigma gets a ``+1e-8`` inside the sqrt (``:1263``) where numpy has none;
- AGGD betas come from masked sums with ``+1e-8`` denominators and
  lgamma-exp gammas (``:1144-1186``) — empty sign buckets yield 0.0,
  not NaN;
- the half-downscale is the BasicSR cubic resize with MATLAB-style
  *reflect* padding (``:1060-1135``), not the symmetric-padded imresize,
  and a dtype-cast bug (``:697``: ``!= f32 or != f64`` is always true)
  silently runs it in float32 before casting back to float64;
- Y conversion runs on the tensor as RGB [0,1] -> ``*255`` -> ``round``
  -> float64 (``:1318-1325``).

On smooth synthetic imagery the two implementations agree to ~1e-5, but
real CFD frames with flat backgrounds sit on degenerate-block knife
edges where they diverge by >10% — hence this exact twin.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["niqe_torch_exact"]


def _gaussian7(torch):
    """fspecial_gaussian(7, 7/6) as float32 (reference ``:544-570``)."""
    m = (7 - 1.0) / 2.0
    y, x = np.ogrid[-m : m + 1, -m : m + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * (7.0 / 6.0) ** 2))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    h /= h.sum()
    return torch.from_numpy(h).float().view(1, 1, 7, 7)


def _aggd(torch, blocks):
    """Masked AGGD fit over (N, 1, h, w) blocks (reference ``:1144-1186``).

    Returns per-block (alpha, left_beta, right_beta); empty sign buckets
    produce 0.0 stds via the +1e-8 denominators (numpy twin yields NaN)."""
    grid = torch.arange(0.2, 10 + 0.001, 0.001).to(blocks)
    r_gam = (2 * torch.lgamma(2.0 / grid) - (torch.lgamma(1.0 / grid) + torch.lgamma(3.0 / grid))).exp()
    r_gam = r_gam.repeat(blocks.size(0), 1)

    neg, pos = blocks < 0, blocks > 0
    n_neg = neg.sum(dim=(-1, -2), dtype=torch.float32)
    n_pos = pos.sum(dim=(-1, -2), dtype=torch.float32)
    left_std = torch.sqrt_((blocks * neg).pow(2).sum(dim=(-1, -2)) / (n_neg + 1e-8))
    right_std = torch.sqrt_((blocks * pos).pow(2).sum(dim=(-1, -2)) / (n_pos + 1e-8))
    gamma_hat = left_std / right_std
    rhat = blocks.abs().mean(dim=(-1, -2)).pow(2) / blocks.pow(2).mean(dim=(-1, -2))
    rhat_norm = (rhat * (gamma_hat.pow(3) + 1) * (gamma_hat + 1)) / (gamma_hat.pow(2) + 1).pow(2)
    alpha = grid[(r_gam - rhat_norm).abs().argmin(dim=-1)]
    scale = (torch.lgamma(1 / alpha) - torch.lgamma(3 / alpha)).exp().sqrt()
    return alpha, left_std.squeeze(-1) * scale, right_std.squeeze(-1) * scale


def _block_feats(torch, blocks):
    """18 features per block (reference ``_get_mscn_feature_torch``)."""
    n = blocks.shape[0]
    x = blocks[:, [0]]
    alpha, lb, rb = _aggd(torch, x)
    feats = [alpha, (lb + rb) / 2]
    for shift in ([0, 1], [1, 0], [1, 1], [1, -1]):
        alpha, lb, rb = _aggd(torch, x * torch.roll(x, shift, dims=(2, 3)))
        mean = (rb - lb) * (torch.lgamma(2 / alpha) - torch.lgamma(1 / alpha)).exp()
        feats.extend((alpha, mean, lb, rb))
    return torch.cat([f.reshape(n, 1) for f in feats], dim=-1)


def _reflect_pad_1d(torch, t, dim, pre, post):
    """MATLAB-style edge-duplicating reflect pad along one spatial dim
    (reference ``_reflect_padding_torch``: [a,b,c,d] -> [a,a,b,c,d,d])."""
    if pre == 0 and post == 0:
        return t
    if dim in (2, -2):
        head = t[..., :pre, :].flip(-2)
        tail = t[..., t.size(-2) - post :, :].flip(-2)
        return torch.cat([head, t, tail], dim=-2)
    head = t[..., :pre].flip(-1)
    tail = t[..., t.size(-1) - post :].flip(-1)
    return torch.cat([head, t, tail], dim=-1)


def _resize_half_1d(torch, t, dim):
    """One axis of the BasicSR cubic 0.5x resize (reference
    ``_resize_1d_torch``), float32, antialiased, reflect-padded."""
    F = torch.nn.functional
    size = math.ceil(t.size(dim) * 0.5)
    ksz = math.ceil(4 / 0.5) + 2  # antialiased cubic + margin = 10
    with torch.no_grad():
        pos = torch.linspace(0, size - 1, steps=size, dtype=t.dtype)
        pos = (pos + 0.5) / 0.5 - 0.5
        base = pos.floor() - (ksz // 2) + 1
        dist = pos - base
        taps = torch.stack([dist - i for i in range(ksz)]) * 0.5
        ax = taps.abs()
        ax2, ax3 = ax * ax, ax * ax * ax
        w = (1.5 * ax3 - 2.5 * ax2 + 1) * ax.le(1).to(t.dtype) + (
            -0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2
        ) * (ax.gt(1) & ax.le(2)).to(t.dtype)
        w = w / w.sum(dim=0, keepdim=True)
        base = base.long()
        pre = int(max(0, -base.min().item()))
        base = base + pre
        post = int(max(0, (base.max().item() + ksz - 1) - (t.size(dim) + pre) + 1))
    x = _reflect_pad_1d(torch, t, dim, pre, post)
    if dim in (2, -2):
        unfold = F.unfold(x, (ksz, 1)).view(x.size(0), ksz, -1, x.size(-1))
        sample = unfold[..., base, :]
        w = w.view(1, ksz, size, 1)
    else:
        unfold = F.unfold(x, (1, ksz)).view(x.size(0), ksz, x.size(-2), -1)
        sample = unfold[..., base]
        w = w.view(1, ksz, 1, size)
    return (sample * w).sum(dim=1, keepdim=True)


def _resize_half(torch, t):
    """0.5x bicubic like the reference's ``_image_resize_torch`` — which
    always computes in float32 (the ``_cast_input_torch`` dtype check at
    ``:697`` is a tautology) and casts back afterwards."""
    dtype = t.dtype
    x = t.reshape(-1, 1, t.size(-2), t.size(-1)).float()
    x = _resize_half_1d(torch, x, -2)
    x = _resize_half_1d(torch, x, -1)
    return x.reshape(*t.shape[:-2], x.size(-2), x.size(-1)).to(dtype)


def niqe_torch_exact(image, model, crop_border: int = 0, block: int = 96) -> float:
    """Score with the reference torch NIQE's exact arithmetic.

    Args:
        image: RGB [0,1] float — HWC numpy array or (1,3,H,W) torch
            tensor (the reference module's input, ``test_bsrgan.py:217``).
        model: :class:`srganfd_tpu_torch.metrics.niqe.NiqeModel` (mu/cov).
        crop_border: pixels cropped from each side first.
    """
    import torch

    F = torch.nn.functional
    with torch.no_grad():
        if isinstance(image, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(image.transpose(2, 0, 1))[None]).float()
        else:
            t = image.float()
        if crop_border > 0:
            t = t[:, :, crop_border:-crop_border, crop_border:-crop_border]

        mu_pris = torch.from_numpy(np.ravel(model.mu)).to(t).repeat(t.size(0), 1)
        cov_pris = torch.from_numpy(model.cov).to(t).repeat(t.size(0), 1, 1)

        # Y channel: matmul + 16, /255, *255, round, float64 (``:1318-1325``)
        wy = torch.tensor([[65.481], [128.553], [24.966]]).to(t)
        y = (torch.matmul(t.permute(0, 2, 3, 1), wy).permute(0, 3, 1, 2) + 16.0) / 255.0
        y = (y * 255.0).round().to(torch.float64)

        b, c, h, w = y.shape
        nbh, nbw = h // block, w // block
        if nbh * nbw < 2:
            # the JAX twin fails here with a RuntimeError from F.pad (no
            # block at all) instead of its ValueError below, which cli.test
            # catches to skip the frame's NIQE
            raise ValueError(f"NIQE needs >= 2 {block}px blocks, got {nbh * nbw} in a {h}x{w} frame")
        y = y[..., : nbh * block, : nbw * block]

        feats = []
        for scale in (1, 2):
            kern = _gaussian7(torch).to(y)
            yp = F.pad(y, (3, 3, 3, 3), mode="replicate")  # 7x7 'same'
            mu = F.conv2d(yp, kern)
            std = F.conv2d(yp**2, kern)
            sigma = torch.sqrt_((std - mu**2).abs() + 1e-8)
            mscn = (y - mu) / (sigma + 1)

            k = block // scale
            blocks = F.unfold(mscn, (k, k), stride=(k, k))
            blocks = blocks.reshape(b, c, k, k, nbh, nbw)
            blocks = blocks.permute(5, 4, 0, 1, 2, 3).reshape(nbh * nbw * b, c, k, k)
            bf = _block_feats(torch, blocks)
            feats.append(bf.reshape(nbh * nbw, b, *bf.shape[1:]).transpose(0, 1))
            if scale == 1:
                y = _resize_half(torch, y / 255.0) * 255.0

        dist = torch.cat(feats, -1)  # (b, nblocks, 36)
        nan = torch.isnan(dist)
        filled = dist.clone()
        filled[nan] = 0
        mu_dist = filled.sum(dim=1) / (~nan).float().sum(dim=1)
        rows_ok = ~nan.any(dim=2, keepdim=True)
        kept = dist.masked_select(rows_ok).reshape(b, -1, dist.size(-1))
        if kept.shape[-2] < 2:
            raise ValueError(
                f"NIQE needs >= 2 NaN-free {block}px blocks, got {kept.shape[-2]} "
                f"(image too small or fully degenerate; the reference torch NIQE "
                f"divides by zero here, image_quality_assessment.py:950)"
            )
        # reference _cov_torch: transpose, center over rows, then
        # (factor * t) @ t.T — the factor scales BEFORE the matmul
        # (``:944-952``; * and @ are left-associative)
        tT = kept.transpose(-1, -2)
        tT = tT - tT.mean(dim=-1, keepdim=True)
        cov_dist = (1 / (tT.shape[-1] - 1) * tT) @ tT.transpose(-1, -2)

        inv = torch.linalg.pinv((cov_pris + cov_dist) / 2)
        d = (mu_pris - mu_dist).unsqueeze(1)
        score = torch.bmm(torch.bmm(d, inv), d.transpose(1, 2)).squeeze().sqrt()
        return float(score)
