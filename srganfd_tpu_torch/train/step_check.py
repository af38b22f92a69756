"""How closely one f32 training step with the kernels must follow the same
step with their plain versions.

The two steps start from the same state and take the same batch, so only
the RDB differs: the kernels' (split-precision 3xTF32; the backward takes
its slopes from the forward kernel's own out_k) or ``rdb_forward_ref``'s
(cuDNN, and autograd through it). Any two forwards that round differently
make the backwards take a few LeakyReLU slopes differently: a
pre-activation near 0 lands on the other side. :func:`slope_flips` counts
those between the two runs' recomputed pre-activations; the ones between
the kernel's out_k and the recompute at one input are ``chip_smoke.py``'s
phase 7 count. Such a flip moves the gradient of its own
conv's output channel by one pixel's share, and for a bias that starts at
zero that is up to ~2.4e-4 of its update (``f32_step_study.py``).

- :func:`slope_flips` counts the flips per RDB and names the channels;
- :func:`g_agreement` measures the updated G against the plain step's, per
  tensor, outside and inside those channels (and the biases outside the
  RDBs, which every flip reaches);
- :func:`step_check_failures` applies a set of limits to the readings:
  :data:`LIMITS`, which ``chip_smoke.py`` holds, or :data:`CHANNEL_RULE`,
  G to 1e-5 outside the flipped channels, which ``f32_step_study.py``
  measures. The study finds the channel rule fails a correct forward
  whenever ~10 LeakyReLU slopes after the trunk flip: their changed
  gradient reaches every trunk bias (up to 1.65e-5), and any excluded set
  that covers that also covers a planted fault (PERF.md).
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F

__all__ = ["LIMITS", "CHANNEL_RULE", "rdb_preactivations", "slope_flips", "flipped_channels", "g_agreement",
           "step_check_failures"]

# chain LR (kernel chain against the plain chain) and loss: max abs and
# relative; LeakyReLU slopes the two backwards take differently; updated G,
# per tensor max |dG| / max |G|, outside and inside the excluded set
LIMITS = {"lr_max_abs": 1e-5, "loss_rel": 1e-5, "slope_flips": 250, "g_outside": 1e-3,
          "g_inside": 1e-3}
CHANNEL_RULE = {**LIMITS, "g_outside": 1e-5}

_PARAM = re.compile(r"(.*\.conv(\d))\.(weight|bias)")


def rdb_preactivations(x, kernels, biases) -> list[torch.Tensor]:
    """The four LeakyReLU inputs of one RDB as ``rdb_forward_ref``'s f32
    path computes them, each (N, gc, H, W)."""
    feats, zs = [x.float().permute(0, 3, 1, 2)], []
    for k in range(4):
        w = kernels[k].float().permute(3, 2, 0, 1)
        z = F.conv2d(torch.cat(feats, 1), w, biases[k].float(), padding=1)
        zs.append(z)
        feats.append(F.leaky_relu(z, 0.2))
    return zs


def slope_flips(rdbs_a, rdbs_b) -> tuple[list[int], list[list[torch.Tensor]]]:
    """The LeakyReLU slopes that two runs' backwards take differently:
    elements of the recomputed pre-activations, at each run's RDB input,
    whose signs differ. ``rdbs_*``: (x, kernels, biases) per RDB, in
    forward order. Returns per RDB the count, and per RDB and conv 1-4 the
    output channels that hold a flip."""
    counts, channels = [], []
    for a, b in zip(rdbs_a, rdbs_b):
        per_conv = [((za > 0) != (zb > 0)).sum(dim=(0, 2, 3))
                    for za, zb in zip(rdb_preactivations(*a), rdb_preactivations(*b))]
        counts.append(int(sum(int(c.sum()) for c in per_conv)))
        channels.append([torch.nonzero(c).flatten().cpu() for c in per_conv])
    return counts, channels


def flipped_channels(rdb_names: list[str], channels: list[list[torch.Tensor]]) -> dict[str, torch.Tensor]:
    """``slope_flips``' channels keyed by conv: ``{"<rdb>.conv<k>": idx}``
    for each conv that holds a flip; ``rdb_names`` are the RDB modules'
    names in forward order (e.g. ``trunk.12.rdb2``)."""
    if len(rdb_names) != len(channels):
        raise ValueError(f"{len(rdb_names)} RDB names for {len(channels)} recorded RDBs")
    return {f"{name}.conv{k + 1}": idx for name, per_conv in zip(rdb_names, channels)
            for k, idx in enumerate(per_conv) if idx.numel()}


def g_agreement(g_a: dict, g_b: dict, flipped: dict[str, torch.Tensor], outer: bool = True) -> dict:
    """The updated G of run a against run b's, per tensor ``max |dG| /
    max |G_b|``: the largest over the elements outside the flipped channels
    and the largest inside them, with the tensor each comes from, and the
    five tensors that read largest outside. Inside are a flipped conv's
    bias elements and weight rows (dim 0) of its flipped output channels
    and, with ``outer``, every bias outside the RDBs: they start at zero
    and sum over every pixel of the trunk's input or output, so all flips
    reach them, and so do the LeakyReLU flips after the trunk, which
    :func:`slope_flips` does not count (``f32_step_study.py``)."""
    out = {"g_outside": 0.0, "g_outside_worst": None, "g_inside": 0.0, "g_inside_worst": None,
           "g_excluded_elements": 0}
    outside = {}
    for name, b in g_b.items():
        if not b.is_floating_point():
            continue
        rel = (g_a[name].float() - b.float()).abs() / b.float().abs().max().clamp_min(1e-12)
        inside = torch.zeros_like(rel, dtype=torch.bool)
        m = _PARAM.fullmatch(name)
        if outer and ".rdb" not in name and name.endswith(".bias"):
            inside[...] = True
        elif m and m.group(1) in flipped:
            inside[flipped[m.group(1)].to(rel.device)] = True
        if (~inside).any():
            outside[name] = rel[~inside].max().item()
        if inside.any() and rel[inside].max().item() > out["g_inside"]:
            out["g_inside"], out["g_inside_worst"] = rel[inside].max().item(), name
        out["g_excluded_elements"] += int(inside.sum())
    top = sorted(outside.items(), key=lambda kv: -kv[1])[:5]
    if top:
        out["g_outside"], out["g_outside_worst"] = top[0][1], top[0][0]
    out["g_outside_top5"] = top
    return out


def step_check_failures(readings: dict, limits: dict) -> list[str]:
    """The readings over their limits, as ``"name value > limit"``."""
    return [f"{k} {readings[k]:.3g} > {v:g}" for k, v in limits.items() if readings[k] > v]
