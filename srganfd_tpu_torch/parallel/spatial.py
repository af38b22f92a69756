"""Spatially sharded inference with a halo exchange between ranks
(counterpart of ``srganfd_tpu/parallel/spatial.py``).

One large frame's height is split over the ranks of the ``data`` axis.
Each rank takes ``halo`` boundary rows from its neighbours
(:func:`comm.ppermute`), runs the generator on its slice with the halos,
drops the halo's share of its output, and the slices are all-gathered so
that every rank holds the whole SR frame (JAX replicates the output the
same way). With ``halo`` at least the network's receptive radius the
interior seams are exact; at the frame's top and bottom the first and last
ranks see reflected rows where the unsharded model sees its convs' zero
padding, a difference confined to a receptive-radius-deep border.

:func:`spatial_sr_loop` is the plain version: the same padding, halos,
crops and forwards, shard after shard in one process, with no collective.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from srganfd_tpu_torch.parallel import comm

__all__ = ["exchange_halos", "spatial_sharded_sr", "spatial_sr_loop", "shard_rows"]

ApplyFn = Callable[[torch.Tensor], torch.Tensor]  # NHWC in, NHWC out, on one device


def _reflect_halos(x: torch.Tensor, halo: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A shard's own boundary rows mirrored (the edge ranks' halos)."""
    return x[1:halo + 1].flip(0), x[-halo - 1:-1].flip(0)


def exchange_halos(x: torch.Tensor, halo: int) -> torch.Tensor:
    """This rank's rows ``x`` (H_loc, W, C) with ``halo`` rows of the
    previous rank above and of the next rank below; the first and last
    ranks reflect their own boundary instead."""
    n, r = comm.world(), comm.rank()
    reflect_top, reflect_bot = _reflect_halos(x, halo)
    from_prev = comm.ppermute(x[-halo:], 1)  # my last rows -> the next rank's top halo
    from_next = comm.ppermute(x[:halo], -1)  # my first rows -> the previous rank's bottom halo
    top = reflect_top if r == 0 else from_prev
    bot = reflect_bot if r == n - 1 else from_next
    return torch.cat([top, x, bot], 0)


def shard_rows(image: np.ndarray, n: int, row_multiple: int = 1) -> np.ndarray:
    """``image`` reflect-padded at the bottom to a multiple of ``n *
    row_multiple`` rows (JAX's padding)."""
    pad_h = (-image.shape[0]) % (n * row_multiple)
    if pad_h:
        image = np.pad(image, ((0, pad_h), (0, 0), (0, 0)), mode="reflect")
    return image


def spatial_sharded_sr(
    apply_fn: ApplyFn,
    image: np.ndarray,
    upscale_factor: int,
    halo: int = 16,
    row_multiple: int = 1,
    device: torch.device | str = "cpu",
) -> np.ndarray:
    """SR one HWC [0, 1] frame with its rows sharded over the ranks. Every
    rank passes the whole frame and gets the whole SR frame back (HWC f32
    on the host). ``apply_fn`` is the generator on ``device``;
    ``row_multiple`` pads each shard's rows to a multiple of it (the
    transformer archs' stride-2 token grid needs 2)."""
    n, r, sf = comm.world(), comm.rank(), upscale_factor
    h = image.shape[0]
    image = shard_rows(image, n, row_multiple)
    rows = image.shape[0] // n
    if rows <= halo:
        raise ValueError(f"--spatial-shard: {rows} rows per rank for a halo of {halo}; use fewer ranks or a "
                         "smaller --tile-overlap")
    local = torch.from_numpy(np.ascontiguousarray(image[r * rows:(r + 1) * rows], np.float32)).to(device)
    with torch.inference_mode():
        sr = apply_fn(exchange_halos(local, halo)[None])[0]
        sr = sr[halo * sf: sr.shape[0] - halo * sf]
        out = comm.all_gather(sr.contiguous(), 0)
    return out.cpu().numpy()[: h * sf]


def spatial_sr_loop(
    apply_fn: ApplyFn | None,
    image: np.ndarray,
    upscale_factor: int,
    n: int,
    halo: int = 16,
    row_multiple: int = 1,
    device: torch.device | str = "cpu",
    shards_fn: Callable[[list[torch.Tensor]], list[torch.Tensor]] | None = None,
) -> np.ndarray:
    """What :func:`spatial_sharded_sr` computes on ``n`` ranks, in one
    process: each shard's rows with its neighbours' halos (reflected at the
    frame's edges), the forward, the crop, the concatenation.
    ``shards_fn`` (list of NHWC shards -> list of SR shards) replaces the
    per-shard ``apply_fn`` for a model whose shards talk to each other (the
    context-parallel transformer's ``forward_shards``)."""
    sf = upscale_factor
    h = image.shape[0]
    image = shard_rows(image, n, row_multiple)
    rows = image.shape[0] // n
    full = torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(device)
    shards = []
    for r in range(n):
        x = full[r * rows:(r + 1) * rows]
        reflect_top, reflect_bot = _reflect_halos(x, halo)
        top = reflect_top if r == 0 else full[r * rows - halo:r * rows]
        bot = reflect_bot if r == n - 1 else full[(r + 1) * rows:(r + 1) * rows + halo]
        shards.append(torch.cat([top, x, bot], 0)[None])
    with torch.inference_mode():
        outs = shards_fn(shards) if shards_fn is not None else [apply_fn(s) for s in shards]
        outs = [o[0][halo * sf: o.shape[1] - halo * sf] for o in outs]
    return torch.cat(outs, 0).cpu().numpy()[: h * sf]
