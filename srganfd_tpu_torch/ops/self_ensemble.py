"""Geometric x8 self-ensemble for SR serving (counterpart of
``srganfd_tpu/ops/self_ensemble.py``).

Runs the generator on the 8 dihedral transforms of the LR input (4
rotations x optional horizontal flip), maps each SR output back through
the inverse transform and averages in float32. :func:`self_ensemble_batched`
folds the 4 same-shape variants of each orientation into one batched call;
:func:`self_ensemble` wraps any single-image SR callable (tiled, for one).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["DIHEDRAL", "transform", "inverse_transform", "self_ensemble",
           "self_ensemble_batched"]

# the 8 elements of D4 as (k, flip): horizontal flip first, then rot90^k
DIHEDRAL: tuple[tuple[int, bool], ...] = tuple(
    (k, f) for f in (False, True) for k in range(4)
)


def transform(img: np.ndarray, k: int, flip: bool) -> np.ndarray:
    """Dihedral element (k, flip) over the leading (H, W) axes of an HWC
    array: horizontal flip first, then k quarter-turns."""
    if flip:
        img = img[:, ::-1]
    return np.rot90(img, k)


def inverse_transform(img: np.ndarray, k: int, flip: bool) -> np.ndarray:
    """Inverse of :func:`transform`: undo the rotation, then the flip."""
    img = np.rot90(img, -k)
    if flip:
        img = img[:, ::-1]
    return img


def self_ensemble(
    run_single: Callable[[np.ndarray], np.ndarray], img: np.ndarray
) -> np.ndarray:
    """x8 ensemble around a single-image SR path ``(H, W, C) -> (sH, sW, C)``;
    returns the float32 mean of the 8 back-mapped predictions."""
    acc = None
    for k, f in DIHEDRAL:
        sr = np.asarray(run_single(np.ascontiguousarray(transform(img, k, f))))
        sr = inverse_transform(sr, k, f).astype(np.float32)
        acc = sr if acc is None else acc + sr
    return acc / len(DIHEDRAL)


def self_ensemble_batched(
    apply_fn: Callable[[np.ndarray], np.ndarray], img: np.ndarray
) -> np.ndarray:
    """x8 ensemble in two batched calls of ``apply_fn((N, H, W, C)) ->
    (N, sH, sW, C)``: even-k variants keep the input shape, odd-k variants
    batch at the transposed shape."""
    groups: dict[bool, list[tuple[int, bool]]] = {False: [], True: []}
    for k, f in DIHEDRAL:
        groups[bool(k % 2)].append((k, f))

    acc = None
    for variants in groups.values():
        batch = np.stack(
            [np.ascontiguousarray(transform(img, k, f)) for k, f in variants]
        )
        srs = np.asarray(apply_fn(batch))
        for sr, (k, f) in zip(srs, variants):
            sr = inverse_transform(sr, k, f).astype(np.float32)
            acc = sr if acc is None else acc + sr
    return acc / len(DIHEDRAL)
