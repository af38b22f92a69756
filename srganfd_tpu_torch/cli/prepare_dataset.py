"""Offline dataset preparation: sliding-window tiler (the port's own copy
of ``srganfd_tpu/cli/prepare_dataset.py``, same flags and outputs).

Parity target: ``ESRGAN/scripts/prepare_dataset.py:24-58`` (multiprocessing
Pool over images, fixed-size crops at a stride) and the driver
``scripts/run.py``.

Usage:
    python -m srganfd_tpu_torch.cli.prepare_dataset --images-dir raw/ \\
        --output-dir data/train --image-size 480 --step 240 [--scale 1.0]
"""

from __future__ import annotations

import argparse
import multiprocessing
import os

import cv2
import numpy as np

__all__ = ["split_one", "main"]


def split_one(task: tuple[str, str, int, int, float]) -> int:
    """Tile one image into ``size`` x ``size`` crops at ``step`` (after an
    optional bicubic ``scale``), written as ``<stem>_<top>_<left>.png``;
    returns the crop count (0 for an unreadable file)."""
    path, out_dir, size, step, scale = task
    image = cv2.imread(path, cv2.IMREAD_COLOR)
    if image is None:
        return 0
    if scale != 1.0:
        image = cv2.resize(image, None, fx=scale, fy=scale, interpolation=cv2.INTER_CUBIC)
    h, w = image.shape[:2]
    stem = os.path.splitext(os.path.basename(path))[0]
    count = 0
    for top in range(0, max(h - size, 0) + 1, step):
        for left in range(0, max(w - size, 0) + 1, step):
            crop = image[top : top + size, left : left + size]
            if crop.shape[0] != size or crop.shape[1] != size:
                continue
            cv2.imwrite(os.path.join(out_dir, f"{stem}_{top:05d}_{left:05d}.png"), crop)
            count += 1
    return count


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="tile images into training crops")
    ap.add_argument("--images-dir", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--image-size", type=int, default=480)
    ap.add_argument("--step", type=int, default=240)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--num-workers", type=int, default=os.cpu_count() or 4)
    args = ap.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    files = [
        os.path.join(args.images_dir, f)
        for f in sorted(os.listdir(args.images_dir))
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))
    ]
    tasks = [(f, args.output_dir, args.image_size, args.step, args.scale) for f in files]
    # spawned workers: a fork of a process with threads can deadlock
    with multiprocessing.get_context("spawn").Pool(args.num_workers) as pool:
        counts = pool.map(split_one, tasks)
    print(f"wrote {int(np.sum(counts))} crops from {len(files)} images to {args.output_dir}")


if __name__ == "__main__":
    main()
