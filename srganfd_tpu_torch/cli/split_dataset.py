"""Train/valid/test split utility (the port's own copy of
``srganfd_tpu/cli/split_dataset.py``, same flags and outputs).

Parity target: the dataset-splitting cells of ``ESRGAN/ESRGANpipeline.ipynb``
(cell 5: random split of the Bubbles frames into train/valid/test dirs).

Usage:
    python -m srganfd_tpu_torch.cli.split_dataset --images-dir raw/ \\
        --output-dir data/ --train 0.8 --valid 0.1 --seed 0 [--move]
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

__all__ = ["split_dataset", "main"]


def split_dataset(
    images_dir: str,
    output_dir: str,
    train: float = 0.8,
    valid: float = 0.1,
    seed: int = 0,
    move: bool = False,
) -> dict[str, int]:
    """Random train/valid/test split by ``np.random.default_rng(seed)``'s
    permutation of the sorted file names; returns per-split counts."""
    files = sorted(f for f in os.listdir(images_dir) if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".tif")))
    order = np.random.default_rng(seed).permutation(len(files))
    n_train = int(len(files) * train)
    n_valid = int(len(files) * valid)
    splits = {
        "train": order[:n_train],
        "valid": order[n_train : n_train + n_valid],
        "test": order[n_train + n_valid :],
    }
    op = shutil.move if move else shutil.copy2
    counts = {}
    for split, idxs in splits.items():
        out = os.path.join(output_dir, split)
        os.makedirs(out, exist_ok=True)
        for i in idxs:
            op(os.path.join(images_dir, files[i]), os.path.join(out, files[i]))
        print(f"{split}: {len(idxs)} images -> {out}")
        counts[split] = len(idxs)
    return counts


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="split an image dir into train/valid/test")
    ap.add_argument("--images-dir", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--train", type=float, default=0.8)
    ap.add_argument("--valid", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--move", action="store_true", help="move instead of copy")
    args = ap.parse_args(argv)
    split_dataset(args.images_dir, args.output_dir, args.train, args.valid, args.seed, args.move)


if __name__ == "__main__":
    main()
