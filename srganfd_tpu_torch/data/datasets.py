"""Image listing and decoding for the port's CLIs (its own copies of
``srganfd_tpu/data/datasets.py`` ``IMAGE_EXTS``, ``list_image_files`` and
``load_image_rgb``)."""

from __future__ import annotations

import os

import cv2
import numpy as np

__all__ = ["IMAGE_EXTS", "list_image_files", "load_image_rgb"]

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp")


def list_image_files(directory: str) -> list[str]:
    """Sorted paths of the images in ``directory`` (by extension)."""
    names = sorted(f for f in os.listdir(directory) if f.lower().endswith(IMAGE_EXTS))
    return [os.path.join(directory, f) for f in names]


def load_image_rgb(path: str) -> np.ndarray:
    """Decode to float32 RGB [0,1] HWC (cv2.imread + BGR->RGB, /255 —
    matching ``ESRGAN/dataset.py:57-66``)."""
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"failed to read image {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
