"""Image <-> tensor conversion helpers (counterpart of
``srganfd_tpu/ops/convert.py``).

Parity target: ``image_to_tensor`` / ``tensor_to_image`` /
``preprocess_one_image`` (``BSRGAN/imgproc.py:329-386,480-491``). NHWC
``(1, H, W, C)`` as in the JAX package, not the reference's NCHW;
``half`` maps to bfloat16; tensors go to an explicit ``device``, the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["image_to_tensor", "tensor_to_image", "preprocess_one_image"]


def image_to_tensor(
    image: np.ndarray, range_norm: bool = False, half: bool = False, device: torch.device | str = "cuda"
) -> torch.Tensor:
    """HWC [0,1] float image -> (1, H, W, C) f32 tensor on ``device``;
    ``range_norm`` rescales to [-1, 1], ``half`` casts to bfloat16 (after
    the rescale, as in JAX)."""
    t = torch.from_numpy(np.ascontiguousarray(image, dtype=np.float32))[None].to(device)
    if range_norm:
        t = t * 2.0 - 1.0
    if half:
        t = t.to(torch.bfloat16)
    return t


def tensor_to_image(tensor: torch.Tensor, range_norm: bool = False, half: bool = False) -> np.ndarray:
    """(1, H, W, C) or (H, W, C) tensor -> uint8 HWC image: cast to bf16
    (``half``) or f32, ``range_norm`` maps [-1, 1] back to [0, 1] in that
    dtype, then ``clip(t.float() * 255, 0, 255)`` and truncation to uint8,
    the JAX package's order."""
    t = tensor[0] if tensor.dim() == 4 else tensor
    t = t.to(torch.bfloat16) if half else t.to(torch.float32)
    if range_norm:
        t = (t + 1.0) / 2.0
    arr = torch.clamp(t.to(torch.float32) * 255.0, 0, 255).cpu().numpy()
    return arr.astype(np.uint8)


def preprocess_one_image(image_path: str, device: torch.device | str = "cuda") -> torch.Tensor:
    """Read + decode + to the device, the inference input path
    (``BSRGAN/imgproc.py:480-491``)."""
    from srganfd_tpu_torch.data.datasets import load_image_rgb

    return image_to_tensor(load_image_rgb(image_path), device=device)
