"""Device copies of host constants (resample plans, DCT tables, index
vectors, loss weights), made once per value, device and dtype.

A CUDA graph cannot hold a copy from host memory, so the chains and the
train step take their constants from here: the first (eager) step makes
them, and a capture reuses them. A constant first asked for during a
capture raises instead of breaking it. On the CPU nothing is cached.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["device_const", "live"]

_MAX = 4096  # entries kept; a capture holds the ones it reads (``live``)
_cache: dict[tuple, torch.Tensor] = {}


def device_const(value, device: torch.device | str, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``value`` (a numpy array or a sequence of numbers) as a tensor on
    ``device`` in ``dtype`` (numpy's when None). Treat it as read-only."""
    device = torch.device(device)
    arr = np.ascontiguousarray(value)
    if device.type == "cpu":
        return torch.from_numpy(arr).to(dtype=dtype) if dtype is not None else torch.from_numpy(arr)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), device, dtype)
    t = _cache.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"a constant of shape {arr.shape} was first needed inside a CUDA graph capture: the "
                "dispatch's first steps run eagerly and make every constant the capture reads")
        if len(_cache) >= _MAX:
            _cache.pop(next(iter(_cache)))
        t = torch.from_numpy(arr.copy()).to(device=device, dtype=dtype)
        _cache[key] = t
    return t


def live() -> list[torch.Tensor]:
    """Every cached constant: a captured graph keeps these references, so
    that no entry it reads is freed by a later eviction."""
    return list(_cache.values())
