"""Checkpoints of the port with ``torch.save`` (counterpart of
``srganfd_tpu/train/checkpoint.py`` ``save_checkpoint``, ``load_checkpoint``
and ``find_auto_resume``).

Parity target: the reference's checkpoint dicts (``ESRGAN/utils.py:30-101``):
``{"epoch", "best_psnr", "best_ssim", "state_dict", "ema_state_dict",
"optimizer"}``, written as ``ckpt_last.pth`` after every epoch and
``ckpt_best.pth`` when the epoch is the best so far, under
``results_dir/exp_name``. The port adds ``step`` (optimizer steps applied),
which makes ``--resume`` step-exact, as the JAX package's sidecar does, and
a ``best_<metric>`` for every best metric tracked (``best_lpips`` among
them). A GAN's files also hold ``d_state_dict`` (D, its spectral-norm
``u`` buffers and BatchNorm running statistics included) and
``d_optimizer``.
``convert.load_generator_weights`` reads G or, with ``use_ema``, EMA-G from
either file, so ``cli.infer --weights`` serves what ``cli.train`` wrote.

Each file is written to ``<name>.tmp`` and renamed into place, so a kill
during a save leaves the previous file whole. The mid-epoch, preemption and
asynchronous snapshots of the JAX package are not ported (ROADMAP.md A4).
"""

from __future__ import annotations

import os
from typing import Any

import torch

from srganfd_tpu_torch.train.state import TrainState

__all__ = ["save_checkpoint", "load_checkpoint", "best_metrics", "restore_state", "find_auto_resume"]


def save_checkpoint(
    directory: str,
    state: TrainState,
    epoch: int,
    best_metrics: dict[str, float],
    is_best: bool,
) -> None:
    """Write ``<dir>/ckpt_last.pth`` and, when ``is_best``,
    ``<dir>/ckpt_best.pth``: G and EMA-G (reference names), the optimizer,
    the step, the epoch, ``best_<k>`` for each best metric so far, and, for
    a GAN, D and its optimizer."""
    os.makedirs(directory, exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "step": int(state.step),
        **{f"best_{k}": float(v) for k, v in best_metrics.items()},
        "state_dict": _cpu(state.g_model.state_dict()),
        "ema_state_dict": _cpu(state.ema_g),
        "optimizer": state.g_opt.state_dict(),
    }
    if state.d_model is not None:
        payload["d_state_dict"] = _cpu(state.d_model.state_dict())
        payload["d_optimizer"] = state.d_opt.state_dict()
    targets = ["ckpt_last.pth"] + (["ckpt_best.pth"] if is_best else [])
    for target in targets:
        path = os.path.join(directory, target)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)


def _cpu(tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def best_metrics(payload: dict[str, Any]) -> dict[str, float]:
    """The best metrics a checkpoint carries, by name (``psnr``, ``ssim``,
    ``lpips``, ...)."""
    return {k[len("best_"):]: float(v) for k, v in payload.items() if k.startswith("best_")}


def load_checkpoint(path: str) -> dict[str, Any]:
    """The payload of a checkpoint this module wrote, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_state(state: TrainState, payload: dict[str, Any]) -> None:
    """Load a checkpoint's G, EMA-G, optimizer, step and, for a GAN, D
    (``u`` and running statistics included) and its optimizer into
    ``state``."""
    state.g_model.load_state_dict(payload["state_dict"])
    with torch.no_grad():
        for k, v in payload["ema_state_dict"].items():
            state.ema_g[k].copy_(v)
    state.g_opt.load_state_dict(payload["optimizer"])
    if state.d_model is not None:
        if "d_state_dict" not in payload:
            raise ValueError("the checkpoint holds no discriminator: it is not a GAN checkpoint")
        state.d_model.load_state_dict(payload["d_state_dict"])
        state.d_opt.load_state_dict(payload["d_optimizer"])
    state.step = int(payload["step"])


def find_auto_resume(directory: str) -> str | None:
    """``ckpt_last.pth`` in ``directory`` for ``--resume auto``, or None
    (fresh start) when there is none."""
    path = os.path.join(directory, "ckpt_last.pth")
    return path if os.path.isfile(path) else None
