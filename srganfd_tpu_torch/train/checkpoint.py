"""Checkpoints of the port with ``torch.save`` (counterpart of
``srganfd_tpu/train/checkpoint.py`` ``save_checkpoint``, ``load_checkpoint``
and ``find_auto_resume``).

Parity target: the reference's checkpoint dicts (``ESRGAN/utils.py:30-101``):
``{"epoch", "best_psnr", "best_ssim", "state_dict", "ema_state_dict",
"optimizer"}``, written as ``ckpt_last.pth`` after every epoch and
``ckpt_best.pth`` when the epoch is the best so far, under
``results_dir/exp_name``. The port adds ``step`` (optimizer steps applied),
which makes ``--resume`` step-exact, as the JAX package's sidecar does.
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

__all__ = ["save_checkpoint", "load_checkpoint", "restore_state", "find_auto_resume"]


def save_checkpoint(
    directory: str,
    state: TrainState,
    epoch: int,
    best_metrics: dict[str, float],
    is_best: bool,
) -> None:
    """Write ``<dir>/ckpt_last.pth`` and, when ``is_best``,
    ``<dir>/ckpt_best.pth``: G and EMA-G (reference names), the optimizer,
    the step, the epoch and the best PSNR and SSIM so far."""
    os.makedirs(directory, exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "step": int(state.step),
        "best_psnr": float(best_metrics["psnr"]),
        "best_ssim": float(best_metrics["ssim"]),
        "state_dict": {k: v.detach().cpu() for k, v in state.g_model.state_dict().items()},
        "ema_state_dict": {k: v.detach().cpu() for k, v in state.ema_g.items()},
        "optimizer": state.g_opt.state_dict(),
    }
    targets = ["ckpt_last.pth"] + (["ckpt_best.pth"] if is_best else [])
    for target in targets:
        path = os.path.join(directory, target)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)


def load_checkpoint(path: str) -> dict[str, Any]:
    """The payload of a checkpoint this module wrote, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_state(state: TrainState, payload: dict[str, Any]) -> None:
    """Load a checkpoint's G, EMA-G, optimizer and step into ``state``."""
    state.g_model.load_state_dict(payload["state_dict"])
    with torch.no_grad():
        for k, v in payload["ema_state_dict"].items():
            state.ema_g[k].copy_(v)
    state.g_opt.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])


def find_auto_resume(directory: str) -> str | None:
    """``ckpt_last.pth`` in ``directory`` for ``--resume auto``, or None
    (fresh start) when there is none."""
    path = os.path.join(directory, "ckpt_last.pth")
    return path if os.path.isfile(path) else None
