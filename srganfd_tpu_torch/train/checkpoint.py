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

``load_pretrained`` and ``merge_by_path`` graft a prior run's G or D into a
fresh state (``--pretrained-g``/``--pretrained-d``, the JAX package's
``load_pretrained_params`` and ``merge_by_path``): by name and shape, every
other tensor keeping its init.
"""

from __future__ import annotations

import os
from typing import Any

import torch
from torch import nn

from srganfd_tpu_torch.train.state import TrainState

__all__ = ["save_checkpoint", "load_checkpoint", "best_metrics", "restore_state", "find_auto_resume",
           "load_pretrained", "refuse_unported_source", "state_dict_of", "is_reference_layout", "merge_by_path", "warn_if_young_ema"]


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


def load_pretrained(path: str, key: str = "state_dict") -> dict[str, torch.Tensor]:
    """The state dict that ``key`` names in a checkpoint, for a graft: the
    port's ``ckpt_best.pth``/``ckpt_last.pth`` (``state_dict``, the raw G
    as the JAX graft takes ``g_params``, or ``d_state_dict``, D with its
    ``u`` and running statistics), or a reference-layout ``.pth.tar``
    (``ESRGAN/utils.py:30-101``: one model per file under ``state_dict``,
    in the port's names), which serves either key.

    The JAX package's two other sources, a ``.npz`` in
    ``tools/port_torch_weights.py``'s layout and an MLflow ``runs:/`` URI,
    are not ported (ROADMAP.md A15)."""
    refuse_unported_source(path)
    return state_dict_of(load_checkpoint(path), key, path)


def refuse_unported_source(path: str) -> None:
    """Raise, naming ROADMAP.md A15, for the JAX package's weight sources
    that the port does not read: an MLflow ``runs:/`` URI and a ``.npz`` in
    ``tools/port_torch_weights.py``'s layout."""
    if path.startswith("runs:/"):
        raise NotImplementedError(f"{path}: MLflow runs:/ sources of a pretrained model are not ported to "
                                  "srganfd_tpu_torch yet: see ROADMAP.md A15")
    if path.endswith(".npz"):
        raise NotImplementedError(f"{path}: .npz sources of a pretrained model are not ported to "
                                  "srganfd_tpu_torch yet: see ROADMAP.md A15")


def state_dict_of(payload: Any, key: str, path: str = "checkpoint") -> dict[str, torch.Tensor]:
    """``load_pretrained``'s choice in a loaded ``payload``: ``payload[key]``,
    or the one model of a reference-layout file (no ``step``), whatever the
    key; KeyError when the port's checkpoint lacks ``key``."""
    if not isinstance(payload, dict):
        raise ValueError(f"{path} holds no checkpoint dict")
    if key in payload:
        return payload[key]
    if is_reference_layout(payload):
        return payload["state_dict"]
    raise KeyError(f"checkpoint {path} has no {key!r}")


def is_reference_layout(payload: dict[str, Any]) -> bool:
    """A reference-layout ``.pth.tar`` (one model under ``state_dict``), not
    a checkpoint of the port's trainer (which carries ``step``)."""
    return "step" not in payload and "state_dict" in payload


def merge_by_path(model: nn.Module, loaded: dict[str, torch.Tensor]) -> tuple[int, int]:
    """Copy into ``model`` each entry of ``loaded`` whose name is in the
    model's state dict (parameters and buffers) with the same shape; the
    rest of the model keeps its values, and entries the model lacks (such
    as torch BatchNorm's ``num_batches_tracked``) are ignored. Returns
    ``(n_loaded, n_total)`` over the model's state dict."""
    current = model.state_dict()
    n_ok = 0
    with torch.no_grad():
        for name, cur in current.items():
            new = loaded.get(name)
            if isinstance(new, torch.Tensor) and new.shape == cur.shape:
                cur.copy_(new)
                n_ok += 1
    return n_ok, len(current)


def warn_if_young_ema(payload: dict[str, Any], decay: float, reference_semantics: bool = False) -> None:
    """``--use-ema`` on a young checkpoint serves a model that is still
    mostly its init: the conventional EMA lerps from the initial
    parameters, so after t steps the init keeps decay^t of the weight.
    Print a warning when that exceeds 5%, or when the payload carries no
    ``step`` (the JAX ``warn_if_young_ema``, reading the port payload's
    ``step``). Under ``ema_reference_semantics`` the EMA is about the raw
    model and never young: no warning."""
    if reference_semantics:
        return
    try:
        steps = int(payload["step"])
    except (KeyError, TypeError, ValueError):
        print("! --use-ema: checkpoint carries no step metadata, EMA age unknown — a young EMA may still "
              "be mostly its random init")
        return
    init_w = float(decay) ** max(0, steps)
    if init_w > 0.05:
        print(f"! --use-ema: EMA decay {decay} over only {steps} steps — the EMA still carries {init_w:.0%} "
              "of the INITIAL params; expect degraded output until ~3/(1-decay) steps (use raw weights or "
              "train longer)")
