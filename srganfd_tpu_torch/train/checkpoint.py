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
during a save leaves the previous file whole; the next save and
``find_auto_resume`` sweep the ``.tmp`` it left. Besides the epoch-end
``ckpt_last``/``ckpt_best``, the trainer writes ``ckpt_step_last.pth``
(``--save-every-steps``) and ``ckpt_preempt_last.pth`` (SIGTERM), each
recording the steps applied to the state it holds; ``find_auto_resume``
takes the newest of the three. A payload also carries ``g_count`` and
``d_count``, the updates applied to G and D (below ``step`` where
``skip_nonfinite_updates`` skipped some), which drive the schedules.

``AsyncCheckpointWriter`` (``--async-ckpt``) moves the writes to one
thread behind a queue of at most two snapshots: ``save`` returns once the
state is copied to the host, and a write's error is raised by the next
``save``, ``wait`` or ``close``. The copy is a real one on either device:
``Tensor.cpu()`` returns a CPU tensor itself, and an optimizer's
``state_dict()`` holds the live tensors the next step updates in place.

``load_pretrained`` and ``merge_by_path`` graft a prior run's G or D into a
fresh state (``--pretrained-g``/``--pretrained-d``, the JAX package's
``load_pretrained_params`` and ``merge_by_path``): by name and shape, every
other tensor keeping its init. Its sources are the port's checkpoints, a
reference-layout ``.pth.tar``, a ``.npz`` of Flax paths through its
family's bridge, and an MLflow ``runs:/`` URI of any of them
(``resolve_checkpoint_uri``).
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Any

import numpy as np
import torch
from torch import nn

from srganfd_tpu_torch.track.tracker import _optional_mlflow
from srganfd_tpu_torch.train.state import TrainState

__all__ = ["save_checkpoint", "AsyncCheckpointWriter", "load_checkpoint", "best_metrics", "restore_state", "find_auto_resume",
           "resolve_checkpoint_uri", "load_pretrained", "state_dict_of", "is_reference_layout", "merge_by_path",
           "warn_if_young_ema"]


def save_checkpoint(
    directory: str,
    state: TrainState,
    epoch: int,
    best_metrics: dict[str, float],
    is_best: bool,
    name: str = "ckpt",
    step: int | None = None,
) -> None:
    """Write ``<dir>/<name>_last.pth`` and, when ``is_best``,
    ``<dir>/<name>_best.pth``: G and EMA-G (reference names), the optimizer,
    the step (``step``, else ``state.step``: the steps applied to the
    saved state), the applied-update counts, the epoch, ``best_<k>`` for
    each best metric so far, and, for a GAN, D and its optimizer."""
    _write_snapshot(directory, host_payload(state, epoch, best_metrics, step), is_best, name)


def host_payload(
    state: TrainState, epoch: int, best_metrics: dict[str, float], step: int | None = None
) -> dict[str, Any]:
    """The checkpoint payload of ``state``, every tensor a new CPU copy."""
    payload = {
        "epoch": int(epoch),
        "step": int(state.step if step is None else step),
        "g_count": int(state.g_count),
        "d_count": int(state.d_count),
        **{f"best_{k}": float(v) for k, v in best_metrics.items()},
        "state_dict": state.g_model.state_dict(),
        "ema_state_dict": state.ema_g,
        "optimizer": state.g_opt.state_dict(),
    }
    if state.d_model is not None:
        payload["d_state_dict"] = state.d_model.state_dict()
        payload["d_optimizer"] = state.d_opt.state_dict()
    return _host_copy(payload)


def _host_copy(obj: Any) -> Any:
    """``obj`` with every tensor copied to the CPU (``copy=True``: a CPU
    tensor is copied too), containers rebuilt."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _write_snapshot(directory: str, payload: dict[str, Any], is_best: bool, name: str = "ckpt") -> None:
    """The disk half of a save: each target to ``.tmp``, renamed into place."""
    os.makedirs(directory, exist_ok=True)
    _sweep_incomplete(directory)
    targets = [f"{name}_last.pth"] + ([f"{name}_best.pth"] if is_best else [])
    for target in targets:
        path = os.path.join(directory, target)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)


def _sweep_incomplete(directory: str) -> None:
    """Drop the ``.tmp`` a killed save left: the file it was to replace is
    still whole (the rename is the save's last act)."""
    for entry in os.listdir(directory):
        if entry.endswith(".pth.tmp"):
            os.remove(os.path.join(directory, entry))


class AsyncCheckpointWriter:
    """Snapshot writes on one worker thread (the JAX package's
    ``AsyncCheckpointWriter``). ``save`` takes ``save_checkpoint``'s
    arguments, copies the state to the host on the caller's thread (the
    next step changes it in place) and queues the write; the queue holds
    at most ``max_pending`` snapshots, so a slow disk holds the loop back
    instead of filling host memory. One worker keeps the writes in order.
    A failed write is raised by the next ``save``, ``wait`` or ``close``."""

    def __init__(self, max_pending: int = 2) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="srganfd-ckpt-writer", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                _write_snapshot(*item)
            except BaseException as e:  # raised on the caller's thread
                self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async checkpoint write failed") from err

    def save(
        self,
        directory: str,
        state: TrainState,
        epoch: int,
        best_metrics: dict[str, float],
        is_best: bool,
        name: str = "ckpt",
        step: int | None = None,
    ) -> None:
        self._raise_pending()
        self._q.put((directory, host_payload(state, epoch, best_metrics, step), bool(is_best), name))

    def wait(self) -> None:
        """Block until every queued snapshot is on disk."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        if self._thread.is_alive():
            self._q.put(None)
            self._q.join()
            self._thread.join()
        self._raise_pending()

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def best_metrics(payload: dict[str, Any]) -> dict[str, float]:
    """The best metrics a checkpoint carries, by name (``psnr``, ``ssim``,
    ``lpips``, ...)."""
    return {k[len("best_"):]: float(v) for k, v in payload.items() if k.startswith("best_")}


def load_checkpoint(path: str) -> dict[str, Any]:
    """The payload of a checkpoint this module wrote, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_state(state: TrainState, payload: dict[str, Any]) -> None:
    """Load a checkpoint's G, EMA-G, optimizer, step, applied-update counts
    and, for a GAN, D (``u`` and running statistics included) and its
    optimizer into ``state``."""
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
    # payloads from before the guard: every step was an update
    state.g_count = int(payload.get("g_count", state.step))
    state.d_count = int(payload.get("d_count", state.step if state.d_model is not None else 0))


SNAPSHOTS = ("ckpt_last.pth", "ckpt_step_last.pth", "ckpt_preempt_last.pth")


def find_auto_resume(directory: str) -> str | None:
    """The snapshot ``--resume auto`` continues from: of ``ckpt_last``,
    ``ckpt_step_last`` and ``ckpt_preempt_last`` in ``directory``, the one
    with the most applied steps, a tie going to the later name in that
    order; None (a fresh start) when there is none. Sweeps the leftovers
    of a killed save first."""
    if not os.path.isdir(directory):
        return None
    _sweep_incomplete(directory)
    best_path, best_key = None, None
    for rank, name in enumerate(SNAPSHOTS):
        path = os.path.join(directory, name)
        if not os.path.isfile(path):
            continue
        # mmap: the step is read without reading the tensors
        step = int(torch.load(path, map_location="cpu", weights_only=True, mmap=True)["step"])
        if best_key is None or (step, rank) > best_key:
            best_path, best_key = path, (step, rank)
    return best_path


def resolve_checkpoint_uri(path: str) -> str:
    """An MLflow ``runs:/<run_id>/<artifact_path>`` URI as a local path
    (``srganfd_tpu/train/checkpoint.py:231-268``; the reference's
    ``loadsFromMlrun``, ``BSRGAN/bsrgan_config.py:66,109-119``); any other
    path passes through. A malformed URI raises ``ValueError``. With
    ``mlflow`` importable the tracking client downloads the artifact;
    without, the local file store (``$MLFLOW_TRACKING_URI`` with a
    ``file:`` or ``file://`` prefix stripped, else ``./mlruns``) is
    searched for ``<root>/*/<run_id>/artifacts/<artifact>``, the first
    sorted hit taken, ``FileNotFoundError`` when there is none."""
    if not path.startswith("runs:/"):
        return path
    run_id, _, artifact = path[len("runs:/"):].partition("/")
    if not run_id or not artifact:
        raise ValueError(f"malformed MLflow URI {path!r}: want runs:/<run_id>/<artifact>")
    mlflow = _optional_mlflow()
    if mlflow is not None and hasattr(mlflow, "artifacts"):
        return mlflow.artifacts.download_artifacts(run_id=run_id, artifact_path=artifact)
    root = os.environ.get("MLFLOW_TRACKING_URI", "mlruns")
    for prefix in ("file://", "file:"):
        if root.startswith(prefix):
            root = root[len(prefix):]
            break
    hits = sorted(glob.glob(os.path.join(root, "*", run_id, "artifacts", artifact)))
    if not hits:
        raise FileNotFoundError(
            f"cannot resolve {path!r}: mlflow is not installed and no "
            f"{root}/*/{run_id}/artifacts/{artifact} exists on disk"
        )
    return hits[0]


def load_pretrained(path: str, key: str = "state_dict", model: nn.Module | None = None) -> dict[str, torch.Tensor]:
    """The state dict that ``key`` names in a checkpoint, for a graft into
    ``model`` (``srganfd_tpu/train/checkpoint.py`` ``load_pretrained_params``):

    - the port's ``ckpt_best.pth``/``ckpt_last.pth`` (``state_dict``, the raw
      G as the JAX graft takes ``g_params``, or ``d_state_dict``, D with its
      ``u`` and running statistics);
    - a reference-layout ``.pth.tar`` (``ESRGAN/utils.py:30-101``: one model
      per file under ``state_dict``, in the port's names), which serves
      either key;
    - a ``.npz`` in ``tools/port_torch_weights.py``'s layout (``/``-joined
      Flax paths, the VGG-128 and attention U-Net D's ``batch_stats``
      inline), mapped to the port's names by the bridge of its own family
      for a generator, of ``model``'s class for a discriminator
      (:func:`_npz_state_dict`), and then, as every source,
      :func:`merge_by_path` takes what matches by name and shape;
    - an MLflow ``runs:/<run_id>/<artifact>`` URI naming one of these
      (:func:`resolve_checkpoint_uri`).

    The JAX package's own checkpoints are Orbax directories, which need
    JAX: a directory raises ``ValueError``."""
    path = resolve_checkpoint_uri(path)
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an Orbax checkpoint of the JAX package?): the port reads "
                         "no Orbax; convert it with `python tools/export_to_torch.py` to a .pth")
    if path.endswith(".npz"):
        if model is None:
            raise ValueError(f"{path}: a .npz source maps through the target model's bridge; pass the model")
        return _npz_state_dict(path, model)
    return state_dict_of(load_checkpoint(path), key, path)


def _npz_state_dict(path: str, model: nn.Module) -> dict[str, torch.Tensor]:
    """A ``.npz`` of ``/``-joined Flax paths as the port's state dict: a
    discriminator's tree (``batch_stats`` inline, no spectral collection,
    so every ``u`` keeps its init) through the bridge of ``model``'s class;
    any other through ``convert.flax_to_state_dict``, which picks the
    generator bridge from the tree's own keys, as ``.npz`` weights are read
    everywhere in the port."""
    from srganfd_tpu_torch import convert
    from srganfd_tpu_torch.models import discriminators as d

    d_bridges = {
        d.DiscriminatorVGG128: convert.vgg_discriminator_flax_to_state_dict,
        d.DiscriminatorUNet: lambda p, stats: convert.discriminator_flax_to_state_dict(p, None),
        d.DiscriminatorUNetSA: lambda p, stats: convert.sa_discriminator_flax_to_state_dict(p, None),
        d.AttentionUNetDiscriminator:
            lambda p, stats: convert.attention_discriminator_flax_to_state_dict(p, stats, None),
        d.MultiScaleAttentionDiscriminator:
            lambda p, stats: convert.multiscale_attention_discriminator_flax_to_state_dict(p, stats, None),
    }
    with np.load(path) as f:
        tree = convert.unflatten_flax({k: f[k] for k in f.files})
    bridge = d_bridges.get(type(model))
    if bridge is None:
        sd = convert.flax_to_state_dict(tree)
    else:
        sd = bridge({k: v for k, v in tree.items() if k != "batch_stats"}, tree.get("batch_stats", {}))
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


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
