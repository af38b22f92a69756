"""Training entry point of the port (counterpart of ``srganfd_tpu/cli/train.py``).

The reference train scripts' template (``load_dataset -> build_model ->
define_loss/optimizer/scheduler -> epoch loop{train, validate,
checkpoint-best/last}``, ``BSRGAN/train_bsrgan.py:38-232``), driven by a
config name. Ported: every config of the JAX package. ESRGAN's two stages,
``rrdbnet`` (``rrdbnet_x4`` on L1 over MATLAB-bicubic LR, PSNR selection)
and ``esrgan`` (its GAN fine-tune: the G step first, relativistic, against
the VGG-128 discriminator with BatchNorm, VGG19 content loss, LPIPS
selection); the BSRGAN recipe's two stages, the generator-only
``bsrnet`` pretrain and the ``bsrgan`` GAN fine-tune (``discriminator_unet``,
VGG19 content loss, BCE, LPIPS selection), with the BSRGAN degradation
chain; and the Real-ESRGAN recipe's two stages, ``realesrnet`` (L1) and
``realesrgan`` (the G-first GAN step, the pixel and content losses against
the USM-sharpened GT), with the second-order chain; and A-ESRGAN's
``aesrgan`` (``bsrgantrans_x2`` against the attention-gated U-Net
discriminator, or with ``--d-arch discriminator_attention_unet_ms`` its
multi-scale ensemble, the D-first step, the BSRGAN chain). ``--config
bsrgan --d-arch discriminator_unet_sa`` trains against the U-Net with token
self-attention instead, the fork's ``BSRGANsa`` experiment. Every blur of
the chains runs the hand-written ``filter2d`` kernel and the generator's
RDBs the RDB kernel on the card.

A recipe's second stage starts from its first stage's generator:
``--pretrained-g <ckpt_last.pth>`` grafts G (and EMA-G, a copy of it)
into the fresh state by name and shape, ``--pretrained-d`` a
discriminator with its ``u`` and running statistics, before any
``--resume``, which still restores the whole state. Optimizers start
fresh. A source may also be a ``.npz`` of Flax paths
(``tools/port_torch_weights.py``), mapped through its family's bridge
(a discriminator's: the target's), or an MLflow ``runs:/`` URI. ``degradation="paired"`` (a config
override with ``train_lr_images_dir``/``valid_lr_images_dir``) trains on
registered GT/LR pairs read from disk. E.g. ``--config rrdbnet``, then ``--config esrgan --pretrained-g
results/train_RRDBNet_x4/ckpt_last.pth``.

Usage:
    python -m srganfd_tpu_torch.cli.train --config bsrgan \
        --train-dir data/train --valid-dir data/valid [--epochs N] [--device-type cpu]
    torchrun --nproc-per-node 4 -m srganfd_tpu_torch.cli.train --config bsrgan ...

Data parallelism: under ``torchrun`` (or the JAX package's coordinator
triple, ``parallel/mesh.py``) every rank joins the group first (NCCL on
the card, gloo with ``--device-type cpu``), reads its shard of the file
lists, degrades it with its own rank-keyed draws and steps on
``--batch-size`` frames, so the global batch is ``batch_size x world``;
the trainer averages the gradients and takes BatchNorm's statistics and
the relativistic means over the global batch (``train/loop.py``). Each
rank validates its own shard; only rank 0 writes the tracker, the
checkpoints and the best-model selection's files. ``--resume`` and the
pretrained grafts load on every rank. A SIGTERM that reaches any rank
preempts them all at the same step (``FlagConsensus``), after rank 0's
snapshot.

A run is step-exact: the loader is seekable, the degradation plans are
keyed by the global step, and a checkpoint holds G, EMA-G, D (with its
spectral-norm ``u`` and BatchNorm running statistics), both Adams, the step
and the applied-update counts, so ``--resume auto`` continues from the
newest snapshot as the uninterrupted run would have. Snapshots:
``ckpt_last`` every ``--ckpt-every-epochs`` epochs (best epochs and the
last one always), ``ckpt_step_last`` every ``--save-every-steps`` steps,
and ``ckpt_preempt_last`` on SIGTERM: a flag-only handler, installed before
any setup, asks the loop to save at its next safe point (a step boundary,
between validation batches, after the epoch-end saves) and exit with
128 + the signal. ``--async-ckpt`` writes them on a thread.

Data: for the GT-crop pipelines (``bicubic``, ``bsrgan``) the native C++
loader (``data/native_loader.py``: decode, crop and augment in a thread
pool, raw uint8 crops, the JAX loader's stream byte for byte), unless
``SRGANFD_NATIVE_LOADER=0`` or its library cannot be built here (one line
says why; the Python ``BatchLoader`` then), as the JAX CLI chooses; every
batch reaches the adapter through ``parallel.prefetch_to_device``, which
on the card keeps two copies in flight from page-locked memory.

The JAX CLI's dispatch variables: ``SRGANFD_FUSE_STEP=1`` (``bsrgan``
degradation) runs the chain, the aligned crop and the step as one dispatch
(``Trainer.bsrgan_fused_train_step``), ``SRGANFD_STEPS_PER_DISPATCH=K``
runs K steps as one (``bsrgan_fused_train_multi_step``, grouped by the
chain's branch key, or ``make_train_multi_step`` on the adapter's batches
in order). On the card a dispatch is one CUDA graph replay
(``train/graphs.py``); the buffers are flushed before every snapshot,
before validation and at an epoch's end, so a resume stays step-exact; the
logged metrics are a dispatch's mean. Under data parallelism both are
ignored, with JAX's messages, and the steps run one at a time.

The trainer's options: ``--grad-accum N``, ``--skip-nonfinite``, and the
config's ``grad_clip_norm`` and ``model_weight_decay`` (``train/loop.py``);
``--debug-nans`` raises at the first module whose output holds a NaN;
``--profile-dir`` writes a ``torch.profiler`` trace of the first epoch
(``utils/profiling.py``). Metrics go to stdout and to the tracker
(``track/tracker.py``: JSONL under ``samples_dir``).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import time
from typing import Any, Callable

import numpy as np
import torch

from srganfd_tpu_torch import configs
from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
from srganfd_tpu_torch.cli.infer import choice_device
from srganfd_tpu_torch.configs.base import ExperimentConfig
from srganfd_tpu_torch.data import native_loader
from srganfd_tpu_torch.data.datasets import (
    BatchLoader,
    DegeneratedImageDataset,
    PairedImageDataset,
    TrainValidImageDataset,
)
from srganfd_tpu_torch.losses.lpips import Lpips
from srganfd_tpu_torch.metrics.psnr_ssim import psnr_tensor, ssim_tensor
from srganfd_tpu_torch.models import check_ported
from srganfd_tpu_torch.ops.degrade import bsrgan_lr_size, plan_bsrgan_batch
from srganfd_tpu_torch.parallel import comm, prefetch_to_device
from srganfd_tpu_torch.parallel.mesh import FlagConsensus, make_mesh, maybe_init_distributed
from srganfd_tpu_torch.track.tracker import Tracker
from srganfd_tpu_torch.train import checkpoint as ckpt
from srganfd_tpu_torch.train.loop import Trainer
from srganfd_tpu_torch.train.state import TrainState
from srganfd_tpu_torch.utils.meters import AverageMeter, ProgressMeter
from srganfd_tpu_torch.utils.profiling import annotate, debug_nans, trace

__all__ = ["build_datasets", "build_train_loader", "validate", "graft_pretrained", "run_train", "main"]

PREFETCH = 2  # batches whose copy to the card is in flight (below native_loader.RING)

# cooperative preemption: the handler only sets the flag, and the loop
# saves ckpt_preempt at its next safe point (a save from inside the handler
# could land in the middle of another save)
_PREEMPT = {"signum": 0}


def _request_preempt(signum, frame) -> None:
    _PREEMPT["signum"] = signum
    print(f"signal {signum}: preemption checkpoint at the next safe point", flush=True)


def _install_preempt_handler(reset: bool = True) -> Any:
    """Install the flag-only SIGTERM handler; returns the one it replaced
    (None off the main thread, where no handler can be installed)."""
    if reset:
        _PREEMPT["signum"] = 0  # a fresh run does not inherit a stale request
    try:
        return signal.signal(signal.SIGTERM, _request_preempt)
    except ValueError:
        return None


def _restore_sigterm(prev: Any) -> None:
    """Undo ``_install_preempt_handler``: after training a SIGTERM ends the
    process again."""
    if prev is None:
        return
    with contextlib.suppress(ValueError):
        signal.signal(signal.SIGTERM, prev)


def build_train_loader(cfg: ExperimentConfig, train_ds: Any, start_batch: int, device: torch.device) -> Any:
    """The training stream, sought to ``start_batch``: for the GT-crop
    pipelines (``bicubic``, ``bsrgan``) the native C++ loader with raw uint8
    crops, unless ``SRGANFD_NATIVE_LOADER=0`` or its library cannot be built
    here (then one line says why), as the JAX CLI chooses it; else the
    Python ``BatchLoader``. On the card the native loader writes into a ring
    of page-locked buffers that ``prefetch_to_device`` copies from."""
    if cfg.degradation in ("bicubic", "bsrgan") and os.environ.get("SRGANFD_NATIVE_LOADER", "1") != "0":
        if native_loader.available():
            print("using native C++ data loader")
            return native_loader.NativeBatchLoader(
                train_ds.paths, crop=cfg.crop_image_size or cfg.gt_image_size, batch_size=cfg.batch_size,
                seed=cfg.seed, num_threads=max(cfg.num_workers, 2),
                # the chains divide by 255 on the device: a quarter of the transfer
                uint8=True, start_batch=start_batch, pinned=device.type == "cuda",
            )
        print(f"! native C++ data loader unavailable ({native_loader.unavailable_reason()}): "
              "using the Python BatchLoader")
    return BatchLoader(train_ds, cfg.batch_size, shuffle=True, seed=cfg.seed, num_workers=cfg.num_workers,
                       start_batch=start_batch)


def build_datasets(cfg: ExperimentConfig) -> tuple[Any, Any]:
    """GT-only train and valid datasets at the pre-crop (or GT) size (the
    BSRGAN chain and bicubic LR); for the Real-ESRGAN chain each record
    also carries its kernel triple; ``paired`` reads registered GT/LR
    pairs from ``train_lr_images_dir`` and ``valid_lr_images_dir`` beside
    the GT dirs (a config override selects it, as in JAX)."""
    if cfg.degradation == "paired":
        return (PairedImageDataset(cfg.train_gt_images_dir, cfg.train_lr_images_dir),
                PairedImageDataset(cfg.valid_gt_images_dir, cfg.valid_lr_images_dir))
    if cfg.degradation == "realesrgan":
        model = cfg.degradation_params["model"]
        return (DegeneratedImageDataset(cfg.train_gt_images_dir, cfg.gt_image_size, model, "Train"),
                DegeneratedImageDataset(cfg.valid_gt_images_dir, cfg.gt_image_size, model, "Valid"))
    if cfg.degradation not in ("bsrgan", "bicubic"):
        raise ValueError(f"unknown degradation {cfg.degradation!r}")
    crop = cfg.crop_image_size or cfg.gt_image_size
    train_ds = TrainValidImageDataset(cfg.train_gt_images_dir, cfg.gt_image_size, "Train", crop)
    valid_ds = TrainValidImageDataset(cfg.valid_gt_images_dir, cfg.gt_image_size, "Valid", crop)
    return train_ds, valid_ds


def validate(
    cfg: ExperimentConfig,
    trainer: Trainer,
    state: TrainState,
    valid_loader: BatchLoader,
    adapter: DegradationAdapter,
    lpips_fn: Lpips | None = None,
    max_batches: int = 16,
    should_stop: Callable[[], bool] | None = None,
) -> dict[str, float]:
    """Per-epoch validation: SR the degraded valid crops by G, Y-channel
    PSNR/SSIM with crop_border = upscale_factor, and LPIPS when ``lpips_fn``
    is given (``BSRGAN/train_bsrgan.py:515-607``; the [0, 1] images, the
    reference's quirk). The adapter keys its RNG by the batch index, so
    every epoch validates on the same degradations. ``should_stop`` is
    asked before each batch (a pending preemption)."""
    psnrs, ssims, lpipses = [], [], []
    for i, host_batch in enumerate(valid_loader):
        if i >= max_batches or (should_stop is not None and should_stop()):
            break
        batch = adapter(host_batch, i)
        lr, gt = batch["lr"], batch["gt"]
        sr = trainer.eval_sr(state, lr)
        if sr.shape != gt.shape:
            continue
        psnrs.extend(psnr_tensor(sr, gt, cfg.upscale_factor, cfg.only_test_y_channel).cpu().numpy())
        ssims.extend(ssim_tensor(sr, gt, cfg.upscale_factor, cfg.only_test_y_channel).cpu().numpy())
        if lpips_fn is not None:
            with torch.inference_mode():
                lpipses.extend(lpips_fn(sr, gt).cpu().numpy())
    return {
        "psnr": float(np.mean(psnrs)) if psnrs else 0.0,
        "ssim": float(np.mean(ssims)) if ssims else 0.0,
        "lpips": float(np.mean(lpipses)) if lpipses else float("inf"),
    }


def _is_best(cfg: ExperimentConfig, vm: dict[str, float], best: dict[str, float],
             last_metrics: dict[str, torch.Tensor]) -> bool:
    """Best-model selection on the configured metric
    (``BSRGAN/train_bsrgan.py:184-214``: LPIPS lower is better, D SR
    probability or PSNR higher); updates ``best`` in place."""
    if cfg.optimizing_metric == "LPIPS":
        is_best = vm["lpips"] < best["lpips"]
    elif cfg.optimizing_metric == "Discriminator SR Prob":
        d_prob = float(last_metrics.get("d_sr_probability", 0.0))
        is_best = d_prob > best.get("d_sr_prob", -1.0)
        best["d_sr_prob"] = max(best.get("d_sr_prob", -1.0), d_prob)
    else:
        is_best = vm["psnr"] > best["psnr"]
    best["psnr"] = max(best["psnr"], vm["psnr"])
    best["ssim"] = max(best["ssim"], vm["ssim"])
    best["lpips"] = min(best["lpips"], vm["lpips"])
    return is_best


def graft_pretrained(cfg: ExperimentConfig, state: TrainState) -> None:
    """The JAX trainer's pretrained initialisation, in its order
    (``srganfd_tpu/cli/train.py:235-276``, the reference's
    ``BSRGAN/train_bsrgan.py:60-92``): ``pretrained_g_model_weights_path``'s
    raw G grafted by name and shape, EMA-G restarting as a copy of it;
    ``pretrained_d_model_weights_path``'s D with its ``u`` and running
    statistics, on a config with a D (ignored otherwise, as in JAX). The
    Adams keep their fresh state; a ``--resume`` after this overrides all
    of it."""
    if cfg.pretrained_g_model_weights_path:
        path = cfg.pretrained_g_model_weights_path
        n_ok, n_all = ckpt.merge_by_path(state.g_model, ckpt.load_pretrained(path, "state_dict", state.g_model))
        with torch.no_grad():
            for name, p in state.g_model.named_parameters():
                state.ema_g[name].copy_(p)
        print(f"loaded pretrained G ({n_ok}/{n_all} tensors) from {path}")
    if cfg.pretrained_d_model_weights_path and state.d_model is not None:
        path = cfg.pretrained_d_model_weights_path
        n_ok, n_all = ckpt.merge_by_path(state.d_model, ckpt.load_pretrained(path, "d_state_dict", state.d_model))
        print(f"loaded pretrained D ({n_ok}/{n_all} tensors) from {path}")


def run_train(
    cfg: ExperimentConfig,
    steps_per_epoch: int | None = None,
    resume: str = "",
    device: torch.device | str = "cuda",
    profile_dir: str = "",
    save_every_steps: int = 0,
    async_ckpt: bool = False,
    ckpt_every_epochs: int = 1,
    check_nans: bool = False,
) -> dict:
    """Train per the config on ``device``; returns the best PSNR/SSIM/LPIPS
    and the final state. ``resume`` is a ``ckpt_*.pth`` path or ``"auto"``
    (the newest snapshot of this experiment, or a fresh start).
    ``save_every_steps`` adds ``ckpt_step_last``; ``ckpt_every_epochs`` = N
    saves ``ckpt_last`` every Nth epoch (best epochs and the last one
    always); ``async_ckpt`` writes on a thread; ``profile_dir`` traces the
    first epoch; ``check_nans`` is ``--debug-nans``. SIGTERM writes
    ``ckpt_preempt_last`` at the next safe point and raises
    ``SystemExit(128 + signum)``."""
    # installed before any setup, which takes seconds to minutes, so that a
    # signal in it is not the default's kill; restored on return
    prev_sigterm = _install_preempt_handler()
    try:
        return _run_train_body(cfg, steps_per_epoch, resume, device, profile_dir, save_every_steps,
                               async_ckpt, ckpt_every_epochs, check_nans)
    finally:
        _restore_sigterm(prev_sigterm)


def _run_train_body(
    cfg: ExperimentConfig,
    steps_per_epoch: int | None,
    resume: str,
    device: torch.device | str,
    profile_dir: str,
    save_every_steps: int,
    async_ckpt: bool,
    ckpt_every_epochs: int,
    check_nans: bool,
) -> dict:
    device = torch.device(device)
    # first, as in JAX: the rank's card is made current before anything
    # builds or launches a kernel
    maybe_init_distributed(device)
    world, is_main = comm.world(), comm.rank() == 0
    # before the datasets: a data row's ranks read one shard with one key
    mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axes)
    if world > 1:
        rows = comm.data_world()
        print(f"data parallel: rank {comm.rank()} of {world} ({comm.backend()}), {cfg.batch_size} frames a "
              f"rank, global batch {cfg.batch_size * rows}" + ("" if rows == world else f"; {mesh}"), flush=True)
    train_ds, valid_ds = build_datasets(cfg)
    spe = steps_per_epoch or cfg.steps_per_epoch or max(1, len(train_ds) // cfg.batch_size)
    if world > 1 and not (steps_per_epoch or cfg.steps_per_epoch):
        # each rank counts its own shard's files; every rank must take the
        # same number of steps, or one waits forever in the next collective
        spe = int(comm.all_reduce(torch.tensor([spe], device=device), "min").item())

    trainer = Trainer(cfg, steps_per_epoch=spe, device=device, mesh=mesh)
    train_adapter = DegradationAdapter(cfg, seed=cfg.seed, train=True, device=device)
    valid_adapter = DegradationAdapter(cfg, seed=cfg.seed + 1, train=True, device=device)
    state = trainer.init_state()
    graft_pretrained(cfg, state)

    ckpt_dir = os.path.join(cfg.results_dir, cfg.exp_name or cfg.name)
    start_step = 0
    best = {"psnr": -1.0, "ssim": -1.0, "lpips": float("inf")}
    if resume == "auto":
        resume = ckpt.find_auto_resume(ckpt_dir) or ""
        print(f"auto-resume: {resume or 'no snapshot found, fresh start'}")
    if resume:
        payload = ckpt.load_checkpoint(resume)
        ckpt.restore_state(state, payload)
        # every tracked best carries over, so ckpt_best cannot regress
        best.update(ckpt.best_metrics(payload))
        start_step = state.step
        print(f"resumed from {resume} at step {start_step} (epoch {start_step // spe})")
    start_epoch = start_step // spe

    lpips_fn = None
    if cfg.optimizing_metric == "LPIPS" or cfg.is_gan:
        lpips_fn = Lpips().to(device)
        if not lpips_fn.pretrained:
            print("! LPIPS weights unavailable: validation LPIPS is the deterministic surrogate")

    # built after the resume so the stream starts at the resume position
    train_loader = build_train_loader(cfg, train_ds, start_step, device)

    # the dispatch modes (module docstring); the plan operands and the
    # buffers are per rank, so under data parallelism they would desynchronize
    # the ranks' collective steps, as JAX's multi-host does
    needs_pixel_target = cfg.degradation == "realesrgan"
    fuse_step = cfg.degradation == "bsrgan" and os.environ.get("SRGANFD_FUSE_STEP", "0") == "1"
    if fuse_step and world > 1:
        print("! SRGANFD_FUSE_STEP ignored under multi-host (plan operands are per-host)")
        fuse_step = False
    superstep = max(1, int(os.environ.get("SRGANFD_STEPS_PER_DISPATCH", "1")))
    if superstep > 1 and world > 1:
        print("! SRGANFD_STEPS_PER_DISPATCH ignored under multi-host")
        superstep = 1
    if (fuse_step or superstep > 1) and check_nans and device.type == "cuda":
        raise ValueError("--debug-nans reads each module's output on the host, which a CUDA graph cannot hold: "
                         "run it without SRGANFD_FUSE_STEP and SRGANFD_STEPS_PER_DISPATCH")
    if fuse_step:
        print("degradation fused into the train step (SRGANFD_FUSE_STEP=1)")
    multi_step_fn = None
    if superstep > 1:
        print(f"K-step dispatch: {superstep} train steps per device dispatch" + (" (fused chain)" if fuse_step else ""))
        if not fuse_step:
            multi_step_fn = trainer.make_train_multi_step(separate_pixel_target=needs_pixel_target)
    batch_time = AverageMeter("Time", ":6.3f")
    data_time = AverageMeter("Data", ":6.3f")
    loss_meters = {"g_loss": AverageMeter("G loss", ":6.4f")}
    if trainer.has_d:
        loss_meters.update({"d_loss": AverageMeter("D loss", ":6.4f"),
                            "d_gt_probability": AverageMeter("D(GT)", ":6.4f"),
                            "d_sr_probability": AverageMeter("D(SR)", ":6.4f")})

    global_step = start_step
    epoch = start_epoch
    last_metrics: dict[str, torch.Tensor] = {}
    # every rank runs the steps and validates its own shard; only rank 0
    # writes: the tracker, the checkpoints and the best-model selection's files
    tracker = Tracker(cfg.experience_name or cfg.exp_name or cfg.name, cfg.run_name, cfg.run_id,
                      samples_dir=cfg.samples_dir, tags=cfg.tags or None, description=cfg.description,
                      enabled=is_main)
    writer = ckpt.AsyncCheckpointWriter() if async_ckpt and is_main else None

    def save_snapshot(*args, **kw) -> None:
        if is_main:
            (writer.save if writer is not None else ckpt.save_checkpoint)(*args, **kw)

    def flush_snapshots() -> None:
        if writer is not None:
            writer.wait()

    # a SIGTERM may reach some ranks only, and the step is a collective: the
    # ranks agree on it through FlagConsensus (one poll late), polled by all
    # at the same points, and wait for rank 0's snapshot before they exit
    consensus = FlagConsensus() if world > 1 else None

    def preempt_signum() -> int:
        return consensus.poll(_PREEMPT["signum"]) if consensus is not None else _PREEMPT["signum"]

    fuse_buffers: dict[tuple, list] = {}
    plain_buf: list = []

    def flush_buffers() -> None:
        """Run the buffered steps as single dispatches, so that the applied
        steps are the prefix 0..global_step: before a snapshot (a resume
        would apply some steps twice and skip others), before validating and
        at an epoch's end; then the counts come back to the state."""
        for buf in fuse_buffers.values():
            for gt_b, plan_b, tops_b, lefts_b in buf:
                trainer.bsrgan_fused_train_step(state, gt_b, plan_b, tops_b, lefts_b, cfg.gt_image_size)
            buf.clear()
        for batch_b in plain_buf:
            multi_step_fn(state, [batch_b])
        plain_buf.clear()
        trainer.sync_counts(state)

    def preempt_exit_if_requested() -> None:
        sig = preempt_signum()
        if not sig:
            return
        flush_buffers()
        save_snapshot(ckpt_dir, state, epoch, best, is_best=False, name="ckpt_preempt")
        flush_snapshots()  # about to exit: the snapshot must be on disk
        if is_main:
            print(f"preemption checkpoint written at step {state.step}; exiting", flush=True)
        if consensus is not None:
            consensus.barrier()
        raise SystemExit(128 + sig)

    nan_check = contextlib.nullcontext()
    if check_nans:
        hooked = [m for m in (state.g_model, state.d_model, trainer.content_loss) if m is not None]
        nan_check = debug_nans(*hooked)
    # the tracker's and the libraries' setup may have installed their own
    # handlers: install ours again, keeping a request that came meanwhile
    _install_preempt_handler(reset=False)
    it = source = None
    try:
        tracker.log_params(dict(vars(cfg)))
        source = iter(train_loader)
        it = prefetch_to_device(source, size=PREFETCH, device=device)
        metrics: dict[str, torch.Tensor] = {}
        with nan_check:
            for epoch in range(start_epoch, cfg.epochs):
                profiling = bool(profile_dir) and epoch == start_epoch
                progress = ProgressMeter(spe, [batch_time, data_time, *loss_meters.values()],
                                         prefix=f"Epoch[{epoch}]")
                first_slot = start_step - epoch * spe if epoch == start_epoch else 0
                with trace(profile_dir, device, enabled=profiling):
                    end = time.time()
                    for i in range(max(first_slot, 0), spe):
                        preempt_exit_if_requested()
                        host_batch = next(it)
                        if fuse_step:
                            # the adapter's draws, in its order: the plan, then the crop
                            gt_raw = host_batch["gt"]
                            n = int(gt_raw.shape[0])
                            step_rng = train_adapter.step_rng(global_step)
                            plan = plan_bsrgan_batch(
                                step_rng, n, cfg.upscale_factor,
                                jpeg_prob=cfg.degradation_params.get("jpeg_prob", 0.9),
                                scale2_prob=cfg.degradation_params.get("scale2_prob", 0.25),
                                per_sample_order=True,
                            )
                            lim = bsrgan_lr_size(int(gt_raw.shape[1]), plan) - cfg.gt_image_size // cfg.upscale_factor
                            tops = step_rng.integers(0, lim + 1, n)
                            lefts = step_rng.integers(0, lim + 1, n)
                            data_time.update(time.time() - end)
                            if superstep == 1:
                                metrics = trainer.bsrgan_fused_train_step(state, gt_raw, plan, tops, lefts,
                                                                          cfg.gt_image_size)
                            else:
                                buf = fuse_buffers.setdefault((plan.scale2, plan.scale2_interp,
                                                               plan.effective_upscale), [])
                                buf.append((gt_raw, plan, tops, lefts))
                                if len(buf) == superstep:
                                    metrics = trainer.bsrgan_fused_train_multi_step(
                                        state, *zip(*buf), cfg.gt_image_size)
                                    buf.clear()
                        else:
                            with annotate("chain"):
                                batch = train_adapter(host_batch, global_step)
                            data_time.update(time.time() - end)
                            if superstep > 1:
                                plain_buf.append(batch)
                                if len(plain_buf) == superstep:
                                    metrics = multi_step_fn(state, list(plain_buf))
                                    plain_buf.clear()
                            else:
                                metrics = trainer.train_step(state, batch["gt"], batch["lr"], batch.get("gt_pixel"))
                        # reading a loss waits for the card: only at print
                        # frequency (no metrics yet: the step is buffered)
                        if metrics:
                            last_metrics = metrics
                        if metrics and i % cfg.train_print_frequency == 0:
                            values = {k: float(v) for k, v in metrics.items()}
                            for k, meter in loss_meters.items():
                                meter.update(values[k])
                            batch_time.update(time.time() - end)
                            progress.display(i)
                            tracker.log_metrics({f"Train/{k}": v for k, v in values.items()}, global_step)
                            metrics = {}  # a dispatch's mean is logged once
                        end = time.time()
                        if save_every_steps and global_step and global_step % save_every_steps == 0:
                            flush_buffers()  # the state then holds global_step + 1 applied steps
                            save_snapshot(ckpt_dir, state, epoch, best, is_best=False, name="ckpt_step")
                        global_step += 1
                    flush_buffers()
                if profiling:
                    print(f"profiler trace written to {profile_dir}", flush=True)

                valid_loader = BatchLoader(
                    valid_ds, min(cfg.batch_size, len(valid_ds)), shuffle=False, loop=False,
                    seed=cfg.seed, drop_last=True, num_workers=cfg.num_workers,
                )
                preempt_exit_if_requested()
                # the reference validates the raw generator (train_bsrgan.py:166);
                # the EMA generator is checkpointed beside it
                # a pipe axis's ranks run each pipelined batch together: none
                # may stop alone on its own signal (the consensus below stops them)
                vm = validate(cfg, trainer, state, valid_loader, valid_adapter, lpips_fn=lpips_fn,
                              should_stop=None if trainer.microbatches else lambda: bool(_PREEMPT["signum"]))
                preempt_exit_if_requested()
                epoch_metrics = {"Valid/PSNR": vm["psnr"], "Valid/SSIM": vm["ssim"], "epoch": epoch}
                lpips_str = ""
                if lpips_fn is not None and np.isfinite(vm["lpips"]):
                    epoch_metrics["Valid/LPIPS"] = vm["lpips"]
                    lpips_str = f"  LPIPS {vm['lpips']:.4f}"
                tracker.log_metrics(epoch_metrics, global_step)
                print(f"[epoch {epoch}] valid PSNR {vm['psnr']:.3f} dB  SSIM {vm['ssim']:.4f}{lpips_str}",
                      flush=True)

                is_best = _is_best(cfg, vm, best, last_metrics)
                # best epochs and the last epoch always save
                if is_best or (epoch + 1) % max(1, ckpt_every_epochs) == 0 or epoch == cfg.epochs - 1:
                    save_snapshot(ckpt_dir, state, epoch, best, is_best)
                    flush_snapshots()  # the artifacts below are the files just written
                    if is_best:
                        tracker.log_artifact(os.path.join(ckpt_dir, "ckpt_best.pth"), "best_g_model")
                    tracker.log_artifact(os.path.join(ckpt_dir, "ckpt_last.pth"), "last_g_model")
                preempt_exit_if_requested()
        if writer is not None:
            writer.close()  # raises a failed write
    finally:
        for gen in (it, source):  # stop the loader's threads, also when a step raised
            if gen is not None:
                gen.close()
        if isinstance(train_loader, native_loader.NativeBatchLoader):
            train_loader.close()
        if writer is not None:
            with contextlib.suppress(RuntimeError):  # the body's error, if any, is the one to see
                writer.close()
        tracker.close()
    return {"best_psnr": best["psnr"], "best_ssim": best["ssim"], "best_lpips": best["lpips"],
            "state": state}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="srganfd_tpu_torch trainer")
    ap.add_argument("--config", required=True,
                    help="rrdbnet, esrgan, bsrnet, bsrgan, realesrnet, realesrgan or aesrgan")
    ap.add_argument("--train-dir", default=None)
    ap.add_argument("--valid-dir", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--steps-per-epoch", type=int, default=None)
    ap.add_argument("--compute-dtype", default=None, choices=["bfloat16", "float32"])
    ap.add_argument(
        "--resume", default="",
        help="checkpoint (.pth) to resume full state from, or 'auto' to pick this "
        "experiment's ckpt_last.pth (fresh start if none)",
    )
    ap.add_argument("--gt-size", type=int, default=None,
                    help="override gt_image_size (and disable pre-crop)")
    ap.add_argument(
        "--tiny", action="store_true",
        help="shrink the generator for smoke tests (8ch, growth 4, 1 RRDB; bsrgantrans_x2's "
        "4 heads of 2; the discriminator keeps its width); CPU only: the RDB kernel takes "
        "channel counts that are multiples of 8",
    )
    ap.add_argument("--device-type", "--device_type", dest="device", default="cuda",
                    choices=["cuda", "cpu"])
    ap.add_argument("--pretrained-g", default=None,
                    help="checkpoint (.pth, a reference-layout .pth.tar, a .npz of Flax paths in "
                    "tools/port_torch_weights.py's layout, or an MLflow runs:/<run_id>/<artifact> URI of one) whose "
                    "G initialises this run's G and EMA-G, by name and shape")
    ap.add_argument("--pretrained-d", default=None,
                    help="checkpoint (as --pretrained-g's) whose D (u and running statistics included; a .npz "
                    "carries no u) initialises this run's D, by name and shape; ignored without a D")
    ap.add_argument("--d-arch", default=None,
                    help="override the discriminator arch (ported: discriminator_unet, "
                    "discriminator_unet_sa (bsrgan's self-attention U-Net), "
                    "uNetDiscriminatorAesrgan / discriminator_attention_unet, "
                    "discriminator_attention_unet_ms, whose scales need GT sides of 16k)")
    ap.add_argument("--grad-accum", type=int, default=None,
                    help="accumulate gradients over N chunks of the batch before each optimizer step")
    ap.add_argument("--skip-nonfinite", action="store_true",
                    help="leave parameters, Adam states, EMA and D's buffers as they were on a step whose "
                    "gradients hold a NaN or an Inf")
    ap.add_argument("--async-ckpt", action="store_true",
                    help="write snapshots on a thread (the loop pays the copy to the host)")
    ap.add_argument("--save-every-steps", type=int, default=0, help="ckpt_step_last every N steps")
    ap.add_argument("--ckpt-every-epochs", type=int, default=1,
                    help="ckpt_last every N epochs (best epochs and the last one always save)")
    ap.add_argument("--profile-dir", default="",
                    help="write a torch.profiler trace (Chrome/Perfetto JSON) of the first epoch here")
    ap.add_argument("--debug-nans", action="store_true",
                    help="raise at the first module whose output holds a NaN (slow)")
    args = ap.parse_args(argv)

    overrides = {}
    if args.train_dir:
        overrides["train_gt_images_dir"] = args.train_dir
    if args.valid_dir:
        overrides["valid_gt_images_dir"] = args.valid_dir
    if args.epochs is not None:
        overrides["epochs"] = args.epochs
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    if args.compute_dtype:
        overrides["compute_dtype"] = args.compute_dtype
    if args.pretrained_g:
        overrides["pretrained_g_model_weights_path"] = args.pretrained_g
    if args.pretrained_d:
        overrides["pretrained_d_model_weights_path"] = args.pretrained_d
    if args.gt_size:
        overrides["gt_image_size"] = args.gt_size
        overrides["crop_image_size"] = 0
    if args.grad_accum:
        overrides["grad_accum_steps"] = args.grad_accum
    if args.skip_nonfinite:
        overrides["skip_nonfinite_updates"] = True
    if args.d_arch:
        try:
            check_ported(args.d_arch)
        except (NotImplementedError, KeyError) as e:
            raise SystemExit(f"--d-arch: {e.args[0]}") from None
        overrides["d_arch"] = args.d_arch
    cfg = configs.get_config(args.config, **overrides)
    if args.tiny:  # bsrgan_x2, bsrgantrans_x2 and realesrgan_x4 take num_rrdb, rrdbnet_x* num_blocks
        count_key = "num_blocks" if cfg.g_arch.startswith("rrdbnet_x") else "num_rrdb"
        cfg = cfg.replace(g_kwargs={**cfg.g_kwargs, "channels": 8, "growth_channels": 4, count_key: 1})
    device = choice_device(args.device)
    run_train(cfg, steps_per_epoch=args.steps_per_epoch, resume=args.resume, device=device,
              profile_dir=args.profile_dir, save_every_steps=args.save_every_steps,
              async_ckpt=args.async_ckpt, ckpt_every_epochs=args.ckpt_every_epochs,
              check_nans=args.debug_nans)


if __name__ == "__main__":
    main()
