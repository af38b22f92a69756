"""Training entry point of the port (counterpart of ``srganfd_tpu/cli/train.py``).

The reference train scripts' template (``load_dataset -> build_model ->
define_loss/optimizer/scheduler -> epoch loop{train, validate,
checkpoint-best/last}``, ``BSRGAN/train_bsrgan.py:38-232``), driven by a
config name. Ported: the BSRGAN recipe's two stages, the generator-only
``bsrnet`` pretrain and the ``bsrgan`` GAN fine-tune (``discriminator_unet``,
VGG19 content loss, BCE, LPIPS selection), with the BSRGAN degradation
chain; and the Real-ESRGAN recipe's two stages, ``realesrnet`` (L1) and
``realesrgan`` (the G-first GAN step, the pixel and content losses against
the USM-sharpened GT), with the second-order chain; and A-ESRGAN's
``aesrgan`` (``bsrgantrans_x2`` against the attention-gated U-Net
discriminator, or with ``--d-arch discriminator_attention_unet_ms`` its
multi-scale ensemble, the D-first step, the BSRGAN chain). Every blur of
the chains runs the hand-written ``filter2d`` kernel and the generator's
RDBs the RDB kernel on the card.

Usage:
    python -m srganfd_tpu_torch.cli.train --config bsrgan \
        --train-dir data/train --valid-dir data/valid [--epochs N] [--device-type cpu]

A run is step-exact: the loader is seekable, the degradation plans are
keyed by the global step, and a checkpoint holds G, EMA-G, D (with its
spectral-norm ``u`` and BatchNorm running statistics), both Adams and the
step, so ``--resume auto``
continues as the uninterrupted run would have. Metrics go to stdout and to
the tracker (``track/tracker.py``: JSONL under ``samples_dir``).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any

import numpy as np
import torch

from srganfd_tpu_torch import configs
from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
from srganfd_tpu_torch.cli.infer import choice_device
from srganfd_tpu_torch.configs.base import ExperimentConfig
from srganfd_tpu_torch.data.datasets import BatchLoader, DegeneratedImageDataset, TrainValidImageDataset
from srganfd_tpu_torch.losses.lpips import Lpips
from srganfd_tpu_torch.metrics.psnr_ssim import psnr_tensor, ssim_tensor
from srganfd_tpu_torch.models import check_ported
from srganfd_tpu_torch.track.tracker import Tracker
from srganfd_tpu_torch.train import checkpoint as ckpt
from srganfd_tpu_torch.train.loop import Trainer
from srganfd_tpu_torch.train.state import TrainState
from srganfd_tpu_torch.utils.meters import AverageMeter, ProgressMeter

__all__ = ["build_datasets", "validate", "run_train", "main"]

# options of the JAX trainer whose parts are not ported yet -> the
# ROADMAP.md item that ports them; setting one is an error, never a no-op
_UNPORTED_CFG = {
    "pretrained_g_model_weights_path": ("--pretrained-g", "A4"),
    "pretrained_d_model_weights_path": ("--pretrained-d", "A4"),
}
_UNPORTED_FLAGS = {
    "pretrained_g": ("--pretrained-g", "A4"),
    "pretrained_d": ("--pretrained-d", "A4"),
    "grad_accum": ("--grad-accum", "A4"),
    "skip_nonfinite": ("--skip-nonfinite", "A4"),
    "async_ckpt": ("--async-ckpt", "A4"),
    "save_every_steps": ("--save-every-steps", "A4"),
    "ckpt_every_epochs": ("--ckpt-every-epochs", "A4"),
    "profile_dir": ("--profile-dir", "A4"),
    "debug_nans": ("--debug-nans", "A4"),
}


def _reject_unported_env() -> None:
    """The JAX trainer's dispatch variables: the fused degradation+step
    program and K-step dispatch."""
    if os.environ.get("SRGANFD_FUSE_STEP", "0") == "1":
        raise NotImplementedError("SRGANFD_FUSE_STEP=1 is not ported to srganfd_tpu_torch yet: "
                                  "see ROADMAP.md A4")
    if int(os.environ.get("SRGANFD_STEPS_PER_DISPATCH", "1")) > 1:
        raise NotImplementedError("SRGANFD_STEPS_PER_DISPATCH > 1 is not ported to "
                                  "srganfd_tpu_torch yet: see ROADMAP.md A4")


def build_datasets(cfg: ExperimentConfig) -> tuple[Any, Any]:
    """GT-only train and valid datasets at the pre-crop (or GT) size; for
    the Real-ESRGAN chain each record also carries its kernel triple."""
    if cfg.degradation == "realesrgan":
        model = cfg.degradation_params["model"]
        return (DegeneratedImageDataset(cfg.train_gt_images_dir, cfg.gt_image_size, model, "Train"),
                DegeneratedImageDataset(cfg.valid_gt_images_dir, cfg.gt_image_size, model, "Valid"))
    if cfg.degradation != "bsrgan":
        raise NotImplementedError(
            f"degradation {cfg.degradation!r} is not ported to srganfd_tpu_torch yet: "
            "see ROADMAP.md A8 (other families)"
        )
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
) -> dict[str, float]:
    """Per-epoch validation: SR the degraded valid crops by G, Y-channel
    PSNR/SSIM with crop_border = upscale_factor, and LPIPS when ``lpips_fn``
    is given (``BSRGAN/train_bsrgan.py:515-607``; the [0, 1] images, the
    reference's quirk). The adapter keys its RNG by the batch index, so
    every epoch validates on the same degradations."""
    psnrs, ssims, lpipses = [], [], []
    for i, host_batch in enumerate(valid_loader):
        if i >= max_batches:
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


def run_train(
    cfg: ExperimentConfig,
    steps_per_epoch: int | None = None,
    resume: str = "",
    device: torch.device | str = "cuda",
) -> dict:
    """Train per the config on ``device``; returns the best PSNR/SSIM/LPIPS
    and the final state. ``resume`` is a ``ckpt_*.pth`` path or ``"auto"``
    (this experiment's ``ckpt_last.pth``, or a fresh start). Every epoch
    ends with a checkpoint."""
    for field, (flag, item) in _UNPORTED_CFG.items():
        if getattr(cfg, field):
            raise NotImplementedError(f"{flag} is not ported to srganfd_tpu_torch yet: "
                                      f"see ROADMAP.md {item}")
    _reject_unported_env()
    device = torch.device(device)
    train_ds, valid_ds = build_datasets(cfg)
    spe = steps_per_epoch or cfg.steps_per_epoch or max(1, len(train_ds) // cfg.batch_size)

    trainer = Trainer(cfg, steps_per_epoch=spe, device=device)
    train_adapter = DegradationAdapter(cfg, seed=cfg.seed, train=True, device=device)
    valid_adapter = DegradationAdapter(cfg, seed=cfg.seed + 1, train=True, device=device)
    state = trainer.init_state()

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
    train_loader = BatchLoader(
        train_ds, cfg.batch_size, shuffle=True, seed=cfg.seed, num_workers=cfg.num_workers,
        start_batch=start_step,
    )
    batch_time = AverageMeter("Time", ":6.3f")
    data_time = AverageMeter("Data", ":6.3f")
    loss_meters = {"g_loss": AverageMeter("G loss", ":6.4f")}
    if trainer.has_d:
        loss_meters.update({"d_loss": AverageMeter("D loss", ":6.4f"),
                            "d_gt_probability": AverageMeter("D(GT)", ":6.4f"),
                            "d_sr_probability": AverageMeter("D(SR)", ":6.4f")})

    global_step = start_step
    last_metrics: dict[str, torch.Tensor] = {}
    tracker = Tracker(cfg.experience_name or cfg.exp_name or cfg.name, cfg.run_name, cfg.run_id,
                      samples_dir=cfg.samples_dir, tags=cfg.tags or None, description=cfg.description)
    it = None
    try:
        tracker.log_params(dict(vars(cfg)))
        it = iter(train_loader)
        for epoch in range(start_epoch, cfg.epochs):
            progress = ProgressMeter(spe, [batch_time, data_time, *loss_meters.values()],
                                     prefix=f"Epoch[{epoch}]")
            end = time.time()
            first_slot = start_step - epoch * spe if epoch == start_epoch else 0
            for i in range(max(first_slot, 0), spe):
                batch = train_adapter(next(it), global_step)
                data_time.update(time.time() - end)
                last_metrics = trainer.train_step(state, batch["gt"], batch["lr"], batch.get("gt_pixel"))
                # reading a loss waits for the card: only at print frequency
                if i % cfg.train_print_frequency == 0:
                    values = {k: float(v) for k, v in last_metrics.items()}
                    for k, meter in loss_meters.items():
                        meter.update(values[k])
                    batch_time.update(time.time() - end)
                    progress.display(i)
                    tracker.log_metrics({f"Train/{k}": v for k, v in values.items()}, global_step)
                end = time.time()
                global_step += 1

            valid_loader = BatchLoader(
                valid_ds, min(cfg.batch_size, len(valid_ds)), shuffle=False, loop=False,
                seed=cfg.seed, drop_last=True, num_workers=cfg.num_workers,
            )
            # the reference validates the raw generator (train_bsrgan.py:166);
            # the EMA generator is checkpointed beside it
            vm = validate(cfg, trainer, state, valid_loader, valid_adapter, lpips_fn=lpips_fn)
            epoch_metrics = {"Valid/PSNR": vm["psnr"], "Valid/SSIM": vm["ssim"], "epoch": epoch}
            lpips_str = ""
            if lpips_fn is not None and np.isfinite(vm["lpips"]):
                epoch_metrics["Valid/LPIPS"] = vm["lpips"]
                lpips_str = f"  LPIPS {vm['lpips']:.4f}"
            tracker.log_metrics(epoch_metrics, global_step)
            print(f"[epoch {epoch}] valid PSNR {vm['psnr']:.3f} dB  SSIM {vm['ssim']:.4f}{lpips_str}",
                  flush=True)

            is_best = _is_best(cfg, vm, best, last_metrics)
            ckpt.save_checkpoint(ckpt_dir, state, epoch, best, is_best)
            if is_best:
                tracker.log_artifact(os.path.join(ckpt_dir, "ckpt_best.pth"), "best_g_model")
            tracker.log_artifact(os.path.join(ckpt_dir, "ckpt_last.pth"), "last_g_model")
    finally:
        if it is not None:
            it.close()  # stop the loader's threads, also when a step raised
        tracker.close()
    return {"best_psnr": best["psnr"], "best_ssim": best["ssim"], "best_lpips": best["lpips"],
            "state": state}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="srganfd_tpu_torch trainer")
    ap.add_argument("--config", required=True,
                    help="bsrnet, bsrgan, realesrnet, realesrgan or aesrgan (the other configs are not ported yet)")
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
        help="shrink the generator for smoke tests (8ch, growth 4, 1 block; bsrgantrans_x2's "
        "4 heads of 2; the discriminator keeps its width); CPU only: the RDB kernel takes "
        "channel counts that are multiples of 8",
    )
    ap.add_argument("--device-type", "--device_type", dest="device", default="cuda",
                    choices=["cuda", "cpu"])
    ap.add_argument("--pretrained-g", default=None, help="not ported yet")
    ap.add_argument("--pretrained-d", default=None, help="not ported yet")
    ap.add_argument("--d-arch", default=None,
                    help="override the discriminator arch (ported: discriminator_unet, "
                    "uNetDiscriminatorAesrgan / discriminator_attention_unet, "
                    "discriminator_attention_unet_ms, whose scales need GT sides of 16k)")
    ap.add_argument("--grad-accum", type=int, default=None, help="not ported yet")
    ap.add_argument("--skip-nonfinite", action="store_true", help="not ported yet")
    ap.add_argument("--async-ckpt", action="store_true", help="not ported yet")
    ap.add_argument("--save-every-steps", type=int, default=0, help="not ported yet")
    ap.add_argument("--ckpt-every-epochs", type=int, default=0, help="not ported yet")
    ap.add_argument("--profile-dir", default="", help="not ported yet")
    ap.add_argument("--debug-nans", action="store_true", help="not ported yet")
    args = ap.parse_args(argv)
    for dest, (flag, item) in _UNPORTED_FLAGS.items():
        if getattr(args, dest):
            raise SystemExit(f"{flag} is not ported to srganfd_tpu_torch yet: see ROADMAP.md {item}")

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
    if args.gt_size:
        overrides["gt_image_size"] = args.gt_size
        overrides["crop_image_size"] = 0
    if args.d_arch:
        try:
            check_ported(args.d_arch)
        except (NotImplementedError, KeyError) as e:
            raise SystemExit(f"--d-arch: {e.args[0]}") from None
        overrides["d_arch"] = args.d_arch
    cfg = configs.get_config(args.config, **overrides)
    if args.tiny:  # bsrgan_x2, bsrgantrans_x2 and realesrgan_x4 take the same widths
        cfg = cfg.replace(g_kwargs={**cfg.g_kwargs, "channels": 8, "growth_channels": 4, "num_rrdb": 1})
    device = choice_device(args.device)
    run_train(cfg, steps_per_epoch=args.steps_per_epoch, resume=args.resume, device=device)


if __name__ == "__main__":
    main()
