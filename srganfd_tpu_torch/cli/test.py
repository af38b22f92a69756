"""Dataset-level evaluation entry point of the port (counterpart of
``srganfd_tpu/cli/test.py``, same flags and outputs).

Parity target: the reference ``test_*.py`` evaluation programs
(``BSRGAN/test_bsrgan.py:60-309``): SR every image in a GT dir (LR by the
config's degradation in eval mode, or from a paired LR dir), compute
PSNR/SSIM on the valid region, LPIPS (on the seeded surrogate unless
``$SRGANFD_LPIPS_NPZ`` names weights), NIQE when ``--niqe-model`` names a
pristine model; log SR images, the discriminator's sigmoid heat-maps and
attention maps and a metrics dict to the tracker; print clamped averages.

Frames are reflect-padded to a multiple of ``max(64, 16 * sf)`` (shape
buckets) unless ``--exact-shapes``; the metrics read the valid region only
(``metrics/psnr_ssim.py`` ``*_padded``). Every generator forward runs f32,
so each RDB is the 3xTF32 kernel on the card; the chain's blurs are the
filter2d kernel. The discriminators run in eval mode (``train=False``):
BatchNorm normalises with the running statistics, spectral-norm convs run
their power iteration without writing ``u``.

Beyond the JAX CLI: ``--device-type`` (``cuda``, the default, or
``cpu``), and ``--d-arch``, the discriminator of the heat-maps (default
the config's; a checkpoint trained with ``cli.train --d-arch`` needs the
same). The Real-ESRGAN chain needs each frame's kernel triple, which the
JAX CLI does not pass (its ``--config realesrgan`` raises a KeyError): the
port draws it per frame from ``(seed, frame index)``. ``--codec cv2`` takes
the BSRGAN chain's JPEG stages through the reference's cv2 round trip on
the host, the blurs on the card between them. ``--weights`` takes a
checkpoint of ``cli.train``, a reference-layout ``.pth.tar`` or a ``.npz``
of Flax paths (``tools/port_torch_weights.py``), mapped through the
arch's bridge.

Usage:
    python -m srganfd_tpu_torch.cli.test --config bsrgan --gt-dir data/test \\
        [--weights results/BSRGAN_x2/ckpt_best.pth] [--save-images] [--device-type cpu]
"""

from __future__ import annotations

import argparse
import os
import re
import time
from typing import Any

import numpy as np
import torch

from srganfd_tpu_torch import configs
from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
from srganfd_tpu_torch.cli.infer import choice_device, make_apply
from srganfd_tpu_torch.data.datasets import list_image_files, load_image_rgb
from srganfd_tpu_torch.losses.lpips import Lpips
from srganfd_tpu_torch.metrics.psnr_ssim import psnr_tensor_padded, ssim_tensor_padded
from srganfd_tpu_torch.models import check_ported, create_model
from srganfd_tpu_torch.ops.realesrgan_degrade import sample_kernel_triple
from srganfd_tpu_torch.track.tracker import Tracker
from srganfd_tpu_torch.train import checkpoint as ckpt

__all__ = ["NIQE_AUTO_MODULE_MAX_PIXELS", "select_niqe_impl", "build_parser", "run_eval", "main"]

# 'auto' NIQE-impl pixel budget: above this, the bit-exact torch twin
# (which twins the reference module's cost: minutes per megapixel-class
# frame on small hosts) yields to the numpy implementation (seconds)
NIQE_AUTO_MODULE_MAX_PIXELS = 512 * 512


def select_niqe_impl(impl: str, module_available: bool, n_pixels: int) -> str:
    """Resolve ``--niqe-impl`` per frame: 'auto' keeps the bit-exact torch
    twin for crops and small frames and takes the numpy ``niqe()`` above
    ``NIQE_AUTO_MODULE_MAX_PIXELS`` (the scores differ by convention);
    explicit choices hold unconditionally."""
    if impl == "numpy" or not module_available:
        return "numpy"
    if impl == "module":
        return "module"
    return "module" if n_pixels <= NIQE_AUTO_MODULE_MAX_PIXELS else "numpy"


def _pad_to_multiple(img: np.ndarray, mult: int) -> tuple[np.ndarray, int, int]:
    h, w = img.shape[:2]
    ph, pw = (-h) % mult, (-w) % mult
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="reflect")
    return img, h, w


def _match_hw(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Crop or zero-pad an NHWC tensor to (height, width); the padded
    region is masked out of the metrics."""
    x = x[:, :height, :width]
    ph, pw = height - x.shape[1], width - x.shape[2]
    if ph or pw:
        x = torch.nn.functional.pad(x, (0, 0, 0, pw, 0, ph))
    return x


def _config_lr(adapter: DegradationAdapter, gt: np.ndarray, index: int) -> torch.Tensor:
    """The config's eval-mode LR of one frame, (1, h, w, 3) on the
    adapter's device, keyed by the frame index as the JAX CLI keys it; for
    the Real-ESRGAN chain with the frame's kernel triple, drawn from
    ``(seed, index)``."""
    host = {"gt": gt[None]}
    cfg = adapter.cfg
    if cfg.degradation == "realesrgan":
        k1, k2, sinc = sample_kernel_triple(np.random.default_rng((cfg.seed, index)),
                                            cfg.degradation_params["model"])
        host.update({"kernel1": k1[None], "kernel2": k2[None], "sinc_kernel": sinc[None]})
    return adapter(host, index)["lr"]


def _attention_image(m: torch.Tensor, hw: tuple[int, int]) -> np.ndarray:
    """One attention map of the D's second output as an RGB image in [0,
    1]: a token map (N, Q, K) averaged over queries, reshaped to the token
    grid; a spatial map (N, h, w, 1) as it is; min-max normalised. ``hw``
    is the token grid, (H/4, W/4) for the self-attention U-Net's up1, where
    the JAX CLI takes a square of side sqrt(K) (the same on square frames;
    it fails on others)."""
    arr = m[0].float().cpu().numpy()
    if arr.ndim == 2:  # token attention: average over queries
        arr = arr.mean(axis=0).reshape(hw)
    arr = (arr - arr.min()) / (arr.max() - arr.min() + 1e-8)
    return np.squeeze(arr)[..., None].repeat(3, -1)


class _Clock:
    """Milliseconds of each part of a frame on the host clock, the device
    synchronised at each mark so that a part's work lands in it."""

    def __init__(self, device: torch.device) -> None:
        self.device, self.ms = device, {}
        self._t = time.perf_counter()

    def mark(self, part: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.ms[part] = self.ms.get(part, 0.0) + (now - self._t) * 1e3
        self._t = now


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags with its defaults, ``--d-arch`` and ``--device-type``."""
    ap = argparse.ArgumentParser(description="srganfd_tpu_torch evaluation")
    ap.add_argument("--config", required=True)
    ap.add_argument("--gt-dir", required=True)
    ap.add_argument("--lr-dir", default="", help="paired LR dir; default: degrade GT per config")
    ap.add_argument("--weights", default="",
                    help="a checkpoint of cli.train (ckpt_best.pth / ckpt_last.pth: G, EMA-G and D), a "
                    "reference-layout .pth.tar or a .npz of Flax paths (tools/port_torch_weights.py); default: a "
                    "seeded random generator")
    ap.add_argument("--save-images", action="store_true")
    ap.add_argument("--max-images", type=int, default=0)
    ap.add_argument("--subdivision-lpips", action="store_true",
                    help="LPIPS on 2x2 quadrants, averaged (test_bsrgan.py:233-268)")
    ap.add_argument("--save-discriminator-eval", action="store_true",
                    help="log sigmoid heat-maps of D(gt) and D(sr) (test_bsrgan.py:182-212)")
    ap.add_argument("--save-attention-layers", action="store_true",
                    help="log discriminator attention maps (test_bsrgan.py:216-221 / A-ESRGAN getAttentionLayers)")
    ap.add_argument("--niqe-model", default=os.environ.get("SRGANFD_NIQE_MODEL", ""),
                    help=".mat/.npz pristine model; enables NIQE (default $SRGANFD_NIQE_MODEL; the package "
                    "ships srganfd_tpu_torch/assets/niqe_cfd_bubbles.npz)")
    ap.add_argument("--niqe-impl", choices=("auto", "module", "numpy"), default="auto",
                    help="which reference NIQE to match: 'module' = bit-exact twin of the torch NIQE the eval "
                    "scripts call (test_bsrgan.py:125,227), 'numpy' = the numpy niqe() implementation; 'auto' "
                    "picks module, falling back to numpy above 512x512 px/frame (the twin costs minutes per "
                    "megapixel frame, as the reference module does)")
    ap.add_argument("--self-ensemble", action="store_true",
                    help="x8 geometric self-ensemble (rotations x flip averaged after inverse mapping) before "
                    "computing metrics, beyond the reference; 8x the eval FLOPs")
    ap.add_argument("--tile", type=int, default=0,
                    help="evaluate via overlapping-tile SR (feathered stitch) instead of whole-frame forwards: "
                    "keeps transformer archs at their training token count on large frames; 0 = whole frame")
    ap.add_argument("--tile-overlap", type=int, default=16)
    ap.add_argument("--tiny", action="store_true", help="shrink models (matches train --tiny)")
    ap.add_argument("--codec", choices=["diffjpeg", "cv2"], default="diffjpeg",
                    help="degradation JPEG stages for config-degraded LR: DiffJPEG (default) or the reference's "
                    "cv2 round trip on the host (byte-exact against the reference)")
    ap.add_argument("--use-ema", action="store_true", help="evaluate the EMA generator instead of the raw one")
    ap.add_argument("--exact-shapes", action="store_true",
                    help="disable shape bucketing: one shape per image size, but no reflect-pad seam inside the "
                    "generator's receptive field (metrics are exact either way)")
    ap.add_argument("--d-arch", default="",
                    help="the discriminator of --save-discriminator-eval / --save-attention-layers (default: the "
                    "config's); a checkpoint trained with cli.train --d-arch needs the same")
    ap.add_argument("--device-type", "--device_type", dest="device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv: list[str] | None = None) -> None:
    run_eval(build_parser().parse_args(argv))


def _load_generator(args, cfg, model: torch.nn.Module, payload: dict[str, Any] | None) -> None:
    """G (``--use-ema``: EMA-G) from the checkpoint's payload into
    ``model``, or a notice that it keeps its seeded init."""
    if payload is None:
        print("! no --weights: randomly initialized generator")
        return
    if args.use_ema:
        if ckpt.is_reference_layout(payload):
            print("! --use-ema ignored: a reference-layout file carries a single param tree (no EMA variant "
                  "to select)")
        else:
            ckpt.warn_if_young_ema(payload, cfg.model_ema_decay, cfg.ema_reference_semantics)
    key = "ema_state_dict" if args.use_ema else "state_dict"
    model.load_state_dict(ckpt.state_dict_of(payload, key, args.weights))


def _load_discriminator(d_model: torch.nn.Module, payload: dict[str, Any] | None) -> None:
    """D with its ``u`` and running statistics from a checkpoint of
    ``cli.train``, else a notice that it keeps its seeded init."""
    if payload is not None and "d_state_dict" in payload:
        d_model.load_state_dict(payload["d_state_dict"])
    elif payload is not None:
        print("! checkpoint has no discriminator: using random D for heat-maps")


def run_eval(args) -> dict:
    """Evaluate per ``args`` (``main``'s flags; a Namespace built by hand
    may lack the newer ones, which take their defaults). Returns ``{"avg":
    the clamped averages, "generator_shapes": distinct input shapes the
    generator ran (the JAX CLI's ``generator_compiles``), "per_image": each
    frame's metrics and ms of its parts}``."""
    device = choice_device(getattr(args, "device", "cuda"))
    cfg = configs.get_config(args.config, mode="test")
    if args.tiny:
        count_key = "num_blocks" if cfg.g_arch.startswith("rrdbnet") else "num_rrdb"
        cfg = cfg.replace(g_kwargs={**cfg.g_kwargs, "channels": 8, "growth_channels": 4, count_key: 1})
    # programmatic overrides: a sibling arch under the family config
    if getattr(args, "g_arch", ""):
        m = re.search(r"_x(\d+)$", args.g_arch)
        # archs without an _x<n> suffix keep the config's upscale factor
        cfg = cfg.replace(g_arch=args.g_arch, upscale_factor=int(m.group(1)) if m else cfg.upscale_factor)
    if getattr(args, "g_kwargs", None):
        cfg = cfg.replace(g_kwargs={**cfg.g_kwargs, **args.g_kwargs})
    if getattr(args, "d_arch", ""):
        check_ported(args.d_arch)
        cfg = cfg.replace(d_arch=args.d_arch)
    self_ensemble, tile = getattr(args, "self_ensemble", False), getattr(args, "tile", 0)
    exact_shapes = getattr(args, "exact_shapes", False)
    if self_ensemble and tile:
        raise SystemExit("--self-ensemble and --tile cannot combine (the ensemble runs whole-frame forwards, "
                         "defeating --tile's in-distribution token count)")
    payload = None
    model = create_model(cfg.g_arch, dtype=torch.float32, generator=torch.Generator().manual_seed(0), **cfg.g_kwargs)
    if args.weights and args.weights.endswith(".npz"):
        # a .npz of Flax paths (a ported reference .pth.tar) carries one
        # param tree: the whole G, through the arch's bridge
        if args.use_ema:
            print("! --use-ema ignored: .npz weights carry a single param tree (no EMA variant to select)")
        model.load_state_dict(ckpt.load_pretrained(args.weights, "state_dict", model))
        payload = {}
    else:
        if args.weights:
            payload = ckpt.load_checkpoint(args.weights)
        _load_generator(args, cfg, model, payload)
    model = model.to(device).eval().requires_grad_(False)
    shapes: set[tuple[int, ...]] = set()

    def generator(x: torch.Tensor) -> torch.Tensor:
        shapes.add(tuple(x.shape))
        with torch.inference_mode():
            return model(x)

    host_apply = make_apply(generator, device)
    tracker = Tracker(cfg.experience_name or cfg.name, cfg.run_name, cfg.run_id, samples_dir=cfg.samples_dir)
    gt_paths = list_image_files(args.gt_dir)
    if args.max_images:
        gt_paths = gt_paths[: args.max_images]
    lr_paths = list_image_files(args.lr_dir) if args.lr_dir else [None] * len(gt_paths)
    adapter = DegradationAdapter(cfg, seed=cfg.seed, train=False, device=device,
                                 eval_codec=getattr(args, "codec", "diffjpeg"))
    lpips = Lpips().to(device)
    if not lpips.pretrained:
        print("! LPIPS weights unavailable: reporting surrogate LPIPS (relative only)")

    niqe_model = None
    niqe_impl = getattr(args, "niqe_impl", "auto")
    niqe_auto_noted = False
    if args.niqe_model:
        from srganfd_tpu_torch.metrics import niqe as niqe_mod
        from srganfd_tpu_torch.metrics.niqe_torch import niqe_torch_exact

        niqe_model = niqe_mod.load_niqe_model(args.niqe_model)

    d_model = None
    if (args.save_discriminator_eval or args.save_attention_layers) and cfg.d_arch:
        d_model = create_model(cfg.d_arch, dtype=torch.float32, generator=torch.Generator().manual_seed(0),
                               **cfg.d_kwargs)
        _load_discriminator(d_model, payload)
        d_model = d_model.to(device).eval().requires_grad_(False)

    sf = cfg.upscale_factor
    mult = max(64, 16 * sf)
    psnrs, ssims, lpipses, niqes, per_image = [], [], [], [], []
    try:
        for i, (gt_path, lr_path) in enumerate(zip(gt_paths, lr_paths)):
            clock = _Clock(device)
            gt = load_image_rgb(gt_path)
            if exact_shapes:
                h0, w0 = gt.shape[:2]
            else:
                # shape buckets: reflect-pad to a coarse multiple; the
                # metrics read only the valid region
                gt, h0, w0 = _pad_to_multiple(gt, mult)
            if lr_path is None:
                lr = _config_lr(adapter, gt, i)
            else:
                lr_img = load_image_rgb(lr_path)
                if not exact_shapes:
                    lr_img, _, _ = _pad_to_multiple(lr_img, mult // sf)
                lr = torch.from_numpy(lr_img)[None].to(device)
            clock.mark("lr")
            if self_ensemble:
                from srganfd_tpu_torch.ops.self_ensemble import self_ensemble_batched

                sr_img = torch.from_numpy(self_ensemble_batched(host_apply, lr[0].cpu().numpy()))[None].to(device)
            elif tile:
                from srganfd_tpu_torch.parallel.tiled_inference import tiled_sr

                sr_img = torch.from_numpy(tiled_sr(host_apply, lr[0].cpu().numpy(), sf, tile=tile,
                                                   overlap=getattr(args, "tile_overlap", 16)))[None].to(device)
            else:
                sr_img = generator(lr)
            sr = _match_hw(sr_img, gt.shape[0], gt.shape[1])
            clock.mark("generator")

            gt_t = torch.from_numpy(gt)[None].to(device)
            valid = torch.tensor([[h0, w0]], device=device)
            p = float(psnr_tensor_padded(sr, gt_t, valid, sf, cfg.only_test_y_channel)[0])
            s = float(ssim_tensor_padded(sr, gt_t, valid, sf, cfg.only_test_y_channel)[0])
            clock.mark("psnr_ssim")
            # perceptual metrics and outputs use the valid crop
            sr_v, gt_v = sr[:, :h0, :w0], gt_t[:, :h0, :w0]
            with torch.inference_mode():
                if args.subdivision_lpips:
                    # 2x2 quadrant LPIPS averaged (test_bsrgan.py:233-268)
                    hh, ww = h0 // 2, w0 // 2
                    vals = [float(lpips(sr_v[:, qy * hh:(qy + 1) * hh, qx * ww:(qx + 1) * ww],
                                        gt_v[:, qy * hh:(qy + 1) * hh, qx * ww:(qx + 1) * ww])[0])
                            for qy in (0, 1) for qx in (0, 1)]
                    lp = float(np.mean(vals))
                else:
                    lp = float(lpips(sr_v, gt_v)[0])
            clock.mark("lpips")
            psnrs.append(p)
            ssims.append(s)
            lpipses.append(lp)
            record = {"path": gt_path, "psnr": p, "ssim": s, "lpips": lp}
            sr_np = sr_v[0].cpu().numpy()
            extra = ""
            if niqe_model is not None:
                sel = select_niqe_impl(niqe_impl, True, sr_np.shape[0] * sr_np.shape[1])
                if sel == "numpy" and niqe_impl == "auto" and not niqe_auto_noted:
                    niqe_auto_noted = True
                    print(f"! --niqe-impl auto: frame exceeds {NIQE_AUTO_MODULE_MAX_PIXELS} px, using the numpy "
                          "niqe() (pass --niqe-impl module to force the torch twin)")
                try:
                    if sel == "module":
                        n_score = niqe_torch_exact(sr_np.astype(np.float32), niqe_model)
                    else:
                        n_score = niqe_mod.niqe(sr_np[..., ::-1] * 255.0, niqe_model)
                except ValueError as e:
                    # too few 96 px blocks on a small SR frame: the reference
                    # NIQE divides by zero there; skip the frame's NIQE
                    print(f"! NIQE skipped for this frame: {e}")
                    n_score = float("nan")
                if np.isfinite(n_score):
                    niqes.append(n_score)
                record["niqe"] = n_score
                extra = f"  NIQE {n_score:.3f}"
                clock.mark("niqe")
            print(f"[{i + 1}/{len(gt_paths)}] {gt_path}  PSNR {p:.2f}  SSIM {s:.4f}  LPIPS {lp:.4f}{extra}")
            if args.save_images:
                tracker.log_image(sr_np, f"sr_{i:04d}")
            if d_model is not None:
                with torch.inference_mode():
                    d_out, sr_out = d_model(gt_t), d_model(sr)
                logits_gt, logits_sr = (d_out[0], sr_out[0]) if isinstance(d_out, tuple) else (d_out, sr_out)
                if args.save_discriminator_eval:
                    if isinstance(logits_gt, tuple):
                        raise ValueError(
                            f"--save-discriminator-eval: {cfg.d_arch} returns one logit map per scale, and a "
                            "heat-map takes one (the JAX CLI fails here too, reading .ndim of the tuple)")
                    if logits_gt.dim() == 4:
                        tracker.log_image(torch.sigmoid(logits_gt)[0, :h0, :w0].cpu().numpy(), f"d_gt_{i:04d}")
                        tracker.log_image(torch.sigmoid(logits_sr)[0, :h0, :w0].cpu().numpy(), f"d_sr_{i:04d}")
                if args.save_attention_layers and isinstance(sr_out, tuple):
                    attn = sr_out[1]
                    maps = attn if isinstance(attn, tuple) else (attn,)
                    grid = (gt.shape[0] // 4, gt.shape[1] // 4)  # the SA U-Net's up1 tokens
                    for j, m in enumerate(maps):
                        if m is not None:  # None: chunked attention keeps no map
                            tracker.log_image(_attention_image(m, grid), f"attn{j}_{i:04d}")
                clock.mark("discriminator")
            record["ms"] = clock.ms
            per_image.append(record)

        # clamped averages, matching test_bsrgan.py:276-309
        avg = {
            "PSNR": float(np.clip(np.mean(psnrs), 0, 100)),
            "SSIM": float(np.clip(np.mean(ssims), 0, 1)),
            "LPIPS": float(np.clip(np.mean(lpipses), 0, 1)),
        }
        if niqes:
            avg["NIQE"] = float(np.clip(np.mean(niqes), 0, 100))
        niqe_str = f"  NIQE: {avg['NIQE']:.3f}" if "NIQE" in avg else ""
        print(f"== PSNR: {avg['PSNR']:.2f} dB  SSIM: {avg['SSIM']:.4f}  LPIPS: {avg['LPIPS']:.4f}{niqe_str}")
        tracker.log_dict(avg, "test_metrics")
    finally:
        tracker.close()
    return {"avg": avg, "generator_shapes": len(shapes), "per_image": per_image}


if __name__ == "__main__":
    main()
