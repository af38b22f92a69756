"""Super-resolution inference CLI of the port (counterpart of
``srganfd_tpu/cli/infer.py``, same flags and outputs).

Builds the arch by name, loads weights, SRs one image and writes a PNG.
Pass a DIRECTORY as ``--inputs-path`` to SR a frame sequence: frames are
grouped by shape and batched (``--batch``).

Usage:
    python -m srganfd_tpu_torch.cli.infer --model-arch bsrgan_x2 \
        --inputs-path in.png --output-path out.png [--weights g.pth]
    python -m srganfd_tpu_torch.cli.infer --model-arch bsrgan_x2 \
        --inputs-path frames/ --output-path sr_frames/ --batch 8 --half
    python -m srganfd_tpu_torch.cli.infer --model-arch bsrgantrans_x2 \
        --attn-chunk 1024 --attn-backend flash --inputs-path in.png --output-path out.png
    python -m srganfd_tpu_torch.cli.infer --model-arch bsrgan_x2 --quant-int8 \
        --inputs-path in.png --output-path out.png

Across ranks (one process per GPU, ``torchrun`` or the JAX package's
``JAX_COORDINATOR_ADDRESS``/``JAX_PROCESS_ID``/``JAX_NUM_PROCESSES``;
NCCL on the card, gloo with ``--device-type cpu``):
    torchrun --nproc-per-node 4 -m srganfd_tpu_torch.cli.infer \
        --model-arch bsrgan_x2 --spatial-shard --inputs-path big.png --output-path sr.png
    torchrun --nproc-per-node 4 -m srganfd_tpu_torch.cli.infer \
        --model-arch bsrgantrans_x2 --spatial-shard --cp-backend ulysses ...
    torchrun --nproc-per-node 4 -m srganfd_tpu_torch.cli.infer \
        --model-arch bsrgan_x2 --data-shard --batch 8 --inputs-path frames/ --output-path sr/
``--spatial-shard`` splits one frame's rows over the ranks
(``parallel/spatial.py``); rank 0 writes the frame. ``--data-shard``
splits each frame batch; each rank writes its own frames. Without a group
both run as a world of one.

Runs on ``cuda`` unless ``--device-type cpu`` is given; asking for cuda
without a visible GPU exits with an error.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time
from typing import Callable

import cv2
import numpy as np
import torch

from srganfd_tpu_torch.convert import load_generator_weights
from srganfd_tpu_torch.data.datasets import list_image_files, load_image_rgb
from srganfd_tpu_torch.models import arch_accepts, create_model
from srganfd_tpu_torch.models.blocks import ATTN_BACKENDS, CP_BACKENDS
from srganfd_tpu_torch.parallel import comm
from srganfd_tpu_torch.parallel.mesh import maybe_init_distributed


def add_parallel_flags(ap: argparse.ArgumentParser) -> None:
    """``--spatial-shard`` and ``--cp-backend``, with the JAX CLIs' meaning."""
    ap.add_argument("--spatial-shard", action="store_true",
                    help="shard the frame's rows over the ranks of the process group (torchrun), with a "
                    "halo exchange of --tile-overlap rows; transformer archs (bsrgantrans_x2) run their "
                    "attention context-parallel over the ranks so every token still attends to the "
                    "whole frame. One rank without a group")
    ap.add_argument("--cp-backend", choices=list(CP_BACKENDS), default="ring",
                    help="--spatial-shard transformer attention: 'ring' (K/V blocks rotate over the ranks, "
                    "any rank count, O(T_loc^2) scores per hop) or 'ulysses' (head-sharded all-to-all, at "
                    "most 4 ranks for 4 heads, O(T_glob^2) scores per rank; prefer ring on large frames)")


def spatial_plan(arch: str, tile_overlap: int, cp_backend: str) -> tuple[int, int, dict]:
    """(halo, row multiple, model kwargs) of ``--spatial-shard``, as the JAX
    CLIs derive them: the halo is ``--tile-overlap``; an arch with a
    transformer bottleneck (it takes ``ring_axis``) runs its attention over
    the ranks, with the halo rounded up to even and even rows per rank for
    its stride-2 token grid."""
    if not arch_accepts(arch, "ring_axis"):
        return tile_overlap, 1, {}
    halo = tile_overlap + tile_overlap % 2
    return halo, 2, {"ring_axis": "data", "ring_halo": halo, "cp_backend": cp_backend}


def add_attention_flags(ap: argparse.ArgumentParser) -> None:
    """``--attn-chunk`` and ``--attn-backend``, with the JAX CLIs' meaning."""
    ap.add_argument("--attn-chunk", type=int, default=0,
                    help="attention-bearing archs (bsrgantrans_x2): exact attention in "
                    "query chunks of this many rows, O(chunk*T) score memory; other "
                    "archs ignore it. 0 = full O(T^2) attention")
    ap.add_argument("--attn-backend", choices=list(ATTN_BACKENDS), default=None,
                    help="how --attn-chunk attention runs: 'chunked' (query-block sweep "
                    "in plain PyTorch) or 'flash' (the hand-written online-softmax CUDA "
                    "kernel). Without --attn-chunk it changes nothing. Default: "
                    "$SRGANFD_ATTN_BACKEND, else 'chunked'")


def add_quant_flag(ap: argparse.ArgumentParser) -> None:
    """``--quant-int8``, with the JAX CLIs' meaning."""
    ap.add_argument("--quant-int8", action="store_true",
                    help="int8 post-training quantization of the RDB trunk: s8 x s8 -> s32 convs on the "
                    "hand-written tensor-core kernel, per-output-channel weight and dynamic per-tensor "
                    "activation scales (ops/quant.py). Serving only; measure the PSNR cost on your data "
                    "before shipping")


def quant_kwargs(arch: str, quant_int8: bool) -> dict:
    """Model kwargs for ``--quant-int8``: ``quant`` for archs that take it
    (``arch_accepts``, as in JAX); others print that it is ignored."""
    if not quant_int8:
        return {}
    if arch_accepts(arch, "quant"):
        return {"quant": True}
    print(f"! --quant-int8 ignored: arch {arch!r} has no RDB trunk")
    return {}


def attention_kwargs(arch: str, attn_chunk: int, attn_backend: str | None) -> dict:
    """Model kwargs for the attention flags: ``attn_chunk`` only for archs
    that accept it (others print that it is ignored, as the JAX CLI does),
    ``attn_backend`` when given, for archs that take it (unset, the model
    reads ``$SRGANFD_ATTN_BACKEND``)."""
    kwargs: dict = {}
    if attn_chunk:
        if arch_accepts(arch, "attn_chunk"):
            kwargs["attn_chunk"] = attn_chunk
        else:
            print(f"! --attn-chunk ignored: arch {arch!r} has no attention to chunk")
    if attn_backend and arch_accepts(arch, "attn_backend"):
        kwargs["attn_backend"] = attn_backend
    return kwargs


def choice_device(device_type: str) -> torch.device:
    """``cuda`` (the default of every entry point) or ``cpu``; asking for
    cuda without a visible GPU exits instead of running on the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit(
            "--device-type cuda: no CUDA device is visible; "
            "pass --device-type cpu to run on the CPU"
        )
    # cuDNN runs float32 convs in TF32 by default (about three decimal
    # digits); the f32 path is held to the JAX f32 reference, so TF32 is
    # off. bf16 convs do not read these flags.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def build_model(
    arch: str,
    device: torch.device,
    weights: str = "",
    use_ema: bool = False,
    half: bool = False,
    model_kwargs: dict | None = None,
    seed: int = 0,
) -> torch.nn.Module:
    """The generator in eval mode on ``device``: weights from ``--weights``
    (``.pth`` or Flax ``.npz``), else a seeded kaiming x0.1 init."""
    model = create_model(
        arch,
        dtype=torch.bfloat16 if half else torch.float32,
        generator=torch.Generator().manual_seed(seed),
        **(model_kwargs or {}),
    )
    if weights:
        model.load_state_dict(load_generator_weights(weights, use_ema=use_ema))
    else:
        print(
            f"! no --weights given: using randomly initialized parameters (seed {seed})",
            file=sys.stderr,
        )
    return model.to(device).eval().requires_grad_(False)


def make_apply(model: torch.nn.Module, device: torch.device) -> Callable[[np.ndarray], np.ndarray]:
    """numpy (N, H, W, 3) float32 -> numpy (N, sH, sW, 3) through ``model``."""

    def apply(batch: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(device)
        with torch.inference_mode():
            return model(x).cpu().numpy()

    return apply


def _image_hw(path: str) -> tuple[int, int]:
    """(H, W) from the image header only, so grouping a long sequence by
    shape does not decode every frame twice."""
    try:
        from PIL import Image

        with Image.open(path) as im:
            w, h = im.size
        return (h, w)
    except OSError:  # PIL cannot read the header: decode instead
        img = cv2.imread(path)
        if img is None:
            raise ValueError(f"unreadable image: {path}")
        return img.shape[:2]


def _write_png(path: str, sr: np.ndarray) -> None:
    sr8 = np.clip(sr * 255.0, 0, 255).astype(np.uint8)
    cv2.imwrite(path, sr8[..., ::-1])


def run_sequence(
    model: torch.nn.Module,
    paths: list[str],
    out_dir: str,
    batch: int = 8,
    device: torch.device | str = "cuda",
    data_shard: bool = False,
) -> dict:
    """SR a frame sequence: grouped by shape, batched.

    Ragged tails pad by repeating the last frame, so a group sees one
    batch shape. Batches run one after another: decode, forward, copy
    back, encode (the JAX CLI overlaps host and device work; here that
    waits for a copy stream, ROADMAP.md A3). With ``data_shard``
    (``--data-shard``) every batch is split over the ranks of the process
    group: each rank decodes, SRs and writes its ``batch / world`` rows,
    so the ranks together write the files of the unsharded run; ``batch``
    must divide by the world. Returns {"frames": n, "buckets": k}, the
    frames this rank wrote."""
    n, r = (comm.world(), comm.rank()) if data_shard else (1, 0)
    if batch % n:
        raise SystemExit(f"--data-shard: --batch {batch} not divisible by the {n}-device data axis")
    per_rank = batch // n
    os.makedirs(out_dir, exist_ok=True)
    by_shape: dict[tuple, list[str]] = collections.defaultdict(list)
    for p in paths:
        by_shape[_image_hw(p)].append(p)

    frames = 0
    with torch.inference_mode():
        for _, group in sorted(by_shape.items()):
            for start in range(0, len(group), batch):
                chunk = group[start : start + batch]
                padded = chunk + [chunk[-1]] * (batch - len(chunk))
                mine = padded[r * per_rank:(r + 1) * per_rank]
                # the padding repeats the last frame: write each file once
                real = max(0, min(per_rank, len(group) - start - r * per_rank))
                if not real:  # this rank's rows are all padding
                    continue
                imgs = [load_image_rgb(p) for p in mine]
                sr = model(torch.from_numpy(np.stack(imgs)).to(device))
                for out_img, path in zip(sr[:real].cpu().numpy(), mine[:real]):
                    _write_png(os.path.join(out_dir, os.path.basename(path)), out_img)
                frames += real
    return {"frames": frames, "buckets": len(by_shape)}


def _maybe_ensemble(run_one, img: np.ndarray, enabled: bool) -> np.ndarray:
    """Run ``run_one`` directly or wrapped in the x8 self-ensemble."""
    if not enabled:
        return np.asarray(run_one(img))
    from srganfd_tpu_torch.ops.self_ensemble import self_ensemble

    return self_ensemble(run_one, img)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="srganfd_tpu_torch single-image inference")
    ap.add_argument("--model-arch", "--model_arch_name", dest="arch", default="rrdbnet_x4")
    ap.add_argument("--inputs-path", "--inputs_path", dest="inputs", required=True)
    ap.add_argument("--output-path", "--output_path", dest="output", required=True)
    ap.add_argument("--weights", "--model_weights_path", dest="weights", default="",
                    help=".pth (tools/export_to_torch.py) or .npz of the Flax tree")
    ap.add_argument("--use-ema", action="store_true",
                    help="evaluate the EMA generator instead of the raw one")
    ap.add_argument("--device-type", "--device_type", dest="device", default="cuda",
                    choices=["cuda", "cpu"])
    ap.add_argument("--tile", type=int, default=0,
                    help="tile size for large-image tiled SR (0 = whole image)")
    ap.add_argument("--batch", type=int, default=8,
                    help="frames per call when --inputs-path is a directory (sequence mode)")
    ap.add_argument("--tile-overlap", type=int, default=16)
    ap.add_argument("--half", action="store_true", help="bfloat16 compute")
    ap.add_argument("--self-ensemble", action="store_true",
                    help="x8 geometric self-ensemble (4 rotations x flip, averaged "
                    "after inverse mapping), 8x the serving FLOPs")
    ap.add_argument("--data-shard", action="store_true",
                    help="sequence mode: split each frame batch over the ranks of the process group "
                    "(torchrun); --batch must divide by the rank count")
    add_attention_flags(ap)
    add_quant_flag(ap)
    add_parallel_flags(ap)
    args = ap.parse_args(argv)

    device = choice_device(args.device)
    if args.data_shard or args.spatial_shard:
        maybe_init_distributed(device)
    kwargs = {**quant_kwargs(args.arch, args.quant_int8),
              **attention_kwargs(args.arch, args.attn_chunk, args.attn_backend)}
    halo, row_multiple = args.tile_overlap, 1
    spatial = args.spatial_shard and not os.path.isdir(args.inputs)
    if spatial:
        halo, row_multiple, cp_kwargs = spatial_plan(args.arch, args.tile_overlap, args.cp_backend)
        kwargs.update(cp_kwargs)
    model = build_model(args.arch, device, args.weights, args.use_ema, args.half, model_kwargs=kwargs)
    apply_fn = make_apply(model, device)

    if os.path.isdir(args.inputs):
        frame_paths = list_image_files(args.inputs)
        if not frame_paths:
            raise SystemExit(f"no images found in {args.inputs}")
        t0 = time.perf_counter()
        if args.self_ensemble:
            # each frame becomes two batch-4 calls (one per orientation);
            # frame-level batching is superseded
            from srganfd_tpu_torch.ops.self_ensemble import self_ensemble_batched

            os.makedirs(args.output, exist_ok=True)
            for p in frame_paths:
                sr = self_ensemble_batched(apply_fn, load_image_rgb(p))
                _write_png(os.path.join(args.output, os.path.basename(p)), sr)
            dt = time.perf_counter() - t0
            print(
                f"SR'd {len(frame_paths)} frames (x8 self-ensemble) to "
                f"{args.output} in {dt:.1f}s ({len(frame_paths) / dt:.2f} frames/s)"
            )
            return
        stats = run_sequence(model, frame_paths, args.output, batch=args.batch, device=device,
                             data_shard=args.data_shard)
        dt = time.perf_counter() - t0
        print(
            f"SR'd {stats['frames']} frames ({stats['buckets']} shape bucket(s)) "
            f"to {args.output} in {dt:.1f}s ({stats['frames'] / dt:.2f} frames/s)"
        )
        return

    img = load_image_rgb(args.inputs)
    if spatial:
        from srganfd_tpu_torch.parallel.spatial import spatial_sharded_sr

        def run_one(im):
            return spatial_sharded_sr(model, im, model.upscale, halo=halo, row_multiple=row_multiple, device=device)

        sr = _maybe_ensemble(run_one, img, args.self_ensemble)
        if comm.rank() != 0:  # every rank holds the whole frame; rank 0 writes it
            return
    elif args.tile:
        from srganfd_tpu_torch.parallel.tiled_inference import tiled_sr

        def run_one(im):
            return tiled_sr(apply_fn, im, model.upscale, tile=args.tile, overlap=args.tile_overlap)

        sr = _maybe_ensemble(run_one, img, args.self_ensemble)
    elif args.self_ensemble:
        from srganfd_tpu_torch.ops.self_ensemble import self_ensemble_batched

        sr = self_ensemble_batched(apply_fn, img)
    else:
        sr = apply_fn(img[None])[0]
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    _write_png(args.output, sr)
    print(f"SR image saved to {args.output} ({sr.shape[1]}x{sr.shape[0]})")


if __name__ == "__main__":
    main()
