#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``srganfd_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and nvcc. It builds every kernel of ``srganfd_tpu_torch/csrc`` from source,
holds each kernel against its plain PyTorch version at the main path's
shapes and times it, then drives the serving path end to end at full
width (``bsrgan_x2``: 64 channels, growth 32, 23 RRDBs, seeded weights):

1. kernel phase: ``rdb_forward`` vs ``rdb_forward_ref`` in f32 and bf16,
   including ragged shapes; CUDA-event times of the kernel, the plain
   version and a bf16 cuDNN 5-conv chain (a yardstick the port never
   calls) at x (1, 256, 256, 64), beside the card's bound;
2. serving phase: ``ServingEngine`` over ``serve_stdio`` (4 requests of
   256x256, f32 then bf16), a ``--batch 2`` watch ``--once`` drain and a
   250x190 frame; every reply must be ok at the right size and every
   generator forward must make exactly 69 RDB kernel calls. One frame is
   run again with the plain RDB to hold the whole model to it;
3. infer phase: ``cli.infer --half --batch 2`` on a directory of frames.

It exits non-zero on any failure, and when no CUDA device is visible.
The line before the last is one JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
SERVE_SHAPE = (1, 256, 256, 64)  # x of every RDB for a 256x256 frame
CH, GC, NUM_RRDB = 64, 32, 23
RDB_PER_FORWARD = 3 * NUM_RRDB


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def rdb_inputs(shape, seed: int):
    """x and kaiming-normal RDB weights (gain sqrt(2), no x0.1, so outputs
    are O(1) and a rounding slip shows), made on the CPU from a seed."""
    g = torch.Generator().manual_seed(seed)
    n, h, w, ch = shape
    x = torch.randn(shape, generator=g)
    kernels, biases = [], []
    for k in range(5):
        cin, cout = ch + k * GC, GC if k < 4 else ch
        kernels.append(torch.randn(3, 3, cin, cout, generator=g) * math.sqrt(2.0 / (9 * cin)))
        biases.append(torch.randn(cout, generator=g) * 0.1)
    dev = lambda t: t.cuda()
    return dev(x), [dev(k) for k in kernels], [dev(b) for b in biases]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cudnn_chain(x, kernels, biases):
    """The RDB as five bf16 cuDNN convs over torch.cat (library yardstick)."""
    import torch.nn.functional as F

    xc = x.permute(0, 3, 1, 2)
    ws = [k.to(x.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
          for k in kernels]
    bs = [b.to(x.dtype) for b in biases]

    def run():
        feats = [xc]
        for k in range(4):
            feats.append(F.leaky_relu(F.conv2d(torch.cat(feats, 1), ws[k], bs[k], padding=1), 0.2))
        return F.conv2d(torch.cat(feats, 1), ws[4], bs[4], padding=1) * 0.2 + xc

    return run


def kernel_phase(rdb) -> dict:
    """rdb_forward vs rdb_forward_ref at the main path's shapes, then times."""
    errs = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(2, 64, 64, CH), (1, 37, 53, CH), SERVE_SHAPE, (2, 256, 256, CH), (1, 250, 190, CH)]
    for i, shape in enumerate(cases):
        x, ks, bs = rdb_inputs(shape, seed=i)
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            got = rdb.rdb_forward(xd, ks, bs).float()
            torch.cuda.synchronize()
            want = rdb.rdb_forward_ref(xd, ks, bs).float()
            diff = (got - want).abs()
            max_err, mean_err = diff.max().item(), diff.mean().item()
            name = "float32" if dt == torch.float32 else "bfloat16"
            errs[name] = max(errs[name], max_err)
            print(f"rdb {shape} {dt}: max abs {max_err:.3g}, mean abs {mean_err:.3g}", flush=True)
            if dt == torch.float32:
                # same f32 operands, sums in another order; TF32 is off
                check(torch.allclose(got, want, atol=1e-4, rtol=0), f"f32 rdb {shape}: {max_err}")
            else:
                # 1.6e-2 is one bf16 ulp at |y| ~ 2: an out_k rounded the
                # other way after a different f32 summation order
                check(torch.allclose(got, want, atol=1.6e-2, rtol=1.6e-2), f"bf16 rdb {shape}: {max_err}")
                check(mean_err <= 1e-3, f"bf16 rdb {shape}: mean abs {mean_err}")

    # the kernel against the plain version run on the CPU, which sums in yet
    # another order: the f32 agreement does not hang on one summation order
    x, ks, bs = rdb_inputs((1, 37, 53, CH), seed=1)
    got = rdb.rdb_forward(x, ks, bs).cpu()
    want = rdb.rdb_forward_ref(x.cpu(), [k.cpu() for k in ks], [b.cpu() for b in bs])
    err_cpu = (got - want).abs().max().item()
    print(f"rdb (1, 37, 53, {CH}) float32 vs plain version on the CPU: max abs {err_cpu:.3g}", flush=True)
    check(err_cpu <= 1e-4, f"f32 rdb vs CPU plain version: {err_cpu}")

    x, ks, bs = rdb_inputs(SERVE_SHAPE, seed=100)
    xb = x.to(torch.bfloat16)
    packed_b = rdb.pack_rdb_weights(ks, bs, torch.bfloat16)
    packed_f = rdb.pack_rdb_weights(ks, bs, torch.float32)
    with torch.inference_mode():
        kernel_ms = cuda_ms(lambda: rdb.rdb_forward(xb, ks, bs, packed_b))
        kernel_f32_ms = cuda_ms(lambda: rdb.rdb_forward(x, ks, bs, packed_f))
        plain_ms = cuda_ms(lambda: rdb.rdb_forward_ref(xb, ks, bs))
        library_ms = cuda_ms(cudnn_chain(xb, ks, bs))
    n, h, w, ch = SERVE_SHAPE
    mac_per_px = sum(9 * (ch + k * GC) * (GC if k < 4 else ch) for k in range(5))
    flops = 2 * n * h * w * mac_per_px
    # x read once, output written once, weights (bf16) and biases (f32) read once
    bytes_moved = 2 * (2 * n * h * w * ch) + 2 * packed_b[0].numel() + 4 * packed_b[1].numel()
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, bytes_moved / PEAK_HBM_BYTES * 1e3
    # the f32 path: f32 x, output and weights, and the f32 rate of the CUDA cores
    bytes_f32 = 4 * (2 * n * h * w * ch) + 4 * packed_f[0].numel() + 4 * packed_f[1].numel()
    bound_f32_ms = max(flops / PEAK_F32_FLOPS, bytes_f32 / PEAK_HBM_BYTES) * 1e3
    print(
        f"rdb timing at x {SERVE_SHAPE} bf16: kernel {kernel_ms:.4f} ms (f32 {kernel_f32_ms:.4f}), "
        f"plain {plain_ms:.4f} ms, cuDNN bf16 chain {library_ms:.4f} ms, "
        f"bound {max(t_ops, t_bytes):.4f} ms ({flops:.3e} FLOP, {bytes_moved:.3e} B; "
        f"f32 bound {bound_f32_ms:.4f} ms), {flops / kernel_ms / 1e9:.1f} TFLOP/s",
        flush=True,
    )
    return {
        "name": "rdb_forward",
        "route": "cuda",
        "source": "srganfd_tpu_torch/csrc/rdb.cu",
        "replaces": "srganfd_tpu/ops/pallas/rdb.py:331",
        "also_replaces": "srganfd_tpu/ops/pallas/rdb.py:254",
        "max_abs_err": max(errs.values()),
        "max_abs_err_f32": errs["float32"],
        "max_abs_err_bf16": errs["bfloat16"],
        "max_abs_err_f32_vs_cpu": err_cpu,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "kernel_f32_ms": kernel_f32_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_f32_ms": bound_f32_ms,
        "shape": list(SERVE_SHAPE),
        "dtype": "bfloat16",
    }


def write_frames(d: str, n: int, h: int, w: int, seed: int) -> list[str]:
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    paths = []
    for i in range(n):
        # a smooth field plus noise: closer to a CFD frame than pure noise
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        base = 0.5 + 0.3 * np.sin(2 * np.pi * (xx * (i + 1) + yy * rng.uniform(0.5, 2)))
        img = np.clip(base[..., None] + 0.1 * rng.standard_normal((h, w, 3)), 0, 1)
        p = os.path.join(d, f"frame_{i:03d}.png")
        cv2.imwrite(p, (img * 255).astype(np.uint8))
        paths.append(p)
    return paths


def serve_phase(work: str, rdb, blocks) -> tuple[int, dict]:
    """Full-width bsrgan_x2 serving; returns the RDB kernel calls it made
    and the generator's forward time on the card per dtype."""
    import cv2

    from srganfd_tpu_torch.cli.serve import ServingEngine, serve_stdio, serve_watch
    from srganfd_tpu_torch.data.datasets import load_image_rgb

    frames = write_frames(os.path.join(work, "lr"), 4, 256, 256, seed=0)
    launches, forward_ms = 0, {}
    for half in (False, True):
        tag = "bf16" if half else "f32"
        engine = ServingEngine("bsrgan_x2", half=half, device="cuda", seed=0)
        reqs = [{"id": i, "input": p, "output": os.path.join(work, f"sr_{tag}", os.path.basename(p))}
                for i, p in enumerate(frames)]
        lines = [json.dumps(r) for r in reqs] + ['{"cmd": "stats"}', '{"cmd": "shutdown"}']
        out = io.StringIO()
        rdb.launches = 0
        t0 = time.perf_counter()
        serve_stdio(engine, inp=io.StringIO("\n".join(lines)), out=out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = rdb.launches
        launches += calls
        replies = [json.loads(line) for line in out.getvalue().splitlines()]
        check(len(replies) == 5, f"{tag}: {len(replies)} replies")
        for r in replies[:4]:
            check(r.get("ok") and r["out_hw"] == [512, 512], f"{tag} reply {r}")
        check(calls == 4 * RDB_PER_FORWARD, f"{tag}: {calls} rdb_forward calls for 4 forwards")
        print(f"serve stdio {tag}: 4 x 256x256 -> 512x512 in {wall:.2f} s, "
              f"per-frame ms {[r['ms'] for r in replies[:4]]}, stats {replies[4]}, "
              f"{calls // 4} rdb_forward calls per forward", flush=True)

        # whole model, kernel RDB vs plain RDB, same weights, same frame
        x = torch.from_numpy(load_image_rgb(frames[0])[None]).cuda()
        with torch.inference_mode():
            y_kernel = engine.model(x)
            orig = blocks.rdb_forward
            blocks.rdb_forward = lambda xh, k, b, packed=None: rdb.rdb_forward_ref(xh, k, b)
            try:
                y_plain = engine.model(x)
            finally:
                blocks.rdb_forward = orig
        err = (y_kernel - y_plain).abs().max().item()
        mse = ((y_kernel - y_plain) ** 2).mean().item()
        psnr = 10 * math.log10(1.0 / mse) if mse > 0 else float("inf")
        print(f"model {tag}: kernel vs plain RDB max abs {err:.3g}, PSNR {psnr:.2f} dB", flush=True)
        check(torch.isfinite(y_kernel).all().item(), f"{tag}: non-finite output")
        if half:
            check(err <= 8 / 255 and psnr >= 45, f"bf16 model: max abs {err}, PSNR {psnr}")
        else:
            check(err <= 1e-3, f"f32 model: max abs {err}")
        with torch.inference_mode():
            forward_ms[tag] = cuda_ms(lambda: engine.model(x), iters=5, warmup=1)
        print(f"model {tag}: one 256x256 forward on the card {forward_ms[tag]:.2f} ms", flush=True)
        del engine

    # --batch 2 watch drain (3 frames: one full batch, one ragged tail)
    engine = ServingEngine("bsrgan_x2", half=True, batch=2, device="cuda", seed=0)
    watch_in, watch_out = os.path.join(work, "watch_in"), os.path.join(work, "watch_out")
    write_frames(watch_in, 3, 256, 256, seed=1)
    rdb.launches = 0
    t0 = time.perf_counter()
    done = serve_watch(engine, watch_in, watch_out, once=True)
    wall = time.perf_counter() - t0
    calls = rdb.launches
    launches += calls
    check(done == 3, f"watch drained {done} frames")
    for name in sorted(os.listdir(watch_out)):
        check(cv2.imread(os.path.join(watch_out, name)).shape == (512, 512, 3), f"watch {name}")
    check(calls == 2 * RDB_PER_FORWARD, f"watch: {calls} rdb_forward calls for 2 forwards")
    print(f"serve watch --batch 2 bf16: 3 frames in {wall:.2f} s, {calls} rdb_forward calls", flush=True)

    # a frame with odd edges
    odd = write_frames(os.path.join(work, "odd"), 1, 250, 190, seed=2)[0]
    rdb.launches = 0
    reply = engine.sr_file(odd, os.path.join(work, "odd_sr.png"))
    calls = rdb.launches
    launches += calls
    check(reply["ok"] and reply["out_hw"] == [500, 380], f"odd frame reply {reply}")
    check(calls == RDB_PER_FORWARD, f"odd frame: {calls} rdb_forward calls")
    print(f"serve 250x190 bf16: {reply}", flush=True)
    return launches, forward_ms


def infer_phase(work: str, rdb) -> int:
    import cv2

    from srganfd_tpu_torch.cli import infer

    frames_dir, out_dir = os.path.join(work, "seq"), os.path.join(work, "seq_sr")
    write_frames(frames_dir, 4, 256, 256, seed=3)
    rdb.launches = 0
    infer.main([
        "--model-arch", "bsrgan_x2", "--half", "--batch", "2",
        "--inputs-path", frames_dir, "--output-path", out_dir,
    ])
    torch.cuda.synchronize()
    calls = rdb.launches
    outs = sorted(os.listdir(out_dir))
    check(len(outs) == 4, f"infer wrote {outs}")
    for name in outs:
        img = cv2.imread(os.path.join(out_dir, name))
        check(img is not None and img.shape == (512, 512, 3), f"infer {name}")
    check(calls == 2 * RDB_PER_FORWARD, f"infer: {calls} rdb_forward calls for 2 forwards")
    return calls


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, ROOT)
    from srganfd_tpu_torch.models import blocks
    from srganfd_tpu_torch.ops.cuda import build, rdb

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    names = build.build_all()
    print(f"built {names} in {time.perf_counter() - t0:.1f} s (nvcc: "
          f"{ {n: round(i['seconds'], 1) for n, i in build.build_info.items()} })", flush=True)
    for name, info in build.build_info.items():
        regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
        print(f"{name} ptxas: {regs}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    entry = kernel_phase(rdb)
    base = os.path.join(ROOT, "build")
    os.makedirs(base, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=base) as work:
        launches, forward_ms = serve_phase(work, rdb, blocks)
        launches += infer_phase(work, rdb)
    check(launches > 0, "the main path launched no rdb_forward kernel")
    entry["launches"] = launches
    entry["launches_per_forward"] = RDB_PER_FORWARD
    entry["forward_ms"] = forward_ms  # bsrgan_x2 at 256x256, whole generator
    print(f"bsrgan_x2 256x256 forward: f32 {forward_ms['f32']:.2f} ms, bf16 {forward_ms['bf16']:.2f} ms; "
          f"69 RDB kernels alone: f32 {RDB_PER_FORWARD * entry['kernel_f32_ms']:.2f} ms, "
          f"bf16 {RDB_PER_FORWARD * entry['kernel_ms']:.2f} ms", flush=True)
    print(smi)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
