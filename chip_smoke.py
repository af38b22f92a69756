#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``srganfd_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and nvcc. It builds every kernel of ``srganfd_tpu_torch/csrc`` from source,
holds each kernel against its plain PyTorch version at the main paths'
shapes and times it, then drives two serving paths end to end at full
width, with seeded weights: ``bsrgan_x2`` (64 channels, growth 32, 23
RRDBs) and ``bsrgantrans_x2`` (the same trunk, then 2 transformer layers
of 4 heads and FFN 2048 over the H/2 x W/2 tokens, ``--attn-chunk 1024
--attn-backend flash``), and trains ``bsrgan_x2`` at full width:

1. kernel phases: ``rdb_forward`` vs ``rdb_forward_ref`` and
   ``flash_attention`` vs ``flash_attention_ref``, in f32 (the 3xTF32
   tensor-core kernels) and bf16 (the bf16 tensor-core kernels), including
   ragged shapes at the edges of the kernels' tiles (RDB (16, 72, 72, 64),
   (3, 17, 23, 64), cin with a half-filled 16-channel step, gc 8; flash
   T in {1, 15, 17, 63, 65, 129} at D = 16 and 32); CUDA-event times of
   each kernel, its plain version and one library call that the port
   never makes (a cuDNN 5-conv chain; ``scaled_dot_product_attention``,
   its backend named), in bf16 and in f32 with TF32 off, at the serving
   shapes, x (1, 256, 256, 64) and q (1, 16384, 4, 16), and of the RDB at
   the training shape, beside the card's bounds (f32: on the CUDA cores,
   and as three TF32 products on the tensor cores), with TFLOP/s and the
   share of the bound;
2. ``bsrgan_x2`` serving: ``ServingEngine`` over ``serve_stdio`` (4
   requests of 256x256, f32 then bf16), a ``--batch 2`` watch ``--once``
   drain and a 250x190 frame; every reply must be ok at the right size and
   every generator forward must make exactly 69 RDB kernel calls. One frame
   is run again with the plain RDB to hold the whole model to it;
3. ``bsrgan_x2`` infer: ``cli.infer --half --batch 2`` on a directory;
4. ``bsrgantrans_x2`` serving: 4 stdio requests of 256x256 and one of
   250x190 (125x95 tokens, ragged tiles), f32 then bf16; every forward must
   make exactly 69 RDB and 2 flash kernel calls. One frame is run again
   with the plain attention to hold the transformer layers and the whole
   model to it;
5. ``bsrgantrans_x2`` infer: ``cli.infer --attn-chunk 1024 --attn-backend
   flash --half --batch 2`` on a directory;
6. the filter2d kernel (the BSRGAN chain's blur, 3xTF32 on the tensor
   cores) against ``filter2d_ref`` at the training shape (16, 320, 320, 3)
   with K = 25, on asymmetric kernels and on one plan's zero-padded
   kernels, and at ragged shapes with K = 1, 7, 25 and 31; CUDA-event
   times of the kernel, the plain version and a cuDNN grouped convolution
   at the training shape, beside the card's bounds (f32 on the CUDA cores,
   and as three TF32 products on the tensor cores), and on the plan's
   kernels beside the bound of their nonzero taps;
7. the RDB under autograd: ``rdb_apply``'s gradients against autograd
   through ``rdb_forward_ref`` at the training shape x (16, 72, 72, 64),
   f32 and bf16, and the time of one forward+backward;
8. training: ``cli.train.run_train`` on the ``bsrnet`` config unchanged
   (full-width ``bsrgan_x2``, batch 16, pre-crop 320, GT 144, bf16) over
   seeded synthetic frames, 2 epochs of 6 steps, then ``--resume auto``
   for a third; every forward must make 69 RDB kernel calls and every
   chain 2 filter2d kernel calls. Both checkpoints load as weights and
   ``cli.infer --use-ema`` serves a frame from one. One f32 step is run
   with the RDB kernel and again with ``rdb_forward_ref``, from the same
   state on one batch (the chain's, with the filter2d kernel, held to the
   plain chain's), to hold the step to the plain one
   (``train/step_check.py``: the LeakyReLU slopes its backward takes
   differently, and the updated G; see ``train_phase``).

Each path runs with the kernels' launch counts set to 0 just before it and
read just after.

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
PEAK_TF32_FLOPS = 495e12  # tensor cores; the f32 kernels take three TF32 products per pair
TF32_PRODUCTS = 3
PEAK_HBM_BYTES = 3.35e12
# exponentials: 16 per clock on each of the 132 SMs (the special-function
# units, Hopper architecture white paper) at the 1.98 GHz boost clock
PEAK_EXP_PER_S = 132 * 16 * 1.98e9
SERVE_SHAPE = (1, 256, 256, 64)  # x of every RDB for a 256x256 frame
CH, GC, NUM_RRDB = 64, 32, 23
RDB_PER_FORWARD = 3 * NUM_RRDB
# q of each bsrgantrans_x2 attention for a 256x256 frame: 128x128 tokens
FLASH_SHAPE = (1, 16384, 4, 16)
ATTN_CHUNK = 1024
ATTN_PER_FORWARD = 2


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def rdb_inputs(shape, seed: int, gc: int = GC):
    """x and kaiming-normal RDB weights (gain sqrt(2), no x0.1, so outputs
    are O(1) and a rounding slip shows), made on the CPU from a seed."""
    g = torch.Generator().manual_seed(seed)
    n, h, w, ch = shape
    x = torch.randn(shape, generator=g)
    kernels, biases = [], []
    for k in range(5):
        cin, cout = ch + k * gc, gc if k < 4 else ch
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
    """The RDB as five cuDNN convs over torch.cat in x's dtype (library
    yardstick; f32 runs in full f32 while cudnn.allow_tf32 is off)."""
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


def rdb_flops(shape, gc: int = GC) -> int:
    n, h, w, ch = shape
    return 2 * n * h * w * sum(9 * (ch + k * gc) * (gc if k < 4 else ch) for k in range(5))


def kernel_phase(rdb) -> dict:
    """rdb_forward vs rdb_forward_ref at the main paths' shapes and at the
    edges of the kernels' tiles (16x8 pixels, 16-channel bf16 and 8-channel
    f32 steps, cout tiles of 16), then times."""
    errs = {"float32": 0.0, "bfloat16": 0.0}
    # (shape, gc): the serving shapes, the training shape (72 rows: a
    # ragged last row tile), tiles ragged in both axes, ch = 24 / 40 (cin
    # 24, 40, 56, ...: a half-filled last 16-channel step) and gc 8 (couts
    # of 8 in a tile of 16)
    cases = [((2, 64, 64, CH), GC), ((1, 37, 53, CH), GC), (SERVE_SHAPE, GC), ((2, 256, 256, CH), GC),
             ((1, 250, 190, CH), GC), (TRAIN_RDB_SHAPE, GC), ((3, 17, 23, CH), GC),
             ((2, 37, 53, 24), 16), ((1, 20, 33, 40), 8), ((2, 19, 13, 24), 8)]
    for i, (shape, gc) in enumerate(cases):
        x, ks, bs = rdb_inputs(shape, seed=i, gc=gc)
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            got = rdb.rdb_forward(xd, ks, bs).float()
            torch.cuda.synchronize()
            want = rdb.rdb_forward_ref(xd, ks, bs).float()
            diff = (got - want).abs()
            max_err, mean_err = diff.max().item(), diff.mean().item()
            name = "float32" if dt == torch.float32 else "bfloat16"
            errs[name] = max(errs[name], max_err)
            print(f"rdb {shape} gc={gc} {dt}: max abs {max_err:.3g}, mean abs {mean_err:.3g}", flush=True)
            if dt == torch.float32:
                # same f32 operands, products split into three TF32 ones
                # (~2^-22 relative dropped), sums in another order; TF32 is
                # off for the plain version
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
        plain_f32_ms = cuda_ms(lambda: rdb.rdb_forward_ref(x, ks, bs))
        library_f32_ms = cuda_ms(cudnn_chain(x, ks, bs))
    # the training shape, and what its ragged last row tile costs: 72 rows
    # take 5 tiles of 16 where 64 rows take 4
    train = {}
    for shape in (TRAIN_RDB_SHAPE, (16, 64, 72, CH)):
        xt, kt, bt = rdb_inputs(shape, seed=101)
        xt = xt.to(torch.bfloat16)
        pt = rdb.pack_rdb_weights(kt, bt, torch.bfloat16)
        with torch.inference_mode():
            train[shape] = (cuda_ms(lambda: rdb.rdb_forward(xt, kt, bt, pt)), cuda_ms(cudnn_chain(xt, kt, bt)))
    train_ms, train_library_ms = train[TRAIN_RDB_SHAPE]
    ragged_ms = train_ms - train[(16, 64, 72, CH)][0] * 72 / 64
    n, h, w, ch = SERVE_SHAPE
    flops = rdb_flops(SERVE_SHAPE)
    # x read once, output written once, weights (bf16) and biases (f32) read once
    bytes_moved = 2 * (2 * n * h * w * ch) + 2 * packed_b[0].numel() + 4 * packed_b[1].numel()
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, bytes_moved / PEAK_HBM_BYTES * 1e3
    # the f32 path: f32 x, output, weights (HWIO, once) and biases; at the f32
    # rate of the CUDA cores, and as three TF32 products at the tensor cores'
    bytes_f32 = 4 * (2 * n * h * w * ch) + 4 * sum(k.numel() for k in ks) + 4 * packed_f[1].numel()
    bound_f32_ms = max(flops / PEAK_F32_FLOPS, bytes_f32 / PEAK_HBM_BYTES) * 1e3
    bound_tf32_ms = max(TF32_PRODUCTS * flops / PEAK_TF32_FLOPS, bytes_f32 / PEAK_HBM_BYTES) * 1e3
    bound = max(t_ops, t_bytes)
    print(
        f"rdb timing at x {SERVE_SHAPE} bf16: kernel {kernel_ms:.4f} ms (f32 {kernel_f32_ms:.4f}), "
        f"plain {plain_ms:.4f} ms, cuDNN bf16 chain {library_ms:.4f} ms, "
        f"bound {bound:.4f} ms ({flops:.3e} FLOP, {bytes_moved:.3e} B; "
        f"f32 bound {bound_f32_ms:.4f} ms); bf16 {flops / kernel_ms / 1e9:.1f} TFLOP/s, "
        f"{100 * bound / kernel_ms:.1f}% of its bound",
        flush=True,
    )
    print(
        f"rdb timing at x {SERVE_SHAPE} f32: kernel (3xTF32) {kernel_f32_ms:.4f} ms, plain "
        f"{plain_f32_ms:.4f} ms, cuDNN f32 chain (TF32 off) {library_f32_ms:.4f} ms; bound "
        f"{bound_tf32_ms:.4f} ms as {TF32_PRODUCTS} TF32 products on the tensor cores, "
        f"{bound_f32_ms:.4f} ms on the CUDA cores; {flops / kernel_f32_ms / 1e9:.1f} TFLOP/s of f32 "
        f"products, {100 * bound_tf32_ms / kernel_f32_ms:.1f}% of the lower bound",
        flush=True,
    )
    train_flops = rdb_flops(TRAIN_RDB_SHAPE)
    print(
        f"rdb timing at x {TRAIN_RDB_SHAPE} bf16: kernel {train_ms:.4f} ms "
        f"({train_flops / train_ms / 1e9:.1f} TFLOP/s, {100 * train_flops / PEAK_BF16_FLOPS * 1e3 / train_ms:.1f}% "
        f"of the operations bound), cuDNN bf16 chain {train_library_ms:.4f} ms; at (16, 64, 72, {CH}) "
        f"{train[(16, 64, 72, CH)][0]:.4f} ms, so the ragged last row tile costs {ragged_ms:.4f} ms",
        flush=True,
    )
    return {
        "name": "rdb_forward",
        "route": "cuda",
        "design": "bf16: tensor cores (implicit GEMM, mma.sync.m16n8k16 bf16->f32, ldmatrix from the "
                  "shifted halo window, cp.async double buffer); f32: the same GEMM as split-precision "
                  "3xTF32 (mma.sync.m16n8k8 tf32->f32, three products per fragment pair)",
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
        "bound_ms": bound,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_f32_ms": bound_f32_ms,
        "bound_f32_tf32_ms": bound_tf32_ms,
        "plain_f32_ms": plain_f32_ms,
        "library_f32_ms": library_f32_ms,
        "library_f32": "cuDNN 5-conv chain, f32, TF32 off",
        "tflops": flops / kernel_ms / 1e9,
        "share_of_bound": bound / kernel_ms,
        "tflops_f32": flops / kernel_f32_ms / 1e9,
        "share_of_bound_f32": min(bound_f32_ms, bound_tf32_ms) / kernel_f32_ms,
        "train_shape": list(TRAIN_RDB_SHAPE),
        "train_kernel_ms": train_ms,
        "train_library_ms": train_library_ms,
        "train_ragged_tile_ms": ragged_ms,
        "shape": list(SERVE_SHAPE),
        "dtype": "bfloat16",
    }


def flash_inputs(shape, seed: int, dtype=torch.float32):
    """q, k, v ~ N(0, 1) made on the CPU from a seed."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to("cuda", dtype) for _ in range(3)]


def sdpa_kernels(q, k, v) -> list[str]:
    """The CUDA kernels one ``scaled_dot_product_attention`` call launches
    on these inputs (torch.profiler): they name the backend it took."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v)
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA})


def flash_kernel_phase(attn) -> dict:
    """flash_attention vs flash_attention_ref at the main path's shapes
    (T = 16384 for 256x256 frames, 11875 for 250x190) and small ragged
    ones, D = 16 (bsrgantrans_x2) and 32, then times."""
    import torch.nn.functional as F

    errs = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(n, t, 4, d) for d in (16, 32) for t in (100, 333, 16384, 11875) for n in (1, 2)]
    # the edges of the kernels' tiles: 64 queries a block, 16 a warp, 64
    # keys a staged tile, 8 keys a P V k-step
    cases += [(2, t, 4, d) for d in (16, 32) for t in (1, 15, 17, 63, 65, 129)]
    for i, shape in enumerate(cases):
        q, k, v = flash_inputs(shape, seed=i)
        for dt in (torch.float32, torch.bfloat16):
            qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
            got = attn.flash_attention(qd, kd, vd).float()
            torch.cuda.synchronize()
            want = attn.flash_attention_ref(qd, kd, vd).float()
            diff = (got - want).abs()
            max_err = diff.max().item()
            name = "float32" if dt == torch.float32 else "bfloat16"
            errs[name] = max(errs[name], max_err)
            print(f"flash {shape} {dt}: max abs {max_err:.3g}, mean abs {diff.mean().item():.3g}", flush=True)
            if dt == torch.float32:
                # the same f32 math in another order (exp2 of scaled scores,
                # online rescaling), products split into three TF32 ones
                # (~2^-22 relative dropped); TF32 is off for the plain version
                check(torch.allclose(got, want, atol=1e-5, rtol=1e-5), f"f32 flash {shape}: {max_err}")
            else:
                # both round one f32 result to bf16: at most one bf16 ulp
                # apart, 2**-7 of the value
                check(bool((diff <= want.abs() * 2**-7 + 1e-5).all()), f"bf16 flash {shape}: {max_err}")

    # the kernel against the plain version run on the CPU (another order again)
    err_cpu = 0.0
    for shape in ((1, 333, 4, 16), (2, 100, 4, 32)):
        q, k, v = flash_inputs(shape, seed=50)
        got = attn.flash_attention(q, k, v).cpu()
        want = attn.flash_attention_ref(q.cpu(), k.cpu(), v.cpu())
        err_cpu = max(err_cpu, (got - want).abs().max().item())
    print(f"flash float32 vs plain version on the CPU: max abs {err_cpu:.3g}", flush=True)
    check(err_cpu <= 1e-5, f"f32 flash vs CPU plain version: {err_cpu}")

    q, k, v = flash_inputs(FLASH_SHAPE, seed=100)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    with torch.inference_mode():
        kernel_ms = cuda_ms(lambda: attn.flash_attention(qb, kb, vb))
        kernel_f32_ms = cuda_ms(lambda: attn.flash_attention(q, k, v))
        plain_ms = cuda_ms(lambda: attn.flash_attention_ref(qb, kb, vb, ATTN_CHUNK), iters=5, warmup=1)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qb.transpose(1, 2), kb.transpose(1, 2), vb.transpose(1, 2)))
        plain_f32_ms = cuda_ms(lambda: attn.flash_attention_ref(q, k, v, ATTN_CHUNK), iters=5, warmup=1)
        library_f32_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)))
    n, t, h, d = FLASH_SHAPE
    flops = 4 * n * h * t * t * d  # QK^T and PV
    exps = n * h * t * t
    bytes_moved = 4 * n * t * h * d * 2  # q, k, v read once, o written once, bf16
    t_mm, t_exp = flops / PEAK_BF16_FLOPS * 1e3, exps / PEAK_EXP_PER_S * 1e3
    t_bytes = bytes_moved / PEAK_HBM_BYTES * 1e3
    bound = max(t_mm, t_exp, t_bytes)
    bound_f32_ms = max(flops / PEAK_F32_FLOPS * 1e3, t_exp, 2 * bytes_moved / PEAK_HBM_BYTES * 1e3)
    bound_tf32_ms = max(TF32_PRODUCTS * flops / PEAK_TF32_FLOPS * 1e3, t_exp,
                        2 * bytes_moved / PEAK_HBM_BYTES * 1e3)
    print(
        f"flash timing at q {FLASH_SHAPE} bf16: kernel {kernel_ms:.4f} ms (f32 {kernel_f32_ms:.4f}), "
        f"plain {plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms, "
        f"bound {bound:.4f} ms (products {t_mm:.4f} ms for {flops:.3e} FLOP, exponentials "
        f"{t_exp:.4f} ms for {exps:.3e}, bytes {t_bytes:.4f} ms for {bytes_moved:.3e} B; "
        f"f32 bound {bound_f32_ms:.4f} ms); bf16 {flops / kernel_ms / 1e9:.1f} TFLOP/s of products, "
        f"{100 * bound / kernel_ms:.1f}% of its bound",
        flush=True,
    )
    print(
        f"flash timing at q {FLASH_SHAPE} f32: kernel (3xTF32) {kernel_f32_ms:.4f} ms, plain "
        f"{plain_f32_ms:.4f} ms, scaled_dot_product_attention f32 {library_f32_ms:.4f} ms; bound "
        f"{bound_tf32_ms:.4f} ms as {TF32_PRODUCTS} TF32 products on the tensor cores, {bound_f32_ms:.4f} "
        f"ms on the CUDA cores; {flops / kernel_f32_ms / 1e9:.1f} TFLOP/s of f32 products, "
        f"{100 * bound_tf32_ms / kernel_f32_ms:.1f}% of the lower bound",
        flush=True,
    )
    return {
        "name": "flash_attention",
        "route": "cuda",
        "design": "bf16: tensor cores (FlashAttention-2 style, mma.sync.m16n8k16 for QK^T and PV with P "
                  "split into bf16 hi + lo, ldmatrix(.trans), cp.async double buffer); f32: the same "
                  "blocks as split-precision 3xTF32 (mma.sync.m16n8k8 tf32->f32, three products per "
                  "fragment pair, S registers fed to P V with keys relabelled)",
        "source": "srganfd_tpu_torch/csrc/flash_attention.cu",
        "replaces": "srganfd_tpu/ops/pallas/attention.py:95",
        "max_abs_err": max(errs.values()),
        "max_abs_err_f32": errs["float32"],
        "max_abs_err_bf16": errs["bfloat16"],
        "max_abs_err_f32_vs_cpu": err_cpu,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "kernel_f32_ms": kernel_f32_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound,
        "bound_by": "operations" if max(t_mm, t_exp) >= t_bytes else "bytes",
        "bound_operation": "exponentials" if t_exp >= t_mm else "products",
        "bound_products_ms": t_mm,
        "bound_exponentials_ms": t_exp,
        "bound_bytes_ms": t_bytes,
        "bound_f32_ms": bound_f32_ms,
        "bound_f32_tf32_ms": bound_tf32_ms,
        "plain_f32_ms": plain_f32_ms,
        "library_f32_ms": library_f32_ms,
        "library_f32": "scaled_dot_product_attention, f32",
        "tflops": flops / kernel_ms / 1e9,
        "share_of_bound": bound / kernel_ms,
        "tflops_f32": flops / kernel_f32_ms / 1e9,
        "share_of_bound_f32": min(bound_f32_ms, bound_tf32_ms) / kernel_f32_ms,
        "shape": list(FLASH_SHAPE),
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


def serve_phase(work: str, rdb, blocks) -> tuple[int, dict, int]:
    """Full-width bsrgan_x2 serving; returns the RDB kernel calls it made,
    the generator's forward time on the card per dtype, and the calls of
    the f32 requests."""
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
        if not half:
            f32_launches = calls
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
            orig = blocks.rdb_apply
            blocks.rdb_apply = lambda xh, k, b, packed=None: rdb.rdb_forward_ref(xh, k, b)
            try:
                y_plain = engine.model(x)
            finally:
                blocks.rdb_apply = orig
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
    return launches, forward_ms, f32_launches


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


def spread_weights(work: str) -> str:
    """A bsrgantrans_x2 weights file from the seeded init with the seven
    convs outside the trunk scaled x6 and 0.5 on conv4's bias, so that
    frames come out spread over [0, 1] (the x0.1 init alone clamps every
    output to 0; x10 clamps a third of them) and a comparison of two runs
    means something. The trunk keeps its x0.1 init: at full gain 23 RRDBs
    would grow the signal ~1.35x each."""
    from srganfd_tpu_torch.models import create_model

    model = create_model("bsrgantrans_x2", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 4 and not name.startswith("trunk."):
                p.mul_(6)
        model.conv4.bias.add_(0.5)
    path = os.path.join(work, "bsrgantrans_x2_spread.pth")
    torch.save({"state_dict": model.state_dict()}, path)
    return path


def trans_serve_phase(work: str, weights: str, rdb, attn, blocks) -> tuple[dict, dict, dict, dict]:
    """Full-width bsrgantrans_x2 served over stdio with --attn-chunk 1024
    --attn-backend flash; returns the kernel calls it made, the generator's
    forward time and its two transformer layers' time on the card per
    dtype, and the kernel calls of the f32 requests."""
    from srganfd_tpu_torch.cli.serve import ServingEngine, serve_stdio
    from srganfd_tpu_torch.data.datasets import load_image_rgb

    frames = write_frames(os.path.join(work, "trans_lr"), 4, 256, 256, seed=4)
    frames += write_frames(os.path.join(work, "trans_odd"), 1, 250, 190, seed=5)
    launches, forward_ms, transformer_ms = {"rdb": 0, "flash": 0}, {}, {}
    for half in (False, True):
        tag = "bf16" if half else "f32"
        engine = ServingEngine("bsrgantrans_x2", weights=weights, half=half, attn_chunk=ATTN_CHUNK,
                               attn_backend="flash", device="cuda")
        reqs = [{"id": i, "input": p, "output": os.path.join(work, f"trans_sr_{tag}", f"{i}.png")}
                for i, p in enumerate(frames)]
        lines = [json.dumps(r) for r in reqs] + ['{"cmd": "stats"}', '{"cmd": "shutdown"}']
        out = io.StringIO()
        rdb.launches = attn.launches = 0
        t0 = time.perf_counter()
        serve_stdio(engine, inp=io.StringIO("\n".join(lines)), out=out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = {"rdb": rdb.launches, "flash": attn.launches}
        for key in launches:
            launches[key] += calls[key]
        if not half:
            f32_launches = calls
        replies = [json.loads(line) for line in out.getvalue().splitlines()]
        check(len(replies) == 6, f"trans {tag}: {len(replies)} replies")
        for r, want_hw in zip(replies[:5], [[512, 512]] * 4 + [[500, 380]]):
            check(r.get("ok") and r["out_hw"] == want_hw, f"trans {tag} reply {r}")
        check(calls == {"rdb": 5 * RDB_PER_FORWARD, "flash": 5 * ATTN_PER_FORWARD},
              f"trans {tag}: {calls} kernel calls for 5 forwards")
        print(f"serve stdio bsrgantrans_x2 {tag}: 4 x 256x256 + 250x190 in {wall:.2f} s, "
              f"per-frame ms {[r['ms'] for r in replies[:5]]}, stats {replies[5]}, per forward "
              f"{calls['rdb'] // 5} rdb_forward and {calls['flash'] // 5} flash_attention calls",
              flush=True)

        # the transformer layers and the whole model, flash kernel vs plain
        # attention, same weights, same frame
        model = engine.model
        x = torch.from_numpy(load_image_rgb(frames[0])[None]).cuda()
        captured = []
        hook = model.transformer.register_forward_hook(lambda m, i, o: captured.append((i[0], o)))
        with torch.inference_mode():
            y_kernel = model(x)
            orig = blocks.flash_attention
            blocks.flash_attention = lambda q, k, v: attn.flash_attention_ref(q, k, v, ATTN_CHUNK)
            try:
                y_plain = model(x)
            finally:
                blocks.flash_attention = orig
        hook.remove()
        (tokens, t_kernel), (_, t_plain) = captured
        t_err = (t_kernel.float() - t_plain.float()).abs()
        err = (y_kernel - y_plain).abs().max().item()
        mse = ((y_kernel - y_plain) ** 2).mean().item()
        psnr = 10 * math.log10(1.0 / mse) if mse > 0 else float("inf")
        print(f"bsrgantrans_x2 {tag}: kernel vs plain attention, transformer output max abs "
              f"{t_err.max().item():.3g} (mean {t_err.mean().item():.3g}, |tokens| <= "
              f"{t_plain.float().abs().max().item():.3g}); model max abs {err:.3g}, PSNR {psnr:.2f} dB; "
              f"output mean {y_kernel.mean().item():.4f}, std {y_kernel.std().item():.4f}", flush=True)
        check(torch.isfinite(y_kernel).all().item(), f"trans {tag}: non-finite output")
        check(y_kernel.std().item() > 0.05 and 0.05 < y_kernel.mean().item() < 0.95,
              f"trans {tag}: output clamped flat (mean {y_kernel.mean().item()}, std {y_kernel.std().item()})")
        if half:
            # one bf16 ulp in an attention output can move a post-LayerNorm
            # token by a few bf16 ulps (|tokens| < 8: 2**-5 each)
            check(t_err.max().item() <= 2**-3 and t_err.mean().item() <= 2**-8,
                  f"bf16 transformer: max {t_err.max().item()}, mean {t_err.mean().item()}")
            check(err <= 8 / 255 and psnr >= 45, f"bf16 trans model: max abs {err}, PSNR {psnr}")
        else:
            check(t_err.max().item() <= 1e-4, f"f32 transformer: max abs {t_err.max().item()}")
            check(err <= 1e-3, f"f32 trans model: max abs {err}")
        with torch.inference_mode():
            forward_ms[tag] = cuda_ms(lambda: model(x), iters=5, warmup=1)
            transformer_ms[tag] = cuda_ms(lambda: model.transformer(tokens), iters=5, warmup=1)
        print(f"bsrgantrans_x2 {tag}: one 256x256 forward on the card {forward_ms[tag]:.2f} ms, "
              f"its two transformer layers {transformer_ms[tag]:.2f} ms", flush=True)
        del engine, model
    return launches, forward_ms, transformer_ms, f32_launches


def trans_infer_phase(work: str, weights: str, rdb, attn) -> dict:
    import cv2

    from srganfd_tpu_torch.cli import infer

    frames_dir, out_dir = os.path.join(work, "trans_seq"), os.path.join(work, "trans_seq_sr")
    write_frames(frames_dir, 4, 256, 256, seed=6)
    rdb.launches = attn.launches = 0
    infer.main([
        "--model-arch", "bsrgantrans_x2", "--attn-chunk", str(ATTN_CHUNK), "--attn-backend", "flash",
        "--half", "--batch", "2", "--weights", weights,
        "--inputs-path", frames_dir, "--output-path", out_dir,
    ])
    torch.cuda.synchronize()
    calls = {"rdb": rdb.launches, "flash": attn.launches}
    outs = sorted(os.listdir(out_dir))
    check(len(outs) == 4, f"trans infer wrote {outs}")
    for name in outs:
        img = cv2.imread(os.path.join(out_dir, name))
        check(img is not None and img.shape == (512, 512, 3), f"trans infer {name}")
    check(calls == {"rdb": 2 * RDB_PER_FORWARD, "flash": 2 * ATTN_PER_FORWARD},
          f"trans infer: {calls} kernel calls for 2 forwards")
    return calls


# the bsrnet training step's shapes: a chain call per batch of 16 pre-crops
# of 320x320, two blurs of K = 25; the generator's RDBs on 72x72 LR crops
FILTER_SHAPE, FILTER_K = (16, 320, 320, 3), 25
TRAIN_RDB_SHAPE = (16, 72, 72, CH)
FILTERS_PER_CHAIN = 2
TRAIN_STEPS_PER_EPOCH, TRAIN_EPOCHS = 6, 2
TRAIN_FRAME = 360  # edge of the synthetic GT frames, above the 320 pre-crop


def asymmetric_kernels(n: int, k: int, seed: int) -> torch.Tensor:
    """Positive K x K kernels that sum to 1 with no symmetry, so that a
    flipped kernel (a convolution) shows; the chain's Gaussians would not."""
    g = torch.Generator().manual_seed(seed)
    ks = torch.rand((n, k, k), generator=g)
    return (ks / ks.sum(dim=(1, 2), keepdim=True)).cuda()


def filter2d_kernel_phase(f2d) -> dict:
    """filter2d vs filter2d_ref at the chain's shape and ragged ones, with
    K from 1 to 31 and the chain's own zero-padded kernels, then times at
    the chain's shape."""
    import torch.nn.functional as F

    from srganfd_tpu_torch.ops.degrade import plan_bsrgan_batch

    # the chain's kernels: one plan's first blurs, every size 7..25 centred
    # in a zero 25 x 25 frame
    plan_ks = torch.from_numpy(plan_bsrgan_batch(np.random.default_rng(220), FILTER_SHAPE[0], 2).kernels_a).cuda()
    cases = [(FILTER_SHAPE, FILTER_K, None), (FILTER_SHAPE, FILTER_K, plan_ks), ((3, 37, 53, 3), 1, None),
             ((3, 37, 53, 3), 7, None), ((3, 37, 53, 3), 25, None), ((3, 37, 53, 3), 31, None)]
    err = 0.0
    for i, (shape, k, ks) in enumerate(cases):
        x = torch.rand(shape, generator=torch.Generator().manual_seed(200 + i)).cuda()
        ks = asymmetric_kernels(shape[0], k, seed=300 + i) if ks is None else ks
        got = f2d.filter2d(x, ks)
        torch.cuda.synchronize()
        want = f2d.filter2d_ref(x, ks)
        e = (got - want).abs().max().item()
        err = max(err, e)
        print(f"filter2d {shape} K={k}{' (plan)' if i == 1 else ''} f32: max abs {e:.3g} "
              f"(|out| <= {want.abs().max().item():.3g})", flush=True)
        # the kernel takes each product as three TF32 ones (~2^-22 relative
        # dropped) and sums in another order; TF32 is off for the plain version
        check(e <= 1e-5, f"filter2d {shape} K={k}: max abs {e}")

    x = torch.rand(FILTER_SHAPE, generator=torch.Generator().manual_seed(210)).cuda()
    ks = asymmetric_kernels(FILTER_SHAPE[0], FILTER_K, seed=310)
    n, h, w, c = FILTER_SHAPE
    pad = FILTER_K // 2
    # the library yardstick: one cuDNN f32 grouped convolution over the
    # reflect-padded, batch-folded input (the literal form of the JAX
    # filter2d_depthwise), laid out beforehand
    xpad = F.pad(x.permute(0, 3, 1, 2).reshape(1, n * c, h, w), (pad,) * 4, mode="reflect")
    weight = ks.repeat_interleave(c, dim=0)[:, None].contiguous()
    with torch.inference_mode():
        kernel_ms = cuda_ms(lambda: f2d.filter2d(x, ks))
        plain_ms = cuda_ms(lambda: f2d.filter2d_ref(x, ks))
        library_ms = cuda_ms(lambda: F.conv2d(xpad, weight, groups=n * c))
    flops = 2 * n * h * w * c * FILTER_K * FILTER_K
    bytes_moved = 4 * (2 * n * h * w * c + n * FILTER_K * FILTER_K)  # images in, out, taps
    t_bytes = bytes_moved / PEAK_HBM_BYTES * 1e3
    # f32 products on the CUDA cores, or three TF32 products each on the
    # tensor cores, as the kernel takes them
    bound_f32_ms = max(flops / PEAK_F32_FLOPS * 1e3, t_bytes)
    bound_tf32_ms = max(TF32_PRODUCTS * flops / PEAK_TF32_FLOPS * 1e3, t_bytes)
    print(
        f"filter2d timing at {FILTER_SHAPE} K={FILTER_K} f32: kernel (3xTF32) {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, cuDNN grouped conv {library_ms:.4f} ms; bound {bound_tf32_ms:.4f} ms as "
        f"{TF32_PRODUCTS} TF32 products on the tensor cores, {bound_f32_ms:.4f} ms on the CUDA cores "
        f"({flops:.3e} FLOP, {bytes_moved:.3e} B: {t_bytes:.4f} ms); {flops / kernel_ms / 1e9:.1f} TFLOP/s "
        f"of f32 products, {100 * bound_tf32_ms / kernel_ms:.1f}% of the lower bound",
        flush=True,
    )
    # the chain's own kernels: the kernel skips their rows of zero taps, so
    # the bound counts the products of the nonzero taps of each
    with torch.inference_mode():
        plan_ms = cuda_ms(lambda: f2d.filter2d(x, plan_ks))
        plan_plain_ms = cuda_ms(lambda: f2d.filter2d_ref(x, plan_ks))
    plan_flops = 2 * h * w * c * int((plan_ks != 0).sum())
    plan_bound_ms = max(TF32_PRODUCTS * plan_flops / PEAK_TF32_FLOPS * 1e3, t_bytes)
    rows_live = (plan_ks != 0).any(-1).float().mean().item()
    print(
        f"filter2d timing at {FILTER_SHAPE} on one plan's kernels (sizes 7..25 zero-padded to 25: "
        f"{100 * plan_flops / flops:.1f}% of the taps, {100 * rows_live:.1f}% of the rows nonzero): kernel "
        f"{plan_ms:.4f} ms, plain {plan_plain_ms:.4f} ms; bound on the nonzero taps {plan_bound_ms:.4f} ms "
        f"as {TF32_PRODUCTS} TF32 products, {100 * plan_bound_ms / plan_ms:.1f}% of it",
        flush=True,
    )
    return {
        "name": "filter2d",
        "route": "cuda",
        "design": "f32: tensor cores, a banded GEMM per kernel row (A: staged input rows, B: the "
                  "Toeplitz band of the row's taps, 8 + K - 1 deep) as split-precision 3xTF32 "
                  "(mma.sync.m16n8k8 tf32->f32, three products per fragment pair); rows of zero "
                  "taps skipped",
        "source": "srganfd_tpu_torch/csrc/filter2d.cu",
        "replaces": "srganfd_tpu/ops/pallas/filter2d.py:54",
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_tf32_ms,
        "bound_by": "operations" if bound_tf32_ms > t_bytes else "bytes",
        "bound_f32_ms": bound_f32_ms,
        "bound_f32_tf32_ms": bound_tf32_ms,
        "tflops": flops / kernel_ms / 1e9,
        "share_of_bound": bound_tf32_ms / kernel_ms,
        "share_of_bound_f32": bound_f32_ms / kernel_ms,
        "plan_ms": plan_ms,
        "plan_plain_ms": plan_plain_ms,
        "plan_bound_ms": plan_bound_ms,
        "plan_nonzero_tap_share": plan_flops / flops,
        "plan_nonzero_row_share": rows_live,
        "shape": list(FILTER_SHAPE),
        "k": FILTER_K,
        "dtype": "float32",
    }


def rdb_grad_phase(rdb) -> dict:
    """rdb_apply (kernel forward, backward through the recomputed plain
    version) against plain autograd through rdb_forward_ref at the training
    shape; then one forward+backward timed."""
    out = {}
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x, ks, bs = rdb_inputs(TRAIN_RDB_SHAPE, seed=400)
        cot = torch.randn(TRAIN_RDB_SHAPE, generator=torch.Generator().manual_seed(401)).cuda().to(dt)
        leaves = [x.to(dt).requires_grad_(), *[t.requires_grad_() for t in ks + bs]]
        plain = [t.detach().clone().requires_grad_() for t in leaves]
        before = rdb.launches
        y = rdb.rdb_apply(leaves[0], leaves[1:6], leaves[6:])
        check(rdb.launches == before + 1, "rdb_apply did not launch the kernel")
        got = torch.autograd.grad(y, leaves, cot)
        want = torch.autograd.grad(rdb.rdb_forward_ref(plain[0], plain[1:6], plain[6:]), plain, cot)
        rel = max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
                  for g, w in zip(got, want))
        print(f"rdb_apply {TRAIN_RDB_SHAPE} {name}: gradients vs autograd through the plain "
              f"version, max relative {rel:.3g} (x, 5 kernels, 5 biases)", flush=True)
        # both pull the cotangent through the same recomputed plain forward;
        # only cuDNN's backward algorithms (their summation order) differ
        check(rel <= (1e-4 if dt == torch.float32 else 1e-2), f"{name} rdb_apply gradients: {rel}")
        out[f"grad_max_rel_err_{name}"] = rel

        def fwd_bwd():
            y = rdb.rdb_apply(leaves[0], leaves[1:6], leaves[6:])
            torch.autograd.grad(y, leaves, cot)

        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: rdb.rdb_apply(leaves[0], leaves[1:6], leaves[6:]), iters=10)
            # what the backward recomputes first
            plain_ms = cuda_ms(lambda: rdb.rdb_forward_ref(leaves[0], leaves[1:6], leaves[6:]), iters=10)
        out[f"train_fwd_ms_{name}"] = fwd_ms
        out[f"train_plain_fwd_ms_{name}"] = plain_ms
        out[f"train_fwd_bwd_ms_{name}"] = cuda_ms(fwd_bwd, iters=5, warmup=1)
        print(f"rdb_apply {TRAIN_RDB_SHAPE} {name}: forward (packing the weights, then the kernel) "
              f"{fwd_ms:.4f} ms, the plain forward "
              f"the backward recomputes {plain_ms:.4f} ms, forward+backward "
              f"{out[f'train_fwd_bwd_ms_{name}']:.4f} ms", flush=True)
    return out


def write_gt_frames(d: str, n: int, size: int, seed: int) -> None:
    """Smooth structure plus noise and a few sharp edges, so that blur and
    JPEG both change the frames."""
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    yy, xx = np.mgrid[0:size, 0:size] / size
    for i in range(n):
        f = rng.uniform(1, 6, 2)
        base = 0.5 + 0.25 * np.sin(2 * np.pi * (f[0] * xx + f[1] * yy + rng.uniform()))
        base += 0.15 * (((xx * 8 + yy * 3 + i) % 1.0) > 0.5)
        img = np.clip(base[..., None] + 0.05 * rng.standard_normal((size, size, 3)), 0, 1)
        cv2.imwrite(os.path.join(d, f"gt_{i:03d}.png"), (img * 255).astype(np.uint8))


def f32_step_vs_plain(cfg, host, rdb, f2d, blocks, filters) -> dict:
    """One full-width f32 bsrnet step from the seeded init, with the RDB
    kernel and then with rdb_forward_ref swapped in (a switch of this script
    only), on one batch: the chain's, with the filter2d kernel, whose LR is
    held to the plain chain's apart. The readings of
    ``train.step_check``: the chain's LR, the loss, the slope flips between
    the two backwards and the updated G outside and inside the flipped
    channels."""
    from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
    from srganfd_tpu_torch.train import step_check
    from srganfd_tpu_torch.train.loop import Trainer

    cfg = cfg.replace(compute_dtype="float32")
    orig = blocks.rdb_apply, filters.filter2d
    before = f2d.launches
    batch = DegradationAdapter(cfg, seed=cfg.seed, train=True, device="cuda")(host, 0)
    check(f2d.launches - before == FILTERS_PER_CHAIN, f"the f32 chain made {f2d.launches - before} filter2d calls")
    filters.filter2d = f2d.filter2d_ref
    try:
        plain_lr = DegradationAdapter(cfg, seed=cfg.seed, train=True, device="cuda")(host, 0)["lr"]
    finally:
        filters.filter2d = orig[1]
    runs = []
    try:
        for plain in (False, True):
            seen = []

            def recorded(x, k, b, packed=None, plain=plain):
                seen.append((x.detach().clone(), [t.detach().clone() for t in k], [t.detach().clone() for t in b]))
                return rdb.rdb_forward_ref(x, k, b) if plain else orig[0](x, k, b, packed)

            blocks.rdb_apply = recorded
            trainer = Trainer(cfg, steps_per_epoch=TRAIN_STEPS_PER_EPOCH, device="cuda")
            state = trainer.init_state()
            before = rdb.launches
            loss = trainer.train_step(state, batch["gt"], batch["lr"])["pixel_loss"].item()
            made = rdb.launches - before
            check(made == (0 if plain else RDB_PER_FORWARD), f"f32 step (plain={plain}) made {made} rdb calls")
            names = [n for n, m in state.g_model.named_modules() if isinstance(m, blocks.ResidualDenseBlock)]
            runs.append((loss, {k: v.detach().clone() for k, v in state.g_model.state_dict().items()}, seen))
            del trainer, state
    finally:
        blocks.rdb_apply = orig[0]
    (loss_k, g_k, rdbs_k), (loss_p, g_p, rdbs_p) = runs
    flips, channels = step_check.slope_flips(rdbs_k, rdbs_p)
    out = {"lr_max_abs": (batch["lr"] - plain_lr).abs().max().item(), "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
           "slope_flips": sum(flips), "rdbs_with_flips": sum(f > 0 for f in flips),
           "preactivations": RDB_PER_FORWARD * sum(z.numel() for z in step_check.rdb_preactivations(*rdbs_p[0])),
           **step_check.g_agreement(g_k, g_p, step_check.flipped_channels(names, channels))}
    print(f"f32 bsrnet step, kernels vs plain versions on one batch: chain LR (filter2d kernel vs plain) max "
          f"abs {out['lr_max_abs']:.3g}, loss {loss_k:.7f} vs {loss_p:.7f} (relative {out['loss_rel']:.3g}); "
          f"LeakyReLU slopes the backwards take differently: {out['slope_flips']} of {out['preactivations']}, "
          f"in {out['rdbs_with_flips']} of {RDB_PER_FORWARD} RDBs; updated G per tensor max relative "
          f"{out['g_outside']:.3g} outside the flipped channels ({out['g_outside_worst']}), "
          f"{out['g_inside']:.3g} inside ({out['g_inside_worst']}, {out['g_excluded_elements']} elements)",
          flush=True)
    return out


def train_phase(work: str, rdb, f2d, blocks, filters) -> tuple[dict, dict]:
    """Full-width bsrnet through cli.train.run_train: 2 epochs, then a
    resume for a third; returns the kernel calls it made and its numbers."""
    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli import infer
    from srganfd_tpu_torch.cli import train as cli_train
    from srganfd_tpu_torch.convert import load_generator_weights
    from srganfd_tpu_torch.data.datasets import BatchLoader
    from srganfd_tpu_torch.models import create_model
    from srganfd_tpu_torch.ops.degrade import apply_bsrgan_batch_cropped, bsrgan_lr_size, plan_bsrgan_batch
    from srganfd_tpu_torch.train import step_check
    from srganfd_tpu_torch.train.loop import Trainer
    from srganfd_tpu_torch.train.state import ema_update

    train_dir, valid_dir = os.path.join(work, "train_gt"), os.path.join(work, "valid_gt")
    write_gt_frames(train_dir, 24, TRAIN_FRAME, seed=10)
    write_gt_frames(valid_dir, 4, TRAIN_FRAME, seed=11)
    cfg = configs.get_config("bsrnet").replace(
        train_gt_images_dir=train_dir, valid_gt_images_dir=valid_dir,
        results_dir=os.path.join(work, "results"),
    )
    print(f"bsrnet: {cfg.g_arch} {cfg.g_kwargs or 'full width (64/32/23)'}, batch {cfg.batch_size}, "
          f"pre-crop {cfg.crop_image_size}, GT {cfg.gt_image_size}, {cfg.compute_dtype}, Adam eps "
          f"{cfg.model_eps}", flush=True)

    losses, steps = [], []  # steps: (step index, host clock at entry, at end)
    real_step = Trainer.train_step

    def recorded_step(self, state, gt, lr_img):
        entry = time.perf_counter()
        index = state.step
        metrics = real_step(self, state, gt, lr_img)
        losses.append(metrics["g_loss"].item())  # waits for the step
        steps.append((index, entry, time.perf_counter()))
        return metrics

    Trainer.train_step = recorded_step
    torch.cuda.reset_peak_memory_stats()
    rdb.launches = f2d.launches = 0
    try:
        run_s = []
        for epochs, resume in ((TRAIN_EPOCHS, ""), (TRAIN_EPOCHS + 1, "auto")):
            t0 = time.perf_counter()
            result = cli_train.run_train(cfg.replace(epochs=epochs), TRAIN_STEPS_PER_EPOCH,
                                         resume=resume, device="cuda")
            torch.cuda.synchronize()
            run_s.append(time.perf_counter() - t0)
    finally:
        Trainer.train_step = real_step
    calls = {"rdb": rdb.launches, "filter2d": f2d.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = TRAIN_STEPS_PER_EPOCH * (TRAIN_EPOCHS + 1)
    n_valid = TRAIN_EPOCHS + 1  # one batch of the 4 valid frames per epoch
    check(len(losses) == n_steps, f"{len(losses)} train steps, expected {n_steps}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    check(calls == {"rdb": RDB_PER_FORWARD * (n_steps + n_valid),
                    "filter2d": FILTERS_PER_CHAIN * (n_steps + n_valid)},
          f"training made {calls} kernel calls for {n_steps} steps and {n_valid} validation batches")
    state = result["state"]
    check(state.step == n_steps, f"resumed run ended at step {state.step}")

    init = create_model(cfg.g_arch, generator=torch.Generator().manual_seed(cfg.seed)).state_dict()
    g = {k: v.detach().cpu() for k, v in state.g_model.state_dict().items()}
    ema = {k: v.cpu() for k, v in state.ema_g.items()}
    g_moved = max((g[k] - init[k]).abs().max().item() for k in init)
    ema_moved = max((ema[k] - init[k]).abs().max().item() for k in init)
    g_vs_ema = max((g[k] - ema[k]).abs().max().item() for k in init)
    check(g_moved > 0 and ema_moved > 0 and g_vs_ema > 0,
          f"G moved {g_moved}, EMA-G moved {ema_moved}, G vs EMA-G {g_vs_ema}")
    ckpt_dir = os.path.join(cfg.results_dir, cfg.exp_name)
    for name in ("ckpt_last.pth", "ckpt_best.pth"):
        for use_ema in (False, True):
            sd = load_generator_weights(os.path.join(ckpt_dir, name), use_ema=use_ema)
            check(set(sd) == set(init), f"{name} (use_ema={use_ema}) holds other tensors")
    last_g = load_generator_weights(os.path.join(ckpt_dir, "ckpt_last.pth"))
    check(all(torch.equal(last_g[k], g[k]) for k in g), "ckpt_last.pth is not the final G")

    # host clock: the interval between the ends of consecutive steps of one
    # epoch (the loader, the plan, the chain and the step: the throughput),
    # and the time inside train_step (the step, and the chain queued before
    # it); the first step of the first run against the p50 of the others
    intervals = [(b[2] - a[2]) * 1e3 for a, b in zip(steps, steps[1:])
                 if b[0] == a[0] + 1 and b[0] % TRAIN_STEPS_PER_EPOCH]
    inside = [(end - entry) * 1e3 for _, entry, end in steps]
    step_p50 = float(np.median(intervals))
    first_excess = float(inside[0] - np.median(inside[1:]))
    print(f"bsrnet training: losses {[round(v, 5) for v in losses]}", flush=True)
    print(f"bsrnet training: {n_steps} steps + {n_valid} validation batches in "
          f"{[round(t, 2) for t in run_s]} s; step p50 {step_p50:.2f} ms host clock over "
          f"{len(intervals)} steps ({cfg.batch_size * 1e3 / step_p50:.2f} frames/s), inside "
          f"train_step p50 {np.median(inside[1:]):.2f} ms, the first step +{first_excess:.1f} ms; "
          f"peak memory {peak_gb:.2f} GB; {calls} kernel calls (per forward "
          f"{calls['rdb'] // (n_steps + n_valid)} rdb_forward, per chain "
          f"{calls['filter2d'] // (n_steps + n_valid)} filter2d)", flush=True)

    # where a step's time goes, on the card (CUDA events), on the trained state
    loader = BatchLoader(cli_train.build_datasets(cfg)[0], cfg.batch_size, seed=cfg.seed,
                         num_workers=2)
    it = iter(loader)
    host = next(it)
    it.close()
    gt_dev = torch.from_numpy(host["gt"]).cuda()
    plan = plan_bsrgan_batch(np.random.default_rng(0), cfg.batch_size, cfg.upscale_factor)
    lim = bsrgan_lr_size(gt_dev.shape[1], plan) - cfg.gt_image_size // cfg.upscale_factor
    tops = np.random.default_rng(1).integers(0, lim + 1, cfg.batch_size)
    chain = lambda: apply_bsrgan_batch_cropped(gt_dev, plan, tops, tops, cfg.gt_image_size,
                                               cfg.upscale_factor)
    gt_c, lr_c = chain()
    model = state.g_model

    def fwd_bwd():
        loss = (model(lr_c) - gt_c).abs().mean()
        loss.backward()

    breakdown = {
        "chain_ms": cuda_ms(chain, iters=5, warmup=1),
        "forward_ms": cuda_ms(lambda: model(lr_c), iters=5, warmup=1),
        "forward_backward_ms": cuda_ms(fwd_bwd, iters=3, warmup=1),
    }
    trainer = Trainer(cfg, TRAIN_STEPS_PER_EPOCH, device="cuda")
    # each step's update bumps the parameters, so the next forward repacks
    # every RDB's weights: count the packs by dtype, and time the pieces
    # that the step adds to forward+backward
    packs, real_pack = {}, blocks.pack_rdb_weights

    def counted_pack(kernels, biases, dtype):
        packs[str(dtype)] = packs.get(str(dtype), 0) + 1
        return real_pack(kernels, biases, dtype)

    blocks.pack_rdb_weights = counted_pack
    try:
        breakdown["train_step_ms"] = cuda_ms(lambda: real_step(trainer, state, gt_c, lr_c), iters=3, warmup=1)
    finally:
        blocks.pack_rdb_weights = real_pack
    check(set(packs) == {str(trainer.dtype)}, f"4 {trainer.dtype} steps packed {packs}")
    rdbs = [m for m in model.modules() if isinstance(m, blocks.ResidualDenseBlock)]
    with torch.no_grad():
        breakdown["repack_ms"] = cuda_ms(
            lambda: [real_pack(*m.kernels_biases(), trainer.dtype) for m in rdbs], iters=3, warmup=1)
        breakdown["adam_ms"] = cuda_ms(state.g_opt.step, iters=3, warmup=1)
        params = dict(model.named_parameters())
        breakdown["ema_ms"] = cuda_ms(lambda: ema_update(state.ema_g, params, cfg.model_ema_decay), iters=3,
                                      warmup=1)
    print(f"bsrnet step breakdown on the card (CUDA events, {cfg.compute_dtype}, batch "
          f"{cfg.batch_size}): chain "
          f"{breakdown['chain_ms']:.2f} ms, generator forward {breakdown['forward_ms']:.2f} ms, "
          f"forward+backward {breakdown['forward_backward_ms']:.2f} ms, whole train step "
          f"(forward, backward, Adam, EMA) {breakdown['train_step_ms']:.2f} ms; of what the step adds: "
          f"repacking {len(rdbs)} RDBs' weights {breakdown['repack_ms']:.2f} ms, Adam "
          f"{breakdown['adam_ms']:.2f} ms, EMA {breakdown['ema_ms']:.2f} ms; packs in 4 steps {packs}",
          flush=True)
    del model, state, result, trainer

    # One f32 step held to the plain one (train/step_check.py's LIMITS): the
    # chain's LR and the loss to 1e-5; both steps take the kernel chain's
    # batch, so they differ only in the RDB forward. A forward that does not
    # round as cuDNN does makes the backward take a few dozen LeakyReLU
    # slopes differently (20-44 for the kernels and for an exactly summed
    # forward, ~1400 for one TF32 product; held to 250), and one flip moves
    # a zero-started bias's update by up to ~2.4e-4 of itself: G is held to
    # 1e-3, above every correct reading, for a gradient lost or misrouted.
    # G to 1e-5 outside the flipped channels (CHANNEL_RULE) is printed, not
    # held: flips after the trunk reach every trunk bias, and no excluded
    # set passes every correct reading and fails a planted 1e-4 fault
    # (f32_step_study.py, PERF.md section 6).
    f32 = f32_step_vs_plain(cfg, host, rdb, f2d, blocks, filters)
    failed = step_check.step_check_failures(f32, step_check.LIMITS)
    check(not failed, f"f32 step vs plain: {failed}")
    f32["channel_rule_failures"] = step_check.step_check_failures(f32, step_check.CHANNEL_RULE)
    print(f"f32 step, G to 1e-5 outside the flipped channels (not held): "
          f"{f32['channel_rule_failures'] or 'passes'}", flush=True)

    out_png = os.path.join(work, "train_sr.png")
    rdb.launches = 0
    infer.main(["--model-arch", cfg.g_arch, "--weights", os.path.join(ckpt_dir, "ckpt_best.pth"),
                "--use-ema", "--inputs-path", os.path.join(valid_dir, "gt_000.png"),
                "--output-path", out_png])
    import cv2

    img = cv2.imread(out_png)
    want = (2 * TRAIN_FRAME, 2 * TRAIN_FRAME, 3)
    check(img is not None and img.shape == want, f"infer of the trained EMA-G: {img is None or img.shape}")
    check(rdb.launches == RDB_PER_FORWARD, f"infer of the trained EMA-G: {rdb.launches} rdb calls")
    print(f"cli.infer --use-ema on ckpt_best.pth: {TRAIN_FRAME}x{TRAIN_FRAME} -> "
          f"{img.shape[1]}x{img.shape[0]}", flush=True)
    numbers = {
        "steps": n_steps, "validation_batches": n_valid, "losses": losses,
        "step_ms_p50": step_p50, "inside_step_ms_p50": float(np.median(inside[1:])),
        "frames_per_s": cfg.batch_size * 1e3 / step_p50, "first_step_excess_ms": first_excess,
        "peak_memory_gb": peak_gb, "run_s": run_s, **breakdown, "f32_step_vs_plain": f32,
    }
    return calls, numbers


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, ROOT)
    from srganfd_tpu_torch.models import blocks
    from srganfd_tpu_torch.ops import filters
    from srganfd_tpu_torch.ops.cuda import attention as attn
    from srganfd_tpu_torch.ops.cuda import build, rdb
    from srganfd_tpu_torch.ops.cuda import filter2d as f2d

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
    flash_entry = flash_kernel_phase(attn)
    filter_entry = filter2d_kernel_phase(f2d)
    entry.update(rdb_grad_phase(rdb))
    base = os.path.join(ROOT, "build")
    os.makedirs(base, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=base) as work:
        launches, forward_ms, f32_launches = serve_phase(work, rdb, blocks)
        launches += infer_phase(work, rdb)
        weights = spread_weights(work)
        trans_launches, trans_forward_ms, transformer_ms, trans_f32 = trans_serve_phase(
            work, weights, rdb, attn, blocks)
        trans_infer = trans_infer_phase(work, weights, rdb, attn)
        train_launches, train = train_phase(work, rdb, f2d, blocks, filters)
    launches += trans_launches["rdb"] + trans_infer["rdb"] + train_launches["rdb"]
    flash_launches = trans_launches["flash"] + trans_infer["flash"]
    check(launches > 0, "the main paths launched no rdb_forward kernel")
    check(flash_launches > 0, "the bsrgantrans_x2 path launched no flash_attention kernel")
    entry["launches"] = launches
    # of which f32 (the 3xTF32 kernels): the f32 stdio requests
    entry["launches_f32"] = f32_launches + trans_f32["rdb"]
    entry["launches_per_forward"] = RDB_PER_FORWARD
    entry["forward_ms"] = forward_ms  # bsrgan_x2 at 256x256, whole generator
    flash_entry["launches"] = flash_launches
    flash_entry["launches_f32"] = trans_f32["flash"]
    flash_entry["launches_per_forward"] = ATTN_PER_FORWARD
    flash_entry["forward_ms"] = trans_forward_ms  # bsrgantrans_x2 at 256x256, whole generator
    flash_entry["transformer_ms"] = transformer_ms  # its two encoder layers
    check(train_launches["filter2d"] > 0, "the training path launched no filter2d kernel")
    entry["train_launches"] = train_launches["rdb"]
    filter_entry["launches"] = train_launches["filter2d"]
    filter_entry["launches_per_chain"] = FILTERS_PER_CHAIN
    filter_entry["chain_ms"] = train["chain_ms"]  # the whole chain of one bsrnet step
    print(f"bsrgan_x2 256x256 forward: f32 {forward_ms['f32']:.2f} ms, bf16 {forward_ms['bf16']:.2f} ms; "
          f"69 RDB kernels alone: f32 {RDB_PER_FORWARD * entry['kernel_f32_ms']:.2f} ms, "
          f"bf16 {RDB_PER_FORWARD * entry['kernel_ms']:.2f} ms", flush=True)
    print(f"f32 kernel launches on the main paths: rdb_forward {entry['launches_f32']} of "
          f"{launches}, flash_attention {flash_entry['launches_f32']} of {flash_launches}", flush=True)
    for tag, key in (("f32", "kernel_f32_ms"), ("bf16", "kernel_ms")):
        print(f"bsrgantrans_x2 256x256 forward {tag}: {trans_forward_ms[tag]:.2f} ms; 69 RDB kernels "
              f"{RDB_PER_FORWARD * entry[key]:.2f} ms, 2 flash kernels "
              f"{ATTN_PER_FORWARD * flash_entry[key]:.2f} ms, 2 transformer layers "
              f"{transformer_ms[tag]:.2f} ms", flush=True)
    print(f"bsrnet step (bf16, batch 16): {train['train_step_ms']:.2f} ms on the card, of which the "
          f"forward {train['forward_ms']:.2f} ms (69 RDB kernels at {TRAIN_RDB_SHAPE} alone "
          f"{RDB_PER_FORWARD * entry['train_kernel_ms']:.2f} ms) and forward+backward "
          f"{train['forward_backward_ms']:.2f} ms; the chain {train['chain_ms']:.2f} ms (2 filter2d "
          f"kernels {FILTERS_PER_CHAIN * filter_entry['ms']:.2f} ms); host-clock step p50 "
          f"{train['step_ms_p50']:.2f} ms", flush=True)
    # last, so that no timed phase runs after a profiler session
    q, k, v = (t.transpose(1, 2) for t in flash_inputs(FLASH_SHAPE, seed=100))
    flash_entry["library_f32_kernels"] = sdpa_kernels(q, k, v)
    print(f"scaled_dot_product_attention f32 at q {FLASH_SHAPE} launches {flash_entry['library_f32_kernels']}",
          flush=True)
    print(json.dumps({"train": {k: v for k, v in train.items() if k != "losses"}}))
    print(smi)
    print(json.dumps({"kernels": [entry, flash_entry, filter_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
