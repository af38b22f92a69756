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
--attn-backend flash``), and the Real-ESRGAN generators ``realesrgan_x4``
and ``realesrgan_x2`` (a pixel-unshuffle front, the same trunk, two x2
upsamples), and trains three recipes at full width: ``bsrgan_x2``, the L1
pretrain (``bsrnet``) and then the GAN stage (``bsrgan``);
``realesrgan_x4``, ``realesrnet`` and then ``realesrgan``; and
``bsrgantrans_x2`` against the attention-gated U-Net (``aesrgan``):

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
   kernels, at ragged shapes with K = 1, 7, 25 and 31, and at shapes
   whose sides are at or below the reflect pad (K // 2 >= H or W, down to
   one pixel), where the reflection folds again as ``jnp.pad`` folds it;
   CUDA-event
   times of the kernel, the plain version and a cuDNN grouped convolution
   at the training shape, beside the card's bounds (f32 on the CUDA cores,
   and as three TF32 products on the tensor cores), on the plan's
   kernels beside the bound of their nonzero taps, and at (48, 8, 8, 3)
   with K = 21, below the pad;
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
   differently, and the updated G; see ``train_phase``);
9. GAN training: ``cli.train.run_train`` on the ``bsrgan`` config unchanged
   (full-width ``bsrgan_x2`` against ``discriminator_unet`` at c = 64,
   batch 16, pre-crop 320, GT 144, bf16, L1 x 20 + VGG19 content over five
   nodes + BCE x 0.5, LPIPS selection, on the seeded VGG19 and LPIPS
   surrogates) on the training phase's frames: one epoch of 4 steps, then
   ``--resume auto`` for a second. Losses finite, D probabilities in
   (0, 1), 69 RDB and 2 filter2d kernel calls per step and validation
   batch, the resumed run at step 4 with D's ``u`` and both Adams as the
   checkpoint held them, finite validation LPIPS and ``ckpt_best.pth`` at
   the epoch of the lowest. CUDA-event times of one step and its parts (G
   forward+backward, the D update, the content and adversarial terms'
   forward+backward), the chain and a validation with LPIPS. One f32 GAN
   step with the RDB kernel is held to the same step with
   ``rdb_forward_ref``, from the bsrnet-trained G and this phase's D
   (loss parts to 1e-5, D to 1e-3, ``u`` to 1e-3 as a sanity check, G by
   ``step_check.LIMITS``; see ``gan_train_phase``); the same step from the
   seeded init, also with the adversarial term and then the content loss
   off, is printed;
10. the Real-ESRGAN kernel shapes: the RDB kernel at x (48, 64, 64, 64)
    (held in f32 and bf16, timed in bf16 beside its bound, the plain
    version and the cuDNN chain) and filter2d with K = 21 on one batch's
    k1 (mixed Gaussians) and on sinc kernels (negative taps) at (48, 256,
    256, 3), and on the final sincs at (48, 64, 64, 3), each held to
    ``filter2d_ref`` and timed beside its bounds and the cuDNN grouped conv;
11. ``realesrgan_x4`` serving over stdio (4 requests of 128x128, f32 then
    bf16), ``realesrgan_x2`` (one 250x190 request), each on weights whose
    output is spread over [0, 1] and held to itself with the plain RDB
    (69 RDB kernel calls a forward), and ``cli.infer`` of 2 frames;
12. Real-ESRGAN training: ``cli.train.run_train`` on ``realesrnet`` and
    then ``realesrgan``, the configs unchanged (``realesrgan_x4``
    64/32/23, batch 48, GT 256, x4, bf16; for the GAN
    ``discriminator_unet`` c = 64, VGG19 content over five nodes against
    the USM-sharpened GT, BCE x 0.1, the G step first, LPIPS selection)
    on 48 synthetic 288x288 frames: one epoch of 3 steps, then ``--resume
    auto`` for a second; 69 RDB kernel calls per forward and 2-3 filter2d
    calls per chain (the count the plans' second-blur draws give), the
    resumed run at step 3 with its Adams (and D's ``u``) as the
    checkpoint held them, ``ckpt_best`` at the best validation PSNR or
    LPIPS; CUDA-event times of a step and its parts (the chain with USM's
    and filter2d's shares, G forward+backward, the D update, the content
    and adversarial terms), peak memory;
13. one f32 ``realesrgan`` step with the kernels held to the same step
    with their plain versions on one batch of 48 (the kernel chain's, its
    LR held to the plain chain's with one noise generator state: max 0.05,
    the DiffJPEG envelope, mean 1e-4, under 1% of its elements off a
    level; the same chain without noise and JPEG to one 8-bit level),
    from the realesrnet-trained G and the realesrgan-trained D
    (``step_check``'s LIMITS, loss parts 1e-5, D and ``u`` 1e-3; the
    updated G held on the same step with the content loss off, whose
    VGG gradient amplifies the forward's rounding; the step with the
    adversarial weight 0 printed);
14. A-ESRGAN training: ``cli.train.run_train`` on ``aesrgan``, the config
    unchanged (``bsrgantrans_x2`` 64/32/23 with its transformer
    bottleneck at full attention against ``uNetDiscriminatorAesrgan``
    with 64 features, batch 8, pre-crop 150, GT 120, bf16, VGG19 content
    over five nodes, BCE x 0.1, the D step first, LPIPS selection) on the
    bsrnet phase's frames: one epoch of 4 steps, then ``--resume auto``
    for a second; 69 RDB kernel calls per forward and 2 filter2d calls
    per chain, the resumed D (its ``u`` and BatchNorm running statistics)
    and both Adams as the checkpoint held them; CUDA-event times of a step
    and its parts, peak memory; the RDB kernel timed at x (8, 60, 60, 64)
    in the kernel phase; one step of ``--d-arch
    discriminator_attention_unet_ms`` at GT 128 (its two scales need
    sides of 16k); one f32 step held to its plain twin from the trained
    state (``step_check``'s LIMITS, loss parts 1e-5, D and ``u`` 1e-3, the
    gates' running statistics 1e-5; the biases before BatchNorm, which
    have no gradient, printed);
    ``cli.infer --use-ema`` on ``ckpt_best.pth``.

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
# the Real-ESRGAN configs' shapes: batches of 48 GT crops of 256 at x4; the
# chain's blurs are K = 21 (k1 on the GT, k2 at the first resize's size,
# the sinc on the final 64x64); the generator's RDBs run on 64x64 LR crops
RE_BATCH, RE_GT, RE_K = 48, 256, 21
RE_RDB_SHAPE = (RE_BATCH, 64, 64, CH)
RE_FILTER_SHAPE, RE_FINAL_SHAPE = (RE_BATCH, RE_GT, RE_GT, 3), (RE_BATCH, 64, 64, 3)
RE_SERVE = 128  # realesrgan_x4 request edge: 512x512 out
RE_STEPS_PER_EPOCH, RE_EPOCHS = 3, 1  # then --resume auto for one more epoch
RE_FRAME = 288  # edge of the synthetic GT frames, above the 256 crop
# the aesrgan config's shapes: batches of 8 pre-crops of 150, GT 120 at x2;
# the generator's RDBs on 60x60 LR crops, its bottleneck on 30x30 tokens
AE_RDB_SHAPE = (8, 60, 60, CH)
AE_STEPS_PER_EPOCH, AE_EPOCHS = 4, 1  # then --resume auto for one more epoch
AE_MS_GT = 128  # the ensemble's two scales need GT sides of 16k; the config's 120 is not one


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
             ((1, 250, 190, CH), GC), (TRAIN_RDB_SHAPE, GC), (RE_RDB_SHAPE, GC), (AE_RDB_SHAPE, GC),
             ((3, 17, 23, CH), GC),
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
    # the Real-ESRGAN training shape: bf16 kernel, plain version, cuDNN chain
    xr, kr, br = rdb_inputs(RE_RDB_SHAPE, seed=102)
    xr = xr.to(torch.bfloat16)
    pr = rdb.pack_rdb_weights(kr, br, torch.bfloat16)
    with torch.inference_mode():
        re_ms = cuda_ms(lambda: rdb.rdb_forward(xr, kr, br, pr))
        re_plain_ms = cuda_ms(lambda: rdb.rdb_forward_ref(xr, kr, br))
        re_library_ms = cuda_ms(cudnn_chain(xr, kr, br))
    re_flops = rdb_flops(RE_RDB_SHAPE)
    re_bytes = 2 * 2 * xr.numel() + 2 * pr[0].numel() + 4 * pr[1].numel()
    re_bound = max(re_flops / PEAK_BF16_FLOPS, re_bytes / PEAK_HBM_BYTES) * 1e3
    print(
        f"rdb timing at x {RE_RDB_SHAPE} bf16 (realesrgan training): kernel {re_ms:.4f} ms, plain "
        f"{re_plain_ms:.4f} ms, cuDNN bf16 chain {re_library_ms:.4f} ms; bound {re_bound:.4f} ms "
        f"({re_flops:.3e} FLOP, operations), {100 * re_bound / re_ms:.1f}% of it",
        flush=True,
    )
    # the aesrgan training shape, the same numbers
    xa, ka, ba = rdb_inputs(AE_RDB_SHAPE, seed=103)
    xa = xa.to(torch.bfloat16)
    pa = rdb.pack_rdb_weights(ka, ba, torch.bfloat16)
    with torch.inference_mode():
        ae_ms = cuda_ms(lambda: rdb.rdb_forward(xa, ka, ba, pa))
        ae_plain_ms = cuda_ms(lambda: rdb.rdb_forward_ref(xa, ka, ba))
        ae_library_ms = cuda_ms(cudnn_chain(xa, ka, ba))
    ae_flops = rdb_flops(AE_RDB_SHAPE)
    ae_bytes = 2 * 2 * xa.numel() + 2 * pa[0].numel() + 4 * pa[1].numel()
    ae_bound = max(ae_flops / PEAK_BF16_FLOPS, ae_bytes / PEAK_HBM_BYTES) * 1e3
    print(
        f"rdb timing at x {AE_RDB_SHAPE} bf16 (aesrgan training): kernel {ae_ms:.4f} ms, plain "
        f"{ae_plain_ms:.4f} ms, cuDNN bf16 chain {ae_library_ms:.4f} ms; bound {ae_bound:.4f} ms "
        f"({ae_flops:.3e} FLOP, {'operations' if ae_flops / PEAK_BF16_FLOPS >= ae_bytes / PEAK_HBM_BYTES else 'bytes'}), "
        f"{100 * ae_bound / ae_ms:.1f}% of it",
        flush=True,
    )
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
        "realesrgan_train_shape": list(RE_RDB_SHAPE),
        "realesrgan_train_kernel_ms": re_ms,
        "realesrgan_train_plain_ms": re_plain_ms,
        "realesrgan_train_library_ms": re_library_ms,
        "realesrgan_train_bound_ms": re_bound,
        "aesrgan_train_shape": list(AE_RDB_SHAPE),
        "aesrgan_train_kernel_ms": ae_ms,
        "aesrgan_train_plain_ms": ae_plain_ms,
        "aesrgan_train_library_ms": ae_library_ms,
        "aesrgan_train_bound_ms": ae_bound,
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
        hold_model_to_plain(engine.model, x, tag, "bsrgan_x2", rdb, blocks)
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


def spread_weights(work: str, arch: str = "bsrgantrans_x2", gain: float = 6.0) -> str:
    """A weights file of ``arch`` from the seeded init with the convs
    outside the trunk scaled by ``gain`` and 0.5 on conv4's bias, so that
    frames come out spread over [0, 1] (the x0.1 init alone clamps every
    output to 0; x10 clamps a third of bsrgantrans_x2's; the realesrgan
    archs take x4: on a 32x32 CPU frame output std 0.19, 8-16% clamped,
    where x6 clamps 64-70%) and a comparison of two runs means something.
    The trunk keeps its x0.1 init: at full gain 23 RRDBs would grow the
    signal ~1.35x each."""
    from srganfd_tpu_torch.models import create_model

    model = create_model(arch, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 4 and not name.startswith("trunk."):
                p.mul_(gain)
        model.conv4.bias.add_(0.5)
    path = os.path.join(work, f"{arch}_spread.pth")
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


def hold_model_to_plain(model, x, tag: str, label: str, rdb, blocks) -> torch.Tensor:
    """The whole model with the RDB kernel against itself with
    rdb_forward_ref swapped in, same weights, same frame: f32 max abs 1e-3;
    bf16 max abs 8/255 and PSNR 45 dB. Returns the kernel run's output."""
    with torch.inference_mode():
        y_kernel = model(x)
        orig = blocks.rdb_apply
        blocks.rdb_apply = lambda xh, k, b, packed=None: rdb.rdb_forward_ref(xh, k, b)
        try:
            y_plain = model(x)
        finally:
            blocks.rdb_apply = orig
    err = (y_kernel - y_plain).abs().max().item()
    mse = ((y_kernel - y_plain) ** 2).mean().item()
    psnr = 10 * math.log10(1.0 / mse) if mse > 0 else float("inf")
    print(f"{label} {tag}: kernel vs plain RDB max abs {err:.3g}, PSNR {psnr:.2f} dB; output mean "
          f"{y_kernel.mean().item():.4f}, std {y_kernel.std().item():.4f}", flush=True)
    check(torch.isfinite(y_kernel).all().item(), f"{label} {tag}: non-finite output")
    if tag == "bf16":
        check(err <= 8 / 255 and psnr >= 45, f"bf16 {label}: max abs {err}, PSNR {psnr}")
    else:
        check(err <= 1e-3, f"f32 {label}: max abs {err}")
    return y_kernel


def re_serve_phase(work: str, rdb, blocks) -> tuple[int, dict, int]:
    """Full-width realesrgan_x4 served over stdio (4 requests of 128x128,
    f32 then bf16) and realesrgan_x2 (one 250x190 request: 125x95 after the
    unshuffle; f32), on spread weights, each model held to itself with the
    plain RDB; then cli.infer of realesrgan_x4 on 2 frames. Returns the RDB
    kernel calls, the forward ms by arch and dtype, and the f32 calls."""
    import cv2

    from srganfd_tpu_torch.cli import infer
    from srganfd_tpu_torch.cli.serve import ServingEngine, serve_stdio
    from srganfd_tpu_torch.data.datasets import load_image_rgb

    frames = write_frames(os.path.join(work, "re_lr"), 4, RE_SERVE, RE_SERVE, seed=7)
    odd = write_frames(os.path.join(work, "re_odd"), 1, 250, 190, seed=8)
    weights = {arch: spread_weights(work, arch, gain=4.0) for arch in ("realesrgan_x4", "realesrgan_x2")}
    launches, f32_launches, forward_ms = 0, 0, {}
    for arch, half, inputs, out_hw in (("realesrgan_x4", False, frames, [4 * RE_SERVE] * 2),
                                       ("realesrgan_x4", True, frames, [4 * RE_SERVE] * 2),
                                       ("realesrgan_x2", False, odd, [500, 380])):
        tag = "bf16" if half else "f32"
        engine = ServingEngine(arch, weights=weights[arch], half=half, device="cuda")
        reqs = [{"id": i, "input": p, "output": os.path.join(work, f"re_sr_{arch}_{tag}", f"{i}.png")}
                for i, p in enumerate(inputs)]
        lines = [json.dumps(r) for r in reqs] + ['{"cmd": "stats"}', '{"cmd": "shutdown"}']
        out = io.StringIO()
        rdb.launches = 0
        t0 = time.perf_counter()
        serve_stdio(engine, inp=io.StringIO("\n".join(lines)), out=out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = rdb.launches
        launches += calls
        f32_launches += 0 if half else calls
        replies = [json.loads(line) for line in out.getvalue().splitlines()]
        check(len(replies) == len(inputs) + 1, f"{arch} {tag}: {len(replies)} replies")
        for r in replies[:-1]:
            check(r.get("ok") and r["out_hw"] == out_hw, f"{arch} {tag} reply {r}")
        check(calls == len(inputs) * RDB_PER_FORWARD, f"{arch} {tag}: {calls} rdb_forward calls for "
              f"{len(inputs)} forwards")
        print(f"serve stdio {arch} {tag}: {len(inputs)} x {replies[0]['in_hw']} -> {out_hw} in {wall:.2f} s, "
              f"per-frame ms {[r['ms'] for r in replies[:-1]]}, stats {replies[-1]}, "
              f"{calls // len(inputs)} rdb_forward calls per forward", flush=True)
        x = torch.from_numpy(load_image_rgb(inputs[0])[None]).cuda()
        y = hold_model_to_plain(engine.model, x, tag, arch, rdb, blocks)
        mean, std = y.mean().item(), y.std().item()
        check(std > 0.05 and 0.05 < mean < 0.95, f"{arch} {tag}: output clamped flat (mean {mean}, std {std})")
        with torch.inference_mode():
            forward_ms[f"{arch} {tag}"] = cuda_ms(lambda: engine.model(x), iters=5, warmup=1)
        print(f"{arch} {tag}: one {tuple(x.shape[1:3])} forward on the card {forward_ms[f'{arch} {tag}']:.2f} ms",
              flush=True)
        del engine

    frames_dir, out_dir = os.path.join(work, "re_seq"), os.path.join(work, "re_seq_sr")
    write_frames(frames_dir, 2, RE_SERVE, RE_SERVE, seed=9)
    rdb.launches = 0
    infer.main(["--model-arch", "realesrgan_x4", "--half", "--batch", "2", "--weights", weights["realesrgan_x4"],
                "--inputs-path", frames_dir, "--output-path", out_dir])
    torch.cuda.synchronize()
    calls = rdb.launches
    launches += calls
    outs = sorted(os.listdir(out_dir))
    check(len(outs) == 2, f"realesrgan_x4 infer wrote {outs}")
    for name in outs:
        img = cv2.imread(os.path.join(out_dir, name))
        check(img is not None and img.shape == (4 * RE_SERVE, 4 * RE_SERVE, 3), f"realesrgan_x4 infer {name}")
    check(calls == RDB_PER_FORWARD, f"realesrgan_x4 infer: {calls} rdb_forward calls for 1 forward")
    print(f"cli.infer realesrgan_x4 --half --batch 2: 2 frames, {calls} rdb_forward calls", flush=True)
    return launches, forward_ms, f32_launches


# the bsrnet training step's shapes: a chain call per batch of 16 pre-crops
# of 320x320, two blurs of K = 25; the generator's RDBs on 72x72 LR crops
FILTER_SHAPE, FILTER_K = (16, 320, 320, 3), 25
SMALL_FILTER_SHAPE = (RE_BATCH, 8, 8, 3)  # the Real-ESRGAN chain's last stage at GT 32, x4
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
    # then shapes at and below the reflect pad (K // 2 >= H or W, down to
    # one pixel): the reflection folds again and again, as jnp.pad pads
    cases = [(FILTER_SHAPE, FILTER_K, None), (FILTER_SHAPE, FILTER_K, plan_ks), ((3, 37, 53, 3), 1, None),
             ((3, 37, 53, 3), 7, None), ((3, 37, 53, 3), 25, None), ((3, 37, 53, 3), 31, None),
             ((2, 1, 1, 3), 3, None), ((2, 1, 9, 3), 7, None), ((2, 6, 1, 3), 5, None), ((2, 3, 5, 3), 25, None),
             ((2, 12, 12, 3), 25, None), (SMALL_FILTER_SHAPE, RE_K, None), ((1, 13, 90, 5), 31, None)]
    err = 0.0
    for i, (shape, k, ks) in enumerate(cases):
        x = torch.rand(shape, generator=torch.Generator().manual_seed(200 + i)).cuda()
        ks = asymmetric_kernels(shape[0], k, seed=300 + i) if ks is None else ks
        got = f2d.filter2d(x, ks)
        torch.cuda.synchronize()
        want = f2d.filter2d_ref(x, ks)
        e = (got - want).abs().max().item()
        err = max(err, e)
        small = " (below the pad)" if k // 2 >= min(shape[1], shape[2]) else ""
        print(f"filter2d {shape} K={k}{' (plan)' if i == 1 else ''}{small} f32: max abs {e:.3g} "
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
    # the Real-ESRGAN chain's final stage at GT 32 (x4): 8x8 under the K = 21
    # sinc, below its pad of 10
    x8 = torch.rand(SMALL_FILTER_SHAPE, generator=torch.Generator().manual_seed(211)).cuda()
    k8 = asymmetric_kernels(SMALL_FILTER_SHAPE[0], RE_K, seed=311)
    with torch.inference_mode():
        small_ms = cuda_ms(lambda: f2d.filter2d(x8, k8))
        small_plain_ms = cuda_ms(lambda: f2d.filter2d_ref(x8, k8))
    n8, h8, w8, c8 = SMALL_FILTER_SHAPE
    small_flops = 2 * n8 * h8 * w8 * c8 * RE_K * RE_K
    small_bytes_ms = 4 * (2 * n8 * h8 * w8 * c8 + n8 * RE_K * RE_K) / PEAK_HBM_BYTES * 1e3
    small_bound_ms = max(TF32_PRODUCTS * small_flops / PEAK_TF32_FLOPS * 1e3, small_bytes_ms)
    print(f"filter2d timing at {SMALL_FILTER_SHAPE} K={RE_K} (below the pad): kernel {small_ms:.4f} ms, plain "
          f"{small_plain_ms:.4f} ms; bound {small_bound_ms:.4f} ms "
          f"({'operations' if small_bound_ms > small_bytes_ms else 'bytes'}), "
          f"{100 * small_bound_ms / small_ms:.1f}% of it", flush=True)
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
        "below_pad_shape": list(SMALL_FILTER_SHAPE),
        "below_pad_ms": small_ms,
        "below_pad_plain_ms": small_plain_ms,
        "below_pad_bound_ms": small_bound_ms,
        "shape": list(FILTER_SHAPE),
        "k": FILTER_K,
        "dtype": "float32",
    }


def re_filter2d_phase(f2d) -> dict:
    """filter2d vs filter2d_ref at the Real-ESRGAN chain's shapes, K = 21:
    k1 on (48, 256, 256, 3) from one batch's kernel triples (mixed
    Gaussians of sizes 7..21 zero-padded to 21, a sinc now and then), the
    same images under sinc kernels alone (negative taps), and the final
    sinc (or identity pulse) on (48, 64, 64, 3); each timed beside its
    bounds, the plain version and the cuDNN grouped convolution."""
    import torch.nn.functional as F

    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.ops import kernels
    from srganfd_tpu_torch.ops.realesrgan_degrade import sample_kernel_triple

    model = configs.get_config("realesrgan").degradation_params["model"]
    rng = np.random.default_rng(230)
    triples = [sample_kernel_triple(rng, model) for _ in range(RE_BATCH)]
    sizes = model["gaussian_kernel_range"]
    sincs = np.stack([kernels.sinc_kernel(rng.uniform(np.pi / 3, np.pi), int(rng.choice(sizes)), pad_to=RE_K)
                      for _ in range(RE_BATCH)]).astype(np.float32)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    cases = {"k1": (RE_FILTER_SHAPE, dev(np.stack([t[0] for t in triples]))),
             "sinc": (RE_FILTER_SHAPE, dev(sincs)),
             "final_sinc": (RE_FINAL_SHAPE, dev(np.stack([t[2] for t in triples])))}
    check(bool((cases["sinc"][1] < 0).any()), "the sinc kernels have no negative tap")
    out = {}
    for i, (name, (shape, ks)) in enumerate(cases.items()):
        x = torch.rand(shape, generator=torch.Generator().manual_seed(240 + i)).cuda()
        got = f2d.filter2d(x, ks)
        torch.cuda.synchronize()
        want = f2d.filter2d_ref(x, ks)
        err = (got - want).abs().max().item()
        check(err <= 1e-5, f"filter2d {shape} {name}: max abs {err}")
        n, h, w, c = shape
        pad = RE_K // 2
        xpad = F.pad(x.permute(0, 3, 1, 2).reshape(1, n * c, h, w), (pad,) * 4, mode="reflect")
        weight = ks.repeat_interleave(c, dim=0)[:, None].contiguous()
        with torch.inference_mode():
            kernel_ms = cuda_ms(lambda: f2d.filter2d(x, ks))
            plain_ms = cuda_ms(lambda: f2d.filter2d_ref(x, ks))
            library_ms = cuda_ms(lambda: F.conv2d(xpad, weight, groups=n * c))
        flops = 2 * n * h * w * c * RE_K * RE_K
        nonzero_flops = 2 * h * w * c * int((ks != 0).sum())
        t_bytes = 4 * (2 * n * h * w * c + n * RE_K * RE_K) / PEAK_HBM_BYTES * 1e3
        bound = max(TF32_PRODUCTS * flops / PEAK_TF32_FLOPS * 1e3, t_bytes)
        nonzero_bound = max(TF32_PRODUCTS * nonzero_flops / PEAK_TF32_FLOPS * 1e3, t_bytes)
        out[name] = {"shape": list(shape), "k": RE_K, "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound, "nonzero_bound_ms": nonzero_bound,
                     "bound_by": "operations" if bound > t_bytes else "bytes",
                     "nonzero_tap_share": nonzero_flops / flops}
        print(f"filter2d {shape} K={RE_K} {name} (realesrgan chain): max abs {err:.3g} (|out| <= "
              f"{want.abs().max().item():.3g}); kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN "
              f"grouped conv {library_ms:.4f} ms; bound {bound:.4f} ms on dense taps as {TF32_PRODUCTS} TF32 "
              f"products ({100 * bound / kernel_ms:.1f}% of it), {nonzero_bound:.4f} ms on the "
              f"{100 * nonzero_flops / flops:.1f}% nonzero taps", flush=True)
    return out


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


def f32_step_vs_plain(cfg, host, rdb, f2d, blocks, filters, init=(), plain_runs=1, label="bsrnet",
                      filters_per_chain=FILTERS_PER_CHAIN):
    """One full-width f32 step of ``cfg`` (bsrnet, or bsrgan with its D),
    with the RDB kernel and then ``plain_runs`` times with rdb_forward_ref
    swapped in (a switch of this script only), from one state (the seeded
    init, or ``init``: G's state dict and, for a GAN, D's with its ``u``)
    on one batch: the chain's, with the filter2d kernel, whose LR is held
    to the plain chain's apart (the Real-ESRGAN chain draws its noise from
    one generator state in both). Returns the readings of
    ``train.step_check`` (the chain's LR, and the share of its elements
    off by more than 1e-5; the loss parts, relative; the
    LeakyReLU slopes the kernel's and the first plain run's backwards take
    differently; the updated G outside and inside the flipped channels),
    the share of SR elements in (0, 1), which the output clamp passes (a
    forward's rounding reaches the losses through these alone), and each
    run's (metrics, G state dict, D state dict or None), the kernel's
    first."""
    from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
    from srganfd_tpu_torch.train import step_check
    from srganfd_tpu_torch.train.loop import Trainer

    cfg = cfg.replace(compute_dtype="float32")
    orig = blocks.rdb_apply, filters.filter2d
    before = f2d.launches
    batch = DegradationAdapter(cfg, seed=cfg.seed, train=True, device="cuda")(host, 0)
    check(f2d.launches - before == filters_per_chain, f"the f32 chain made {f2d.launches - before} filter2d calls")
    filters.filter2d = f2d.filter2d_ref
    try:
        plain_lr = DegradationAdapter(cfg, seed=cfg.seed, train=True, device="cuda")(host, 0)["lr"]
    finally:
        filters.filter2d = orig[1]
    runs, rdbs, inside = [], [], []
    try:
        for plain in (False,) + (True,) * plain_runs:
            seen = []

            def recorded(x, k, b, packed=None, plain=plain, seen=seen):
                if len(rdbs) < 2:  # the flips compare the first two runs
                    seen.append((x.detach().clone(), [t.detach().clone() for t in k],
                                 [t.detach().clone() for t in b]))
                return rdb.rdb_forward_ref(x, k, b) if plain else orig[0](x, k, b, packed)

            blocks.rdb_apply = recorded
            trainer = Trainer(cfg, steps_per_epoch=TRAIN_STEPS_PER_EPOCH, device="cuda")
            state = trainer.init_state(*init)
            hook = state.g_model.register_forward_hook(
                lambda m, i, o: inside.append(((o > 0) & (o < 1)).float().mean().item()))
            before = rdb.launches
            metrics = {k: v.item() for k, v in trainer.train_step(state, batch["gt"], batch["lr"],
                                                                  batch.get("gt_pixel")).items()}
            hook.remove()
            made = rdb.launches - before
            check(made == (0 if plain else RDB_PER_FORWARD), f"f32 {label} step (plain={plain}) made {made} rdb calls")
            names = [n for n, m in state.g_model.named_modules() if isinstance(m, blocks.ResidualDenseBlock)]
            d = None if state.d_model is None else {k: v.detach().clone()
                                                    for k, v in state.d_model.state_dict().items()}
            runs.append((metrics, {k: v.detach().clone() for k, v in state.g_model.state_dict().items()}, d))
            if len(rdbs) < 2:
                rdbs.append(seen)
            del trainer, state
    finally:
        blocks.rdb_apply = orig[0]
    (m_k, g_k, _), (m_p, g_p, _) = runs[:2]
    flips, channels = step_check.slope_flips(*rdbs)
    loss_rel = {k: abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-30) for k in m_p if k.endswith("_loss")}
    lr_diff = (batch["lr"] - plain_lr).abs()
    out = {"lr_max_abs": lr_diff.max().item(), "lr_mean_abs": lr_diff.mean().item(),
           "lr_off_level_share": (lr_diff > 1e-5).float().mean().item(),
           "loss_rel": max(loss_rel.values()),
           "loss_rel_parts": loss_rel, "sr_in_range": inside[0],
           "slope_flips": sum(flips), "rdbs_with_flips": sum(f > 0 for f in flips),
           "preactivations": RDB_PER_FORWARD * sum(z.numel() for z in step_check.rdb_preactivations(*rdbs[1][0])),
           **step_check.g_agreement(g_k, g_p, step_check.flipped_channels(names, channels))}
    print(f"f32 {label} step, kernels vs plain versions on one batch: chain LR (filter2d kernel vs plain) max "
          f"abs {out['lr_max_abs']:.3g}; SR in (0, 1) {out['sr_in_range']:.4f}; loss parts relative "
          f"{ {k: float(f'{v:.3g}') for k, v in loss_rel.items()} } (kernel {m_k}, plain {m_p}); LeakyReLU "
          f"slopes the backwards take differently: {out['slope_flips']} of {out['preactivations']}, in "
          f"{out['rdbs_with_flips']} of {RDB_PER_FORWARD} RDBs; updated G per tensor max relative "
          f"{out['g_outside']:.3g} outside the flipped channels ({out['g_outside_worst']}), "
          f"{out['g_inside']:.3g} inside ({out['g_inside_worst']}, {out['g_excluded_elements']} elements)",
          flush=True)
    return out, runs


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

    def recorded_step(self, state, gt, lr_img, gt_pixel=None):
        entry = time.perf_counter()
        index = state.step
        metrics = real_step(self, state, gt, lr_img, gt_pixel)
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
    f32, _ = f32_step_vs_plain(cfg, host, rdb, f2d, blocks, filters)
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


GAN_STEPS_PER_EPOCH = 4
GAN_EPOCHS = 1  # then --resume auto for one more epoch
GAN_EXPERIENCE = "BSRGANsa_x2_bubbles"  # the bsrgan config's experience_name


def _rel_per_tensor(a: dict, b: dict) -> tuple[float, str]:
    """The largest per-tensor max |a - b| / max |b|, and its tensor."""
    return max(((a[k].float() - v.float()).abs().max().item() / max(v.float().abs().max().item(), 1e-12), k)
               for k, v in b.items())


def gan_train_phase(work: str, rdb, f2d, blocks, filters) -> tuple[dict, dict]:
    """Full-width bsrgan (the config unchanged: bsrgan_x2 64/32/23,
    discriminator_unet c = 64, batch 16, pre-crop 320, GT 144, bf16, the
    VGG19 content loss and LPIPS selection on the seeded surrogates)
    through cli.train.run_train on the bsrnet phase's frames: one epoch,
    then --resume auto for a second; returns the kernel calls it made and
    its numbers."""
    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli import train as cli_train
    from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
    from srganfd_tpu_torch.convert import load_generator_weights
    from srganfd_tpu_torch.data.datasets import BatchLoader
    from srganfd_tpu_torch.losses.gan import bce_with_logits
    from srganfd_tpu_torch.ops.degrade import apply_bsrgan_batch_cropped, bsrgan_lr_size, plan_bsrgan_batch
    from srganfd_tpu_torch.train import checkpoint as ckpt
    from srganfd_tpu_torch.train import step_check
    from srganfd_tpu_torch.train.loop import Trainer

    cfg = configs.get_config("bsrgan").replace(
        train_gt_images_dir=os.path.join(work, "train_gt"), valid_gt_images_dir=os.path.join(work, "valid_gt"),
        results_dir=os.path.join(work, "results"), samples_dir=os.path.join(work, "samples"),
    )
    print(f"bsrgan: {cfg.g_arch} {cfg.g_kwargs or 'full width (64/32/23)'} against {cfg.d_arch} "
          f"{cfg.d_kwargs or 'c = 64'}, batch {cfg.batch_size}, pre-crop {cfg.crop_image_size}, GT "
          f"{cfg.gt_image_size}, {cfg.compute_dtype}; pixel {cfg.pixel_weight} + content {cfg.content_weight} "
          f"over {cfg.feature_nodes} + adversarial {cfg.adversarial_weight}; Adam g {cfg.model_lr} / d "
          f"{cfg.discriminator_lr} eps {cfg.model_eps}; selection by {cfg.optimizing_metric}", flush=True)

    metrics_seen, steps = [], []  # steps: (step index, host clock at entry, at end)
    restored = []  # what restore_state left in the state, held to the checkpoint it read right then
    real_step, real_restore = Trainer.train_step, ckpt.restore_state

    def recorded_step(self, state, gt, lr_img, gt_pixel=None):
        entry = time.perf_counter()
        index = state.step
        m = real_step(self, state, gt, lr_img, gt_pixel)
        metrics_seen.append({k: v.item() for k, v in m.items()})  # waits for the step
        steps.append((index, entry, time.perf_counter()))
        return m

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a.cpu(), b.cpu())
        if isinstance(a, dict):
            return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return a == b

    def recorded_restore(state, payload):
        real_restore(state, payload)
        u = {k: v for k, v in state.d_model.state_dict().items() if k.endswith(".u")}
        restored.append({
            "step": state.step, "u": same(u, {k: payload["d_state_dict"][k] for k in u}),
            "adams": same(state.g_opt.state_dict(), payload["optimizer"])
            and same(state.d_opt.state_dict(), payload["d_optimizer"]),
            "d_adam_count": state.d_opt.state_dict()["state"][0]["step"].item(),
        })

    Trainer.train_step, ckpt.restore_state = recorded_step, recorded_restore
    torch.cuda.reset_peak_memory_stats()
    rdb.launches = f2d.launches = 0
    try:
        run_s = []
        for epochs, resume in ((GAN_EPOCHS, ""), (GAN_EPOCHS + 1, "auto")):
            t0 = time.perf_counter()
            result = cli_train.run_train(cfg.replace(epochs=epochs), GAN_STEPS_PER_EPOCH, resume=resume,
                                         device="cuda")
            torch.cuda.synchronize()
            run_s.append(time.perf_counter() - t0)
    finally:
        Trainer.train_step, ckpt.restore_state = real_step, real_restore
    calls = {"rdb": rdb.launches, "filter2d": f2d.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = GAN_STEPS_PER_EPOCH * (GAN_EPOCHS + 1)
    n_valid = GAN_EPOCHS + 1  # one batch of the 4 valid frames per epoch
    check(len(metrics_seen) == n_steps, f"{len(metrics_seen)} bsrgan steps, expected {n_steps}")
    check(all(math.isfinite(v) for m in metrics_seen for v in m.values()), f"non-finite bsrgan metrics: {metrics_seen}")
    check(all(0 < m[k] < 1 for m in metrics_seen for k in ("d_gt_probability", "d_sr_probability")),
          "a D probability outside (0, 1): " + str([(m["d_gt_probability"], m["d_sr_probability"])
                                                    for m in metrics_seen]))
    check(calls == {"rdb": RDB_PER_FORWARD * (n_steps + n_valid),
                    "filter2d": FILTERS_PER_CHAIN * (n_steps + n_valid)},
          f"bsrgan training made {calls} kernel calls for {n_steps} steps and {n_valid} validation batches")
    state = result["state"]
    check(state.step == n_steps, f"resumed bsrgan run ended at step {state.step}")

    # the resumed run restored step, u and both Adams, and went on from there
    check(len(restored) == 1, f"{len(restored)} restores in the bsrgan runs")
    after = restored[0]
    check(after["step"] == GAN_STEPS_PER_EPOCH, f"resumed at step {after['step']}")
    resumed_first = steps[GAN_STEPS_PER_EPOCH][0]
    check(resumed_first == GAN_STEPS_PER_EPOCH, f"the resumed run's first step was {resumed_first}")
    check(after["u"], "the resumed D's u vectors are not the checkpoint's")
    check(after["adams"], "the resumed Adams are not the checkpoint's")
    check(after["d_adam_count"] == GAN_STEPS_PER_EPOCH, f"D's Adam count after the resume: {after['d_adam_count']}")

    # validation LPIPS and the selection of ckpt_best (the tracker's JSONL)
    with open(os.path.join(cfg.samples_dir, "logs", GAN_EXPERIENCE, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    lpips = [e["metrics"]["Valid/LPIPS"] for e in events if e["type"] == "metrics" and "Valid/LPIPS" in e["metrics"]]
    check(len(lpips) == n_valid and all(math.isfinite(v) for v in lpips), f"validation LPIPS {lpips}")
    ckpt_dir = os.path.join(cfg.results_dir, cfg.exp_name)
    best = ckpt.load_checkpoint(os.path.join(ckpt_dir, "ckpt_best.pth"))
    check(best["epoch"] == int(np.argmin(lpips)) and best["best_lpips"] == min(lpips),
          f"ckpt_best.pth is epoch {best['epoch']} (best LPIPS {best['best_lpips']}), LPIPS by epoch {lpips}")
    last = ckpt.load_checkpoint(os.path.join(ckpt_dir, "ckpt_last.pth"))
    check(all(torch.equal(last["d_state_dict"][k], v.cpu()) for k, v in state.d_model.state_dict().items()),
          "ckpt_last.pth is not the final D")

    intervals = [(b[2] - a[2]) * 1e3 for a, b in zip(steps, steps[1:])
                 if b[0] == a[0] + 1 and b[0] % GAN_STEPS_PER_EPOCH]
    inside = [(end - entry) * 1e3 for _, entry, end in steps]
    step_p50 = float(np.median(intervals))
    print(f"bsrgan training: metrics {[{k: round(v, 5) for k, v in m.items()} for m in metrics_seen]}", flush=True)
    print(f"bsrgan training: {n_steps} steps + {n_valid} validation batches in {[round(t, 2) for t in run_s]} s; "
          f"step p50 {step_p50:.2f} ms host clock over {len(intervals)} steps "
          f"({cfg.batch_size * 1e3 / step_p50:.2f} frames/s), inside train_step p50 {np.median(inside[1:]):.2f} "
          f"ms; validation LPIPS by epoch {lpips}, ckpt_best.pth epoch {best['epoch']}; resumed at step "
          f"{after['step']}; peak memory {peak_gb:.2f} GB; {calls} kernel calls", flush=True)

    # where one step's time goes, on the card (CUDA events), on the trained state
    loader = BatchLoader(cli_train.build_datasets(cfg)[0], cfg.batch_size, seed=cfg.seed, num_workers=2)
    it = iter(loader)
    host = next(it)
    it.close()
    gt_dev = torch.from_numpy(host["gt"]).cuda()
    plan = plan_bsrgan_batch(np.random.default_rng(0), cfg.batch_size, cfg.upscale_factor)
    lim = bsrgan_lr_size(gt_dev.shape[1], plan) - cfg.gt_image_size // cfg.upscale_factor
    tops = np.random.default_rng(1).integers(0, lim + 1, cfg.batch_size)
    chain = lambda: apply_bsrgan_batch_cropped(gt_dev, plan, tops, tops, cfg.gt_image_size, cfg.upscale_factor)
    gt_c, lr_c = chain()
    trainer = Trainer(cfg, GAN_STEPS_PER_EPOCH, device="cuda")
    g, d = state.g_model, state.d_model

    def g_fwd_bwd():
        (g(lr_c) - gt_c).abs().mean().backward()

    sr = g(lr_c).detach()
    sr_leaf = sr.clone().requires_grad_()

    def content_fwd_bwd():
        trainer.content_loss(sr_leaf, gt_c).backward(inputs=[sr_leaf])

    def adversarial_fwd_bwd():
        out = d(sr_leaf, update_stats=False)
        bce_with_logits(out, torch.ones_like(out)).backward(inputs=[sr_leaf])

    breakdown = {
        "chain_ms": cuda_ms(chain, iters=5, warmup=1),
        "g_forward_backward_ms": cuda_ms(g_fwd_bwd, iters=3, warmup=1),
        "d_update_ms": cuda_ms(lambda: trainer._d_update(state, gt_c, sr), iters=3, warmup=1),
        "content_forward_backward_ms": cuda_ms(content_fwd_bwd, iters=3, warmup=1),
        "adversarial_forward_backward_ms": cuda_ms(adversarial_fwd_bwd, iters=3, warmup=1),
        "train_step_ms": cuda_ms(lambda: real_step(trainer, state, gt_c, lr_c), iters=3, warmup=1),
    }
    valid_adapter = DegradationAdapter(cfg, seed=cfg.seed + 1, train=True, device="cuda")
    valid_ds = cli_train.build_datasets(cfg)[1]
    from srganfd_tpu_torch.losses.lpips import Lpips

    lpips_fn = Lpips().to("cuda")
    valid_host = next(iter(BatchLoader(valid_ds, 4, shuffle=False, loop=False, seed=cfg.seed, drop_last=True,
                                       num_workers=1)))
    vb = valid_adapter(valid_host, 0)
    vsr = trainer.eval_sr(state, vb["lr"])
    with torch.inference_mode():
        breakdown["lpips_ms"] = cuda_ms(lambda: lpips_fn(vsr, vb["gt"]), iters=5, warmup=1)
    t0 = time.perf_counter()
    vm = cli_train.validate(cfg, trainer, state,
                            BatchLoader(valid_ds, 4, shuffle=False, loop=False, seed=cfg.seed, drop_last=True,
                                        num_workers=1), valid_adapter, lpips_fn=lpips_fn)
    torch.cuda.synchronize()
    breakdown["validation_ms"] = (time.perf_counter() - t0) * 1e3
    check(math.isfinite(vm["lpips"]), f"validation LPIPS {vm['lpips']}")
    print(f"bsrgan step breakdown on the card (CUDA events, {cfg.compute_dtype}, batch {cfg.batch_size}): "
          f"chain {breakdown['chain_ms']:.2f} ms; G forward+backward (L1) {breakdown['g_forward_backward_ms']:.2f} "
          f"ms; D update (2 forwards on GT and SR, backward, Adam) {breakdown['d_update_ms']:.2f} ms; content "
          f"(VGG19 to features.34 on SR and GT, backward to SR) {breakdown['content_forward_backward_ms']:.2f} ms; "
          f"adversarial (D on SR, backward to SR) {breakdown['adversarial_forward_backward_ms']:.2f} ms; whole "
          f"train step {breakdown['train_step_ms']:.2f} ms; validation of 4 frames with LPIPS "
          f"{breakdown['validation_ms']:.2f} ms host clock (LPIPS alone {breakdown['lpips_ms']:.2f} ms)", flush=True)
    d_final = {k: v.detach().clone() for k, v in d.state_dict().items()}
    del g, d, state, result, trainer, sr, sr_leaf

    # One f32 GAN step held to the plain one, from the state the recipe's
    # GAN stage starts from: G from the bsrnet phase's last checkpoint, D
    # and its u from this phase's end. From the seeded init the content
    # term's gradient makes G read 1.42e-4 outside the flipped channels,
    # 50x the bsrnet step; from here it reads as the bsrnet step does (the
    # variants below, PERF.md section 6). Held: the loss parts to 1e-5; D
    # per tensor to 1e-3; u to 1e-3, a sanity check only (u is written from
    # D's weights before Adam moves them, so both runs write the same u); G
    # by step_check's LIMITS (flips 250, G 1e-3).
    bsrnet_ckpt = os.path.join(cfg.results_dir, configs.get_config("bsrnet").exp_name, "ckpt_last.pth")
    f32, runs = f32_step_vs_plain(cfg, host, rdb, f2d, blocks, filters,
                                  init=(load_generator_weights(bsrnet_ckpt), d_final), plain_runs=2,
                                  label="bsrgan (bsrnet-trained G, bsrgan-trained D)")
    (_, _, d_k), (m_p, g_p, d_p), (m_p2, g_p2, d_p2) = runs
    kept = lambda sd, u: {k: v for k, v in sd.items() if k.endswith(".u") == u}  # noqa: E731
    f32["d_rel"], f32["d_worst"] = _rel_per_tensor(kept(d_k, False), kept(d_p, False))
    f32["u_rel"], f32["u_worst"] = _rel_per_tensor(kept(d_k, True), kept(d_p, True))
    f32["plain_again"] = {"loss_rel": max(abs(m_p2[k] - m_p[k]) / max(abs(m_p[k]), 1e-30) for k in m_p),
                          "d_rel": _rel_per_tensor(d_p2, d_p)[0], "g_rel": _rel_per_tensor(g_p2, g_p)[0]}
    print(f"f32 bsrgan step (trained state): updated D per tensor max relative {f32['d_rel']:.3g} "
          f"({f32['d_worst']}), u {f32['u_rel']:.3g} ({f32['u_worst']}); the plain step run twice: losses "
          f"{f32['plain_again']['loss_rel']:.3g}, D {f32['plain_again']['d_rel']:.3g}, G per tensor "
          f"{f32['plain_again']['g_rel']:.3g} apart", flush=True)
    failed = step_check.step_check_failures(f32, {**step_check.LIMITS, "d_rel": 1e-3, "u_rel": 1e-3})
    check(not failed, f"f32 bsrgan step vs plain: {failed}")

    # Where the seeded-init GAN step's G reading outside the flipped
    # channels comes from (printed, not held): the same step with the
    # adversarial weight 0, then with the content loss off too.
    variants = {}
    for name, over in (("bsrgan", {}), ("adversarial weight 0", {"adversarial_weight": (0.0,)}),
                       ("adversarial weight 0, no content loss", {"adversarial_weight": (0.0,), "content_weight": ()})):
        r, _ = f32_step_vs_plain(cfg.replace(**over), host, rdb, f2d, blocks, filters,
                                 label=f"bsrgan, {name}, seeded init")
        variants[name] = {k: r[k] for k in ("sr_in_range", "loss_rel", "slope_flips", "g_outside", "g_outside_worst",
                                            "g_inside", "g_inside_worst")}
    numbers = {
        "steps": n_steps, "validation_batches": n_valid, "metrics": metrics_seen, "validation_lpips": lpips,
        "best_epoch": best["epoch"], "step_ms_p50": step_p50, "inside_step_ms_p50": float(np.median(inside[1:])),
        "frames_per_s": cfg.batch_size * 1e3 / step_p50, "peak_memory_gb": peak_gb, "run_s": run_s,
        **breakdown, "f32_step_vs_plain": f32, "f32_seeded_init_variants": variants,
    }
    return calls, numbers


def re_expected_filters(cfg, seed: int, steps, n: int) -> int:
    """filter2d launches of the Real-ESRGAN chain over these adapter steps
    at batch ``n`` of RE_GT crops: k1 and the sinc always, k2 when the
    step's plan draws the second blur (p = 0.8)."""
    from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
    from srganfd_tpu_torch.ops.realesrgan_degrade import plan_realesrgan_batch

    adapter = DegradationAdapter(cfg, seed=seed, device="cpu")
    process = cfg.degradation_params["process"]
    return sum(2 + plan_realesrgan_batch(adapter.step_rng(s), n, (RE_GT, RE_GT), cfg.upscale_factor,
                                         process).second_blur for s in steps)


def re_train_phase(work: str, name: str, rdb, f2d, blocks, filters) -> tuple[dict, dict, dict]:
    """Full-width ``realesrnet`` or ``realesrgan`` (the config unchanged:
    realesrgan_x4 64/32/23, batch 48, GT 256, x4, bf16; for the GAN
    discriminator_unet c = 64, VGG19 content over five nodes, BCE, LPIPS
    selection on the seeded surrogates) through cli.train.run_train on 48
    synthetic 288x288 frames: one epoch of RE_STEPS_PER_EPOCH steps, then
    --resume auto for a second. Returns the kernel calls, the numbers, and
    the host batch and final D state that the f32 check starts from."""
    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli import train as cli_train
    from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
    from srganfd_tpu_torch.data.datasets import BatchLoader
    from srganfd_tpu_torch.losses.gan import bce_with_logits
    from srganfd_tpu_torch.losses.lpips import Lpips
    from srganfd_tpu_torch.ops.realesrgan_degrade import usm_sharp
    from srganfd_tpu_torch.train import checkpoint as ckpt
    from srganfd_tpu_torch.train.loop import Trainer

    train_dir, valid_dir = os.path.join(work, "re_train_gt"), os.path.join(work, "re_valid_gt")
    if not os.path.isdir(train_dir):
        write_gt_frames(train_dir, RE_BATCH, RE_FRAME, seed=20)
        write_gt_frames(valid_dir, 4, RE_FRAME, seed=21)
    cfg = configs.get_config(name).replace(
        train_gt_images_dir=train_dir, valid_gt_images_dir=valid_dir,
        results_dir=os.path.join(work, "results"), samples_dir=os.path.join(work, "samples"),
    )
    gan = cfg.is_gan
    print(f"{name}: {cfg.g_arch} {cfg.g_kwargs or 'full width (64/32/23)'}"
          f"{f' against {cfg.d_arch} c = 64' if gan else ''}, batch {cfg.batch_size}, GT {cfg.gt_image_size}, "
          f"x{cfg.upscale_factor}, {cfg.compute_dtype}; pixel {cfg.pixel_weight}"
          f"{f' + content {cfg.content_weight} + adversarial {cfg.adversarial_weight}, G step first' if gan else ''}"
          f"; Adam {cfg.model_lr} eps {cfg.model_eps}; selection by {cfg.optimizing_metric}", flush=True)

    metrics_seen, steps, restored = [], [], []
    real_step, real_restore = Trainer.train_step, ckpt.restore_state

    def recorded_step(self, state, gt, lr_img, gt_pixel=None):
        entry = time.perf_counter()
        index = state.step
        m = real_step(self, state, gt, lr_img, gt_pixel)
        metrics_seen.append({k: v.item() for k, v in m.items()})  # waits for the step
        steps.append((index, entry, time.perf_counter()))
        return m

    def recorded_restore(state, payload):
        real_restore(state, payload)
        same = lambda a, b: all(torch.equal(torch.as_tensor(a[k]).cpu(), torch.as_tensor(b[k]).cpu())  # noqa: E731
                                for k in b)
        adams = [(state.g_opt, "optimizer")] + ([(state.d_opt, "d_optimizer")] if gan else [])
        restored.append({
            "step": state.step,
            "adams": all(same(o.state_dict()["state"][i], payload[key]["state"][i])
                         for o, key in adams for i in payload[key]["state"]),
            "u": (not gan) or same({k: v for k, v in state.d_model.state_dict().items() if k.endswith(".u")},
                                   {k: v for k, v in payload["d_state_dict"].items() if k.endswith(".u")}),
        })

    Trainer.train_step, ckpt.restore_state = recorded_step, recorded_restore
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rdb.launches = f2d.launches = 0
    try:
        run_s = []
        for epochs, resume in ((RE_EPOCHS, ""), (RE_EPOCHS + 1, "auto")):
            t0 = time.perf_counter()
            result = cli_train.run_train(cfg.replace(epochs=epochs), RE_STEPS_PER_EPOCH, resume=resume,
                                         device="cuda")
            torch.cuda.synchronize()
            run_s.append(time.perf_counter() - t0)
    finally:
        Trainer.train_step, ckpt.restore_state = real_step, real_restore
    calls = {"rdb": rdb.launches, "filter2d": f2d.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = RE_STEPS_PER_EPOCH * (RE_EPOCHS + 1)
    n_valid = RE_EPOCHS + 1  # one batch of the 4 valid frames per epoch, adapter step 0
    want_filters = (re_expected_filters(cfg, cfg.seed, range(n_steps), RE_BATCH)
                    + n_valid * re_expected_filters(cfg, cfg.seed + 1, [0], 4))
    check(len(metrics_seen) == n_steps, f"{len(metrics_seen)} {name} steps, expected {n_steps}")
    check(all(math.isfinite(v) for m in metrics_seen for v in m.values()), f"non-finite {name} metrics: {metrics_seen}")
    if gan:
        check(all(0 < m[k] < 1 for m in metrics_seen for k in ("d_gt_probability", "d_sr_probability")),
              f"a D probability outside (0, 1): {metrics_seen}")
    check(calls == {"rdb": RDB_PER_FORWARD * (n_steps + n_valid), "filter2d": want_filters},
          f"{name} made {calls} kernel calls for {n_steps} steps and {n_valid} validation batches "
          f"(expected {RDB_PER_FORWARD * (n_steps + n_valid)} rdb, {want_filters} filter2d)")
    state = result["state"]
    check(state.step == n_steps, f"resumed {name} run ended at step {state.step}")
    check(len(restored) == 1 and restored[0]["step"] == RE_STEPS_PER_EPOCH, f"{name} restores: {restored}")
    check(steps[RE_STEPS_PER_EPOCH][0] == RE_STEPS_PER_EPOCH, f"the resumed {name} run's first step was "
          f"{steps[RE_STEPS_PER_EPOCH][0]}")
    check(restored[0]["adams"] and restored[0]["u"], f"the resumed {name} state is not the checkpoint's: {restored}")

    exp = cfg.experience_name or cfg.exp_name
    with open(os.path.join(cfg.samples_dir, "logs", exp, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    metric = "Valid/LPIPS" if cfg.optimizing_metric == "LPIPS" else "Valid/PSNR"
    scores = [e["metrics"][metric] for e in events if e["type"] == "metrics" and metric in e["metrics"]]
    check(len(scores) == n_valid and all(math.isfinite(v) for v in scores), f"{name} validation {metric} {scores}")
    ckpt_dir = os.path.join(cfg.results_dir, cfg.exp_name)
    best = ckpt.load_checkpoint(os.path.join(ckpt_dir, "ckpt_best.pth"))
    pick = np.argmin if metric == "Valid/LPIPS" else np.argmax
    check(best["epoch"] == int(pick(scores)), f"{name} ckpt_best.pth is epoch {best['epoch']}, {metric} {scores}")
    if gan:
        last = ckpt.load_checkpoint(os.path.join(ckpt_dir, "ckpt_last.pth"))
        check(all(torch.equal(last["d_state_dict"][k], v.cpu()) for k, v in state.d_model.state_dict().items()),
              f"{name} ckpt_last.pth is not the final D")

    intervals = [(b[2] - a[2]) * 1e3 for a, b in zip(steps, steps[1:])
                 if b[0] == a[0] + 1 and b[0] % RE_STEPS_PER_EPOCH]
    inside = [(end - entry) * 1e3 for _, entry, end in steps]
    step_p50 = float(np.median(intervals))
    print(f"{name} training: metrics {[{k: round(v, 5) for k, v in m.items()} for m in metrics_seen]}", flush=True)
    print(f"{name} training: {n_steps} steps + {n_valid} validation batches in {[round(t, 2) for t in run_s]} s; "
          f"step p50 {step_p50:.2f} ms host clock over {len(intervals)} steps "
          f"({cfg.batch_size * 1e3 / step_p50:.2f} frames/s), inside train_step p50 {np.median(inside[1:]):.2f} ms, "
          f"the first step {inside[0]:.1f} ms; validation {metric} by epoch {scores}, ckpt_best.pth epoch "
          f"{best['epoch']}; resumed at step {restored[0]['step']}; peak memory {peak_gb:.2f} GB; {calls} kernel "
          f"calls (per forward {calls['rdb'] // (n_steps + n_valid)} rdb_forward, per chain "
          f"{calls['filter2d'] / (n_steps + n_valid):.2f} filter2d)", flush=True)

    # where a step's time goes, on the card (CUDA events), on the trained state
    loader = BatchLoader(cli_train.build_datasets(cfg)[0], cfg.batch_size, seed=cfg.seed, num_workers=2)
    it = iter(loader)
    host = next(it)
    it.close()
    adapter = DegradationAdapter(cfg, seed=cfg.seed, train=True, device="cuda")
    seen_filters, real_filter = [], filters.filter2d

    def recorded_filter(x, k):
        seen_filters.append((x, k))
        return real_filter(x, k)

    filters.filter2d = recorded_filter
    try:
        batch = adapter(host, 0)
    finally:
        filters.filter2d = real_filter
    gt_dev = torch.from_numpy(host["gt"]).cuda()
    gt_c, lr_c, pix_c = batch["gt"], batch["lr"], batch["gt_pixel"]
    trainer = Trainer(cfg, RE_STEPS_PER_EPOCH, device="cuda")
    g = state.g_model

    def g_fwd_bwd():
        (g(lr_c) - pix_c).abs().mean().backward()

    with torch.inference_mode():
        breakdown = {
            "chain_ms": cuda_ms(lambda: adapter(host, 0), iters=3, warmup=1),
            "usm_ms": cuda_ms(lambda: usm_sharp(gt_dev), iters=3, warmup=1),
            "chain_filter2d_ms": sum(cuda_ms(lambda x=x, k=k: f2d.filter2d(x, k)) for x, k in seen_filters),
            "forward_ms": cuda_ms(lambda: g(lr_c), iters=3, warmup=1),
        }
    breakdown["chain_filter2d_shapes"] = [list(x.shape) for x, _ in seen_filters]
    breakdown["g_forward_backward_ms"] = cuda_ms(g_fwd_bwd, iters=2, warmup=1)
    if gan:
        d = state.d_model
        sr = g(lr_c).detach()
        sr_leaf = sr.clone().requires_grad_()

        def content_fwd_bwd():
            trainer.content_loss(sr_leaf, pix_c).backward(inputs=[sr_leaf])

        def adversarial_fwd_bwd():
            out = d(sr_leaf, update_stats=False)
            bce_with_logits(out, torch.ones_like(out)).backward(inputs=[sr_leaf])

        breakdown["d_update_ms"] = cuda_ms(lambda: trainer._d_update(state, gt_c, sr), iters=2, warmup=1)
        breakdown["content_forward_backward_ms"] = cuda_ms(content_fwd_bwd, iters=2, warmup=1)
        breakdown["adversarial_forward_backward_ms"] = cuda_ms(adversarial_fwd_bwd, iters=2, warmup=1)
        del sr, sr_leaf
    breakdown["train_step_ms"] = cuda_ms(lambda: real_step(trainer, state, gt_c, lr_c, pix_c), iters=2, warmup=1)
    valid_adapter = DegradationAdapter(cfg, seed=cfg.seed + 1, train=True, device="cuda")
    valid_loader = lambda: BatchLoader(cli_train.build_datasets(cfg)[1], 4, shuffle=False, loop=False,  # noqa: E731
                                       seed=cfg.seed, drop_last=True, num_workers=1)
    lpips_fn = Lpips().to("cuda") if gan else None
    t0 = time.perf_counter()
    vm = cli_train.validate(cfg, trainer, state, valid_loader(), valid_adapter, lpips_fn=lpips_fn)
    torch.cuda.synchronize()
    breakdown["validation_ms"] = (time.perf_counter() - t0) * 1e3
    check(math.isfinite(vm["psnr"]), f"{name} validation PSNR {vm['psnr']}")
    if gan:
        vb = valid_adapter(next(iter(valid_loader())), 0)
        vsr = trainer.eval_sr(state, vb["lr"])
        with torch.inference_mode():
            breakdown["lpips_ms"] = cuda_ms(lambda: lpips_fn(vsr, vb["gt"]), iters=5, warmup=1)
        check(math.isfinite(vm["lpips"]), f"{name} validation LPIPS {vm['lpips']}")
    print(f"{name} step breakdown on the card (CUDA events, {cfg.compute_dtype}, batch {cfg.batch_size}): "
          f"chain {breakdown['chain_ms']:.2f} ms (USM {breakdown['usm_ms']:.2f}, {len(seen_filters)} filter2d "
          f"kernels {breakdown['chain_filter2d_ms']:.2f} at {breakdown['chain_filter2d_shapes']}); generator "
          f"forward {breakdown['forward_ms']:.2f} ms, forward+backward (L1) {breakdown['g_forward_backward_ms']:.2f} "
          f"ms" + (f"; D update (2 forwards on GT and SR, backward, Adam) {breakdown['d_update_ms']:.2f} ms; content "
                   f"(VGG19 on SR and the USM GT, backward to SR) {breakdown['content_forward_backward_ms']:.2f} ms; "
                   f"adversarial (D on SR, backward to SR) {breakdown['adversarial_forward_backward_ms']:.2f} ms"
                   if gan else "")
          + f"; whole train step {breakdown['train_step_ms']:.2f} ms; validation of 4 frames "
          f"{breakdown['validation_ms']:.2f} ms host clock"
          + (f" (LPIPS alone {breakdown['lpips_ms']:.2f} ms)" if gan else ""), flush=True)
    d_final = {k: v.detach().clone() for k, v in state.d_model.state_dict().items()} if gan else None
    numbers = {
        "steps": n_steps, "validation_batches": n_valid, "validation": scores, "best_epoch": best["epoch"],
        "step_ms_p50": step_p50, "inside_step_ms_p50": float(np.median(inside[1:])), "first_step_ms": inside[0],
        "frames_per_s": cfg.batch_size * 1e3 / step_p50, "peak_memory_gb": peak_gb, "run_s": run_s,
        "filter2d_per_chain": calls["filter2d"] / (n_steps + n_valid), **breakdown,
    }
    del g, state, result, trainer, batch, seen_filters, lpips_fn
    torch.cuda.empty_cache()
    return calls, numbers, {"host": host, "d_final": d_final}


def re_jpeg_free_chain(cfg, host, f2d, filters) -> dict:
    """The Real-ESRGAN chain of adapter step 0 on the host batch, its
    noise and both JPEGs switched off (sigma and Poisson scale 0, the
    quality-0 skip), with the filter2d kernel against filter2d_ref: what
    is left is the blurs, the resizes and the 8-bit quantisation, held as
    the chain goldens are (one 8-bit level at most, under 1% of the
    elements off). With JPEG on, a value that moves by the kernels'
    ~1e-6 can round a DCT coefficient the other way and move its 8x8
    block by a quantisation step."""
    import dataclasses

    from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
    from srganfd_tpu_torch.ops.realesrgan_degrade import apply_realesrgan_batch, plan_realesrgan_batch, usm_sharp

    rng = DegradationAdapter(cfg, seed=cfg.seed, device="cpu").step_rng(0)
    plan = plan_realesrgan_batch(rng, RE_BATCH, (RE_GT, RE_GT), cfg.upscale_factor, cfg.degradation_params["process"])
    z = np.zeros(RE_BATCH, np.float32)
    plan = dataclasses.replace(plan, noise1_sigma=z, noise1_poisson_scale=z, noise2_sigma=z, noise2_poisson_scale=z,
                               jpeg1_quality=z - 1, jpeg2_quality=z - 1)
    dev = lambda k: torch.from_numpy(np.ascontiguousarray(host[k])).cuda()  # noqa: E731
    gt = usm_sharp(dev("gt"))
    ks = [dev(k) for k in ("kernel1", "kernel2", "sinc_kernel")]
    run = lambda: apply_realesrgan_batch(gt, *ks, torch.Generator(device="cuda").manual_seed(0), plan)  # noqa: E731
    before = f2d.launches
    got = run()
    made = f2d.launches - before
    orig = filters.filter2d
    filters.filter2d = f2d.filter2d_ref
    try:
        want = run()
    finally:
        filters.filter2d = orig
    diff = (got - want).abs()
    out = {"max_abs": diff.max().item(), "off_level_share": (diff > 1e-5).float().mean().item(),
           "filter2d_launches": made}
    print(f"realesrgan chain without noise and JPEG, filter2d kernel vs plain ({made} launches): max abs "
          f"{out['max_abs']:.3g}, {100 * out['off_level_share']:.4f}% of the elements off a level", flush=True)
    check(made == 2 + plan.second_blur, f"the JPEG-free chain made {made} filter2d calls")
    check(out["max_abs"] <= 1 / 255 + 1e-5 and out["off_level_share"] < 0.01, f"JPEG-free chain: {out}")
    return out


def re_f32_check(work: str, host, d_final, rdb, f2d, blocks, filters) -> dict:
    """One f32 ``realesrgan`` step with the kernels against the same step
    with their plain versions, on one batch of 48 (the kernel chain's),
    from the trained state: G from the realesrnet phase's last checkpoint,
    D and its u from the realesrgan phase's end. The full step is held by
    step_check's LIMITS apart from G: the loss parts to 1e-5, the slope
    flips to 250, D and u to 1e-3. Its content term makes the updated G's
    reading depend on the forward's rounding (3.7e-4 - 1.9e-3 inside and
    outside the flipped channels on the H100, where the same step without
    it reads 6e-7: PERF.md section 6), so G is held by LIMITS on
    that step: the content loss off, the adversarial term on. The chain's
    LR against the plain chain's (one generator state) goes through two
    DiffJPEGs, whose coefficient rounding can turn the kernels' ~1e-6 into
    a block's quantisation step: it is held to the DiffJPEG envelope of the
    chain goldens (max 0.05), the mean to 1e-4 and the share of elements
    off a level to 1%; the same chain without noise and JPEG is held to
    one level (``re_jpeg_free_chain``)."""
    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.convert import load_generator_weights
    from srganfd_tpu_torch.train import step_check

    cfg = configs.get_config("realesrgan").replace(results_dir=os.path.join(work, "results"))
    g_init = load_generator_weights(os.path.join(work, "results", configs.get_config("realesrnet").exp_name,
                                                 "ckpt_last.pth"))
    n_filters = re_expected_filters(cfg, cfg.seed, [0], RE_BATCH)
    f32, runs = f32_step_vs_plain(cfg, host, rdb, f2d, blocks, filters, init=(g_init, d_final),
                                  label="realesrgan (realesrnet-trained G, realesrgan-trained D)",
                                  filters_per_chain=n_filters)
    (_, _, d_k), (_, _, d_p) = runs
    kept = lambda sd, u: {k: v for k, v in sd.items() if k.endswith(".u") == u}  # noqa: E731
    f32["d_rel"], f32["d_worst"] = _rel_per_tensor(kept(d_k, False), kept(d_p, False))
    f32["u_rel"], f32["u_worst"] = _rel_per_tensor(kept(d_k, True), kept(d_p, True))
    print(f"f32 realesrgan step (trained state): chain LR mean abs {f32['lr_mean_abs']:.3g}, off by more than "
          f"1e-5 on {100 * f32['lr_off_level_share']:.4f}% of its elements; updated D per tensor max relative "
          f"{f32['d_rel']:.3g} ({f32['d_worst']}), u {f32['u_rel']:.3g}", flush=True)
    limits = {**step_check.LIMITS, "lr_max_abs": 0.05, "lr_mean_abs": 1e-4, "lr_off_level_share": 0.01,
              "d_rel": 1e-3, "u_rel": 1e-3}
    g_limits = {k: limits.pop(k) for k in ("g_outside", "g_inside")}
    failed = step_check.step_check_failures(f32, limits)
    check(not failed, f"f32 realesrgan step vs plain: {failed}")
    f32["jpeg_free_chain"] = re_jpeg_free_chain(cfg, host, f2d, filters)
    # G, held on the step without the content term; the step with the
    # adversarial weight 0 (content on) printed beside it
    f32["variants"] = {}
    for name, over in (("no content loss", {"content_weight": ()}),
                       ("adversarial weight 0", {"adversarial_weight": (0.0,)})):
        r, _ = f32_step_vs_plain(cfg.replace(**over), host, rdb, f2d, blocks, filters, init=(g_init, d_final),
                                 label=f"realesrgan, {name}, trained state", filters_per_chain=n_filters)
        f32["variants"][name] = {k: r[k] for k in ("sr_in_range", "loss_rel", "slope_flips", "g_outside",
                                                   "g_outside_worst", "g_inside", "g_inside_worst")}
    failed = step_check.step_check_failures(f32["variants"]["no content loss"],
                                            {**g_limits, "loss_rel": limits["loss_rel"],
                                             "slope_flips": limits["slope_flips"]})
    check(not failed, f"f32 realesrgan step without the content loss vs plain: {failed}")
    return f32


def ae_train_phase(work: str, rdb, f2d, blocks, filters) -> tuple[dict, dict]:
    """Full-width ``aesrgan`` (the config unchanged: bsrgantrans_x2 64/32/23
    against uNetDiscriminatorAesrgan with 64 features, batch 8, pre-crop
    150, GT 120, bf16, VGG19 content over five nodes on the seeded
    surrogate unless $SRGANFD_VGG19_NPZ names a file, BCE x 0.1, LPIPS
    selection) through cli.train.run_train on the bsrnet phase's frames:
    one epoch of AE_STEPS_PER_EPOCH steps, then --resume auto for a
    second; one step of the multi-scale ensemble; one f32 step held to its
    plain twin from the trained state; cli.infer --use-ema on ckpt_best.
    Returns the kernel calls of the training runs and the numbers."""
    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli import infer
    from srganfd_tpu_torch.cli import train as cli_train
    from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
    from srganfd_tpu_torch.convert import load_generator_weights
    from srganfd_tpu_torch.data.datasets import BatchLoader
    from srganfd_tpu_torch.losses.lpips import Lpips
    from srganfd_tpu_torch.ops.degrade import apply_bsrgan_batch_cropped, bsrgan_lr_size, plan_bsrgan_batch
    from srganfd_tpu_torch.train import checkpoint as ckpt
    from srganfd_tpu_torch.train import step_check
    from srganfd_tpu_torch.train.loop import Trainer, _bce_scales, _first

    cfg = configs.get_config("aesrgan").replace(
        train_gt_images_dir=os.path.join(work, "train_gt"), valid_gt_images_dir=os.path.join(work, "valid_gt"),
        results_dir=os.path.join(work, "results"), samples_dir=os.path.join(work, "samples"),
    )
    print(f"aesrgan: {cfg.g_arch} {cfg.g_kwargs or 'full width (64/32/23, 2 encoder layers of 4 heads, FFN 2048)'} "
          f"against {cfg.d_arch} {cfg.d_kwargs or '64 features'}, batch {cfg.batch_size}, pre-crop "
          f"{cfg.crop_image_size}, GT {cfg.gt_image_size}, {cfg.compute_dtype}; pixel {cfg.pixel_weight} + content "
          f"{cfg.content_weight} + adversarial {cfg.adversarial_weight}; Adam g {cfg.model_lr} / d "
          f"{cfg.discriminator_lr} eps {cfg.model_eps}; selection by {cfg.optimizing_metric}", flush=True)

    metrics_seen, steps, restored = [], [], []
    real_step, real_restore = Trainer.train_step, ckpt.restore_state

    def recorded_step(self, state, gt, lr_img, gt_pixel=None):
        entry = time.perf_counter()
        index = state.step
        m = real_step(self, state, gt, lr_img, gt_pixel)
        metrics_seen.append({k: v.item() for k, v in m.items()})  # waits for the step
        steps.append((index, entry, time.perf_counter()))
        return m

    def recorded_restore(state, payload):
        real_restore(state, payload)
        same = lambda a, b: all(torch.equal(torch.as_tensor(a[k]).cpu(), torch.as_tensor(b[k]).cpu())  # noqa: E731
                                for k in b)
        restored.append({
            "step": state.step,
            "d": same(state.d_model.state_dict(), payload["d_state_dict"]),
            "adams": all(same(o.state_dict()["state"][i], payload[key]["state"][i])
                         for o, key in ((state.g_opt, "optimizer"), (state.d_opt, "d_optimizer"))
                         for i in payload[key]["state"]),
        })

    Trainer.train_step, ckpt.restore_state = recorded_step, recorded_restore
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rdb.launches = f2d.launches = 0
    try:
        run_s = []
        for epochs, resume in ((AE_EPOCHS, ""), (AE_EPOCHS + 1, "auto")):
            t0 = time.perf_counter()
            result = cli_train.run_train(cfg.replace(epochs=epochs), AE_STEPS_PER_EPOCH, resume=resume,
                                         device="cuda")
            torch.cuda.synchronize()
            run_s.append(time.perf_counter() - t0)
    finally:
        Trainer.train_step, ckpt.restore_state = real_step, real_restore
    calls = {"rdb": rdb.launches, "filter2d": f2d.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = AE_STEPS_PER_EPOCH * (AE_EPOCHS + 1)
    n_valid = AE_EPOCHS + 1  # one batch of the 4 valid frames per epoch
    check(len(metrics_seen) == n_steps, f"{len(metrics_seen)} aesrgan steps, expected {n_steps}")
    check(all(math.isfinite(v) for m in metrics_seen for v in m.values()), f"non-finite aesrgan metrics: {metrics_seen}")
    check(all(0 < m[k] < 1 for m in metrics_seen for k in ("d_gt_probability", "d_sr_probability")),
          f"a D probability outside (0, 1): {metrics_seen}")
    check(calls == {"rdb": RDB_PER_FORWARD * (n_steps + n_valid),
                    "filter2d": FILTERS_PER_CHAIN * (n_steps + n_valid)},
          f"aesrgan training made {calls} kernel calls for {n_steps} steps and {n_valid} validation batches")
    state = result["state"]
    check(state.step == n_steps, f"resumed aesrgan run ended at step {state.step}")
    check(len(restored) == 1 and restored[0]["step"] == AE_STEPS_PER_EPOCH, f"aesrgan restores: {restored}")
    check(steps[AE_STEPS_PER_EPOCH][0] == AE_STEPS_PER_EPOCH, f"the resumed aesrgan run's first step was "
          f"{steps[AE_STEPS_PER_EPOCH][0]}")
    check(restored[0]["d"] and restored[0]["adams"],
          f"the resumed aesrgan D (u, running statistics) or Adams are not the checkpoint's: {restored}")
    with open(os.path.join(cfg.samples_dir, "logs", cfg.exp_name, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    lpips = [e["metrics"]["Valid/LPIPS"] for e in events if e["type"] == "metrics" and "Valid/LPIPS" in e["metrics"]]
    check(len(lpips) == n_valid and all(math.isfinite(v) for v in lpips), f"aesrgan validation LPIPS {lpips}")
    ckpt_dir = os.path.join(cfg.results_dir, cfg.exp_name)
    best = ckpt.load_checkpoint(os.path.join(ckpt_dir, "ckpt_best.pth"))
    check(best["epoch"] == int(np.argmin(lpips)), f"aesrgan ckpt_best.pth is epoch {best['epoch']}, LPIPS {lpips}")
    last = ckpt.load_checkpoint(os.path.join(ckpt_dir, "ckpt_last.pth"))
    check(all(torch.equal(last["d_state_dict"][k], v.cpu()) for k, v in state.d_model.state_dict().items()),
          "aesrgan ckpt_last.pth is not the final D")
    stats = [k for k in last["d_state_dict"] if k.endswith(("running_mean", "running_var"))]
    check(len(stats) == 6, f"the attention D's checkpoint holds {stats}")

    intervals = [(b[2] - a[2]) * 1e3 for a, b in zip(steps, steps[1:])
                 if b[0] == a[0] + 1 and b[0] % AE_STEPS_PER_EPOCH]
    inside = [(end - entry) * 1e3 for _, entry, end in steps]
    step_p50 = float(np.median(intervals))
    print(f"aesrgan training: metrics {[{k: round(v, 5) for k, v in m.items()} for m in metrics_seen]}", flush=True)
    print(f"aesrgan training: {n_steps} steps + {n_valid} validation batches in {[round(t, 2) for t in run_s]} s; "
          f"step p50 {step_p50:.2f} ms host clock over {len(intervals)} steps "
          f"({cfg.batch_size * 1e3 / step_p50:.2f} frames/s), inside train_step p50 {np.median(inside[1:]):.2f} ms, "
          f"the first step {inside[0]:.1f} ms; validation LPIPS by epoch {lpips}, ckpt_best.pth epoch "
          f"{best['epoch']}; resumed at step {restored[0]['step']}; peak memory {peak_gb:.2f} GB; {calls} kernel "
          f"calls (per forward {calls['rdb'] // (n_steps + n_valid)} rdb_forward, per chain "
          f"{calls['filter2d'] // (n_steps + n_valid)} filter2d)", flush=True)

    # where one step's time goes, on the card (CUDA events), on the trained state
    loader = BatchLoader(cli_train.build_datasets(cfg)[0], cfg.batch_size, seed=cfg.seed, num_workers=2)
    it = iter(loader)
    host = next(it)
    it.close()
    gt_dev = torch.from_numpy(host["gt"]).cuda()
    plan = plan_bsrgan_batch(np.random.default_rng(0), cfg.batch_size, cfg.upscale_factor)
    lim = bsrgan_lr_size(gt_dev.shape[1], plan) - cfg.gt_image_size // cfg.upscale_factor
    tops = np.random.default_rng(1).integers(0, lim + 1, cfg.batch_size)
    chain = lambda: apply_bsrgan_batch_cropped(gt_dev, plan, tops, tops, cfg.gt_image_size, cfg.upscale_factor)  # noqa: E731
    gt_c, lr_c = chain()
    check(tuple(lr_c.shape) == (cfg.batch_size, 60, 60, 3), f"aesrgan LR batch {tuple(lr_c.shape)}")
    trainer = Trainer(cfg, AE_STEPS_PER_EPOCH, device="cuda")
    g, d = state.g_model, state.d_model
    before = rdb.launches
    with torch.no_grad():
        g(lr_c)
    check(rdb.launches - before == RDB_PER_FORWARD, f"an aesrgan G forward made {rdb.launches - before} rdb calls")

    def g_fwd_bwd():
        (g(lr_c) - gt_c).abs().mean().backward()

    sr = g(lr_c).detach()
    sr_leaf = sr.clone().requires_grad_()

    def content_fwd_bwd():
        trainer.content_loss(sr_leaf, gt_c).backward(inputs=[sr_leaf])

    def adversarial_fwd_bwd():
        _bce_scales(_first(d(sr_leaf, update_stats=False)), 1.0).backward(inputs=[sr_leaf])

    with torch.inference_mode():
        breakdown = {"chain_ms": cuda_ms(chain, iters=5, warmup=1),
                     "forward_ms": cuda_ms(lambda: g(lr_c), iters=5, warmup=1)}
    breakdown.update({
        "g_forward_backward_ms": cuda_ms(g_fwd_bwd, iters=3, warmup=1),
        "d_update_ms": cuda_ms(lambda: trainer._d_update(state, gt_c, sr), iters=3, warmup=1),
        "content_forward_backward_ms": cuda_ms(content_fwd_bwd, iters=3, warmup=1),
        "adversarial_forward_backward_ms": cuda_ms(adversarial_fwd_bwd, iters=3, warmup=1),
        "train_step_ms": cuda_ms(lambda: real_step(trainer, state, gt_c, lr_c), iters=3, warmup=1),
    })
    valid_adapter = DegradationAdapter(cfg, seed=cfg.seed + 1, train=True, device="cuda")
    valid_loader = lambda: BatchLoader(cli_train.build_datasets(cfg)[1], 4, shuffle=False, loop=False,  # noqa: E731
                                       seed=cfg.seed, drop_last=True, num_workers=1)
    lpips_fn = Lpips().to("cuda")
    vb = valid_adapter(next(iter(valid_loader())), 0)
    vsr = trainer.eval_sr(state, vb["lr"])
    with torch.inference_mode():
        breakdown["lpips_ms"] = cuda_ms(lambda: lpips_fn(vsr, vb["gt"]), iters=5, warmup=1)
    t0 = time.perf_counter()
    vm = cli_train.validate(cfg, trainer, state, valid_loader(), valid_adapter, lpips_fn=lpips_fn)
    torch.cuda.synchronize()
    breakdown["validation_ms"] = (time.perf_counter() - t0) * 1e3
    check(math.isfinite(vm["lpips"]), f"aesrgan validation LPIPS {vm['lpips']}")
    print(f"aesrgan step breakdown on the card (CUDA events, {cfg.compute_dtype}, batch {cfg.batch_size}): "
          f"chain {breakdown['chain_ms']:.2f} ms; G forward {breakdown['forward_ms']:.2f} ms, forward+backward (L1) "
          f"{breakdown['g_forward_backward_ms']:.2f} ms; D update (2 forwards on GT and SR, backward, Adam) "
          f"{breakdown['d_update_ms']:.2f} ms; content (VGG19 on SR and GT, backward to SR) "
          f"{breakdown['content_forward_backward_ms']:.2f} ms; adversarial (D on SR, backward to SR) "
          f"{breakdown['adversarial_forward_backward_ms']:.2f} ms; whole train step {breakdown['train_step_ms']:.2f} "
          f"ms; validation of 4 frames with LPIPS {breakdown['validation_ms']:.2f} ms host clock (LPIPS alone "
          f"{breakdown['lpips_ms']:.2f} ms)", flush=True)
    d_final = {k: v.detach().clone() for k, v in d.state_dict().items()}
    g_final = {k: v.detach().clone() for k, v in g.state_dict().items()}
    del g, d, state, result, trainer, sr, sr_leaf, lpips_fn, vsr
    torch.cuda.empty_cache()

    # One step of the multi-scale ensemble through run_train, at GT AE_MS_GT
    ms_cfg = cfg.replace(d_arch="discriminator_attention_unet_ms", gt_image_size=AE_MS_GT, epochs=1,
                         results_dir=os.path.join(work, "results_ms"), samples_dir=os.path.join(work, "samples_ms"))
    ms_metrics = []

    def ms_step(self, *args):
        m = real_step(self, *args)
        ms_metrics.append({k: v.item() for k, v in m.items()})
        return m

    Trainer.train_step = ms_step
    rdb.launches = f2d.launches = 0
    try:
        t0 = time.perf_counter()
        ms_result = cli_train.run_train(ms_cfg, 1, device="cuda")
        torch.cuda.synchronize()
        ms_s = time.perf_counter() - t0
    finally:
        Trainer.train_step = real_step
    ms_calls = {"rdb": rdb.launches, "filter2d": f2d.launches}
    ms_d = ms_result["state"].d_model
    check(len(ms_metrics) == 1 and all(math.isfinite(v) for v in ms_metrics[0].values())
          and all(0 < ms_metrics[0][k] < 1 for k in ("d_gt_probability", "d_sr_probability")),
          f"the ensemble step's metrics {ms_metrics}")
    check(type(ms_d).__name__ == "MultiScaleAttentionDiscriminator" and hasattr(ms_d, "D1"),
          f"the ensemble run trained {type(ms_d).__name__}")
    check(ms_calls == {"rdb": 2 * RDB_PER_FORWARD, "filter2d": 2 * FILTERS_PER_CHAIN},
          f"the ensemble run made {ms_calls} kernel calls for 1 step and 1 validation batch")
    print(f"aesrgan with --d-arch discriminator_attention_unet_ms (GT {AE_MS_GT}): 1 step + 1 validation batch in "
          f"{ms_s:.2f} s, metrics { {k: round(v, 5) for k, v in ms_metrics[0].items()} }, {ms_calls} kernel calls",
          flush=True)
    del ms_result, ms_d
    torch.cuda.empty_cache()

    # One f32 step held to its plain twin, from this phase's trained state
    # (G, and D with its u and running statistics): the loss parts, the
    # slope flips and G by step_check's LIMITS; D and u to 1e-3 as the
    # bsrgan check holds them; the gates' running mean and variance, which
    # the D update writes from the GT and SR batches, to 1e-5 of each
    # tensor's largest entry. The bias of the 1x1 conv before each gate's
    # BatchNorm has no gradient in exact arithmetic (the batch mean takes
    # it out): both runs step it by Adam on roundoff, so what the two runs
    # read there is noise against noise (1.1e-3 - 2.4e-3 of its largest
    # entry, 2.6e-8 apart, with correct kernels on an H100 80GB HBM3 at
    # 700 W: PERF.md section 6). Those three are printed, not held; the CPU tests hold
    # their gradient against JAX's (test_torch_aesrgan_model.py).
    f32, runs = f32_step_vs_plain(cfg, host, rdb, f2d, blocks, filters, init=(g_final, d_final),
                                  label="aesrgan (aesrgan-trained G and D)")
    (_, _, d_k), (_, _, d_p) = runs

    def kind(k):
        if k.endswith(".u"):
            return "u"
        if k.endswith(("running_mean", "running_var")):
            return "bn"
        return "pre_bn_bias" if k.endswith("W.0.bias") else "d"

    kept = lambda sd, c: {k: v for k, v in sd.items() if kind(k) == c}  # noqa: E731
    f32["d_rel"], f32["d_worst"] = _rel_per_tensor(kept(d_k, "d"), kept(d_p, "d"))
    f32["u_rel"], f32["u_worst"] = _rel_per_tensor(kept(d_k, "u"), kept(d_p, "u"))
    f32["bn_rel"], f32["bn_worst"] = _rel_per_tensor(kept(d_k, "bn"), kept(d_p, "bn"))
    pre_bn = kept(d_p, "pre_bn_bias")
    check(len(pre_bn) == 3, f"pre-BatchNorm biases {sorted(pre_bn)}")
    f32["pre_bn_bias_abs"] = max((d_k[k] - v).abs().max().item() for k, v in pre_bn.items())
    f32["pre_bn_bias_max"] = max(v.abs().max().item() for v in pre_bn.values())
    f32["pre_bn_bias_rel"] = _rel_per_tensor(kept(d_k, "pre_bn_bias"), pre_bn)[0]
    print(f"f32 aesrgan step (trained state): updated D per tensor max relative {f32['d_rel']:.3g} "
          f"({f32['d_worst']}), u {f32['u_rel']:.3g}, the gates' running statistics {f32['bn_rel']:.3g} "
          f"({f32['bn_worst']}); the pre-BatchNorm biases (no gradient; not held) {f32['pre_bn_bias_abs']:.3g} "
          f"apart, {f32['pre_bn_bias_rel']:.3g} of their largest entry {f32['pre_bn_bias_max']:.3g}", flush=True)
    failed = step_check.step_check_failures(f32, {**step_check.LIMITS, "d_rel": 1e-3, "u_rel": 1e-3, "bn_rel": 1e-5})
    check(not failed, f"f32 aesrgan step vs plain: {failed}")

    # cli.infer --use-ema on ckpt_best.pth: a GT-sized frame (120x120, 60x60
    # tokens at full attention, as the config trains)
    import cv2

    frame = os.path.join(work, "ae_frame.png")
    cv2.imwrite(frame, cv2.imread(os.path.join(cfg.valid_gt_images_dir, "gt_000.png"))[:cfg.gt_image_size,
                                                                                       :cfg.gt_image_size])
    out_png = os.path.join(work, "ae_sr.png")
    rdb.launches = 0
    infer.main(["--model-arch", cfg.g_arch, "--weights", os.path.join(ckpt_dir, "ckpt_best.pth"), "--use-ema",
                "--inputs-path", frame, "--output-path", out_png])
    img = cv2.imread(out_png)
    want = (2 * cfg.gt_image_size, 2 * cfg.gt_image_size, 3)
    check(img is not None and img.shape == want, f"infer of the aesrgan EMA-G: {img is None or img.shape}")
    check(rdb.launches == RDB_PER_FORWARD, f"infer of the aesrgan EMA-G: {rdb.launches} rdb calls")
    sd = load_generator_weights(os.path.join(ckpt_dir, "ckpt_best.pth"), use_ema=True)
    check(any(k.startswith("transformer.") for k in sd), "the aesrgan checkpoint holds no transformer")
    print(f"cli.infer --model-arch {cfg.g_arch} --use-ema on ckpt_best.pth: {cfg.gt_image_size}x{cfg.gt_image_size} "
          f"-> {img.shape[1]}x{img.shape[0]}, {RDB_PER_FORWARD} rdb calls", flush=True)
    numbers = {
        "steps": n_steps, "validation_batches": n_valid, "metrics": metrics_seen, "validation_lpips": lpips,
        "best_epoch": best["epoch"], "step_ms_p50": step_p50, "inside_step_ms_p50": float(np.median(inside[1:])),
        "first_step_ms": inside[0], "frames_per_s": cfg.batch_size * 1e3 / step_p50, "peak_memory_gb": peak_gb,
        "run_s": run_s, **breakdown, "ensemble_step": {"gt": AE_MS_GT, "metrics": ms_metrics[0], "s": ms_s,
                                                       "calls": ms_calls},
        "f32_step_vs_plain": f32,
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
    filter_entry["realesrgan"] = re_filter2d_phase(f2d)
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
        re_launches, re_forward_ms, re_f32_launches = re_serve_phase(work, rdb, blocks)
        train_launches, train = train_phase(work, rdb, f2d, blocks, filters)
        gan_launches, gan = gan_train_phase(work, rdb, f2d, blocks, filters)
        ren_launches, ren, _ = re_train_phase(work, "realesrnet", rdb, f2d, blocks, filters)
        reg_launches, reg, reg_state = re_train_phase(work, "realesrgan", rdb, f2d, blocks, filters)
        reg["f32_step_vs_plain"] = re_f32_check(work, reg_state["host"], reg_state["d_final"], rdb, f2d, blocks,
                                                filters)
        del reg_state
        ae_launches, ae = ae_train_phase(work, rdb, f2d, blocks, filters)
    launches += (trans_launches["rdb"] + trans_infer["rdb"] + train_launches["rdb"] + gan_launches["rdb"]
                 + re_launches + ren_launches["rdb"] + reg_launches["rdb"] + ae_launches["rdb"])
    flash_launches = trans_launches["flash"] + trans_infer["flash"]
    check(launches > 0, "the main paths launched no rdb_forward kernel")
    check(flash_launches > 0, "the bsrgantrans_x2 path launched no flash_attention kernel")
    entry["launches"] = launches
    # of which f32 (the 3xTF32 kernels): the f32 stdio requests
    entry["launches_f32"] = f32_launches + trans_f32["rdb"] + re_f32_launches
    entry["launches_per_forward"] = RDB_PER_FORWARD
    entry["forward_ms"] = forward_ms  # bsrgan_x2 at 256x256, whole generator
    entry["realesrgan_forward_ms"] = re_forward_ms  # realesrgan_x4 at 128x128, realesrgan_x2 at 250x190
    entry["realesrgan_serve_launches"] = re_launches
    flash_entry["launches"] = flash_launches
    flash_entry["launches_f32"] = trans_f32["flash"]
    flash_entry["launches_per_forward"] = ATTN_PER_FORWARD
    flash_entry["forward_ms"] = trans_forward_ms  # bsrgantrans_x2 at 256x256, whole generator
    flash_entry["transformer_ms"] = transformer_ms  # its two encoder layers
    check(train_launches["filter2d"] > 0, "the training path launched no filter2d kernel")
    check(gan_launches["filter2d"] > 0, "the bsrgan training path launched no filter2d kernel")
    entry["train_launches"] = train_launches["rdb"]
    entry["gan_launches"] = gan_launches["rdb"]
    entry["realesrnet_launches"] = ren_launches["rdb"]
    entry["realesrgan_launches"] = reg_launches["rdb"]
    entry["aesrgan_launches"] = ae_launches["rdb"]
    check(ren_launches["filter2d"] > 0 and reg_launches["filter2d"] > 0,
          "a Real-ESRGAN training path launched no filter2d kernel")
    check(ae_launches["rdb"] > 0 and ae_launches["filter2d"] > 0, "the aesrgan training path launched no kernel")
    filter_entry["launches"] = (train_launches["filter2d"] + gan_launches["filter2d"] + ren_launches["filter2d"]
                                + reg_launches["filter2d"] + ae_launches["filter2d"])
    filter_entry["aesrgan_launches"] = ae_launches["filter2d"]
    filter_entry["realesrnet_launches"] = ren_launches["filter2d"]
    filter_entry["realesrgan_launches"] = reg_launches["filter2d"]
    filter_entry["gan_launches"] = gan_launches["filter2d"]
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
    print(f"bsrgan step (bf16, batch 16): {gan['train_step_ms']:.2f} ms on the card, of which G "
          f"forward+backward {gan['g_forward_backward_ms']:.2f} ms, the D update {gan['d_update_ms']:.2f} ms, "
          f"content {gan['content_forward_backward_ms']:.2f} ms, adversarial "
          f"{gan['adversarial_forward_backward_ms']:.2f} ms; the chain {gan['chain_ms']:.2f} ms; host-clock step "
          f"p50 {gan['step_ms_p50']:.2f} ms; validation {gan['validation_ms']:.2f} ms", flush=True)
    for name, r in (("realesrnet", ren), ("realesrgan", reg)):
        parts = (f", the D update {r['d_update_ms']:.2f} ms, content {r['content_forward_backward_ms']:.2f} ms, "
                 f"adversarial {r['adversarial_forward_backward_ms']:.2f} ms" if name == "realesrgan" else "")
        print(f"{name} step (bf16, batch {RE_BATCH}, GT {RE_GT}): {r['train_step_ms']:.2f} ms on the card, of which "
              f"G forward+backward {r['g_forward_backward_ms']:.2f} ms (69 RDB kernels at {RE_RDB_SHAPE} alone "
              f"{RDB_PER_FORWARD * entry['realesrgan_train_kernel_ms']:.2f} ms){parts}; the chain "
              f"{r['chain_ms']:.2f} ms (USM {r['usm_ms']:.2f}, filter2d {r['chain_filter2d_ms']:.2f}); host-clock "
              f"step p50 {r['step_ms_p50']:.2f} ms; peak memory {r['peak_memory_gb']:.2f} GB", flush=True)
    print(f"aesrgan step (bf16, batch 8, GT 120): {ae['train_step_ms']:.2f} ms on the card, of which G "
          f"forward+backward {ae['g_forward_backward_ms']:.2f} ms (69 RDB kernels at {AE_RDB_SHAPE} alone "
          f"{RDB_PER_FORWARD * entry['aesrgan_train_kernel_ms']:.2f} ms), the D update {ae['d_update_ms']:.2f} ms, "
          f"content {ae['content_forward_backward_ms']:.2f} ms, adversarial "
          f"{ae['adversarial_forward_backward_ms']:.2f} ms; the chain {ae['chain_ms']:.2f} ms; host-clock step p50 "
          f"{ae['step_ms_p50']:.2f} ms; peak memory {ae['peak_memory_gb']:.2f} GB", flush=True)
    # last, so that no timed phase runs after a profiler session
    q, k, v = (t.transpose(1, 2) for t in flash_inputs(FLASH_SHAPE, seed=100))
    flash_entry["library_f32_kernels"] = sdpa_kernels(q, k, v)
    print(f"scaled_dot_product_attention f32 at q {FLASH_SHAPE} launches {flash_entry['library_f32_kernels']}",
          flush=True)
    print(json.dumps({"train": {k: v for k, v in train.items() if k != "losses"}}))
    print(json.dumps({"gan": {k: v for k, v in gan.items() if k != "metrics"}}))
    print(json.dumps({"realesrnet": ren}))
    print(json.dumps({"realesrgan": reg}))
    print(json.dumps({"aesrgan": {k: v for k, v in ae.items() if k != "metrics"}}))
    print(smi)
    print(json.dumps({"kernels": [entry, flash_entry, filter_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
