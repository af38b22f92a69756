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
upsamples), and trains four recipes at full width: ``bsrgan_x2``, the L1
pretrain (``bsrnet``) and then the GAN stage (``bsrgan``);
``realesrgan_x4``, ``realesrnet`` and then ``realesrgan``;
``bsrgantrans_x2`` against the attention-gated U-Net (``aesrgan``); and
``rrdbnet_x4``, ``rrdbnet`` and then ``esrgan`` (ESRGAN's two stages);
then ``bsrgan`` against the self-attention U-Net (``--d-arch
discriminator_unet_sa``), evaluates the trained checkpoints with
``cli.test``, serves ``bsrgan_x2`` over HTTP with the micro-batcher, and
drives A-ESRGAN's generators ``gen_rrdb2x`` and ``gen_rpa2x``:

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
   the training shapes and at ``gen_rrdb2x``'s (1, 128, 128, 64) (a 256x256
   frame after its unshuffle), beside the card's bounds (f32: on the CUDA cores,
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
7. the RDB under autograd, f32 and bf16, at the training shape x (16, 72,
   72, 64) and a ragged (2, 37, 45, 64): one forward and one backward
   kernel call (``csrc/rdb_bwd.cu``, with ``rdb_forward_ref`` made to raise
   during the backward), the gradients of x, the kernels and the biases
   against ``rdb_backward_ref`` on the same saved ``feat`` (max |a - b| /
   max |b| per tensor: f32 1e-5 against it in f64, bf16 1e-2), once with x
   not requiring a gradient; autograd through the recomputed
   ``rdb_forward_ref`` beside it (1e-4 / 1e-2 when no LeakyReLU slope
   differs between the kernel's feat and the recompute, the count
   printed); at the training shape CUDA-graph times of each conv's dgrad
   and wgrad, the sums and the whole backward beside its bound, the plain
   version, autograd through the five cuDNN convs (bf16, f32 with TF32 off
   and on), and one forward and forward+backward of ``rdb_apply``;
8. training: ``cli.train.run_train`` on the ``bsrnet`` config unchanged
   (full-width ``bsrgan_x2``, batch 16, pre-crop 320, GT 144, bf16) over
   seeded synthetic frames, 2 epochs of 6 steps, then ``--resume auto``
   for a third; every forward must make 69 RDB kernel calls, every step
   69 RDB backward kernel calls (``launches_bwd``, in every training phase
   below too) and every chain 2 filter2d kernel calls; one more step runs
   with ``rdb_forward_ref`` raising on a CUDA tensor. Both checkpoints load as weights and
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
   the epoch of the lowest; G and EMA-G start from the bsrnet run's
   ``ckpt_last.pth`` (``--pretrained-g``), as the recipe's second stage
   does, and equal it at step 0. CUDA-event times of one step and its parts (G
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
    LPIPS, ``realesrgan``'s G and EMA-G the realesrnet run's at step 0
    (``--pretrained-g``); CUDA-event times of a step and its parts (the chain with USM's
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
    ``cli.infer --use-ema`` on ``ckpt_best.pth``;
15. ESRGAN training: ``cli.train.run_train`` on ``rrdbnet`` and then
    ``esrgan``, the configs unchanged (``rrdbnet_x4`` 64/32/23, batch 16,
    MATLAB-bicubic LR, bf16; ``rrdbnet`` at GT 192 on L1; ``esrgan`` at GT
    128 against the VGG-128 D with c = 64 and BatchNorm, VGG19 content at
    ``features.34``, the relativistic loss, the G step first, LPIPS
    selection, started with ``--pretrained-g`` from rrdbnet's
    ``ckpt_last.pth``, G and EMA-G equal to its G at step 0) on the bsrnet
    phase's frames: one epoch of 4 steps each, then ``--resume auto`` for a
    second (step, G, EMA-G, D with its running statistics and both Adams
    as the checkpoint held them); 69 RDB kernel calls a forward; one step
    with ``--pretrained-d`` on esrgan's checkpoint (D and its running
    statistics the file's, its Adam fresh); CUDA-event times of each
    stage's step and its parts; the RDB kernel timed at x (16, 48, 48, 64)
    and (16, 32, 32, 64) in the kernel phase; one f32 esrgan step held to
    its plain twin from esrgan's ``ckpt_last.pth`` restored whole
    (``step_check``'s LIMITS, loss parts 1e-5, D 1e-3, running statistics
    1e-5; the logit's bias, which the relativistic losses cancel, by its
    gradient, 1e-6; the same step from fresh Adams printed); ``cli.infer
    --use-ema`` on esrgan's ``ckpt_best.pth``;
16. the self-attention D: ``cli.train.run_train`` on ``bsrgan`` with
    ``--d-arch discriminator_unet_sa`` (the config otherwise unchanged:
    batch 16, pre-crop 320, GT 144, bf16; token self-attention of 8 heads
    after down2, after down3 and on up1, full softmax), G from the bsrnet
    run (``--pretrained-g``): one epoch of 4 steps, then ``--resume auto``
    for a second (69 RDB and 2 filter2d kernel calls per step and
    validation batch, the resumed D as checkpointed); CUDA-event times of
    the step, the D update, the adversarial term and each attention's
    forward, peak memory; one f32 step held to its plain twin (loss parts
    1e-5, D and ``u`` 1e-3, G by ``step_check.LIMITS``);
17. evaluation: ``srganfd_tpu_torch.cli.test`` on the card over 6
    synthetic frames at 4 sizes (sides that are not multiples of 64 among
    them, so shape buckets and the masked metrics run), on each training
    phase's ``ckpt_last.pth``: ``bsrgan`` with ``--save-images
    --save-discriminator-eval --subdivision-lpips --niqe-model`` (the
    port's asset), ``aesrgan`` with ``--save-attention-layers
    --save-discriminator-eval`` (the gates' BatchNorm in eval mode),
    ``esrgan`` with ``--use-ema --self-ensemble`` and then ``--use-ema
    --tile 64`` on 2 frames, ``realesrgan`` (the second-order eval chain);
    every G forward f32 (69 3xTF32 RDB kernel calls), 2-3 filter2d calls
    a chain; ``aesrgan``, ``esrgan`` and ``realesrgan``, whose few
    training steps leave G's output near 0, again on a copy of the
    checkpoint whose G and EMA-G are ``spread_weights``' (SR in (0.05,
    0.95) at 30% of its elements or more). Each run is made again with every kernel
    swapped for its plain version on the kernel run's LR: each frame's SR
    to max abs 1e-3, PSNR to 0.01 dB, SSIM and LPIPS to 1e-4; the plain
    chain's LR to the DiffJPEG envelope (max 0.05); the heat-map and
    attention-map PNGs exist. Frames/s and each frame's parts (LR, G, metrics, LPIPS, NIQE,
    D) on the host clock with the device synchronised;
18. HTTP serving: ``cli.serve``'s ``serve_http`` in a thread on a free port
    of 127.0.0.1, full-width ``bsrgan_x2`` on spread weights with
    ``--batch auto`` (the micro-batcher), f32 then bf16: a burst of 24
    concurrent POST /sr of 256x256 from 24 client threads (every reply 200;
    f32 within one 8-bit level of the engine's ``sr_array`` of the same
    frame, bf16 within the bf16 serving limit, 8 levels and 45 dB, since a
    batched bf16 forward's cuDNN convs round apart from a single one's;
    fewer forwards than requests, by the RDB launch count), 8 sequential
    requests (host-clock p50/p95 and /stats's), 413 past ``--max-body-mb``,
    503 + ``Retry-After`` with ``--max-queue 1`` under a burst, /healthz,
    the ``should_stop`` drain within 10 s, and ``--batch 1``'s
    single-threaded server;
19. A-ESRGAN's generators at full width: ``gen_rrdb2x`` (23 RRDBs over the
    unshuffled half-size frame) on spread weights through the stdio loop
    and ``cli.infer``, f32 and bf16, 69 RDB kernel calls a forward, held to
    its plain-RDB twin at the serving limits; ``gen_rpa2x`` (no kernel)
    over stdio, shape and finite values; one bf16 ``bsrnet`` step of each
    with ``g_arch`` overridden (batch 16, GT 144): a finite loss, G moved.
20. the trainer's options at full width: ``bsrgan`` (batch 16, GT 144,
    bf16) through ``run_train`` for 2 epochs of 4 steps as it is and with
    ``--grad-accum 2 --skip-nonfinite --save-every-steps 2
    --ckpt-every-epochs 2 --async-ckpt --profile-dir``: step p50, peak
    memory, RDB and filter2d calls (3 G forwards a step under
    accumulation), the snapshots' steps, one step of each on the card
    (CUDA events); the trace names ``conv3x3_mma_kernel`` and
    ``filter2d_tf32_kernel`` and the step's parts; its top 10 device ops;
21. preemption: ``cli.train --config bsrgan`` as a subprocess (one epoch
    of 4 steps, deterministic algorithms where PyTorch has them), SIGTERM
    after its first step's report: exit 143, ``ckpt_preempt_last.pth`` at
    the applied step it printed; ``--resume auto`` finishes it; the final G,
    EMA-G and D against an uninterrupted run's, bit for bit or the
    difference beside the ops without a deterministic implementation;
22. the guard: an f32 ``bsrgan`` step (full width, batch 16) on a batch with
    an Inf pixel skips both updates and leaves G, D with ``u``, both Adams
    (``step`` too), EMA-G and the counts bit for bit; the next step equals
    a twin's from the pre-plant state;
23. accumulation: one f32 ``bsrnet`` step at ``grad_accum_steps`` 2 against
    1 on one batch: gradients per tensor 1e-4, G elementwise 2 lr;
24. ``--debug-nans``: a NaN frame pixel raises at ``conv1``, a NaN in the
    first RDB's input at that RDB (the kernel's output); a NaN weight's
    effect on the kernel and its plain version, printed;
25. flash attention's backward at q (1, 16384, 4, 16), f32 and bf16,
    against autograd through ``flash_attention_ref``; forward+backward
    timed beside ``scaled_dot_product_attention``'s and the bound; three
    ``aesrgan`` steps (batch 8, GT 120) with ``attn_chunk`` 1024 on the
    flash backend through the config, against the chunked backend;
26. ``cli.test_degradations`` over 4 frames of 512x512, ``--plus`` and
    ``--codec cv2``, each LR held to the same run with filter2d plain (cv2
    one 8-bit level, plus 0.05), frames/s and filter2d calls;
27. the s8 conv kernel of the int8 serving path (``csrc/qconv.cu``, in the
    kernel phases) on the five sources of a full-width RDB (x: 64 -> 192
    channels; out_1..out_4: 32 -> 160, 128, 96, 64) at (1, 256, 256) and
    (16, 72, 72): the int32 sums and the f32 output equal to the plain
    version (an exact float64 conv) bit for bit; CUDA-event times of the
    five convs at (1, 256, 256), the plain version and the bf16 RDB kernel
    on the same input, beside the bound (no library call takes an int8
    conv on CUDA);
28. ``cli.serve --stdio --quant-int8``: ``bsrgan_x2`` (4 x 256x256) and
    ``realesrgan_x4`` (4 x 128x128) on spread weights, f32 and bf16: 345
    qconv kernel calls and no RDB-kernel call a forward; one frame held to
    the same quantized model with the plain qconv (f32 1e-3; bf16 8/255 and
    45 dB); the PSNR against the unquantized f32 SR printed, not held;
29. paired training: ``bsrnet`` with ``degradation="paired"`` (full width,
    batch 16, bf16) on 16 registered pairs (GT 144, LR 72) for 3 steps:
    the first step's LR equal to the files (max abs 0), 69 RDB kernel calls
    a forward, the step p50 and peak memory;
30. ``cli.export`` of full-width ``bsrgan_x2`` at 128x128 on the card: the
    ``.pt2`` reloaded and run, held to the module (max abs 1e-3), its 69
    RDB kernel calls through the custom op ``srganfd::rdb_forward``, the
    RDBs' weights in it only packed (its size printed);
31. the graft's sources: ``--pretrained-g`` from the paired run's
    ``ckpt_last.pth``, a ``.npz`` of it and a ``runs:/`` URI of it in a
    ``file:`` MLflow store: the same ``n_ok/n_all``, G's forwards bit for
    bit equal;
32. the parallel modes on ``torch.distributed``, every rank a subprocess
    with a timeout (NCCL refuses two ranks of one communicator on one card,
    so a world of one runs under NCCL and two ranks share cuda:0 under
    gloo, joined by the launcher before it calls the CLI's ``main``):
    ``dp1_phase``, ``cli.train --config bsrgan`` and ``esrgan`` (full
    width, batch 2, 3 steps, deterministic algorithms) with torchrun's
    variables for a world of one and without them: G, EMA-G and D (``u``,
    BatchNorm's running statistics) max abs 0 apart, step p50 of each;
33. ``dp2_phase``: both configs on 2 gloo ranks for one f32 step, the
    ranks' synced first-step gradients against one process on both ranks'
    degraded pairs with the ranks' config, within 10x that reference's own
    spread between the two orders of the pairs, every update phase
    (``esrgan``'s BatchNorm moments in f64 in the ranks and the reference,
    or its f32 fast variance spreads 4e-3); ``esrgan`` again with per-rank
    BatchNorm statistics and with per-rank relativistic means (planted
    faults in the phase's own copy of the step) must each fail it;
34. ``spatial_phase``: ``cli.infer --spatial-shard`` of ``bsrgan_x2`` on a
    512x512 frame, a world of one under NCCL and 2 gloo ranks, each bit for
    bit the one-process loop of the same shards (``spatial_sr_loop``), the
    interior against the unsharded forward printed; ``--data-shard`` on 2
    ranks, its files equal to the unsharded run's at the per-rank batch;
35. ``cp_phase``: ``bsrgantrans_x2`` at 128x128 (4096 tokens) on 2 gloo
    ranks with ``--cp-backend ring`` and ``ulysses``, each bit for bit its
    one-process loop (``forward_shards``), ring against Ulysses 1e-4, the
    unsharded model's max abs printed;
36. ``serve_spatial_phase``: ``cli.serve --stdio --spatial-shard`` on 2
    gloo ranks, 4 requests equal to the spatial phase's frame and the
    loop's, both ranks exit 0 after the shutdown; the ranks try each
    collective on a CUDA tensor under gloo (printed), and every phase
    prints the collectives gloo ran through host memory.

37. ``dispatch_phase`` (run before 32-36, in one ``--dispatch-worker``
    subprocess under deterministic algorithms): the native C++ loader
    builds (or, where the host lacks libjpeg's or libpng's headers, its
    reason is printed and ``cli.train``'s fallback line is held), its
    batches of 16 x 320^2 equal for 2 and 8 threads and after a
    ``start_batch`` seek; full-width ``bsrnet`` under ``SRGANFD_FUSE_STEP=1
    SRGANFD_STEPS_PER_DISPATCH=2`` (8 steps) and ``bsrgan`` with its D and
    ``--skip-nonfinite`` under ``SRGANFD_STEPS_PER_DISPATCH=2`` (6 steps),
    each with CUDA graphs against the same run eager, max abs 0 over G,
    EMA-G, D and the Adams; the graph run again with the RDB packing's
    host check frozen in the capture, which must differ; graphs captured,
    replays, the RDB and filter2d launches a replay, step p50 graph against
    eager, and the ``Data`` meter before (``BatchLoader``, one step at a
    time) and after.

``python3 chip_smoke.py --parallel-only`` builds the kernels and runs
32-36 alone, without the last two lines; ``--dispatch-only`` runs 37 alone.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after.

It exits non-zero on any failure, and when no CUDA device is visible.
The line before the last is one JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
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
AE_FIRST_BIAS = "conv0.bias"  # the attention D's first conv's bias, held by its gradient
AE_MS_GT = 128  # the ensemble's two scales need GT sides of 16k; the config's 120 is not one
# the ESRGAN configs' shapes: batches of 16, GT 192 (rrdbnet) and 128
# (esrgan) at x4, so the generator's RDBs run on 48x48 and 32x32 LR crops
ES_RDB_SHAPES = {"rrdbnet": (16, 48, 48, CH), "esrgan": (16, 32, 32, CH)}
ES_STEPS_PER_EPOCH, ES_EPOCHS = 4, 1  # then --resume auto for one more epoch
# gen_rrdb2x unshuffles a 256x256 frame to 128x128 before its trunk
GEN_RDB_SHAPE = (1, 128, 128, CH)
LAST_CONV = {"gen_rrdb2x": "conv_last", "gen_rpa2x": "conv3"}  # the other archs' is conv4
# the HTTP phase: a burst of concurrent requests, then sparse ones
HTTP_BURST, HTTP_SPARSE = 24, 8


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


def rdb_shape_times(rdb, shape, seed: int, label: str) -> tuple[float, float, float, float]:
    """The bf16 kernel, its plain version and the cuDNN chain at a training
    config's RDB shape, and the card's bound there (ms each)."""
    x, ks, bs = rdb_inputs(shape, seed=seed)
    x = x.to(torch.bfloat16)
    packed = rdb.pack_rdb_weights(ks, bs, torch.bfloat16)
    with torch.inference_mode():
        ms = cuda_ms(lambda: rdb.rdb_forward(x, ks, bs, packed))
        plain_ms = cuda_ms(lambda: rdb.rdb_forward_ref(x, ks, bs))
        library_ms = cuda_ms(cudnn_chain(x, ks, bs))
    flops = rdb_flops(shape)
    # x read once, output written once, weights (bf16) and biases (f32) read once
    bytes_moved = 2 * 2 * x.numel() + 2 * packed[0].numel() + 4 * packed[1].numel()
    bound = max(flops / PEAK_BF16_FLOPS, bytes_moved / PEAK_HBM_BYTES) * 1e3
    print(
        f"rdb timing at x {shape} bf16 ({label}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN bf16 chain "
        f"{library_ms:.4f} ms; bound {bound:.4f} ms ({flops:.3e} FLOP, "
        f"{'operations' if flops / PEAK_BF16_FLOPS >= bytes_moved / PEAK_HBM_BYTES else 'bytes'}), "
        f"{100 * bound / ms:.1f}% of it",
        flush=True,
    )
    return ms, plain_ms, library_ms, bound


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
             *((shape, GC) for shape in ES_RDB_SHAPES.values()), (GEN_RDB_SHAPE, GC), ((3, 17, 23, CH), GC),
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
    # each training config's shape: bf16 kernel, plain version, cuDNN chain
    re_ms, re_plain_ms, re_library_ms, re_bound = rdb_shape_times(rdb, RE_RDB_SHAPE, 102, "realesrgan training")
    ae_ms, ae_plain_ms, ae_library_ms, ae_bound = rdb_shape_times(rdb, AE_RDB_SHAPE, 103, "aesrgan training")
    es = {name: rdb_shape_times(rdb, shape, 104 + i, f"{name} training")
          for i, (name, shape) in enumerate(ES_RDB_SHAPES.items())}
    gen = rdb_shape_times(rdb, GEN_RDB_SHAPE, 106, "gen_rrdb2x serving a 256x256 frame")
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
        **{f"{name}_train_{key}": value for name, shape in ES_RDB_SHAPES.items()
           for key, value in zip(("shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms"),
                                 (list(shape), *es[name]))},
        **{f"gen_rrdb2x_serve_{key}": value for key, value in zip(
            ("shape", "kernel_ms", "plain_ms", "library_ms", "bound_ms"), (list(GEN_RDB_SHAPE), *gen))},
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
        rdb.launches = rdb.launches_bwd = 0
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
    rdb.launches = rdb.launches_bwd = 0
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
    rdb.launches = rdb.launches_bwd = 0
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
    rdb.launches = rdb.launches_bwd = 0
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
    signal ~1.35x each. ``gen_rrdb2x``'s tail takes Flax's default init,
    not x0.1, and puts out std ~13 unscaled: it takes a gain of 0.5 (std
    0.20, 90% of a 64x64 CPU frame in (0.05, 0.95)); ``bsrgan_x2`` takes 3
    (std 0.24, 90%)."""
    from srganfd_tpu_torch.models import create_model

    model = create_model(arch, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 4 and not name.startswith(("trunk.", "body.")):
                p.mul_(gain)
        getattr(model, LAST_CONV.get(arch, "conv4")).bias.add_(0.5)
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
            blocks.flash_attention = lambda q, k, v, block_q=None: attn.flash_attention_ref(q, k, v, ATTN_CHUNK)
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
        rdb.launches = rdb.launches_bwd = 0
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
    rdb.launches = rdb.launches_bwd = 0
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


BWD_RAGGED_SHAPE = (2, 37, 45, CH)  # 16x8 tiles ragged in both axes


def graph_ms(fn, iters: int = 20) -> float:
    """CUDA-event time of one call of ``fn``, replayed from a CUDA graph of
    ``iters`` calls: the card's time without the host's launch overhead
    (a backward's Python wrapper takes ~0.14 ms, above its smaller kernels)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def rdb_bwd_bound(shape, dtype, packed) -> tuple[float, str]:
    """The least time of one RDB backward: its operations (dgrad and wgrad,
    each the forward's; as three TF32 products in f32) over the tensor
    cores' peak, or its bytes (x, feat and g read once, the packed weights
    read once, dx written once in x's dtype, dW and db written once in f32)
    over HBM's; the larger, in ms, and which one it is."""
    n, h, w, ch = shape
    esize = 2 if dtype == torch.bfloat16 else 4
    flops = 2 * rdb_flops(shape)
    t_ops = flops / PEAK_BF16_FLOPS if dtype == torch.bfloat16 else TF32_PRODUCTS * flops / PEAK_TF32_FLOPS
    out_elems = sum(9 * (ch + k * GC) * (GC if k < 4 else ch) + (GC if k < 4 else ch) for k in range(5))
    moved = esize * n * h * w * (3 * ch + 4 * GC) + packed[0].numel() * esize + 4 * out_elems
    t_bytes = moved / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def rdb_grad_phase(rdb) -> dict:
    """rdb_apply under autograd at the training shape x (16, 72, 72, 64)
    and a ragged (2, 37, 45, 64), f32 and bf16: one forward kernel and one
    backward kernel call each; the gradients of x, the 5 kernels and the 5
    biases held, as max |a - b| / max |b| per tensor, to rdb_backward_ref fed
    the same saved feat (f32 to 1e-5 against it run in f64 on f64 copies:
    the f32 cuDNN plain version misses exact sums by up to 3.9e-5 at the
    training shape, printed; bf16 to 1e-2 against the bf16 plain version),
    once with x not requiring a gradient; beside it the old comparison,
    autograd through the recomputed rdb_forward_ref (1e-4 / 1e-2 when no
    LeakyReLU slope differs between the kernel's feat and the recompute),
    and the count of slopes that differ. Then times at the training shape:
    each conv's dgrad and wgrad, the sums, the whole backward (CUDA graphs
    of the calls), its bound, the plain version, autograd through the five
    cuDNN convs (bf16, f32 with TF32 off and on), and rdb_apply's forward
    and backward."""
    import torch.nn.functional as F

    out = {}
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for shape, seed in ((TRAIN_RDB_SHAPE, 400), (BWD_RAGGED_SHAPE, 402)):
            x, ks, bs = rdb_inputs(shape, seed=seed)
            cot = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 1)).cuda().to(dt)
            for x_grad in (True, False) if shape == TRAIN_RDB_SHAPE else (True,):
                tag = f"{name} {shape}" + ("" if x_grad else " x without a gradient")
                leaves = [x.to(dt).requires_grad_(x_grad), *[t.clone().requires_grad_() for t in ks + bs]]
                wanted = [t for t in leaves if t.requires_grad]
                before = rdb.launches, rdb.launches_bwd
                y = rdb.rdb_apply(leaves[0], leaves[1:6], leaves[6:])
                feat = y.grad_fn.saved_tensors[1]
                orig_ref = rdb.rdb_forward_ref

                def refuse(*a, **k):
                    raise AssertionError("the backward reached rdb_forward_ref")

                rdb.rdb_forward_ref = refuse
                try:
                    got = torch.autograd.grad(y, wanted, cot)
                finally:
                    rdb.rdb_forward_ref = orig_ref
                torch.cuda.synchronize()
                check((rdb.launches, rdb.launches_bwd) == (before[0] + 1, before[1] + 1),
                      f"{tag}: rdb_apply made {rdb.launches - before[0]} forward and "
                      f"{rdb.launches_bwd - before[1]} backward kernel calls")
                xs, kt, bt = leaves[0].detach(), [t.detach() for t in ks], [t.detach() for t in bs]
                if dt == torch.float32:
                    d = torch.float64
                    want = rdb.rdb_backward_ref(xs.to(d), [t.to(d) for t in kt], [t.to(d) for t in bt], feat.to(d),
                                                cot.to(d), x_grad)
                    plain32 = rdb.rdb_backward_ref(xs, kt, bt, feat, cot, x_grad)
                else:
                    want = plain32 = rdb.rdb_backward_ref(xs, kt, bt, feat, cot, x_grad)
                want = ([want[0]] if x_grad else []) + want[1] + want[2]
                plain32 = ([plain32[0]] if x_grad else []) + plain32[1] + plain32[2]
                names = (["x"] if x_grad else []) + [f"kernel{k}" for k in range(5)] + [f"bias{k}" for k in range(5)]
                per = {n_: _rel_max(g, w) for n_, g, w in zip(names, got, want)}
                rel = max(per.values())
                out[f"bwd_max_abs_err_{name}"] = max(out.get(f"bwd_max_abs_err_{name}", 0.0), *(
                    (g.double() - w.double()).abs().max().item() for g, w in zip(got, want)))
                finite = all(torch.isfinite(g).all().item() for g in got)
                print(f"rdb_apply {tag}: backward kernels vs rdb_backward_ref on the same feat"
                      f"{' (in f64)' if dt == torch.float32 else ''}, max relative per tensor {rel:.3g} "
                      f"{ {k: float(f'{v:.2g}') for k, v in per.items()} }", flush=True)
                limit = 1e-5 if dt == torch.float32 else 1e-2
                check(finite and rel <= limit, f"{tag} backward kernels vs rdb_backward_ref: {rel} > {limit}")
                key = f"{name}_{shape[0]}x{shape[1]}x{shape[2]}" + ("" if x_grad else "_no_x_grad")
                out[f"bwd_rel_{key}"] = rel
                if dt == torch.float32:
                    plain_rel = max(_rel_max(p, w) for p, w in zip(plain32, want))
                    out[f"bwd_plain_f32_rel_{key}"] = plain_rel
                    print(f"rdb_apply {tag}: the f32 plain version (cuDNN, TF32 off) vs in f64, max relative per "
                          f"tensor {plain_rel:.3g}", flush=True)
                if not x_grad:
                    continue
                # the old comparison: autograd through the recomputed plain forward
                plain = [t.detach().clone().requires_grad_() for t in leaves]
                y_ref, feat_ref = rdb.rdb_forward_ref(plain[0], plain[1:6], plain[6:], with_feat=True)
                flips = int(((feat >= 0) != (feat_ref >= 0)).sum())
                old = max(_rel_max(g, w) for g, w in zip(got, torch.autograd.grad(y_ref, plain, cot)))
                old_limit = 1e-4 if dt == torch.float32 else 1e-2
                print(f"rdb_apply {tag}: vs autograd through the recomputed rdb_forward_ref, max relative "
                      f"{old:.3g} ({old_limit:g} held when no slope differs); LeakyReLU slopes that differ "
                      f"between the kernel's feat and the recompute: {flips}", flush=True)
                check(flips > 0 or old <= old_limit, f"{tag} vs autograd through the plain version: {old}")
                out[f"grad_max_rel_err_{key}"] = old
                out[f"slope_flips_{key}"] = flips
                del plain, y_ref, feat_ref
            del leaves, y, feat, got, want, plain32

    # times at the training shape
    x, ks, bs = rdb_inputs(TRAIN_RDB_SHAPE, seed=404)
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        xd = x.to(dt)
        packed = rdb.pack_rdb_weights(ks, bs, dt)
        cot = torch.randn(TRAIN_RDB_SHAPE, generator=torch.Generator().manual_seed(405)).cuda().to(dt)
        with torch.no_grad():
            _, feat = rdb.rdb_forward_ref(xd, ks, bs, with_feat=True)
        args = (xd, feat, cot, packed, GC)
        pieces = {f"dgrad{k}": graph_ms(lambda k=k: rdb.rdb_backward(*args, only=k)) for k in range(5)}
        pieces.update({f"wgrad{k}": graph_ms(lambda k=k: rdb.rdb_backward(*args, only=5 + k)) for k in range(5)})
        pieces["sums"] = graph_ms(lambda: rdb.rdb_backward(*args, only=10))
        ms = graph_ms(lambda: rdb.rdb_backward(*args))
        bound, bound_by = rdb_bwd_bound(TRAIN_RDB_SHAPE, dt, packed)
        plain_ms = cuda_ms(lambda: rdb.rdb_backward_ref(xd, ks, bs, feat, cot), iters=5, warmup=1)
        library = {}
        saved = torch.backends.cudnn.allow_tf32
        for lib_tag, tf32 in ((("bf16", False),) if dt == torch.bfloat16 else (("f32", False), ("tf32", True))):
            torch.backends.cudnn.allow_tf32 = tf32
            try:
                xl = xd.detach().requires_grad_()
                kl = [t.detach().requires_grad_() for t in ks]
                bl = [t.detach().requires_grad_() for t in bs]
                xc = xl.permute(0, 3, 1, 2)
                feats = [xc]
                for k in range(4):
                    wk = kl[k].to(dt).permute(3, 2, 0, 1)
                    feats.append(F.leaky_relu(F.conv2d(torch.cat(feats, 1), wk, bl[k].to(dt), padding=1), 0.2))
                yl = F.conv2d(torch.cat(feats, 1), kl[4].to(dt).permute(3, 2, 0, 1), bl[4].to(dt), padding=1) * 0.2 + xc
                gl = cot.permute(0, 3, 1, 2)
                library[lib_tag] = cuda_ms(lambda: torch.autograd.grad(yl, [xl, *kl, *bl], gl, retain_graph=True),
                                           iters=5, warmup=1)
                del yl, feats
            finally:
                torch.backends.cudnn.allow_tf32 = saved
        leaves = [xd.detach().requires_grad_(), *[t.detach().requires_grad_() for t in ks + bs]]

        def fwd_bwd():
            torch.autograd.grad(rdb.rdb_apply(leaves[0], leaves[1:6], leaves[6:]), leaves, cot)

        fwd_bwd_ms = cuda_ms(fwd_bwd, iters=10, warmup=2)
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: rdb.rdb_apply(leaves[0], leaves[1:6], leaves[6:]), iters=10)
        out[f"bwd_ms_{name}"] = ms
        out[f"bwd_pieces_ms_{name}"] = pieces
        out[f"bwd_bound_ms_{name}"] = bound
        out[f"bwd_bound_by_{name}"] = bound_by
        out[f"bwd_plain_ms_{name}"] = plain_ms
        out[f"bwd_library_ms_{name}"] = library
        out[f"train_fwd_ms_{name}"] = fwd_ms
        out[f"train_fwd_bwd_ms_{name}"] = fwd_bwd_ms
        print(f"rdb backward at x {TRAIN_RDB_SHAPE} {name} (CUDA graphs of the calls): {ms:.4f} ms, "
              f"{100 * bound / ms:.1f}% of its {bound:.4f} ms bound ({bound_by}); pieces "
              f"{ {k: round(v, 4) for k, v in pieces.items()} } ms (each conv's wgrad alone, the whole launch "
              f"holds all five); plain version {plain_ms:.4f} ms; autograd through the five cuDNN convs "
              f"{ {k: round(v, 4) for k, v in library.items()} } ms; rdb_apply forward {fwd_ms:.4f} ms, forward+"
              f"backward {fwd_bwd_ms:.4f} ms (host clock of the eager calls, CUDA events)", flush=True)
    return out


def _rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| in f64."""
    return ((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30)).item()


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
                      filters_per_chain=FILTERS_PER_CHAIN, payload=None):
    """One full-width f32 step of ``cfg`` (bsrnet, or bsrgan with its D),
    with the RDB kernel and then ``plain_runs`` times with rdb_forward_ref
    swapped in (a switch of this script only), from one state (the seeded
    init; or ``init``: G's state dict and, for a GAN, D's with its ``u``;
    or a checkpoint's ``payload``, restored whole: G, EMA-G, D, both Adams
    and the step) on one batch: the chain's, with the filter2d kernel, whose LR is held
    to the plain chain's apart (the Real-ESRGAN chain draws its noise from
    one generator state in both). Returns the readings of
    ``train.step_check`` (the chain's LR, and the share of its elements
    off by more than 1e-5; the loss parts, relative; the
    LeakyReLU slopes the kernel's and the first plain run's backwards take
    differently; the updated G outside and inside the flipped channels;
    with a D, the largest |gradient| of each D parameter that the kernel
    run's D update handed Adam, and each one's max |kernel - plain| over
    the plain run's largest |gradient|), the share of SR elements in (0, 1), which the output clamp passes (a
    forward's rounding reaches the losses through these alone), and each
    run's (metrics, G state dict, D state dict or None), the kernel's
    first. Each step runs under torch.use_deterministic_algorithms(True,
    warn_only=True) and cuDNN's deterministic algorithms, so that the
    card's own run-to-run roundoff does not read as the kernels'; the ops
    that warned are returned."""
    import warnings

    from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
    from srganfd_tpu_torch.train import checkpoint as ckpt
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
    runs, rdbs, inside, warned, d_grads = [], [], [], set(), []
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
            if payload is not None:
                # a copy each run: a restored Adam keeps the payload's step
                # tensor and counts on in it
                ckpt.restore_state(state, copy.deepcopy(payload))
            hook = state.g_model.register_forward_hook(
                lambda m, i, o: inside.append(((o > 0) & (o < 1)).float().mean().item()))
            before = rdb.launches
            torch.backends.cudnn.deterministic = True
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    metrics = {k: v.item() for k, v in trainer.train_step(state, batch["gt"], batch["lr"],
                                                                          batch.get("gt_pixel")).items()}
                finally:
                    torch.use_deterministic_algorithms(False)
                    torch.backends.cudnn.deterministic = False
            warned.update(str(w.message)[:160] for w in caught if "deterministic" in str(w.message))
            hook.remove()
            made = rdb.launches - before
            check(made == (0 if plain else RDB_PER_FORWARD), f"f32 {label} step (plain={plain}) made {made} rdb calls")
            names = [n for n, m in state.g_model.named_modules() if isinstance(m, blocks.ResidualDenseBlock)]
            d = None if state.d_model is None else {k: v.detach().clone()
                                                    for k, v in state.d_model.state_dict().items()}
            if d is not None and len(d_grads) < 2:  # what the D update handed Adam, kernel and first plain run
                d_grads.append({k: p.grad.detach().clone() for k, p in state.d_model.named_parameters()})
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
    out["nondeterministic_ops"] = sorted(warned)
    if runs[0][2] is not None:
        out["d_grad_max_abs"] = {k: v.abs().max().item() for k, v in d_grads[0].items()}
        out["d_grad_rel_parts"] = {k: (v - d_grads[1][k]).abs().max().item()
                                   / max(d_grads[1][k].abs().max().item(), 1e-30) for k, v in d_grads[0].items()}
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
    rdb.launches = rdb.launches_bwd = f2d.launches = 0
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
    calls = {"rdb": rdb.launches, "rdb_bwd": rdb.launches_bwd, "filter2d": f2d.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = TRAIN_STEPS_PER_EPOCH * (TRAIN_EPOCHS + 1)
    n_valid = TRAIN_EPOCHS + 1  # one batch of the 4 valid frames per epoch
    check(len(losses) == n_steps, f"{len(losses)} train steps, expected {n_steps}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    check(calls == {"rdb": RDB_PER_FORWARD * (n_steps + n_valid), "rdb_bwd": RDB_PER_FORWARD * n_steps,
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
    # one step with the plain RDB raising on the card: no RDB of the step,
    # forward or backward, runs the plain version
    real_ref = rdb.rdb_forward_ref

    def refuse_on_card(x, *a, **k):
        check(not x.is_cuda, "a training step ran rdb_forward_ref on a CUDA tensor")
        return real_ref(x, *a, **k)

    rdb.rdb_forward_ref = refuse_on_card
    rdb.launches = rdb.launches_bwd = 0
    try:
        real_step(trainer, state, gt_c, lr_c)
        torch.cuda.synchronize()
    finally:
        rdb.rdb_forward_ref = real_ref
    check((rdb.launches, rdb.launches_bwd) == (RDB_PER_FORWARD, RDB_PER_FORWARD),
          f"the step with the plain RDB refused made {rdb.launches} forward and {rdb.launches_bwd} backward calls")
    print(f"bsrnet step with rdb_forward_ref raising on a CUDA tensor: {rdb.launches} forward and "
          f"{rdb.launches_bwd} backward RDB kernel calls, no plain RDB", flush=True)
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
    rdb.launches = rdb.launches_bwd = 0
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


def graft_held(path: str):
    """A test of a run's first step: whether its G and EMA-G are the raw G
    that ``path`` holds (the --pretrained-g graft), compared on the card."""
    from srganfd_tpu_torch.convert import load_generator_weights

    want = {k: v.cuda() for k, v in load_generator_weights(path).items()}

    def held(state) -> bool:
        g = state.g_model.state_dict()
        return (set(g) == set(want) and all(torch.equal(g[k], v) for k, v in want.items())
                and set(state.ema_g) == set(want) and all(torch.equal(state.ema_g[k], want[k]) for k in want))

    return held


def gan_train_phase(work: str, rdb, f2d, blocks, filters) -> tuple[dict, dict]:
    """Full-width bsrgan (the config unchanged: bsrgan_x2 64/32/23,
    discriminator_unet c = 64, batch 16, pre-crop 320, GT 144, bf16, the
    VGG19 content loss and LPIPS selection on the seeded surrogates)
    through cli.train.run_train on the bsrnet phase's frames, its G and
    EMA-G grafted from the bsrnet phase's ckpt_last.pth (--pretrained-g),
    as the recipe's second stage starts: one epoch, then --resume auto for
    a second; returns the kernel calls it made and its numbers."""
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

    bsrnet_ckpt = os.path.join(work, "results", configs.get_config("bsrnet").exp_name, "ckpt_last.pth")
    cfg = configs.get_config("bsrgan").replace(
        train_gt_images_dir=os.path.join(work, "train_gt"), valid_gt_images_dir=os.path.join(work, "valid_gt"),
        results_dir=os.path.join(work, "results"), samples_dir=os.path.join(work, "samples"),
        pretrained_g_model_weights_path=bsrnet_ckpt,
    )
    grafted = graft_held(bsrnet_ckpt)
    print(f"bsrgan: {cfg.g_arch} {cfg.g_kwargs or 'full width (64/32/23)'} against {cfg.d_arch} "
          f"{cfg.d_kwargs or 'c = 64'}, batch {cfg.batch_size}, pre-crop {cfg.crop_image_size}, GT "
          f"{cfg.gt_image_size}, {cfg.compute_dtype}; pixel {cfg.pixel_weight} + content {cfg.content_weight} "
          f"over {cfg.feature_nodes} + adversarial {cfg.adversarial_weight}; Adam g {cfg.model_lr} / d "
          f"{cfg.discriminator_lr} eps {cfg.model_eps}; selection by {cfg.optimizing_metric}", flush=True)

    metrics_seen, steps = [], []  # steps: (step index, host clock at entry, at end)
    restored = []  # what restore_state left in the state, held to the checkpoint it read right then
    graft = []  # the first run's first step: G and EMA-G the bsrnet checkpoint's
    real_step, real_restore = Trainer.train_step, ckpt.restore_state

    def recorded_step(self, state, gt, lr_img, gt_pixel=None):
        entry = time.perf_counter()
        index = state.step
        if not steps:
            graft.append(grafted(state))
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
    rdb.launches = rdb.launches_bwd = f2d.launches = 0
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
    calls = {"rdb": rdb.launches, "rdb_bwd": rdb.launches_bwd, "filter2d": f2d.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = GAN_STEPS_PER_EPOCH * (GAN_EPOCHS + 1)
    n_valid = GAN_EPOCHS + 1  # one batch of the 4 valid frames per epoch
    check(len(metrics_seen) == n_steps, f"{len(metrics_seen)} bsrgan steps, expected {n_steps}")
    check(all(math.isfinite(v) for m in metrics_seen for v in m.values()), f"non-finite bsrgan metrics: {metrics_seen}")
    check(all(0 < m[k] < 1 for m in metrics_seen for k in ("d_gt_probability", "d_sr_probability")),
          "a D probability outside (0, 1): " + str([(m["d_gt_probability"], m["d_sr_probability"])
                                                    for m in metrics_seen]))
    check(calls == {"rdb": RDB_PER_FORWARD * (n_steps + n_valid), "rdb_bwd": RDB_PER_FORWARD * n_steps,
                    "filter2d": FILTERS_PER_CHAIN * (n_steps + n_valid)},
          f"bsrgan training made {calls} kernel calls for {n_steps} steps and {n_valid} validation batches")
    state = result["state"]
    check(state.step == n_steps, f"resumed bsrgan run ended at step {state.step}")
    check(graft == [True], f"the bsrgan run's G or EMA-G at step 0 is not the bsrnet checkpoint's G: {graft}")

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
    --resume auto for a second; ``realesrgan`` with its G and EMA-G grafted
    from the realesrnet phase's ckpt_last.pth (--pretrained-g). Returns the
    kernel calls, the numbers, and the host batch and final D state that
    the f32 check starts from."""
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
    grafted = None
    if gan:
        l1_ckpt = os.path.join(work, "results", configs.get_config("realesrnet").exp_name, "ckpt_last.pth")
        cfg = cfg.replace(pretrained_g_model_weights_path=l1_ckpt)
        grafted = graft_held(l1_ckpt)
    print(f"{name}: {cfg.g_arch} {cfg.g_kwargs or 'full width (64/32/23)'}"
          f"{f' against {cfg.d_arch} c = 64' if gan else ''}, batch {cfg.batch_size}, GT {cfg.gt_image_size}, "
          f"x{cfg.upscale_factor}, {cfg.compute_dtype}; pixel {cfg.pixel_weight}"
          f"{f' + content {cfg.content_weight} + adversarial {cfg.adversarial_weight}, G step first' if gan else ''}"
          f"; Adam {cfg.model_lr} eps {cfg.model_eps}; selection by {cfg.optimizing_metric}", flush=True)

    metrics_seen, steps, restored, graft = [], [], [], []
    real_step, real_restore = Trainer.train_step, ckpt.restore_state

    def recorded_step(self, state, gt, lr_img, gt_pixel=None):
        entry = time.perf_counter()
        index = state.step
        if grafted is not None and not steps:
            graft.append(grafted(state))
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
    rdb.launches = rdb.launches_bwd = f2d.launches = 0
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
    calls = {"rdb": rdb.launches, "rdb_bwd": rdb.launches_bwd, "filter2d": f2d.launches}
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
    check(calls == {"rdb": RDB_PER_FORWARD * (n_steps + n_valid), "rdb_bwd": RDB_PER_FORWARD * n_steps,
                    "filter2d": want_filters},
          f"{name} made {calls} kernel calls for {n_steps} steps and {n_valid} validation batches "
          f"(expected {RDB_PER_FORWARD * (n_steps + n_valid)} rdb, {want_filters} filter2d)")
    state = result["state"]
    check(state.step == n_steps, f"resumed {name} run ended at step {state.step}")
    check(graft == ([True] if gan else []), f"the {name} run's G or EMA-G at step 0 is not the realesrnet "
          f"checkpoint's G: {graft}")
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
    rdb.launches = rdb.launches_bwd = f2d.launches = 0
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
    calls = {"rdb": rdb.launches, "rdb_bwd": rdb.launches_bwd, "filter2d": f2d.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = AE_STEPS_PER_EPOCH * (AE_EPOCHS + 1)
    n_valid = AE_EPOCHS + 1  # one batch of the 4 valid frames per epoch
    check(len(metrics_seen) == n_steps, f"{len(metrics_seen)} aesrgan steps, expected {n_steps}")
    check(all(math.isfinite(v) for m in metrics_seen for v in m.values()), f"non-finite aesrgan metrics: {metrics_seen}")
    check(all(0 < m[k] < 1 for m in metrics_seen for k in ("d_gt_probability", "d_sr_probability")),
          f"a D probability outside (0, 1): {metrics_seen}")
    check(calls == {"rdb": RDB_PER_FORWARD * (n_steps + n_valid), "rdb_bwd": RDB_PER_FORWARD * n_steps,
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
        _bce_scales(_first(d(sr_leaf, update_stats=False, train=True)), 1.0).backward(inputs=[sr_leaf])

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
    rdb.launches = rdb.launches_bwd = f2d.launches = 0
    try:
        t0 = time.perf_counter()
        ms_result = cli_train.run_train(ms_cfg, 1, device="cuda")
        torch.cuda.synchronize()
        ms_s = time.perf_counter() - t0
    finally:
        Trainer.train_step = real_step
    ms_calls = {"rdb": rdb.launches, "rdb_bwd": rdb.launches_bwd, "filter2d": f2d.launches}
    ms_d = ms_result["state"].d_model
    check(len(ms_metrics) == 1 and all(math.isfinite(v) for v in ms_metrics[0].values())
          and all(0 < ms_metrics[0][k] < 1 for k in ("d_gt_probability", "d_sr_probability")),
          f"the ensemble step's metrics {ms_metrics}")
    check(type(ms_d).__name__ == "MultiScaleAttentionDiscriminator" and hasattr(ms_d, "D1"),
          f"the ensemble run trained {type(ms_d).__name__}")
    check(ms_calls == {"rdb": 2 * RDB_PER_FORWARD, "rdb_bwd": RDB_PER_FORWARD, "filter2d": 2 * FILTERS_PER_CHAIN},
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
    # tensor's largest entry; every gradient the D update hands Adam to 1e-3
    # of the tensor's largest; the plain step twice bit for bit (the steps
    # run under PyTorch's deterministic algorithms) unless an op warned, so
    # every difference the check reads is the kernels'. The bias of the 1x1
    # conv before each gate's BatchNorm has no gradient in exact arithmetic
    # (the batch mean takes it out): both runs step it by Adam on roundoff,
    # so what the two runs read there is noise against noise (1.1e-3 -
    # 2.4e-3 of its largest entry, 2.6e-8 apart, with correct kernels on an
    # H100 80GB HBM3 at 700 W: PERF.md section 6). Those three are printed,
    # not held, value or gradient; the CPU tests hold their gradient against
    # JAX's (test_torch_aesrgan_model.py).
    # conv0.bias, the first conv's, is held by its gradient and its value
    # printed: zero at init, its largest entry after the phase's steps is
    # ~10 lr, and a few of its 64 gradients sit below Adam's eps (1e-4),
    # where the fresh Adam's first update, lr g / (|g| + eps), passes the
    # gradient on linearly. Its value then reads ~1e3 times the gradient's
    # absolute difference, which the kernels' rounding of SR puts at 1e-7 -
    # 1.4e-6 through the D: 4.9e-5 - 5.3e-4 in 8 trainings, 1.29e-3 in
    # another, with correct kernels (ae_check_study.py, PERF.md section 6).
    f32, runs = f32_step_vs_plain(cfg, host, rdb, f2d, blocks, filters, init=(g_final, d_final), plain_runs=2,
                                  label="aesrgan (aesrgan-trained G and D)")
    (_, _, d_k), (m_p, g_p, d_p), (m_p2, g_p2, d_p2) = runs

    def kind(k):
        if k.endswith(".u"):
            return "u"
        if k.endswith(("running_mean", "running_var")):
            return "bn"
        if k == AE_FIRST_BIAS:
            return "first_bias"
        return "pre_bn_bias" if k.endswith("W.0.bias") else "d"

    kept = lambda sd, c: {k: v for k, v in sd.items() if kind(k) == c}  # noqa: E731
    f32["d_rel"], f32["d_worst"] = _rel_per_tensor(kept(d_k, "d"), kept(d_p, "d"))
    f32["u_rel"], f32["u_worst"] = _rel_per_tensor(kept(d_k, "u"), kept(d_p, "u"))
    f32["bn_rel"], f32["bn_worst"] = _rel_per_tensor(kept(d_k, "bn"), kept(d_p, "bn"))
    f32["d_grad_rel"], f32["d_grad_worst"] = max((v, k) for k, v in f32["d_grad_rel_parts"].items()
                                                 if kind(k) != "pre_bn_bias")
    f32["first_bias_rel"] = _rel_per_tensor(kept(d_k, "first_bias"), kept(d_p, "first_bias"))[0]
    f32["first_bias_max"] = d_p[AE_FIRST_BIAS].abs().max().item()
    f32["first_bias_grads_below_eps"] = int((d_k[AE_FIRST_BIAS] - d_final[AE_FIRST_BIAS].to(d_k[AE_FIRST_BIAS]))
                                            .abs().lt(0.5 * cfg.discriminator_lr).sum())
    pre_bn = kept(d_p, "pre_bn_bias")
    check(len(pre_bn) == 3, f"pre-BatchNorm biases {sorted(pre_bn)}")
    f32["pre_bn_bias_abs"] = max((d_k[k] - v).abs().max().item() for k, v in pre_bn.items())
    f32["pre_bn_bias_max"] = max(v.abs().max().item() for v in pre_bn.values())
    f32["pre_bn_bias_rel"] = _rel_per_tensor(kept(d_k, "pre_bn_bias"), pre_bn)[0]
    f32["plain_again_exact"] = (m_p2 == m_p and all(torch.equal(g_p2[k], v) for k, v in g_p.items())
                                and all(torch.equal(d_p2[k], v) for k, v in d_p.items()))
    print(f"f32 aesrgan step (trained state): updated D per tensor max relative "
          f"{f32['d_rel']:.3g} ({f32['d_worst']}), u {f32['u_rel']:.3g}, the gates' running statistics "
          f"{f32['bn_rel']:.3g} ({f32['bn_worst']}); the D update's gradients per tensor {f32['d_grad_rel']:.3g} "
          f"({f32['d_grad_worst']}); {AE_FIRST_BIAS} (value not held) {f32['first_bias_rel']:.3g} of its largest "
          f"entry {f32['first_bias_max']:.3g}, {f32['first_bias_grads_below_eps']} of its gradients in Adam's "
          f"linear range, its gradient {f32['d_grad_rel_parts'][AE_FIRST_BIAS]:.3g}; the pre-BatchNorm biases (no "
          f"gradient; not held) {f32['pre_bn_bias_abs']:.3g} apart, {f32['pre_bn_bias_rel']:.3g} of their largest "
          f"entry {f32['pre_bn_bias_max']:.3g}; the plain step twice "
          f"{'bit for bit' if f32['plain_again_exact'] else 'NOT bit for bit'}; ops without a deterministic "
          f"implementation: {f32['nondeterministic_ops']}", flush=True)
    failed = step_check.step_check_failures(f32, {**step_check.LIMITS, "d_rel": 1e-3, "u_rel": 1e-3, "bn_rel": 1e-5,
                                                  "d_grad_rel": 1e-3})
    check(not failed, f"f32 aesrgan step vs plain: {failed}")
    check(f32["plain_again_exact"] or f32["nondeterministic_ops"],
          "the plain aesrgan step run twice differs with no non-deterministic op warned")

    # cli.infer --use-ema on ckpt_best.pth: a GT-sized frame (120x120, 60x60
    # tokens at full attention, as the config trains)
    import cv2

    frame = os.path.join(work, "ae_frame.png")
    cv2.imwrite(frame, cv2.imread(os.path.join(cfg.valid_gt_images_dir, "gt_000.png"))[:cfg.gt_image_size,
                                                                                       :cfg.gt_image_size])
    out_png = os.path.join(work, "ae_sr.png")
    rdb.launches = rdb.launches_bwd = 0
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


def es_run(cfg, rdb, f2d, steps_per_epoch: int, runs, check_first=None) -> dict:
    """``cfg`` through cli.train.run_train once per (epochs, resume) of
    ``runs``, with each step's metrics and host-clock times, what each
    restore left in the state against the checkpoint it read (step, G,
    EMA-G, D with its buffers, both Adams), ``check_first`` of the first
    step's state, the kernel calls and the peak memory."""
    from srganfd_tpu_torch.cli import train as cli_train
    from srganfd_tpu_torch.train import checkpoint as ckpt
    from srganfd_tpu_torch.train.loop import Trainer

    out = {"metrics": [], "steps": [], "restored": [], "first": [], "run_s": []}
    real_step, real_restore = Trainer.train_step, ckpt.restore_state

    def recorded_step(self, state, gt, lr_img, gt_pixel=None):
        entry = time.perf_counter()
        index = state.step
        if check_first is not None and not out["steps"]:
            out["first"].append(check_first(state))
        m = real_step(self, state, gt, lr_img, gt_pixel)
        out["metrics"].append({k: v.item() for k, v in m.items()})  # waits for the step
        out["steps"].append((index, entry, time.perf_counter()))
        return m

    def recorded_restore(state, payload):
        real_restore(state, payload)
        same = lambda a, b: set(a) == set(b) and all(  # noqa: E731
            torch.equal(torch.as_tensor(a[k]).cpu(), torch.as_tensor(b[k]).cpu()) for k in b)
        adams = [(state.g_opt, "optimizer")] + ([(state.d_opt, "d_optimizer")] if state.d_model is not None else [])
        out["restored"].append({
            "step": state.step,
            "g": same(state.g_model.state_dict(), payload["state_dict"]),
            "ema": same(state.ema_g, payload["ema_state_dict"]),
            "d": state.d_model is None or same(state.d_model.state_dict(), payload["d_state_dict"]),
            "adams": all(same(o.state_dict()["state"][i], payload[key]["state"][i])
                         for o, key in adams for i in payload[key]["state"]),
        })

    Trainer.train_step, ckpt.restore_state = recorded_step, recorded_restore
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rdb.launches = rdb.launches_bwd = f2d.launches = 0
    try:
        for epochs, resume in runs:
            t0 = time.perf_counter()
            out["result"] = cli_train.run_train(cfg.replace(epochs=epochs), steps_per_epoch, resume=resume,
                                                device="cuda")
            torch.cuda.synchronize()
            out["run_s"].append(time.perf_counter() - t0)
    finally:
        Trainer.train_step, ckpt.restore_state = real_step, real_restore
    out["calls"] = {"rdb": rdb.launches, "rdb_bwd": rdb.launches_bwd, "filter2d": f2d.launches}
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def es_train_phase(work: str, rdb, f2d, blocks, filters) -> tuple[dict, dict]:
    """Full-width ESRGAN, its two stages through cli.train.run_train on the
    bsrnet phase's frames, the configs unchanged: ``rrdbnet`` (rrdbnet_x4
    64/32/23, batch 16, GT 192, MATLAB-bicubic LR, L1, bf16), one epoch of
    ES_STEPS_PER_EPOCH steps and a resumed second; then ``esrgan`` (the
    same G at GT 128 against the VGG-128 D with c = 64, VGG19 content at
    features.34 on the seeded surrogate, relativistic, the G step first,
    LPIPS selection) with --pretrained-g on rrdbnet's ckpt_last.pth, one
    epoch and a resumed second; a one-step --pretrained-d run from
    esrgan's checkpoint; the step's parts on the card for each stage; one
    f32 esrgan step held to its plain twin from the trained G and D;
    cli.infer --use-ema on esrgan's ckpt_best.pth. Returns the kernel calls
    of the training runs and the numbers."""
    import cv2

    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli import infer
    from srganfd_tpu_torch.cli import train as cli_train
    from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
    from srganfd_tpu_torch.data.datasets import BatchLoader
    from srganfd_tpu_torch.losses.gan import relativistic_g_loss
    from srganfd_tpu_torch.train import checkpoint as ckpt
    from srganfd_tpu_torch.train import step_check
    from srganfd_tpu_torch.train.loop import Trainer, _d_train_mode

    where = dict(train_gt_images_dir=os.path.join(work, "train_gt"), valid_gt_images_dir=os.path.join(work, "valid_gt"),
                 results_dir=os.path.join(work, "results"), samples_dir=os.path.join(work, "samples"))
    n_steps = ES_STEPS_PER_EPOCH * (ES_EPOCHS + 1)
    n_valid = ES_EPOCHS + 1  # one batch of the 4 valid frames per epoch
    runs = ((ES_EPOCHS, ""), (ES_EPOCHS + 1, "auto"))
    calls, numbers, hosts = {"rdb": 0, "rdb_bwd": 0, "filter2d": 0}, {}, {}
    for name in ("rrdbnet", "esrgan"):
        cfg = configs.get_config(name).replace(**where)
        graft = None
        if name == "esrgan":
            source = os.path.join(cfg.results_dir, configs.get_config("rrdbnet").exp_name, "ckpt_last.pth")
            cfg = cfg.replace(pretrained_g_model_weights_path=source)
            graft = graft_held(source)
        print(f"{name}: {cfg.g_arch} {cfg.g_kwargs or 'full width (64/32/23)'}"
              f"{f' against {cfg.d_arch} (VGG-128) c = 64' if cfg.is_gan else ''}, batch {cfg.batch_size}, GT "
              f"{cfg.gt_image_size}, x{cfg.upscale_factor}, {cfg.degradation} LR, {cfg.compute_dtype}; pixel "
              f"{cfg.pixel_weight} + content {cfg.content_weight} over {cfg.feature_nodes} + adversarial "
              f"{cfg.adversarial_weight} (relativistic: {cfg.relativistic_gan}, G first: {cfg.g_step_first}); Adam "
              f"{cfg.model_lr} eps {cfg.model_eps}; selection by {cfg.optimizing_metric}"
              f"{f'; --pretrained-g {cfg.pretrained_g_model_weights_path}' if graft else ''}", flush=True)
        r = es_run(cfg, rdb, f2d, ES_STEPS_PER_EPOCH, runs, check_first=graft)
        metrics, steps, restored = r["metrics"], r["steps"], r["restored"]
        check(len(metrics) == n_steps, f"{len(metrics)} {name} steps, expected {n_steps}")
        check(all(math.isfinite(v) for m in metrics for v in m.values()), f"non-finite {name} metrics: {metrics}")
        if cfg.is_gan:
            check(all(0 < m[k] < 1 for m in metrics for k in ("d_gt_probability", "d_sr_probability")),
                  f"a D probability outside (0, 1): {metrics}")
            check(r["first"] == [True], f"the esrgan run's G or EMA-G at step 0 is not rrdbnet's G: {r['first']}")
        check(r["calls"] == {"rdb": RDB_PER_FORWARD * (n_steps + n_valid), "rdb_bwd": RDB_PER_FORWARD * n_steps,
                             "filter2d": 0},
              f"{name} made {r['calls']} kernel calls for {n_steps} steps and {n_valid} validation batches")
        state = r["result"]["state"]
        check(state.step == n_steps, f"resumed {name} run ended at step {state.step}")
        check(len(restored) == 1 and restored[0]["step"] == ES_STEPS_PER_EPOCH, f"{name} restores: {restored}")
        check(steps[ES_STEPS_PER_EPOCH][0] == ES_STEPS_PER_EPOCH, f"the resumed {name} run's first step was "
              f"{steps[ES_STEPS_PER_EPOCH][0]}")
        check(all(restored[0].values()), f"the resumed {name} state is not the checkpoint's: {restored}")
        ckpt_dir = os.path.join(cfg.results_dir, cfg.exp_name)
        with open(os.path.join(cfg.samples_dir, "logs", cfg.experience_name or cfg.exp_name, "events.jsonl")) as f:
            events = [json.loads(line) for line in f]
        metric = "Valid/LPIPS" if cfg.optimizing_metric == "LPIPS" else "Valid/PSNR"
        scores = [e["metrics"][metric] for e in events if e["type"] == "metrics" and metric in e["metrics"]]
        check(len(scores) == n_valid and all(math.isfinite(v) for v in scores), f"{name} validation {metric} {scores}")
        best = ckpt.load_checkpoint(os.path.join(ckpt_dir, "ckpt_best.pth"))
        pick = np.argmin if metric == "Valid/LPIPS" else np.argmax
        check(best["epoch"] == int(pick(scores)), f"{name} ckpt_best.pth is epoch {best['epoch']}, {metric} {scores}")
        if cfg.is_gan:
            last = ckpt.load_checkpoint(os.path.join(ckpt_dir, "ckpt_last.pth"))
            stats = [k for k in last["d_state_dict"] if k.endswith(("running_mean", "running_var"))]
            check(len(stats) == 18, f"the VGG-128 D's checkpoint holds {stats}")
            check(all(torch.equal(last["d_state_dict"][k], v.cpu()) for k, v in state.d_model.state_dict().items()),
                  "esrgan ckpt_last.pth is not the final D")
        intervals = [(b[2] - a[2]) * 1e3 for a, b in zip(steps, steps[1:])
                     if b[0] == a[0] + 1 and b[0] % ES_STEPS_PER_EPOCH]
        inside = [(end - entry) * 1e3 for _, entry, end in steps]
        step_p50 = float(np.median(intervals))
        print(f"{name} training: metrics {[{k: round(v, 5) for k, v in m.items()} for m in metrics]}", flush=True)
        print(f"{name} training: {n_steps} steps + {n_valid} validation batches in "
              f"{[round(t, 2) for t in r['run_s']]} s; step p50 {step_p50:.2f} ms host clock over {len(intervals)} "
              f"steps ({cfg.batch_size * 1e3 / step_p50:.2f} frames/s), inside train_step p50 "
              f"{np.median(inside[1:]):.2f} ms, the first step {inside[0]:.1f} ms; validation {metric} by epoch "
              f"{scores}, ckpt_best.pth epoch {best['epoch']}; resumed at step {restored[0]['step']} with G, EMA-G"
              f"{', D (running statistics)' if cfg.is_gan else ''} and the Adams the checkpoint's; peak memory "
              f"{r['peak_memory_gb']:.2f} GB; {r['calls']} kernel calls (per forward "
              f"{r['calls']['rdb'] // (n_steps + n_valid)} rdb_forward)", flush=True)

        # where one step's time goes, on the card (CUDA events), on the trained state
        loader = BatchLoader(cli_train.build_datasets(cfg)[0], cfg.batch_size, seed=cfg.seed, num_workers=2)
        it = iter(loader)
        host = next(it)
        it.close()
        adapter = DegradationAdapter(cfg, seed=cfg.seed, train=True, device="cuda")
        batch = adapter(host, 0)
        gt_c, lr_c = batch["gt"], batch["lr"]
        check(tuple(lr_c.shape) == (cfg.batch_size, cfg.gt_image_size // 4, cfg.gt_image_size // 4, 3),
              f"{name} LR batch {tuple(lr_c.shape)}")
        trainer = Trainer(cfg, ES_STEPS_PER_EPOCH, device="cuda")
        g, d = state.g_model, state.d_model
        before = rdb.launches
        with torch.no_grad():
            g(lr_c)
        check(rdb.launches - before == RDB_PER_FORWARD, f"a {name} G forward made {rdb.launches - before} rdb calls")

        def g_fwd_bwd():
            (g(lr_c) - gt_c).abs().mean().backward()

        with torch.inference_mode():
            breakdown = {"chain_ms": cuda_ms(lambda: adapter(host, 0), iters=5, warmup=1),
                         "forward_ms": cuda_ms(lambda: g(lr_c), iters=5, warmup=1)}
        breakdown["g_forward_backward_ms"] = cuda_ms(g_fwd_bwd, iters=3, warmup=1)
        if cfg.is_gan:
            sr = g(lr_c).detach()
            sr_leaf = sr.clone().requires_grad_()

            def content_fwd_bwd():
                trainer.content_loss(sr_leaf, gt_c).backward(inputs=[sr_leaf])

            def adversarial_fwd_bwd():
                with torch.no_grad():
                    gt_out = _d_train_mode(d, gt_c, update_stats=False)
                relativistic_g_loss(gt_out, _d_train_mode(d, sr_leaf, update_stats=False)).backward(inputs=[sr_leaf])

            breakdown.update({
                "d_update_ms": cuda_ms(lambda: trainer._d_update(state, gt_c, sr), iters=3, warmup=1),
                "content_forward_backward_ms": cuda_ms(content_fwd_bwd, iters=3, warmup=1),
                "adversarial_forward_backward_ms": cuda_ms(adversarial_fwd_bwd, iters=3, warmup=1),
            })
            del sr, sr_leaf
        breakdown["train_step_ms"] = cuda_ms(lambda: Trainer.train_step(trainer, state, gt_c, lr_c), iters=3, warmup=1)
        print(f"{name} step breakdown on the card (CUDA events, {cfg.compute_dtype}, batch {cfg.batch_size}, GT "
              f"{cfg.gt_image_size}): bicubic LR {breakdown['chain_ms']:.2f} ms; G forward {breakdown['forward_ms']:.2f} "
              f"ms, forward+backward (L1) {breakdown['g_forward_backward_ms']:.2f} ms"
              + (f"; D update (2 forwards on GT and SR, relativistic loss, backward, Adam) "
                 f"{breakdown['d_update_ms']:.2f} ms; content (VGG19 to features.34 on SR and GT, backward to SR) "
                 f"{breakdown['content_forward_backward_ms']:.2f} ms; adversarial (D on GT without a graph and on "
                 f"SR, backward to SR) {breakdown['adversarial_forward_backward_ms']:.2f} ms" if cfg.is_gan else "")
              + f"; whole train step {breakdown['train_step_ms']:.2f} ms", flush=True)
        hosts[name] = host
        numbers[name] = {
            "steps": n_steps, "validation_batches": n_valid, "validation": scores, "best_epoch": best["epoch"],
            "step_ms_p50": step_p50, "inside_step_ms_p50": float(np.median(inside[1:])), "first_step_ms": inside[0],
            "frames_per_s": cfg.batch_size * 1e3 / step_p50, "peak_memory_gb": r["peak_memory_gb"],
            "run_s": r["run_s"], "rdb_launches": r["calls"]["rdb"], **breakdown,
        }
        calls = {k: calls[k] + r["calls"][k] for k in calls}
        del g, d, state, r, trainer
        torch.cuda.empty_cache()

    # One step with --pretrained-d on esrgan's checkpoint: D with its running
    # statistics the file's, its Adam fresh, G rrdbnet's
    es_cfg = configs.get_config("esrgan").replace(**where)
    es_ckpt = os.path.join(es_cfg.results_dir, es_cfg.exp_name, "ckpt_last.pth")
    saved_d = {k: v.cuda() for k, v in ckpt.load_checkpoint(es_ckpt)["d_state_dict"].items()}
    g_held = graft_held(os.path.join(es_cfg.results_dir, configs.get_config("rrdbnet").exp_name, "ckpt_last.pth"))

    def d_grafted(state) -> bool:
        d = state.d_model.state_dict()
        return (set(d) == set(saved_d) and all(torch.equal(d[k], v) for k, v in saved_d.items())
                and len(state.d_opt.state) == 0 and len(state.g_opt.state) == 0 and g_held(state))

    d_cfg = es_cfg.replace(results_dir=os.path.join(work, "results_d"), samples_dir=os.path.join(work, "samples_d"),
                           pretrained_d_model_weights_path=es_ckpt,
                           pretrained_g_model_weights_path=os.path.join(es_cfg.results_dir,
                                                                        configs.get_config("rrdbnet").exp_name,
                                                                        "ckpt_last.pth"))
    r = es_run(d_cfg, rdb, f2d, 1, ((1, ""),), check_first=d_grafted)
    check(r["first"] == [True], "the --pretrained-d run's D (running statistics), fresh Adams or G at step 0 are "
          "not esrgan's D and rrdbnet's G")
    check(len(r["metrics"]) == 1 and all(math.isfinite(v) for v in r["metrics"][0].values()),
          f"the --pretrained-d step's metrics {r['metrics']}")
    check(r["calls"] == {"rdb": 2 * RDB_PER_FORWARD, "rdb_bwd": RDB_PER_FORWARD, "filter2d": 0},
          f"the --pretrained-d run made {r['calls']}")
    calls = {k: calls[k] + r["calls"][k] for k in calls}
    numbers["pretrained_d_step"] = {"metrics": r["metrics"][0], "s": r["run_s"][0], "calls": r["calls"]}
    print(f"esrgan --pretrained-d {es_ckpt} --pretrained-g (rrdbnet's): D, its 18 running statistics and a fresh "
          f"Adam at step 0; 1 step + 1 validation batch in {r['run_s'][0]:.2f} s, metrics "
          f"{ {k: round(v, 5) for k, v in r['metrics'][0].items()} }, {r['calls']} kernel calls", flush=True)
    del r
    torch.cuda.empty_cache()

    # One f32 esrgan step held to its plain twin from the trained state,
    # esrgan's ckpt_last.pth restored whole (G, EMA-G, D with its running
    # statistics, both Adams, the step): the loss parts, the slope flips and
    # G outside the flipped channels by step_check's LIMITS, D per tensor to
    # 1e-3, its BatchNorms' running statistics to 1e-5. Every BatchNorm of
    # this D follows a bias-free conv, but the logit's bias
    # (classifier.2.bias) cancels from every difference the relativistic
    # losses take: its gradient is the roundoff of a sum that is 0, and Adam
    # turns that roundoff into an update of up to lr, so its value in the
    # two runs is printed, not held. In two of three correct trainings the
    # kernel run's gradient was exactly 0 and left it at 0 while the plain
    # run moved it, a relative reading of exactly 1 (es_check_study.py,
    # PERF.md section 6). Its gradient in the kernel run is held to 1e-6
    # instead (it read 0 - 3.7e-9): the terms of that sum are each at most
    # 1/16, and a mean left out of the graph makes it ~0.2-0.5.
    # G inside the flipped channels is printed, not held: rrdbnet's eight
    # steps leave the trunk biases at ~3e-5 (their gradients sit below
    # Adam's eps of 1e-8), so a flipped slope's share of a bias's gradient
    # reads 5.0e-4 - 1.14e-3 of it with correct kernels on an H100 80GB
    # HBM3 at 700 W (PERF.md section 6). With fresh Adams instead (the
    # other phases' checks) the first update is lr * g / (|g| + eps), +-lr
    # for all but the tiniest g: the few hundred G and ~10^4 D elements
    # whose gradient the forward's rounding turns over (none when the plain
    # step runs twice) then read 2 lr apart, up to 2e-2 of G's tensors and
    # 0.23 of D's (PERF.md section 6). That step is printed beside it.
    es_payload = ckpt.load_checkpoint(es_ckpt)
    host, g_final, d_final = hosts["esrgan"], es_payload["state_dict"], es_payload["d_state_dict"]
    lr = Trainer(es_cfg, ES_STEPS_PER_EPOCH).schedule(0)
    cancelled = "classifier.2.bias"
    kept = lambda sd, bn: {k: v for k, v in sd.items()  # noqa: E731
                           if k.endswith(("running_mean", "running_var")) == bn and k != cancelled}
    turned = lambda a, b: {k: int(n) for k in a if a[k].is_floating_point()  # noqa: E731
                           for n in [((a[k].float() - b[k].float()).abs() > lr).sum()] if n}
    f32 = {}
    for name, start in (("trained state", {"payload": es_payload}), ("fresh Adams", {"init": (g_final, d_final)})):
        r, runs = f32_step_vs_plain(es_cfg, host, rdb, f2d, blocks, filters, plain_runs=2 if not f32 else 1,
                                    label=f"esrgan ({name})", filters_per_chain=0, **start)
        (_, g_k, d_k), (m_p, g_p, d_p) = runs[:2]
        r["d_rel"], r["d_worst"] = _rel_per_tensor(kept(d_k, False), kept(d_p, False))
        r["bn_rel"], r["bn_worst"] = _rel_per_tensor(kept(d_k, True), kept(d_p, True))
        r["cancelled_grad"] = r["d_grad_max_abs"][cancelled]
        r["cancelled_apart"] = {"kernel": d_k[cancelled].item(), "plain": d_p[cancelled].item(),
                                "in_lr": abs(d_k[cancelled].item() - d_p[cancelled].item()) / lr}
        r["updates_turned"] = {"g": sum(turned(g_k, g_p).values()), "d": sum(turned(kept(d_k, False),
                                                                                kept(d_p, False)).values())}
        if len(runs) == 3:
            m_p2, g_p2, d_p2 = runs[2]
            r["plain_again"] = {"loss_rel": max(abs(m_p2[k] - m_p[k]) / max(abs(m_p[k]), 1e-30) for k in m_p),
                                "g_rel": _rel_per_tensor(g_p2, g_p)[0],
                                "d_rel": _rel_per_tensor(kept(d_p2, False), kept(d_p, False))[0],
                                "updates_turned": {"g": sum(turned(g_p2, g_p).values()),
                                                   "d": sum(turned(kept(d_p2, False), kept(d_p, False)).values())}}
        print(f"f32 esrgan step ({name}): updated D per tensor max relative {r['d_rel']:.3g} ({r['d_worst']}), its "
              f"running statistics {r['bn_rel']:.3g} ({r['bn_worst']}); {cancelled}: gradient "
              f"{r['cancelled_grad']:.3g}, "
              f"updated {r['cancelled_apart']['kernel']:.6g} and {r['cancelled_apart']['plain']:.6g} (not held: "
              f"{r['cancelled_apart']['in_lr']:.3g} lr apart); elements the two runs moved more than the "
              f"learning rate {lr:.3g} apart: {r['updates_turned']}"
              + (f"; the plain step run twice: {r['plain_again']}" if "plain_again" in r else ""), flush=True)
        f32[name] = r
    limits = {k: v for k, v in step_check.LIMITS.items() if k != "g_inside"}
    failed = step_check.step_check_failures(f32["trained state"], {**limits, "d_rel": 1e-3, "bn_rel": 1e-5,
                                                                   "cancelled_grad": 1e-6})
    check(not failed, f"f32 esrgan step vs plain: {failed}")
    numbers["esrgan"]["f32_step_vs_plain"] = f32

    # cli.infer --use-ema on esrgan's ckpt_best.pth: a 64x64 crop of a valid frame
    frame = os.path.join(work, "es_frame.png")
    cv2.imwrite(frame, cv2.imread(os.path.join(es_cfg.valid_gt_images_dir, "gt_000.png"))[:64, :64])
    out_png = os.path.join(work, "es_sr.png")
    rdb.launches = rdb.launches_bwd = 0
    infer.main(["--model-arch", es_cfg.g_arch, "--weights", os.path.join(es_cfg.results_dir, es_cfg.exp_name,
                                                                         "ckpt_best.pth"),
                "--use-ema", "--inputs-path", frame, "--output-path", out_png])
    img = cv2.imread(out_png)
    check(img is not None and img.shape == (256, 256, 3), f"infer of the esrgan EMA-G: {img is None or img.shape}")
    check(rdb.launches == RDB_PER_FORWARD, f"infer of the esrgan EMA-G: {rdb.launches} rdb calls")
    print(f"cli.infer --model-arch {es_cfg.g_arch} --use-ema on esrgan's ckpt_best.pth: 64x64 -> "
          f"{img.shape[1]}x{img.shape[0]}, {RDB_PER_FORWARD} rdb calls", flush=True)
    return calls, numbers


SA_EXP = "BSRGAN_SA_x2"  # the SA run's results and log directory, beside bsrgan's


def sa_train_phase(work: str, rdb, f2d, blocks, filters) -> tuple[dict, dict]:
    """Full-width ``bsrgan`` with ``--d-arch discriminator_unet_sa`` (the
    config otherwise unchanged: bsrgan_x2 64/32/23, batch 16, pre-crop 320,
    GT 144, bf16; the U-Net with token self-attention after down2, after
    down3 and on up1, 8 heads, full softmax) through cli.train.run_train on
    the bsrnet phase's frames, G and EMA-G grafted from the bsrnet phase's
    ckpt_last.pth: one epoch, then --resume auto for a second. Returns its
    kernel calls and numbers: step p50, the D update, the adversarial term,
    the three attentions' forward ms, peak memory, and one f32 step held to
    its plain twin by the bsrgan phase's limits."""
    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli import train as cli_train
    from srganfd_tpu_torch.convert import load_generator_weights
    from srganfd_tpu_torch.data.datasets import BatchLoader
    from srganfd_tpu_torch.losses.gan import bce_with_logits
    from srganfd_tpu_torch.ops.degrade import apply_bsrgan_batch_cropped, bsrgan_lr_size, plan_bsrgan_batch
    from srganfd_tpu_torch.train import checkpoint as ckpt
    from srganfd_tpu_torch.train import step_check
    from srganfd_tpu_torch.train.loop import Trainer, _first

    bsrnet_ckpt = os.path.join(work, "results", configs.get_config("bsrnet").exp_name, "ckpt_last.pth")
    cfg = configs.get_config("bsrgan").replace(
        d_arch="discriminator_unet_sa", exp_name=SA_EXP, experience_name=SA_EXP,
        train_gt_images_dir=os.path.join(work, "train_gt"), valid_gt_images_dir=os.path.join(work, "valid_gt"),
        results_dir=os.path.join(work, "results"), samples_dir=os.path.join(work, "samples"),
        pretrained_g_model_weights_path=bsrnet_ckpt,
    )
    print(f"bsrgan --d-arch {cfg.d_arch}: {cfg.g_arch} full width against the SA U-Net c = 64 (attentions of "
          f"256, 512, 256 channels, 8 heads), batch {cfg.batch_size}, pre-crop {cfg.crop_image_size}, GT "
          f"{cfg.gt_image_size}, {cfg.compute_dtype}", flush=True)
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
        restored.append({"step": state.step, "d": all(
            torch.equal(v.cpu(), payload["d_state_dict"][k]) for k, v in state.d_model.state_dict().items())})

    Trainer.train_step, ckpt.restore_state = recorded_step, recorded_restore
    torch.cuda.reset_peak_memory_stats()
    rdb.launches = rdb.launches_bwd = f2d.launches = 0
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
    calls = {"rdb": rdb.launches, "rdb_bwd": rdb.launches_bwd, "filter2d": f2d.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps, n_valid = GAN_STEPS_PER_EPOCH * (GAN_EPOCHS + 1), GAN_EPOCHS + 1
    state = result["state"]
    check(type(state.d_model).__name__ == "DiscriminatorUNetSA", f"the SA run trained {type(state.d_model).__name__}")
    check(len(metrics_seen) == n_steps and state.step == n_steps, f"{len(metrics_seen)} SA steps, expected {n_steps}")
    check(all(math.isfinite(v) for m in metrics_seen for v in m.values()), f"non-finite SA metrics: {metrics_seen}")
    check(all(0 < m[k] < 1 for m in metrics_seen for k in ("d_gt_probability", "d_sr_probability")),
          f"an SA D probability outside (0, 1): {metrics_seen}")
    check(calls == {"rdb": RDB_PER_FORWARD * (n_steps + n_valid), "rdb_bwd": RDB_PER_FORWARD * n_steps,
                    "filter2d": FILTERS_PER_CHAIN * (n_steps + n_valid)},
          f"the SA training made {calls} kernel calls for {n_steps} steps and {n_valid} validation batches")
    check(len(restored) == 1 and restored[0] == {"step": GAN_STEPS_PER_EPOCH, "d": True},
          f"the resumed SA run's restore: {restored}")
    intervals = [(b[2] - a[2]) * 1e3 for a, b in zip(steps, steps[1:])
                 if b[0] == a[0] + 1 and b[0] % GAN_STEPS_PER_EPOCH]
    step_p50 = float(np.median(intervals))
    print(f"SA training: metrics {[{k: round(v, 5) for k, v in m.items()} for m in metrics_seen]}", flush=True)
    print(f"SA training: {n_steps} steps + {n_valid} validation batches in {[round(t, 2) for t in run_s]} s; step p50 "
          f"{step_p50:.2f} ms host clock over {len(intervals)} steps; peak memory {peak_gb:.2f} GB; {calls} kernel "
          f"calls", flush=True)

    # a step's parts on the card (CUDA events), on the trained state
    loader = BatchLoader(cli_train.build_datasets(cfg)[0], cfg.batch_size, seed=cfg.seed, num_workers=2)
    it = iter(loader)
    host = next(it)
    it.close()
    gt_dev = torch.from_numpy(host["gt"]).cuda()
    plan = plan_bsrgan_batch(np.random.default_rng(0), cfg.batch_size, cfg.upscale_factor)
    lim = bsrgan_lr_size(gt_dev.shape[1], plan) - cfg.gt_image_size // cfg.upscale_factor
    tops = np.random.default_rng(1).integers(0, lim + 1, cfg.batch_size)
    gt_c, lr_c = apply_bsrgan_batch_cropped(gt_dev, plan, tops, tops, cfg.gt_image_size, cfg.upscale_factor)
    trainer = Trainer(cfg, GAN_STEPS_PER_EPOCH, device="cuda")
    g, d = state.g_model, state.d_model
    sr = g(lr_c).detach()
    sr_leaf = sr.clone().requires_grad_()

    def adversarial_fwd_bwd():
        out = _first(d(sr_leaf, update_stats=False, train=True))
        bce_with_logits(out, torch.ones_like(out)).backward(inputs=[sr_leaf])

    breakdown = {
        "d_update_ms": cuda_ms(lambda: trainer._d_update(state, gt_c, sr), iters=3, warmup=1),
        "adversarial_forward_backward_ms": cuda_ms(adversarial_fwd_bwd, iters=3, warmup=1),
        "train_step_ms": cuda_ms(lambda: real_step(trainer, state, gt_c, lr_c), iters=3, warmup=1),
    }
    # each attention's forward alone, at its input of this batch (bf16)
    attn_in = {}
    hooks = [getattr(d, name).register_forward_hook(lambda m, i, o, name=name: attn_in.__setitem__(name, i[0]))
             for name in ("attn_down2", "attn_down3", "attn_up1")]
    with torch.no_grad():
        d(sr, train=True)
    for h in hooks:
        h.remove()
    with torch.no_grad():
        for name, x in attn_in.items():
            breakdown[f"{name}_ms"] = cuda_ms(lambda m=getattr(d, name), x=x: m(x), iters=5, warmup=1)
            breakdown[f"{name}_tokens"] = x.shape[2] * x.shape[3]
    print(f"SA step breakdown on the card (CUDA events, {cfg.compute_dtype}, batch {cfg.batch_size}): D update (2 "
          f"forwards on GT and SR, backward, Adam) {breakdown['d_update_ms']:.2f} ms; adversarial (D on SR, backward "
          f"to SR) {breakdown['adversarial_forward_backward_ms']:.2f} ms; whole train step "
          f"{breakdown['train_step_ms']:.2f} ms; attention forwards: "
          + ", ".join(f"{n} {breakdown[f'{n}_ms']:.2f} ms ({breakdown[f'{n}_tokens']} tokens)" for n in attn_in),
          flush=True)
    d_final = {k: v.detach().clone() for k, v in d.state_dict().items()}
    del g, d, state, result, trainer, sr, sr_leaf, attn_in
    torch.cuda.empty_cache()

    # One f32 step held to its plain twin, from the bsrnet-trained G and this
    # phase's SA D, by the bsrgan phase's limits: loss parts 1e-5, D and u
    # 1e-3, G by step_check's LIMITS
    f32, runs = f32_step_vs_plain(cfg, host, rdb, f2d, blocks, filters,
                                  init=(load_generator_weights(bsrnet_ckpt), d_final), plain_runs=1,
                                  label="bsrgan --d-arch discriminator_unet_sa (trained state)")
    (_, _, d_k), (_, _, d_p) = runs
    kept = lambda sd, u: {k: v for k, v in sd.items() if k.endswith(".u") == u}  # noqa: E731
    f32["d_rel"], f32["d_worst"] = _rel_per_tensor(kept(d_k, False), kept(d_p, False))
    f32["u_rel"], f32["u_worst"] = _rel_per_tensor(kept(d_k, True), kept(d_p, True))
    print(f"f32 SA step (trained state): updated D per tensor max relative {f32['d_rel']:.3g} ({f32['d_worst']}), "
          f"u {f32['u_rel']:.3g} ({f32['u_worst']})", flush=True)
    failed = step_check.step_check_failures(f32, {**step_check.LIMITS, "d_rel": 1e-3, "u_rel": 1e-3})
    check(not failed, f"f32 SA step vs plain: {failed}")
    numbers = {"steps": n_steps, "validation_batches": n_valid, "step_ms_p50": step_p50, "peak_memory_gb": peak_gb,
               "run_s": run_s, **breakdown, "f32_step_vs_plain": f32}
    return calls, numbers


# cli.test's frames: 6 at 4 sizes, sides that are not multiples of 64 among them (buckets of 64)
EVAL_SIZES = ((256, 256), (200, 300), (192, 320), (150, 230), (256, 256), (200, 300))
# (tag, config, the checkpoint's experiment, cli.test flags, (G arch, gain)):
# with a gain, the same run is made again on a copy of the checkpoint whose
# G and EMA-G are spread_weights' (the seeded init with the convs outside
# the trunk scaled by the gain): a few training steps from the x0.1 init
# leave G's output near 0 (PSNR 6.86 dB on these frames), where the
# comparison with the plain kernels at 1e-3 would hold little, and scaling
# the trained tail instead saturates it (rrdbnet's, x4: 1% of SR in (0.05,
# 0.95))
EVAL_RUNS = (
    ("bsrgan", "bsrgan", "BSRGAN_x2", ["--save-images", "--save-discriminator-eval", "--subdivision-lpips",
                                        "--niqe-model", "NIQE"], None),
    ("aesrgan", "aesrgan", "AESRGAN_x2", ["--save-attention-layers", "--save-discriminator-eval"],
     ("bsrgantrans_x2", 6.0)),
    ("esrgan_ensemble", "esrgan", "train_ESRGAN_x4_bubbles", ["--use-ema", "--self-ensemble", "--max-images", "2"],
     ("rrdbnet_x4", 4.0)),
    ("esrgan_tile", "esrgan", "train_ESRGAN_x4_bubbles", ["--use-ema", "--tile", "64", "--max-images", "2"],
     ("rrdbnet_x4", 4.0)),
    ("realesrgan", "realesrgan", "RealESRGAN_x4", [], ("realesrgan_x4", 4.0)),
)


def _eval_forwards(flags, sizes, sf: int) -> int:
    """The generator calls of one cli.test run: one a frame; two (the
    ensemble's orientations, four variants each) with --self-ensemble;
    one per 8 tiles of 64 at overlap 16 with --tile 64."""
    if "--self-ensemble" in flags:
        return 2 * len(sizes)
    if "--tile" in flags:
        calls = 0
        for h, w in sizes:
            lh, lw = -(-h // 64) * 64 // sf, -(-w // 64) * 64 // sf
            tiles = max(1, math.ceil((lh - 32) / 32)) * max(1, math.ceil((lw - 32) / 32))
            calls += math.ceil(tiles / 8)
        return calls
    return len(sizes)


def spread_checkpoint(work: str, src: str, dst: str, arch: str, gain: float) -> str:
    """A copy of a cli.train checkpoint whose G and EMA-G are
    ``spread_weights(work, arch, gain)``'s; D as the checkpoint holds it."""
    from srganfd_tpu_torch.train import checkpoint as ckpt

    payload = ckpt.load_checkpoint(src)
    g = torch.load(spread_weights(work, arch, gain), map_location="cpu", weights_only=True)["state_dict"]
    payload["state_dict"], payload["ema_state_dict"] = g, {k: v.clone() for k, v in g.items()}
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    torch.save(payload, dst)
    return dst


def eval_phase(work: str, rdb, f2d, blocks, filters) -> tuple[dict, dict]:
    """``srganfd_tpu_torch.cli.test`` on the card on each training phase's
    ckpt_last.pth (EVAL_RUNS) over 6 synthetic frames at 4 sizes: every G
    forward in f32 (the 3xTF32 RDB kernel), the BSRGAN and Real-ESRGAN eval
    chains on the filter2d kernel, the Ds in eval mode; where the few
    training steps leave G's output near 0, again on a copy of the
    checkpoint with spread_weights' G. Each run is made again with every kernel swapped
    for its plain version on the kernel run's LR: each frame's SR held to
    max abs 1e-3 (the serving f32 limit), PSNR to 0.01 dB, SSIM and LPIPS
    to 1e-4; the chains' plain LR printed beside the kernel LR and held to
    the DiffJPEG envelope (max 0.05); a spread copy's SR held to lie in
    (0.05, 0.95) at 30% of its elements or more. Returns the kernel calls of the
    kernel runs and the numbers."""
    import cv2

    from srganfd_tpu_torch.cli import test as cli_test

    gt_dir = os.path.join(work, "eval_gt")
    os.makedirs(gt_dir)
    rng = np.random.default_rng(12)
    for i, (h, w) in enumerate(EVAL_SIZES):
        yy, xx = np.mgrid[0:h, 0:w] / 64.0
        base = 0.5 + 0.25 * np.sin(2 * np.pi * (xx * rng.uniform(0.5, 2) + yy * rng.uniform(0.5, 2)))
        img = np.clip(base[..., None] + 0.04 * rng.standard_normal((h, w, 3)), 0, 1)
        cv2.imwrite(os.path.join(gt_dir, f"frame_{i:02d}.png"), (img * 255).astype(np.uint8))
    niqe_asset = os.path.join(ROOT, "srganfd_tpu_torch", "assets", "niqe_cfd_bubbles.npz")
    real_lr, real_match, real_rdb, real_f2d = cli_test._config_lr, cli_test._match_hw, blocks.rdb_apply, filters.filter2d
    calls, numbers, home = {"rdb": 0, "filter2d": 0}, {}, os.getcwd()

    def one_run(tag: str, config: str, weights: str, flags: list[str], spread: bool) -> None:
        run_dir = os.path.join(work, f"eval_{tag}")
        os.makedirs(run_dir)
        os.chdir(run_dir)  # cli.test logs under ./samples, as the JAX CLI does
        argv = (["--config", config, "--gt-dir", gt_dir, "--weights", weights]
                + [niqe_asset if f == "NIQE" else f for f in flags])
        lrs, srs = [], []

        def recorded_lr(adapter, gt, i):
            lr = real_lr(adapter, gt, i)
            lrs.append(lr.clone())
            return lr

        def recorded_match(x, h, w):
            out = real_match(x, h, w)
            srs.append(out.clone())
            return out

        cli_test._config_lr, cli_test._match_hw = recorded_lr, recorded_match
        rdb.launches = rdb.launches_bwd = f2d.launches = 0
        t0 = time.perf_counter()
        out = cli_test.run_eval(cli_test.build_parser().parse_args(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cli_test._config_lr, cli_test._match_hw = real_lr, real_match
        made = {"rdb": rdb.launches, "rdb_bwd": rdb.launches_bwd, "filter2d": f2d.launches}
        frames = out["per_image"]
        n = len(frames)
        forwards = _eval_forwards(flags, EVAL_SIZES[:n], 4 if config in ("esrgan", "realesrgan") else 2)
        check(made["rdb"] == RDB_PER_FORWARD * forwards,
              f"cli.test {tag}: {made['rdb']} rdb calls for {forwards} generator forwards")
        lo, hi = {"bsrgan": (2, 2), "aesrgan": (2, 2), "realesrgan": (2, 3)}.get(config, (0, 0))
        check(lo * n <= made["filter2d"] <= hi * n, f"cli.test {tag}: {made['filter2d']} filter2d calls, {n} frames")
        for k in calls:
            calls[k] += made[k]
        check(all(math.isfinite(r[m]) for r in frames for m in ("psnr", "ssim", "lpips")),
              f"cli.test {tag}: non-finite metrics {frames}")
        sr_spread = torch.cat([((s > 0.05) & (s < 0.95)).float().flatten() for s in srs]).mean().item()
        check(not spread or sr_spread >= 0.3, f"cli.test {tag}: SR in (0.05, 0.95) at {sr_spread:.3f} of its elements")

        # the same run with every kernel swapped for its plain version, on the kernel run's LR
        plain_lr_diff, plain_srs = [], []

        def replayed_lr(adapter, gt, i):
            """The plain chain's LR, set beside the kernel run's, which is returned."""
            kernel_lr = lrs[len(plain_lr_diff)]
            plain_lr_diff.append((real_lr(adapter, gt, i) - kernel_lr).abs().max().item())
            return kernel_lr

        def plain_match(x, h, w):
            plain_srs.append(real_match(x, h, w))
            return plain_srs[-1]

        cli_test._config_lr, cli_test._match_hw = replayed_lr, plain_match
        blocks.rdb_apply = lambda x, k, b, packed=None: rdb.rdb_forward_ref(x, k, b)
        filters.filter2d = f2d.filter2d_ref
        rdb.launches = rdb.launches_bwd = f2d.launches = 0
        os.makedirs(run_dir + "_plain")
        os.chdir(run_dir + "_plain")
        plain = cli_test.run_eval(cli_test.build_parser().parse_args(argv))
        blocks.rdb_apply, filters.filter2d = real_rdb, real_f2d
        cli_test._config_lr, cli_test._match_hw = real_lr, real_match
        check(rdb.launches == 0 and f2d.launches == 0, f"the plain {tag} run launched a kernel")
        sr_diff = [(a - b).abs().max().item() for a, b in zip(srs, plain_srs)]
        dm = {m: max(abs(a[m] - b[m]) for a, b in zip(frames, plain["per_image"])) for m in ("psnr", "ssim", "lpips")}
        check(len(sr_diff) == n and max(sr_diff) <= 1e-3, f"cli.test {tag}: SR kernels vs plain {sr_diff}")
        check(dm["psnr"] <= 0.01 and dm["ssim"] <= 1e-4 and dm["lpips"] <= 1e-4,
              f"cli.test {tag}: metrics kernels vs plain {dm}")
        check(not plain_lr_diff or max(plain_lr_diff) <= 0.05, f"cli.test {tag}: chain LR vs plain {plain_lr_diff}")
        logs = os.path.join(run_dir, "samples", "logs")
        (exp_dir,) = os.listdir(logs)
        pngs = sorted(os.listdir(os.path.join(logs, exp_dir)))
        want = {"sr_": "--save-images" in flags, "d_gt_": "--save-discriminator-eval" in flags,
                "d_sr_": "--save-discriminator-eval" in flags, "attn2_": "--save-attention-layers" in flags}
        for prefix, expected in want.items():
            got = sum(p.startswith(prefix) and p.endswith(".png") for p in pngs)
            check(got == (n if expected else 0), f"cli.test {tag}: {got} {prefix}*.png for {n} frames")
        per = {part: float(np.median([r["ms"].get(part, 0.0) for r in frames]))
               for part in ("lr", "generator", "psnr_ssim", "lpips", "niqe", "discriminator")}
        numbers[tag] = {"frames": n, "wall_s": wall, "frames_per_s": n / wall, "ms_per_frame_p50": per,
                        "generator_shapes": out["generator_shapes"], "avg": out["avg"], "launches": made,
                        "sr_spread": sr_spread, "sr_max_abs_vs_plain": max(sr_diff), "metrics_vs_plain": dm,
                        "chain_lr_max_abs_vs_plain": max(plain_lr_diff) if plain_lr_diff else None}
        print(f"cli.test {tag} ({config}, {' '.join(f for f in flags if f != 'NIQE')}): {n} frames in {wall:.2f} s "
              f"({n / wall:.2f} frames/s) host clock, {out['generator_shapes']} generator shapes; per frame p50: "
              f"LR {per['lr']:.2f} ms, G {per['generator']:.2f} ms, PSNR/SSIM {per['psnr_ssim']:.2f} ms, LPIPS "
              f"{per['lpips']:.2f} ms, NIQE {per['niqe']:.2f} ms, D {per['discriminator']:.2f} ms; {made} kernel "
              f"calls; avg {out['avg']}; SR in (0.05, 0.95) {sr_spread:.3f}; kernels vs plain: SR max abs "
              f"{max(sr_diff):.3g}, metrics {dm}, chain LR {numbers[tag]['chain_lr_max_abs_vs_plain']}", flush=True)

    try:
        for tag, config, exp, flags, spread_g in EVAL_RUNS:
            weights = os.path.join(work, "results", exp, "ckpt_last.pth")
            one_run(tag, config, weights, flags, spread=False)
            if spread_g:
                spread = spread_checkpoint(work, weights, os.path.join(work, "results_spread", exp, "ckpt_last.pth"),
                                           *spread_g)
                one_run(f"{tag}_spread", config, spread, flags, spread=True)
    finally:
        os.chdir(home)
        blocks.rdb_apply, filters.filter2d = real_rdb, real_f2d
        cli_test._config_lr, cli_test._match_hw = real_lr, real_match
    return calls, numbers


def _http(port: int, method: str, path: str, body: bytes | None = None, timeout: float = 120):
    """One request to the local server: (status, body, headers)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        conn.close()


def _start_http(engine, **kw):
    """``serve_http`` on a free port of 127.0.0.1 in a thread; returns
    (port, thread, stop)."""
    import threading

    from srganfd_tpu_torch.cli.serve import serve_http

    up, stop, bound = threading.Event(), threading.Event(), {}

    def ready(addr):
        bound["port"] = addr[1]
        up.set()

    th = threading.Thread(target=serve_http, args=(engine, 0),
                          kwargs={"should_stop": stop.is_set, "ready": ready, **kw}, daemon=True)
    th.start()
    check(up.wait(60), "the HTTP server did not come up")
    return bound["port"], th, stop.set


def _stop_http(th, stop, label: str) -> float:
    t0 = time.perf_counter()
    stop()
    th.join(10)
    check(not th.is_alive(), f"{label}: the HTTP server did not drain within 10 s of should_stop")
    return time.perf_counter() - t0


def _burst(port: int, bodies: list[bytes]) -> list[tuple[int, bytes, dict, float]]:
    """POST every body at once from its own client thread; each reply with
    its host-clock ms."""
    import threading

    replies = [None] * len(bodies)
    go = threading.Event()

    def post(i):
        go.wait()
        t0 = time.perf_counter()
        status, body, headers = _http(port, "POST", "/sr", bodies[i])
        replies[i] = (status, body, headers, (time.perf_counter() - t0) * 1e3)

    clients = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
    for c in clients:
        c.start()
    go.set()
    for c in clients:
        c.join(300)
    check(all(r is not None for r in replies), "an HTTP client got no reply within 300 s")
    return replies


def _png_levels(reply: bytes, want: np.ndarray) -> tuple[int, float]:
    """Largest 8-bit level between a reply's PNG and ``sr_array``'s output
    quantised as the server quantises it, and their PSNR (dB, on [0, 1])."""
    import cv2

    got = cv2.imdecode(np.frombuffer(reply, np.uint8), cv2.IMREAD_COLOR)
    want8 = np.clip(want * 255.0, 0, 255).astype(np.uint8)[..., ::-1]
    check(got is not None and got.shape == want8.shape, f"reply PNG {None if got is None else got.shape}")
    diff = got.astype(np.float64) - want8.astype(np.float64)
    mse = float(np.mean((diff / 255.0) ** 2))
    return int(np.abs(diff).max()), (10 * math.log10(1.0 / mse) if mse > 0 else float("inf"))


def _http_agrees(tag: str, reading: tuple[int, float]) -> bool:
    """The HTTP agreement limit: f32 one 8-bit level of ``sr_array``; bf16
    the serving limit of a bf16 forward, 8 levels and 45 dB, since a
    micro-batched bf16 forward runs cuDNN's convs for another batch size
    than ``sr_array``'s, and bf16 rounds their other sums apart."""
    levels, psnr = reading
    return levels <= 1 if tag == "f32" else (levels <= 8 and psnr >= 45)


def http_serve_phase(work: str, rdb, blocks) -> tuple[int, dict]:
    """``cli.serve --port``'s transport (``serve_http``) on 127.0.0.1 serving
    full-width bsrgan_x2 on spread weights with ``--batch auto`` (the
    micro-batcher), f32 then bf16: a burst of HTTP_BURST concurrent POST /sr
    of 256x256 (every reply 200 and within ``_http_agrees``' limit of the
    engine's ``sr_array`` of its frame; fewer forwards than requests), HTTP_SPARSE
    sequential ones (host-clock p50/p95 and /stats's); then, in bf16, the
    overload limits (413 past ``--max-body-mb``, 503 + Retry-After with a
    queue of 1), /healthz, the should_stop drain, and ``--batch 1``'s
    single-threaded server. Returns the RDB kernel calls and the readings."""
    from srganfd_tpu_torch.cli.serve import ServingEngine
    from srganfd_tpu_torch.data.datasets import load_image_rgb

    frames = write_frames(os.path.join(work, "http_lr"), HTTP_BURST, 256, 256, seed=20)
    bodies = [open(p, "rb").read() for p in frames]
    weights = spread_weights(work, "bsrgan_x2", gain=3.0)
    launches, out = 0, {}
    for half in (False, True):
        tag = "bf16" if half else "f32"
        engine = ServingEngine("bsrgan_x2", weights=weights, half=half, batch="auto", device="cuda")
        engine.warmup([(256, 256)])
        want = [engine.sr_array(load_image_rgb(p)) for p in frames]  # one forward each, not counted
        port, th, stop = _start_http(engine)
        rdb.launches = rdb.launches_bwd = 0
        t0 = time.perf_counter()
        replies = _burst(port, bodies)
        torch.cuda.synchronize()
        burst_s = time.perf_counter() - t0
        calls = rdb.launches
        launches += calls
        check([r[0] for r in replies] == [200] * HTTP_BURST, f"{tag} burst statuses {[r[0] for r in replies]}")
        readings = [_png_levels(r[1], w) for r, w in zip(replies, want)]
        levels, psnr = max(r[0] for r in readings), min(r[1] for r in readings)
        forwards = calls // RDB_PER_FORWARD
        check(calls % RDB_PER_FORWARD == 0 and 0 < forwards < HTTP_BURST,
              f"{tag} burst: {calls} rdb_forward calls for {HTTP_BURST} requests")
        check(all(_http_agrees(tag, r) for r in readings), f"{tag} burst: replies {readings} from sr_array")
        spread = float(np.mean([((w > 0.05) & (w < 0.95)).mean() for w in want]))
        # where a batched forward parts from a single one: the model with the
        # plain RDB, the first 16 frames as one batch against one by one
        x = torch.from_numpy(np.stack([load_image_rgb(p) for p in frames[:16]])).cuda()
        with torch.inference_mode():
            orig = blocks.rdb_apply
            blocks.rdb_apply = lambda xh, k, b, packed=None: rdb.rdb_forward_ref(xh, k, b)
            try:
                batched = engine.model(x)
                single = torch.cat([engine.model(x[i:i + 1]) for i in range(16)])
            finally:
                blocks.rdb_apply = orig
        batch_gap = (batched - single).abs().max().item()
        # and sr_batch (the dispatcher's call; here a batch of 16 and one of
        # 8) on this thread against sr_array, and the replies against it
        main_batched = engine.sr_batch([load_image_rgb(p) for p in frames])
        sr_batch_gap = max(float(np.abs(b - w).max()) for b, w in zip(main_batched, want))
        reply_vs_batch = [_png_levels(r[1], b) for r, b in zip(replies, main_batched)]
        print(f"http {tag} burst: {HTTP_BURST} concurrent POST /sr of 256x256 in {burst_s:.2f} s, {forwards} forwards "
              f"({calls} rdb_forward calls), replies within {levels} level(s) and {psnr:.2f} dB of sr_array, "
              f"{100 * spread:.0f}% of SR in (0.05, 0.95); with the plain RDB a batch of 16 against 16 single "
              f"forwards: max abs {batch_gap:.3g}; on this thread sr_batch against sr_array max abs {sr_batch_gap:.3g}, "
              f"the replies within {max(r[0] for r in reply_vs_batch)} level(s) of it; client ms p50 {np.percentile([r[3] for r in replies], 50):.2f} max "
              f"{max(r[3] for r in replies):.2f}", flush=True)

        with engine.stats_lock:
            engine.latencies_ms.clear()
        rdb.launches = rdb.launches_bwd = 0
        sparse = []
        for i in range(HTTP_SPARSE):
            t0 = time.perf_counter()
            status, body, _ = _http(port, "POST", "/sr", bodies[i])
            sparse.append((time.perf_counter() - t0) * 1e3)
            check(status == 200 and _http_agrees(tag, _png_levels(body, want[i])), f"{tag} sparse request {i}: {status}")
        calls = rdb.launches
        launches += calls
        check(calls == HTTP_SPARSE * RDB_PER_FORWARD, f"{tag} sparse: {calls} rdb_forward calls")
        stats = json.loads(_http(port, "GET", "/stats")[1])
        out[tag] = {
            "burst_s": burst_s, "burst_forwards": forwards, "burst_levels": levels, "burst_psnr": psnr,
            "burst_spread": spread, "plain_batch16_vs_single_max_abs": batch_gap,
            "sr_batch_vs_sr_array_max_abs": sr_batch_gap,
            "reply_vs_sr_batch_levels": max(r[0] for r in reply_vs_batch),
            "burst_client_ms": sorted(r[3] for r in replies),
            "sparse_ms_p50": float(np.percentile(sparse, 50)), "sparse_ms_p95": float(np.percentile(sparse, 95)),
            "stats_p50_ms": stats["p50_ms"], "stats_p95_ms": stats["p95_ms"], "stats": stats,
        }
        print(f"http {tag} sparse: {HTTP_SPARSE} sequential requests, host-clock ms p50 "
              f"{out[tag]['sparse_ms_p50']:.2f} p95 {out[tag]['sparse_ms_p95']:.2f}; /stats p50 {stats['p50_ms']} p95 "
              f"{stats['p95_ms']} (decode to encode), served {stats['served']}, queue "
              f"{stats['queue_depth']}/{stats['queue_capacity']}", flush=True)
        out[tag]["drain_s"] = _stop_http(th, stop, f"{tag} micro-batched")
        if not half:
            out["f32_launches"] = launches  # every call so far ran the f32 kernel
            del engine
            continue

        # the overload limits, on the bf16 engine: a 1 MB body cap, a queue of one
        port, th, stop = _start_http(engine, max_body_bytes=1 << 20, max_queue=1)
        check(_http(port, "GET", "/healthz")[:2] == (200, b"ok"), "/healthz")
        # the headers alone: the server answers before reading any body
        import socket

        with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
            sock.sendall(b"POST /sr HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n" % (2 << 20))
            status_line = sock.recv(64).split(b"\r\n", 1)[0]
        check(b" 413 " in status_line, f"a 2 MB body against a 1 MB cap: {status_line}")
        rdb.launches = rdb.launches_bwd = 0
        flood = _burst(port, bodies[:16])
        launches += rdb.launches
        statuses = [r[0] for r in flood]
        rejected = statuses.count(503)
        check(set(statuses) <= {200, 503} and rejected >= 1 and statuses.count(200) >= 1,
              f"a burst of 16 against a queue of 1: {statuses}")
        check(all(r[2].get("Retry-After") == "1" for r in flood if r[0] == 503), "503 without Retry-After: 1")
        stats = json.loads(_http(port, "GET", "/stats")[1])
        check(stats["rejected"] == rejected and stats["rejected_oversize"] == 1 and stats["queue_capacity"] == 1,
              f"overload stats {stats}")
        check(_http(port, "GET", "/healthz")[:2] == (200, b"ok"), "/healthz after the flood")
        out["overload"] = {"statuses": statuses, "rejected": rejected, "rejected_oversize": stats["rejected_oversize"]}
        print(f"http overload: 413 for a 2 MB body (cap 1 MB); a burst of 16 against --max-queue 1: "
              f"{statuses.count(200)} served, {rejected} x 503 with Retry-After 1; /stats rejected {stats['rejected']}, "
              f"rejected_oversize {stats['rejected_oversize']}", flush=True)
        out["overload"]["drain_s"] = _stop_http(th, stop, "overload")

        # --batch 1: the single-threaded server runs sr_array on its own thread
        engine.batch = 1
        port, th, stop = _start_http(engine)
        rdb.launches = rdb.launches_bwd = 0
        status, body, _ = _http(port, "POST", "/sr", bodies[0])
        calls = rdb.launches
        launches += calls
        check(status == 200 and _http_agrees(tag, _png_levels(body, want[0])) and calls == RDB_PER_FORWARD,
              f"--batch 1 server: {status}, {calls} rdb_forward calls")
        stats = json.loads(_http(port, "GET", "/stats")[1])
        check("queue_depth" not in stats, "the single-threaded server reports a queue")
        out["single_threaded_drain_s"] = _stop_http(th, stop, "single-threaded")
        print(f"http --batch 1 (single-threaded): one request, {calls} rdb_forward calls; drains in "
              f"{out['single_threaded_drain_s']:.2f} s (micro-batched {out['bf16']['drain_s']:.2f} s)", flush=True)
        del engine
    return launches, out


def gen_phase(work: str, rdb, blocks) -> tuple[int, dict]:
    """A-ESRGAN's generators at full width: ``gen_rrdb2x`` (64/32/23 over the
    unshuffled half-size frame) on spread seeded weights through ``cli.serve
    --stdio``'s loop (2 requests of 256x256, f32 and bf16, 69 RDB kernel
    calls a forward, the model held to its plain-RDB twin at the serving
    limits) and ``cli.infer``; ``gen_rpa2x`` (64 features, 20 blocks, no
    kernel) over stdio: shape and finite values; then one bf16 ``bsrnet``
    step of each with ``g_arch`` overridden (batch 16, GT 144): a finite
    loss and a G that moved. Returns the RDB kernel calls and readings."""
    import cv2

    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli import infer
    from srganfd_tpu_torch.cli.serve import ServingEngine, serve_stdio
    from srganfd_tpu_torch.data.datasets import load_image_rgb
    from srganfd_tpu_torch.train.loop import Trainer

    frames = write_frames(os.path.join(work, "gen_lr"), 2, 256, 256, seed=30)
    weights = {"gen_rrdb2x": spread_weights(work, "gen_rrdb2x", gain=0.5),
               "gen_rpa2x": spread_weights(work, "gen_rpa2x", gain=1.0)}
    launches, out = 0, {"f32_launches": 0}
    for arch, half in (("gen_rrdb2x", False), ("gen_rrdb2x", True), ("gen_rpa2x", False), ("gen_rpa2x", True)):
        tag = "bf16" if half else "f32"
        engine = ServingEngine(arch, weights=weights[arch], half=half, device="cuda")
        reqs = [{"id": i, "input": p, "output": os.path.join(work, f"gen_sr_{arch}_{tag}", f"{i}.png")}
                for i, p in enumerate(frames)]
        lines = [json.dumps(r) for r in reqs] + ['{"cmd": "stats"}', '{"cmd": "shutdown"}']
        stdout = io.StringIO()
        rdb.launches = rdb.launches_bwd = 0
        serve_stdio(engine, inp=io.StringIO("\n".join(lines)), out=stdout)
        torch.cuda.synchronize()
        calls = rdb.launches
        launches += calls
        out["f32_launches"] += 0 if half else calls
        replies = [json.loads(line) for line in stdout.getvalue().splitlines()]
        for r in replies[:-1]:
            check(r.get("ok") and r["out_hw"] == [512, 512], f"{arch} {tag} reply {r}")
        per_forward = RDB_PER_FORWARD if arch == "gen_rrdb2x" else 0
        check(calls == len(frames) * per_forward, f"{arch} {tag}: {calls} rdb_forward calls for {len(frames)} forwards")
        x = torch.from_numpy(load_image_rgb(frames[0])[None]).cuda()
        if arch == "gen_rrdb2x":
            y = hold_model_to_plain(engine.model, x, tag, arch, rdb, blocks)
        else:  # no kernel: its plain version is itself
            with torch.inference_mode():
                y = engine.model(x)
            check(tuple(y.shape) == (1, 512, 512, 3) and torch.isfinite(y).all().item(), f"{arch} {tag}: {y.shape}")
        with torch.inference_mode():
            ms = cuda_ms(lambda: engine.model(x), iters=5, warmup=1)
        out[f"{arch} {tag}"] = {"forward_ms": ms, "mean": y.mean().item(), "std": y.std().item(),
                                "stdio_ms": [r["ms"] for r in replies[:-1]], "rdb_launches": calls}
        print(f"{arch} {tag}: 2 stdio requests of 256x256 -> 512x512, {calls} rdb_forward calls; one forward on the "
              f"card {ms:.2f} ms; output mean {y.mean().item():.4f} std {y.std().item():.4f}", flush=True)
        del engine

    frames_dir, out_dir = os.path.join(work, "gen_seq"), os.path.join(work, "gen_seq_sr")
    write_frames(frames_dir, 2, 256, 256, seed=31)
    for half in (False, True):
        rdb.launches = rdb.launches_bwd = 0
        infer.main(["--model-arch", "gen_rrdb2x", "--batch", "2", "--weights", weights["gen_rrdb2x"],
                    "--inputs-path", frames_dir, "--output-path", out_dir, *(["--half"] if half else [])])
        torch.cuda.synchronize()
        calls = rdb.launches
        launches += calls
        out["f32_launches"] += 0 if half else calls
        outs = sorted(os.listdir(out_dir))
        check(len(outs) == 2 and all(cv2.imread(os.path.join(out_dir, n)).shape == (512, 512, 3) for n in outs),
              f"gen_rrdb2x infer wrote {outs}")
        check(calls == RDB_PER_FORWARD, f"gen_rrdb2x infer: {calls} rdb_forward calls for 1 forward")
    print(f"cli.infer gen_rrdb2x --batch 2, f32 and bf16: 2 frames each, {RDB_PER_FORWARD} rdb_forward calls a run",
          flush=True)

    gt = torch.rand((16, 144, 144, 3), generator=torch.Generator().manual_seed(32)).cuda()
    lr = gt[:, ::2, ::2].contiguous()
    for arch in ("gen_rrdb2x", "gen_rpa2x"):
        cfg = configs.get_config("bsrnet", g_arch=arch, g_kwargs={})
        tr = Trainer(cfg, steps_per_epoch=1, device=torch.device("cuda"))
        st = tr.init_state()
        before = {k: v.detach().clone() for k, v in st.g_model.named_parameters()}
        rdb.launches = rdb.launches_bwd = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = tr.train_step(st, gt, lr)
        loss = float(metrics["pixel_loss"])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        calls = rdb.launches
        launches += calls
        moved = max((p.detach() - before[k]).abs().max().item() for k, p in st.g_model.named_parameters())
        check(math.isfinite(loss) and moved > 0, f"{arch} bf16 step: loss {loss}, G moved {moved}")
        want = RDB_PER_FORWARD if arch == "gen_rrdb2x" else 0
        check((calls, rdb.launches_bwd) == (want, want),
              f"{arch} step: {calls} rdb_forward and {rdb.launches_bwd} backward calls")
        out[f"{arch} step"] = {"loss": loss, "moved": moved, "first_step_ms": step_ms, "rdb_launches": calls,
                               "compute_dtype": cfg.compute_dtype}
        print(f"{arch} bsrnet step ({cfg.compute_dtype}, batch 16, GT 144): L1 {loss:.5f}, G moved up to {moved:.3g}, "
              f"{calls} rdb_forward calls, first step {step_ms:.1f} ms host clock", flush=True)
        del tr, st
    return launches, out


# -- the trainer's options, preemption, the guard, accumulation, --debug-nans,
# flash attention's backward and the degradation CLI --------------------------

OPT_STEPS_PER_EPOCH, OPT_EPOCHS = 4, 2  # the options run profiles epoch 0 and is timed on epoch 1
PRE_STEPS_PER_EPOCH, PRE_EPOCHS = 4, 1  # the preemption runs: SIGTERM during the epoch
PRE_WARNED_REL = 1e-4  # resumed against uninterrupted where an op has no deterministic implementation
DEG_FRAMES, DEG_SIZE = 4, 512  # cli.test_degradations' frames
# a subprocess of cli.train with deterministic algorithms where PyTorch has
# them (warn_only: an op without one warns, naming itself, and runs)
DETERMINISTIC_TRAIN = ("import sys, torch; torch.use_deterministic_algorithms(True, warn_only=True); "
                       "from srganfd_tpu_torch.cli.train import main; main(sys.argv[1:])")


def _record_steps(Trainer, steps: list, metrics_seen: list):
    """Trainer.train_step wrapped to read each step's metrics (a sync) and
    record (step index, host clock at entry, at end); returns the real one."""
    real_step = Trainer.train_step

    def recorded(self, state, gt, lr_img, gt_pixel=None):
        entry, index = time.perf_counter(), state.step
        m = real_step(self, state, gt, lr_img, gt_pixel)
        metrics_seen.append({k: v.item() for k, v in m.items()})
        steps.append((index, entry, time.perf_counter()))
        return m

    Trainer.train_step = recorded
    return real_step


def _trace_kernels(path: str) -> dict[str, float]:
    """Device time (ms) by name of the kernels, copies and sets in a Chrome
    trace that torch.profiler wrote."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name: dict[str, float] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0.0) / 1e3
    return by_name


def options_phase(work: str, rdb, f2d) -> tuple[dict, dict]:
    """``bsrgan`` at full width (the config unchanged: batch 16, GT 144,
    bf16, 64/32/23) through cli.train.run_train twice on the bsrnet phase's
    frames, OPT_EPOCHS epochs of OPT_STEPS_PER_EPOCH steps each: as it is,
    and with --grad-accum 2 --skip-nonfinite --save-every-steps 2
    --ckpt-every-epochs 2 --async-ckpt --profile-dir. Step p50 (epoch 1,
    outside the profiler), peak memory and kernel calls of both; the
    snapshots the options wrote; the trace names both kernels, and its top
    10 device operations. Returns the kernel calls and the numbers."""
    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli import train as cli_train
    from srganfd_tpu_torch.train import checkpoint as ckpt
    from srganfd_tpu_torch.train.loop import Trainer
    from srganfd_tpu_torch.utils import profiling

    base = configs.get_config("bsrgan").replace(
        train_gt_images_dir=os.path.join(work, "train_gt"), valid_gt_images_dir=os.path.join(work, "valid_gt"),
        results_dir=os.path.join(work, "opt_results"), samples_dir=os.path.join(work, "opt_samples"),
        epochs=OPT_EPOCHS,
    )
    prof_dir = os.path.join(work, "opt_profile")
    n_steps, n_valid = OPT_STEPS_PER_EPOCH * OPT_EPOCHS, OPT_EPOCHS
    out, calls_all = {}, {"rdb": 0, "rdb_bwd": 0, "filter2d": 0}
    for tag in ("plain", "options"):
        cfg, kw = base.replace(exp_name=f"BSRGAN_x2_{tag}"), {}
        if tag == "options":
            cfg = cfg.replace(grad_accum_steps=2, skip_nonfinite_updates=True)
            kw = dict(save_every_steps=2, ckpt_every_epochs=2, async_ckpt=True, profile_dir=prof_dir)
        steps, metrics_seen = [], []
        real_step = _record_steps(Trainer, steps, metrics_seen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rdb.launches = rdb.launches_bwd = f2d.launches = 0
        t0 = time.perf_counter()
        try:
            result = cli_train.run_train(cfg, OPT_STEPS_PER_EPOCH, device="cuda", **kw)
            torch.cuda.synchronize()
        finally:
            Trainer.train_step = real_step
        run_s = time.perf_counter() - t0
        calls = {"rdb": rdb.launches, "rdb_bwd": rdb.launches_bwd, "filter2d": f2d.launches}
        calls_all = {k: calls_all[k] + v for k, v in calls.items()}
        # a D-first step under accumulation: one forward of G without a graph
        # for D, then G by chunks (2 forwards); validation one forward a batch
        g_forwards = (3 if tag == "options" else 1) * n_steps + n_valid
        # under accumulation G's graph runs by chunks: 2 backwards a step
        check(calls == {"rdb": RDB_PER_FORWARD * g_forwards,
                        "rdb_bwd": RDB_PER_FORWARD * (2 if tag == "options" else 1) * n_steps,
                        "filter2d": FILTERS_PER_CHAIN * (n_steps + n_valid)},
              f"bsrgan {tag}: {calls} kernel calls for {n_steps} steps and {n_valid} validation batches")
        check(len(metrics_seen) == n_steps and result["state"].step == n_steps, f"bsrgan {tag}: {len(metrics_seen)} steps")
        check(all(math.isfinite(v) for m in metrics_seen for v in m.values()), f"bsrgan {tag}: {metrics_seen}")
        if tag == "options":
            skipped = [(m["g_update_skipped"], m["d_update_skipped"]) for m in metrics_seen]
            check(all(s == (0.0, 0.0) for s in skipped), f"finite steps skipped: {skipped}")
            check((result["state"].g_count, result["state"].d_count) == (n_steps, n_steps), "applied-update counts")
        ckpt_dir = os.path.join(cfg.results_dir, cfg.exp_name)
        last = ckpt.load_checkpoint(os.path.join(ckpt_dir, "ckpt_last.pth"))
        check(last["step"] == n_steps, f"bsrgan {tag}: ckpt_last at step {last['step']}")
        if tag == "options":
            snap = ckpt.load_checkpoint(os.path.join(ckpt_dir, "ckpt_step_last.pth"))
            # saved after global steps 2, 4 and 6: the last holds 7 steps
            check(snap["step"] == n_steps - 1, f"ckpt_step_last at step {snap['step']}")
        intervals = [(b[2] - a[2]) * 1e3 for a, b in zip(steps, steps[1:])
                     if b[0] == a[0] + 1 and b[0] // OPT_STEPS_PER_EPOCH == OPT_EPOCHS - 1 and b[0] % OPT_STEPS_PER_EPOCH]
        out[tag] = {"step_ms_p50": float(np.median(intervals)), "steps_timed": len(intervals),
                    "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "run_s": run_s,
                    "rdb_launches": calls["rdb"], "filter2d_launches": calls["filter2d"]}
        print(f"bsrgan {tag} (bf16, batch 16, GT 144): step p50 {out[tag]['step_ms_p50']:.2f} ms host clock over "
              f"{len(intervals)} steps of epoch {OPT_EPOCHS - 1}, peak memory {out[tag]['peak_memory_gb']:.2f} GB, "
              f"{calls} kernel calls, {run_s:.1f} s", flush=True)

    # one step on the card (CUDA events) from the options run's final state
    # on one batch: accumulation and the guard without the loop's host work
    # (the snapshots' copies and writes, the loader)
    from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
    from srganfd_tpu_torch.data.datasets import BatchLoader

    state = result["state"]
    it = iter(BatchLoader(cli_train.build_datasets(base)[0], base.batch_size, seed=base.seed, num_workers=2))
    batch = DegradationAdapter(base, seed=base.seed, train=True, device="cuda")(next(it), 0)
    it.close()
    card_ms = {}
    for label, over in (("plain", {}), ("grad_accum_2", {"grad_accum_steps": 2}),
                        ("grad_accum_2_guard", {"grad_accum_steps": 2, "skip_nonfinite_updates": True})):
        tr = Trainer(base.replace(**over), steps_per_epoch=OPT_STEPS_PER_EPOCH, device="cuda")
        card_ms[label] = cuda_ms(lambda: tr.train_step(state, batch["gt"], batch["lr"]), iters=3, warmup=1)
    out["train_step_ms"] = card_ms
    print(f"bsrgan step on the card (CUDA events, 3 after 1): { {k: round(v, 2) for k, v in card_ms.items()} } ms",
          flush=True)

    # one snapshot of that state, host clock, twice: the host copy alone,
    # --async-ckpt's save until it returns (the copy, then the queue) and
    # until the writer has it on disk, and a synchronous save
    snap_dir = os.path.join(work, "opt_snap")
    snap = {"host_copy_ms": [], "async_return_ms": [], "async_written_ms": [], "sync_ms": []}
    with ckpt.AsyncCheckpointWriter() as writer:
        for _ in range(2):
            t0 = time.perf_counter()
            ckpt.host_payload(state, 0, {})
            snap["host_copy_ms"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            writer.save(snap_dir, state, 0, {}, False, name="ckpt_step")
            snap["async_return_ms"].append((time.perf_counter() - t0) * 1e3)
            writer.wait()
            snap["async_written_ms"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            ckpt.save_checkpoint(snap_dir, state, 0, {}, False, name="ckpt_sync")
            snap["sync_ms"].append((time.perf_counter() - t0) * 1e3)
    snap["mb"] = os.path.getsize(os.path.join(snap_dir, "ckpt_sync_last.pth")) / 1e6
    out["snapshot"] = snap
    print(f"one bsrgan snapshot ({snap['mb']:.1f} MB), host clock, two of each: host copy "
          f"{[round(v, 2) for v in snap['host_copy_ms']]} ms; --async-ckpt save returns after "
          f"{[round(v, 2) for v in snap['async_return_ms']]} ms, on disk after "
          f"{[round(v, 2) for v in snap['async_written_ms']]}; synchronous save "
          f"{[round(v, 2) for v in snap['sync_ms']]} ms", flush=True)

    trace = profiling.trace_file(prof_dir)
    check(os.path.isfile(trace), f"no profiler trace at {trace}")
    by_name = _trace_kernels(trace)
    with open(trace) as f:
        text = f.read()
    for name in ("conv3x3_mma_kernel", "filter2d_tf32_kernel", "g_update", "d_update", "chain", "ema"):
        check(name in text, f"the profiler trace does not name {name}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    total = sum(by_name.values())
    print(f"profiler trace of epoch 0 ({os.path.getsize(trace) / 1e6:.1f} MB): {total:.1f} ms of device time in "
          f"{len(by_name)} operations; top 10:", flush=True)
    for name, ms in top:
        print(f"  {ms:9.2f} ms  {100 * ms / total:5.1f}%  {name[:140]}", flush=True)
    out["trace_device_ms"] = total
    out["trace_top10"] = [(name[:140], ms) for name, ms in top]
    return calls_all, out


def _pre_run(work: str, cwd: str, extra: list[str], signal_after: str | None = None) -> tuple[int, str, str]:
    """One cli.train subprocess (bsrgan on the bsrnet phase's frames) with
    deterministic algorithms; with ``signal_after``, SIGTERM once its
    standard output shows that line. Returns (exit code, stdout, stderr)."""
    import signal

    os.makedirs(cwd, exist_ok=True)
    argv = [sys.executable, "-u", "-c", DETERMINISTIC_TRAIN, "--config", "bsrgan",
            "--train-dir", os.path.join(work, "train_gt"), "--valid-dir", os.path.join(work, "valid_gt"),
            "--steps-per-epoch", str(PRE_STEPS_PER_EPOCH), "--epochs", str(PRE_EPOCHS), *extra]
    env = dict(os.environ, PYTHONPATH=ROOT, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    err_path = os.path.join(cwd, f"stderr_{len(os.listdir(cwd))}.txt")
    lines = []
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen(argv, cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=err_file, text=True)
        try:
            for line in proc.stdout:
                lines.append(line)
                if signal_after is not None and line.startswith(signal_after):
                    proc.send_signal(signal.SIGTERM)
                    signal_after = None
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(err_path) as f:
        return rc, "".join(lines), f.read()


def preempt_phase(work: str) -> dict:
    """SIGTERM to a cli.train subprocess (full-width bsrgan, PRE_EPOCHS
    epochs of PRE_STEPS_PER_EPOCH steps) once epoch 0's first step is
    reported: exit 143 and ckpt_preempt_last.pth at the applied step it
    printed; --resume auto finishes the run; the final G, D and Adams
    against an uninterrupted run's, all three under
    torch.use_deterministic_algorithms(True, warn_only=True): bit for bit,
    or the difference printed beside the ops that warned."""
    from srganfd_tpu_torch.train import checkpoint as ckpt

    rc, stdout, err = _pre_run(work, os.path.join(work, "pre_cut"), [], signal_after="Epoch[0][0/")
    check(rc == 143, f"SIGTERM gave exit {rc}: {stdout[-2000:]} {err[-2000:]}")
    cut_dir = os.path.join(work, "pre_cut", "results", "BSRGAN_x2")
    written = [ln for ln in stdout.splitlines() if ln.startswith("preemption checkpoint written at step")]
    check(len(written) == 1, f"no preemption line: {stdout[-2000:]}")
    applied = int(written[0].split("at step ")[1].split(";")[0])
    snap = ckpt.load_checkpoint(os.path.join(cut_dir, "ckpt_preempt_last.pth"))
    check(snap["step"] == applied and 0 < applied < PRE_STEPS_PER_EPOCH * PRE_EPOCHS,
          f"ckpt_preempt_last at step {snap['step']}, the run applied {applied}")
    rc, stdout_resumed, err_resumed = _pre_run(work, os.path.join(work, "pre_cut"), ["--resume", "auto"])
    check(rc == 0, f"the resumed run gave exit {rc}: {err_resumed[-2000:]}")
    check(f"resumed from {os.path.join('results', 'BSRGAN_x2', 'ckpt_preempt_last.pth')} at step {applied}"
          in stdout_resumed, f"the resumed run did not start at the preemption snapshot: {stdout_resumed[-1500:]}")
    rc, _, err_whole = _pre_run(work, os.path.join(work, "pre_whole"), [])
    check(rc == 0, f"the uninterrupted run gave exit {rc}: {err_whole[-2000:]}")
    got = ckpt.load_checkpoint(os.path.join(cut_dir, "ckpt_last.pth"))
    want = ckpt.load_checkpoint(os.path.join(work, "pre_whole", "results", "BSRGAN_x2", "ckpt_last.pth"))
    check(got["step"] == want["step"] == PRE_STEPS_PER_EPOCH * PRE_EPOCHS, f"final steps {got['step']} {want['step']}")
    diffs = {}
    for key in ("state_dict", "ema_state_dict", "d_state_dict"):
        for name, w in want[key].items():
            g = got[key][name]
            if w.is_floating_point():
                diffs[f"{key}/{name}"] = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
    exact = all(v == 0.0 for v in diffs.values())
    worst_rel = max(diffs.values())
    warned = sorted({ln.split("UserWarning: ")[1][:160] for e in (err, err_resumed, err_whole)
                     for ln in e.splitlines() if "does not have a deterministic implementation" in ln})
    worst = sorted(diffs.items(), key=lambda kv: -kv[1])[:5]
    print(f"preemption: SIGTERM after epoch 0's first step, exit 143, ckpt_preempt_last at step {applied}; the "
          f"resumed run vs the uninterrupted one: {'bit for bit' if exact else 'not bit for bit'} over "
          f"{len(diffs)} tensors of G, EMA-G and D, worst per-tensor relative {worst}; ops without a "
          f"deterministic implementation: {warned}", flush=True)
    check(all(math.isfinite(v) for v in diffs.values()), "non-finite final state")
    # bit for bit unless an op warned. Then only its roundoff can part the
    # runs, over the steps after the resume: held per tensor to
    # PRE_WARNED_REL of the tensor's largest entry, the top of the range
    # PERF.md predicted for it; a wrong resume (an Adam state, a generator
    # or the loader's position) moves a tensor by a whole update, lr =
    # 8e-5 against entries of 1e-2 - 1e-1
    if warned:
        check(worst_rel <= PRE_WARNED_REL, f"the runs differ by {worst} with {warned} warned")
    else:
        check(exact, f"the runs differ with no non-deterministic op warned: {worst}")
    return {"applied_step": applied, "bit_for_bit": exact, "max_rel_diff": worst_rel,
            "worst": worst, "nondeterministic_ops": warned}


def _state_copy(state) -> dict:
    """Every tensor of a TrainState, cloned on its device, and its counts."""
    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(clone(v) for v in x)
        return copy.deepcopy(x)

    return {"g": clone(state.g_model.state_dict()), "d": clone(state.d_model.state_dict()),
            "g_opt": clone(state.g_opt.state_dict()), "d_opt": clone(state.d_opt.state_dict()),
            "ema": clone(state.ema_g), "counts": (state.g_count, state.d_count)}


def _diff(a, b) -> float:
    """Largest difference over two nested state copies, each tensor's
    relative to its largest entry in ``b`` (0.0: bit for bit; inf: another
    structure)."""
    if isinstance(a, torch.Tensor):
        if not a.numel():
            return 0.0
        return (a.double() - b.double()).abs().max().item() / max(b.double().abs().max().item(), 1e-30)
    if isinstance(a, dict):
        return max((_diff(a[k], b[k]) for k in a), default=0.0) if a.keys() == b.keys() else math.inf
    if isinstance(a, (list, tuple)):
        return max((_diff(x, y) for x, y in zip(a, b)), default=0.0) if len(a) == len(b) else math.inf
    return 0.0 if a == b else math.inf


def guard_phase(work: str, rdb, f2d) -> dict:
    """One f32 ``bsrgan`` step (full width, batch 16, GT 144) with
    skip_nonfinite_updates on a batch whose LR holds an Inf pixel: both
    phases skip and G, D (its ``u``), both Adams (``step`` too), EMA-G and
    the counts are bit for bit as before; then a finite step from there
    against the same step from a twin loaded with the pre-plant state."""
    import warnings

    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
    from srganfd_tpu_torch.data.datasets import BatchLoader
    from srganfd_tpu_torch.cli import train as cli_train
    from srganfd_tpu_torch.train.loop import Trainer

    cfg = configs.get_config("bsrgan", compute_dtype="float32", skip_nonfinite_updates=True,
                             train_gt_images_dir=os.path.join(work, "train_gt"),
                             valid_gt_images_dir=os.path.join(work, "valid_gt"))
    loader = BatchLoader(cli_train.build_datasets(cfg)[0], cfg.batch_size, seed=cfg.seed, num_workers=2)
    it = iter(loader)
    adapter = DegradationAdapter(cfg, seed=cfg.seed, train=True, device="cuda")
    batches = [adapter(next(it), i) for i in range(3)]
    it.close()
    trainer = Trainer(cfg, steps_per_epoch=100, device="cuda")
    state = trainer.init_state()
    rdb.launches = rdb.launches_bwd = 0
    trainer.train_step(state, batches[0]["gt"], batches[0]["lr"])
    before = _state_copy(state)
    planted = batches[1]["lr"].clone()
    planted[3, 10, 10, 1] = float("inf")
    m = trainer.train_step(state, batches[1]["gt"], planted)
    skipped = (m["g_update_skipped"].item(), m["d_update_skipped"].item())
    check(skipped == (1.0, 1.0), f"the planted Inf skipped {skipped}")
    off = _diff(_state_copy(state), before)
    check(off == 0.0 and state.step == 2, f"a skipped step moved the state by {off} (step {state.step})")

    twin_trainer = Trainer(cfg, steps_per_epoch=100, device="cuda")
    twin = twin_trainer.init_state()
    twin.g_model.load_state_dict(before["g"])
    twin.d_model.load_state_dict(before["d"])
    # copies: an optimizer's load_state_dict keeps the tensors it is given
    twin.g_opt.load_state_dict(copy.deepcopy(before["g_opt"]))
    twin.d_opt.load_state_dict(copy.deepcopy(before["d_opt"]))
    with torch.no_grad():
        for k, v in before["ema"].items():
            twin.ema_g[k].copy_(v)
    twin.step, (twin.g_count, twin.d_count) = 1, before["counts"]
    torch.backends.cudnn.deterministic = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            trainer.train_step(state, batches[2]["gt"], batches[2]["lr"])
            twin_trainer.train_step(twin, batches[2]["gt"], batches[2]["lr"])
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
    warned = sorted({str(w.message)[:160] for w in caught if "deterministic" in str(w.message)})
    after, twin_after = _state_copy(state), _state_copy(twin)
    parts = {k: _diff(after[k], twin_after[k]) for k in after}
    print(f"guard (f32 bsrgan, batch 16): the Inf step skipped both updates and left every tensor bit for bit; "
          f"the next step vs the twin's from the pre-plant state: largest relative difference by part {parts}; ops "
          f"without a deterministic implementation: {warned}; {rdb.launches} rdb calls", flush=True)
    check(parts["counts"] == 0.0 and state.g_count == 2 and state.d_count == 2, f"counts {parts['counts']}")
    # bit for bit unless an op warned; then its roundoff in one step, held
    # per tensor as the preemption runs hold theirs (PRE_WARNED_REL)
    if warned:
        check(all(v <= PRE_WARNED_REL for v in parts.values()), f"the step after the skip: {parts}, {warned} warned")
    else:
        check(all(v == 0.0 for v in parts.values()), f"the step after the skip differs from the twin's: {parts}")
    return {"skipped": skipped, "next_step_vs_twin": parts, "nondeterministic_ops": warned,
            "rdb_launches": rdb.launches}


def accum_phase(work: str, rdb) -> dict:
    """One f32 ``bsrnet`` step (full width, batch 16, GT 144) with
    grad_accum_steps 2 against the same step at 1 from the same state and
    batch. The pixel loss is a mean, so the accumulated gradient is the
    batch's up to the summation order: each G gradient tensor held to 1e-4
    of its largest entry (f32 sums of O(10^4) terms in another order).
    After the update: Adam's first step is lr * g / (|g| + eps), so G may
    differ by up to 2 lr only where a gradient's sign turned over in that
    roundoff: held elementwise to 2 lr, and G's per-tensor relative
    difference printed."""
    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli import train as cli_train
    from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
    from srganfd_tpu_torch.data.datasets import BatchLoader
    from srganfd_tpu_torch.train.loop import Trainer

    cfg = configs.get_config("bsrnet", compute_dtype="float32", train_gt_images_dir=os.path.join(work, "train_gt"),
                             valid_gt_images_dir=os.path.join(work, "valid_gt"))
    loader = BatchLoader(cli_train.build_datasets(cfg)[0], cfg.batch_size, seed=cfg.seed, num_workers=2)
    it = iter(loader)
    batch = DegradationAdapter(cfg, seed=cfg.seed, train=True, device="cuda")(next(it), 0)
    it.close()
    results = {}
    rdb.launches = rdb.launches_bwd = 0
    for accum in (1, 2):
        trainer = Trainer(cfg.replace(grad_accum_steps=accum), steps_per_epoch=100, device="cuda")
        state = trainer.init_state()
        m = trainer.train_step(state, batch["gt"], batch["lr"])
        results[accum] = (m["pixel_loss"].item(), {n: p.grad.detach().clone() for n, p in state.g_model.named_parameters()},
                          {n: p.detach().clone() for n, p in state.g_model.named_parameters()})
    check((rdb.launches, rdb.launches_bwd) == (RDB_PER_FORWARD * 3, RDB_PER_FORWARD * 3),
          f"{rdb.launches} rdb forward and {rdb.launches_bwd} backward calls for one step at 1 and one at 2")
    lr = cfg.model_lr
    grad_rel = {n: ((results[2][1][n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
                for n, g in results[1][1].items()}
    g_rel = {n: ((results[2][2][n] - p).abs().max() / p.abs().max().clamp_min(1e-30)).item()
             for n, p in results[1][2].items()}
    g_abs = max((results[2][2][n] - p).abs().max().item() for n, p in results[1][2].items())
    moved = sum(int(((results[2][2][n] - p).abs() > 1e-3 * lr).sum()) for n, p in results[1][2].items())
    total = sum(p.numel() for p in results[1][2].values())
    worst_grad = max(grad_rel.items(), key=lambda kv: kv[1])
    worst_g = max(g_rel.items(), key=lambda kv: kv[1])
    loss_rel = abs(results[2][0] - results[1][0]) / results[1][0]
    print(f"accumulation (f32 bsrnet, batch 16 as 2 x 8): pixel loss rel {loss_rel:.3g}; gradients per tensor "
          f"worst {worst_grad[1]:.3g} ({worst_grad[0]}); G after the step per tensor worst {worst_g[1]:.3g} "
          f"({worst_g[0]}), largest |dG| {g_abs:.3g} (2 lr = {2 * lr:.3g}), {moved} of {total} parameters apart "
          f"by more than 1e-3 lr", flush=True)
    check(loss_rel <= 1e-5, f"accumulated pixel loss off by {loss_rel}")
    check(worst_grad[1] <= 1e-4, f"accumulated gradient off by {worst_grad}")
    check(g_abs <= 2 * lr * (1 + 1e-5), f"G apart by {g_abs} > 2 lr")
    return {"loss_rel": loss_rel, "grad_rel_worst": worst_grad, "g_rel_worst": worst_g, "g_abs_max": g_abs,
            "params_apart": moved, "params": total, "rdb_launches": rdb.launches}


def _plant_device_nan(t: torch.Tensor, index: tuple) -> torch.Tensor:
    """A copy of f32 ``t`` holding the device's own NaN (0x7fffffff, what
    the card's arithmetic puts out) at ``index``: the bits the TF32 split
    once rounded to -0, where a NaN typed on the host (0x7fc00000) survived."""
    t = t.clone()
    t.view(torch.int32)[index] = 0x7FFFFFFF
    return t


def _keeps_nans(got: torch.Tensor, want: torch.Tensor) -> tuple[bool, int, int]:
    """Whether the kernel puts out a NaN wherever the plain version does
    (it may put out more: a NaN times a zero tap of a band or a Winograd
    tile is NaN, and an algorithm's reach differs), and how many each puts
    out."""
    g, w = torch.isnan(got), torch.isnan(want)
    return bool(w.any()) and bool(g[w].all()), int(g.sum()), int(w.sum())


def debug_nans_phase(rdb, f2d, attn) -> dict:
    """--debug-nans' hooks on the card, full-width bsrgan_x2 in f32: a NaN
    pixel in the frame raises FloatingPointError at the first conv; a NaN
    put into the first RDB's input (a forward pre-hook) and a NaN weight
    in its third conv raise at that RDB, whose output is the hand-written
    kernel's. Then every kernel against its plain version on the same
    inputs, both dtypes: a NaN wherever the plain version puts one out, so
    that --debug-nans and --skip-nonfinite see it: the RDB with a NaN
    weight in conv3 (conv4 reads the NaNs conv3 computed: the device's
    0x7fffffff) and with the device's NaN in x; filter2d and flash
    attention with it in the image, in q and in k."""
    from srganfd_tpu_torch.models import create_model
    from srganfd_tpu_torch.utils.profiling import debug_nans

    model = create_model("bsrgan_x2", generator=torch.Generator().manual_seed(0)).cuda()
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(1)).cuda()
    raised = {}
    rdb.launches = rdb.launches_bwd = 0
    rdb1 = model.trunk[0].rdb1
    for case in ("frame", "rdb_input", "rdb_weight"):
        frame, handle, weight = x.clone(), None, rdb1.conv3.weight.detach().clone()
        if case == "frame":
            frame[0, 5, 5, 1] = float("nan")
        elif case == "rdb_input":
            def plant(module, args):
                planted = args[0].clone()
                planted[0, 3, 7, 7] = float("nan")
                return (planted,)

            handle = rdb1.register_forward_pre_hook(plant)
        else:
            with torch.no_grad():
                rdb1.conv3.weight[0, 0, 1, 1] = float("nan")  # bumps its version: the block repacks
        try:
            with debug_nans(model):
                model(frame)
            raised[case] = ""
        except FloatingPointError as e:
            raised[case] = str(e)
        finally:
            if handle is not None:
                handle.remove()
            with torch.no_grad():
                rdb1.conv3.weight.copy_(weight)
    print(f"--debug-nans on the card: {raised} after {rdb.launches} rdb call(s)", flush=True)
    check(raised["frame"].startswith("NaN in the output of BSRGAN.conv1 (Conv)"), f"frame: {raised['frame']!r}")
    for case in ("rdb_input", "rdb_weight"):
        check(raised[case].startswith("NaN in the output of BSRGAN.trunk.0.rdb1 (ResidualDenseBlock)"),
              f"{case}: {raised[case]!r}")
    check(rdb.launches == 2, f"{rdb.launches} rdb calls for the two RDB cases")

    launches = rdb.launches
    held = {}
    xs, ks, bs = rdb_inputs((1, 32, 32, CH), seed=300)
    k_nan = [k.clone() for k in ks]
    k_nan[2][1, 1, 0, 0] = float("nan")
    x_nan = _plant_device_nan(xs, (0, 5, 9, 3))
    img = torch.rand((2, 37, 53, 3), generator=torch.Generator().manual_seed(301)).cuda()
    fks = asymmetric_kernels(2, 7, seed=302)
    q, k, v = flash_inputs((2, 333, 4, 16), seed=303)
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for case, (xi, kk) in (("rdb_weight_conv3", (xs, k_nan)), ("rdb_x", (x_nan, ks))):
            args = (xi.to(dt), [w.to(dt) for w in kk], bs)
            held[f"{case}_{tag}"] = _keeps_nans(rdb.rdb_forward(*args), rdb.rdb_forward_ref(*args))
        for case, qkv in (("flash_q", (_plant_device_nan(q, (1, 100, 2, 5)), k, v)),
                          ("flash_k", (q, _plant_device_nan(k, (0, 50, 1, 3)), v))):
            args = [t.to(dt) for t in qkv]
            held[f"{case}_{tag}"] = _keeps_nans(attn.flash_attention(*args), attn.flash_attention_ref(*args))
    planted = _plant_device_nan(img, (1, 10, 20, 2))
    held["filter2d_f32"] = _keeps_nans(f2d.filter2d(planted, fks), f2d.filter2d_ref(planted, fks))
    print(f"NaNs of each kernel against its plain version (each of the plain version's kept, kernel count, "
          f"plain count): {held}", flush=True)
    for case, (kept, got_n, want_n) in held.items():
        check(kept, f"{case}: the kernel drops a NaN the plain version puts out ({got_n} against {want_n})")
    return {"raised": raised, "rdb_launches": launches, "nans_vs_plain": held}


def flash_backward_phase(attn) -> dict:
    """flash_attention's autograd.Function at q FLASH_SHAPE, f32 and bf16:
    its gradients (the kernel's forward, the f32 recompute by blocks of
    flash_block_q(ATTN_CHUNK)) against autograd through flash_attention_ref,
    and forward+backward timed beside scaled_dot_product_attention's and
    the bound. The backward is PyTorch, as the JAX one is XLA."""
    import torch.nn.functional as F

    block_q = attn.flash_block_q(ATTN_CHUNK)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dt) for t in flash_inputs(FLASH_SHAPE, seed=200))
        g = torch.randn(FLASH_SHAPE, generator=torch.Generator().manual_seed(201)).cuda().to(dt)
        ours = [t.clone().requires_grad_() for t in (q, k, v)]
        before = attn.launches
        attn.flash_attention(*ours, block_q=block_q).backward(g)
        check(attn.launches == before + 1, "the autograd.Function did not launch the kernel")
        ref = [t.clone().requires_grad_() for t in (q, k, v)]
        attn.flash_attention_ref(*ref, ATTN_CHUNK).backward(g)
        tag = "f32" if dt == torch.float32 else "bf16"
        errs[tag] = {}
        for name, a, b in zip("qkv", ours, ref):
            check(a.grad.dtype == dt, f"d{name} in {a.grad.dtype}")
            diff = (a.grad.float() - b.grad.float()).abs()
            scale = b.grad.float().abs().max().item()
            errs[tag][name] = diff.max().item() / scale
            if dt == torch.float32:
                # the same f32 math by other blocks: roundoff of sums over T
                check(errs[tag][name] <= 1e-5, f"f32 flash d{name}: {errs[tag][name]}")
            else:
                # both round one f32 gradient to bf16: one bf16 step apart
                check(bool((diff <= b.grad.float().abs() * 2**-7 + 1e-6 * scale).all()),
                      f"bf16 flash d{name}: {errs[tag][name]}")
        print(f"flash backward {tag} at q {FLASH_SHAPE}, block_q {block_q}: gradients vs autograd through the plain "
              f"version, max abs over max |grad|: {errs[tag]}", flush=True)

    times = {}
    n, t, h, d = FLASH_SHAPE
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v = (t_.to(dt).requires_grad_() for t_ in flash_inputs(FLASH_SHAPE, seed=202))
        g = torch.randn(FLASH_SHAPE, generator=torch.Generator().manual_seed(203)).cuda().to(dt)
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
        gt = g.transpose(1, 2)

        def ours():
            attn.flash_attention(q, k, v, block_q=block_q).backward(g)

        def library():
            F.scaled_dot_product_attention(qt, kt, vt).backward(gt)

        def plain():  # autograd through the plain version, what the gradients are held to
            attn.flash_attention_ref(q, k, v, ATTN_CHUNK).backward(g)

        times[tag] = {"flash_fwd_bwd_ms": cuda_ms(ours, iters=5, warmup=1),
                      "sdpa_fwd_bwd_ms": cuda_ms(library, iters=10, warmup=2),
                      "plain_fwd_bwd_ms": cuda_ms(plain, iters=2, warmup=1)}
    # fwd: QK^T and PV; bwd: S again, dV, dP, dQ and dK: 14 N H T^2 D; the
    # softmax's exponentials twice; q, k, v, o, dO read, o, dq, dk, dv written
    flops = 14 * n * h * t * t * d
    exps = 2 * n * h * t * t
    elems = 9 * n * t * h * d
    t_exp = exps / PEAK_EXP_PER_S * 1e3
    bound = max(flops / PEAK_BF16_FLOPS * 1e3, t_exp, 2 * elems / PEAK_HBM_BYTES * 1e3)
    bound_f32 = max(TF32_PRODUCTS * flops / PEAK_TF32_FLOPS * 1e3, t_exp, 4 * elems / PEAK_HBM_BYTES * 1e3)
    print(f"flash forward+backward at q {FLASH_SHAPE}: bf16 {times['bf16']['flash_fwd_bwd_ms']:.3f} ms "
          f"(scaled_dot_product_attention {times['bf16']['sdpa_fwd_bwd_ms']:.3f} ms, the plain version "
          f"{times['bf16']['plain_fwd_bwd_ms']:.3f} ms, bound {bound:.3f} ms), f32 "
          f"{times['f32']['flash_fwd_bwd_ms']:.3f} ms (scaled_dot_product_attention "
          f"{times['f32']['sdpa_fwd_bwd_ms']:.3f} ms, the plain version {times['f32']['plain_fwd_bwd_ms']:.3f} ms, "
          f"bound {bound_f32:.3f} ms as 3 TF32 products)", flush=True)
    return {"route": "pytorch (the JAX backward is XLA): exact attention recomputed in f32 by query blocks, "
                     "autograd per block; the forward is the cuda kernel",
            "source": "srganfd_tpu_torch/ops/cuda/attention.py",
            "replaces": "srganfd_tpu/ops/pallas/attention.py:164-187",
            "block_q": block_q, "grad_rel_err": errs, "times": times, "fwd_bwd_ms": times["bf16"]["flash_fwd_bwd_ms"],
            "library_fwd_bwd_ms": times["bf16"]["sdpa_fwd_bwd_ms"], "plain_fwd_bwd_ms": times["bf16"]["plain_fwd_bwd_ms"],
            "bound_fwd_bwd_ms": bound,
            "bound_fwd_bwd_f32_ms": bound_f32, "bound_by": "operations"}


def _hold_flash_call(attn, rec: dict, out: torch.Tensor, dq: torch.Tensor) -> dict:
    """One recorded flash call of a training step against the plain
    version on its q, k, v: the kernel's output (``out``) to
    flash_attention_ref's, and the dq the backward returned (``dq``; dk
    and dv as recorded) to autograd through flash_attention_ref with the
    recorded output gradient. bf16: each one bf16 step (2**-7 of the
    value) apart at most, as flash_kernel_phase holds the output and
    flash_backward_phase the gradients."""
    q, k, v = (rec[n].clone().requires_grad_() for n in "qkv")
    want = attn.flash_attention_ref(q, k, v, ATTN_CHUNK)
    want.backward(rec["g"])
    errs, ok = {}, True
    for name, got, ref in (("out", out, want.detach()), ("dq", dq, q.grad), ("dk", rec["dk"], k.grad),
                           ("dv", rec["dv"], v.grad)):
        diff, ref = (got.float() - ref.float()).abs(), ref.float()
        scale = ref.abs().max().item()
        floor = 1e-5 if name == "out" else 1e-6 * scale
        ok = ok and bool((diff <= ref.abs() * 2**-7 + floor).all())
        errs[name] = diff.max().item() / max(scale, 1e-30)
    return {"ok": ok, "rel_err": errs}


def flash_train_phase(work: str, rdb, attn, blocks) -> dict:
    """One aesrgan config (batch 8, GT 120, bf16, bsrgantrans_x2 64/32/23)
    with attn_chunk 1024 set through the config's g_kwargs: three steps on
    the flash backend, then the same three from the same init on the same
    batches on the chunked backend (blocks.chunked_attention, which is
    flash_attention_ref: the plain version). Each flash call of the path
    (2 a G forward, q (8, 900, 4, 16) bf16, under grad) is recorded and
    held to the plain version at this shape (_hold_flash_call); the check
    must refuse a planted fault, the batch rolled by one sample. Each
    step's losses and G after it against the chunked run's. Step times
    (StepTimer: after a device sync)."""
    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli import train as cli_train
    from srganfd_tpu_torch.cli.degrade_adapter import DegradationAdapter
    from srganfd_tpu_torch.data.datasets import BatchLoader
    from srganfd_tpu_torch.train.loop import Trainer
    from srganfd_tpu_torch.utils.profiling import StepTimer

    base = configs.get_config("aesrgan", train_gt_images_dir=os.path.join(work, "train_gt"),
                              valid_gt_images_dir=os.path.join(work, "valid_gt"))
    loader = BatchLoader(cli_train.build_datasets(base)[0], base.batch_size, seed=base.seed, num_workers=2)
    it = iter(loader)
    adapter = DegradationAdapter(base, seed=base.seed, train=True, device="cuda")
    batches = [adapter(next(it), i) for i in range(3)]
    it.close()

    records, real = [], blocks.flash_attention

    def recording(q, k, v, block_q=512):
        out = real(q, k, v, block_q)
        rec = {"q": q.detach().clone(), "k": k.detach().clone(), "v": v.detach().clone(),
               "out": out.detach().clone()}
        records.append(rec)
        if out.requires_grad:
            out.register_hook(lambda g: rec.__setitem__("g", g.detach().clone()))
            for name, t in (("dq", q), ("dk", k), ("dv", v)):
                t.register_hook(lambda g, name=name: rec.__setitem__(name, g.detach().clone()))
        return out

    out, g_after, init = {}, {}, {}
    for backend in ("flash", "chunked"):
        cfg = base.replace(g_kwargs={**base.g_kwargs, "attn_chunk": ATTN_CHUNK, "attn_backend": backend})
        trainer = Trainer(cfg, steps_per_epoch=100, device="cuda")
        state = trainer.init_state()
        init[backend] = {n: p.detach().clone() for n, p in state.g_model.named_parameters()}
        g_after[backend] = []
        attn.launches = rdb.launches = rdb.launches_bwd = 0
        ms, metrics = [], []
        blocks.flash_attention = recording
        try:
            timer = StepTimer("cuda")
            timer.lap()
            for b in batches:
                m = trainer.train_step(state, b["gt"], b["lr"])
                ms.append(timer.lap() * 1e3)
                metrics.append({k: v.item() for k, v in m.items()})
                g_after[backend].append({n: p.detach().clone() for n, p in state.g_model.named_parameters()})
                timer.lap()
        finally:
            blocks.flash_attention = real
        check(all(math.isfinite(v) for m in metrics for v in m.values()), f"aesrgan {backend} metrics {metrics}")
        check(rdb.launches_bwd == RDB_PER_FORWARD * len(batches), f"aesrgan {backend}: {rdb.launches_bwd} rdb backwards")
        out[backend] = {"step_ms": ms, "flash_launches": attn.launches, "rdb_launches": rdb.launches,
                        "g_loss": [m["g_loss"] for m in metrics], "d_loss": [m["d_loss"] for m in metrics]}
        del trainer, state
    check(out["flash"]["flash_launches"] == ATTN_PER_FORWARD * len(batches) == len(records)
          and out["chunked"]["flash_launches"] == 0,
          f"flash launches {out['flash']['flash_launches']} / {out['chunked']['flash_launches']}, "
          f"{len(records)} recorded")
    check(all(torch.equal(p, init["chunked"][n]) for n, p in init["flash"].items()),
          "the two backends' runs start from different G")

    # every flash call of the path against the plain version at its shape
    calls = []
    for rec in records:
        check(all(key in rec for key in ("g", "dq", "dk", "dv")), "a flash call of the step took no backward")
        calls.append(_hold_flash_call(attn, rec, rec["out"], rec["dq"]))
    fault_out = _hold_flash_call(attn, records[0], records[0]["out"].roll(1, 0), records[0]["dq"])
    fault_dq = _hold_flash_call(attn, records[0], records[0]["out"], records[0]["dq"].roll(1, 0))
    worst = {name: max(c["rel_err"][name] for c in calls) for name in ("out", "dq", "dk", "dv")}
    print(f"aesrgan flash calls ({len(calls)}, q {tuple(records[0]['q'].shape)} {records[0]['q'].dtype}) against "
          f"the plain version: worst max abs over max |ref| {worst}; planted faults (the batch rolled by one) "
          f"refused: output {not fault_out['ok']}, dq {not fault_dq['ok']}", flush=True)
    check(all(c["ok"] for c in calls), f"a flash call of the step disagrees with the plain version: {calls}")
    check(not fault_out["ok"] and not fault_dq["ok"], "the flash check passed a batch rolled by one sample")

    # the steps against the chunked (plain) run: attention's outputs one
    # bf16 step apart move the losses, means over the batch, far below
    # 1e-3; Adam moves a parameter by at most lr max(1, (1 - b1) /
    # sqrt(1 - b2)) a step whatever its gradient, so two runs are at most
    # twice that a step apart
    b1, b2 = base.model_betas
    per_step = base.model_lr * max(1.0, (1 - b1) / math.sqrt(1 - b2))
    loss_rel, g_abs = [], []
    for i in range(len(batches)):
        loss_rel.append(max(abs(out["flash"][key][i] - out["chunked"][key][i]) / abs(out["chunked"][key][i])
                            for key in ("g_loss", "d_loss")))
        g_abs.append(max((p - g_after["chunked"][i][n]).abs().max().item() for n, p in g_after["flash"][i].items()))
    print(f"aesrgan step through flash (bf16, batch 8, GT 120, attn_chunk {ATTN_CHUNK}): "
          f"{[round(v, 2) for v in out['flash']['step_ms']]} ms host clock after a sync (recording its calls), "
          f"{out['flash']['flash_launches']} flash calls; chunked backend "
          f"{[round(v, 2) for v in out['chunked']['step_ms']]} ms; g_loss flash {out['flash']['g_loss']}, chunked "
          f"{out['chunked']['g_loss']}; by step, losses apart (relative) {loss_rel}, G apart (largest |dG|) {g_abs} "
          f"against {[2 * (i + 1) * per_step for i in range(len(batches))]}", flush=True)
    for i in range(len(batches)):
        check(loss_rel[i] <= 1e-3, f"step {i}: flash and plain losses apart by {loss_rel[i]}")
        check(g_abs[i] <= 2 * (i + 1) * per_step, f"step {i}: G apart by {g_abs[i]} > {2 * (i + 1) * per_step}")
    out["calls_vs_plain"] = worst
    out["steps_vs_plain"] = {"loss_rel": loss_rel, "g_abs": g_abs}
    return out


def degradations_phase(work: str, f2d, filters) -> tuple[int, dict]:
    """python -m srganfd_tpu_torch.cli.test_degradations over DEG_FRAMES
    frames of DEG_SIZE px, --plus and --codec cv2, each run again with
    filter2d plain on the same seeds: the cv2 chain's LR to one 8-bit level
    (the JPEG round trip quantises, so a blur's roundoff can cross one
    level), the plus chain's within the DiffJPEG envelope (0.05). Frames/s
    of the kernel runs and their filter2d calls."""
    from srganfd_tpu_torch.cli import test_degradations

    gt_dir = os.path.join(work, "deg_gt")
    write_gt_frames(gt_dir, DEG_FRAMES, DEG_SIZE, seed=40)
    out, launches = {}, 0
    for mode, kw, limit in (("plus", {"plus": True}, 0.05), ("cv2", {"codec": "cv2"}, 1 / 255 + 1e-6)):
        runs = {}
        for route in ("kernel", "plain"):
            real = filters.filter2d
            if route == "plain":
                filters.filter2d = f2d.filter2d_ref
            f2d.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                frames = test_degradations.run("bsrgan", gt_dir, os.path.join(work, f"deg_{mode}_{route}"),
                                               max_images=DEG_FRAMES, device="cuda", **kw)
                torch.cuda.synchronize()
            finally:
                filters.filter2d = real
            runs[route] = (frames, time.perf_counter() - t0, f2d.launches)
        frames, seconds, calls = runs["kernel"]
        check(calls == 2 * DEG_FRAMES and runs["plain"][2] == 0, f"{mode}: {calls} / {runs['plain'][2]} filter2d calls")
        diffs = [float(np.abs(a - b).max()) for a, b in zip(frames, runs["plain"][0])]
        check(len(diffs) == DEG_FRAMES and all(np.isfinite(f).all() for f in frames), f"{mode}: frames")
        check(max(diffs) <= limit, f"{mode}: LR vs the plain filter2d run {diffs} > {limit}")
        launches += calls
        out[mode] = {"frames_per_s": DEG_FRAMES / seconds, "filter2d_launches": calls, "lr_vs_plain": diffs,
                     "lr_shape": list(frames[0].shape)}
        print(f"cli.test_degradations --{'plus' if mode == 'plus' else 'codec cv2'} ({DEG_FRAMES} frames of "
              f"{DEG_SIZE}x{DEG_SIZE}): {DEG_FRAMES / seconds:.2f} frames/s, {calls} filter2d calls, LR "
              f"{frames[0].shape}, vs plain filter2d {diffs}", flush=True)
    return launches, out


# -- the int8 serving path, paired training, export and the graft's sources --

PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core rate of one H100 SXM
# the five sources of a full-width RDB: x (64 channels) feeds all five convs'
# rows (4 * 32 + 64 outputs), out_1..out_4 (32 channels) the later ones
QCONV_SOURCES = [(CH, 4 * GC + CH), (GC, 3 * GC + CH), (GC, 2 * GC + CH), (GC, GC + CH), (GC, CH)]
QCONV_PER_FORWARD = 5 * RDB_PER_FORWARD
PAIRED_STEPS, PAIRED_GT = 3, 144


def qconv_bound_ms(n: int, h: int, w: int) -> tuple[float, float, str]:
    """The card's least time for the five convs of one quantized RDB on
    (n, h, w): int8 inputs and weights read once, f32 scales read once, f32
    outputs written once, against 2 * 9 * cin * cout operations a pixel at
    the dense int8 rate. Returns (bound ms, operations-only ms, bound_by)."""
    ops = sum(2 * 9 * cin * cout * n * h * w for cin, cout in QCONV_SOURCES)
    moved = sum(n * h * w * cin + 9 * cin * cout + 4 * cout + 4 * n * h * w * cout for cin, cout in QCONV_SOURCES)
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, moved / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops, "operations" if t_ops >= t_bytes else "bytes"


QCONV_LIBRARY = (("f32", torch.float32, False), ("tf32", torch.float32, True), ("bf16", torch.bfloat16, False))


def qconv_library(xq, kq, scale, want_i, want_f, timed: bool) -> dict:
    """The library's way to the s8 conv: one cuDNN ``F.conv2d`` on the int8
    values cast to a float type, times the scales. Every product (<= 127^2)
    and every partial sum (<= 127^2 * 9 * 64 < 2^24) is an integer that f32
    holds exactly, so a direct or implicit-GEMM algorithm with f32 sums
    gives the int32 sums in any order; a Winograd or FFT algorithm, or a
    bf16 output, rounds. Each variant (f32 with TF32 off, f32 with TF32 on,
    bf16 inputs and output) is held to the int32 sums and to the kernel's
    plain f32 output, and timed where ``timed`` (20 calls after 3, the
    casts made before the timing: the library's best case)."""
    import torch.nn.functional as F

    out = {}
    saved = torch.backends.cudnn.allow_tf32
    try:
        for name, dt, tf32 in QCONV_LIBRARY:
            torch.backends.cudnn.allow_tf32 = tf32
            x = xq.permute(0, 3, 1, 2).to(dt)  # channels_last, as xq is NHWC
            w = kq.permute(3, 2, 0, 1).to(dt).contiguous(memory_format=torch.channels_last)
            s = scale.view(1, -1, 1, 1)
            with torch.inference_mode():
                sums = F.conv2d(x, w, padding=1)
                y = (sums * s).permute(0, 2, 3, 1)
            row = {"int32_max_diff": (sums.double().permute(0, 2, 3, 1) - want_i.double()).abs().max().item(),
                   "f32_max_diff": (y - want_f).abs().max().item()}
            row["exact"] = row["int32_max_diff"] == 0 and torch.equal(y, want_f)
            if timed:
                with torch.inference_mode():
                    row["ms"] = cuda_ms(lambda: F.conv2d(x, w, padding=1) * s)
            out[name] = row
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return out


def qconv_kernel_phase(qc, rdb) -> dict:
    """The s8 conv kernel against its plain version (an exact float64 conv
    on the card) on the five sources of a full-width RDB at (1, 256, 256)
    and (16, 72, 72): the int32 sums and the f32 output bit for bit. Times
    (CUDA events, 20 calls after 3 warm-up ones) of each source's conv, of
    the plain version, of the library's float convs (:func:`qconv_library`;
    ``library_ms`` is the fastest bit-exact one) and of the bf16 RDB kernel
    on the same (1, 256, 256, 64) input, beside the bound."""
    g = torch.Generator().manual_seed(51)
    worst = 0
    per_source, plain_ms_total, ms_total = [], 0.0, 0.0
    for shape in ((1, 256, 256), (16, 72, 72)):
        for cin, cout in QCONV_SOURCES:
            xq = torch.randint(-127, 128, (*shape, cin), generator=g, dtype=torch.int8).cuda()
            kq = torch.randint(-127, 128, (3, 3, cin, cout), generator=g, dtype=torch.int8).cuda()
            scale = (torch.rand(cout, generator=g) * 1e-4 + 1e-6).cuda()
            packed = qc.pack_qconv_weights(kq)
            got_i, got_f = qc.qconv3x3(xq, kq, None, packed), qc.qconv3x3(xq, kq, scale, packed)
            torch.cuda.synchronize()
            want_i, want_f = qc.qconv3x3_ref(xq, kq), qc.qconv3x3_ref(xq, kq, scale)
            diff_i = (got_i.long() - want_i.long()).abs().max().item()
            diff_f = (got_f - want_f).abs().max().item()
            worst = max(worst, diff_i, diff_f)
            check(torch.equal(got_i, want_i) and torch.equal(got_f, want_f),
                  f"qconv {shape} cin {cin} cout {cout}: int32 max diff {diff_i}, f32 max diff {diff_f}")
            row = {"shape": [*shape, cin], "cout": cout, "int32_max_diff": diff_i, "f32_max_diff": diff_f,
                   "library": qconv_library(xq, kq, scale, want_i, want_f, timed=shape == (1, 256, 256))}
            if shape == (1, 256, 256):
                with torch.inference_mode():
                    row["ms"] = cuda_ms(lambda: qc.qconv3x3(xq, kq, scale, packed))
                    row["plain_ms"] = cuda_ms(lambda: qc.qconv3x3_ref(xq, kq, scale), iters=3, warmup=1)
                row["bound_ms"] = max(2 * 9 * cin * cout * 65536 / PEAK_INT8_OPS,
                                      (65536 * (cin + 4 * cout) + 9 * cin * cout + 4 * cout) / PEAK_HBM_BYTES) * 1e3
                ms_total += row["ms"]
                plain_ms_total += row["plain_ms"]
            per_source.append(row)
            lib = "; ".join(f"cuDNN {k}: int32 max diff {v['int32_max_diff']:g}, f32 max diff {v['f32_max_diff']:g}"
                            + (f", {v['ms']:.4f} ms" if "ms" in v else "") for k, v in row["library"].items())
            print(f"qconv {shape} cin {cin} -> cout {cout}: int32 and f32 equal to the plain version "
                  f"(max diffs {diff_i}, {diff_f})" + (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
                                                        f"ms, bound {row['bound_ms']:.4f} ms" if "ms" in row else "")
                  + f"; {lib}", flush=True)
    bound, ops_bound, bound_by = qconv_bound_ms(1, 256, 256)
    x, ks, bs = rdb_inputs(SERVE_SHAPE, seed=52)
    xb = x.to(torch.bfloat16)
    packed_b = rdb.pack_rdb_weights(ks, bs, torch.bfloat16)
    with torch.inference_mode():
        bf16_rdb_ms = cuda_ms(lambda: rdb.rdb_forward(xb, ks, bs, packed_b))
    ops = sum(2 * 9 * cin * cout * 65536 for cin, cout in QCONV_SOURCES)
    variants = {}
    for name, _, _ in QCONV_LIBRARY:
        rows = [r["library"][name] for r in per_source]
        variants[name] = {"ms": sum(r["ms"] for r in rows if "ms" in r), "exact": all(r["exact"] for r in rows),
                          "f32_max_diff": max(r["f32_max_diff"] for r in rows)}
    exact = {k: v for k, v in variants.items() if v["exact"]}
    library = min(exact or variants, key=lambda k: variants[k]["ms"])
    library_ms = variants[library]["ms"]
    print(f"qconv timing, the five convs of one quantized RDB at x {SERVE_SHAPE}: kernel {ms_total:.4f} ms "
          f"({ops / ms_total / 1e9:.1f} TOP/s), plain {plain_ms_total:.4f} ms, library {library_ms:.4f} ms "
          f"(cuDNN F.conv2d {library}, {'exact' if library in exact else 'NOT exact'}; "
          + ", ".join(f"{k} {v['ms']:.4f} ms {'exact' if v['exact'] else 'max diff ' + format(v['f32_max_diff'], 'g')}"
                      for k, v in variants.items())
          + f"); bound {bound:.4f} ms by {bound_by} (operations alone {ops_bound:.4f} ms, "
          f"{ops:.3e} ops at {PEAK_INT8_OPS / 1e12:.0f} TOP/s), {100 * bound / ms_total:.1f}% of it; the bf16 RDB "
          f"kernel on the same input {bf16_rdb_ms:.4f} ms", flush=True)
    return {
        "name": "qconv3x3 (qconv2d's s8 conv)",
        "route": "cuda",
        "design": "mma.sync.m16n8k32 s8 x s8 -> s32 on the bf16 RDB kernel's staging (18x10 halo tile and "
                  "32-channel weight steps by cp.async into swizzled shared memory, ldmatrix), epilogue "
                  "(float)acc * scale in f32",
        "source": "srganfd_tpu_torch/csrc/qconv.cu",
        "replaces": "srganfd_tpu/ops/quant.py:64",
        "replaces_note": "an XLA s8 convolution in the JAX package (no Pallas kernel): the int8 serving path",
        "max_abs_err": worst,
        "ms": ms_total,
        "plain_ms": plain_ms_total,
        "bound_ms": bound,
        "bound_by": bound_by,
        "bound_ops_ms": ops_bound,
        "library_ms": library_ms,
        "library": f"cuDNN F.conv2d on the int8 values as {library} times the scales "
                   f"({'bit-equal' if library in exact else 'not bit-equal'} to the kernel); casts untimed",
        "library_variants": variants,
        "bf16_rdb_kernel_ms": bf16_rdb_ms,
        "tops": ops / ms_total / 1e9,
        "share_of_bound": bound / ms_total,
        "shape": [*SERVE_SHAPE[:3], "five sources of one RDB"],
        "sources": per_source,
    }


def quant_serve_phase(work: str, qc, rdb, blocks) -> tuple[int, dict]:
    """``cli.serve --stdio --quant-int8``: full-width ``bsrgan_x2`` (4
    requests of 256x256) and ``realesrgan_x4`` (4 of 128x128) on spread
    weights, f32 then bf16. Every forward makes 345 qconv kernel calls (5 an
    RDB) and no RDB-kernel call; one frame is held to the same quantized
    model with the plain qconv (the serving limits), and its PSNR against
    the unquantized f32 SR is printed, not held. Returns the qconv calls of
    the stdio runs and the numbers."""
    from srganfd_tpu_torch.cli.serve import ServingEngine, serve_stdio
    from srganfd_tpu_torch.data.datasets import load_image_rgb
    from srganfd_tpu_torch.ops import quant

    out, launches = {}, 0
    for arch, size, gain in (("bsrgan_x2", 256, 3.0), ("realesrgan_x4", RE_SERVE, 4.0)):
        weights = spread_weights(work, arch, gain=gain)
        frames = write_frames(os.path.join(work, f"q_lr_{arch}"), 4, size, size, seed=53)
        x = torch.from_numpy(load_image_rgb(frames[0])[None]).cuda()
        y_ref = None  # the unquantized f32 SR: the f32 engine's model with its RDBs' quant off
        for half in (False, True):
            tag = "bf16" if half else "f32"
            engine = ServingEngine(arch, weights=weights, half=half, quant_int8=True, device="cuda")
            reqs = [{"id": i, "input": p, "output": os.path.join(work, f"q_sr_{arch}_{tag}", f"{i}.png")}
                    for i, p in enumerate(frames)]
            lines = [json.dumps(r) for r in reqs] + ['{"cmd": "shutdown"}']
            buf = io.StringIO()
            qc.launches = rdb.launches = rdb.launches_bwd = 0
            t0 = time.perf_counter()
            serve_stdio(engine, inp=io.StringIO("\n".join(lines)), out=buf)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            calls, rdb_calls = qc.launches, rdb.launches
            launches += calls
            replies = [json.loads(line) for line in buf.getvalue().splitlines()]
            scale = engine.upscale
            check(len(replies) == 4 and all(r.get("ok") and r["out_hw"] == [scale * size] * 2 for r in replies),
                  f"{arch} --quant-int8 {tag}: replies {replies}")
            check(calls == 4 * QCONV_PER_FORWARD and rdb_calls == 0,
                  f"{arch} --quant-int8 {tag}: {calls} qconv and {rdb_calls} rdb_forward calls for 4 forwards")
            with torch.inference_mode():
                y = engine.model(x)
                if y_ref is None:
                    rdbs = [m for m in engine.model.modules() if isinstance(m, blocks.ResidualDenseBlock)]
                    for m in rdbs:
                        m.quant = False
                    y_ref = engine.model(x)
                    for m in rdbs:
                        m.quant = True
                real = quant.qconv3x3
                quant.qconv3x3 = lambda xq, kq, s=None, packed=None: qc.qconv3x3_ref(xq, kq, s)
                try:
                    qc.launches = 0
                    y_plain = engine.model(x)
                    plain_calls = qc.launches
                finally:
                    quant.qconv3x3 = real
                forward_ms = cuda_ms(lambda: engine.model(x), iters=5, warmup=1)
            check(plain_calls == 0, f"{arch} {tag}: the plain twin launched {plain_calls} qconv kernels")
            err = (y - y_plain).abs().max().item()
            mse = ((y - y_plain) ** 2).mean().item()
            psnr_plain = 10 * math.log10(1.0 / mse) if mse > 0 else float("inf")
            mse_ref = ((y - y_ref) ** 2).mean().item()
            psnr_ref = 10 * math.log10(1.0 / mse_ref) if mse_ref > 0 else float("inf")
            check(torch.isfinite(y).all().item() and y.std().item() > 0.05, f"{arch} {tag}: output {y.std().item()}")
            if half:
                check(err <= 8 / 255 and psnr_plain >= 45,
                      f"{arch} --quant-int8 bf16 vs plain qconv: {err}, {psnr_plain}")
            else:
                check(err <= 1e-3, f"{arch} --quant-int8 f32 vs plain qconv: {err}")
            out[f"{arch} {tag}"] = {"wall_s": wall, "per_frame_ms": [r["ms"] for r in replies],
                                    "qconv_per_forward": calls // 4, "vs_plain_qconv_max_abs": err,
                                    "psnr_vs_unquantized_f32_db": psnr_ref, "forward_ms": forward_ms}
            print(f"serve stdio --quant-int8 {arch} {tag}: 4 x {size}x{size} in {wall:.2f} s, per-frame ms "
                  f"{[r['ms'] for r in replies]}, {calls // 4} qconv calls a forward, 0 rdb_forward; vs the plain "
                  f"qconv max abs {err:.3g}; PSNR against the unquantized f32 SR {psnr_ref:.2f} dB (printed, not "
                  f"held); one forward on the card {forward_ms:.2f} ms", flush=True)
            del engine
    return launches, out


def write_pairs(root: str, n: int, size: int, seed: int) -> tuple[str, str]:
    """``n`` registered pairs: GT frames of ``size`` and their 2x area
    downscales as LR, under ``root/gt`` and ``root/lr``."""
    import cv2

    gt_dir, lr_dir = os.path.join(root, "gt"), os.path.join(root, "lr")
    write_gt_frames(gt_dir, n, size, seed)
    os.makedirs(lr_dir, exist_ok=True)
    for name in sorted(os.listdir(gt_dir)):
        img = cv2.imread(os.path.join(gt_dir, name))
        cv2.imwrite(os.path.join(lr_dir, name), cv2.resize(img, (size // 2, size // 2), interpolation=cv2.INTER_AREA))
    return gt_dir, lr_dir


def paired_train_phase(work: str, rdb) -> tuple[int, dict, str]:
    """``bsrnet`` unchanged but ``degradation="paired"`` (full-width
    ``bsrgan_x2``, batch 16, bf16) on 16 synthetic registered pairs (GT
    144, LR 72), one epoch of 3 steps through ``run_train``: the first
    step's LR equals the loader's batch read from disk (max abs 0), 69 RDB
    kernel calls a forward. Returns the RDB calls, the numbers and the
    path of ``ckpt_last.pth``."""
    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli import train as cli_train
    from srganfd_tpu_torch.data.datasets import BatchLoader
    from srganfd_tpu_torch.train.loop import Trainer

    train_gt, train_lr = write_pairs(os.path.join(work, "paired_train"), 16, PAIRED_GT, seed=54)
    valid_gt, valid_lr = write_pairs(os.path.join(work, "paired_valid"), 4, PAIRED_GT, seed=55)
    cfg = configs.get_config("bsrnet").replace(
        degradation="paired", train_gt_images_dir=train_gt, train_lr_images_dir=train_lr,
        valid_gt_images_dir=valid_gt, valid_lr_images_dir=valid_lr, epochs=1,
        results_dir=os.path.join(work, "paired_results"))
    first_lr, steps = [], []
    real_step = Trainer.train_step

    def recorded(self, state, gt, lr_img, gt_pixel=None):
        if not first_lr:
            first_lr.append(lr_img.float().cpu())
        entry = time.perf_counter()
        metrics = real_step(self, state, gt, lr_img, gt_pixel)
        metrics["g_loss"].item()
        steps.append((entry, time.perf_counter()))
        return metrics

    Trainer.train_step = recorded
    torch.cuda.reset_peak_memory_stats()
    rdb.launches = rdb.launches_bwd = 0
    try:
        t0 = time.perf_counter()
        result = cli_train.run_train(cfg, PAIRED_STEPS, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        Trainer.train_step = real_step
    calls, bwd_calls = rdb.launches, rdb.launches_bwd
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    host = next(iter(BatchLoader(cli_train.build_datasets(cfg)[0], cfg.batch_size, seed=cfg.seed, num_workers=1,
                                 loop=False)))
    lr_diff = (first_lr[0] - torch.from_numpy(host["lr"])).abs().max().item()
    check(first_lr[0].shape == (16, PAIRED_GT // 2, PAIRED_GT // 2, 3) and lr_diff == 0,
          f"paired: the first step's LR {tuple(first_lr[0].shape)} differs from the files by {lr_diff}")
    check(len(steps) == PAIRED_STEPS and result["state"].step == PAIRED_STEPS, f"paired: {len(steps)} steps")
    check((calls, bwd_calls) == (RDB_PER_FORWARD * (PAIRED_STEPS + 1), RDB_PER_FORWARD * PAIRED_STEPS),
          f"paired: {calls} rdb_forward and {bwd_calls} backward calls for {PAIRED_STEPS} steps and 1 validation batch")
    check(math.isfinite(result["best_psnr"]) and result["best_psnr"] > 0, f"paired: PSNR {result['best_psnr']}")
    intervals = [(b[1] - a[1]) * 1e3 for a, b in zip(steps, steps[1:])]
    numbers = {"steps": PAIRED_STEPS, "step_ms_p50": float(np.median(intervals)), "peak_memory_gb": peak_gb,
               "run_s": wall, "lr_vs_files_max_abs": lr_diff, "rdb_per_forward": calls // (PAIRED_STEPS + 1),
               "valid_psnr": result["best_psnr"]}
    print(f"paired bsrnet (bf16, batch 16, GT {PAIRED_GT}, LR {PAIRED_GT // 2} from disk): {PAIRED_STEPS} steps + 1 "
          f"validation batch in {wall:.2f} s, step p50 {numbers['step_ms_p50']:.2f} ms host clock, peak memory "
          f"{peak_gb:.2f} GB, {calls} rdb_forward calls ({calls // (PAIRED_STEPS + 1)} a forward), LR vs files "
          f"max abs {lr_diff}, valid PSNR {result['best_psnr']:.3f} dB", flush=True)
    ckpt_path = os.path.join(cfg.results_dir, cfg.exp_name, "ckpt_last.pth")
    del result
    return calls, numbers, ckpt_path


def export_phase(work: str, rdb) -> tuple[int, dict]:
    """``cli.export`` of full-width ``bsrgan_x2`` at 128x128 on the card
    (spread weights as G and EMA-G), the ``.pt2`` reloaded and run: its
    output held to the module's (f32 limit 1e-3), 69 RDB kernel calls
    through the custom op ``srganfd::rdb_forward``, no RDB weight in the
    program's state dict (they travel packed, as its constants)."""
    from srganfd_tpu_torch.cli import export
    from srganfd_tpu_torch.convert import load_generator_weights
    from srganfd_tpu_torch.models import create_model

    sd = torch.load(spread_weights(work, "bsrgan_x2", gain=3.0), weights_only=True)["state_dict"]
    weights = os.path.join(work, "export_weights.pth")
    torch.save({"state_dict": sd, "ema_state_dict": sd}, weights)
    t0 = time.perf_counter()
    res = export.export_generator("bsrgan_x2", os.path.join(work, "export", "bsrgan_x2"), weights, 128, 1, "cuda")
    export_s = time.perf_counter() - t0
    exported = torch.export.load(res["program"])
    raw = [k for k in exported.state_dict if ".rdb" in k]
    check(not raw, f"the exported program holds the RDBs' raw weights too: {raw[:3]}")
    program = exported.module()
    n_ops = sum(1 for n in program.graph.nodes if "srganfd.rdb_forward" in str(n.target))
    check(n_ops == RDB_PER_FORWARD, f"exported program holds {n_ops} srganfd::rdb_forward nodes")
    model = create_model("bsrgan_x2")
    model.load_state_dict(load_generator_weights(weights, use_ema=True))
    model = model.cuda().eval().requires_grad_(False)
    x = torch.from_numpy(np.random.default_rng(56).uniform(size=(1, 128, 128, 3)).astype(np.float32)).cuda()
    with torch.no_grad():
        rdb.launches = rdb.launches_bwd = 0
        y = program(x)
        torch.cuda.synchronize()
        calls = rdb.launches
        want = model(x)
        ms = cuda_ms(lambda: program(x), iters=5, warmup=1)
        module_ms = cuda_ms(lambda: model(x), iters=5, warmup=1)
    err = (y - want).abs().max().item()
    check(calls == RDB_PER_FORWARD, f"the exported program made {calls} rdb_forward calls")
    check(y.shape == (1, 256, 256, 3) and torch.isfinite(y).all().item() and err <= 1e-3,
          f"exported program vs module: shape {tuple(y.shape)}, max abs {err}")
    print(f"cli.export bsrgan_x2 128x128 on the card: traced and saved in {export_s:.2f} s "
          f"({os.path.getsize(res['program'])} B .pt2, {res['arrays']} arrays in .params.npz); reloaded: "
          f"{calls} rdb_forward calls through srganfd::rdb_forward, vs the module max abs {err:.3g}; forward "
          f"{ms:.2f} ms (module {module_ms:.2f} ms)", flush=True)
    return calls, {"export_s": export_s, "vs_module_max_abs": err, "forward_ms": ms, "module_forward_ms": module_ms,
                   "rdb_launches": calls, "pt2_bytes": os.path.getsize(res["program"])}


def graft_sources_phase(work: str, ckpt_path: str, rdb) -> tuple[int, dict]:
    """``--pretrained-g`` from the paired run's ``ckpt_last.pth``, from a
    ``.npz`` of it (Flax paths, ``tools/port_torch_weights.py``'s layout)
    and from a ``runs:/`` URI of it in a ``file:`` MLflow store: the same
    ``n_ok/n_all``, and G's forward on one LR batch bit for bit equal."""
    import contextlib

    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli.train import graft_pretrained
    from srganfd_tpu_torch.convert import flatten_flax, state_dict_to_flax
    from srganfd_tpu_torch.train.loop import Trainer

    sd = torch.load(ckpt_path, weights_only=True)["state_dict"]
    npz = os.path.join(work, "paired_g.npz")
    np.savez(npz, **flatten_flax(state_dict_to_flax(sd, NUM_RRDB)))
    store = os.path.join(work, "mlstore")
    os.makedirs(os.path.join(store, "5", "run0", "artifacts"))
    os.link(ckpt_path, os.path.join(store, "5", "run0", "artifacts", "ckpt_last.pth"))
    prev = os.environ.get("MLFLOW_TRACKING_URI")
    os.environ["MLFLOW_TRACKING_URI"] = f"file:{store}"
    x = torch.from_numpy(np.random.default_rng(57).uniform(size=(2, 72, 72, 3)).astype(np.float32)).cuda()
    out, ys = {}, {}
    rdb.launches = rdb.launches_bwd = 0
    try:
        for source in (ckpt_path, npz, "runs:/run0/ckpt_last.pth"):
            cfg = configs.get_config("bsrnet", pretrained_g_model_weights_path=source)
            state = Trainer(cfg, 1, device="cuda").init_state()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                graft_pretrained(cfg, state)
            line = buf.getvalue().strip()
            with torch.no_grad():
                ys[source] = state.g_model.eval()(x)
            kind = "pth" if source == ckpt_path else "npz" if source == npz else "runs"
            out[kind] = line.split("(")[1].split(" ")[0]
            print(f"graft from {kind}: {line}", flush=True)
            del state
    finally:
        if prev is None:
            os.environ.pop("MLFLOW_TRACKING_URI", None)
        else:
            os.environ["MLFLOW_TRACKING_URI"] = prev
    calls = rdb.launches
    n_all = len(sd)
    check(set(out.values()) == {f"{n_all}/{n_all}"}, f"graft counts {out}")
    y0 = ys[ckpt_path]
    same = {k: torch.equal(y0, y) for k, y in ys.items()}
    check(all(same.values()) and torch.isfinite(y0).all().item(), f"grafted G forwards differ: {same}")
    check(calls == 3 * RDB_PER_FORWARD, f"graft forwards: {calls} rdb_forward calls")
    print(f"graft sources: .pth, .npz and runs:/ each {n_all}/{n_all} tensors, G forwards bit for bit equal, "
          f"{calls} rdb_forward calls", flush=True)
    return calls, {"counts": out, "forwards_equal": all(same.values())}


# -- the parallel modes (torch.distributed), one process per rank ----------------------

# every rank of the parallel phases is a subprocess of this launcher: it
# joins a gloo group itself when asked (two ranks share cuda:0, where NCCL
# refuses two ranks of one communicator), installs the phase's own hooks,
# sets the kernels' counts to 0, calls the CLI's main(argv) and prints its
# counts and readings on a line of its own
RANK_LAUNCHER = r'''
import datetime, json, os, sys, time
T_START = time.perf_counter()
import torch
torch.set_num_threads(1)  # a wave runs up to 12 ranks on the host's cores
import torch
import torch.distributed as dist
spec = json.loads(sys.argv[1])
if spec.get("deterministic"):
    torch.use_deterministic_algorithms(True, warn_only=True)
if spec.get("gloo"):
    dist.init_process_group("gloo", init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(seconds=spec["timeout"]))
from srganfd_tpu_torch.models import blocks
from srganfd_tpu_torch.ops.cuda import attention, filter2d, rdb
from srganfd_tpu_torch.parallel import comm, spatial
from srganfd_tpu_torch.train import loop
rank = int(os.environ.get("RANK", "0"))
record = {"step_ms": []}
def bn64(moments):
    return lambda xs: tuple(m.to(xs.dtype) for m in moments(xs.double()))
sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
if spec.get("probe"):  # each collective of a CUDA tensor under gloo, its values checked
    def gathered(t):
        parts = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(parts, t)
        return torch.cat(parts)
    def exchanged(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        return out
    def reduced(t):
        dist.all_reduce(t)
        return t
    def broadcast(t):
        dist.broadcast(t, 0)
        return t
    record["probe"] = {}
    for name, fn, want in (("all_reduce", reduced, [3.0] * 4), ("broadcast", broadcast, [1.0] * 4),
                           ("all_gather", gathered, [1.0] * 4 + [2.0] * 4),
                           ("all_to_all", exchanged, [1.0, 1.0, 2.0, 2.0])):
        try:
            got = fn(torch.full((4,), float(rank + 1), device="cuda")).cpu().tolist()
            record["probe"][name] = "ok" if got == want else f"wrong: {got}"
        except Exception as e:
            record["probe"][name] = type(e).__name__ + ": " + str(e)[:120]
if spec.get("bn64"):  # BatchNorm's moments summed in f64: the step's own code on an f64 copy of its input
    blocks.BatchNorm._batch_moments = staticmethod(bn64(blocks.BatchNorm._batch_moments))
if spec.get("plant_bn"):  # a planted fault: the moments per rank (in f64 as well)
    blocks.BatchNorm._batch_moments = staticmethod(
        lambda xs: tuple(m.to(xs.dtype) for m in (xs.double().mean((0, 2, 3)), xs.double().square().mean((0, 2, 3)))))
if spec.get("plant_rel"):  # a planted fault: the relativistic losses' means per rank
    from srganfd_tpu_torch.losses import gan
    gan.batch_mean = torch.mean
if spec.get("cfg"):  # config fields that no flag sets (the mesh), merged into cli.train's config
    from srganfd_tpu_torch import configs
    real_get = configs.get_config
    def get_config(name, **kw):
        over = dict(spec["cfg"])
        if "g_kwargs" in over:
            over["g_kwargs"] = {**real_get(name).g_kwargs, **over["g_kwargs"]}
        return real_get(name, **{**kw, **over})
    configs.get_config = get_config
if spec.get("plant_pp"):  # a planted fault: the pipelined trunk's output cotangent not split over its stages
    from srganfd_tpu_torch.parallel import pipeline
    pipeline._SplitCotangent = type("Unsplit", (), {"apply": staticmethod(lambda t, n: t)})
real_step, real_update = loop.Trainer.train_step, loop.Trainer._apply_update
grads = []
def train_step(self, state, gt, lr_img, gt_pixel=None):
    if spec.get("capture") and state.step == 0:
        torch.save({"gt": gt.cpu(), "lr": lr_img.cpu()}, spec["capture"] + f"_inputs{rank}.pt")
    sync()
    t0 = time.perf_counter()
    record.setdefault("first_step_at", t0 - T_MAIN)
    m = real_step(self, state, gt, lr_img, gt_pixel)
    sync()
    record["step_ms"].append((time.perf_counter() - t0) * 1e3)
    record["last_step_end_at"] = time.perf_counter() - T_MAIN
    return m
def apply_update(self, opt, params):
    out = real_update(self, opt, params)
    if spec.get("capture") and len(record["step_ms"]) == 0:
        grads.append([p.grad.detach().cpu() for p in params if p.grad is not None])
    return out
loop.Trainer.train_step, loop.Trainer._apply_update = train_step, apply_update
real_sr = spatial.spatial_sharded_sr
outs = []
def spatial_sr(*a, **k):
    out = real_sr(*a, **k)
    outs.append(out)
    return out
spatial.spatial_sharded_sr = spatial_sr
if spec.get("stdin") and rank == 0:
    sys.stdin = open(spec["stdin"])
import importlib
# a job runs a CLI's main(argv), or one of chip_smoke's rank functions (spec["call"])
mod = importlib.import_module("chip_smoke" if spec.get("call") else "srganfd_tpu_torch.cli." + spec["cli"])
rdb.launches = rdb.launches_bwd = filter2d.launches = attention.launches = comm.staged = 0
t0 = T_MAIN = time.perf_counter()
record["imports_s"] = t0 - T_START
try:
    if spec.get("call"):
        record["call"] = getattr(mod, spec["call"])(spec)
    else:
        mod.main(spec["argv"])
    rc = 0
except SystemExit as e:
    rc = e.code if isinstance(e.code, int) else 1
sync()
record.update(rdb=rdb.launches, rdb_bwd=rdb.launches_bwd, filter2d=filter2d.launches, flash=attention.launches,
              staged=comm.staged,
              seconds=time.perf_counter() - t0, rc=rc, world=comm.world(), backend=comm.backend())
if spec.get("capture"):
    torch.save(grads, spec["capture"] + f"_grads{rank}.pt")
if spec.get("save_sr"):
    import numpy as np
    np.save(spec["save_sr"] + f"_rank{rank}.npy", np.stack(outs))
if dist.is_initialized():
    dist.barrier()
    dist.destroy_process_group()
print("RANK_RESULT " + json.dumps(record), flush=True)
'''
PAR_TIMEOUT = 240  # every rank process and every group initialisation has one
DP_BATCH = 2  # frames a rank
DP1_STEPS = 3
DP_CONFIGS = ("bsrgan", "esrgan")
# dp2's runs: tag -> the launcher's switches (``bn64``: BatchNorm's moments in
# f64; ``plant_bn`` / ``plant_rel``: a global reduction taken per rank)
DP2_RUNS = {"bsrgan": {}, "esrgan": {"bn64": True}, "esrgan_planted_bn": {"bn64": True, "plant_bn": True},
            "esrgan_planted_rel": {"bn64": True, "plant_rel": True}}
SP_FRAME = 512  # the spatial phase's frame edge, bsrgan_x2
CP_FRAME = 128  # the context-parallel frame: 4096 tokens, 2048 a rank (3072 with the halo rows)
# cp_phase's gradients: q, k, v of that frame's attention (4 heads of 16), 2048 tokens a rank,
# each rank's first and last 128 keys masked out as halo rows are
CP_GRAD_SHAPE, CP_GRAD_HALO = (1, 4096, 4, 16), 128
SERVE_SHAPES = ((256, 256), (320, 192), (250, 190))  # the served frames after the spatial phase's
PP_STEPS = 2  # pp_phase: one epoch of two bsrnet steps
# the config fields pp_phase's cli.train runs take: the scanned trunk on a (data, pipe) mesh of every rank
PP_CFG = {"g_kwargs": {"scan_blocks": True}, "mesh_shape": [1, -1], "mesh_axes": ["data", "pipe"]}
# pp_phase's runs: tag -> (ranks, the launcher's switches; ``plant_pp``: the output cotangent not split)
PP_RUNS = {"pp1": (1, {}), "pp2": (2, {}), "pp2_planted": (2, {"plant_pp": True})}
TP_FRAME = 256  # tp_phase's frame edge, bsrgan_x2


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _group_env(rank: int, world: int, port: int) -> dict:
    """torchrun's variables for ``rank``; every rank on cuda:0 (one card)."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def _launch(jobs: list[tuple[dict, dict, str]], label: str) -> list[dict]:
    """Run every (spec, env, cwd) job of RANK_LAUNCHER at once; each must
    exit 0 within PAR_TIMEOUT and print its RANK_RESULT line. Returns the
    records (with the job's stdout under "stdout"). A job past its time
    fails the phase, and every job is ended before this returns."""
    procs = []
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    for spec, env, cwd in jobs:
        os.makedirs(cwd, exist_ok=True)
        spec = {"timeout": PAR_TIMEOUT, **spec}
        err = open(os.path.join(cwd, f"stderr_{len(procs)}.txt"), "w")
        out = open(os.path.join(cwd, f"stdout_{len(procs)}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-u", "-c", RANK_LAUNCHER, json.dumps(spec)], cwd=cwd,
            env={**base, **env, "PYTHONPATH": ROOT, "CUBLAS_WORKSPACE_CONFIG": ":4096:8", "OMP_NUM_THREADS": "1"},
            stdout=out, stderr=err), out, err))
    deadline = time.monotonic() + PAR_TIMEOUT
    try:
        while any(p.poll() is None for p, _, _ in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p, _, _ in procs):
                break  # a failed rank: its peers would wait for it until their timeout
            time.sleep(0.1)
    finally:
        for p, out, err in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            out.close()
            err.close()
    records = []
    for i, ((p, out, err), (_, _, cwd)) in enumerate(zip(procs, jobs)):
        text = open(out.name).read()
        lines = [ln for ln in text.splitlines() if ln.startswith("RANK_RESULT ")]
        check(p.returncode == 0 and len(lines) == 1,
              f"{label}: job {i} exited {p.returncode}: {text[-1500:]} {open(err.name).read()[-3000:]}")
        rec = json.loads(lines[0][len("RANK_RESULT "):])
        rec["stdout"] = text
        records.append(rec)
    return records


def _train_argv(name: str, train_dir: str, valid_dir: str, steps: int, extra=()) -> list[str]:
    return ["--config", name, "--train-dir", train_dir, "--valid-dir", valid_dir, "--batch-size", str(DP_BATCH),
            "--steps-per-epoch", str(steps), "--epochs", "1", *extra]


def _ckpt(cwd: str) -> dict:
    from srganfd_tpu_torch.train import checkpoint as ckpt

    found = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(cwd, "results")) for f in fs
             if f == "ckpt_last.pth"]
    check(len(found) == 1, f"{cwd}: ckpt_last.pth {found}")
    return ckpt.load_checkpoint(found[0])


def _dp_dirs(work: str) -> tuple[str, str]:
    """8 training frames and 2 validation frames (1 a rank under 2 ranks),
    written once."""
    train, valid = os.path.join(work, "dp_train"), os.path.join(work, "dp_valid")
    if not os.path.isdir(train):
        write_gt_frames(train, 8, TRAIN_FRAME, seed=60)
        write_gt_frames(valid, 2, TRAIN_FRAME, seed=61)
    return train, valid


def dp1_phase(work: str, smi: str) -> dict:
    """``cli.train --config bsrgan`` and ``--config esrgan`` (full width,
    batch DP_BATCH, DP1_STEPS steps, deterministic algorithms) with
    torchrun's variables for a world of one (NCCL) and without them, the
    four runs at once: the final G, EMA-G and D (``u`` and BatchNorm's
    running statistics included) max abs 0 apart; step p50 of each."""
    train, valid = _dp_dirs(work)
    jobs = []
    for name in DP_CONFIGS:
        for tag in ("group", "plain"):
            env = _group_env(0, 1, _free_port()) if tag == "group" else {}
            jobs.append(({"cli": "train", "deterministic": True, "argv": _train_argv(name, train, valid, DP1_STEPS)},
                         env, os.path.join(work, f"dp1_{name}_{tag}")))
    recs, seconds = yield jobs
    out = {"seconds": seconds}
    for i, name in enumerate(DP_CONFIGS):
        group, plain = recs[2 * i], recs[2 * i + 1]
        check(group["world"] == 1 and group["backend"] == "nccl" and plain["backend"] is None,
              f"dp1 {name}: group {group['backend']}, plain {plain['backend']}")
        a, b = _ckpt(jobs[2 * i][2]), _ckpt(jobs[2 * i + 1][2])
        diffs = {f"{key}/{k}": (a[key][k].float() - v.float()).abs().max().item()
                 for key in ("state_dict", "ema_state_dict", "d_state_dict") for k, v in b[key].items()
                 if v.is_floating_point()}
        worst = max(diffs.values())
        stats = sum(1 for k in diffs if k.endswith(("running_mean", "running_var")))
        check(worst == 0.0, f"dp1 {name}: the world-of-one run differs from the plain one by {worst}")
        chains = group["filter2d"] >= 2 * DP1_STEPS if name == "bsrgan" else group["filter2d"] == 0
        check(group["rdb"] > 0 and chains and (group["rdb"], group["filter2d"]) == (plain["rdb"], plain["filter2d"]),
              f"dp1 {name}: launches {group['rdb']} rdb, {group['filter2d']} filter2d; without the group "
              f"{plain['rdb']}, {plain['filter2d']}")
        check(group["rdb_bwd"] == plain["rdb_bwd"] == RDB_PER_FORWARD * DP1_STEPS,
              f"dp1 {name}: {group['rdb_bwd']} and {plain['rdb_bwd']} rdb backward calls for {DP1_STEPS} steps")
        out[name] = {"max_abs": worst, "tensors": len(diffs), "batchnorm_stats": stats,
                     "step_ms_p50_group": float(np.median(group["step_ms"])),
                     "step_ms_p50_plain": float(np.median(plain["step_ms"])),
                     "rdb_launches": group["rdb"] + plain["rdb"],
                     "filter2d_launches": group["filter2d"] + plain["filter2d"]}
        print(f"dp1_phase {name} ({smi}): NCCL world of one vs no group, {len(diffs)} tensors of G, EMA-G and D "
              f"({stats} BatchNorm running statistics) max abs {worst}; step p50 {out[name]['step_ms_p50_group']:.2f} "
              f"ms with the group, {out[name]['step_ms_p50_plain']:.2f} without (four runs at once on the card); "
              f"{group['rdb']} rdb, {group['filter2d']} filter2d launches a run; wave {out['seconds']:.1f} s, "
              f"job seconds in main {[round(r['seconds'], 1) for r in recs]} (imports, first step at, last step end "
              f"at: {[(round(r['imports_s'], 1), round(r['first_step_at'], 1), round(r['last_step_end_at'], 1)) for r in recs]})",
              flush=True)
    return out


def _phase_rel(a: list, b: list) -> list[float]:
    """Per update phase of a step (in its order), ||a - b|| / ||b|| over
    the phase's gradients flattened: a norm over every tensor, so that a
    tensor whose gradient is roundoff of a sum that is 0 (the relativistic
    losses' logit bias) does not set the reading."""
    out = []
    for xs, ys in zip(a, b):
        diff = math.sqrt(sum(float((x.double() - y.double()).square().sum()) for x, y in zip(xs, ys)))
        out.append(diff / math.sqrt(sum(float(y.double().square().sum()) for y in ys)))
    return out


def _bn64(moments):
    """BatchNorm's batch moments taken by ``moments`` (the step's own code)
    on an f64 copy of the input, rounded back: dp2's conditioning."""
    return lambda xs: tuple(m.to(xs.dtype) for m in moments(xs.double()))


def _dp_reference(name: str, train: str, valid: str, inputs: list[dict], bn64: bool) -> tuple[list, list]:
    """The first step's gradients (per update phase, in the step's order) of
    one process on the ranks' degraded pairs concatenated in rank order,
    and in the other order, each from the same seeded state, f32, with the
    config the ranks' ``cli.train`` ran (one epoch of one step: the
    schedule's milestones, and so D's first learning rate in a D-first
    step, follow the epochs). ``bn64``: BatchNorm's moments in f64, as the
    ranks took them."""
    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.models import blocks
    from srganfd_tpu_torch.train import loop

    cfg = configs.get_config(name, train_gt_images_dir=train, valid_gt_images_dir=valid,
                             batch_size=DP_BATCH * len(inputs), compute_dtype="float32", epochs=1)
    real, moments = loop.Trainer._apply_update, blocks.BatchNorm.__dict__["_batch_moments"]
    tr = loop.Trainer(cfg, steps_per_epoch=1, device="cuda")
    out = []
    for order in (inputs, inputs[::-1]):
        grads = []

        def apply_update(self, opt, params):
            done = real(self, opt, params)
            grads.append([p.grad.detach().cpu() for p in params if p.grad is not None])
            return done

        state = tr.init_state()
        loop.Trainer._apply_update = apply_update
        if bn64:
            blocks.BatchNorm._batch_moments = staticmethod(_bn64(moments.__func__))
        try:
            tr.train_step(state, torch.cat([x["gt"] for x in order]).cuda(), torch.cat([x["lr"] for x in order]).cuda())
        finally:
            loop.Trainer._apply_update, blocks.BatchNorm._batch_moments = real, moments
        out.append(grads)
    return out[0], out[1]


def dp2_phase(work: str, smi: str) -> dict:
    """Two gloo ranks on cuda:0 (LOCAL_RANK 0 both), ``cli.train`` of
    ``bsrgan`` and ``esrgan`` for one f32 step at DP_BATCH frames a rank,
    deterministic algorithms; and ``esrgan`` again with each of two planted
    faults in this phase's own copy of the step: BatchNorm's statistics per
    rank, and the relativistic losses' means per rank. The ranks' synced
    first-step gradients against one process on both ranks' degraded pairs
    (rank 0's then rank 1's), from the same seeded state and config, per
    update phase as ||a - b|| / ||b||; the tolerance is 10x that
    reference's spread between the two orders of the pairs (floor 1e-6),
    every phase held. ``esrgan``'s runs and its reference take BatchNorm's
    moments in f64 (``_bn64``: the step's own code, all-reduce included, on
    an f64 copy): in f32 the fast variance E[x^2] - E[x]^2 cancels, and a
    reordered batch moves the gradients 4e-3 apart, which would hide any
    fault below that. Each planted run must fail the tolerance."""
    train, valid = _dp_dirs(work)
    runs = DP2_RUNS
    jobs = []
    for tag, extra in runs.items():
        port = _free_port()
        name = tag.split("_")[0]
        cwd = os.path.join(work, f"dp2_{tag}")
        spec = {"cli": "train", "gloo": True, "deterministic": True, "capture": os.path.join(cwd, "step0"),
                "argv": _train_argv(name, train, valid, 1, ("--compute-dtype", "float32")), **extra}
        jobs += [(spec, _group_env(r, 2, port), cwd) for r in range(2)]
    recs, seconds = yield jobs
    out = {"seconds": seconds}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for i, tag in enumerate(runs):
            cwd = jobs[2 * i][2]
            r0, r1 = recs[2 * i], recs[2 * i + 1]
            check(r0["world"] == 2 and r0["backend"] == "gloo", f"dp2 {tag}: {r0['world']} {r0['backend']}")
            g0, g1 = (torch.load(os.path.join(cwd, f"step0_grads{r}.pt")) for r in range(2))
            check(len(g0) == 2 and all(torch.equal(a, b) for xs, ys in zip(g0, g1) for a, b in zip(xs, ys)),
                  f"dp2 {tag}: the ranks' synced gradients differ")
            out[tag] = {"grads": g0, "rdb_launches": r0["rdb"] + r1["rdb"],
                        "filter2d_launches": r0["filter2d"] + r1["filter2d"], "staged": r0["staged"] + r1["staged"],
                        "inputs": [torch.load(os.path.join(cwd, f"step0_inputs{r}.pt")) for r in range(2)]}
        readings = {}
        t_ref = time.perf_counter()
        for name in DP_CONFIGS:
            ref, swapped = _dp_reference(name, train, valid, out[name]["inputs"], bool(runs[name].get("bn64")))
            spread = _phase_rel(swapped, ref)
            tol = [max(10 * v, 1e-6) for v in spread]
            got = _phase_rel(out[name]["grads"], ref)
            readings[name] = {"rel": got, "spread": spread, "tolerance": tol}
            check(all(g <= t for g, t in zip(got, tol)),
                  f"dp2 {name}: synced gradients {got} from one process's (per phase), tolerance {tol}")
            for tag in (t for t in runs if t.startswith(name + "_planted")):
                check(all(torch.equal(a["gt"], b["gt"]) for a, b in zip(out[tag]["inputs"], out[name]["inputs"])),
                      f"dp2 {tag}: its pairs differ from the held run's")
                planted = _phase_rel(out[tag]["grads"], ref)
                readings[name][tag] = planted
                check(any(p > t for p, t in zip(planted, tol)),
                      f"dp2 {tag}: the planted fault reads {planted}, within the tolerance {tol}")
        out["reference_seconds"] = time.perf_counter() - t_ref
        for tag in runs:
            for key in ("grads", "inputs"):
                out[tag].pop(key)
        out["readings"] = readings
    finally:
        torch.use_deterministic_algorithms(False)
    check(out["bsrgan"]["filter2d_launches"] > 0 and all(out[t]["rdb_launches"] > 0 for t in runs),
          "dp2: a rank launched no kernel")
    print(f"dp2_phase ({smi}): 2 gloo ranks on cuda:0, first-step synced gradients vs one process on both ranks' "
          f"pairs, ||a - b|| / ||b|| per update phase in the step's order, every phase held (esrgan's BatchNorm "
          f"moments in f64 in the ranks and the reference): " + "; ".join(
              f"{n} {r['rel']} (spread {r['spread']}, tolerance {r['tolerance']}"
              + "".join(f", {k} {v}" for k, v in r.items() if "_planted" in k) + ")"
              for n, r in readings.items())
          + f"; launches { {t: (out[t]['rdb_launches'], out[t]['filter2d_launches']) for t in runs} } (rdb, filter2d);"
          f" staged collectives { {t: out[t]['staged'] for t in runs} }; wave {seconds:.1f} s, job seconds in main "
          f"{[round(r['seconds'], 1) for r in recs]} (imports, first step at, last step end at: "
          f"{[(round(r['imports_s'], 1), round(r.get('first_step_at', 0), 1), round(r.get('last_step_end_at', 0), 1)) for r in recs]}), "
          f"{out['reference_seconds']:.1f} s for the 4 reference steps", flush=True)
    return out


def _loop_sr(model, img: np.ndarray, n: int, halo: int, row_multiple: int = 1, shards: bool = False) -> np.ndarray:
    from srganfd_tpu_torch.parallel.spatial import spatial_sr_loop

    return spatial_sr_loop(model, img, model.upscale, n, halo=halo, row_multiple=row_multiple, device="cuda",
                           shards_fn=model.forward_shards if shards else None)


def _png_sr(sr: np.ndarray) -> np.ndarray:
    """The 8-bit frame the CLIs write for ``sr`` (RGB)."""
    return np.clip(sr * 255.0, 0, 255).astype(np.uint8)


def spatial_phase(work: str, smi: str) -> dict:
    """``cli.infer --spatial-shard`` of full-width ``bsrgan_x2`` (seeded,
    f32) on one SP_FRAME^2 frame, halo 16: a world of one under NCCL and 2
    gloo ranks on cuda:0, each bit for bit the one-process loop of the same
    shards; the interior rows against the unsharded forward (printed);
    ``--data-shard --batch 4`` on 2 ranks over 6 frames, its files equal to
    the unsharded run's at the per-rank batch (2) and every frame written
    once. All jobs at once."""
    import cv2

    from srganfd_tpu_torch.cli import infer

    frame = write_frames(os.path.join(work, "sp_in"), 1, SP_FRAME, SP_FRAME, seed=71)[0]
    seq = os.path.join(work, "sp_seq")
    write_frames(seq, 6, 128, 128, seed=72)
    base = ["--model-arch", "bsrgan_x2"]
    one = [*base, "--spatial-shard", "--inputs-path", frame]
    jobs = [({"cli": "infer", "argv": [*one, "--output-path", os.path.join(work, "sp_w1.png")],
              "save_sr": os.path.join(work, "sp_w1")}, _group_env(0, 1, _free_port()), os.path.join(work, "sp_job_w1"))]
    port = _free_port()
    jobs += [({"cli": "infer", "gloo": True, "argv": [*one, "--output-path", os.path.join(work, "sp_w2.png")],
               "save_sr": os.path.join(work, "sp_w2")}, _group_env(r, 2, port), os.path.join(work, "sp_job_w2"))
             for r in range(2)]
    port = _free_port()
    jobs += [({"cli": "infer", "gloo": True, "argv": [*base, "--data-shard", "--batch", "4", "--inputs-path", seq,
                                                      "--output-path", os.path.join(work, "sp_ds")]},
              _group_env(r, 2, port), os.path.join(work, "sp_job_ds")) for r in range(2)]
    jobs.append(({"cli": "infer", "argv": [*base, "--batch", "2", "--inputs-path", seq,
                                           "--output-path", os.path.join(work, "sp_seq_out")]},
                 {}, os.path.join(work, "sp_job_seq")))
    recs, seconds = yield jobs
    check(recs[0]["backend"] == "nccl" and recs[0]["world"] == 1 and recs[1]["world"] == 2, "spatial: groups")
    model = infer.build_model("bsrgan_x2", torch.device("cuda"))
    img = cv2.cvtColor(cv2.imread(frame), cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    out = {"seconds": seconds}
    with torch.inference_mode():
        full = model(torch.from_numpy(img)[None].cuda())[0].cpu().numpy()
    for n, tag in ((1, "w1"), (2, "w2")):
        want = _loop_sr(model, img, n, 16)
        got = [np.load(os.path.join(work, f"sp_{tag}_rank{r}.npy"))[0] for r in range(n)]
        check(all(np.array_equal(g, want) for g in got), f"spatial {tag}: not the one-process loop bit for bit: "
              f"{max(float(np.abs(g - want).max()) for g in got)}")
        png = cv2.cvtColor(cv2.imread(os.path.join(work, f"sp_{tag}.png")), cv2.COLOR_BGR2RGB)
        check(np.array_equal(png, _png_sr(want)), f"spatial {tag}: the written frame is not the SR's")
        interior = slice(2 * 16 * 2, -2 * 16 * 2)  # rows away from the frame's reflected edges
        out[tag] = {"interior_max_abs_vs_unsharded": float(np.abs(got[0][interior] - full[interior]).max()),
                    "edge_max_abs_vs_unsharded": float(np.abs(got[0] - full).max())}
    names = sorted(os.listdir(seq))
    check(sorted(os.listdir(os.path.join(work, "sp_ds"))) == names, "data-shard: files")
    same = all(np.array_equal(cv2.imread(os.path.join(work, "sp_ds", f)), cv2.imread(os.path.join(work, "sp_seq_out", f)))
               for f in names)
    check(same, "--data-shard's files differ from the unsharded run's at the per-rank batch")
    ds = recs[3:5]
    check([r["rdb"] for r in ds] == [2 * RDB_PER_FORWARD, RDB_PER_FORWARD], f"data-shard launches {[r['rdb'] for r in ds]}")
    out["rdb_launches"] = sum(r["rdb"] for r in recs[:5])
    out["staged"] = [r["staged"] for r in recs[:5]]
    out["data_shard_frames_per_rank"] = [r["stdout"].split("SR'd ")[1].split(" ")[0] for r in ds]
    out["job_seconds"] = [round(r["seconds"], 3) for r in recs]
    check(all(r["rdb"] == RDB_PER_FORWARD for r in recs[:3]), f"spatial launches {[r['rdb'] for r in recs[:3]]}")
    print(f"spatial_phase ({smi}): bsrgan_x2 {SP_FRAME}x{SP_FRAME} f32 --spatial-shard, NCCL world of one and 2 gloo "
          f"ranks each bit for bit its one-process loop; against the unsharded forward: interior max abs "
          f"{ {t: out[t]['interior_max_abs_vs_unsharded'] for t in ('w1', 'w2')} }, with the edges "
          f"{ {t: out[t]['edge_max_abs_vs_unsharded'] for t in ('w1', 'w2')} }; --data-shard on 2 ranks: 6 files equal "
          f"to the unsharded run's, frames a rank {out['data_shard_frames_per_rank']}; rdb launches "
          f"{[r['rdb'] for r in recs]}; staged collectives {out['staged']}; wave {seconds:.1f} s, job seconds "
          f"{out['job_seconds']}", flush=True)
    return out


def cp_phase(work: str, weights: str, smi: str) -> dict:
    """``cli.infer --spatial-shard`` of full-width ``bsrgantrans_x2`` (the
    spread weights, f32) on a CP_FRAME^2 frame on 2 gloo ranks, with
    ``--cp-backend ring`` and ``ulysses`` at once: each bit for bit the
    one-process loop of the same algorithm (``forward_shards``); ring
    against Ulysses held to 1e-4; the unsharded model's max abs printed."""
    import cv2

    from srganfd_tpu_torch.cli import infer
    from srganfd_tpu_torch.parallel.spatial import spatial_sr_loop

    frame = write_frames(os.path.join(work, "cp_in"), 1, CP_FRAME, CP_FRAME, seed=73)[0]
    jobs = []
    for backend in ("ring", "ulysses"):
        port = _free_port()
        argv = ["--model-arch", "bsrgantrans_x2", "--weights", weights, "--spatial-shard", "--cp-backend", backend,
                "--inputs-path", frame, "--output-path", os.path.join(work, f"cp_{backend}.png")]
        jobs += [({"cli": "infer", "gloo": True, "argv": argv, "save_sr": os.path.join(work, f"cp_{backend}")},
                  _group_env(r, 2, port), os.path.join(work, f"cp_job_{backend}")) for r in range(2)]
    qkv = os.path.join(work, "cp_grad_qkv.npz")
    rng = np.random.default_rng(75)
    t_loc = CP_GRAD_SHAPE[1] // 2
    np.savez(qkv, **{k: rng.standard_normal(CP_GRAD_SHAPE).astype(np.float32) for k in ("q", "k", "v", "cot")},
             mask=np.tile(np.arange(t_loc) >= CP_GRAD_HALO, 2) & np.tile(np.arange(t_loc) < t_loc - CP_GRAD_HALO, 2))
    for backend in ("ring", "ulysses"):
        port = _free_port()
        jobs += [({"call": "cp_grad_rank", "gloo": True, "backend": backend, "qkv": qkv,
                   "out": os.path.join(work, f"cp_grad_{backend}")}, _group_env(r, 2, port),
                  os.path.join(work, f"cp_grad_job_{backend}")) for r in range(2)]
    recs, seconds = yield jobs
    out = {"seconds": seconds, "gradients": cp_grad_check(work, qkv)}
    recs = recs[:4]
    img = cv2.cvtColor(cv2.imread(frame), cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    plain = infer.build_model("bsrgantrans_x2", torch.device("cuda"), weights)
    with torch.inference_mode():
        full = plain(torch.from_numpy(img)[None].cuda())[0].cpu().numpy()
    got = {}
    for i, backend in enumerate(("ring", "ulysses")):
        kw = {"ring_axis": "data", "ring_halo": 16, "cp_backend": backend}
        model = infer.build_model("bsrgantrans_x2", torch.device("cuda"), weights, model_kwargs=kw)
        want = spatial_sr_loop(model, img, 2, 2, halo=16, row_multiple=2, device="cuda", shards_fn=model.forward_shards)
        got[backend] = [np.load(os.path.join(work, f"cp_{backend}_rank{r}.npy"))[0] for r in range(2)]
        check(all(np.array_equal(g, want) for g in got[backend]),
              f"cp {backend}: not the one-process loop bit for bit: {max(float(np.abs(g - want).max()) for g in got[backend])}")
        interior = slice(2 * 16 * 2, -2 * 16 * 2)
        out[backend] = {"max_abs_vs_unsharded": float(np.abs(got[backend][0] - full).max()),
                        "interior_max_abs_vs_unsharded": float(np.abs(got[backend][0][interior] - full[interior]).max()),
                        "rdb_launches": recs[2 * i]["rdb"] + recs[2 * i + 1]["rdb"],
                        "flash_launches": recs[2 * i]["flash"] + recs[2 * i + 1]["flash"],
                        "staged": [recs[2 * i]["staged"], recs[2 * i + 1]["staged"]]}
        check(out[backend]["rdb_launches"] == 2 * RDB_PER_FORWARD, f"cp {backend}: {out[backend]['rdb_launches']} rdb")
    ring_vs_ulysses = float(np.abs(got["ring"][0] - got["ulysses"][0]).max())
    check(ring_vs_ulysses <= 1e-4, f"cp: ring against ulysses {ring_vs_ulysses}")
    out["ring_vs_ulysses"] = ring_vs_ulysses
    out["spread"] = float(((full > 0.05) & (full < 0.95)).mean())
    print(f"cp_phase ({smi}): bsrgantrans_x2 {CP_FRAME}x{CP_FRAME} f32 on 2 gloo ranks, ring and ulysses each bit for "
          f"bit its one-process loop; ring vs ulysses max abs {ring_vs_ulysses:.3e}; vs the unsharded model "
          f"{ {b: out[b]['max_abs_vs_unsharded'] for b in ('ring', 'ulysses')} }, interior "
          f"{ {b: out[b]['interior_max_abs_vs_unsharded'] for b in ('ring', 'ulysses')} } (SR in (0.05, 0.95) at "
          f"{out['spread']:.2f}); launches (rdb, flash) { {b: (out[b]['rdb_launches'], out[b]['flash_launches']) for b in ('ring', 'ulysses')} };"
          f" staged collectives { {b: out[b]['staged'] for b in ('ring', 'ulysses')} }; wave {seconds:.1f} s, job "
          f"seconds {[round(r['seconds'], 1) for r in recs]}; gradients {out['gradients']}", flush=True)
    return out


def cp_grad_rank(spec: dict) -> dict:
    """One rank of ``cp_phase``'s gradient jobs: dq, dk and dv of
    ``sum(attention(q, k, v) * cot)`` through ring or Ulysses attention
    (``spec["backend"]``) on this rank's half of the token axis, on the
    card; saved with the output."""
    from srganfd_tpu_torch.parallel import comm
    from srganfd_tpu_torch.parallel.ring_attention import ring_attention
    from srganfd_tpu_torch.parallel.ulysses import ulysses_attention

    d = np.load(spec["qkv"])
    n, r = comm.world(), comm.rank()
    t = d["q"].shape[1] // n
    part = lambda a: torch.from_numpy(np.ascontiguousarray(a[:, r * t:(r + 1) * t])).cuda()  # noqa: E731
    q, k, v = (part(d[x]).requires_grad_() for x in ("q", "k", "v"))
    fn = ring_attention if spec["backend"] == "ring" else ulysses_attention
    y = fn(q, k, v, torch.from_numpy(d["mask"][r * t:(r + 1) * t]).cuda())
    (y * part(d["cot"])).sum().backward()
    torch.cuda.synchronize()
    np.savez(spec["out"] + f"_rank{r}.npz", y=y.detach().cpu().numpy(),
             **{f"d{x}": g.grad.cpu().numpy() for x, g in zip("qkv", (q, k, v))})
    return {"world": n}


def cp_grad_check(work: str, qkv: str) -> dict:
    """The ranks' outputs and gradients (``cp_grad_rank``) against the
    one-process loops' (``ring_attention_loop``, ``ulysses_attention_loop``)
    on the card, on the same halves: the outputs bit for bit, each of dq,
    dk and dv to 1e-5 of its largest entry, the masked keys' dk and dv 0."""
    from srganfd_tpu_torch.parallel.ring_attention import ring_attention_loop
    from srganfd_tpu_torch.parallel.ulysses import ulysses_attention_loop

    d = np.load(qkv)
    t = d["q"].shape[1] // 2
    out = {}
    for backend, loop in (("ring", ring_attention_loop), ("ulysses", ulysses_attention_loop)):
        shards = [[torch.from_numpy(np.ascontiguousarray(d[x][:, i * t:(i + 1) * t])).cuda().requires_grad_()
                   for i in range(2)] for x in ("q", "k", "v")]
        masks = [torch.from_numpy(d["mask"][i * t:(i + 1) * t]).cuda() for i in range(2)]
        ys = loop(*shards, masks)
        sum((y * torch.from_numpy(np.ascontiguousarray(d["cot"][:, i * t:(i + 1) * t])).cuda()).sum()
            for i, y in enumerate(ys)).backward()
        ranks = [np.load(os.path.join(work, f"cp_grad_{backend}_rank{i}.npz")) for i in range(2)]
        check(all(np.array_equal(ranks[i]["y"], ys[i].detach().cpu().numpy()) for i in range(2)),
              f"cp gradients {backend}: the ranks' outputs are not the loop's bit for bit")
        rel = {}
        for j, x in enumerate("qkv"):
            want = torch.cat([g.grad for g in shards[j]], 1).cpu().numpy()
            got = np.concatenate([rk[f"d{x}"] for rk in ranks], 1)
            rel[f"d{x}"] = float(np.abs(got - want).max() / np.abs(want).max())
            if x != "q":
                check(not got[:, ~d["mask"]].any(), f"cp gradients {backend}: d{x} of a masked key is not 0")
        check(all(v <= 1e-5 for v in rel.values()), f"cp gradients {backend}: {rel} from the loop's, limit 1e-5")
        out[backend] = rel
    return out


def pp_phase(work: str, smi: str) -> dict:
    """Pipeline parallelism: ``cli.train`` of ``bsrnet`` at full width
    (64/32/23, ``scan_blocks``), f32, PP_STEPS steps at DP_BATCH frames,
    deterministic algorithms, on a ``("data", "pipe")`` mesh: a world of one
    under NCCL (1, 1), and 2 gloo ranks on cuda:0 (1, 2), the trunk in 2
    microbatches, each rank running 12 and 11 of the 23 RRDBs; and those 2
    ranks again with a planted fault, the output cotangent not divided over
    the stages. The first step's gradients, after the sum of the trunk's
    over the axis, against one process's plain step on the same batch, as
    ``dp2_phase`` holds them: ||a - b|| / ||b||, within 10x the reference's
    spread between two orders of the batch's frames (floor 1e-6); the
    planted run must fail that. The ranks of the data row degrade the same
    frames and end with the same gradients."""
    train, valid = _dp_dirs(work)
    jobs = []
    for tag, (world, extra) in PP_RUNS.items():
        port, cwd = _free_port(), os.path.join(work, f"pp_{tag}")
        spec = {"cli": "train", "gloo": world > 1, "deterministic": True, "cfg": PP_CFG,
                "capture": os.path.join(cwd, "step0"),
                "argv": _train_argv("bsrnet", train, valid, PP_STEPS, ("--compute-dtype", "float32")), **extra}
        jobs += [(spec, _group_env(r, world, port), cwd) for r in range(world)]
    recs, seconds = yield jobs
    out = {"seconds": seconds}
    i = 0
    for tag, (world, _) in PP_RUNS.items():
        rs, cwd = recs[i:i + world], jobs[i][2]
        i += world
        check(all(r["world"] == world for r in rs) and rs[0]["backend"] == ("gloo" if world > 1 else "nccl"),
              f"pp {tag}: world {[r['world'] for r in rs]}, backend {rs[0]['backend']}")
        grads = [torch.load(os.path.join(cwd, f"step0_grads{r}.pt")) for r in range(world)]
        inputs = [torch.load(os.path.join(cwd, f"step0_inputs{r}.pt")) for r in range(world)]
        check(all(torch.equal(a, b) for g in grads for xs, ys in zip(g, grads[0]) for a, b in zip(xs, ys)),
              f"pp {tag}: the ranks' synced gradients differ")
        check(all(torch.equal(x[k], inputs[0][k]) for x in inputs for k in ("gt", "lr")),
              f"pp {tag}: the ranks of one data row degraded different frames")
        out[tag] = {"grads": grads[0], "inputs": inputs[0], "rdb_launches": [r["rdb"] for r in rs],
                    "filter2d_launches": [r["filter2d"] for r in rs], "staged": [r["staged"] for r in rs],
                    "step_ms_p50": [float(np.median(r["step_ms"])) for r in rs]}
        check(all(r["rdb"] > 0 and r["filter2d"] > 0 for r in rs), f"pp {tag}: a rank launched no kernel")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        x = out["pp2"]["inputs"]
        frames = [{"gt": x["gt"][j:j + 1], "lr": x["lr"][j:j + 1]} for j in range(x["gt"].shape[0])]
        ref, swapped = _dp_reference("bsrnet", train, valid, frames, False)
    finally:
        torch.use_deterministic_algorithms(False)
    spread = _phase_rel(swapped, ref)
    tol = [max(10 * v, 1e-6) for v in spread]
    readings = {}
    for tag in PP_RUNS:
        check(all(torch.equal(out[tag]["inputs"][k], x[k]) for k in ("gt", "lr")), f"pp {tag}: not pp2's batch")
        readings[tag] = _phase_rel(out[tag].pop("grads"), ref)
        out[tag].pop("inputs")
        held = all(g <= t for g, t in zip(readings[tag], tol))
        check(held if "planted" not in tag else not held,
              f"pp {tag}: first-step gradients {readings[tag]} from one process's, tolerance {tol}")
    out.update(readings=readings, spread=spread, tolerance=tol)
    out["rdb_launches"] = sum(sum(out[t]["rdb_launches"]) for t in PP_RUNS)
    out["filter2d_launches"] = sum(sum(out[t]["filter2d_launches"]) for t in PP_RUNS)
    print(f"pp_phase ({smi}): bsrnet full width, scan_blocks, (data, pipe) = (1, 1) under NCCL and (1, 2) on 2 "
          f"gloo ranks on cuda:0, first-step gradients vs one process on the same batch, ||a - b|| / ||b||: "
          f"{ {t: readings[t] for t in PP_RUNS} } (spread {spread}, tolerance {tol}; the planted run must exceed it); "
          f"launches (rdb, filter2d) a rank { {t: list(zip(out[t]['rdb_launches'], out[t]['filter2d_launches'])) for t in PP_RUNS} }; "
          f"staged collectives { {t: out[t]['staged'] for t in PP_RUNS} }; step p50 ms "
          f"{ {t: [round(v, 2) for v in out[t]['step_ms_p50']] for t in PP_RUNS} }; wave {seconds:.1f} s", flush=True)
    return out


def tp_rank(spec: dict) -> dict:
    """One rank of ``tp_phase``: ``bsrgan_x2`` (f32, ``spec["weights"]``)
    channel-sharded over the ``model`` axis of a ``("model", "data")`` mesh
    of every rank, its forward of ``spec["frame"]`` saved; the parameters it
    keeps sharded and whole."""
    import cv2

    from srganfd_tpu_torch.cli import infer
    from srganfd_tpu_torch.parallel import comm
    from srganfd_tpu_torch.parallel.mesh import make_mesh, maybe_init_distributed
    from srganfd_tpu_torch.parallel.tensor import channel_sharded_params

    # cuDNN as in the process that holds the ranks to the replicated forward
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    maybe_init_distributed("cuda")
    mesh = make_mesh((-1, 1), ("model", "data"))
    whole = infer.build_model("bsrgan_x2", torch.device("cuda"), spec["weights"])
    shapes = {k: v.shape for k, v in whole.state_dict().items()}
    model = channel_sharded_params(whole, mesh)
    img = cv2.cvtColor(cv2.imread(spec["frame"]), cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    with torch.inference_mode():
        sr = model(torch.from_numpy(img)[None].cuda())[0].cpu().numpy()
    np.save(spec["out"] + f"_rank{comm.rank()}.npy", sr)
    kept = {k: v.shape for k, v in model.state_dict().items()}
    sharded = sorted(k for k in kept if kept[k] != shapes[k])
    return {"model_axis": mesh.size("model"), "sharded": len(sharded),
            "whole": sorted(k for k in kept if kept[k] == shapes[k]) if sharded else len(kept)}


def tp_phase(work: str, weights: str, smi: str) -> dict:
    """Tensor parallelism: ``channel_sharded_params`` on ``bsrgan_x2`` (full
    width, spread weights, f32) over a ``("model", "data")`` mesh, a world of
    one under NCCL (1, 1) and 2 gloo ranks on cuda:0 (2, 1), one TP_FRAME^2
    frame: each rank's SR against the replicated forward, bit for bit or to
    1e-3; on 2 ranks every conv of 64 or 32 output channels holds half of
    them and the 3-channel head is whole; 69 RDB kernel calls a rank."""
    import cv2

    from srganfd_tpu_torch.cli import infer

    frame = write_frames(os.path.join(work, "tp_in"), 1, TP_FRAME, TP_FRAME, seed=74)[0]
    jobs = []
    for world in (1, 2):
        port = _free_port()
        jobs += [({"call": "tp_rank", "gloo": world > 1, "weights": weights, "frame": frame,
                   "out": os.path.join(work, f"tp_w{world}")}, _group_env(r, world, port),
                  os.path.join(work, f"tp_job_w{world}")) for r in range(world)]
    recs, seconds = yield jobs
    img = cv2.cvtColor(cv2.imread(frame), cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    plain = infer.build_model("bsrgan_x2", torch.device("cuda"), weights)
    with torch.inference_mode():
        full = plain(torch.from_numpy(img)[None].cuda())[0].cpu().numpy()
    out = {"seconds": seconds, "rdb_launches": sum(r["rdb"] for r in recs)}
    for world, rs in ((1, recs[:1]), (2, recs[1:])):
        srs = [np.load(os.path.join(work, f"tp_w{world}_rank{r}.npy")) for r in range(world)]
        worst = max(float(np.abs(sr - full).max()) for sr in srs)
        check(worst <= 1e-3, f"tp on {world} ranks: max abs {worst} from the replicated forward, limit 1e-3")
        check(all(r["rdb"] == RDB_PER_FORWARD for r in rs), f"tp on {world} ranks: rdb {[r['rdb'] for r in rs]}")
        call = rs[0]["call"]
        if world == 2:
            check(call["whole"] == ["conv4.bias", "conv4.weight"] and call["sharded"] == 2 * (5 * 3 * NUM_RRDB + 4),
                  f"tp on 2 ranks: whole {call['whole']}, {call['sharded']} sharded")
        out[f"w{world}"] = {"max_abs": worst, "bit_for_bit": all(np.array_equal(sr, full) for sr in srs),
                            "sharded": call["sharded"], "whole": call["whole"]}
    print(f"tp_phase ({smi}): bsrgan_x2 {TP_FRAME}x{TP_FRAME} f32, (model, data) = (1, 1) under NCCL and (2, 1) on 2 "
          f"gloo ranks on cuda:0, against the replicated forward: "
          f"{ {k: (v['max_abs'], v['bit_for_bit']) for k, v in out.items() if k.startswith('w')} } (max abs, bit for bit); "
          f"{out['w2']['sharded']} tensors sharded, {out['w2']['whole']} whole; {out['rdb_launches']} rdb launches; "
          f"wave {seconds:.1f} s, job seconds {[round(r['seconds'], 1) for r in recs]}", flush=True)
    return out


def serve_spatial_phase(work: str, smi: str) -> dict:
    """``cli.serve --stdio --spatial-shard`` of full-width ``bsrgan_x2``
    (seeded, f32) on 2 gloo ranks: 4 requests, the spatial phase's frame
    and SERVE_SHAPES; every reply ok at 2x, the frames equal to the spatial
    phase's output (the first) and to the one-process loop (all); the
    shutdown ends both ranks with exit 0 within the timeout. The ranks also
    try each collective on a CUDA tensor under gloo (printed)."""
    import cv2

    from srganfd_tpu_torch.cli import infer

    frames = [os.path.join(work, "sp_in", "frame_000.png")]
    for i, (h, w) in enumerate(SERVE_SHAPES):
        frames += write_frames(os.path.join(work, f"ss_in{i}"), 1, h, w, seed=80 + i)
    outs = [os.path.join(work, "ss_out", f"f{i}.png") for i in range(len(frames))]
    req = os.path.join(work, "ss_requests.jsonl")
    with open(req, "w") as f:
        for i, (a, b) in enumerate(zip(frames, outs)):
            f.write(json.dumps({"id": i, "input": a, "output": b}) + "\n")
        f.write('{"cmd": "shutdown"}\n')
    port = _free_port()
    jobs = [({"cli": "serve", "gloo": True, "probe": True, "stdin": req,
              "argv": ["--model-arch", "bsrgan_x2", "--stdio", "--spatial-shard"]},
             _group_env(r, 2, port), os.path.join(work, "ss_job")) for r in range(2)]
    recs, seconds = yield jobs
    replies = [json.loads(ln) for ln in recs[0]["stdout"].splitlines() if ln.startswith("{")]
    check([r.get("id") for r in replies] == list(range(len(frames))) and all(r["ok"] for r in replies),
          f"serve_spatial replies {replies}")
    check(not any(ln.startswith("{") for ln in recs[1]["stdout"].splitlines()), "rank 1 replied")
    model = infer.build_model("bsrgan_x2", torch.device("cuda"))
    for i, (frame, out_path) in enumerate(zip(frames, outs)):
        img = cv2.cvtColor(cv2.imread(frame), cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        got = cv2.cvtColor(cv2.imread(out_path), cv2.COLOR_BGR2RGB)
        check(replies[i]["out_hw"] == [2 * img.shape[0], 2 * img.shape[1]], f"serve_spatial {i}: {replies[i]}")
        check(np.array_equal(got, _png_sr(_loop_sr(model, img, 2, 16))), f"serve_spatial {i}: not the loop's frame")
    first = cv2.imread(os.path.join(work, "sp_w2.png"))
    check(np.array_equal(cv2.imread(outs[0]), first), "serve_spatial: frame 0 is not the spatial phase's")
    probe = recs[0]["probe"]
    print(f"serve_spatial_phase ({smi}): cli.serve --stdio --spatial-shard on 2 gloo ranks, {len(frames)} replies "
          f"equal to the spatial phase's frame and the one-process loop's, both ranks exit 0 after the shutdown in "
          f"{max(r['seconds'] for r in recs):.1f} s of main (wave {seconds:.1f} s); rdb launches "
          f"{[r['rdb'] for r in recs]}; staged collectives {[r['staged'] for r in recs]};"
          f" gloo on CUDA tensors: {probe}", flush=True)
    return {"seconds": seconds, "rdb_launches": sum(r["rdb"] for r in recs), "staged": [r["staged"] for r in recs],
            "gloo_cuda": probe, "replies_ms": [r["ms"] for r in replies]}


def _wave(phases: dict, label: str) -> dict:
    """Run the phases' rank jobs all at once: each phase is a generator
    that yields its jobs and gets back (its records, the wave's seconds),
    then checks them and returns its result."""
    jobs = {k: next(g) for k, g in phases.items()}
    t0 = time.perf_counter()
    recs = _launch([j for js in jobs.values() for j in js], label)
    seconds = time.perf_counter() - t0
    out, i = {}, 0
    for k, g in phases.items():
        try:
            g.send((recs[i:i + len(jobs[k])], seconds))
            fail(f"{k}: the phase asked for a second wave")
        except StopIteration as stop:
            out[k] = stop.value
        i += len(jobs[k])
    return out


def parallel_phases(work: str, weights: str, smi: str) -> dict:
    """The eight phases of the parallel modes in three waves of concurrent
    rank processes (inference, data-parallel training, then the pipeline
    and tensor-parallel phases); their launches and seconds."""
    t0 = time.perf_counter()
    res = _wave({"spatial": spatial_phase(work, smi), "cp": cp_phase(work, weights, smi),
                 "serve_spatial": serve_spatial_phase(work, smi)}, "parallel inference")
    res.update(_wave({"dp1": dp1_phase(work, smi), "dp2": dp2_phase(work, smi)}, "parallel training"))
    res.update(_wave({"pp": pp_phase(work, smi), "tp": tp_phase(work, spread_weights(work, "bsrgan_x2", 3.0), smi)},
                     "pipeline and tensor parallelism"))
    res["seconds"] = time.perf_counter() - t0
    res["rdb_launches"] = (sum(res["dp1"][n]["rdb_launches"] for n in DP_CONFIGS)
                           + sum(res["dp2"][t]["rdb_launches"] for t in DP2_RUNS)
                           + res["spatial"]["rdb_launches"] + res["cp"]["ring"]["rdb_launches"]
                           + res["cp"]["ulysses"]["rdb_launches"] + res["serve_spatial"]["rdb_launches"]
                           + res["pp"]["rdb_launches"] + res["tp"]["rdb_launches"])
    res["filter2d_launches"] = (sum(res["dp1"][n]["filter2d_launches"] for n in DP_CONFIGS)
                                + sum(res["dp2"][t]["filter2d_launches"] for t in DP2_RUNS)
                                + res["pp"]["filter2d_launches"])
    print(f"parallel phases ({smi}): {res['seconds']:.1f} s; {res['rdb_launches']} rdb and "
          f"{res['filter2d_launches']} filter2d launches in their ranks (pipeline {res['pp']['rdb_launches']} and "
          f"{res['pp']['filter2d_launches']}, tensor parallel {res['tp']['rdb_launches']} rdb)", flush=True)
    return res


DISPATCH_K = 2  # SRGANFD_STEPS_PER_DISPATCH of the dispatch phase
DISPATCH_STEPS = {"bsrnet": 8, "bsrgan": 6}  # one epoch each: 1 eager dispatch, then replays
LOADER_BATCHES = 6  # batches of 16 x 320^2 read for the loader's own checks


def _dispatch_run(name: str, base: str, train_dir: str, valid_dir: str, env: dict, graphs: bool,
                  plant: bool = False) -> dict:
    """One full-width cli.train.run_train in its own directory (in the
    worker process): the final state on the host, each dispatch's (or
    step's) time on the card, the Data meter, the graphs' counts and the
    run's standard output."""
    import contextlib

    from srganfd_tpu_torch import configs
    from srganfd_tpu_torch.cli import train as cli_train
    from srganfd_tpu_torch.models import blocks
    from srganfd_tpu_torch.train import graphs as graphs_mod
    from srganfd_tpu_torch.train.loop import Trainer
    from srganfd_tpu_torch.utils.meters import AverageMeter

    cfg_name = "bsrgan" if name.startswith("bsrgan") else "bsrnet"
    cwd = os.path.join(base, name)
    os.makedirs(cwd, exist_ok=True)
    cfg = configs.get_config(cfg_name).replace(
        train_gt_images_dir=train_dir, valid_gt_images_dir=valid_dir, results_dir=os.path.join(cwd, "results"),
        epochs=1, skip_nonfinite_updates=cfg_name == "bsrgan")
    rec = {"dispatch_ms": [], "step_ms": [], "data_s": []}
    trainers = []
    real = (Trainer.__init__, Trainer._dispatch, Trainer.train_step, AverageMeter.update,
            blocks.ResidualDenseBlock.packed, graphs_mod.repack_always)

    def init(self, *a, **kw):
        real[0](self, *a, **kw)
        self.cuda_graphs = graphs
        trainers.append(self)

    def dispatch(self, state, key, fn, inputs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = self.graph_stats().get("replays", 0)
        m = real[1](self, state, key, fn, inputs)
        torch.cuda.synchronize()
        replayed = self.graph_stats().get("replays", 0) > before
        rec["dispatch_ms"].append((int(inputs[0].shape[0]), (time.perf_counter() - t0) * 1e3, replayed))
        return m

    def train_step(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = real[2](self, *a, **kw)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        return m

    def update(self, val, n=1):
        if self.name == "Data":
            rec["data_s"].append(float(val))
        real[3](self, val, n)

    frozen = [False]

    def stale_packed(self, dtype):  # the planted fault: the cache's host check frozen in the capture
        if frozen[0] and self._packed is not None and self._packed[0][0] == dtype:
            return self._packed[1], self._packed[2]
        return real[4](self, dtype)

    @contextlib.contextmanager
    def frozen_cache():
        frozen[0] = True
        try:
            yield
        finally:
            frozen[0] = False

    saved_env = {k: os.environ.get(k) for k in ("SRGANFD_NATIVE_LOADER", "SRGANFD_FUSE_STEP",
                                                 "SRGANFD_STEPS_PER_DISPATCH")}
    Trainer.__init__, Trainer._dispatch, Trainer.train_step, AverageMeter.update = init, dispatch, train_step, update
    if plant:
        blocks.ResidualDenseBlock.packed, graphs_mod.repack_always = stale_packed, frozen_cache
    out = io.StringIO()
    try:
        for k in saved_env:
            os.environ.pop(k, None)
        os.environ.update(env)
        with contextlib.redirect_stdout(out):
            state = cli_train.run_train(cfg, steps_per_epoch=DISPATCH_STEPS[cfg_name], device="cuda")["state"]
    finally:
        (Trainer.__init__, Trainer._dispatch, Trainer.train_step, AverageMeter.update,
         blocks.ResidualDenseBlock.packed, graphs_mod.repack_always) = real
        for k, v in saved_env.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    tensors = {f"g.{k}": v.detach().cpu() for k, v in state.g_model.state_dict().items()}
    tensors.update({f"ema.{k}": v.detach().cpu() for k, v in state.ema_g.items()})
    if state.d_model is not None:
        tensors.update({f"d.{k}": v.detach().cpu() for k, v in state.d_model.state_dict().items()})
    for tag, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
        for i, st in enumerate(opt.state.values() if opt is not None else ()):
            tensors.update({f"{tag}.{i}.{k}": v.detach().cpu() for k, v in st.items()})
    rec.update(stdout=out.getvalue(), tensors=tensors, stats=trainers[0].graph_stats() if trainers else {},
               step=state.step, counts=(state.g_count, state.d_count))
    return rec


def dispatch_worker(spec_path: str) -> None:
    """``chip_smoke.py --dispatch-worker SPEC``: the dispatch phase's runs in
    one process started with deterministic algorithms and cuBLAS's fixed
    workspace; writes its results beside SPEC."""
    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, ROOT)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import warnings

    from srganfd_tpu_torch.data import native_loader
    from srganfd_tpu_torch.data.datasets import list_image_files

    res: dict = {}
    t0 = time.perf_counter()
    res["native_available"] = native_loader.available()
    res["native_build_s"] = time.perf_counter() - t0
    res["native_reason"] = native_loader.unavailable_reason()
    if res["native_available"]:
        paths = list_image_files(spec["train_dir"])

        def take(n, **kw):
            ld = native_loader.NativeBatchLoader(paths, crop=320, batch_size=16, seed=0, uint8=True, pinned=True, **kw)
            it = iter(ld)
            t = time.perf_counter()
            got = [next(it)["gt"].clone() for _ in range(n)]
            ms = (time.perf_counter() - t) * 1e3 / n
            ld.close()
            return got, ms

        two, ms2 = take(LOADER_BATCHES, num_threads=2)
        eight, ms8 = take(LOADER_BATCHES, num_threads=8)
        sought, _ = take(LOADER_BATCHES - 3, num_threads=8, start_batch=3)
        res["loader"] = {
            "threads_equal": all(torch.equal(a, b) for a, b in zip(two, eight)),
            "seek_equal": all(torch.equal(a, b) for a, b in zip(two[3:], sought)),
            "pinned": bool(two[0].is_pinned()), "shape": list(two[0].shape), "dtype": str(two[0].dtype),
            "batch_ms_2_threads": ms2, "batch_ms_8_threads": ms8,
        }
    runs = {
        # before this change: BatchLoader, one host-form step a step
        "bsrnet_before": ({"SRGANFD_NATIVE_LOADER": "0"}, False, False),
        "bsrnet_eager": ({"SRGANFD_FUSE_STEP": "1", "SRGANFD_STEPS_PER_DISPATCH": str(DISPATCH_K)}, False, False),
        "bsrnet_graph": ({"SRGANFD_FUSE_STEP": "1", "SRGANFD_STEPS_PER_DISPATCH": str(DISPATCH_K)}, True, False),
        "bsrnet_stale": ({"SRGANFD_FUSE_STEP": "1", "SRGANFD_STEPS_PER_DISPATCH": str(DISPATCH_K)}, True, True),
        "bsrgan_eager": ({"SRGANFD_STEPS_PER_DISPATCH": str(DISPATCH_K)}, False, False),
        "bsrgan_graph": ({"SRGANFD_STEPS_PER_DISPATCH": str(DISPATCH_K)}, True, False),
    }
    tensors = {}
    for name, (env, graphs, plant) in runs.items():
        t = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            r = _dispatch_run(name, spec["work"], spec["train_dir"], spec["valid_dir"], env, graphs, plant)
        r["seconds"] = time.perf_counter() - t
        r["nondeterministic_ops"] = sorted({str(w.message)[:120] for w in caught if "deterministic" in str(w.message)})
        tensors[name] = r.pop("tensors")
        res[name] = r
        torch.cuda.empty_cache()

    def max_abs(a: str, b: str) -> float:
        ta, tb = tensors[a], tensors[b]
        assert set(ta) == set(tb), (a, b)
        return max(float((ta[k].double() - tb[k].double()).abs().max()) if ta[k].is_floating_point()
                   else float((ta[k] != tb[k]).any()) for k in ta)

    res["graph_vs_eager"] = {"bsrnet": max_abs("bsrnet_graph", "bsrnet_eager"),
                             "bsrgan": max_abs("bsrgan_graph", "bsrgan_eager"),
                             "bsrnet_planted_stale_packing": max_abs("bsrnet_stale", "bsrnet_eager")}
    with open(os.path.join(os.path.dirname(spec_path), "dispatch_result.json"), "w") as f:
        json.dump(res, f)


def _p50(xs: list) -> float:
    return float(np.percentile(xs, 50)) if xs else float("nan")


def dispatch_phase(work: str, smi: str) -> dict:
    """The native loader, prefetch and both dispatch variables at full
    width, in a fresh process (``--dispatch-worker``) under deterministic
    algorithms: the loader's stream for 2 and 8 threads and after a
    ``start_batch`` seek; ``bsrnet`` (batch 16, pre-crop 320, GT 144, bf16)
    under ``SRGANFD_FUSE_STEP=1 SRGANFD_STEPS_PER_DISPATCH=2`` and
    ``bsrgan`` (with its D and ``--skip-nonfinite``) under
    ``SRGANFD_STEPS_PER_DISPATCH=2``, each with CUDA graphs against the same
    run eager, bit for bit; the graph run with the RDB cache's host check
    frozen in the capture (a planted fault) must differ; the Data meter
    before (BatchLoader) and after (native loader and prefetch)."""
    base = os.path.join(work, "dispatch")
    train_dir, valid_dir = os.path.join(base, "train_gt"), os.path.join(base, "valid_gt")
    write_gt_frames(train_dir, 32, TRAIN_FRAME, seed=30)
    write_gt_frames(valid_dir, 4, TRAIN_FRAME, seed=31)
    spec = os.path.join(base, "spec.json")
    with open(spec, "w") as f:
        json.dump({"work": base, "train_dir": train_dir, "valid_dir": valid_dir}, f)
    env = dict(os.environ, PYTHONPATH=ROOT, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-u", os.path.join(ROOT, "chip_smoke.py"), "--dispatch-worker", spec],
                          env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"dispatch worker exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    with open(os.path.join(base, "dispatch_result.json")) as f:
        res = json.load(f)
    res["seconds"] = seconds
    if res["native_available"]:
        lo = res["loader"]
        print(f"native loader ({smi}): built and loaded in {res['native_build_s']:.2f} s; {LOADER_BATCHES} batches "
              f"{lo['shape']} {lo['dtype']} pinned={lo['pinned']}: 2 threads equal 8 threads: {lo['threads_equal']}, "
              f"start_batch=3 equal to skipping 3: {lo['seek_equal']}; {lo['batch_ms_2_threads']:.1f} ms a batch on 2 "
              f"threads, {lo['batch_ms_8_threads']:.1f} on 8 (decode included: first pass)", flush=True)
        check(lo["threads_equal"] and lo["seek_equal"] and lo["pinned"], "the native loader's stream is not its own")
        for name in ("bsrnet_eager", "bsrnet_graph", "bsrgan_graph"):
            check("using native C++ data loader" in res[name]["stdout"], f"{name} did not use the native loader")
    else:
        print(f"native loader unavailable on this host: {res['native_reason']}", flush=True)
        check("native C++ data loader unavailable" in res["bsrnet_graph"]["stdout"],
              "cli.train did not report the native loader's fallback")
    check("native C++ data loader" not in res["bsrnet_before"]["stdout"], "SRGANFD_NATIVE_LOADER=0 was not obeyed")
    for name, want in (("bsrnet_graph", "(fused chain)"), ("bsrgan_graph", "per device dispatch")):
        check(want in res[name]["stdout"], f"{name}: cli.train did not announce the dispatch mode")
    for name in ("bsrnet", "bsrgan"):
        g, e = res[f"{name}_graph"], res[f"{name}_eager"]
        st = g["stats"]
        replay_ms = [ms / k for k, ms, replayed in g["dispatch_ms"] if replayed]
        eager_ms = [ms / k for k, ms, _ in e["dispatch_ms"][1:]]  # the first dispatch warms cuDNN and cuBLAS
        res[name] = {"graph_step_ms_p50": _p50(replay_ms), "eager_step_ms_p50": _p50(eager_ms),
                     "first_dispatch_ms_graph": g["dispatch_ms"][0][1], "data_s_p50": _p50(g["data_s"]),
                     "captured": st.get("captured", 0), "replays": st.get("replays", 0),
                     "eager_dispatches": st.get("eager_dispatches", 0),
                     "launches_per_replay": st.get("launches_per_replay", {}),
                     "steps": g["step"], "max_abs_vs_eager": res["graph_vs_eager"][name],
                     "nondeterministic_ops": sorted(set(g["nondeterministic_ops"]) | set(e["nondeterministic_ops"]))}
        r = res[name]
        print(f"{name} K-step dispatch ({smi}): {r['captured']} graph(s) captured, {r['eager_dispatches']} eager "
              f"dispatch(es), {r['replays']} replays for {r['steps']} steps (1 replay a dispatch of {DISPATCH_K} "
              f"steps); kernel launches a replay {r['launches_per_replay']}; step p50 on the host clock "
              f"(synchronized): graph {r['graph_step_ms_p50']:.2f} ms, eager {r['eager_step_ms_p50']:.2f} ms; first "
              f"dispatch with the capture {r['first_dispatch_ms_graph']:.1f} ms; graph against eager max abs "
              f"{r['max_abs_vs_eager']:.3g}; ops without a deterministic implementation: "
              f"{r['nondeterministic_ops']}", flush=True)
        check(r["captured"] >= 1 and r["replays"] >= 1, f"{name}: no graph was replayed")
        check(g["step"] == e["step"] == DISPATCH_STEPS[name], f"{name}: the runs took {g['step']} and {e['step']} steps")
        check(r["max_abs_vs_eager"] == 0.0, f"{name}: the graph replays differ from the eager steps "
              f"(max abs {r['max_abs_vs_eager']:.3g})")
        launches = next(iter(r["launches_per_replay"].values()))
        check(launches["rdb"] == DISPATCH_K * RDB_PER_FORWARD, f"{name}: {launches['rdb']} RDB launches a replay")
    check(res["bsrnet"]["launches_per_replay"] and
          next(iter(res["bsrnet"]["launches_per_replay"].values()))["filter2d"] == DISPATCH_K * FILTERS_PER_CHAIN,
          "the fused bsrnet graph holds the wrong number of filter2d launches")
    planted = res["graph_vs_eager"]["bsrnet_planted_stale_packing"]
    print(f"planted fault (the RDB packing's host check frozen in the capture): graph against eager max abs "
          f"{planted:.3g}", flush=True)
    check(planted > 0.0, "stale packed RDB weights in the graph went unseen by the graph-against-eager check")
    before, after = res["bsrnet_before"], res["bsrnet_graph"]
    res["data_meter"] = {"before_s_p50": _p50(before["data_s"]), "after_s_p50": _p50(after["data_s"]),
                         "before_step_ms_p50": _p50(before["step_ms"])}
    loader = "native loader" if res["native_available"] else "BatchLoader (no native loader here)"
    print(f"bsrnet Data meter p50 ({smi}; 16 x 320^2 crops, includes the chain before this change): before "
          f"(BatchLoader, host-form steps) {res['data_meter']['before_s_p50'] * 1e3:.2f} ms, after ({loader}, "
          f"prefetch, fused dispatch) {res['data_meter']['after_s_p50'] * 1e3:.2f} ms; the before run's step p50 "
          f"{res['data_meter']['before_step_ms_p50']:.2f} ms; phase {seconds:.1f} s", flush=True)
    for name in ("bsrnet_before", "bsrnet_eager", "bsrnet_graph", "bsrnet_stale", "bsrgan_eager", "bsrgan_graph"):
        res[name].pop("stdout")
    return res


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    if sys.argv[1:2] == ["--dispatch-worker"]:
        dispatch_worker(sys.argv[2])
        return
    if sys.argv[1:] == ["--dispatch-only"]:  # the dispatch phase alone, without the contract's lines
        sys.path.insert(0, ROOT)
        from srganfd_tpu_torch.ops.cuda import build

        build.build_all()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
        base = os.path.join(ROOT, "build")
        os.makedirs(base, exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dispatch_", dir=base) as work:
            res = dispatch_phase(work, smi)
        print(json.dumps({"dispatch": res}))
        return
    if sys.argv[1:] == ["--parallel-only"]:  # the parallel phases alone, without the contract's lines
        sys.path.insert(0, ROOT)
        from srganfd_tpu_torch.ops.cuda import build

        build.build_all()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
        base = os.path.join(ROOT, "build")
        os.makedirs(base, exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_par_", dir=base) as work:
            res = parallel_phases(work, spread_weights(work), smi)
        print(json.dumps({"parallel": res}))
        return
    sys.path.insert(0, ROOT)
    from srganfd_tpu_torch.models import blocks
    from srganfd_tpu_torch.ops import filters
    from srganfd_tpu_torch.ops.cuda import attention as attn
    from srganfd_tpu_torch.ops.cuda import build, rdb
    from srganfd_tpu_torch.ops.cuda import filter2d as f2d
    from srganfd_tpu_torch.ops.cuda import qconv as qc

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
    grad = rdb_grad_phase(rdb)
    qconv_entry = qconv_kernel_phase(qc, rdb)
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
        es_launches, es = es_train_phase(work, rdb, f2d, blocks, filters)
        sa_launches, sa = sa_train_phase(work, rdb, f2d, blocks, filters)
        ev_launches, ev = eval_phase(work, rdb, f2d, blocks, filters)
        http_launches, http = http_serve_phase(work, rdb, blocks)
        gen_launches, gen = gen_phase(work, rdb, blocks)
        opt_launches, opt = options_phase(work, rdb, f2d)
        pre = preempt_phase(work)
        guard = guard_phase(work, rdb, f2d)
        accum = accum_phase(work, rdb)
        nans = debug_nans_phase(rdb, f2d, attn)
        flash_bwd = flash_backward_phase(attn)
        flash_train = flash_train_phase(work, rdb, attn, blocks)
        deg_launches, deg = degradations_phase(work, f2d, filters)
        quant_launches, quant_serve = quant_serve_phase(work, qc, rdb, blocks)
        paired_launches, paired, paired_ckpt = paired_train_phase(work, rdb)
        export_launches, exported = export_phase(work, rdb)
        graft_launches, grafts = graft_sources_phase(work, paired_ckpt, rdb)
        disp = dispatch_phase(work, smi)
        par = parallel_phases(work, weights, smi)
    launches += (trans_launches["rdb"] + trans_infer["rdb"] + train_launches["rdb"] + gan_launches["rdb"]
                 + re_launches + ren_launches["rdb"] + reg_launches["rdb"] + ae_launches["rdb"] + es_launches["rdb"]
                 + sa_launches["rdb"] + ev_launches["rdb"] + http_launches + gen_launches + opt_launches["rdb"]
                 + guard["rdb_launches"] + accum["rdb_launches"] + nans["rdb_launches"]
                 + flash_train["flash"]["rdb_launches"] + flash_train["chunked"]["rdb_launches"]
                 + paired_launches + export_launches + graft_launches + par["rdb_launches"])
    bwd_launches = (train_launches["rdb_bwd"] + gan_launches["rdb_bwd"] + ren_launches["rdb_bwd"]
                    + reg_launches["rdb_bwd"] + ae_launches["rdb_bwd"] + es_launches["rdb_bwd"]
                    + sa_launches["rdb_bwd"] + opt_launches["rdb_bwd"])
    check(bwd_launches > 0, "the training paths launched no rdb backward kernel")
    bwd_entry = {
        "name": "rdb_backward",
        "route": "cuda",
        "design": "dgrad: the forward's implicit GEMM transposed (dy built in the prologue from D and feat, "
                  "B by ldmatrix.trans from the forward's packed bf16 layout; 3xTF32 with 32-bit B loads in f32), "
                  "adding into one f32 D; wgrad: all five convs in one launch over pixel slices, "
                  "ldmatrix.trans for both operands, f32 partials summed in a fixed order",
        "source": "srganfd_tpu_torch/csrc/rdb_bwd.cu",
        "replaces": "srganfd_tpu/ops/pallas/rdb.py:163",
        "launches": bwd_launches,
        "max_abs_err": grad["bwd_max_abs_err_bf16"],  # gradients reach ~300 at this shape: held relative, 1e-2
        "ms": grad["bwd_ms_bf16"],
        "plain_ms": grad["bwd_plain_ms_bf16"],
        "bound_ms": grad["bwd_bound_ms_bf16"],
        "bound_by": grad["bwd_bound_by_bf16"],
        "library_ms": grad["bwd_library_ms_bf16"]["bf16"],
        "library": "autograd through the five cuDNN F.conv2d of the block (backward only)",
        "share_of_bound": grad["bwd_bound_ms_bf16"] / grad["bwd_ms_bf16"],
        "ms_f32": grad["bwd_ms_f32"],
        "plain_f32_ms": grad["bwd_plain_ms_f32"],
        "bound_f32_tf32_ms": grad["bwd_bound_ms_f32"],
        "library_f32_ms": grad["bwd_library_ms_f32"],
        "shape": list(TRAIN_RDB_SHAPE),
        "dtype": "bfloat16",
        **grad,
    }
    check(quant_launches > 0, "the --quant-int8 serving path launched no qconv kernel")
    check(paired_launches > 0 and export_launches > 0, "the paired or exported path launched no rdb_forward kernel")
    qconv_entry["launches"] = quant_launches
    qconv_entry["launches_per_forward"] = QCONV_PER_FORWARD
    entry["paired_launches"] = paired_launches
    entry["parallel_launches"] = par["rdb_launches"]
    filter_entry["parallel_launches"] = par["filter2d_launches"]
    check(par["rdb_launches"] > 0 and par["filter2d_launches"] > 0, "the parallel phases launched no kernel")
    entry["export_launches"] = export_launches
    # the dispatch phase's graphs (in its worker process): each replay makes these launches
    entry["dispatch_launches_per_replay"] = {n: next(iter(disp[n]["launches_per_replay"].values()))["rdb"]
                                             for n in ("bsrnet", "bsrgan")}
    filter_entry["dispatch_launches_per_replay"] = {
        n: next(iter(disp[n]["launches_per_replay"].values()))["filter2d"] for n in ("bsrnet", "bsrgan")}
    check(http_launches > 0 and gen_launches > 0, "the HTTP or gen_rrdb2x path launched no rdb_forward kernel")
    flash_launches = trans_launches["flash"] + trans_infer["flash"] + flash_train["flash"]["flash_launches"]
    check(launches > 0, "the main paths launched no rdb_forward kernel")
    check(flash_launches > 0, "the bsrgantrans_x2 path launched no flash_attention kernel")
    entry["launches"] = launches
    # of which f32 (the 3xTF32 kernels): the f32 stdio requests and every cli.test forward
    entry["launches_f32"] = (f32_launches + trans_f32["rdb"] + re_f32_launches + ev_launches["rdb"]
                             + http["f32_launches"] + gen["f32_launches"])
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
    entry["esrgan_recipe_launches"] = es_launches["rdb"]
    entry["sa_launches"] = sa_launches["rdb"]
    entry["eval_launches"] = ev_launches["rdb"]
    entry["http_launches"] = http_launches
    entry["gen_rrdb2x_launches"] = gen_launches
    check(sa_launches["rdb"] > 0 and sa_launches["filter2d"] > 0, "the SA training path launched no kernel")
    check(ev_launches["rdb"] > 0 and ev_launches["filter2d"] > 0, "the cli.test path launched no kernel")
    check(es_launches["rdb"] > 0, "the ESRGAN training path launched no rdb_forward kernel")
    check(ren_launches["filter2d"] > 0 and reg_launches["filter2d"] > 0,
          "a Real-ESRGAN training path launched no filter2d kernel")
    check(ae_launches["rdb"] > 0 and ae_launches["filter2d"] > 0, "the aesrgan training path launched no kernel")
    check(opt_launches["filter2d"] > 0 and deg_launches > 0, "the options or degradation CLI path launched no filter2d")
    filter_entry["launches"] = (train_launches["filter2d"] + gan_launches["filter2d"] + ren_launches["filter2d"]
                                + reg_launches["filter2d"] + ae_launches["filter2d"] + sa_launches["filter2d"]
                                + ev_launches["filter2d"] + opt_launches["filter2d"] + deg_launches
                                + par["filter2d_launches"])
    filter_entry["options_launches"] = opt_launches["filter2d"]
    filter_entry["test_degradations_launches"] = deg_launches
    entry["options_launches"] = opt_launches["rdb"]
    flash_entry["train_launches"] = flash_train["flash"]["flash_launches"]
    flash_entry["backward"] = flash_bwd
    filter_entry["sa_launches"] = sa_launches["filter2d"]
    filter_entry["eval_launches"] = ev_launches["filter2d"]
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
    for name in ("rrdbnet", "esrgan"):
        r = es[name]
        parts = (f", the D update {r['d_update_ms']:.2f} ms, content {r['content_forward_backward_ms']:.2f} ms, "
                 f"adversarial {r['adversarial_forward_backward_ms']:.2f} ms" if name == "esrgan" else "")
        print(f"{name} step (bf16, batch 16, GT {192 if name == 'rrdbnet' else 128}): {r['train_step_ms']:.2f} ms on "
              f"the card, of which G forward+backward {r['g_forward_backward_ms']:.2f} ms (69 RDB kernels at "
              f"{ES_RDB_SHAPES[name]} alone {RDB_PER_FORWARD * entry[f'{name}_train_kernel_ms']:.2f} ms){parts}; "
              f"bicubic LR {r['chain_ms']:.2f} ms; host-clock step p50 {r['step_ms_p50']:.2f} ms; peak memory "
              f"{r['peak_memory_gb']:.2f} GB; {r['rdb_launches']} rdb launches", flush=True)
    print(f"bsrgan --d-arch discriminator_unet_sa step (bf16, batch 16, GT 144): {sa['train_step_ms']:.2f} ms on the "
          f"card, the D update {sa['d_update_ms']:.2f} ms, adversarial {sa['adversarial_forward_backward_ms']:.2f} ms, "
          f"attentions {sa['attn_down2_ms']:.2f} / {sa['attn_down3_ms']:.2f} / {sa['attn_up1_ms']:.2f} ms; host-clock "
          f"step p50 {sa['step_ms_p50']:.2f} ms; peak memory {sa['peak_memory_gb']:.2f} GB; {sa_launches} kernel calls",
          flush=True)
    print(f"cli.serve --port (bsrgan_x2 256x256, --batch auto): burst of {HTTP_BURST} in "
          f"{ {t: round(http[t]['burst_s'], 3) for t in ('f32', 'bf16')} } s over "
          f"{ {t: http[t]['burst_forwards'] for t in ('f32', 'bf16')} } forwards; sparse p50/p95 ms "
          f"{ {t: (round(http[t]['sparse_ms_p50'], 2), round(http[t]['sparse_ms_p95'], 2)) for t in ('f32', 'bf16')} }; "
          f"{http_launches} rdb_forward calls", flush=True)
    print(f"gen_rrdb2x/gen_rpa2x 256x256 forward ms "
          f"{ {k: round(v['forward_ms'], 2) for k, v in gen.items() if isinstance(v, dict) and 'forward_ms' in v} }; "
          f"{gen_launches} "
          f"rdb_forward calls", flush=True)
    print(f"cli.test on the card: {ev_launches} kernel calls; frames/s "
          f"{ {tag: round(r['frames_per_s'], 3) for tag, r in ev.items()} }", flush=True)
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
    print(json.dumps({"esrgan_recipe": es}))
    print(json.dumps({"sa": sa}))
    print(json.dumps({"eval": ev}))
    print(json.dumps({"http": http}))
    print(json.dumps({"gen": gen}))
    print(json.dumps({"options": opt, "preempt": pre, "guard": guard, "accum": accum, "debug_nans": nans,
                      "flash_train": flash_train, "test_degradations": deg}))
    print(json.dumps({"quant_serve": quant_serve, "paired": paired, "export": exported, "graft_sources": grafts}))
    print(json.dumps({"dispatch": disp}))
    print(json.dumps({"parallel": par}))
    # rdb_forward_pallas_v2 (whole images per grid cell) computes row 1's
    # function: the port runs both through the one kernel, whose numbers these are
    entry_v2 = {**entry, "name": "rdb_forward (rdb_forward_pallas_v2)", "replaces": "srganfd_tpu/ops/pallas/rdb.py:255",
                "same_kernel_as": "rdb_forward"}
    print(smi)
    print(json.dumps({"kernels": [entry, entry_v2, bwd_entry, flash_entry, filter_entry, qconv_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
