"""Frozen experiment configuration (the port's own copy of
``srganfd_tpu/configs/base.py`` ``ExperimentConfig``).

Field names and defaults are the JAX package's, so a reader finds each
field's counterpart; the fields of parts not ported yet (meshes, gradient
accumulation, guards) are kept and rejected by the trainer when set.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    # identity
    name: str = "experiment"
    mode: str = "train"  # "train" | "test"
    seed: int = 0
    exp_name: str = ""

    # model
    g_arch: str = "rrdbnet_x4"
    d_arch: str | None = None
    upscale_factor: int = 4
    g_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    d_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    # "bfloat16" (f32 params, bf16 compute) | "float32" | "float64" (CPU lockstep tests only)
    compute_dtype: str = "bfloat16"

    # data
    train_gt_images_dir: str = "data/train"
    valid_gt_images_dir: str = "data/valid"
    train_lr_images_dir: str = ""
    valid_lr_images_dir: str = ""
    test_gt_images_dir: str = ""
    test_lr_images_dir: str = ""
    crop_image_size: int = 0  # BSRGAN host-side pre-crop (0 = disabled)
    gt_image_size: int = 128
    batch_size: int = 16
    num_workers: int = 2

    # degradation pipeline feeding LR from GT
    degradation: str = "bicubic"  # "bicubic" | "bsrgan" | "realesrgan" | "paired"
    degradation_params: dict[str, Any] = dataclasses.field(default_factory=dict)

    # losses
    pixel_weight: tuple[float, ...] = (1.0,)
    content_weight: tuple[float, ...] = ()
    adversarial_weight: tuple[float, ...] = ()
    feature_nodes: tuple[str, ...] = ("features.34",)
    feature_normalize_mean: tuple[float, ...] = (0.485, 0.456, 0.406)
    feature_normalize_std: tuple[float, ...] = (0.229, 0.224, 0.225)
    relativistic_gan: bool = False
    g_step_first: bool = True
    content_detach_bug: bool = False
    fuse_d_forwards: bool = False

    # optimizer / schedule
    epochs: int = 1
    steps_per_epoch: int = 0  # 0 = derive from the dataset
    model_lr: float = 1e-4
    discriminator_lr: float | None = None
    model_betas: tuple[float, float] = (0.9, 0.99)
    model_eps: float = 1e-8
    model_weight_decay: float = 0.0
    model_ema_decay: float = 0.999
    # the reference's literal AveragedModel EMA: inverted lerp
    # ((1-decay)*avg + decay*p, ESRGAN/train_esrgan.py:249) and a copy on the
    # first update; off = the conventional EMA
    ema_reference_semantics: bool = False
    lr_scheduler_milestones: tuple[float, ...] = (0.125, 0.25, 0.5, 0.75)  # epoch fractions
    lr_scheduler_gamma: float = 0.5

    # evaluation / selection
    only_test_y_channel: bool = True
    optimizing_metric: str = "PSNR"  # "PSNR" | "LPIPS" | "Discriminator SR Prob"
    niqe_model_path: str = ""
    lpips_net: str = "alex"

    # checkpoints / tracking
    results_dir: str = "results"
    samples_dir: str = "samples"
    pretrained_g_model_weights_path: str = ""
    pretrained_d_model_weights_path: str = ""
    resume_g_model_weights_path: str = ""
    resume_d_model_weights_path: str = ""
    experience_name: str = ""
    run_name: str = ""
    run_id: str = ""
    tags: str = ""
    description: str = ""
    train_print_frequency: int = 100
    valid_print_frequency: int = 100

    # parallelism
    mesh_shape: tuple[int, ...] = (-1,)
    mesh_axes: tuple[str, ...] = ("data",)
    pipeline_microbatches: int = 0
    dcn_mesh_shape: tuple[int, ...] | None = None

    # training guards beyond the reference
    grad_clip_norm: float = 0.0
    skip_nonfinite_updates: bool = False
    grad_accum_steps: int = 1

    def replace(self, **kw: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    @property
    def milestones_epochs(self) -> tuple[int, ...]:
        return tuple(int(self.epochs * f) for f in self.lr_scheduler_milestones)

    @property
    def is_gan(self) -> bool:
        return self.d_arch is not None and len(self.adversarial_weight) > 0
