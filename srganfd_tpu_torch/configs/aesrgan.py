"""A-ESRGAN x2: the transformer-bottleneck generator against the
attention-gated U-Net discriminator (the port's copy of
``srganfd_tpu/configs/aesrgan.py``).

Reference surface: ``A-ESRGAN/aesrgan_config.py`` (crop 150 -> gt 120,
batch 8, pixel [10.0] / content [1.0] multi-node / adversarial [0.1],
Adam g 5e-5 / d 1e-5 betas (0.9, 0.999) eps 1e-4, EMA 0.999, milestones
(0.15, 0.3, 0.6)); loop ``A-ESRGAN/train_aesrgan.py`` (D step first,
BSRGAN degradation chain)."""

from srganfd_tpu_torch.configs.base import ExperimentConfig
from srganfd_tpu_torch.configs.bsrgan import degradation_process_parameters_dict

d_model_arch_name = "uNetDiscriminatorAesrgan"
g_model_arch_name = "bsrgantrans_x2"
upscale_factor = 2
mode = "train"
exp_name = "AESRGAN_x2"
optimizing_metric = "LPIPS"


def get_config() -> ExperimentConfig:
    return ExperimentConfig(
        name="aesrgan",
        mode=mode,
        exp_name=exp_name,
        g_arch=g_model_arch_name,
        d_arch=d_model_arch_name,
        upscale_factor=upscale_factor,
        crop_image_size=150,
        gt_image_size=60 * upscale_factor,
        batch_size=8,
        degradation="bsrgan",
        degradation_params=dict(degradation_process_parameters_dict),
        pixel_weight=(10.0,),
        content_weight=(1.0,),
        adversarial_weight=(0.1,),
        feature_nodes=(
            "features.2",
            "features.7",
            "features.16",
            "features.25",
            "features.34",
        ),
        relativistic_gan=False,
        g_step_first=False,
        epochs=100,
        model_lr=5e-5,
        discriminator_lr=1e-5,
        model_betas=(0.9, 0.999),
        model_eps=1e-4,
        model_ema_decay=0.999,
        lr_scheduler_milestones=(0.15, 0.3, 0.6),
        lr_scheduler_gamma=0.5,
        optimizing_metric=optimizing_metric,
    )
