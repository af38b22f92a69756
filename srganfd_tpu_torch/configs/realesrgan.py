"""Real-ESRGAN x4: second-order degradation + U-Net SN discriminator (the
port's copy of ``srganfd_tpu/configs/realesrgan.py``).

Reference surface: ``Real_ESRGAN/realesrgan_config.py`` (gt 256, batch 48,
pixel [1.0] / content [0.1,0.1,1,1,1] multi-node / adversarial [0.1],
Adam 1e-4 eps 1e-4, EMA 0.999); loop ``Real_ESRGAN/train_realesrgan.py``
(G step first; losses vs the USM-sharpened GT)."""

from srganfd_tpu_torch.configs.base import ExperimentConfig

degradation_model_parameters_dict = {
    "sinc_kernel_size": 21,
    "gaussian_kernel_range": (7, 9, 11, 13, 15, 17, 19, 21),
    "gaussian_kernel_type": (
        "isotropic",
        "anisotropic",
        "generalized_isotropic",
        "generalized_anisotropic",
        "plateau_isotropic",
        "plateau_anisotropic",
    ),
    "gaussian_kernel_probability1": (0.45, 0.25, 0.12, 0.03, 0.12, 0.03),
    "sinc_kernel_probability1": 0.1,
    "gaussian_sigma_range1": (0.2, 3.0),
    "generalized_kernel_beta_range1": (0.5, 4.0),
    "plateau_kernel_beta_range1": (1.0, 2.0),
    "gaussian_kernel_probability2": (0.45, 0.25, 0.12, 0.03, 0.12, 0.03),
    "sinc_kernel_probability2": 0.1,
    "gaussian_sigma_range2": (0.2, 1.5),
    "generalized_kernel_beta_range2": (0.5, 4.0),
    "plateau_kernel_beta_range2": (1.0, 2.0),
    "sinc_kernel_probability3": 0.8,
}

degradation_process_parameters_dict = {
    "first_blur_probability": 1.0,
    "resize_probability1": (0.2, 0.7, 0.1),
    "resize_range1": (0.15, 1.5),
    "gray_noise_probability1": 0.4,
    "gaussian_noise_probability1": 0.5,
    "noise_range1": (1, 30),
    "poisson_scale_range1": (0.05, 3.0),
    "jpeg_range1": (30, 95),
    "second_blur_probability": 0.8,
    "resize_probability2": (0.3, 0.4, 0.3),
    "resize_range2": (0.3, 1.2),
    "gray_noise_probability2": 0.4,
    "gaussian_noise_probability2": 0.5,
    "noise_range2": (1, 25),
    "poisson_scale_range2": (0.05, 2.5),
    "jpeg_range2": (30, 95),
}

d_model_arch_name = "discriminator_unet"
g_model_arch_name = "realesrgan_x4"
upscale_factor = 4
mode = "train"
exp_name = "RealESRGAN_x4"


def get_config() -> ExperimentConfig:
    return ExperimentConfig(
        name="realesrgan",
        mode=mode,
        exp_name=exp_name,
        g_arch=g_model_arch_name,
        d_arch=d_model_arch_name,
        upscale_factor=upscale_factor,
        gt_image_size=256,
        batch_size=48,
        degradation="realesrgan",
        degradation_params={
            "model": dict(degradation_model_parameters_dict),
            "process": dict(degradation_process_parameters_dict),
        },
        pixel_weight=(1.0,),
        content_weight=(0.1, 0.1, 1.0, 1.0, 1.0),
        adversarial_weight=(0.1,),
        feature_nodes=(
            "features.2",
            "features.7",
            "features.16",
            "features.25",
            "features.34",
        ),
        relativistic_gan=False,
        g_step_first=True,
        epochs=15,
        model_lr=1e-4,
        model_betas=(0.9, 0.99),
        model_eps=1e-4,
        model_ema_decay=0.999,
        lr_scheduler_milestones=(0.125, 0.25, 0.5, 0.75),
        lr_scheduler_gamma=0.5,
        optimizing_metric="LPIPS",
    )
