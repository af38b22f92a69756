"""BSRNet x2: generator-only (PSNR-oriented) pretrain for BSRGAN, the first
stage of the reference's workflow (``BSRGAN/bsrnet_config.py``,
``BSRGAN/train_bsrnet.py``). The port's copy of
``srganfd_tpu/configs/bsrnet.py``."""

from srganfd_tpu_torch.configs.base import ExperimentConfig
from srganfd_tpu_torch.configs.bsrgan import degradation_process_parameters_dict

g_model_arch_name = "bsrgan_x2"
upscale_factor = 2
mode = "train"
exp_name = "BSRNet_x2"


def get_config() -> ExperimentConfig:
    return ExperimentConfig(
        name="bsrnet",
        mode=mode,
        exp_name=exp_name,
        g_arch=g_model_arch_name,
        d_arch=None,
        upscale_factor=upscale_factor,
        crop_image_size=320,
        gt_image_size=72 * upscale_factor,
        batch_size=16,
        degradation="bsrgan",
        degradation_params=dict(degradation_process_parameters_dict),
        pixel_weight=(1.0,),
        epochs=60,
        model_lr=1e-4,
        model_betas=(0.9, 0.999),
        model_eps=1e-4,
        model_ema_decay=0.999,
        lr_scheduler_milestones=(0.5, 0.7),
        lr_scheduler_gamma=0.5,
        optimizing_metric="PSNR",
    )
