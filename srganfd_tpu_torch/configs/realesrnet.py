"""RealESRNet x4: L1-only pretrain over the second-order degradation (the
port's copy of ``srganfd_tpu/configs/realesrnet.py``).

Reference surface: ``Real_ESRGAN/realesrnet_config.py`` (gt 256, batch 48,
Adam 2e-4 eps 1e-4, EMA 0.999, 1000 epochs); loop
``Real_ESRGAN/train_realesrnet.py``."""

from srganfd_tpu_torch.configs.base import ExperimentConfig
from srganfd_tpu_torch.configs.realesrgan import (
    degradation_model_parameters_dict,
    degradation_process_parameters_dict,
)

g_model_arch_name = "rrdbnet_x4"
upscale_factor = 4
mode = "train"
exp_name = "RealESRNet_x4"


def get_config() -> ExperimentConfig:
    return ExperimentConfig(
        name="realesrnet",
        mode=mode,
        exp_name=exp_name,
        g_arch="realesrgan_x4",  # Real-ESRGAN's pixel-unshuffle RRDBNet
        d_arch=None,
        upscale_factor=upscale_factor,
        gt_image_size=256,
        batch_size=48,
        degradation="realesrgan",
        degradation_params={
            "model": dict(degradation_model_parameters_dict),
            "process": dict(degradation_process_parameters_dict),
        },
        pixel_weight=(1.0,),
        epochs=1000,
        model_lr=2e-4,
        model_betas=(0.9, 0.99),
        model_eps=1e-4,
        model_ema_decay=0.999,
        lr_scheduler_milestones=(0.125, 0.25, 0.5, 0.75),
        lr_scheduler_gamma=0.5,
        optimizing_metric="PSNR",
    )
