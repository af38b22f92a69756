"""RRDBNet x4 L1-only pretrain, the PSNR-oriented first stage of ESRGAN
(the port's copy of ``srganfd_tpu/configs/rrdbnet.py``).

Reference surface: ``ESRGAN/rrdbnet_config.py`` (gt 192-px crops, batch 16,
Adam 2e-4 betas (0.9, 0.99), EMA 0.99998, MultiStepLR gamma 0.5, MATLAB
bicubic LR generation); training loop ``ESRGAN/train_rrdbnet.py``.
"""

from srganfd_tpu_torch.configs.base import ExperimentConfig

g_arch_name = "rrdbnet_x4"
upscale_factor = 4
mode = "train"
exp_name = "train_RRDBNet_x4"
only_test_y_channel = True


def get_config() -> ExperimentConfig:
    return ExperimentConfig(
        name="rrdbnet",
        mode=mode,
        exp_name=exp_name,
        g_arch=g_arch_name,
        d_arch=None,
        upscale_factor=upscale_factor,
        gt_image_size=192,
        batch_size=16,
        degradation="bicubic",
        pixel_weight=(1.0,),
        content_weight=(),
        adversarial_weight=(),
        epochs=234,
        model_lr=2e-4,
        model_betas=(0.9, 0.99),
        model_eps=1e-8,
        model_ema_decay=0.99998,
        lr_scheduler_milestones=(0.125, 0.25, 0.5, 0.75),
        lr_scheduler_gamma=0.5,
        optimizing_metric="PSNR",
        only_test_y_channel=only_test_y_channel,
    )
