"""ESRGAN x4 GAN fine-tune of ``rrdbnet``'s generator: relativistic,
against the VGG-128 discriminator (the port's copy of
``srganfd_tpu/configs/esrgan.py``).

Reference surface: ``ESRGAN/esrgan_config.py`` (gt 128 crops, batch 16,
pixel 0.01 / content 1.0 @features.34 / adversarial 0.005, Adam 1e-4,
EMA 0.99998); loop ``ESRGAN/train_esrgan.py`` (G step first). The
reference starts it from the ``rrdbnet`` stage's generator:
``cli.train --config esrgan --pretrained-g <rrdbnet's ckpt_last.pth>``.
"""

from srganfd_tpu_torch.configs.base import ExperimentConfig

d_arch_name = "discriminator"
g_arch_name = "rrdbnet_x4"
upscale_factor = 4
mode = "train"
exp_name = "train_ESRGAN_x4_bubbles"
experience_name = "ESRGAN_x4_bubbles"


def get_config() -> ExperimentConfig:
    return ExperimentConfig(
        name="esrgan",
        mode=mode,
        exp_name=exp_name,
        experience_name=experience_name,
        g_arch=g_arch_name,
        d_arch=d_arch_name,
        upscale_factor=upscale_factor,
        gt_image_size=128,
        batch_size=16,
        degradation="bicubic",
        pixel_weight=(0.01,),
        content_weight=(1.0,),
        adversarial_weight=(0.005,),
        feature_nodes=("features.34",),
        relativistic_gan=True,
        g_step_first=True,
        epochs=1,
        model_lr=1e-4,
        model_betas=(0.9, 0.99),
        model_eps=1e-8,
        model_ema_decay=0.99998,
        lr_scheduler_milestones=(0.125, 0.25, 0.5, 0.75),
        lr_scheduler_gamma=0.5,
        optimizing_metric="LPIPS",
    )
