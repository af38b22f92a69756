"""The BSRGAN family's degradation parameters (``BSRGAN/bsrgan_config.py``):
the fork disables ops 2/3/4, so the chain is blur (two slots) + JPEG
(p = 0.9) + final JPEG + final MATLAB bicubic (``BSRGAN/imgproc.py:492-562``).

Only the dict is ported: the ``bsrgan`` GAN config itself (U-Net
discriminator, VGG19 content loss, BCE, LPIPS selection) comes with the GAN
slice (ROADMAP.md A4).
"""

degradation_process_parameters_dict = {
    "jpeg_prob": 0.9,
    "scale2_prob": 0.25,
    "shuffle_prob": 0.1,
    "use_sharp": False,
}
