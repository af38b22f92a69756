"""Image-quality metrics of the port."""

from srganfd_tpu_torch.metrics.psnr_ssim import psnr_tensor, ssim_tensor  # noqa: F401
