"""Evaluation: PSNR / SSIM / LPIPS scores, FID and the comparison CLI
(``python -m animatablegaussians_torch.eval.comparison``)."""

from .score import (Metrics, compute_psnr, compute_ssim, compute_lpips,
                    crop_image)

__all__ = ["Metrics", "compute_psnr", "compute_ssim", "compute_lpips",
           "crop_image"]
