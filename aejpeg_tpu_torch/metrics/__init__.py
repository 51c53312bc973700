"""Quality metrics: PSNR, SSIM, MS-SSIM, LPIPS."""

from .quality import (EvaluationMetrics, ms_ssim, psnr, rgb_to_gray_u8,
                      ssim)

__all__ = ["psnr", "ssim", "ms_ssim", "rgb_to_gray_u8", "EvaluationMetrics"]
