"""Quality metrics (PSNR)."""

from .quality import psnr

__all__ = ["psnr"]
