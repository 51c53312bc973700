"""PSNR (piq.psnr semantics, as the JAX package's metrics/quality.py)."""

import torch


def psnr(x: torch.Tensor, y: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """PSNR over all pixels/channels of one image (H, W, C) or (H, W)."""
    mse = torch.mean((x.to(torch.float32) - y.to(torch.float32)) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))
