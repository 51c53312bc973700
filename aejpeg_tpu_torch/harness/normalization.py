"""Normalization-constant derivation (reference AColorNormalization parity:
test/analysis/color_normalization.py:25-52).

Sweeps the full 256^3 sRGB lattice through each color space on the device,
one 65,536-pixel slab per blue value, and prints/returns (midpoint, scale)
per channel: midpoint = (min + max) / 2, scale = 127 / max_abs_deviation.
The shipped constants in color/constants.py were derived this way.

Run: python -m aejpeg_tpu_torch.harness.normalization [--device D]
"""

import argparse
from typing import Dict, Tuple

import numpy as np
import torch

from .. import color, resolve_device


def derive_constants(spaces=None, device=None
                     ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """device: None means CUDA (raises when CUDA is absent)."""
    dev = resolve_device(device)
    spaces = spaces or color.get_color_spaces()
    v = np.arange(256, dtype=np.float32) / 255.0
    rr, gg = np.meshgrid(v, v, indexing="ij")
    base = torch.as_tensor(np.stack([rr.ravel(), gg.ravel()], axis=-1),
                           device=dev)                       # (65536, 2)
    blues = torch.as_tensor(v, device=dev)
    out = {}
    for space in spaces:
        fn = color.REGISTRY[space].from_srgb
        mins = torch.full((3,), float("inf"), device=dev)
        maxs = torch.full((3,), float("-inf"), device=dev)
        for bi in range(256):
            rgb = torch.cat([base, blues[bi].expand(base.shape[0], 1)],
                            dim=-1)
            x = fn(rgb)
            mins = torch.minimum(mins, x.amin(dim=0))
            maxs = torch.maximum(maxs, x.amax(dim=0))
        mins, maxs = mins.cpu().numpy(), maxs.cpu().numpy()
        mid = (mins + maxs) / 2
        max_abs = np.maximum(np.abs(mins - mid), np.abs(maxs - mid))
        out[space] = (mid, 127.0 / max_abs)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    for space, (mid, scale) in derive_constants(device=args.device).items():
        print(space)
        for c in range(3):
            print(f"  ({mid[c]!r}, {scale[c]!r})")


if __name__ == "__main__":
    main()
