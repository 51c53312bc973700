"""Normalization-constant derivation (reference AColorNormalization parity:
test/analysis/color_normalization.py:25-52).

Sweeps the full 256^3 sRGB lattice through each color space on the device,
in 65,536-pixel slabs (one per blue value, 16 a call), and prints/returns
(midpoint, scale) per channel: midpoint = (min + max) / 2, scale = 127 / max_abs_deviation.
The shipped constants in color/constants.py were derived this way.

Run: python -m aejpeg_tpu_torch.harness.normalization [--device D]
"""

import argparse
from typing import Dict, Tuple

import numpy as np
import torch

from .. import color, resolve_device


_PLANES_PER_CALL = 16


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
        # 16 blue planes a call: the conversions are eager op sequences
        # (thousands of launches a call in the PQ spaces on the card)
        for b0 in range(0, 256, _PLANES_PER_CALL):
            nb = blues[b0:b0 + _PLANES_PER_CALL]
            rgb = torch.cat([base.repeat(nb.shape[0], 1),
                             nb.repeat_interleave(base.shape[0])[:, None]],
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
