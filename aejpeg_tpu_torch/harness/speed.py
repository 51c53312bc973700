"""Compression speed table — the reference's speed harness on the batched
pipelines.

The reference times compress/decompress on lena.png for uniform block
sizes 4/8/16/32 over 3 iterations and prints a table with no assertions
(reference: test/unit_tests/test_compression_speed.py:27-104).  This does
the same against encode_batch / decode_batch, adds the p50 single-image
latency (the interactive-preview metric), and prints Mpix/s.

Run: python -m aejpeg_tpu_torch.harness.speed IMAGE [--iters N] [--device D]
"""

import argparse
import time
from typing import List, Optional

import numpy as np

from .. import resolve_device
from ..codec.batch_decode import decode_batch
from ..codec.batch_encode import encode_batch
from ..config import CodecConfig
from ..io.image import ImageData


def run_speed_table(image_path: str, iters: int = 3,
                    color_space: str = "YCoCg",
                    block_sizes: Optional[List[int]] = None,
                    entropy_level: int = -1, device=None) -> List[dict]:
    """Returns one row per uniform block size:
    {block, compress_s, decompress_s, mpix_s, p50_latency_s, bytes}.
    device: None means CUDA (raises when CUDA is absent)."""
    dev = resolve_device(device)
    img = ImageData.load(image_path)
    h, w = img.original_shape[:2]
    mpix = h * w / 1e6
    rows = []
    for s in block_sizes or [4, 8, 16, 32]:
        cfg = CodecConfig(color_space, (75, 75), (s, s),
                          entropy_level=entropy_level)
        blob = encode_batch([img], cfg, device=dev)[0]      # warm-up
        decode_batch([blob], device=dev)
        enc_t, dec_t, lat = [], [], []
        for _ in range(iters):
            t0 = time.perf_counter()
            blob = encode_batch([img], cfg, device=dev)[0]
            t1 = time.perf_counter()
            decode_batch([blob], device=dev)
            t2 = time.perf_counter()
            enc_t.append(t1 - t0)
            dec_t.append(t2 - t1)
            lat.append(t2 - t0)
        rows.append({
            "block": s,
            "compress_s": float(np.median(enc_t)),
            "decompress_s": float(np.median(dec_t)),
            "mpix_s": mpix / float(np.median(enc_t)),
            "p50_latency_s": float(np.median(lat)),
            "bytes": len(blob),
        })
    return rows


def format_table(rows: List[dict]) -> str:
    lines = [f"{'block':>6} {'compress':>10} {'decompress':>11} "
             f"{'enc Mpix/s':>11} {'p50 e2e':>9} {'bytes':>9}"]
    for r in rows:
        lines.append(f"{r['block']:>6} {r['compress_s']*1e3:>8.1f}ms "
                     f"{r['decompress_s']*1e3:>9.1f}ms {r['mpix_s']:>11.2f} "
                     f"{r['p50_latency_s']*1e3:>7.1f}ms {r['bytes']:>9}")
    return "\n".join(lines)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--color-space", default="YCoCg")
    p.add_argument("--entropy-level", type=int, default=-1)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    print(format_table(run_speed_table(
        args.image, args.iters, args.color_space,
        entropy_level=args.entropy_level, device=args.device)))


if __name__ == "__main__":
    main()
