"""Per-image metric sweep (reference AMetricsComputation parity:
test/analysis/metrics_computation.py), the cross-check of the batched
sweep.

Sweeps (color_space x quality_range x block_size_range) over an image set
through the per-image Codec, producing the same CSV schema:
image_name,color_space,min_quality,max_quality,min_block_size,
max_block_size,psnr,ssim,ms_ssim,lpips,compression_ratio  (4-decimal
strings).  LPIPS is optional (requires exported weights); absent values are
written as ''.  The CSV is written with the csv module.
"""

import csv
import time
from concurrent.futures import ThreadPoolExecutor
from itertools import product
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from .. import resolve_device
from ..codec.pipeline import Codec
from ..config import CodecConfig
from ..io.image import ImageData
from ..metrics import EvaluationMetrics
from .sweep_batched import (BatchedMetricsSweep, default_block_ranges,
                            default_quality_ranges)


class MetricsSweep:
    """device: None means CUDA (raises when CUDA is absent); pass "cpu" for
    the plain PyTorch path."""

    def __init__(self, img_files: Sequence, result_file,
                 color_spaces: Sequence[str] = ("YCbCr",),
                 quality_ranges: Optional[List[Tuple[int, int]]] = None,
                 block_size_ranges: Optional[List[Tuple[int, int]]] = None,
                 with_lpips: bool = False,
                 lpips_weights: Optional[str] = None,
                 entropy_level: int = 9,
                 n_io_workers: int = 2,
                 device=None):
        self.device = resolve_device(device)
        self.img_files = [Path(p) for p in img_files]
        self.result_file = Path(result_file)
        self.color_spaces = list(color_spaces)
        self.quality_ranges = quality_ranges or default_quality_ranges()
        self.block_size_ranges = block_size_ranges or default_block_ranges()
        self.with_lpips = with_lpips
        self.lpips_weights = lpips_weights
        self.entropy_level = entropy_level
        self.n_io_workers = n_io_workers
        self.errors: List[str] = []

    def _combo_row(self, img: ImageData, img_path: Path, combo) -> dict:
        space, qr, br = combo
        codec = Codec(CodecConfig(space, qr, br,
                                  entropy_level=self.entropy_level),
                      device=self.device)
        blob = codec.compress(img)
        out = Codec(device=self.device).decompress(blob)
        ratio = img.raw_rgb_bytes / len(blob)
        ev = EvaluationMetrics(img, out, lpips_weights=self.lpips_weights,
                               device=self.device)
        return {
            "image_name": str(img_path),
            "color_space": space,
            "min_quality": qr[0],
            "max_quality": qr[1],
            "min_block_size": br[0],
            "max_block_size": br[1],
            "psnr": f"{ev.psnr():.4f}",
            "ssim": f"{ev.ssim():.4f}",
            "ms_ssim": f"{ev.ms_ssim():.4f}",
            "lpips": f"{ev.lpips():.4f}" if self.with_lpips else "",
            "compression_ratio": f"{ratio:.4f}",
        }

    def run(self) -> List[dict]:
        combos = list(product(self.color_spaces, self.quality_ranges,
                              self.block_size_ranges))
        total = len(self.img_files) * len(combos)
        rows = []
        done = 0
        t0 = time.perf_counter()

        with ThreadPoolExecutor(self.n_io_workers) as pool:
            loads = {p: pool.submit(ImageData.load, str(p))
                     for p in self.img_files}
            for p in self.img_files:
                try:
                    img = loads[p].result()
                except Exception as e:  # noqa: BLE001 - per-image isolation
                    self.errors.append(f"Error loading {p.name}: {e}")
                    done += len(combos)
                    continue
                for combo in combos:
                    try:
                        rows.append(self._combo_row(img, p, combo))
                    except Exception as e:  # noqa: BLE001
                        self.errors.append(
                            f"Error processing {p.name} with {combo}: {e}")
                    done += 1
                    if done % 10 == 0 or done == total:
                        dt = time.perf_counter() - t0
                        eta = dt / done * (total - done)
                        print(f"[sweep] {done}/{total} "
                              f"({dt:.0f}s, ETA {eta:.0f}s)", flush=True)

        self.result_file.parent.mkdir(parents=True, exist_ok=True)
        with open(self.result_file, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=BatchedMetricsSweep.COLUMNS,
                                    lineterminator="\n")
            writer.writeheader()
            writer.writerows(rows)
        print(f"Results saved to {self.result_file}")
        if self.errors:
            print(f"{len(self.errors)} errors; first: {self.errors[0]}")
        return rows
