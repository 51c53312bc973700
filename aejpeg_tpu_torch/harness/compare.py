"""Comparison vs standard JPEG anchors (reference AMetricsComparison parity:
test/analysis/metrics_comparison.py:26-284).  Host-only pandas code, the
same as the JAX package's harness/compare.py; pandas is imported here and
nowhere else in the package but harness/analyze.py.

Loads sweep CSVs, averages per configuration, computes per-anchor metric
ratios and the composite quality score
(0.10 psnr + 0.20 ssim + 0.35 ms_ssim + 0.35 / lpips_ratio), and selects
configurations that beat the anchors by >5% on compression (at similar or
better quality) or on quality (at similar or better compression).
"""

import os
import time
from pathlib import Path
from typing import List, Optional

import pandas as pd

# Anchor table measured by the reference authors (YCbCr 4:2:0 8x8 fixed
# quality) — test/analysis/metrics_comparison.py:28-34.
STANDARD_JPEG_RESULTS = [
    {"quality": 10, "psnr": 25.6922, "ssim": 0.8877, "ms_ssim": 0.9014,
     "lpips": 0.2956, "compression_ratio": 26.3875},
    {"quality": 25, "psnr": 28.7196, "ssim": 0.9572, "ms_ssim": 0.9569,
     "lpips": 0.1496, "compression_ratio": 15.4089},
    {"quality": 50, "psnr": 30.8579, "ssim": 0.9797, "ms_ssim": 0.9759,
     "lpips": 0.0832, "compression_ratio": 10.4945},
    {"quality": 75, "psnr": 33.1062, "ssim": 0.9901, "ms_ssim": 0.9855,
     "lpips": 0.0435, "compression_ratio": 7.3001},
    {"quality": 90, "psnr": 36.3888, "ssim": 0.9964, "ms_ssim": 0.9925,
     "lpips": 0.0148, "compression_ratio": 4.5639},
]

GROUPING_COLUMNS = ["color_space", "subsampling", "min_quality",
                    "max_quality", "min_block_size", "max_block_size"]
NUMERIC_COLUMNS = ["psnr", "ssim", "ms_ssim", "lpips", "compression_ratio"]
COMPOSITE_WEIGHTS = {"psnr_ratio": 0.10, "ssim_ratio": 0.20,
                     "ms_ssim_ratio": 0.35, "lpips_ratio": 0.35}


def extract_subsampling(filename: str) -> str:
    """'cr_YCbCr_420.csv' -> '4:2:0' (reference filename convention)."""
    parts = os.path.basename(filename).split("_")
    if len(parts) < 3:
        return "unknown"
    sub = parts[2].split(".")[0]
    if sub.isdigit() and len(sub) == 3:
        return f"{sub[0]}:{sub[1]}:{sub[2]}"
    return sub


class MetricsComparison:
    def __init__(self, input_dir=None, file_list: Optional[List[str]] = None,
                 quality_threshold: float = 0.05,
                 compression_threshold: float = 0.05):
        self.input_dir = input_dir
        self.quality_threshold = quality_threshold
        self.compression_threshold = compression_threshold
        if file_list:
            self.files = [os.path.join(input_dir, f) for f in file_list
                          if f.endswith(".csv")]
        else:
            self.files = [os.path.join(input_dir, f)
                          for f in os.listdir(input_dir)
                          if f.endswith(".csv") and not f.endswith(
                              ("_avg.csv", "_better_compression.csv",
                               "_better_quality.csv"))]
        self.better_compression: List[pd.Series] = []
        self.better_quality: List[pd.Series] = []

    def calculate_averages(self, df: pd.DataFrame,
                           filename: str) -> pd.DataFrame:
        base = os.path.splitext(os.path.basename(filename))[0]
        out = Path(self.input_dir) / f"{base}_avg.csv"
        avg = df.groupby(GROUPING_COLUMNS)[NUMERIC_COLUMNS].mean(
        ).reset_index()
        for c in NUMERIC_COLUMNS:
            avg[c] = avg[c].round(4)
        avg.to_csv(out, index=False)
        return avg

    def composite_score(self, row) -> float:
        """Reference weights .10/.20/.35/.35-inverted
        (reference test/analysis/metrics_comparison.py:54-59,136-144).
        When the sweep ran without LPIPS weights (lpips_ratio NaN),
        renormalize over the remaining metrics instead of poisoning the
        score with NaN."""
        lp = row["lpips_ratio"]
        if lp == lp:  # not NaN
            score = (COMPOSITE_WEIGHTS["psnr_ratio"] * row["psnr_ratio"]
                     + COMPOSITE_WEIGHTS["ssim_ratio"] * row["ssim_ratio"]
                     + COMPOSITE_WEIGHTS["ms_ssim_ratio"]
                     * row["ms_ssim_ratio"]
                     + COMPOSITE_WEIGHTS["lpips_ratio"] / max(lp, 1e-9))
        else:
            wsum = (COMPOSITE_WEIGHTS["psnr_ratio"]
                    + COMPOSITE_WEIGHTS["ssim_ratio"]
                    + COMPOSITE_WEIGHTS["ms_ssim_ratio"])
            score = (COMPOSITE_WEIGHTS["psnr_ratio"] * row["psnr_ratio"]
                     + COMPOSITE_WEIGHTS["ssim_ratio"] * row["ssim_ratio"]
                     + COMPOSITE_WEIGHTS["ms_ssim_ratio"]
                     * row["ms_ssim_ratio"]) / wsum
        return round(score, 4)

    def find_better_configurations(self, avg: pd.DataFrame):
        qmetrics = [m for m in NUMERIC_COLUMNS if m != "compression_ratio"]
        for std in STANDARD_JPEG_RESULTS:
            for _, row in avg.iterrows():
                cr_ratio = row["compression_ratio"] / std["compression_ratio"]
                comp = {c: row[c] for c in GROUPING_COLUMNS}
                comp["quality_compared_to"] = std["quality"]
                for m in qmetrics:
                    comp[f"{m}_ratio"] = round(row[m] / std[m], 4)
                score = self.composite_score(comp)
                comp["composite_score"] = score
                comp["compression_ratio"] = round(cr_ratio, 4)

                similar_cr = abs(cr_ratio - 1) <= self.compression_threshold
                better_cr = cr_ratio - 1 > self.compression_threshold
                similar_q = abs(score - 1) <= self.quality_threshold
                better_q = score - 1 > self.quality_threshold

                if better_cr and (similar_q or better_q):
                    self.better_compression.append(pd.Series(comp))
                if (similar_cr or better_cr) and better_q:
                    self.better_quality.append(pd.Series(comp))

    def save_consolidated_results(self):
        ts = time.strftime("%Y%m%d-%H%M%S")
        outputs = {}
        for name, rows in (("better_compression", self.better_compression),
                           ("better_quality", self.better_quality)):
            if not rows:
                continue
            df = pd.DataFrame(rows).sort_values(
                ["quality_compared_to", "compression_ratio",
                 "composite_score"], ascending=[False, False, False])
            path = Path(self.input_dir) / f"{ts}_{name}.csv"
            df.to_csv(path, index=False)
            outputs[name] = path
        return outputs

    def run(self):
        for f in self.files:
            df = pd.read_csv(f)
            if "psnr" not in df.columns or "image_name" not in df.columns:
                continue  # not a sweep CSV (e.g. analyze outputs in-dir)
            if "subsampling" not in df.columns:
                df["subsampling"] = extract_subsampling(f)
            if df["lpips"].isna().all():
                # sweeps without LPIPS weights: neutral ratio
                df["lpips"] = float("nan")
            avg = self.calculate_averages(df, f)
            self.find_better_configurations(avg)
        return self.save_consolidated_results()
