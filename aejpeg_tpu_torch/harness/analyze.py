"""Aggregation + plots over comparison outputs (reference AMetricsAnalysis
parity: test/analysis/metrics_analysis.py).

Answers the same two questions with the same data: which subsampling wins
per color space (median/mean compression ratio and composite score), and
which (quality, block-size) settings dominate, with heatmap figures.
Host-only pandas code, the same as the JAX package's harness/analyze.py.
"""

import os
from typing import Dict

import numpy as np
import pandas as pd

# Subsampling actually used per space (reference
# test/analysis/metrics_analysis.py:29-37).
DEFINED_SUBSAMPLING = {
    "ICaCb": "4:1:1",
    "ICtCp": "4:1:1",
    "JzAzBz": "4:2:0",
    "OKLAB": "4:2:0",
    "YCbCr": "4:2:0",
    "YCoCg": "4:2:0",
    "YCoCg-R": "4:2:0",
}


class MetricsAnalysis:
    def __init__(self, results_dir: str, figures_dir: str,
                 compression_file: str, quality_file: str):
        self.results_dir = results_dir
        self.figures_dir = figures_dir
        self.df_compression = pd.read_csv(
            os.path.join(results_dir, compression_file))
        self.df_quality = pd.read_csv(os.path.join(results_dir,
                                                   quality_file))
        os.makedirs(figures_dir, exist_ok=True)

    # ------------------------------------------------------------ analyses
    def subsampling_analysis(self, visualize: bool = False) -> pd.DataFrame:
        """Best subsampling per color space by median/mean compression ratio
        and composite score."""
        rows = []
        for space in sorted(set(self.df_compression["color_space"])):
            dc = self.df_compression[
                self.df_compression["color_space"] == space]
            dq = self.df_quality[self.df_quality["color_space"] == space]
            for sub in sorted(set(dc["subsampling"])):
                c = dc[dc["subsampling"] == sub]["compression_ratio"]
                q = dq[dq["subsampling"] == sub]["composite_score"] \
                    if len(dq) else pd.Series(dtype=float)
                rows.append({
                    "color_space": space, "subsampling": sub,
                    "cr_median": round(c.median(), 4) if len(c) else np.nan,
                    "cr_mean": round(c.mean(), 4) if len(c) else np.nan,
                    "score_median": (round(q.median(), 4)
                                     if len(q) else np.nan),
                    "score_mean": round(q.mean(), 4) if len(q) else np.nan,
                    "defined": DEFINED_SUBSAMPLING.get(space, "?") == sub,
                })
        df = pd.DataFrame(rows)
        df.to_csv(os.path.join(self.results_dir,
                               "subsampling_analysis.csv"), index=False)
        if visualize:
            self._plot_bars(df)
        return df

    def settings_analysis(self, top_n: int = 5,
                          visualize: bool = False) -> Dict[str, pd.DataFrame]:
        """Top-N settings by compression ratio and by composite score, plus
        heatmaps of score over (quality range, block range)."""
        out = {}
        out["top_compression"] = self.df_compression.nlargest(
            top_n, "compression_ratio")
        if "composite_score" in self.df_quality.columns and len(
                self.df_quality):
            out["top_quality"] = self.df_quality.nlargest(
                top_n, "composite_score")
        for name, df in out.items():
            df.to_csv(os.path.join(self.results_dir, f"{name}.csv"),
                      index=False)
        if visualize:
            self._plot_heatmaps()
        return out

    # -------------------------------------------------------------- plots
    def _plot_bars(self, df: pd.DataFrame) -> None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 5))
        piv = df.pivot_table(index="color_space", columns="subsampling",
                             values="cr_mean")
        piv.plot.bar(ax=ax)
        ax.set_ylabel("mean compression ratio")
        fig.tight_layout()
        fig.savefig(os.path.join(self.figures_dir, "subsampling_cr.png"))
        plt.close(fig)

    def _plot_heatmaps(self) -> None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        df = self.df_compression
        for value in ("compression_ratio", "composite_score"):
            if value not in df.columns:
                continue
            piv = df.pivot_table(
                index=df["min_quality"].astype(str) + "-"
                + df["max_quality"].astype(str),
                columns=df["min_block_size"].astype(str) + "-"
                + df["max_block_size"].astype(str),
                values=value, aggfunc="mean")
            fig, ax = plt.subplots(figsize=(12, 8))
            im = ax.imshow(piv.values, aspect="auto", cmap="viridis")
            ax.set_xticks(range(len(piv.columns)), piv.columns, rotation=90)
            ax.set_yticks(range(len(piv.index)), piv.index)
            ax.set_xlabel("block size range")
            ax.set_ylabel("quality range")
            fig.colorbar(im)
            fig.tight_layout()
            fig.savefig(os.path.join(self.figures_dir,
                                     f"heatmap_{value}.png"))
            plt.close(fig)
