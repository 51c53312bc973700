"""The port's harness modules against the JAX package's, on the CPU: the
per-image MetricsSweep, compare and analyze (the same CSVs in, the same
files and frames out), the speed table, the quadtree visualizer and the
normalization-constant derivation."""

import os
import shutil

import imageio.v3 as iio
import numpy as np
import pandas as pd
import pytest
import torch

from aejpeg_tpu import CodecConfig as JConfig
from aejpeg_tpu.harness import analyze as janalyze
from aejpeg_tpu.harness import compare as jcompare
from aejpeg_tpu.harness.normalization import \
    derive_constants as j_derive_constants
from aejpeg_tpu.harness.sweep import MetricsSweep as JMetricsSweep
from aejpeg_tpu.harness.visualize import visualize as j_visualize
import aejpeg_tpu_torch as at
from aejpeg_tpu_torch.harness import analyze, compare
from aejpeg_tpu_torch.harness.normalization import derive_constants
from aejpeg_tpu_torch.harness.speed import format_table, run_speed_table
from aejpeg_tpu_torch.harness.sweep import MetricsSweep
from aejpeg_tpu_torch.harness.visualize import visualize

from test_torch_sweep import lpips_weights, synth

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    root = tmp_path_factory.mktemp("harness")
    path = root / "img0.png"
    at.ImageData.from_array(synth(192, 192, 3) / np.float32(255)).save(
        str(path))
    return path, lpips_weights(root / "lpips_random.npz")


def test_metrics_sweep_matches_jax(image, tmp_path):
    path, weights = image
    kw = dict(color_spaces=["YCbCr"], quality_ranges=[(50, 50), (25, 75)],
              block_size_ranges=[(8, 8), (8, 32)], with_lpips=True,
              lpips_weights=weights)
    ours = MetricsSweep([path], tmp_path / "port.csv", device="cpu",
                        **kw).run()
    theirs = JMetricsSweep([path], tmp_path / "jax.csv", **kw).run()
    assert len(ours) == len(theirs) == 4
    port_csv = pd.read_csv(tmp_path / "port.csv", dtype=str)
    jax_csv = pd.read_csv(tmp_path / "jax.csv", dtype=str)
    assert list(port_csv.columns) == list(jax_csv.columns)
    for a, b in zip(port_csv.to_dict("records"), jax_csv.to_dict("records")):
        for k in ("image_name", "color_space", "min_quality", "max_quality",
                  "min_block_size", "max_block_size", "compression_ratio"):
            assert a[k] == b[k]
        for m in ("psnr", "ssim", "ms_ssim", "lpips"):
            assert abs(float(a[m]) - float(b[m])) <= 1e-4, (m, a[m], b[m])


def _sweep_rows(lpips):
    rows = []
    for img in ("a.png", "b.png"):
        for q, cr, ps in ((90, 30.0, 40.0), (50, 12.0, 31.0),
                          (25, 16.5, 28.5)):
            for blocks in ((8, 8), (4, 32)):
                rows.append({
                    "image_name": img, "color_space": "YCbCr",
                    "min_quality": q, "max_quality": q,
                    "min_block_size": blocks[0], "max_block_size": blocks[1],
                    "psnr": ps + blocks[1] / 64, "ssim": 0.97 + q / 5000,
                    "ms_ssim": 0.96 + q / 4000,
                    "lpips": (float("nan") if lpips is None
                              else lpips + blocks[0] / 1000),
                    "compression_ratio": cr + blocks[1] / 8})
    return rows


def _run_compare(module, src_dir, out_dir):
    shutil.copytree(src_dir, out_dir)
    cmp_ = module.MetricsComparison(input_dir=str(out_dir))
    outputs = cmp_.run()
    return cmp_, {name: pd.read_csv(p) for name, p in outputs.items()}


@pytest.mark.parametrize("lpips", [0.05, None], ids=["lpips", "nan-lpips"])
def test_compare_and_analyze_match_jax(tmp_path, capsys, lpips):
    """The same sweep CSVs through both packages' compare and analyze:
    identical averages, selections, analysis CSVs and printed frames."""
    src = tmp_path / "src"
    src.mkdir()
    pd.DataFrame(_sweep_rows(lpips)).to_csv(src / "cr_YCbCr_420.csv",
                                            index=False)
    pd.DataFrame(_sweep_rows(lpips)).assign(color_space="ICtCp").to_csv(
        src / "cr_ICtCp_411.csv", index=False)
    ours, ours_out = _run_compare(compare, src, tmp_path / "port")
    theirs, theirs_out = _run_compare(jcompare, src, tmp_path / "jax")
    assert set(ours_out) == set(theirs_out) and ours_out
    for name in ours_out:
        pd.testing.assert_frame_equal(ours_out[name], theirs_out[name])
    for base in ("cr_YCbCr_420_avg.csv", "cr_ICtCp_411_avg.csv"):
        assert (tmp_path / "port" / base).read_text() == \
            (tmp_path / "jax" / base).read_text()
    assert len(ours.better_compression) == len(theirs.better_compression)
    assert len(ours.better_quality) == len(theirs.better_quality)
    if lpips is None:
        scores = [r["composite_score"] for r in ours.better_compression]
        assert scores and all(s == s for s in scores)

    comp = "better_compression"
    qual = "better_quality" if "better_quality" in ours_out else comp
    printed = {}
    for name, module in (("port", analyze), ("jax", janalyze)):
        d = tmp_path / name
        files = sorted(os.listdir(d))
        cfile = next(f for f in files if f.endswith(f"_{comp}.csv"))
        qfile = next(f for f in files if f.endswith(f"_{qual}.csv"))
        an = module.MetricsAnalysis(str(d), str(tmp_path / f"fig_{name}"),
                                    cfile, qfile)
        sub = an.subsampling_analysis()
        top = an.settings_analysis(top_n=3)
        printed[name] = (sub.to_string(index=False),
                         {k: v.to_string(index=False) for k, v in top.items()})
        capsys.readouterr()
    assert printed["port"] == printed["jax"]
    for f in ("subsampling_analysis.csv", "top_compression.csv"):
        assert (tmp_path / "port" / f).read_text() == \
            (tmp_path / "jax" / f).read_text()


def test_speed_table(tmp_path):
    path = str(tmp_path / "img.png")
    at.ImageData.from_array(synth(64, 64, 5) / np.float32(255)).save(path)
    rows = run_speed_table(path, iters=1, block_sizes=[8, 16], device="cpu")
    assert [r["block"] for r in rows] == [8, 16]
    for r in rows:
        assert set(r) == {"block", "compress_s", "decompress_s", "mpix_s",
                          "p50_latency_s", "bytes"}
        assert r["compress_s"] > 0 and r["decompress_s"] > 0
        assert r["mpix_s"] > 0 and r["p50_latency_s"] > 0 and r["bytes"] > 0
    assert len(format_table(rows).splitlines()) == 3


def test_visualize_matches_jax(image, tmp_path, capsys):
    path, _ = image
    cfg = dict(color_space="YCoCg", quality_range=(40, 80),
               block_size_range=(4, 16))
    ours = visualize(str(path), str(tmp_path / "port"),
                     at.CodecConfig(**cfg), device="cpu")
    theirs = j_visualize(str(path), str(tmp_path / "jax"), JConfig(**cfg))
    capsys.readouterr()
    for name in ("luminance", "chroma1", "chroma2"):
        assert ours[f"{name}_leaves"] == theirs[f"{name}_leaves"] > 0
        for suffix in ("", "_edges", "_quadtree"):
            f = f"{name}{suffix}.png"
            np.testing.assert_array_equal(iio.imread(tmp_path / "port" / f),
                                          iio.imread(tmp_path / "jax" / f))


def test_derive_constants_matches_jax():
    spaces = ["YCoCg", "OKLAB"]
    ours = derive_constants(spaces=spaces, device="cpu")
    theirs = j_derive_constants(spaces=spaces)
    for space in spaces:
        for a, b in zip(ours[space], theirs[space]):
            assert a.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
