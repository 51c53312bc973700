"""The port's batched metric sweep, on the CPU: against the JAX package's
sweep (key columns and compression ratios identical, metrics within 1e-4),
against the port's own encode_batch -> decode_batch -> EvaluationMetrics
path (identical strings), resume after a run cut mid-combo, and the stage
timings."""

import csv

import numpy as np
import pytest
import torch

from aejpeg_tpu.harness.sweep_batched import \
    BatchedMetricsSweep as JBatchedMetricsSweep
import aejpeg_tpu_torch as at
from aejpeg_tpu_torch.harness.sweep_batched import BatchedMetricsSweep
from aejpeg_tpu_torch.metrics import lpips as L

torch.set_num_threads(1)

QUALITY = [(20, 80), (50, 50)]
BLOCKS = [(4, 32), (8, 8), (4, 128)]
KEYS = ["image_name", "color_space", "min_quality", "max_quality",
        "min_block_size", "max_block_size"]
METRICS = ["psnr", "ssim", "ms_ssim", "lpips"]


def synth(h, w, seed):
    """A smooth u8-exact RGB image with hard-edged blocks, from a seed."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    f = rng.uniform(6, 30, 3)
    img = np.stack([0.5 + 0.4 * np.sin(x / f[0]) * np.cos(y / f[1]),
                    (x + y) / (h + w),
                    0.5 + 0.3 * np.cos((x - y) / f[2])], -1)
    for _ in range(4):
        y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
        img[y0:y0 + rng.integers(8, h // 3),
            x0:x0 + rng.integers(8, w // 3)] = rng.random(3)
    img += rng.normal(0, 0.02, img.shape)
    return np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)


def lpips_weights(path):
    """Random weights at AlexNet's widths, as the .npz both packages read."""
    rng = np.random.default_rng(7)
    arrays, in_ch = {}, 3
    for i, (out, k, _, _) in enumerate(L.ALEX_CONVS):
        arrays[f"conv{i}_w"] = rng.normal(
            0, 0.05, (out, in_ch, k, k)).astype(np.float32)
        arrays[f"conv{i}_b"] = rng.normal(0, 0.01, out).astype(np.float32)
        arrays[f"lin{i}_w"] = np.abs(rng.normal(
            0, 0.1, (1, out, 1, 1))).astype(np.float32)
        in_ch = out
    np.savez(path, **arrays)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two 272x300 PNGs (the 5-scale MS-SSIM window and the WIDE band fit)
    and the LPIPS weights."""
    root = tmp_path_factory.mktemp("sweep")
    paths = []
    for i in range(2):
        p = root / f"img{i}.png"
        at.ImageData.from_array(synth(272, 300, i) / np.float32(255)).save(
            str(p))
        paths.append(p)
    return paths, lpips_weights(root / "lpips_random.npz")


def rows_by_key(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    out = {tuple(r[k] for k in KEYS): r for r in rows}
    assert len(out) == len(rows), "duplicate rows"
    return out


def run_port(paths, out, space, weights=None, **kw):
    sweep = BatchedMetricsSweep(
        paths, out, color_spaces=(space,), quality_ranges=QUALITY,
        block_size_ranges=BLOCKS, entropy_level=-1,
        with_lpips=weights is not None, lpips_weights=weights,
        device="cpu", **kw)
    sweep.run()
    assert not sweep.errors, sweep.errors
    return rows_by_key(out)


@pytest.mark.parametrize("space", ["YCoCg", "ICtCp"])
def test_sweep_matches_jax(files, tmp_path, space):
    paths, weights = files
    ours = run_port(paths, tmp_path / "port.csv", space, weights)
    theirs = JBatchedMetricsSweep(
        paths, tmp_path / "jax.csv", color_spaces=(space,),
        quality_ranges=QUALITY, block_size_ranges=BLOCKS, entropy_level=-1,
        with_lpips=True, lpips_weights=weights)
    theirs.run()
    assert not theirs.errors, theirs.errors
    theirs = rows_by_key(tmp_path / "jax.csv")
    assert set(ours) == set(theirs)
    assert len(ours) == len(paths) * len(QUALITY) * len(BLOCKS)
    for key, row in ours.items():
        assert row["compression_ratio"] == theirs[key]["compression_ratio"]
        for m in METRICS:
            assert abs(float(row[m]) - float(theirs[key][m])) <= 1e-4, \
                (key, m, row[m], theirs[key][m])


def check_sweep_matches_decode_path(files, tmp_path, space):
    """Every ratio and metric string equals the one the port's own
    encode_batch -> decode_batch -> EvaluationMetrics path prints."""
    paths, weights = files
    rows = run_port(paths, tmp_path / "port.csv", space, weights)
    imgs = [at.ImageData.load(str(p)) for p in paths]
    for qr in QUALITY:
        for br in BLOCKS:
            cfg = at.CodecConfig(space, qr, br, entropy_level=-1)
            blobs = at.encode_batch(imgs, cfg, device="cpu")
            for p, img, blob, dec in zip(
                    paths, imgs, blobs, at.decode_batch(blobs, device="cpu")):
                row = rows[(str(p), space, str(qr[0]), str(qr[1]),
                            str(br[0]), str(br[1]))]
                ev = at.EvaluationMetrics(img, dec, lpips_weights=weights,
                                          device="cpu")
                assert row["compression_ratio"] == \
                    f"{img.raw_rgb_bytes / len(blob):.4f}"
                assert row["psnr"] == f"{ev.psnr():.4f}"
                assert row["ssim"] == f"{ev.ssim():.4f}"
                assert row["ms_ssim"] == f"{ev.ms_ssim():.4f}"
                assert abs(float(row["lpips"]) - ev.lpips()) <= 1e-4


# ICtCp's case runs in test_torch_sweep_ictcp.py: it takes about as long
# as every other case of this file together
@pytest.mark.parametrize("space", ["YCoCg"])
def test_sweep_matches_decode_path(files, tmp_path, space):
    check_sweep_matches_decode_path(files, tmp_path, space)


def test_resume_rerun_is_noop(files, tmp_path):
    paths, _ = files
    out = tmp_path / "sweep.csv"
    run_port(paths, out, "YCoCg")
    first = out.read_text()
    run_port(paths, out, "YCoCg")
    assert out.read_text() == first


def test_resume_after_cut_mid_combo(files, tmp_path):
    """A run killed after the first image's row of a combo resumes to the
    full set of rows, none twice: the missing images' rows of that combo
    are written too, not only the combos never started."""
    paths, _ = files
    full = tmp_path / "full.csv"
    want = run_port(paths, full, "YCoCg")
    lines = full.read_text().splitlines(keepends=True)
    # header, then 2 rows a combo: cut after the first row of combo 2
    cut = tmp_path / "cut.csv"
    cut.write_text("".join(lines[:1 + 2 * 2 + 1]))
    got = run_port(paths, cut, "YCoCg")
    assert got == want


def test_timings_cover_every_stage(files, tmp_path):
    """timings= splits the run into its stages and leaves the rows as an
    untimed run writes them."""
    paths, weights = files
    st = {}
    timed = run_port(paths, tmp_path / "timed.csv", "YCoCg", weights,
                     timings=st)
    assert timed == run_port(paths, tmp_path / "plain.csv", "YCoCg", weights)
    assert set(st) == {"load", "push", "stage_a 272x300 YCoCg", "lpips",
                       "stage_b", "plans", "stage_d", "psnr", "ssim",
                       "ms_ssim", "pull", "assemble"}
    assert all(v >= 0.0 for v in st.values())


def test_sweep_needs_cuda_unless_asked(files, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedMetricsSweep(files[0], tmp_path / "x.csv")
