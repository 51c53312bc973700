"""`python -m aejpeg_tpu_torch.cli` on the CPU: the subcommands in
process with --device cpu (containers byte-identical to the JAX CLI's), one
in a subprocess, and the refusal to run without CUDA unless asked."""

import csv
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from aejpeg_tpu import cli as jcli
import aejpeg_tpu_torch as at
from aejpeg_tpu_torch import cli

from test_torch_sweep import synth

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODEC_ARGS = ["--color-space", "YCoCg", "--quality", "20", "80",
              "--blocks", "4", "128"]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    paths = []
    for i, (h, w) in enumerate(((176, 208), (176, 208))):
        p = root / f"img{i}.png"
        at.ImageData.from_array(synth(h, w, 10 + i) / np.float32(255)).save(
            str(p))
        paths.append(str(p))
    return paths


def _jax_cli(argv, cache_dir):
    """The JAX CLI in process; its persistent-cache settings restored
    after (its main() sets them process-wide)."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(cache_dir)
    try:
        jcli.main(argv)
    finally:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR")
        for k, v in saved.items():
            jax.config.update(k, v)


def test_compress_matches_jax_cli(images, tmp_path, capsys):
    cli.main(["compress", *images, "-o", str(tmp_path / "port"),
              *CODEC_ARGS, "--device", "cpu"])
    _jax_cli(["compress", *images, "-o", str(tmp_path / "jax"),
              *CODEC_ARGS], tmp_path / "cache")
    out = capsys.readouterr().out
    assert out.count(" bytes, ") == 4
    for p in images:
        name = os.path.splitext(os.path.basename(p))[0] + ".ajpg"
        ours = (tmp_path / "port" / name).read_bytes()
        assert ours == (tmp_path / "jax" / name).read_bytes()


def test_info_decompress_preview(images, tmp_path, capsys):
    cli.main(["compress", images[0], "-o", str(tmp_path), *CODEC_ARGS,
              "--device", "cpu"])
    ajpg = str(tmp_path / "img0.ajpg")
    capsys.readouterr()
    cli.main(["info", ajpg])
    meta = json.loads(capsys.readouterr().out)
    assert meta["color_space"] == "YCoCg" and meta["quality"] == [20, 80]
    assert meta["blocks"] == [4, 128] and meta["extension"] == ".png"
    assert (meta["height"], meta["width"]) == (176, 208)

    cli.main(["decompress", ajpg, "-o", str(tmp_path), "--device", "cpu"])
    out = at.ImageData.load(str(tmp_path / "img0_decompressed.png"))
    src = at.ImageData.load(images[0])
    psnr = 10 * np.log10(1 / np.mean((out.data - src.data) ** 2))
    assert out.data.shape == src.data.shape and psnr > 25

    capsys.readouterr()
    cli.main(["preview", images[0], *CODEC_ARGS, "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    for key in ("compression_ratio", "psnr", "ssim", "ms_ssim"):
        assert report[key] > 0
    assert report["lpips"] is None      # no weights in the repository
    assert report["psnr"] > 25


def test_sweep_subcommand(images, tmp_path):
    out = tmp_path / "sweep.csv"
    cli.main(["sweep", os.path.dirname(images[0]), "-o", str(out),
              "--color-spaces", "YCoCg", "--quality-values", "50",
              "--block-values", "8", "16", "--device", "cpu"])
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 * 3
    assert {r["max_block_size"] for r in rows} == {"8", "16"}
    assert all(float(r["psnr"]) > 25 and r["lpips"] == "" for r in rows)


def test_info_in_subprocess(images, tmp_path):
    cli.main(["compress", images[0], "-o", str(tmp_path), "--quality", "50",
              "50", "--blocks", "8", "8", "--device", "cpu"])
    res = subprocess.run(
        [sys.executable, "-m", "aejpeg_tpu_torch.cli", "info",
         str(tmp_path / "img0.ajpg")], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr[-2000:]
    meta = json.loads(res.stdout)
    assert meta["quality"] == [50, 50] and meta["blocks"] == [8, 8]
    assert len(meta["layer_coeff_counts"]) == 3


def test_refuses_without_cuda(images, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["compress", images[0], "-o", str(tmp_path)],
                 ["preview", images[0]],
                 ["sweep", os.path.dirname(images[0]), "-o",
                  str(tmp_path / "s.csv")]):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code != 0
        assert "no CUDA device is available" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())
