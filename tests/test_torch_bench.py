"""The port's benchmark (aejpeg_tpu_torch/bench.py) and the CLI's bench and
gui subcommands on the CPU, at tiny sizes (the AEJ_BENCH_* knobs cut the
repetitions)."""

import json
import os

import numpy as np
import pytest
import torch

import aejpeg_tpu_torch as at
from aejpeg_tpu_torch import bench, cli
from aejpeg_tpu_torch.metrics.quality import psnr

from test_torch_sweep import synth

torch.set_num_threads(1)

LINE_KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.fixture
def quick(monkeypatch):
    for k, v in (("AEJ_BENCH_ITERS", "1"), ("AEJ_BENCH_DEVICE_REPS", "1"),
                 ("AEJ_BENCH_STREAM", "3")):
        monkeypatch.setenv(k, v)


def _image(h, w, seed):
    img = at.ImageData.from_array(synth(h, w, seed) / np.float32(255),
                                  extension=".bmp")
    img.u8_exact = True
    return img


def test_run_reports_decode_batch_psnr(quick, monkeypatch):
    monkeypatch.setenv("AEJ_BENCH_BLOCKS", "4,32")
    images = [_image(64, 96, 1), _image(64, 96, 2)]
    line, st = bench.run(images, device="cpu")
    assert set(line) == LINE_KEYS
    assert line["unit"] == "Mpix/s" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 500.0, 4)
    json.loads(json.dumps(line))
    cfg = at.CodecConfig("YCoCg", (20, 80), (4, 32), entropy_level=-1)
    blobs = at.encode_batch(images, cfg, device="cpu")
    dec = at.decode_batch(blobs, device="cpu")
    want = float(psnr(torch.from_numpy(images[0].data),
                      torch.from_numpy(dec[0].data)))
    assert st["psnr_db"] == want
    assert f"PSNR {want:.2f} dB" in line["metric"]
    assert st["ratio"] == 2 * 64 * 96 * 3 / sum(map(len, blobs))
    assert st["device"] == "cpu" and "on cpu" in line["metric"]
    for k in ("encode_stream_mpix_s", "encode_sync_mpix_s",
              "decode_stream_mpix_s", "decode_sync_mpix_s",
              "p50_single_ms", "device_busy_s", "host_busy_s"):
        assert st[k] > 0, k
    assert set(st["encode_stages_s"]) == {"push", "stage_a", "plans",
                                          "device", "pull", "assemble"}
    assert set(st["decode_stages_s"]) == {"parse", "push", "device"}


def _write_bmps(directory, shapes):
    paths = []
    for i, (h, w) in enumerate(shapes):
        p = os.path.join(directory, f"im{i:02d}.bmp")
        at.ImageData.from_array(synth(h, w, 30 + i) / np.float32(255)).save(p)
        paths.append(p)
    return paths


def test_load_images_picks_512x768_and_replicates(tmp_path, monkeypatch):
    monkeypatch.setenv("AEJ_BENCH_BATCH", "2")
    monkeypatch.setenv("AEJ_BENCH_REPLICATE", "3")
    _write_bmps(str(tmp_path), [(512, 768), (64, 64), (512, 768),
                                (512, 768)])
    (tmp_path / "note.png").write_bytes(b"")
    imgs = bench.load_images(str(tmp_path))
    assert len(imgs) == 6
    assert all(im.original_shape == (512, 768, 3) for im in imgs)
    assert all(im.extension == ".bmp" and im.u8_exact for im in imgs)
    np.testing.assert_array_equal(imgs[0].data, imgs[2].data)
    np.testing.assert_array_equal(imgs[0].data,
                                  synth(512, 768, 30) / np.float32(255))
    np.testing.assert_array_equal(imgs[1].data,
                                  synth(512, 768, 32) / np.float32(255))


def test_load_images_without_any_raises(tmp_path):
    _write_bmps(str(tmp_path), [(64, 64)])
    with pytest.raises(FileNotFoundError, match="512x768"):
        bench.load_images(str(tmp_path))


def test_main_prints_one_json_line(tmp_path, quick, monkeypatch, capsys):
    monkeypatch.setenv("AEJ_BENCH_BATCH", "1")
    monkeypatch.setenv("AEJ_BENCH_REPLICATE", "2")
    monkeypatch.setenv("AEJ_BENCH_BLOCKS", "8,8")
    _write_bmps(str(tmp_path), [(512, 768)])
    assert bench.main(["--images", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert set(line) == LINE_KEYS and line["value"] > 0
    assert "512x768 x2" in line["metric"]


def test_cli_bench_subcommand(tmp_path, quick, monkeypatch, capsys):
    monkeypatch.setenv("AEJ_BENCH_BATCH", "1")
    monkeypatch.setenv("AEJ_BENCH_REPLICATE", "2")
    monkeypatch.setenv("AEJ_BENCH_BLOCKS", "8,8")
    monkeypatch.delenv("AEJ_BENCH_IMAGES", raising=False)
    _write_bmps(str(tmp_path), [(512, 768)])
    cli.main(["bench", "--images", str(tmp_path), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == LINE_KEYS


@pytest.mark.parametrize("sub", ["bench", "gui"])
def test_cli_help_parses(sub, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([sub, "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--device" in out
    assert ("--images" in out) == (sub == "bench")


def test_bench_needs_images(monkeypatch, capsys):
    monkeypatch.delenv("AEJ_BENCH_IMAGES", raising=False)
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", "--device", "cpu"])
    assert e.value.code != 0
    assert "--images" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["bench", "--images", "."], ["gui"]],
                         ids=["bench", "gui"])
def test_refuses_without_cuda(argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code != 0
    assert "no CUDA device is available" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        bench.main(["--images", "."])
    assert "no CUDA device is available" in capsys.readouterr().err
