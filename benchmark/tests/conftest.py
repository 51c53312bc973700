"""Tests of the benchmark, run on the CPU:
    python -m pytest benchmark/tests -q
Tests marked `card` need a CUDA device and skip without one (their fixture
decides); on the card:
    python -m pytest benchmark/tests -q -m card
"""

import json
import os
import shutil

import pytest
import torch

from benchmark.harness.registry import BENCH_DIR, ROOT, Registry

SMALL = {"height": 64, "width": 96, "count": 3}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def small_bench(tmp_path, images=SMALL) -> Registry:
    """A copy of the benchmark's data files in tmp_path with the images cut
    to `images` and the traffic to two outputs a call, no warm-up."""
    b = tmp_path / "benchmark"
    for d in ("configs", "traffic", "kinds", "metrics", "limits"):
        shutil.copytree(os.path.join(BENCH_DIR, d), b / d)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for f in (b / "configs").iterdir():
        c = json.loads(f.read_text())
        c["images"].update(images)
        f.write_text(json.dumps(c))
    for f in (b / "traffic").iterdir():
        t = json.loads(f.read_text())
        t.update(warm_seconds=0, warm_calls=1, sample=2,
                 profile_seconds=0.2)
        if "repeat" in t:
            t.update(repeat=2, batch_size=2)
        f.write_text(json.dumps(t))
    return Registry(str(b), str(tmp_path / "BENCHMARK.json"))


@pytest.fixture
def small(tmp_path):
    torch.set_num_threads(2)
    return small_bench(tmp_path)
