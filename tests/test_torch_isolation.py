"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import aejpeg_tpu_torch as at

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "aejpeg_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "aejpeg_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_leaves_jax_out():
    code = ("import sys; import aejpeg_tpu_torch, aejpeg_tpu_torch.ops.canny;"
            " bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    img = at.ImageData.from_array(np.zeros((16, 16, 3), np.float32))
    cfg = at.CodecConfig("YCoCg", (20, 80), (4, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        at.encode_batch([img], cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        at.encode_stream([img], cfg)
    blob = at.encode_batch([img], cfg, device="cpu")[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        at.decode_batch([blob])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        at.decode_stream([blob])
    assert at.decode_batch([blob], device="cpu")[0].data.shape == (16, 16, 3)


def test_numerics_pinned():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
