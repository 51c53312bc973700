"""The benchmark measures the port alone: no module under benchmark/
imports JAX or the JAX package (top-level names compared whole, so
`aejpeg_tpu_torch` is not `aejpeg_tpu`), and the reference, its colour
spaces' modules included, imports nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark.harness.registry import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "aejpeg_tpu"}
REF = os.path.join(BENCH_DIR, "reference")


def _sources(top):
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(top)
                  for f in fs if f.endswith(".py"))


def _imports(path):
    """(top-level name, relative level) of every import in the file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


@pytest.mark.parametrize("path", _sources(BENCH_DIR),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_jax(path):
    for name, level in _imports(path):
        assert level or name not in FORBIDDEN, (path, name)


@pytest.mark.parametrize("path", _sources(REF),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_reference_imports_nothing_of_the_port(path):
    depth = os.path.relpath(path, REF).count(os.sep)
    for name, level in _imports(path):
        assert level <= depth + 1, (path, "reaches outside the reference")
        assert level or name in {"functools", "importlib", "json", "math",
                                 "os", "typing", "zlib", "numpy",
                                 "torch"}, (path, name)


def test_loaded_modules():
    code = ("import sys, benchmark.reference.codec, "
            "benchmark.reference.container;"
            " benchmark.reference.codec.space('ICtCp');"
            " ref = {m.split('.')[0] for m in sys.modules};"
            " import benchmark.harness.main, benchmark.calibrate;"
            " print(sorted(ref & {'jax', 'jaxlib', 'flax', 'aejpeg_tpu',"
            " 'aejpeg_tpu_torch'}), sorted({m.split('.')[0] for m in"
            " sys.modules} & {'jax', 'jaxlib', 'flax', 'aejpeg_tpu'}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[] []", res.stdout
