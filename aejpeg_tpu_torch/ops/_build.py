"""Build the CUDA sources under csrc/ into shared libraries with a plain C
interface, loaded through ctypes.

Each source compiles on its own (one nvcc process per source, all started
together) for sm_90a.  A library's file name carries a hash of its source
and the flags, so an edited source is rebuilt at its next use and an
unchanged one is loaded as it is.  The build happens at first use, into
`aejpeg_tpu_torch/build/` (listed in .gitignore).  A failed build raises
with nvcc's output; there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
SOURCES = ("histogram256.cu", "clahe_apply.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the aejpeg_tpu_torch CUDA kernels")


def library_path(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def _build_missing() -> Dict[str, float]:
    """Compile every source whose library is missing, in parallel; returns
    {source: seconds}.  Caller holds _LOCK."""
    todo = [s for s in SOURCES if not os.path.exists(library_path(s))]
    if not todo:
        return {}
    os.makedirs(BUILD, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src in todo:
        out = library_path(src)
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs.append((src, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)))
    times, errors = {}, []
    for src, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        times[src] = time.perf_counter() - t0
        with open(out + ".log", "wb") as f:
            f.write(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                          + log.decode(errors="replace"))
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def build_all() -> Dict[str, float]:
    """Build every missing kernel library now; returns {source: seconds}
    for the sources compiled by this call."""
    with _LOCK:
        return _build_missing()


def build_log(source: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) of the
    library currently built for `source`, or '' if there is none."""
    try:
        with open(library_path(source) + ".log", "rb") as f:
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one csrc/ source, built first if missing."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            _build_missing()
            lib = _LIBS[source] = ctypes.CDLL(library_path(source))
        return lib
