#!/usr/bin/env python3
"""Device-time split of the two CLAHE apply kernels on one NVIDIA GPU.

    python3 tools/probe_clahe_apply.py [--old OLD/clahe_apply.cu]
                                       [--json OUT.json]

Builds aejpeg_tpu_torch/csrc/clahe_apply.cu as it is and in probe variants
(each a text edit of the source, built into aejpeg_tpu_torch/build/probe/),
then times every variant at the shapes the main path gives the kernels:
the gather on 42 x 512x768 and 84 x 256x384, the 4-tap fallback on
2 x 200x300 and 4 x 100x150.  Variants:

  kernel       the source as it is (checked bitwise against its plain
               version);
  no-conflict  the gather's word lookups at v & 1 instead of v: two words,
               two banks, no bank conflicts (wrong results by design);
  f32-outer    the gather's outer blend as a float32 FMA instead of the
               float64 formula: what the float64 conversions cost (may
               differ from the plain version in the last bit);
  band-32, band-128, warps-8
               the gather's CTA with 32 or 128 rows instead of 64, or 8
               warps instead of 4;
  old          with --old, an earlier clahe_apply.cu that takes int32
               pixels (checked bitwise too), timed in turns with `kernel`
               (old, kernel, kernel, old).

Each time as chip_smoke.py phase 2 takes it: CUDA events around 25
back-to-back launches after 3 warm-ups, and the kernel's device time per
call from torch.profiler over the same loop.  Prints one line per
measurement and, with --json, writes them to that file.  Needs CUDA and
nvcc.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from aejpeg_tpu_torch.ops import _build, canny, kernels as K  # noqa: E402

B = "constexpr int kGatherBand = 64;"
W = "constexpr int kGatherWarps = 4;"
PROBES = {
    "no-conflict": [("  const int wt = sw[top + v];",
                     "  v &= 1;\n  const int wt = sw[top + v];")],
    "f32-outer": [("  return __double2float_rn(__fma_rn("
                   "static_cast<double>(t), ya1,\n"
                   "                                    static_cast<double>"
                   "(__fmul_rn(b, ya))));",
                   "  return __fmaf_rn(t, static_cast<float>(ya1), "
                   "__fmul_rn(b, ya));")],
    "band-32": [(B, B.replace("64;", "32;"))],
    "band-128": [(B, B.replace("64;", "128;"))],
    "warps-8": [(W, W.replace("4;", "8;"))],
}


def build(sources):
    """{label: .cu path} -> {label: ctypes library}, nvcc in parallel."""
    out_dir = os.path.join(_build.BUILD, "probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for label, src in sources.items():
        so = os.path.join(out_dir, f"lib{label}.so")
        procs[label] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for label, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {label}:\n{log.decode()}")
        for line in log.decode().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {label}: {line.strip()}")
        libs[label] = ctypes.CDLL(so)
    return libs


def variant_sources():
    """Write the probe variants next to their libraries; {label: path}."""
    with open(os.path.join(_build.CSRC, "clahe_apply.cu")) as f:
        text = f.read()
    out = {"kernel": os.path.join(_build.CSRC, "clahe_apply.cu")}
    for label, edits in PROBES.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"probe {label}: edit site not found")
            src = src.replace(old, new)
        path = os.path.join(_build.BUILD, "probe", f"{label}.cu")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(src)
        out[label] = path
    return out


def launcher(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = K._SIGNATURES[name][1]
    fn.restype = ctypes.c_int

    def run(*args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: launch failed ({err})")
    return run


def gather_case(p, h, w, g):
    th, tw = h // 4, w // 4
    img = torch.randint(0, 256, (p, h, w), generator=g,
                        dtype=torch.uint8).cuda()
    luts = torch.randint(0, 256, (p, 4, 4, 256), generator=g).to(torch.uint8)
    words = (luts.permute(0, 1, 3, 2).contiguous().view(torch.int32)
             .squeeze(-1).cuda())
    vecs = [torch.as_tensor(a).cuda()
            for a in canny._clahe_interp_vectors(h, w, th, tw, 4, 4)]
    out = torch.empty((p, h, w), dtype=torch.float32, device="cuda")
    want = K.clahe_apply_gather_plain(img, words, *vecs, th=th)

    def args(pix):
        return (pix.data_ptr(), words.data_ptr(),
                *[v.data_ptr() for v in vecs], out.data_ptr(), p, h, w, 4, th)
    return img, out, want, args


def lut_case(p, h, w, g):
    th, tw = -(-h // 4), -(-w // 4)
    img = torch.randint(0, 256, (p, h, w), generator=g,
                        dtype=torch.uint8).cuda()
    lut = torch.randint(0, 256, (p, 16, 256), generator=g).float().cuda()
    iy, ix, wts = [torch.as_tensor(a).cuda()
                   for a in canny._clahe_taps(h, w, th, tw, 4, 4)]
    out = torch.empty((p, h, w), dtype=torch.float32, device="cuda")
    want = K.clahe_lut_apply_plain(img, lut, iy, ix, wts, gw=4)

    def args(pix):
        return (pix.data_ptr(), lut.data_ptr(), iy.data_ptr(), ix.data_ptr(),
                wts.data_ptr(), out.data_ptr(), p, h, w, 16, 4)
    return img, out, want, args


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="an earlier clahe_apply.cu (int32 pixels)")
    ap.add_argument("--json", help="write the measurements to this file")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_clahe_apply: CUDA is not available", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(f"card: {card}")
    sources = variant_sources()
    if opts.old:
        sources["old"] = os.path.abspath(opts.old)
    libs = build(sources)
    g = torch.Generator().manual_seed(0)
    rows = []
    for name, kernel, make, shapes in (
            ("aej_clahe_gather", "clahe_gather_kernel", gather_case,
             ((42, 512, 768), (84, 256, 384))),
            ("aej_clahe_lut_apply", "clahe_lut_apply_kernel", lut_case,
             ((2, 200, 300), (4, 100, 150)))):
        for shape in shapes:
            img, out, want, args = make(*shape, g)
            wide = img.to(torch.int32)
            # the probes edit the gather only
            probes = list(PROBES) if name == "aej_clahe_gather" else []
            order = (["old", "kernel", "kernel", "old"] if "old" in libs
                     else ["kernel"]) + probes
            for label in order:
                pix = wide if label == "old" else img
                run = launcher(libs[label], name)
                a = args(pix)
                out.zero_()
                run(*a)
                torch.cuda.synchronize()
                same = torch.equal(out.view(torch.int32),
                                   want.view(torch.int32))
                if label in ("kernel", "old") and not same:
                    raise AssertionError(f"{label} {name} {shape}: differs "
                                         "from the plain version")
                ev = chip_smoke.cuda_ms(lambda: run(*a))
                dev = chip_smoke.device_ms(lambda: run(*a), kernel)
                row = {"kernel": name, "variant": label, "shape": shape,
                       "event_ms": ev, "device_ms": dev, "bitwise": same,
                       "card": card}
                rows.append(row)
                print(f"  {name} {shape} {label}: event {ev:.5f} ms, device "
                      f"{dev:.5f} ms per call, bitwise {same}")
    if opts.json:
        with open(opts.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
