"""Phase 2 of chip_smoke.py for the XLA-ordered contraction kernels
(csrc/banded_resize.cu: `banded_resize` and `dct2d`), the bilateral
filter (csrc/bilateral.cu) and the hysteresis (csrc/hysteresis.cu) alone:
each against its plain version on the card, bitwise, timed beside its
bound and the route it replaced.

    python3 tools/probe_contract.py [--quick | --path] [--kernels NAME,...]
                                    [--csrc DIR ...] [--devices I,J,...]
    python3 tools/probe_contract.py --compare [--csrc DIR ...]
                                    [--two-pass DIR]

The cases, timings and bounds are chip_smoke.py's (`kernel_cases`,
`check_kernels`); timed runs start with chip_smoke's `warm_card`.
--quick: the cases off the main path only (small, odd and special
shapes), untimed; --path: the cases on it only (timed), so that an
earlier source that fails a newer off-path case can still be timed.
--kernels: a subset of banded_resize,dct2d,bilateral,hysteresis.  --csrc DIR: build
the kernels from the sources in DIR (into DIR/build) instead of the
package's csrc/; given several times, each directory in turn in one process, so
that a variant of a source and the package's are timed on one card.
--devices: the checks on each of these cards in turn, in one process (a
kernel's launch set-up holds per card).  Prints one JSON line per source
directory and card; exits 1 when a kernel fails to launch or differs
from its plain version.

With bilateral among the kernels (and no --quick), the line also gives
`bilateral_stage_a`, the kernel on the planes stage A really filters
(the blurred luma and chroma of phase 3's images, recorded from one
`encode_batch` each), every call bitwise to the plain version, timed as
phase 2 times its cases; and `bilateral_sass`, the SASS instructions of
the radius-2 kernel (`cuobjdump -sass` of the built library, the listing
written beside it) and their count per output pixel.  To time a variant
of csrc/bilateral.cu against it, copy csrc/ twice under the ignored
checkout/ (say checkout/base and checkout/var), edit checkout/var, and
pass --kernels bilateral --csrc checkout/base --csrc checkout/var --csrc
checkout/var --csrc checkout/base (the two in turns).

--compare: instead, for each of chip_smoke's dct2d cases on the main
path (`dct_cases`: the bench planes, block sizes 4-128, both
directions), time the routes in turns (A B C C B A, then reversed; CUDA
events around 25 calls, and the kernels' device time from
torch.profiler): dct2d through the path's entry points, built from each
--csrc directory (default the package's); with --two-pass DIR, the
two-pass route of the `aej_dct_pass` entry of the banded_resize.cu in
DIR (one launch a pass, the float32 intermediate through device memory;
extract it with `git show <rev>:aejpeg_tpu_torch/csrc/banded_resize.cu`
from a revision before dct2d); and the cuBLAS route (the case's library
call, chip_smoke's `_old_dct_route`).  Every dct2d build and the
two-pass route are held bitwise to each other.  Prints one JSON line per
case (median ms and device ms of each route, the function's bound and
the two-pass bound that also counts the intermediate's write and read)
and a line of their sums.
"""

import argparse
import ctypes
import functools
import json
import os
import statistics
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import chip_smoke as cs  # noqa: E402

NAMES = ("banded_resize", "dct2d", "bilateral", "hysteresis")
# the output pixels a thread of csrc/bilateral.cu computes (kRows x kCols)
BILATERAL_PIXELS = 4 * 4


def use_sources(csrc):
    """Load the kernels from `csrc` (built into csrc/build) from now on."""
    from aejpeg_tpu_torch.ops import _build, kernels
    _build.CSRC = os.path.abspath(csrc)
    _build.BUILD = os.path.join(_build.CSRC, "build")
    _build._LIBS.clear()
    kernels._FNS.clear()


def two_pass_entry(csrc):
    """aej_dct_pass of the banded_resize.cu in `csrc`, built with the
    package's nvcc flags into csrc/build."""
    from aejpeg_tpu_torch.ops import _build
    os.makedirs(os.path.join(csrc, "build"), exist_ok=True)
    lib = os.path.join(csrc, "build", "libbanded_resize_two_pass.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib,
                    os.path.join(csrc, "banded_resize.cu")], check=True,
                   stdout=subprocess.DEVNULL)
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = ctypes.CDLL(lib).aej_dct_pass
    fn.argtypes = ([vp] * 4 + [i] * 7 + [vp, vp, i, i, vp, i] + [vp] * 3
                   + [i, i, vp])
    fn.restype = ctypes.c_int
    return fn


def two_pass(fn, x, band, quant=None, add=None, affine=None):
    """The DCT as two launches of aej_dct_pass (axis 1, then axis 2 with
    the epilogue), as the route before dct2d called it."""
    import torch
    from aejpeg_tpu_torch.ops import kernels as K
    lanes, w, w_t, small_w = K._dense(band)
    p, h, wd = x.shape
    s = band.period
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def launch(inp, out, axis, q_args, f_args):
        err = fn(inp.data_ptr(), out.data_ptr(), w.data_ptr(),
                 w_t.data_ptr(), p, h, wd, s, axis, lanes, small_w, *q_args,
                 *f_args, stream)
        if err:
            raise RuntimeError(f"aej_dct_pass: error {err}")
    y = torch.empty_like(x)
    launch(x, y, 1, (0, 0, 1, 1, 0, 0), (0, 0, 0, 1, 1))
    if quant is not None:
        hi, lo, group, zigzag, dtype = quant
        out = torch.empty((p, (h // s) * (wd // s), s * s), dtype=dtype,
                          device=x.device)
        perm = K._zigzag_positions(s, x.device).data_ptr() if zigzag else 0
        launch(y, out, 2, (hi.data_ptr(), lo.data_ptr(), group,
                           hi.shape[0], perm,
                           2 if dtype == torch.int32 else 1),
               (0, 0, 0, 1, 1))
        return out
    out = torch.empty_like(x)
    rcp, mid, group = affine
    launch(y, out, 2, (0, 0, 1, 1, 0, 0),
           (add.data_ptr(), rcp.data_ptr(), mid.data_ptr(), group,
            rcp.shape[0]))
    return out


def stage_a_calls(dev):
    """The bilateral calls of stage A for phase 3's images (42 x 512x768
    and 2 x 200x300, YCoCg 4:2:0), one encode_batch each: [(planes,
    colour, space, radius)]."""
    import aejpeg_tpu_torch as at
    from aejpeg_tpu_torch.ops import canny
    seen = []
    real = canny.bilateral

    def record(planes, colour, space, radius):
        seen.append((planes.clone(), colour, list(space), radius))
        return real(planes, colour, space, radius)
    canny.bilateral = record
    try:
        cfg = at.CodecConfig("YCoCg", (20, 80), (4, 128), entropy_level=-1)
        at.encode_batch(cs.synth_images(cs.BATCH, cs.H, cs.W, 0), cfg,
                        device=dev)
        at.encode_batch(cs.synth_images(2, *cs.SMALL, 1), cfg, device=dev)
    finally:
        canny.bilateral = real
    return seen


def stage_a_bilateral(calls):
    """The bilateral kernel on stage A's recorded calls: each bitwise to
    the plain version, then timed; returns the sums."""
    import torch
    from aejpeg_tpu_torch.ops import kernels as K
    tot = {"ms": 0.0, "device_ms": 0.0, "calls": len(calls)}
    for planes, colour, space, radius in calls:
        run = functools.partial(K.bilateral, planes, colour, space, radius)
        if not torch.equal(run(), K.bilateral_plain(planes, colour, space,
                                                    radius)):
            raise AssertionError(f"bilateral: stage A planes "
                                 f"{tuple(planes.shape)} differ from the "
                                 f"plain version")
        ms = cs.cuda_ms(run)
        dms = cs.device_ms(run, cs.KERNEL_NAMES["bilateral"])
        cs.log(f"  bilateral stage A {tuple(planes.shape)}: bitwise equal; "
               f"kernel {ms:.4f} ms (device "
               f"{'not measured' if dms is None else f'{dms:.4f}'} ms)")
        tot["ms"] += ms
        tot["device_ms"] = (None if dms is None or tot["device_ms"] is None
                            else tot["device_ms"] + dms)
    return tot


def bilateral_sass():
    """SASS instructions of bilateral_kernel<2> in the built library, and
    per output pixel; writes the listing beside the library."""
    import shutil
    from aejpeg_tpu_torch.ops import _build
    lib = _build.library_path("bilateral.cu")
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    body, inside = [], False
    for line in out.splitlines():
        if "Function :" in line:
            inside = "bilateral_kernel" in line and "ILi2E" in line
        elif inside and line.lstrip().startswith("/*") and "*/" in line \
                and line.split("*/", 1)[1].strip():
            body.append(line)
    with open(lib + ".radius2.sass", "w") as f:
        f.write("\n".join(body))
    return {"instructions": len(body),
            "per_pixel": len(body) / BILATERAL_PIXELS}


ROUNDS = 2      # of the routes in turns, each A B C C B A


def compare_routes(dev, csrcs, two_pass_dir):
    """--compare: the routes in turns on chip_smoke's on-path dct2d
    cases; returns the sums of their medians."""
    import torch
    fn = two_pass_entry(two_pass_dir) if two_pass_dir else None
    g = torch.Generator(device="cpu").manual_seed(0)
    names = [f"dct2d {d}" for d in csrcs]
    kernel_of = {n: "dct2d_kernel" for n in names}
    if fn is not None:
        names.append("two_pass")
        kernel_of["two_pass"] = "dct_"
    names.append("cublas")
    sums = {}
    for label, args, _, kern, lib, nbytes, ops, on_path in cs.dct_cases(
            dev, g):
        if not on_path:
            continue
        band, ep = kern.spec
        routes = {n: (lambda kern=kern: kern(*args)) for n in kernel_of}
        routes["cublas"] = lib
        if fn is not None:
            routes["two_pass"] = lambda: two_pass(
                fn, args[0], band, quant=ep.get("quant"),
                add=args[1] if len(args) > 1 else None,
                affine=ep.get("affine"))
        ref = None
        for name in names[:-1]:
            if name.startswith("dct2d "):
                use_sources(name[len("dct2d "):])
            got = routes[name]()
            if ref is not None and not torch.equal(got, ref):
                raise AssertionError(f"{label}: {name} differs")
            ref = got
        ms = {k: [] for k in names}
        dms = {k: [] for k in kernel_of}
        for r in range(ROUNDS):
            order = names if r % 2 == 0 else names[::-1]
            for k in order + order[::-1]:
                if k.startswith("dct2d "):
                    use_sources(k[len("dct2d "):])
                ms[k].append(cs.cuda_ms(routes[k]))
                if k in kernel_of:
                    v = cs.device_ms(routes[k], kernel_of[k])
                    if v is not None:
                        dms[k].append(v)
        med = {k: statistics.median(v) for k, v in ms.items()}
        dmed = {k: statistics.median(v) if v else None
                for k, v in dms.items()}
        ops_ms = ops / cs.H100_FP32_PER_S * 1e3
        bound = max(nbytes / cs.H100_BYTES_PER_S * 1e3, ops_ms)
        # the intermediate written and read back as float32
        bound_old = max((nbytes + 8 * args[0].numel())
                        / cs.H100_BYTES_PER_S * 1e3, ops_ms)
        print(json.dumps({"case": label, "ms": med, "device_ms": dmed,
                          "bound_ms": bound, "bound_two_pass_ms": bound_old,
                          "fp32_bound_ms": ops_ms}), flush=True)
        for k, v in list(med.items()) + [
                (k + " device", v) for k, v in dmed.items()]:
            if v is not None:
                sums[k] = sums.get(k, 0.0) + v
        sums["bound"] = sums.get("bound", 0.0) + bound
        sums["bound_two_pass"] = sums.get("bound_two_pass", 0.0) + bound_old
    return sums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--path", action="store_true")
    ap.add_argument("--kernels", default=",".join(NAMES))
    ap.add_argument("--csrc", action="append")
    ap.add_argument("--devices", default="0")
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--two-pass")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_contract: CUDA is not available", file=sys.stderr)
        return 1
    names = args.kernels.split(",")
    if not set(names) <= set(NAMES):
        ap.error(f"--kernels: a subset of {','.join(NAMES)}")
    devices = [int(d) for d in args.devices.split(",")]
    cs.log(cs.card_line())
    if args.compare:
        dev = torch.device("cuda", devices[0])
        csrcs = args.csrc or [os.path.join(_ROOT, "aejpeg_tpu_torch", "csrc")]
        cs.log(f"dct2d from {csrcs} against the two-pass route of "
               f"{args.two_pass} and the cuBLAS route, {ROUNDS} rounds")
        with torch.cuda.device(dev):
            cs.warm_card(dev)
            sums = compare_routes(dev, csrcs, args.two_pass)
        print(json.dumps({"compare_summary": sums}), flush=True)
        return 0
    stage_a = {}     # stage A's bilateral calls, recorded once a card
    for csrc in args.csrc or [None]:
        if csrc is not None:
            use_sources(csrc)
        for d in devices:
            dev = torch.device("cuda", d)
            cs.log(f"sources: {csrc or 'aejpeg_tpu_torch/csrc'}, {dev}")
            try:
                with torch.cuda.device(dev):
                    if not args.quick:
                        cs.warm_card(dev)
                    summary = cs.check_kernels(dev, names, quick=args.quick,
                                               path=args.path)
                    if "bilateral" in names and not args.quick:
                        if d not in stage_a:
                            stage_a[d] = stage_a_calls(dev)
                        summary["bilateral_stage_a"] = stage_a_bilateral(
                            stage_a[d])
                        summary["bilateral_sass"] = bilateral_sass()
            except (AssertionError, RuntimeError) as e:
                print(json.dumps({"csrc": csrc, "device": d, "ok": False,
                                  "error": str(e)}), flush=True)
                return 1
            print(json.dumps({"csrc": csrc, "device": d, "ok": True,
                              "kernels": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
