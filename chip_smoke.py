#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (aejpeg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card and build: the card's name and power limit, then the CUDA
     kernels (nvcc, sm_90a) and the native host library (g++), with their
     build times;
  2. kernels against their plain PyTorch versions on the card, at the
     shapes the main path gives them (u8_to_unit also at every u8 value,
     odd sizes and offset pointers; f32_to_unit also at CLIC's 16 x
     2048x1365, with its flags on k/255 images holding 0.5, 1e-9, a
     subnormal, NaN, infinities, values out of [0, 1] and values whose
     product with 255 is a half, in place and at an offset pointer; the CLAHE gather also at shapes with
     partial column strips and row bands), with times (CUDA events around
     25 back-to-back calls; and the kernel's own device time per call,
     from torch.profiler over the same loop, which tells a launch-bound
     kernel from a host-bound one), the plain version's time, one PyTorch
     library call's time where one computes the same function (bitwise equal
     first, for u8_to_unit), and the bound (least time the card could
     take: the larger of the bytes moved over the memory rate and the
     operations over the float32 rate);
  3. the main path at full size: 42 synthetic 512x768 RGB images (plus 2
     of 200x300, a shape that takes the CLAHE fallback kernel) through
     encode_stream -> decode_stream on cuda with the bench config (YCoCg,
     q20-80, blocks 4-128, native sparse entropy coder): every blob
     decodes, PSNR > 25 dB, every kernel launched;
  4. the card against the CPU: the bilateral filter on 96 random uint8
     planes; on 2 images, stage A's planes and edge levels, stage B's
     tables (the forward DCT with its quantize epilogue) and stage D's
     decoded pixels (the inverse DCT with its canvas-sum and denormalize
     epilogue, the upsample) bitwise equal, containers byte-identical; and
     batch-vs-single container identity on the card; encode_batch's card
     route (float32 upload, f32_to_unit) against the host's route on the
     card (uint8 upload, u8_to_unit), containers byte-identical on 42 x
     512x768 and 16 x 1365x2048, marked u8-exact and not, with each
     route's push time;
  5. encode and decode Mpix/s of the 42-image batch (median of 5 warm
     batches) with each stage's time;
  6. a torch.profiler trace of one warm batch each way: device-busy share
     and the ops with the most device time;
  7. each of the seven colour spaces through encode_batch -> decode_batch
     on 8 x 512x768 on the card (PSNR > 25 dB, encode/decode Mpix/s, the
     kernels it launched), then the card against the CPU on one image per
     space under phase 4's checks; on float inputs, every space's
     conversion both ways on 1,000,000 pixels and on 4,096 subnormal and
     4,096 near-subnormal ones, and encode_batch of 2 x 512x768 per space,
     card bitwise (byte-identical) to the CPU;
  8. the per-image Codec (encode_batch / decode_batch on one image) on
     the card, 4 x 512x768, YCoCg q20-80 blocks 4-128 and YCbCr 8x8:
     containers payload-identical to encode_batch's of the 4 on the card,
     decodes bitwise decode_batch's, mean per-image compress / decompress
     ms, the kernels it launched;
  9. EvaluationMetrics (psnr, ssim, ms_ssim, and LPIPS with random weights
     at AlexNet's widths) on the card against the CPU, within 1e-5
     (relative for LPIPS);
 10. the batched metric sweep (BatchedMetricsSweep) on 16 x 512x768 + 2 x
     200x300 PNGs written and read back by the port's image I/O, YCbCr and
     ICtCp x 3 quality x 6 block ranges, LPIPS on: every row present, no
     error, every kernel launched; its wall time, image-combos/s and
     Mpix-combos/s, its stage split (a second run with timings=, each stage
     synchronized, the metrics each on their own); 4 combos
     per space against encode_batch -> decode_batch -> EvaluationMetrics on
     the card (ratio strings identical, metrics within the JAX package's
     own bounds 2e-2 dB / 2e-3, LPIPS within 1e-4); 2 images x 2 combos
     against the sweep on the CPU (ratios identical, metrics within 1e-4);
 11. the CLI (`python -m aejpeg_tpu_torch.cli`) in subprocesses on the
     default device: compress 2 PNGs (containers byte-identical to
     encode_stream in process), info, decompress (>= 25 dB), preview;
 12. the speed table, the quadtree visualizer (leaf counts card == CPU) and
     the normalization constants (YCoCg card vs CPU within 1e-6 relative;
     all seven spaces against the shipped constants);
 13. the mesh: encode_batch / decode_batch with mesh= over a (2, 1) mesh
     naming cuda:0 twice (and, with several cards, over 2, 4, ... of them),
     on phase 3's images: containers byte-identical to the single-device
     path's and decodes bitwise equal to it (a shard's dots take the
     whole batch's order: ops/xla_dot), 41
     images refused, encode/decode Mpix/s of mesh and single device (median
     of 3), every kernel launched;
 14. multihost: two ranks in subprocesses rendezvous over gloo on
     localhost, each runs encode_stream_sharded then decode_stream_sharded
     on its half of 12 x 512x768 on the card: the union of containers
     byte-identical to encode_stream in process, decodes bitwise equal to
     decode_stream's;
 15. `python -m aejpeg_tpu_torch.cli bench` in a subprocess on 14 512x768
     BMPs written by the port's I/O: its JSON line parsed, value > 0, PSNR
     > 25 dB, its stage lines echoed;
 16. the GUI's jobs without Tk: the preview job (ratio > 1, > 25 dB), the
     compress job (sibling .ajpg files byte-identical to encode_batch) and
     the decompress job (images written back, > 25 dB);
 17. images whose layers are smaller than the largest block (quadtree
     roots below it): every kernel bitwise equal to its plain version at
     their plane shapes (1x1 to 96x128, 64x64 through the CLAHE gather);
     8 such images through encode_batch -> decode_batch on the card, at
     entropy levels 9 and -1 (containers byte-identical to the CPU Codec's
     and the CPU encode_batch's, decodes within 1e-5 of the CPU Codec's,
     every kernel launched) (dct2d at their padded planes, both
     directions, s = 4 and the largest block that tiles them); the CLI's
     compress of a 64x64 PNG at its
     defaults (byte-identical to the CPU Codec); the sweep over a 96x128
     group (each combo stops only at MS-SSIM's 161-pixel bound; with
     MS-SSIM stubbed every row is written, ratios equal to encode_batch's,
     PSNR and SSIM within phase 10's tolerances of the decode path);
 18. dense resizes: resize2d at the odd, narrow and upscaled shapes the
     CPU tests hold bitwise to jax.jit, both kinds, on float planes, card
     bitwise equal to the CPU; two u8 and two float images at 505x632
     (YCoCg) and 128x192 (ICtCp) through encode_batch (containers
     byte-identical card == CPU) and decode_batch (bitwise card == CPU).

Phase 2 also holds the port's own kernel, csrc/banded_resize.cu (the
reference's einsums summed in XLA's CPU order; no Pallas counterpart),
through both its entry points, bitwise to their plain versions:
banded_resize (the dense resize) at the shapes of decode's upsample in
phase 3 (a 512x768 batch and two 200x300 images), at phase 18's odd and
narrow shapes, on thin planes (XLA's column groups, the no-FMA last
columns) and on planes at 2**-126; dct2d (both passes of the DCTs
in one launch) at the bench config's planes for every block size 4-128,
forward with the quantize epilogue and inverse with the decoder's
epilogue (the times the kernel line sums), at every s 2-128 in both
directions with every epilogue, at the Codec's per-block buckets (int32
levels), and on planes of tiny, subnormal, -0 and mixed-sign values;
both on planes of NaNs of many payloads and infinities, payloads
included.  The bilateral kernel (csrc/bilateral.cu) takes the unpadded
planes at the Canny stack's shapes, edge shapes (1x1, 1xN, Nx1, 3x4) and
planes of more tiles than the card holds CTAs at once.  The hysteresis
kernel (csrc/hysteresis.cu) takes the strong and weak maps stage A hands
it for the flagship cell's images (benchmark/harness/images.py: the luma
and chroma groups and one plane of each, the times the kernel line sums),
the adversarial maps of `hysteresis_maps` (spirals, a serpentine, chains
across 32-pixel words, no strong pixel, every pixel weak, chains across
the band edges of a 2048x1365 plane and one its whole height) and the NMS
map of a 2048x1365 image, the last two on its banded path; each case logs
the passes and rounds it took.  Its library
time is the route each replaced: torch.matmul for the resize, cuBLAS
products with the copies and the eager quantize or denormalize for the
DCTs.

Prints the kernels as one JSON line (with their launches in phase 3, in
the sweep, on the mesh, in phase 17 and in phase 18), the card's name and
power limit,
the whole script's time, and
last {"ok": true, "device": {...}}.  Exits non-zero without that line when
CUDA is unavailable or any phase fails.
"""

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

BATCH = 42
H, W = 512, 768
SMALL = (200, 300)        # CLAHE fallback (tile heights 50 and 25)
QUALITY = (20, 80)
BLOCKS = (4, 128)
REPS = 25                 # kernel timing repetitions
WARM_S = 20               # seconds of load before the kernels are timed
BATCH_REPS = 5            # warm batches timed in phase 5
SPACE_BATCH = 8           # images per colour space in phase 7
SPACE_REPS = 3            # warm batches timed per space in phase 7
FLOAT_PIXELS = 1_000_000  # float pixels per space, card vs CPU, in phase 7
MESH_REPS = 3             # warm batches timed per path in phase 13
MH_IMAGES = 12            # images split over the two ranks of phase 14
BENCH_DISTINCT = 14       # BMPs the bench of phase 15 reads (x3 replicated)
GUI_IMAGES = 4            # images through the GUI's compress job
CODEC_IMAGES = 4          # images through the per-image Codec in phase 8
SWEEP_IMAGES = 16         # 512x768 images of the phase-10 sweep
SWEEP_SPACES = ("YCbCr", "ICtCp")
SWEEP_QUALITY_VALUES = (25, 75)        # 3 quality ranges
SWEEP_BLOCK_VALUES = (4, 16, 128)      # 6 block ranges
SWEEP_CHECK_QUALITY = (25, 75)         # combos held to the decode path
SWEEP_CHECK_BLOCKS = ((16, 16), (4, 16), (16, 128), (4, 128))
SWEEP_CPU_COMBOS = ([(25, 75)], [(4, 16), (16, 128)])
# phase 17: images whose quadtree roots lie below the largest block
# (space, blocks, image shape), and the plane shapes their layers give the
# kernels (64x64 takes the CLAHE gather)
SMALL_LAYER_CASES = (("YCoCg", (4, 128), (96, 128)),
                     ("YCoCg", (4, 64), (64, 64)), ("YCoCg", (4, 64), (2, 2)),
                     ("YCoCg", (4, 32), (16, 16)), ("YCoCg", (4, 32), (5, 7)),
                     ("YCoCg", (2, 64), (64, 64)),
                     ("YCoCg", (2, 64), (33, 65)),
                     ("ICtCp", (4, 64), (40, 60)))
SMALL_PLANES = ((1, 1), (2, 3), (3, 4), (5, 7), (8, 8), (16, 32), (24, 32),
                (33, 65), (40, 15), (48, 64), (64, 64), (96, 128))
# phase 18: every resize of the dense path the CPU tests hold to jax.jit,
# (source, destination, kind); 4:2:0 chroma of odd sides, 4:1:1 chroma
# under 64 wide, one dense axis beside a fast one, and upscales
DENSE_RESIZES = (((37, 53), (19, 27), "area"),
                 ((128, 192), (128, 48), "area"),
                 ((101, 256), (51, 128), "area"),
                 ((19, 27), (37, 53), "linear"),
                 ((505, 632), (253, 316), "area"),
                 ((482, 627), (241, 314), "area"),
                 ((241, 314), (482, 627), "linear"),
                 ((256, 384), (512, 768), "linear"),
                 ((600, 10), (1200, 20), "linear"),
                 ((800, 5), (1600, 10), "linear"),
                 ((10, 600), (20, 1200), "linear"),
                 ((512, 8), (1024, 16), "linear"))
# and the images phase 18 encodes, (space, shape); 1200x20: decode's
# upsample is a thin dot (m = the chroma width), in XLA's column groups
DENSE_IMAGES = (("YCoCg", (505, 632)), ("ICtCp", (128, 192)),
                ("YCoCg", (1200, 20)))
H100_BYTES_PER_S = 3.35e12
H100_FP32_PER_S = 67e12   # CUDA-core rate, also used for the integer ops


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def synth_images(n, h, w, seed):
    """u8-exact RGB test images: gradients, hard-edged shapes, noise."""
    from aejpeg_tpu_torch import ImageData
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        f = rng.uniform(4, 40, 3)
        img = np.stack([0.5 + 0.4 * np.sin(x / f[0] + i) * np.cos(y / f[1]),
                        (x + y) / (h + w),
                        0.5 + 0.3 * np.cos((x - y) / f[2])], -1)
        for _ in range(6):
            y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
            dy, dx = rng.integers(8, h // 3), rng.integers(8, w // 3)
            img[y0:y0 + dy, x0:x0 + dx] = rng.random(3)
        img += rng.normal(0, 0.02, img.shape)
        u8 = np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)
        im = ImageData.from_array(u8.astype(np.float32) / 255.0,
                                  extension=".png")
        im.u8_exact = True
        out.append(im)
    return out


def cuda_ms(fn, reps=REPS):
    """Time of one fn() on the card: CUDA events around `reps` back-to-back
    calls after 3 warm-ups, over `reps` (the host's launch work overlaps
    the card's)."""
    import torch
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def sm_clock():
    """The card's SM clock now, as nvidia-smi reports it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()


def warm_card(dev, seconds=WARM_S):
    """float32 products on the card for `seconds`, so that the kernels are
    timed at the clocks the card works at (on an H100 80GB HBM3 the same
    kernel's time fell by up to a third over the first minutes of load).
    Logs the SM clock before and after."""
    import torch
    before = sm_clock()
    a = torch.rand((4096, 4096), device=dev)
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        for _ in range(20):
            b = torch.mm(a, a)
        torch.cuda.synchronize(dev)
    del b
    log(f"  card warmed {seconds} s: SM clock {before} -> {sm_clock()}")


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_ms(fn, kernel, reps=REPS):
    """Device time of one fn() in the kernel named `kernel`: torch.profiler
    over `reps` back-to-back calls (as cuda_ms makes them); per kernel
    whose name holds `kernel`, its device time over the launches the trace
    recorded (the profiler drops records now and then: dividing by `reps`
    undercounted by up to a third), summed over those kernels (each
    launches once a call).  A trace that holds no such kernel is taken
    again, once; None when that one holds none either."""
    import torch
    from torch.profiler import ProfilerActivity
    for _ in range(2):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.key]
        if hits:
            break
    if not hits:
        return None
    counts = [e.count for e in hits]
    if any(c != reps for c in counts):
        log(f"    profiler: {counts} of {reps} launches of {kernel} recorded")
    return sum(_dev_us(e) / max(e.count, 1) for e in hits) / 1e3


# ------------------------------------------------------------------ phase 2


# the bilateral kernel's tile (csrc/bilateral.cu: 128 columns, 8 warps of
# kRows = 4 rows)
BILATERAL_TILE = (32, 128)


def bilateral_tiles(p, h, w):
    th, tw = BILATERAL_TILE
    return p * -(-h // th) * -(-w // tw)


def kernel_cases(dev):
    """Inputs at the main path's shapes: per kernel, [(label, args, plain,
    kernel, library, bytes, ops, on_path)].  The CLAHE kernels take the
    uint8 planes the main path holds.  bytes: each input read once,
    each output written once; ops: one per histogram value, 9 flops per
    gather pixel (three mul + three FMAs), 8 per fallback pixel (four FMAs),
    one table lookup per u8 value.  on_path: the shape is one the phase-3
    run gives the kernel (its times are summed); the others are checked for
    correctness only."""
    import torch
    from aejpeg_tpu_torch.ops import canny, kernels as K
    g = torch.Generator(device="cpu").manual_seed(0)
    cases = {"histogram256": [], "clahe_apply_gather": [],
             "clahe_lut_apply": [], "u8_to_unit": [], "f32_to_unit": [],
             "banded_resize": [], "dct2d": [], "bilateral": [],
             "hysteresis": []}

    def ints(*shape):
        return torch.randint(0, 256, shape, generator=g,
                             dtype=torch.int32).to(dev)

    def bytes_(*shape):
        return torch.randint(0, 256, shape, generator=g,
                             dtype=torch.uint8).to(dev)

    # CLAHE tiles (4x4 grid) and percentile rows (8 per plane), luma 512x768
    # and chroma 256x384, for a 42-image batch
    for p, th, tw in ((BATCH, 128, 192), (2 * BATCH, 64, 96)):
        for label, vals in (
                (f"clahe tiles ({p * 16}, {th * tw})", ints(p, 16, th * tw)),
                (f"percentile rows ({p * 8}, {th * tw * 2})",
                 ints(p, 8, th * tw * 2))):
            rows, n = vals.shape[0] * vals.shape[1], vals.shape[2]
            flat = vals.reshape(rows, n)
            base = torch.arange(rows, device=dev,
                                dtype=torch.int32)[:, None] * 256

            def lib(flat=flat, base=base, rows=rows):
                return torch.bincount((flat + base).reshape(-1),
                                      minlength=rows * 256)
            cases["histogram256"].append(
                (label, (vals,), K.histogram256_plain, K.histogram256, lib,
                 vals.numel() * 4 + rows * 256 * 4, vals.numel(), True))

    def luts(p, gh, gw):
        return torch.randint(0, 256, (p, gh, gw, 256), generator=g).to(
            torch.float32).to(dev)

    # the main path's luma and chroma planes; then partial column strips
    # and row bands (4-byte groups), and a width that is not a multiple of
    # 4 (scalar loads and stores)
    for p, h, w, on_path in ((BATCH, H, W, True),
                             (2 * BATCH, H // 2, W // 2, True),
                             (3, 125, 200, False), (2, 64, 202, False)):
        th, tw = -(-h // 4), -(-w // 4)
        words = (luts(p, 4, 4).to(torch.uint8).permute(0, 1, 3, 2)
                 .contiguous().view(torch.int32).squeeze(-1))
        vecs = [torch.as_tensor(a, device=dev)
                for a in canny._clahe_interp_vectors(h, w, th, tw, 4, 4)]
        args = (bytes_(p, h, w), words, *vecs)
        nbytes = (p * h * w * 5 + words.numel() * 4
                  + sum(v.numel() * 4 for v in vecs))
        cases["clahe_apply_gather"].append(
            (f"({p}, {h}, {w})", args,
             lambda *a, th=th: K.clahe_apply_gather_plain(*a, th=th),
             lambda *a, th=th: K.clahe_apply_gather(*a, th=th), None,
             nbytes, 9 * p * h * w, on_path))

    sh, sw = SMALL
    for p, h, w in ((2, sh, sw), (4, sh // 2, sw // 2), (2, 96, 128),
                    (2, 37, 53)):
        th, tw = -(-h // 4), -(-w // 4)
        iy, ix, wts = [torch.as_tensor(a, device=dev)
                       for a in canny._clahe_taps(h, w, th, tw, 4, 4)]
        args = (bytes_(p, h, w), luts(p, 4, 4).reshape(p, 16, 256), iy, ix,
                wts)
        nbytes = (p * h * w * 5 + p * 16 * 256 * 4 + iy.numel() * 4
                  + ix.numel() * 4 + wts.numel() * 4)
        cases["clahe_lut_apply"].append(
            (f"({p}, {h}, {w})", args,
             lambda *a: K.clahe_lut_apply_plain(*a, gw=4),
             lambda *a: K.clahe_lut_apply(*a, gw=4), None, nbytes,
             8 * p * h * w, h in (sh, sh // 2)))

    # the stage-A load of one batch; every u8 value; sizes that are not a
    # multiple of 16; a flat run whose first byte is 4 past a 16-byte
    # boundary (vector body after a 12-byte head) and one 1 past it (the
    # output cannot align with it: scalar path only)
    run = bytes_(1 << 20)
    t255 = torch.tensor(255.0, dtype=torch.float32, device=dev)
    for label, x, on_path in (
            (f"({BATCH}, {H}, {W}, 3)", bytes_(BATCH, H, W, 3), True),
            ("every value (256,)", torch.arange(256, device=dev).to(
                torch.uint8), False),
            ("(37, 53, 3)", bytes_(37, 53, 3), False),
            ("(7, 13)", bytes_(7, 13), False),
            ("offset 4, (1000003,)", run[4:4 + 1000003], False),
            ("offset 1, (1000003,)", run[1:1 + 1000003], False)):
        def lib(x=x):
            return torch.div(x, t255)
        if not torch.equal(lib().view(torch.int32),
                           K.u8_to_unit_plain(x).view(torch.int32)):
            raise AssertionError(f"u8_to_unit {label}: torch.div by a "
                                 "0-dim tensor is not bitwise x/255")
        cases["u8_to_unit"].append(
            (label, (x,), K.u8_to_unit_plain, K.u8_to_unit, lib,
             x.numel() * 5, x.numel(), on_path))

    # f32_to_unit: the float32 batches encode_batch's card route uploads
    # (CLIC's 16 x 2048x1365 and phase 3's 42, timed; out of place, as the
    # in-place call moves the same bytes); k/255 images with a value that
    # is none (0.5, 1e-9, a subnormal, NaN, infinities, -0.25, 1.5, products
    # at a half) in the last, at 37x53, 1x1 and 512x768, 1 and 3 images,
    # with the flags;
    # the in-place call; a start 4 bytes past a 16-byte boundary (scalar)
    def units(*shape):
        return K.u8_to_unit_plain(bytes_(*shape))

    def unit(x):
        return K.f32_to_unit(x)[0]

    def unit_plain(x):
        return K.f32_to_unit_plain(x)[0]

    def flagged(fn):
        def run(x):
            u, flags = fn(x, check=True)
            return torch.cat((u.reshape(-1).view(torch.int32), flags))
        return run

    def in_place(x):
        y = x.clone()
        return K.f32_to_unit(y, out=y)[0]

    specials = {"k/255": [], "0.5": [0.5], "1e-9": [1e-9],
                "subnormal": [1e-40], "NaN": [float("nan")],
                "infinities": [float("inf"), -float("inf")],
                "out of [0, 1]": [-0.25, 1.5],
                # x * 255 = 0.5 and 254.5 exactly: half to even
                "halves": [float(np.float32(0.5 / 255)),
                           float(np.float32(254.5 / 255))]}
    f32_cases = [(f"({n}, {h}, {w}, 3)", units(n, h, w, 3), unit,
                  unit_plain, True) for n, h, w in ((16, 2048, 1365),
                                                    (BATCH, H, W))]
    for n, h, w in ((1, 37, 53), (3, 37, 53), (1, 1, 1), (3, 1, 1),
                    (1, H, W), (3, H, W)):
        for what, vals in specials.items():
            x = units(n, h, w, 3)
            last = x[-1].view(-1)
            for j, v in enumerate(vals):
                last[j * (last.numel() - 1)] = v
            f32_cases.append((f"({n}, {h}, {w}, 3) {what}, flags", x,
                              flagged(K.f32_to_unit),
                              flagged(K.f32_to_unit_plain), False))
    x = units(3, 37, 53, 3)
    x[1].view(-1)[7] = 0.5
    f32_cases.append(("(3, 37, 53, 3) 0.5 in the middle one, in place", x,
                      in_place, unit_plain, False))
    f32_cases.append(("offset 4, (1000003,)",
                      units(1000007)[1:1000004].reshape(1, -1), unit,
                      unit_plain, False))
    for label, x, kern, plain, on_path in f32_cases:
        cases["f32_to_unit"].append((label, (x,), plain, kern, None,
                                     x.numel() * 8, 2 * x.numel(),
                                     on_path))

    # decode's chroma upsample as phase 3 sends it (one chroma channel of
    # a batch a call, rows then columns): a 512x768 batch and the two
    # 200x300 images; then both axes of the odd and narrow shapes of
    # phase 18, on random planes and on planes at 2**-126 (the flushes)
    for p, (h, w), dst, kind, on_path, tiny in (
            ((BATCH, (H // 2, W // 2), (H, W), "linear", True, False),
             (2, (SMALL[0] // 2, SMALL[1] // 2), SMALL, "linear", True,
              False))
            + tuple((2, src, dst, kind, False, tiny)
                    for tiny in (False, True)
                    for src, dst, kind in DENSE_RESIZES[:4])):
        make = _tiny_planes if tiny else torch.rand
        x = make((p, h, w), generator=g).to(dev)
        y = make((p, dst[0], w), generator=g).to(dev)
        for axis, inp in ((1, x), (2, y)):
            cases["banded_resize"].append(
                _banded_case(p, inp, axis, dst[axis - 1], kind, on_path,
                             " at 2**-126" if tiny else ""))
    # thin planes: XLA's column groups at m = 10 (decode's upsample of a
    # 1200x20 image), and at m = 2 the last 8 columns, which sum without
    # FMAs (ops/xla_dot.xla_dot_order); then NaNs of many payloads and
    # infinities, bitwise (XLA's NaN of each result, kernels.nan_model)
    for p, (h, w), dst, kind in ((1, (600, 10), 1200, "linear"),
                                 (2, (1100, 1), 520, "area")):
        for note, make in ((" (thin)", torch.rand),
                           (" (thin, NaN payloads)", non_finite_planes)):
            cases["banded_resize"].append(_banded_case(
                p, make((p, h, w), generator=g).to(dev), 1, dst, kind,
                False, note))
    for src, dst, kind in DENSE_RESIZES[:4]:
        x = non_finite_planes((2, *src), g).to(dev)
        y = non_finite_planes((2, dst[0], src[1]), g).to(dev)
        for axis, inp in ((1, x), (2, y)):
            cases["banded_resize"].append(_banded_case(
                2, inp, axis, dst[axis - 1], kind, False,
                " (NaN payloads)"))
    cases["dct2d"] = dct_cases(dev, g)
    cases["hysteresis"] = hysteresis_cases(dev)
    # the Canny stack's planes as phase 3 sends them (luma and chroma of
    # both batches: the luma batch alone is more CTAs than the card holds
    # at once), then edge shapes (1x1, 1xN, Nx1, 3x4, planes narrower than
    # the disk), odd shapes and a width that is not a multiple of 4 over
    # several tiles (edge tiles, unaligned rows); bytes: the planes read
    # once, the output written once, the colour table; ops: 3 FP32
    # operations a tap (the FMA's two, the denominator's add) and 3 a pixel
    space = canny._bilateral_taps(5, 75.0, 75.0)
    colour = canny._color_weights(75.0, dev)
    taps = len(space)
    for p, h, w, on_path in ((BATCH, H, W, True),
                             (2 * BATCH, H // 2, W // 2, True),
                             (2, *SMALL, True),
                             (4, SMALL[0] // 2, SMALL[1] // 2, True),
                             (2, 1, 1, False), (2, 1, 300, False),
                             (2, 200, 1, False), (2, 3, 4, False),
                             (3, 37, 53, False), (2, 130, 517, False)):
        cases["bilateral"].append(
            (f"({p}, {h}, {w}), {bilateral_tiles(p, h, w)} tiles",
             (bytes_(p, h, w),),
             lambda x: K.bilateral_plain(x, colour, space, 2),
             lambda x: K.bilateral(x, colour, space, 2), None,
             2 * p * h * w + 256 * 4, (3 * taps + 3) * p * h * w, on_path))
    return cases


# the H100's shared memory a block may opt in to (the hysteresis kernel's
# budget there: 2048x1365 planes take its banded path in bands of 512 rows)
H100_SMEM_OPTIN = 232448
# widths whose rows cross 32-pixel word boundaries in every way
HYST_WIDTHS = (5, 31, 33, 300, 768)


def _spiral(h, w):
    """A rectangular spiral of weak pixels, arms two apart, from the
    outside in: the chain turns up, down, left and right, h * w / 2 long."""
    m = np.zeros((h, w), bool)
    y0, x0, y1, x1 = 0, 0, h - 1, w - 1
    while y0 <= y1 and x0 <= x1:
        m[y0, x0:x1 + 1] = True
        m[y0:y1 + 1, x1] = True
        if y1 - y0 >= 2:
            m[y1, x0:x1 + 1] = True
        if x1 - x0 >= 2:
            m[y0 + 2:y1 + 1, x0] = True
            if y1 - y0 >= 4:
                m[y0 + 2, x0 + 1] = True     # on to the next ring
        y0, x0, y1, x1 = y0 + 2, x0 + 2, y1 - 2, x1 - 2
    return m


def _serpentine(h, w):
    """Vertical weak runs in every other column, joined by one diagonal
    pixel alternately at the bottom and the top: one chain that crosses the
    plane's height w / 2 times."""
    m = np.zeros((h, w), bool)
    for x in range(0, w, 2):
        m[1:h - 1, x] = True
        if x + 2 < w:
            m[h - 1 if x % 4 == 0 else 0, x + 1] = True
    return m


def _word_rows(h, w):
    """Weak chains across the 32-pixel words of a row of w: full rows seeded
    at the right end and at the left; runs broken at each word's last
    column, every other gap bridged by a diagonal pixel below; a zigzag
    chain over 8 rows; an isolated run that must stay off.  (strong,
    weak), h >= 24."""
    s = np.zeros((h, w), bool)
    k = np.zeros((h, w), bool)
    k[2] = True
    s[2, w - 1] = True
    k[5] = True
    s[5, 0] = True
    x = np.arange(w)
    k[8] = x % 32 != 31
    k[9] = (x % 32 == 31) & ((x // 32) % 2 == 0)
    s[8, 0] = True
    tri = np.abs((x % 14) - 7)
    k[12 + tri, x] = True
    s[12 + tri[-1], w - 1] = True
    k[22, w // 3:] = True
    return s, k


def _band_edges(h, w, rows, long_chain):
    """Short chains across each band edge of a plane cut into bands of
    `rows` rows: vertical ones seeded below the edge and above it, a
    diagonal, and a chain that turns along the edge row across the words;
    long_chain: also one vertical chain the plane's height, seeded at its
    foot.  (strong, weak)."""
    s = np.zeros((h, w), bool)
    k = np.zeros((h, w), bool)
    for e in range(rows, h, rows):
        lo, hi = max(e - 12, 0), min(e + 12, h - 1)
        k[lo:hi + 1, 7] = True
        s[hi, 7] = True
        k[lo:hi + 1, 100] = True
        s[lo, 100] = True
        for i in range(lo, hi + 1):
            k[i, 200 + i - lo] = True
        s[lo, 200] = True
        k[lo:e + 1, 500] = True
        k[e, 500:min(w, 900)] = True
        s[lo, 500] = True
    if long_chain:
        k[:, w - 3] = True
        s[h - 1, w - 3] = True
    return s, k


def hysteresis_maps(band_shape=(2048, 1365), budget=H100_SMEM_OPTIN,
                    long_chain=False):
    """The hysteresis's adversarial cases, [(label, strong, weak)] of (P, H,
    W) numpy bool maps: spirals and a serpentine fed from one strong
    pixel (and a spiral that no strong pixel feeds), chains across 32-pixel
    words at each of HYST_WIDTHS beside random maps of those widths, no
    strong pixel, every pixel weak, and chains across the band edges of a
    plane of `band_shape` that the card cuts into bands (its rows from
    `budget` bytes of shared memory)."""
    from aejpeg_tpu_torch.ops.kernels import hysteresis_band_rows
    rng = np.random.default_rng(15)
    out = []
    sp = _spiral(61, 67)
    fed = np.zeros_like(sp)
    fed[0, 0] = True
    out.append(("spiral 61x67", np.stack([fed, np.zeros_like(sp)]),
                np.stack([sp, sp])))
    sp = _spiral(40, 300)
    ys, xs = np.nonzero(sp)
    i = np.argmin(np.abs(ys - 20) * 300 + np.abs(xs - 150))
    fed = np.zeros_like(sp)
    fed[ys[i], xs[i]] = True                 # the spiral's inner end
    out.append(("spiral 40x300, fed inside", fed[None], sp[None]))
    se = _serpentine(64, 41)
    fed = np.zeros_like(se)
    fed[1, 0] = True
    out.append(("serpentine 64x41", fed[None], se[None]))
    for w in HYST_WIDTHS:
        s, k = _word_rows(24, w)
        rk = rng.random((24, w)) < 0.45
        rs = rk & (rng.random((24, w)) < 0.01)
        out.append((f"word crossings (2, 24, {w})", np.stack([s, rs]),
                    np.stack([k, rk])))
    rk = rng.random((3, 37, 53)) < 0.5
    out.append(("no strong (3, 37, 53)", np.zeros_like(rk), rk))
    full = np.ones((3, 33, 70), bool)
    one = np.zeros_like(full)
    one[0, 16, 35] = True
    one[2] = True
    out.append(("every pixel weak (3, 33, 70)", one, full))
    h, w = band_shape
    s, k = _band_edges(h, w, hysteresis_band_rows(h, w, budget), long_chain)
    out.append((f"band edges (1, {h}, {w})", s[None], k[None]))
    return out


def _nms_maps(run):
    """The (strong, weak) maps the Canny stack hands the hysteresis while
    run() runs, in call order."""
    from aejpeg_tpu_torch.ops import canny
    real, calls = canny.hysteresis, []

    def record(strong, weak):
        calls.append((strong.clone(), weak.clone()))
        return real(strong, weak)
    canny.hysteresis = record
    try:
        run()
    finally:
        canny.hysteresis = real
    return calls


def hysteresis_cases(dev):
    """kernel_cases' hysteresis entries.  On the path: the maps stage A
    hands the kernel for 42 of the flagship cell's images
    (benchmark/harness/images.py, seed 2147483801), the luma group (42,
    512, 768) and the chroma group (84, 256, 384), and the first plane of
    each (the preview's one-plane calls).  Off it: `hysteresis_maps` with
    the card's budget (the band-edge plane with a chain its whole height)
    and the NMS map of a 2048x1365 image's luma and 8 of stage A's luma
    maps tiled to 2048x1365, all three cut into bands.
    bytes: the two bool maps read once, the float32 map written once."""
    import torch
    import aejpeg_tpu_torch as at
    from aejpeg_tpu_torch.ops import canny, kernels as K
    from benchmark.harness import images
    imgs = images.to_host_images(images.synth(BATCH, H, W, 2147483801, dev),
                                 ".png", at.ImageData)
    cfg = at.CodecConfig("YCoCg", QUALITY, BLOCKS, entropy_level=-1)
    (ls, lk), (cs_, ck) = _nms_maps(
        lambda: at.encode_batch(imgs, cfg, device=dev))
    photo = images.synth(1, 2048, 1365, 2147483802, dev)
    luma = photo.to(torch.float32).mean(-1) / 255.0
    (ps, pk), = _nms_maps(lambda: canny.canny(luma))
    maps = [(f"stage A luma {tuple(ls.shape)}", ls, lk, True),
            (f"stage A chroma {tuple(cs_.shape)}", cs_, ck, True),
            (f"stage A luma plane {tuple(ls[:1].shape)}",
             ls[:1].contiguous(), lk[:1].contiguous(), True),
            (f"stage A chroma plane {tuple(cs_[:1].shape)}",
             cs_[:1].contiguous(), ck[:1].contiguous(), True)]
    for label, s, k in hysteresis_maps(budget=K._smem_budget(dev),
                                       long_chain=True):
        maps.append((label, torch.from_numpy(s).to(dev),
                     torch.from_numpy(k).to(dev), False))
    maps.append((f"NMS map of a 2048x1365 image {tuple(ps.shape)}", ps, pk,
                 False))
    if ls.shape[0] >= 8:        # denser: 8 of stage A's planes side by side
        tile = [m[:8].reshape(4, 2, H, W).permute(0, 2, 1, 3)
                .reshape(1, 4 * H, 2 * W)[..., :1365].contiguous()
                for m in (ls, lk)]
        maps.append((f"8 stage A luma planes tiled {tuple(tile[0].shape)}",
                     *tile, False))
    return [(label, (s, k),
             lambda a, b: K.hysteresis_plain(a, b).to(torch.float32),
             K.hysteresis, None, 6 * s.numel(), 0, on_path)
            for label, s, k, on_path in maps]


def _quant_tables(s, layers, dev):
    """(hi, lo) reciprocal tables of `layers` layers at size s, as the
    bench config builds them (YCoCg, q20-80)."""
    import torch
    from aejpeg_tpu_torch.codec.tables import quant_tables_np
    import aejpeg_tpu_torch as at
    hi3, lo3, q3 = quant_tables_np(at.CodecConfig("YCoCg", QUALITY, BLOCKS),
                                   s)
    idx = [0] if layers == 1 else [1, 2]
    return (torch.as_tensor(np.stack([hi3[i] for i in idx]), device=dev),
            torch.as_tensor(np.stack([lo3[i] for i in idx]), device=dev),
            torch.as_tensor(np.stack([q3[i] for i in idx]), device=dev))


def _old_dct_route(x, s, hi, lo, inverse=False, add=None):
    """The route the DCTs took before the port's own DCT kernel, timed as
    the library call:
    cuBLAS products (torch.mm on the blocks' rows, with the .mT and
    permute copies, forward; torch.matmul on the (s, gw * s) slabs,
    inverse), then the eager quantize, int16 cast and zigzag gather
    (forward) or the eager canvas sum and denormalize (inverse)."""
    import torch
    from aejpeg_tpu_torch.ops import dct, zigzag
    d = torch.as_tensor(dct.dct_matrix(s), device=x.device)
    p, ph, pw = x.shape
    gh, gw = ph // s, pw // s
    if inverse:
        y = torch.matmul(d.T, x.view(p, gh, s, gw * s))
        z = torch.matmul(y.view(p, gh, s, gw, s), d)
        return (add + z.reshape(p, ph, pw)) / 1.25 + 0.5
    b = x.reshape(p, gh, s, gw, s).permute(0, 1, 3, 2, 4)
    y = torch.mm(b.mT.reshape(-1, s), d.T).reshape(b.shape).mT
    y = torch.mm(y.reshape(-1, s), d.T).reshape(b.shape)
    layer = hi.shape[0]
    h6 = hi.repeat(p // layer, 1, 1).view(p, 1, 1, s, s)
    l6 = lo.repeat(p // layer, 1, 1).view(p, 1, 1, s, s)
    lv = torch.round(y * h6 + y * l6).to(torch.int32).to(torch.int16)
    zz = zigzag._index_tensor(s, False, x.device)
    return lv.reshape(p, gh * gw, s * s)[:, :, zz]


def dct_cases(dev, g):
    """dct2d entries.  On the path: stage B's forward with the quantize
    epilogue (int16 zigzag rows) and stage D's inverse with the canvas-sum
    and denormalize epilogue, at the bench config's planes (luma (42, 512,
    768), chroma (84, 256, 384)) for every block size 4-128, through the
    path's entry points.  Off the path, on small planes (partial tiles) at
    every s 2-128, both directions, every epilogue: float results, int16
    zigzag levels, int32 levels in raster order over two layers' tables,
    the sum alone, the sum and the denormalize (mid 0 and not); the
    Codec's per-block buckets (64 blocks, int32 levels); planes of tiny,
    subnormal, -0 and mixed-sign values (the flushes) at every s, and of
    NaNs of many payloads and infinities (levels, and floats bitwise,
    payloads included); at every s, planes whose tiles make each persistent CTA
    use both its buffers, with int16, int32 and float epilogues.  bytes:
    each input read once, each output written once (the float32
    intermediate never leaves the chip); ops: 2 flops per tap, s taps per
    output per pass."""
    import torch
    from aejpeg_tpu_torch.ops import dct, kernels as K
    out = []

    def entry(label, x, s, inverse, ep=None, m=None, add=None, lib=None,
              on_path=False, via=None):
        """One case: K.dct2d (or `via`, the path's entry point) against
        K.dct2d_plain on x (and the addend)."""
        ep = dict(ep or {})
        b = dct.band(s, m or x.numel() // s, inverse, dev)
        args = (x,) if add is None else (x, add)

        def epi(a):
            return ep if len(a) == 1 else dict(ep, add=a[1])

        def kern(*a):
            return via(*a) if via else K.dct2d(a[0], b, **epi(a))

        def plain(*a):
            return K.dct2d_plain(a[0], b, **epi(a))
        kern.spec = (b, ep)     # for tools/probe_contract.py's other routes
        quant = ep.get("quant")
        out_bytes = (x.numel() * quant[4].itemsize if quant
                     else x.numel() * 4)
        tables = 2 * quant[0].numel() * 4 if quant else 0
        nbytes = x.numel() * 4 * len(args) + out_bytes + tables
        out.append((label, args, plain, kern, lib, nbytes,
                    4 * s * x.numel(), on_path))

    for p, h, w, layers in ((BATCH, H, W, 1), (2 * BATCH, H // 2, W // 2, 2)):
        x = ((torch.rand((p, h, w), generator=g) - 0.5) * 200).to(dev)
        canvas = ((torch.rand((p, h, w), generator=g) - 0.5) * 50).to(dev)
        rcp = torch.tensor([1 / 1.25, 1 / 1.5][:layers], device=dev)
        mid = torch.tensor([0.5, 0.0][:layers], device=dev)
        for s in (4, 8, 16, 32, 64, 128):
            if h % s or w % s:
                continue
            hi, lo, q = _quant_tables(s, layers, dev)
            entry(f"forward + quantize ({p}, {h}, {w}) s={s}", x, s, False,
                  {"quant": (hi, lo, 1, True, torch.int16)},
                  lib=lambda x=x, s=s, hi=hi, lo=lo: _old_dct_route(
                      x, s, hi, lo),
                  on_path=True,
                  via=lambda x, s=s, hi=hi, lo=lo: dct.dct2_quantize(
                      x, s, hi, lo))
            coef = (torch.round(x / 8) * 8).contiguous()
            entry(f"inverse + sum, denormalize ({p}, {h}, {w}) s={s}", coef,
                  s, True, {"affine": (rcp, mid, 1)}, add=canvas,
                  lib=lambda c=coef, s=s, a=canvas: _old_dct_route(
                      c, s, None, None, inverse=True, add=a),
                  on_path=True,
                  via=lambda c, a, s=s, r=rcp, m=mid: dct.idct2_planes(
                      c, s, add=a, affine=(r, m, 1)))
    for s in (2, 4, 8, 16, 32, 64, 128):
        side = max(s, 32)
        x = ((torch.rand((3, 2 * side, 3 * side), generator=g) - 0.5)
             * 200).to(dev)
        add = ((torch.rand(x.shape, generator=g) - 0.5) * 50).to(dev)
        hi, lo, _ = _quant_tables(s, 1, dev)
        hi2, lo2, _ = _quant_tables(s, 2, dev)
        rcp = torch.tensor([1 / 1.25, 1 / 1.5], device=dev)
        mid = torch.tensor([0.5, 0.0], device=dev)
        shape = tuple(x.shape)
        for inverse in (False, True):
            d = "inverse" if inverse else "forward"
            entry(f"{d} {shape} s={s}", x, s, inverse)
            entry(f"{d} + int16 zigzag levels {shape} s={s}", x, s, inverse,
                  {"quant": (hi, lo, 1, True, torch.int16)})
            entry(f"{d} + int32 raster levels, 2 layers {shape} s={s}", x,
                  s, inverse, {"quant": (hi2, lo2, 2, False, torch.int32)})
            entry(f"{d} + sum {shape} s={s}", x, s, inverse, add=add)
            entry(f"{d} + sum, denormalize (2 layers) {shape} s={s}", x, s,
                  inverse, {"affine": (rcp, mid, 1)}, add=add)
        for name, v in _special_dct_planes((2, 2 * side, 2 * side),
                                           s).items():
            xs = v.to(dev)
            for inverse in (False, True):
                d = "inverse" if inverse else "forward"
                if name == "non-finite":
                    # as levels (a NaN's level is 0), and as floats
                    # bitwise, XLA's NaN payloads included (the kernel
                    # writes them where a result is NaN)
                    entry(f"{d} + int16 levels, {name} planes s={s}", xs, s,
                          inverse, {"quant": (hi, lo, 1, True, torch.int16)})
                    entry(f"{d} + int32 levels, {name} planes s={s}", xs, s,
                          inverse,
                          {"quant": (hi2, lo2, 2, False, torch.int32)})
                    entry(f"{d}, {name} planes (NaN payloads) s={s}", xs, s,
                          inverse)
                    entry(f"{d} + sum, denormalize, {name} planes (NaN "
                          f"payloads) s={s}", xs, s, inverse,
                          {"affine": (rcp[:1], mid[:1], 1)}, add=xs.flip(2))
                    continue
                entry(f"{d}, {name} planes {tuple(xs.shape)} s={s}", xs, s,
                      inverse)
                entry(f"{d} + sum, denormalize, {name} planes s={s}", xs, s,
                      inverse, {"affine": (rcp[:1], mid[:1], 1)}, add=xs)
        xt = _tiny_planes((3, 2 * side, 2 * side), g).to(dev)
        entry(f"forward + int16 levels, 2**-126 planes s={s}", xt, s, False,
              {"quant": (hi, lo, 1, True, torch.int16)})
        entry(f"inverse, 2**-126 planes s={s}", xt, s, True)
        if s >= 4:
            blocks = ((torch.rand((45, s, s), generator=g) - 0.5)
                      * 200).to(dev)
            entry(f"Codec bucket (45 of 64, {s}, {s}) int32", blocks, s,
                  False, {"quant": (hi, lo, 1, True, torch.int32)},
                  m=64 * s,
                  via=lambda b, s=s, hi=hi, lo=lo: dct.dct2_quantize(
                      b, s, hi, lo, dtype=torch.int32, capacity=64))
        # planes of more tiles than twice the most CTAs the card holds at
        # once, so that every persistent CTA computes a tile in each of its
        # two buffers (and writes its levels over a tile buffer twice)
        threads, per_tile = DCT_GEO[s]
        props = torch.cuda.get_device_properties(dev)
        per_sm = max(1, min(32, getattr(
            props, "max_threads_per_multi_processor", 2048) // threads))
        most = props.multi_processor_count * per_sm
        per_plane = (WALK_SIDE // s) ** 2 // per_tile
        p = -(-2 * most // per_plane)
        x = ((torch.rand((p, WALK_SIDE, WALK_SIDE), generator=g) - 0.5)
             * 200).to(dev)
        add = ((torch.rand(x.shape, generator=g) - 0.5) * 50).to(dev)
        shape = tuple(x.shape)
        walk = f"{p * per_plane} tiles, {most} CTAs at most"
        entry(f"forward + int16 zigzag levels {shape} ({walk}) s={s}", x, s,
              False, {"quant": (hi, lo, 1, True, torch.int16)})
        entry(f"forward + int32 raster levels, 2 layers {shape} ({walk}) "
              f"s={s}", x, s, False,
              {"quant": (hi2, lo2, 2, False, torch.int32)})
        entry(f"inverse + sum, denormalize (2 layers) {shape} ({walk}) "
              f"s={s}", x, s, True, {"affine": (rcp, mid, 1)}, add=add)
    return out


# dct2d's threads a CTA and blocks a tile per s (Geo<S> in
# csrc/banded_resize.cu), and the side of the planes whose tiles outnumber
# twice the CTAs the card holds
DCT_GEO = {2: (128, 128), 4: (128, 128), 8: (128, 32), 16: (128, 8),
           32: (128, 2), 64: (128, 1), 128: (512, 1)}
WALK_SIDE = 512


def _special_dct_planes(shape, seed):
    """Planes near 2**-126 with subnormal values, tiny negative ones
    (products flushed to -0), mixed signs with zeros of both signs, and
    random values with NaNs (several a block row, each its own payload and
    sign) and infinities."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    tiny = 2.0 ** -126 * (1 + torch.rand(shape, generator=g))
    tiny[:, ::3] = torch.rand(tiny[:, ::3].shape, generator=g) * 2.0 ** -126
    neg = -(2.0 ** -120) * (1 + torch.rand(shape, generator=g))
    mixed = neg.clone()
    mixed[:, ::2] *= -1
    mixed[:, 1::5] = -0.0
    nan = non_finite_planes(shape, g)
    return {"tiny": tiny, "negative tiny": neg, "mixed": mixed,
            "non-finite": nan}


def non_finite_planes(shape, generator):
    """Random planes with NaNs of random payloads and signs (several in a
    row or block row: which one XLA's dot passes on depends on its order)
    and infinities of both signs."""
    import torch
    x = (torch.rand(shape, generator=generator) - 0.5) * 200
    bits = torch.randint(1, 1 << 22, shape, generator=generator,
                         dtype=torch.int32)
    bits = bits | 0x7F800000 | (torch.randint(0, 2, shape, generator=generator,
                                             dtype=torch.int32) << 31)
    pick = torch.rand(shape, generator=generator)
    x = torch.where(pick < 0.03, bits.view(torch.float32), x)
    x = torch.where((pick >= 0.03) & (pick < 0.04), float("inf"), x)
    x = torch.where((pick >= 0.04) & (pick < 0.05), -float("inf"), x)
    return x


def _tiny_planes(shape, generator):
    """Planes whose resize products and sums fall below 2**-126: the
    first plane in [2**-126, 2**-125), the others a mix of random values,
    2**-126, just above it, subnormals and zeros of both signs."""
    import torch
    x = torch.rand(shape, generator=generator)
    x[0] = 2.0 ** -126 * (1 + x[0])
    special = torch.tensor([2.0 ** -126, -2.0 ** -126,
                            2.0 ** -126 * (1 + 2.0 ** -23), 2.0 ** -130,
                            -2.0 ** -140, 0.0, -0.0], dtype=torch.float32)
    pick = torch.randint(0, 2 * len(special), shape, generator=generator)
    rest = pick[1:] < len(special)
    x[1:] = torch.where(rest, special[pick[1:] % len(special)], x[1:])
    return x


def _banded_case(p, x, axis, dst, kind, on_path, note=""):
    """A kernel_cases entry for one banded_resize axis.  bytes: the input
    read once, the output written once and the band's tables; ops: an FMA
    (2 flops) per tap of each output.  library: the same resize as one
    dense torch.matmul by the weight matrix."""
    import torch
    from aejpeg_tpu_torch.ops import kernels as K, resize
    src = x.shape[axis]
    rows = p * (x.shape[2] if axis == 1 else x.shape[1])
    band = resize.band(kind, src, dst, rows, x.device)
    wmat = torch.as_tensor(
        (resize.area_weights if kind == "area" else resize.linear_weights)(
            src, dst).astype(np.float32), device=x.device)
    taps = int((band.idx >= 0).sum())
    outer = x.numel() // src
    if axis == 1:
        def lib(x=x, wmat=wmat):
            return torch.matmul(wmat, x)
    else:
        def lib(x=x, wmat=wmat):
            return torch.matmul(x, wmat.T)
    nbytes = (x.numel() + outer * dst) * 4 + band.idx.numel() * 8
    return (f"axis {axis} {tuple(x.shape)} -> {dst} {kind}{note}", (x,),
            lambda x, band=band, axis=axis: K.banded_resize_plain(x, band,
                                                                  axis),
            lambda x, band=band, axis=axis: K.banded_resize(x, band, axis),
            lib, nbytes, 2 * taps * outer, on_path)


def check_kernels(dev, names=None, quick=False, path=False):
    """Phase 2: every kernel (or those in `names`) against its plain
    version, bitwise, with times.  quick: the cases off the main path
    only, untimed; path: the cases on it only.  Returns {name: summary
    dict}."""
    import torch
    summary = {}
    for name, cases in kernel_cases(dev).items():
        if names is not None and name not in names:
            continue
        tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0,
               "library_ms": 0.0 if cases[0][4] is not None else None,
               "max_abs_err": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
        for label, args, plain, kern, lib, nbytes, ops, on_path in cases:
            if (quick and on_path) or (path and not on_path):
                continue
            got = kern(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = plain(*args)
            torch.cuda.synchronize()
            pms = (time.perf_counter() - t0) * 1e3
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"{name} {label}: shape/dtype mismatch")
            same = (torch.equal(got.view(torch.int32), ref.view(torch.int32))
                    if got.dtype == torch.float32 else torch.equal(got, ref))
            err = float((got.to(torch.float64) - ref.to(torch.float64))
                        .abs().max())
            if not same:
                raise AssertionError(
                    f"{name} {label}: kernel differs from its plain version "
                    f"(max abs {err})")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            if name == "hysteresis":    # how far the fixpoint was
                tally = {}
                kern(*args, tally=tally)
                tot.setdefault("tallies", {})[label] = tally
                log(f"  {name} {label}: {tally}")
            if quick or not on_path:    # timed at the path's shapes only
                log(f"  {name} {label}: bitwise equal")
                continue
            ms = cuda_ms(lambda: kern(*args))
            dms = device_ms(lambda: kern(*args), KERNEL_NAMES[name])
            if pms < 50:            # else the one checked run's time
                pms = cuda_ms(lambda: plain(*args), reps=5)
            lms = cuda_ms(lib, reps=10) if lib is not None else None
            bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
            ops_ms = ops / H100_FP32_PER_S * 1e3
            bound = max(bytes_ms, ops_ms)
            log(f"  {name} {label}: bitwise equal; kernel {ms:.4f} ms "
                f"(device {'not measured' if dms is None else f'{dms:.4f}'}"
                f" ms), plain {pms:.4f} ms, library "
                f"{'-' if lms is None else f'{lms:.4f} ms'}, bound "
                f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB: {bytes_ms:.4f} ms; "
                f"{ops / 1e6:.1f} M ops: {ops_ms:.4f} ms)")
            tot["ms"] += ms
            tot["device_ms"] = (None if dms is None or tot["device_ms"] is None
                                else tot["device_ms"] + dms)
            tot["plain_ms"] += pms
            tot["bound_ms"] += bound
            tot["bytes_ms"] += bytes_ms
            tot["ops_ms"] += ops_ms
            if lms is not None:
                tot["library_ms"] += lms
        summary[name] = tot
    if (names is None or "dct2d" in names) and not path:
        check_card_rejects(dev)
    return summary


def check_card_rejects(dev):
    """dct2d on the card takes only periods that are powers of two:
    a DCT of blocks of 12 (which the CPU's plain version computes) raises
    ValueError there instead of reading past its tiles."""
    import torch
    from aejpeg_tpu_torch.ops import dct
    x = torch.rand((2, 24, 36), device=dev)
    try:
        dct.dct2_dense(x, 12)
    except ValueError as e:
        log(f"  dct2d s=12 on the card: ValueError ({e})")
    else:
        raise AssertionError("dct2d accepted a period of 12 on the card")


# ------------------------------------------------------------------ phases 3-6


def psnr_db(a, b):
    import torch
    from aejpeg_tpu_torch.metrics import psnr
    return float(psnr(torch.from_numpy(a), torch.from_numpy(b)))


def _launches_since_reset(run):
    """Run run() with every launch counter at 0; returns (its result, the
    counts it left)."""
    from aejpeg_tpu_torch.ops.kernels import LAUNCHES
    for c in LAUNCHES.values():
        c.reset()
    out = run()
    return out, {k: c.n for k, c in LAUNCHES.items()}


def _require_launched(what, launches, names):
    missing = [k for k in names if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what}: kernels not launched: {missing}")


def main_path(cfg, big, small):
    """Phase 3: encode_stream -> decode_stream on the card; returns the
    launch counts of this run."""
    import aejpeg_tpu_torch as at
    images = big + small
    marks = []

    def run():
        marks.append(time.perf_counter())
        blobs = at.encode_stream(images, cfg, batch_size=BATCH)
        marks.append(time.perf_counter())
        decoded = at.decode_stream(blobs, batch_size=BATCH)
        marks.append(time.perf_counter())
        return blobs, decoded
    (blobs, decoded), launches = _launches_since_reset(run)
    log(f"  encode_stream {len(images)} images {marks[1] - marks[0]:.3f} s, "
        f"decode_stream {marks[2] - marks[1]:.3f} s (first run: includes "
        "warm-up)")
    log(f"  launches in this run: {launches}")
    worst = min(psnr_db(im.data, d.data) for im, d in zip(images, decoded))
    raw = sum(im.raw_rgb_bytes for im in images)
    log(f"  {len(blobs)} blobs, {sum(map(len, blobs))} bytes, compression "
        f"ratio {raw / sum(map(len, blobs)):.3f}, worst PSNR {worst:.3f} dB")
    for im, d in zip(images, decoded):
        if d.data.shape != im.data.shape or not np.isfinite(d.data).all():
            raise AssertionError("decoded image has the wrong shape or "
                                 "non-finite values")
    if worst <= 25.0:
        raise AssertionError(f"PSNR {worst:.3f} dB <= 25 dB")
    # encode_batch on the card uploads float32 (f32_to_unit); u8_to_unit
    # serves the mesh and the sweep
    _require_launched("main path", launches,
                      [k for k in launches if k != "u8_to_unit"])
    return launches


def bilateral_card_vs_cpu():
    """Phase 4: the bilateral filter on 96 random 200x300 uint8 planes (the
    planes that showed XLA's fused first product), bitwise card == CPU."""
    import torch
    from aejpeg_tpu_torch.ops import canny
    rng = np.random.default_rng(0)
    u8 = torch.from_numpy(rng.integers(0, 256, (96, 200, 300),
                                       dtype=np.uint8))
    if not torch.equal(canny.bilateral_u8(u8.cuda()).cpu(),
                       canny.bilateral_u8(u8)):
        raise AssertionError("cuda/cpu bilateral filters differ")
    log("  bilateral filter on 96 random 200x300 uint8 planes bitwise equal "
        "card == CPU")


def card_vs_cpu(cfg, imgs, singles=True):
    """Phase 4: the same images on cuda and on the CPU: stage A's planes
    and packed edge levels, stage B's tables (the DCT and quantize kernel), the containers
    and stage D's decoded pixels (the inverse DCT and upsample kernels)
    bitwise equal; then (singles) batch-vs-single container identity on
    cuda."""
    import torch
    import aejpeg_tpu_torch as at
    from aejpeg_tpu_torch.codec.batch_encode import (_host_batch, _stage_a,
                                                     _stage_b)
    from aejpeg_tpu_torch.codec.tables import device_tables, spec_for
    host = torch.from_numpy(_host_batch(imgs))
    shape = imgs[0].original_shape[:2]
    spec = spec_for(cfg, shape)
    mn, mx = cfg.block_size_range
    band = (mn.bit_length(), mx.bit_length() - 1)   # node sizes 2mn..mx
    planes_gpu, lv_gpu = _stage_a(host.cuda(), cfg.color_space, band, spec)
    planes_cpu, lv_cpu = _stage_a(host, cfg.color_space, band, spec)
    lv_gpu = lv_gpu.cpu()
    for a, b in zip(planes_gpu, planes_cpu):
        if not torch.equal(a.cpu().view(torch.int32), b.view(torch.int32)):
            raise AssertionError("cuda/cpu stage A planes differ")
    n = len(imgs)
    tab_gpu = _stage_b(planes_gpu, spec, device_tables(
        cfg, shape, n, torch.device("cuda")), n).cpu()
    tab_cpu = _stage_b(planes_cpu, spec, device_tables(
        cfg, shape, n, torch.device("cpu")), n)
    if not torch.equal(tab_gpu, tab_cpu):
        raise AssertionError("cuda/cpu stage B tables differ: "
                             f"{int((tab_gpu != tab_cpu).sum())} levels")
    log(f"  stage A planes and stage B tables ({tab_gpu.numel()} int16 "
        "levels) bitwise equal card == CPU")
    if not torch.equal(lv_gpu, lv_cpu):
        raise AssertionError("cuda/cpu edge levels differ: "
                             f"{int((lv_gpu != lv_cpu).sum())} bytes")
    log(f"  packed edge levels ({lv_gpu.numel()} bytes) bitwise equal "
        "card == CPU")
    gpu = at.encode_batch(imgs, cfg)
    cpu = at.encode_batch(imgs, cfg, device="cpu")
    if gpu != cpu:
        raise AssertionError("cuda/cpu containers differ")
    log(f"  containers byte-identical card == CPU "
        f"({sum(map(len, gpu))} bytes)")
    dg = at.decode_batch(gpu)
    dc = at.decode_batch(gpu, device="cpu")
    for i, (a, b) in enumerate(zip(dg, dc)):
        diff = int((np.ascontiguousarray(a.data, np.float32).view(np.uint32)
                    != np.ascontiguousarray(b.data, np.float32)
                    .view(np.uint32)).sum())
        log(f"  image {i}: cuda vs cpu decode (stage D) {diff} of "
            f"{a.data.size} values in other bits")
        if diff:
            raise AssertionError("cuda/cpu decodes differ")
    if not singles:
        return
    singles = [at.encode_batch([im], cfg)[0] for im in imgs]
    if singles != gpu:
        raise AssertionError("batch-vs-single containers differ on cuda")
    log("  batch-vs-single containers byte-identical on cuda")


def push_routes(cfg, big):
    """Phase 4: encode_batch's card route (the float32 images staged in
    pinned memory, one upload, f32_to_unit) against the host's route on
    the card (_host_batch's uint8, u8_to_unit): containers byte-identical
    on phase 3's 42 images and on 16 of CLIC's 1365x2048, with the images
    marked u8-exact and unmarked (the kernel's check); each route's push
    ms on the second of two calls."""
    from unittest import mock
    import aejpeg_tpu_torch as at
    from aejpeg_tpu_torch.codec import batch_encode as be
    clic = synth_images(16, 1365, 2048, seed=5)
    ccfg = at.CodecConfig("YCbCr", QUALITY, BLOCKS, entropy_level=-1)
    for label, imgs, c in ((f"{len(big)} x {H}x{W}", big, cfg),
                           ("16 x 1365x2048", clic, ccfg)):
        for marked in (True, None):
            for im in imgs:
                im.u8_exact = marked
            push = {}
            for route in ("card", "host"):
                with mock.patch.object(
                        be, "_pinned_route",
                        be._pinned_route if route == "card"
                        else lambda dev, images: False):
                    for _ in range(2):
                        t = {}
                        blobs = at.encode_batch(imgs, c, timings=t)
                push[route] = (blobs, t["push"] * 1e3)
            if push["card"][0] != push["host"][0]:
                raise AssertionError(f"{label}, marked {marked}: the card "
                                     "route's containers differ from the "
                                     "host route's")
            log(f"  {label}, marked {marked}: containers byte-identical, "
                f"card route and host route; push {push['card'][1]:.3f} "
                f"ms against {push['host'][1]:.3f} ms")
        for im in imgs:
            im.u8_exact = True


def times(cfg, big):
    """Phase 5: encode/decode Mpix/s of the full batch, median of warm
    batches, with per-stage medians."""
    import torch
    import aejpeg_tpu_torch as at
    mpix = len(big) * H * W / 1e6
    enc, dec, enc_st, dec_st = [], [], [], []
    blobs = at.encode_batch(big, cfg)
    at.decode_batch(blobs)
    for _ in range(BATCH_REPS):
        st = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blobs = at.encode_batch(big, cfg, timings=st)
        enc.append(time.perf_counter() - t0)
        enc_st.append(st)
        st = {}
        t0 = time.perf_counter()
        at.decode_batch(blobs, timings=st)
        dec.append(time.perf_counter() - t0)
        dec_st.append(st)

    def stages(rows):
        return {k: round(statistics.median(r[k] for r in rows) * 1e3, 3)
                for k in rows[0]}
    e, d = statistics.median(enc), statistics.median(dec)
    log(f"  encode {mpix / e:.3f} Mpix/s ({e * 1e3:.3f} ms per "
        f"{len(big)}-image batch, all runs ms "
        f"{[round(x * 1e3, 3) for x in enc]}), stages ms {stages(enc_st)}")
    log(f"  decode {mpix / d:.3f} Mpix/s ({d * 1e3:.3f} ms per batch, all "
        f"runs ms {[round(x * 1e3, 3) for x in dec]}), stages ms "
        f"{stages(dec_st)}")


def profile(cfg, big):
    """Phase 6: torch.profiler over one warm encode_batch and one
    decode_batch of the full batch: device-busy share of the wall time and
    the ops with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity
    import aejpeg_tpu_torch as at
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for name, run in (("encode_batch", lambda: at.encode_batch(big, cfg)),
                      ("decode_batch", lambda: at.decode_batch(blobs))):
        if name == "encode_batch":
            blobs = run()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if name == "encode_batch":
            blobs = out
        events = prof.key_averages()
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(_dev_us(e) for e in kernels) / 1e3
        log(f"  {name}: wall {wall * 1e3:.3f} ms (profiled), device busy "
            f"{busy:.3f} ms ({busy / (wall * 1e3):.3f} of wall), "
            f"{sum(e.count for e in kernels)} device activities")
        for e in sorted(kernels, key=_dev_us, reverse=True)[:12]:
            log(f"    {_dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
                f"{e.key[:100]}")

def color_spaces(big, card):
    """Phase 7: every user-selectable space through encode_batch ->
    decode_batch on the card, with its rates, then card vs CPU on one
    image of it."""
    import torch
    import aejpeg_tpu_torch as at
    from aejpeg_tpu_torch import color
    imgs = big[:SPACE_BATCH]
    mpix = len(imgs) * H * W / 1e6
    for space in color.get_color_spaces():
        cfg = at.CodecConfig(space, QUALITY, BLOCKS, entropy_level=-1)
        dec, launches = _launches_since_reset(
            lambda: at.decode_batch(at.encode_batch(imgs, cfg)))
        _require_launched(space, launches,
                          ("f32_to_unit", "histogram256",
                           "clahe_apply_gather"))
        for im, d in zip(imgs, dec):
            if d.data.shape != im.data.shape or not np.isfinite(d.data).all():
                raise AssertionError(f"{space}: decoded image has the wrong "
                                     "shape or non-finite values")
        worst = min(psnr_db(im.data, d.data) for im, d in zip(imgs, dec))
        if worst <= 25.0:
            raise AssertionError(f"{space}: PSNR {worst:.3f} dB <= 25 dB")
        enc, dect = [], []
        for _ in range(SPACE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blobs = at.encode_batch(imgs, cfg)
            t1 = time.perf_counter()
            at.decode_batch(blobs)
            enc.append(t1 - t0)
            dect.append(time.perf_counter() - t1)
        e, d = statistics.median(enc), statistics.median(dect)
        ratio = sum(im.raw_rgb_bytes for im in imgs) / sum(map(len, blobs))
        log(f"  {space}: worst PSNR {worst:.3f} dB, ratio {ratio:.3f}; "
            f"encode {mpix / e:.3f} Mpix/s ({e * 1e3:.3f} ms), decode "
            f"{mpix / d:.3f} Mpix/s ({d * 1e3:.3f} ms), median of "
            f"{SPACE_REPS} warm {len(imgs)}-image batches ({card}); "
            f"launches {launches}")
        card_vs_cpu(cfg, imgs[:1], singles=False)
    float_colors(big)


def float_colors(big):
    """Phase 7, float inputs: every space's conversion both ways on
    FLOAT_PIXELS random float pixels and on subnormal and near-subnormal
    pixels, and encode_batch of two float-input images per space, on the
    card: bitwise (byte-identical) to the CPU, which
    tests/test_torch_color.py holds to the JAX package."""
    import torch
    import aejpeg_tpu_torch as at
    from aejpeg_tpu_torch import color
    from aejpeg_tpu_torch.codec.batch_encode import _host_batch
    rng = np.random.default_rng(3)
    px = torch.from_numpy(rng.random((FLOAT_PIXELS, 3), dtype=np.float32))
    for space in color.REGISTRY:
        fwd = color.convert("sRGB", space, px)
        t0 = time.perf_counter()
        fwd_card = color.convert("sRGB", space, px.cuda())
        back_card = color.convert(space, "sRGB", fwd.cuda())
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        back = color.convert(space, "sRGB", fwd)
        for what, a, b in (("forward", fwd_card, fwd),
                           ("inverse", back_card, back)):
            a = a.cpu()
            same = (a.view(torch.int32) == b.view(torch.int32)).all(-1)
            if not bool(same.all()):
                raise AssertionError(
                    f"{space} {what}: {int((~same).sum())} of "
                    f"{FLOAT_PIXELS} float pixels differ card vs CPU")
        log(f"  {space}: forward and inverse on {FLOAT_PIXELS} float pixels "
            f"bitwise card == CPU (card {t * 1e3:.3f} ms both ways, cold)")
    # subnormal and near-subnormal pixels (the flushes), as
    # tests/test_torch_color.py holds them to the JAX package: forward, and
    # inverse on the forward image and on the pixels themselves
    for low, high in ((1e-45, 2.0 ** -126), (1e-38, 1e-30)):
        for space in color.REGISTRY:
            x = torch.from_numpy(_tiny_pixels(low, high, len(space)))
            fwd = color.convert("sRGB", space, x)
            for what, src, dst, inp in (
                    ("forward", "sRGB", space, x),
                    ("inverse", space, "sRGB", torch.cat([fwd, x]))):
                a = color.convert(src, dst, inp.cuda()).cpu()
                b = color.convert(src, dst, inp)
                same = (a.view(torch.int32) == b.view(torch.int32)).all(-1)
                if not bool(same.all()):
                    raise AssertionError(
                        f"{space} {what}: {int((~same).sum())} of "
                        f"{len(inp)} pixels in [{low:g}, {high:g}) differ "
                        "card vs CPU")
        log(f"  every space: forward and inverse on pixels in "
            f"[{low:g}, {high:g}) bitwise card == CPU")
    noisy = [np.clip(im.data + rng.normal(0, 1e-3, im.data.shape), 0, 1)
             .astype(np.float32) for im in big[:2]]
    imgs = [at.ImageData.from_array(a, extension=".png") for a in noisy]
    if _host_batch(imgs).dtype == np.uint8:
        raise AssertionError("float images took the u8 upload path")
    for space in color.get_color_spaces():
        cfg = at.CodecConfig(space, QUALITY, BLOCKS, entropy_level=-1)
        gpu = at.encode_batch(imgs, cfg)
        cpu = at.encode_batch(imgs, cfg, device="cpu")
        if gpu != cpu:
            raise AssertionError(f"{space}: float-input containers differ "
                                 "card vs CPU")
        log(f"  {space}: 2 float-input {H}x{W} containers byte-identical "
            "card == CPU")


def _tiny_pixels(low, high, seed, n=4096):
    """(n, 3) float32 pixels, a third of them normal values in [0, 1) and
    the rest log-uniform in [low, high) (tests/test_torch_color.py)."""
    rng = np.random.default_rng(seed)
    x = np.exp(rng.uniform(np.log(low), np.log(high), (n, 3)))
    normal = rng.random((n, 3)) < 1 / 3
    x[normal] = rng.random(normal.sum())
    return x.astype(np.float32)


def _same_payloads(a: bytes, b: bytes) -> bool:
    from aejpeg_tpu_torch.io.container import ContainerReader
    ra, rb = ContainerReader(a), ContainerReader(b)
    if ra.metadata != rb.metadata:
        return False
    return all(la.bits_len == lb.bits_len and la.root_size == lb.root_size
               and la.states_bytes == lb.states_bytes
               and np.array_equal(la.coeffs, lb.coeffs)
               for la, lb in zip(ra.read_layers(), rb.read_layers()))


def codec_phase(big, card):
    """Phase 8: the per-image Codec on the card against encode_batch /
    decode_batch on the card."""
    import torch
    import aejpeg_tpu_torch as at
    imgs = big[:CODEC_IMAGES]
    for cfg, needs in (
            (at.CodecConfig("YCoCg", QUALITY, BLOCKS, entropy_level=-1),
             ("f32_to_unit", "histogram256", "clahe_apply_gather")),
            (at.CodecConfig("YCbCr", (50, 50), (8, 8), entropy_level=-1),
             ("f32_to_unit",))):
        codec = at.Codec(cfg)
        codec.decompress(codec.compress(imgs[0]))        # warm-up

        def run():
            blobs, dec, tc, td = [], [], [], []
            for im in imgs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                blobs.append(codec.compress(im))
                t1 = time.perf_counter()
                dec.append(codec.decompress(blobs[-1]))
                tc.append(t1 - t0)
                td.append(time.perf_counter() - t1)
            return blobs, dec, tc, td
        (blobs, dec, tc, td), launches = _launches_since_reset(run)
        _require_launched(f"Codec {cfg.color_space}", launches, needs)
        ref = at.encode_batch(imgs, cfg)
        if not all(_same_payloads(a, b) for a, b in zip(blobs, ref)):
            raise AssertionError(f"Codec {cfg}: payloads differ from "
                                 "encode_batch on the card")
        # decode_batch of one container and of the 4: the same bits
        batch_dec = at.decode_batch(ref)
        err = max(float(np.abs(a.data - b.data).max())
                  for a, b in zip(dec, batch_dec))
        diff = sum(_bits_differ(a.data, b.data)
                   for a, b in zip(dec, batch_dec))
        worst = min(psnr_db(im.data, d.data) for im, d in zip(imgs, dec))
        log(f"  Codec {cfg.color_space} q{cfg.quality_range} blocks "
            f"{cfg.block_size_range}: payload-identical to encode_batch, "
            f"decode max abs vs decode_batch {err:.3g} ({diff} values in "
            f"other bits), worst PSNR "
            f"{worst:.3f} dB; per image compress "
            f"{statistics.mean(tc) * 1e3:.3f} ms, decompress "
            f"{statistics.mean(td) * 1e3:.3f} ms (mean of {len(imgs)}, "
            f"{card}); launches {launches}")
        if diff or worst <= 25.0:
            raise AssertionError("Codec decodes differ from decode_batch's")


def write_lpips_weights(path):
    """Random LPIPS weights at AlexNet's widths (the real ones are not in
    the repository), as the .npz the port loads."""
    from aejpeg_tpu_torch.metrics import lpips
    rng = np.random.default_rng(3)
    params, in_ch = {}, 3
    for i, (out, k, _, _) in enumerate(lpips.ALEX_CONVS):
        params[f"conv{i}_w"] = (rng.standard_normal((out, in_ch, k, k))
                                * 0.05).astype(np.float32)
        params[f"conv{i}_b"] = (rng.standard_normal(out)
                                * 0.05).astype(np.float32)
        params[f"lin{i}_w"] = np.abs(rng.standard_normal(
            (1, out, 1, 1))).astype(np.float32)
        in_ch = out
    np.savez(path, **params)
    return path


def metrics_phase(big, card):
    """Phase 9: EvaluationMetrics on the card against the CPU."""
    import os
    import tempfile
    import aejpeg_tpu_torch as at
    cfg = at.CodecConfig("YCoCg", QUALITY, BLOCKS, entropy_level=-1)
    a = big[0].data
    b = at.decode_batch(at.encode_batch(big[:1], cfg))[0].data
    with tempfile.TemporaryDirectory() as tmp:
        path = write_lpips_weights(os.path.join(tmp, "lpips_random.npz"))
        gpu = at.EvaluationMetrics(a, b, lpips_weights=path)
        cpu = at.EvaluationMetrics(a, b, lpips_weights=path, device="cpu")
        for name in ("psnr", "ssim", "ms_ssim", "lpips"):
            t0 = time.perf_counter()
            g = getattr(gpu, name)()
            ms = (time.perf_counter() - t0) * 1e3
            c = getattr(cpu, name)()
            d = abs(g - c) / (abs(c) if name == "lpips" else 1.0)
            log(f"  {name}: card {g!r}, cpu {c!r}, "
                f"{'relative ' if name == 'lpips' else ''}difference "
                f"{d:.3g}; card call {ms:.3f} ms ({card})")
            if not np.isfinite(g) or d > 1e-5:
                raise AssertionError(f"{name}: card and CPU differ")


# --------------------------------------------------------------- phases 10-12


def _csv_rows(path):
    import csv
    with open(path) as f:
        rows = list(csv.DictReader(f))
    keys = ("image_name", "color_space", "min_quality", "max_quality",
            "min_block_size", "max_block_size")
    out = {tuple(r[k] for k in keys): r for r in rows}
    if len(out) != len(rows):
        raise AssertionError(f"{path}: duplicate rows")
    return out


def _write_pngs(images, tmp, prefix):
    paths = []
    for i, im in enumerate(images):
        path = os.path.join(tmp, f"{prefix}{i:02d}.png")
        im.save(path)
        paths.append(path)
    return paths


def sweep_phase(big, small, card):
    """Phase 10: BatchedMetricsSweep on the card, checked against the
    decode path on the card and against the sweep on the CPU; returns the
    launch counts of its run."""
    import tempfile
    import aejpeg_tpu_torch as at
    from aejpeg_tpu_torch.harness.sweep_batched import BatchedMetricsSweep
    from aejpeg_tpu_torch.io.image import ImageData
    from aejpeg_tpu_torch.metrics.lpips import lpips_distance
    qv, bv = SWEEP_QUALITY_VALUES, SWEEP_BLOCK_VALUES
    qrs = [(a, b) for a in qv for b in qv if a <= b]
    brs = [(a, b) for a in bv for b in bv if a <= b]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = (_write_pngs(big[:SWEEP_IMAGES], tmp, "live")
                 + _write_pngs(small, tmp, "small"))
        loaded = [ImageData.load(p) for p in paths]
        src = big[:SWEEP_IMAGES] + small
        if not all(np.array_equal(a.data, b.data)
                   for a, b in zip(loaded, src)):
            raise AssertionError("PNG write -> read changed the pixels")
        log(f"  {len(paths)} PNGs written and read back bit-exact "
            f"({time.perf_counter() - t0:.3f} s)")
        weights = write_lpips_weights(os.path.join(tmp, "lpips.npz"))

        def sweep(out, files=paths, combos=None, device=None, timings=None):
            s = BatchedMetricsSweep(
                files, out, color_spaces=SWEEP_SPACES,
                quality_ranges=combos[0] if combos else qrs,
                block_size_ranges=combos[1] if combos else brs,
                entropy_level=-1, progress_every=10 ** 9, with_lpips=True,
                lpips_weights=weights, device=device, timings=timings)
            s.run()
            if s.errors:
                raise AssertionError(f"sweep errors: {s.errors[:3]}")
            return _csv_rows(out)

        out = os.path.join(tmp, "sweep.csv")
        t0 = time.perf_counter()
        rows, launches = _launches_since_reset(lambda: sweep(out))
        wall = time.perf_counter() - t0
        n_combos = len(SWEEP_SPACES) * len(qrs) * len(brs)
        if len(rows) != len(paths) * n_combos:
            raise AssertionError(f"sweep wrote {len(rows)} rows, want "
                                 f"{len(paths) * n_combos}")
        _require_launched("sweep", launches,
                          [k for k in launches if k != "f32_to_unit"])
        mpix = sum(im.original_shape[0] * im.original_shape[1]
                   for im in src) / 1e6 * n_combos
        log(f"  sweep: {len(rows)} rows ({len(paths)} images x {n_combos} "
            f"combos) in {wall:.3f} s (first run: includes warm-up): "
            f"{len(rows) / wall:.3f} image-combos/s, {mpix / wall:.3f} "
            f"Mpix-combos/s ({card}); launches {launches}")
        st = {}
        t0 = time.perf_counter()
        sweep(os.path.join(tmp, "timed.csv"), timings=st)
        wall2 = time.perf_counter() - t0
        log(f"  second run, each stage synchronized: {wall2:.3f} s, "
            f"{len(rows) / wall2:.3f} image-combos/s; stages s "
            + json.dumps({k: round(v, 4) for k, v in st.items()}))

        gaps = {"psnr": 0.0, "ssim": 0.0, "ms_ssim": 0.0, "lpips": 0.0}
        n_same = n_all = 0
        for space in SWEEP_SPACES:
            for br in SWEEP_CHECK_BLOCKS:
                cfg = at.CodecConfig(space, SWEEP_CHECK_QUALITY, br,
                                     entropy_level=-1)
                for group in (list(range(SWEEP_IMAGES)),
                              list(range(SWEEP_IMAGES, len(paths)))):
                    imgs = [loaded[i] for i in group]
                    blobs = at.encode_batch(imgs, cfg)
                    for i, img, blob, dec in zip(group, imgs, blobs,
                                                 at.decode_batch(blobs)):
                        row = rows[(paths[i], space,
                                    str(SWEEP_CHECK_QUALITY[0]),
                                    str(SWEEP_CHECK_QUALITY[1]),
                                    str(br[0]), str(br[1]))]
                        ev = at.EvaluationMetrics(img, dec)
                        want = {"psnr": ev.psnr(), "ssim": ev.ssim(),
                                "ms_ssim": ev.ms_ssim(),
                                "lpips": float(lpips_distance(
                                    img.data, dec.data, weights))}
                        ratio = f"{img.raw_rgb_bytes / len(blob):.4f}"
                        if row["compression_ratio"] != ratio:
                            raise AssertionError(
                                f"{space} {br} {paths[i]}: ratio "
                                f"{row['compression_ratio']} != {ratio}")
                        for m, v in want.items():
                            gaps[m] = max(gaps[m], abs(float(row[m]) - v))
                            if m != "lpips":
                                n_all += 1
                                n_same += row[m] == f"{v:.4f}"
        log(f"  against encode_batch -> decode_batch -> EvaluationMetrics "
            f"on the card ({len(SWEEP_SPACES)} spaces x "
            f"{len(SWEEP_CHECK_BLOCKS)} combos x {len(paths)} images): "
            f"ratio strings identical; {n_same}/{n_all} psnr/ssim/ms_ssim "
            f"strings identical; largest gaps {gaps}")
        if gaps["psnr"] > 2e-2 or max(gaps["ssim"], gaps["ms_ssim"]) > 2e-3 \
                or gaps["lpips"] > 1e-4:
            raise AssertionError("sweep metrics out of tolerance against "
                                 "the decode path")

        cpu_files = paths[:2]
        cpu_rows = sweep(os.path.join(tmp, "cpu.csv"), files=cpu_files,
                         combos=SWEEP_CPU_COMBOS, device="cpu")
        worst = 0.0
        for key, row in cpu_rows.items():
            if row["compression_ratio"] != rows[key]["compression_ratio"]:
                raise AssertionError(f"{key}: card and CPU ratios differ")
            for m in ("psnr", "ssim", "ms_ssim", "lpips"):
                worst = max(worst, abs(float(row[m])
                                       - float(rows[key][m])))
        log(f"  card against CPU, {len(cpu_rows)} rows: ratio strings "
            f"identical, largest metric gap {worst:.3g}")
        if worst > 1e-4:
            raise AssertionError("sweep card vs CPU out of tolerance")
    return launches


def cli_phase(big, card):
    """Phase 11: the CLI in subprocesses on the default device."""
    import tempfile
    import aejpeg_tpu_torch as at
    root = os.path.dirname(os.path.abspath(__file__))

    def run(*args):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "aejpeg_tpu_torch.cli", *args], cwd=root,
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=root))
        if res.returncode != 0:
            raise AssertionError(f"cli {args[0]} exited {res.returncode}: "
                                 f"{res.stderr[-2000:]}")
        log(f"  cli {args[0]}: exit 0 ({time.perf_counter() - t0:.3f} s)")
        return res.stdout

    with tempfile.TemporaryDirectory() as tmp:
        paths = _write_pngs(big[:2], tmp, "cli")
        out = os.path.join(tmp, "out")
        run("compress", *paths, "-o", out, "--color-space", "YCoCg",
            "--quality", *map(str, QUALITY), "--blocks", *map(str, BLOCKS))
        cfg = at.CodecConfig("YCoCg", QUALITY, BLOCKS)
        want, launches = _launches_since_reset(lambda: at.encode_stream(
            [at.ImageData.load(p) for p in paths], cfg))
        _require_launched("encode_stream of the CLI's images", launches,
                          ("f32_to_unit", "histogram256",
                           "clahe_apply_gather"))
        ajpgs = [os.path.join(out, f"cli{i:02d}.ajpg")
                 for i in range(len(paths))]
        for path, blob in zip(ajpgs, want):
            with open(path, "rb") as f:
                if f.read() != blob:
                    raise AssertionError(f"{path} differs from encode_stream")
        log("  .ajpg files byte-identical to encode_stream in process "
            f"(launches {launches})")
        meta = json.loads(run("info", ajpgs[0]))
        if meta["color_space"] != "YCoCg" or meta["blocks"] != list(BLOCKS):
            raise AssertionError(f"cli info: {meta}")
        run("decompress", *ajpgs, "-o", out)
        for i, p in enumerate(paths):
            dec = at.ImageData.load(os.path.join(
                out, f"cli{i:02d}_decompressed.png"))
            db = psnr_db(at.ImageData.load(p).data, dec.data)
            log(f"  decompressed cli{i:02d}: {db:.3f} dB")
            if db < 25.0:
                raise AssertionError("cli decompress below 25 dB")
        report = json.loads(run("preview", paths[0], "--color-space",
                                "YCoCg", "--quality", *map(str, QUALITY),
                                "--blocks", *map(str, BLOCKS)))
        missing = [k for k in ("compression_ratio", "psnr", "ssim",
                               "ms_ssim") if k not in report]
        if missing:
            raise AssertionError(f"cli preview lacks {missing}")
        keys = ("compression_ratio", "psnr", "ssim", "ms_ssim", "lpips")
        log(f"  preview: { {k: report[k] for k in keys} }")


def harness_phase(big, card):
    """Phase 12: the speed table, the visualizer and the normalization
    constants on the card."""
    import tempfile
    import aejpeg_tpu_torch as at
    from aejpeg_tpu_torch import color
    from aejpeg_tpu_torch.harness.normalization import derive_constants
    from aejpeg_tpu_torch.harness.speed import format_table, run_speed_table
    from aejpeg_tpu_torch.harness.visualize import visualize

    with tempfile.TemporaryDirectory() as tmp:
        (path,) = _write_pngs(big[:1], tmp, "speed")
        rows, launches = _launches_since_reset(lambda: run_speed_table(
            path, iters=3, block_sizes=[4, 8, 16, 32]))
        _require_launched("speed table", launches, ("f32_to_unit",))
        log(f"  speed table, 1 x {H}x{W}, 3 iters ({card}; launches "
            f"{launches}):")
        for line in format_table(rows).splitlines():
            log(f"    {line}")
        vcfg = at.CodecConfig("YCoCg", QUALITY, (4, 64))
        with contextlib.redirect_stdout(io.StringIO()):
            gpu, launches = _launches_since_reset(lambda: visualize(
                path, os.path.join(tmp, "vis_gpu"), vcfg))
            cpu = visualize(path, os.path.join(tmp, "vis_cpu"), vcfg,
                            device="cpu")
        _require_launched("visualize", launches,
                          ("histogram256", "clahe_apply_gather"))
        leaves = {k: (gpu[k], cpu[k]) for k in gpu if k.endswith("_leaves")}
        log(f"  visualize leaf counts card/CPU: {leaves}; launches "
            f"{launches}")
        if any(a != b for a, b in leaves.values()):
            raise AssertionError("visualize leaf counts card != CPU")

    t0 = time.perf_counter()
    gpu = derive_constants()
    t_gpu = time.perf_counter() - t0
    cpu = derive_constants(spaces=["YCoCg"], device="cpu")["YCoCg"]
    rel = max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
              for a, b in zip(gpu["YCoCg"], cpu))
    log(f"  derive_constants: all {len(gpu)} spaces on the card in "
        f"{t_gpu:.3f} s; YCoCg card vs CPU largest relative gap {rel:.3g}")
    if rel > 1e-6:
        raise AssertionError("derive_constants card vs CPU out of tolerance")
    for space, (mid, scale) in gpu.items():
        smid, sscale = color.normalization_constants(space)
        log(f"    {space} against the shipped constants: midpoints within "
            f"{float(np.max(np.abs(mid - smid))):.3g} (absolute), scales "
            f"within {float(np.max(np.abs(scale - sscale) / sscale)):.3g} "
            "(relative)")


# --------------------------------------------------------------- phases 13-16


def mesh_phase(cfg, big, small, card):
    """Phase 13: encode_batch / decode_batch over meshes against the
    single-device path on the same card; returns the launch counts of the
    first mesh's run."""
    import torch
    import aejpeg_tpu_torch as at
    from aejpeg_tpu_torch.parallel import make_mesh
    meshes = [("(2, 1) mesh of cuda:0 twice",
               make_mesh((2, 1), devices=["cuda:0"] * 2))]
    n = 2
    while n <= torch.cuda.device_count():
        meshes.append((f"mesh over {n} cards", make_mesh(
            devices=[f"cuda:{i}" for i in range(n)])))
        n *= 2
    first = None
    for label, mesh in meshes:
        imgs = big[:len(big) - len(big) % mesh.size]
        pair = small if len(small) % mesh.size == 0 else []
        # single-device references, outside the counted mesh run
        want = at.encode_batch(imgs, cfg)
        want_pair = at.encode_batch(pair, cfg) if pair else []
        want_dec = at.decode_batch(want) + (at.decode_batch(want_pair)
                                            if pair else [])

        def run():
            blobs = at.encode_batch(imgs, cfg, mesh=mesh)
            dec = at.decode_batch(blobs, mesh=mesh)
            if pair:
                blobs += at.encode_batch(pair, cfg, mesh=mesh)
                dec += at.decode_batch(blobs[len(imgs):], mesh=mesh)
            return blobs, dec
        (blobs, dec), launches = _launches_since_reset(run)
        if blobs != want + want_pair:
            raise AssertionError(f"{label}: containers differ from the "
                                 "single-device path's")
        err = max(float(np.abs(x.data - y.data).max())
                  for x, y in zip(dec, want_dec))
        diff = sum(_bits_differ(x.data, y.data)
                   for x, y in zip(dec, want_dec))
        log(f"  {label}: {len(imgs)} x {H}x{W}"
            + (f" + {len(pair)} x {SMALL[0]}x{SMALL[1]}" if pair else "")
            + f", containers byte-identical to the single-device path's; "
            f"decode vs single device: {diff} values in other bits (max "
            f"abs {err!r}); launches {launches}")
        if diff:
            raise AssertionError(f"{label}: decode differs in {diff} values "
                                 f"(max abs {err})")
        if first is None:           # the mesh keeps the host's rounding
            _require_launched(label, launches,
                              [k for k in launches if k != "f32_to_unit"])
            first = launches
        for what, call in (
                ("encode_batch", lambda: at.encode_batch(imgs[:-1], cfg,
                                                         mesh=mesh)),
                ("decode_batch", lambda: at.decode_batch(want[:-1],
                                                         mesh=mesh))):
            try:
                call()
            except ValueError as e:
                log(f"  {what} of {len(imgs) - 1} images: ValueError ({e})")
            else:
                raise AssertionError(f"{what} accepted {len(imgs) - 1} "
                                     f"images on {mesh.size} shards")
        mpix = len(imgs) * H * W / 1e6
        rates = {k: [] for k in ("single encode", "mesh encode",
                                 "single decode", "mesh decode")}
        for _ in range(MESH_REPS):
            for k, call in (
                    ("single encode", lambda: at.encode_batch(imgs, cfg)),
                    ("mesh encode", lambda: at.encode_batch(imgs, cfg,
                                                            mesh=mesh)),
                    ("single decode", lambda: at.decode_batch(want)),
                    ("mesh decode", lambda: at.decode_batch(want,
                                                            mesh=mesh))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                rates[k].append(time.perf_counter() - t0)
        log(f"  {label}, median of {MESH_REPS} warm batches ({card}): "
            + ", ".join(f"{k} {mpix / statistics.median(v):.3f} Mpix/s "
                        f"({statistics.median(v) * 1e3:.3f} ms)"
                        for k, v in rates.items()))
    return first


_MH_WORKER = r"""
import pickle, sys, time
sys.path.insert(0, %(root)r)
import torch.distributed as dist
from chip_smoke import synth_images, H, W, MH_IMAGES, QUALITY, BLOCKS
from aejpeg_tpu_torch import CodecConfig
from aejpeg_tpu_torch.parallel import multihost as mh
t0 = time.perf_counter()
mh.initialize(%(coord)r, 2, %(rank)d)
images = synth_images(MH_IMAGES, H, W, seed=3)
cfg = CodecConfig("YCoCg", QUALITY, BLOCKS, entropy_level=-1)
t1 = time.perf_counter()
idxs, blobs = mh.encode_stream_sharded(images, cfg)
t2 = time.perf_counter()
parts = [None, None]
dist.all_gather_object(parts, (idxs, blobs))
merged = dict(kv for p in parts for kv in zip(*p))
t3 = time.perf_counter()
didxs, decoded = mh.decode_stream_sharded([merged[i] for i in
                                           range(MH_IMAGES)])
t4 = time.perf_counter()
with open(%(out)r, "wb") as f:
    pickle.dump({"rank": dist.get_rank(), "world": dist.get_world_size(),
                 "idxs": idxs, "blobs": blobs, "didxs": didxs,
                 "decoded": [im.data for im in decoded],
                 "s": {"start": t1 - t0, "encode": t2 - t1,
                       "decode": t4 - t3}}, f)
dist.destroy_process_group()
"""


def _bits_differ(a, b):
    """The count of float32 values whose bits differ."""
    return int((np.ascontiguousarray(a, np.float32).view(np.uint32)
                != np.ascontiguousarray(b, np.float32).view(np.uint32))
               .sum())


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost_phase(card):
    """Phase 14: two gloo ranks in subprocesses against the in-process
    streams."""
    import pickle
    import tempfile
    import aejpeg_tpu_torch as at
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        coord = f"127.0.0.1:{_free_port()}"
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", _MH_WORKER % {
                "root": root, "coord": coord, "rank": r, "out": outs[r]}],
            cwd=root, env=dict(os.environ, PYTHONPATH=root),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for r in range(2)]
        try:
            for r, p in enumerate(procs):
                _, err = p.communicate(timeout=300)
                if p.returncode != 0:
                    raise AssertionError(
                        f"rank {r} exited {p.returncode}: "
                        f"{err.decode(errors='replace')[-2000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        wall = time.perf_counter() - t0
        res = []
        for path in outs:
            with open(path, "rb") as f:
                res.append(pickle.load(f))
    images = synth_images(MH_IMAGES, H, W, seed=3)
    cfg = at.CodecConfig("YCoCg", QUALITY, BLOCKS, entropy_level=-1)
    want = at.encode_stream(images, cfg)
    want_dec = at.decode_stream(want)
    union, dec = {}, {}
    for r in res:
        union.update(zip(r["idxs"], r["blobs"]))
        dec.update(zip(r["didxs"], r["decoded"]))
        log(f"  rank {r['rank']} of {r['world']}: images {r['idxs']}, "
            f"rendezvous {r['s']['start']:.3f} s, encode_stream_sharded "
            f"{r['s']['encode']:.3f} s, decode_stream_sharded "
            f"{r['s']['decode']:.3f} s (first calls: include warm-up)")
    if sorted(union) != list(range(MH_IMAGES)) or \
            [union[i] for i in range(MH_IMAGES)] != want:
        raise AssertionError("the ranks' containers differ from "
                             "encode_stream in process")
    err = max(float(np.abs(dec[i] - want_dec[i].data).max())
              for i in range(MH_IMAGES))
    diff = sum(_bits_differ(dec[i], want_dec[i].data)
               for i in range(MH_IMAGES))
    log(f"  union of {MH_IMAGES} containers byte-identical to encode_stream;"
        f" decodes vs decode_stream: {diff} values in other bits (max abs "
        f"{err!r}); two ranks' wall {wall:.3f} s from spawn to exit "
        f"({card})")
    if diff:
        raise AssertionError(f"multihost decodes differ in {diff} values "
                             f"(max abs {err})")


def bench_phase(big, card):
    """Phase 15: the CLI's bench subcommand in a subprocess."""
    import re
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        for i, im in enumerate(big[:BENCH_DISTINCT]):
            im.save(os.path.join(tmp, f"live{i:02d}.bmp"))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "aejpeg_tpu_torch.cli", "bench",
             "--images", tmp], cwd=root, capture_output=True, text=True,
            timeout=600, env=dict(os.environ, PYTHONPATH=root))
        wall = time.perf_counter() - t0
    for line in res.stderr.strip().splitlines():
        log(f"    {line}")
    if res.returncode != 0:
        raise AssertionError(f"bench exited {res.returncode}")
    out = res.stdout.strip().splitlines()
    line = json.loads(out[-1])
    log(f"  bench ({wall:.3f} s in its process, {card}): {out[-1]}")
    if set(line) != {"metric", "value", "unit", "vs_baseline"} \
            or not line["value"] > 0:
        raise AssertionError(f"bench line malformed: {line}")
    db = float(re.search(r"PSNR ([0-9.]+) dB", line["metric"]).group(1))
    if db <= 25.0:
        raise AssertionError(f"bench PSNR {db} dB <= 25 dB")


def gui_phase(big, card):
    """Phase 16: the GUI's jobs on the card through a stub app (no Tk)."""
    import tempfile
    import aejpeg_tpu_torch as at
    from aejpeg_tpu_torch.gui.app import AejpegApp
    from aejpeg_tpu_torch.gui.control_panel import PanelState

    class Stub:
        state = PanelState(quality=QUALITY, block_exponents=(2, 7))
        device = None
        codec = at.Codec(state.to_config())

    cfg = Stub.state.to_config()
    (out, ratio), launches = _launches_since_reset(
        lambda: AejpegApp._process_preview(Stub, big[0]))
    db = psnr_db(big[0].data, out.data)
    log(f"  preview job: ratio {ratio:.3f}, {db:.3f} dB; launches "
        f"{launches}")
    if ratio <= 1.0 or db <= 25.0:
        raise AssertionError("preview job out of bounds")
    with tempfile.TemporaryDirectory() as tmp:
        paths = _write_pngs(big[:GUI_IMAGES], tmp, "gui")
        errors, launches = _launches_since_reset(
            lambda: AejpegApp._compress_job(Stub, paths))
        if errors:
            raise AssertionError(f"compress job: {errors}")
        _require_launched("compress job", launches,
                          ("f32_to_unit", "histogram256",
                           "clahe_apply_gather"))
        want = at.encode_batch([at.ImageData.load(p) for p in paths], cfg)
        ajpgs = [os.path.splitext(p)[0] + ".ajpg" for p in paths]
        for path, blob in zip(ajpgs, want):
            with open(path, "rb") as f:
                if f.read() != blob:
                    raise AssertionError(f"{path} differs from encode_batch")
        log(f"  compress job: {len(ajpgs)} .ajpg byte-identical to "
            f"encode_batch; launches {launches}")
        for p in paths:
            os.remove(p)
        errors = AejpegApp._decompress_job(Stub, ajpgs)
        if errors:
            raise AssertionError(f"decompress job: {errors}")
        dbs = [psnr_db(im.data, at.ImageData.load(p).data)
               for im, p in zip(big, paths)]
        log(f"  decompress job: {len(paths)} images written back, "
            f"{min(dbs):.3f}-{max(dbs):.3f} dB ({card})")
        if min(dbs) <= 25.0:
            raise AssertionError("decompress job below 25 dB")


# ------------------------------------------------------------------ phase 17


def small_images(n, h, w, seed):
    """u8-exact RGB test images of any size (down to 1x1): gradients, one
    hard-edged block, noise."""
    from aejpeg_tpu_torch import ImageData
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        img = np.stack([0.5 + 0.4 * np.sin(x / 9.0 + i) * np.cos(y / 13.0),
                        (x + y) / (h + w),
                        0.5 + 0.3 * np.cos(x / (5.0 + i))], -1)
        img[h // 4:h // 2, w // 3:2 * w // 3] = rng.random(3)
        img += rng.normal(0, 0.03, img.shape)
        u8 = np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)
        im = ImageData.from_array(u8.astype(np.float32) / 255.0,
                                  extension=".png")
        im.u8_exact = True
        out.append(im)
    return out


def small_kernel_cases(dev):
    """Each kernel's inputs at the small layers' plane shapes, built as
    canny.clahe and canny.percentiles_u8 build them: [(name, label, args,
    plain, kernel)]."""
    import torch
    import torch.nn.functional as F
    from aejpeg_tpu_torch.ops import canny, dct, kernels as K, resize
    g = torch.Generator(device="cpu").manual_seed(4)
    out = []
    for h, w in SMALL_PLANES:
        p = 3
        img = torch.randint(0, 256, (p, h, w), generator=g,
                            dtype=torch.uint8).to(dev)
        th, tw = -(-h // 4), -(-w // 4)
        padded = K.reflect101_pad(img, 0, th * 4 - h, 0, tw * 4 - w)
        tiles = (padded.reshape(p, 4, th, 4, tw).permute(0, 1, 3, 2, 4)
                 .reshape(p, 16, th * tw).to(torch.int32).contiguous())
        n = h * w
        rows = F.pad(img.reshape(p, n).to(torch.int32), (0, (-n) % 8),
                     value=-1).reshape(p, 8, -1)
        label = f"({p}, {h}, {w})"
        for what, vals in (("tiles", tiles), ("percentile rows", rows)):
            out.append(("histogram256", f"{label} {what}", (vals,),
                        K.histogram256_plain, K.histogram256))
        luts = canny._clahe_luts(padded, th, tw, 4, 4, 0.75)
        key = (dev, h, w, th, tw, 4, 4)
        if K.clahe_gather_supported(h, w, th, 4, 4):
            words = (luts.to(torch.uint8).permute(0, 1, 3, 2).contiguous()
                     .view(torch.int32).squeeze(-1))
            vecs = canny._device_tables(canny._clahe_interp_vectors, *key)
            out.append(("clahe_apply_gather", label, (img, words, *vecs),
                        lambda *a, th=th: K.clahe_apply_gather_plain(
                            *a, th=th),
                        lambda *a, th=th: K.clahe_apply_gather(*a, th=th)))
        else:
            taps = canny._device_tables(canny._clahe_taps, *key)
            out.append(("clahe_lut_apply", label,
                        (img, luts.reshape(p, 16, 256), *taps),
                        lambda *a: K.clahe_lut_apply_plain(*a, gw=4),
                        lambda *a: K.clahe_lut_apply(*a, gw=4)))
        rgb = torch.randint(0, 256, (2, h, w, 3), generator=g,
                            dtype=torch.uint8).to(dev)
        out.append(("u8_to_unit", f"(2, {h}, {w}, 3)", (rgb,),
                    K.u8_to_unit_plain, K.u8_to_unit))
        out.append(("f32_to_unit", f"(2, {h}, {w}, 3)",
                    (K.u8_to_unit_plain(rgb),),
                    lambda x: K.f32_to_unit_plain(x)[0],
                    lambda x: K.f32_to_unit(x)[0]))
        weak = torch.rand((p, h, w), generator=g).to(dev) < 0.5
        strong = weak & (torch.rand((p, h, w), generator=g).to(dev) < 0.05)
        out.append(("hysteresis", label, (strong, weak),
                    lambda a, b: K.hysteresis_plain(a, b).to(torch.float32),
                    K.hysteresis))
        space = canny._bilateral_taps(5, 75.0, 75.0)
        colour = canny._color_weights(75.0, dev)
        out.append(("bilateral", label, (img,),
                    lambda x, c=colour: K.bilateral_plain(x, c, space, 2),
                    lambda x, c=colour: K.bilateral(x, c, space, 2)))
        if h * w > 1:
            x = torch.rand((2, h, w), generator=g).to(dev)
            for axis, dst, kind in ((1, 2 * h, "linear"),
                                    (2, -(-w // 2), "area")):
                if dst == x.shape[axis]:
                    continue
                band = resize.band(kind, x.shape[axis], dst,
                                   2 * x.shape[3 - axis], dev)
                out.append(("banded_resize", f"axis {axis} (2, {h}, {w}) -> "
                            f"{dst} {kind}", (x,),
                            lambda x, b=band, a=axis:
                            K.banded_resize_plain(x, b, a),
                            lambda x, b=band, a=axis:
                            K.banded_resize(x, b, a)))
        if h % 4 or w % 4:
            continue
        # the small images' padded planes through both DCT directions at
        # s = 4 and at the largest block that tiles them
        x = ((torch.rand((3, h, w), generator=g) - 0.5) * 100).to(dev)
        top = min(128, (h & -h), (w & -w))
        for s in sorted({4, top}):
            b_f = dct.band(s, x.numel() // s, False, dev)
            b_i = dct.band(s, x.numel() // s, True, dev)
            hi, lo, _ = _quant_tables(s, 1, dev)
            q = (hi, lo, 1, True, torch.int16)
            rcp = torch.tensor([0.8], device=dev)
            mid = torch.tensor([0.5], device=dev)
            out.append(("dct2d", f"forward + quantize (3, {h}, {w}) "
                        f"s={s}", (x,),
                        lambda x, b=b_f, q=q, s=s: K._levels_plain(
                            K.dct_pass_plain(K.dct_pass_plain(x, b, 1),
                                             b, 2), q, s),
                        lambda x, s=s, hi=hi, lo=lo: dct.dct2_quantize(
                            x, s, hi, lo)))
            out.append(("dct2d", f"inverse + sum, denormalize (3, {h}, "
                        f"{w}) s={s}", (x,),
                        lambda x, b=b_i, r=rcp, m=mid: K._post_plain(
                            K.dct_pass_plain(K.dct_pass_plain(x, b, 1),
                                             b, 2), x, (r, m, 1)),
                        lambda x, s=s, r=rcp, m=mid: dct.idct2_planes(
                            x, s, add=x, affine=(r, m, 1))))
    return out


def small_layers_phase(card):
    """Phase 17: images whose layers are smaller than the largest block.
    The kernels at those plane shapes against their plain versions; the
    fault cases through encode_batch -> decode_batch on the card against
    the per-image Codec on the CPU; the CLI's compress at its defaults on a
    64x64 PNG; the sweep over a 96x128 group.  Returns (the launch counts
    of the encode/decode run, each kernel's largest error)."""
    import tempfile
    from unittest import mock
    import torch
    import aejpeg_tpu_torch as at
    from aejpeg_tpu_torch.harness import sweep_batched
    from aejpeg_tpu_torch.io.container import ContainerReader
    worst = {}
    seen = {}
    for name, label, args, plain, kern in small_kernel_cases(
            torch.device("cuda")):
        got, ref = kern(*args), plain(*args)
        if got.shape != ref.shape or got.dtype != ref.dtype or \
                not torch.equal(got.view(torch.int32)
                                if got.dtype == torch.float32 else got,
                                ref.view(torch.int32)
                                if ref.dtype == torch.float32 else ref):
            raise AssertionError(f"{name} {label}: kernel differs from its "
                                 "plain version")
        worst[name] = max(worst.get(name, 0.0), float(
            (got.double() - ref.double()).abs().max()))
        seen.setdefault(name, []).append(label)
    for name, labels in seen.items():
        log(f"  {name}: bitwise equal to its plain version at "
            + ", ".join(labels))
    if set(seen) != set(KERNEL_NAMES):
        raise AssertionError("kernels not checked at small shapes: "
                             f"{set(KERNEL_NAMES) - set(seen)}")

    cases = [(space, blocks, shape,
              small_images(2, *shape, seed=shape[0] * 7 + shape[1]))
             for space, blocks, shape in SMALL_LAYER_CASES]

    def run():
        out = []
        for space, blocks, _, imgs in cases:
            e9, e1 = (at.encode_batch(imgs, at.CodecConfig(
                space, QUALITY, blocks, entropy_level=level))
                for level in (9, -1))
            out.append((e9, e1, at.decode_batch(e1)))
        return out
    encoded, launches = _launches_since_reset(run)
    log(f"  launches in the encode/decode run: {launches}")
    _require_launched("small layers", launches,
                      [k for k in launches if k != "u8_to_unit"])
    for (space, blocks, shape, imgs), (e9, e1, dec) in zip(cases, encoded):
        cpu9 = at.Codec(at.CodecConfig(space, QUALITY, blocks),
                        device="cpu")
        codec = at.Codec(at.CodecConfig(space, QUALITY, blocks,
                                        entropy_level=-1), device="cpu")
        if e9 != [cpu9.compress(im) for im in imgs]:
            raise AssertionError(f"{space} {blocks} {shape}: card containers "
                                 "differ from the CPU Codec's (level 9)")
        if e1 != at.encode_batch(imgs, codec.config, device="cpu") or \
                not all(_same_payloads(a, codec.compress(im))
                        for a, im in zip(e1, imgs)):
            raise AssertionError(f"{space} {blocks} {shape}: card containers "
                                 "differ from the CPU's (level -1)")
        cpu_dec = [codec.decompress(b).data for b in e1]
        err = max(float(np.abs(d.data - c).max())
                  for d, c in zip(dec, cpu_dec))
        diff = sum(_bits_differ(d.data, c) for d, c in zip(dec, cpu_dec))
        roots = [lay.root_size for lay in ContainerReader(e1[0]).read_layers()]
        log(f"  {space} blocks {blocks} {shape[0]}x{shape[1]} (roots {roots}):"
            f" card containers byte-identical to the CPU Codec's (level 9) "
            f"and the CPU encode_batch's (level -1); decode_batch max abs vs "
            f"the CPU Codec's decode {err:.3g} ({diff} values in other "
            "bits)")
        if err > 1e-5:
            raise AssertionError("small-layer decodes out of tolerance")

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        (png,) = _write_pngs(small_images(1, 64, 64, seed=14), tmp, "icon")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "aejpeg_tpu_torch.cli", "compress", png,
             "-o", tmp], cwd=root, capture_output=True, text=True,
            timeout=300, env=dict(os.environ, PYTHONPATH=root))
        if res.returncode != 0:
            raise AssertionError(f"cli compress exited {res.returncode}: "
                                 f"{res.stderr[-2000:]}")
        with open(os.path.join(tmp, "icon00.ajpg"), "rb") as f:
            blob = f.read()
        if blob != at.Codec(device="cpu").compress(at.ImageData.load(png)):
            raise AssertionError("cli compress of a 64x64 PNG differs from "
                                 "the CPU Codec")
        log(f"  cli compress of a 64x64 PNG at its defaults "
            f"({time.perf_counter() - t0:.3f} s): byte-identical to the CPU "
            "Codec")

        paths = _write_pngs(small_images(2, 96, 128, seed=15), tmp, "sw")
        blocks = [(4, 128), (4, 64), (8, 8)]
        combos = ([QUALITY], blocks)

        def sweep(out):
            s = sweep_batched.BatchedMetricsSweep(
                paths, out, color_spaces=("YCoCg",), quality_ranges=combos[0],
                block_size_ranges=combos[1], entropy_level=-1,
                progress_every=10 ** 9)
            s.run()
            return s.errors, _csv_rows(out)
        errors, rows = sweep(os.path.join(tmp, "bound.csv"))
        if rows or len(errors) != len(blocks) or \
                not all("161" in e for e in errors):
            raise AssertionError(f"sweep of a 96x128 group: {errors[:3]}")
        log(f"  sweep of 2 x 96x128 PNGs: each of its {len(blocks)} combos "
            "stops at MS-SSIM's 161-pixel bound alone, as in both packages")
        with mock.patch.object(
                sweep_batched, "ms_ssim_batch",
                lambda a, b, r: torch.zeros(a.shape[0], device=a.device)):
            errors, rows = sweep(os.path.join(tmp, "rows.csv"))
        if errors or len(rows) != len(paths) * len(blocks):
            raise AssertionError(f"sweep with MS-SSIM stubbed: {errors[:3]}")
        imgs = [at.ImageData.load(p) for p in paths]
        gaps = {"psnr": 0.0, "ssim": 0.0}
        for br in blocks:
            blobs = at.encode_batch(imgs, at.CodecConfig(
                "YCoCg", QUALITY, br, entropy_level=-1))
            for p, img, blob, dec in zip(paths, imgs, blobs,
                                         at.decode_batch(blobs)):
                row = rows[(p, "YCoCg", str(QUALITY[0]), str(QUALITY[1]),
                            str(br[0]), str(br[1]))]
                if row["compression_ratio"] != \
                        f"{img.raw_rgb_bytes / len(blob):.4f}":
                    raise AssertionError(f"sweep {br} {p}: ratio differs")
                ev = at.EvaluationMetrics(img, dec)
                for m in gaps:
                    gaps[m] = max(gaps[m],
                                  abs(float(row[m]) - getattr(ev, m)()))
        log(f"  with MS-SSIM stubbed: all {len(rows)} rows written, ratio "
            "strings identical to encode_batch's on the card, largest gaps "
            f"to encode_batch -> decode_batch -> EvaluationMetrics {gaps} "
            f"({card})")
        if gaps["psnr"] > 2e-2 or gaps["ssim"] > 2e-3:
            raise AssertionError("small-group sweep metrics out of tolerance "
                                 "against the decode path")
    return launches, worst


# ------------------------------------------------------------------ phase 18


def dense_resize_phase(card):
    """Phase 18: the dense resize path on the card against the CPU.  Every
    shape of DENSE_RESIZES, both kinds, on float planes, bitwise; then two
    u8 images and two float images (two batches) of each DENSE_IMAGES
    entry through encode_batch (containers byte-identical card against
    CPU) and decode_batch (within 1e-5).  Returns the launch counts of
    the card runs."""
    import torch
    import aejpeg_tpu_torch as at
    from aejpeg_tpu_torch.ops import resize
    g = torch.Generator(device="cpu").manual_seed(18)
    planes = [torch.rand((2, *src), generator=g) for src, _, _ in
              DENSE_RESIZES]
    batches = []
    for space, (h, w) in DENSE_IMAGES:
        rng = np.random.default_rng(h * w)
        batches.append((space, (h, w), "u8", small_images(2, h, w,
                                                          seed=h + w)))
        batches.append((space, (h, w), "float", [
            at.ImageData.from_array(rng.random((h, w, 3), dtype=np.float32))
            for _ in range(2)]))

    def run():
        outs = [resize.resize2d(x.cuda(), dst, kind).cpu()
                for x, (_, dst, kind) in zip(planes, DENSE_RESIZES)]
        enc = [at.encode_batch(imgs, at.CodecConfig(space, QUALITY, BLOCKS))
               for space, _, _, imgs in batches]
        return outs, enc, [at.decode_batch(b) for b in enc]
    t0 = time.perf_counter()
    (outs, enc, dec), launches = _launches_since_reset(run)
    log(f"  card run {time.perf_counter() - t0:.3f} s; launches {launches}")
    _require_launched("dense resizes", launches, ("banded_resize",
                                                  "f32_to_unit"))
    for x, got, (src, dst, kind) in zip(planes, outs, DENSE_RESIZES):
        want = resize.resize2d(x, dst, kind)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"resize {src} -> {dst} {kind}: card "
                                 "differs from the CPU")
    log(f"  {len(DENSE_RESIZES)} dense resizes (2 float planes each): card "
        "bitwise equal to the CPU: "
        + ", ".join(f"{s[0]}x{s[1]}->{d[0]}x{d[1]} {k}"
                    for s, d, k in DENSE_RESIZES))
    for (space, (h, w), inputs, imgs), blobs, decoded in zip(batches, enc,
                                                             dec):
        cfg = at.CodecConfig(space, QUALITY, BLOCKS)
        cpu = at.encode_batch(imgs, cfg, device="cpu")
        if blobs != cpu:
            raise AssertionError(f"{space} {h}x{w}: card containers differ "
                                 "from the CPU's")
        diff = sum(int((np.ascontiguousarray(a.data, np.float32)
                        .view(np.uint32)
                        != np.ascontiguousarray(b.data, np.float32)
                        .view(np.uint32)).sum()) for a, b in
                   zip(decoded, at.decode_batch(cpu, device="cpu")))
        log(f"  {space} {h}x{w}, 2 {inputs} images: containers "
            f"byte-identical card == CPU ({sum(map(len, blobs))} bytes); "
            f"decode_batch card vs CPU: {diff} values in other bits "
            f"({card})")
        if diff:
            raise AssertionError(f"{space} {h}x{w}: decodes differ")
    return launches


# each kernel's __global__ function, as torch.profiler names it
KERNEL_NAMES = {"histogram256": "hist256_kernel",
                "clahe_apply_gather": "clahe_gather_kernel",
                "clahe_lut_apply": "clahe_lut_apply_kernel",
                "u8_to_unit": "u8_to_unit_kernel",
                "f32_to_unit": "f32_to_unit_kernel",
                "banded_resize": "banded_",
                "dct2d": "dct2d_kernel",
                "bilateral": "bilateral_kernel",
                "hysteresis": "hysteresis_"}
SOURCES = {"histogram256": ("aejpeg_tpu_torch/csrc/histogram256.cu",
                            "aejpeg_tpu/ops/pallas_kernels.py:76"),
           "clahe_apply_gather": ("aejpeg_tpu_torch/csrc/clahe_apply.cu",
                                  "aejpeg_tpu/ops/pallas_kernels.py:299"),
           "clahe_lut_apply": ("aejpeg_tpu_torch/csrc/clahe_apply.cu",
                               "aejpeg_tpu/ops/pallas_kernels.py:362"),
           "u8_to_unit": ("aejpeg_tpu_torch/csrc/u8_to_unit.cu",
                          "aejpeg_tpu/ops/pallas_kernels.py:197"),
           "f32_to_unit": ("aejpeg_tpu_torch/csrc/u8_to_unit.cu",
                           "none: the host's rounding, "
                           "aejpeg_tpu/codec/batch_encode.py:581"),
           "banded_resize": ("aejpeg_tpu_torch/csrc/banded_resize.cu",
                             "aejpeg_tpu/ops/resize.py:168"),
           "dct2d": ("aejpeg_tpu_torch/csrc/banded_resize.cu",
                     "aejpeg_tpu/ops/dct.py:58"),
           "bilateral": ("aejpeg_tpu_torch/csrc/bilateral.cu",
                         "aejpeg_tpu/ops/canny.py:221"),
           "hysteresis": ("aejpeg_tpu_torch/csrc/hysteresis.cu",
                          "aejpeg_tpu/ops/canny.py:341")}


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import aejpeg_tpu_torch as at
    from aejpeg_tpu_torch.native import entropy as native_entropy
    from aejpeg_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"  nvcc builds (parallel, {time.perf_counter() - t0:.2f} s wall): "
        + ", ".join(f"{k} {v:.2f} s" for k, v in built.items()))
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {src}: {line.strip()}")
    t0 = time.perf_counter()
    native = native_entropy.native_available()
    log(f"  native host library built and loaded: {native} "
        f"({time.perf_counter() - t0:.2f} s)")
    if not native:
        raise RuntimeError("native host library did not build")

    log("[2] kernels against their plain versions on the card")
    warm_card(dev)
    summary = check_kernels(dev)

    cfg = at.CodecConfig("YCoCg", QUALITY, BLOCKS, entropy_level=-1)
    big = synth_images(BATCH, H, W, seed=1)
    small = synth_images(2, *SMALL, seed=2)
    log(f"[3] main path: encode_stream -> decode_stream, {BATCH} x {H}x{W} "
        f"+ 2 x {SMALL[0]}x{SMALL[1]}, {cfg}")
    launches = main_path(cfg, big, small)

    log("[4] card against CPU, 2 images; batch vs single on the card")
    bilateral_card_vs_cpu()
    card_vs_cpu(cfg, big[:2])
    push_routes(cfg, big)

    log(f"[5] times, {BATCH} x {H}x{W}, median of {BATCH_REPS} warm batches "
        f"({card})")
    times(cfg, big)

    log("[6] torch.profiler, one warm batch each way")
    profile(cfg, big)

    log(f"[7] colour spaces: encode_batch -> decode_batch, {SPACE_BATCH} x "
        f"{H}x{W} on the card; card against CPU, 1 image each")
    color_spaces(big, card)

    log(f"[8] per-image Codec, {CODEC_IMAGES} x {H}x{W} on the card")
    codec_phase(big, card)

    log("[9] EvaluationMetrics, card against CPU")
    metrics_phase(big, card)

    log(f"[10] batched metric sweep, {SWEEP_IMAGES} x {H}x{W} + 2 x "
        f"{SMALL[0]}x{SMALL[1]} PNGs, {SWEEP_SPACES}")
    sweep_launches = sweep_phase(big, small, card)

    log("[11] CLI in subprocesses on the default device")
    cli_phase(big, card)

    log("[12] speed table, visualizer, normalization")
    harness_phase(big, card)

    log(f"[13] mesh: encode_batch / decode_batch with mesh=, {BATCH} x "
        f"{H}x{W} + 2 x {SMALL[0]}x{SMALL[1]}")
    mesh_launches = mesh_phase(cfg, big, small, card)

    log(f"[14] multihost: two gloo ranks, {MH_IMAGES} x {H}x{W}")
    multihost_phase(card)

    log(f"[15] bench subcommand on {BENCH_DISTINCT} {H}x{W} BMPs")
    bench_phase(big, card)

    log("[16] GUI jobs without Tk")
    gui_phase(big, card)

    log(f"[17] small layers: {len(SMALL_LAYER_CASES)} image shapes whose "
        "quadtree roots lie below the largest block, kernels at "
        f"{len(SMALL_PLANES)} plane shapes")
    small_launches, small_err = small_layers_phase(card)

    log(f"[18] dense resizes: {len(DENSE_RESIZES)} shapes and "
        f"{len(DENSE_IMAGES)} odd or narrow image sizes, card against CPU")
    dense_launches = dense_resize_phase(card)
    log(f"  whole script {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, s in summary.items():
        src, rep = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        "sweep_launches": sweep_launches[name],
                        "mesh_launches": mesh_launches[name],
                        "small_launches": small_launches[name],
                        "dense_launches": dense_launches[name],
                        "max_abs_err": max(s["max_abs_err"],
                                           small_err[name]),
                        "ms": s["ms"],
                        "device_ms": s["device_ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": ("bytes" if s["bytes_ms"] >= s["ops_ms"]
                                     else "operations"),
                        "library_ms": s["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
