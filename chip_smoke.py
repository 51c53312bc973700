#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (aejpeg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card and build: the card's name and power limit, then the CUDA
     kernels (nvcc, sm_90a) and the native host library (g++), with their
     build times;
  2. kernels against their plain PyTorch versions on the card, at the
     shapes the main path gives them (u8_to_unit also at every u8 value,
     odd sizes and offset pointers; the CLAHE gather also at shapes with
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
  4. the card against the CPU on 2 images (byte-identical containers and
     decodes within 1e-5 expected), and batch-vs-single container identity
     on the card;
  5. encode and decode Mpix/s of the 42-image batch (median of 5 warm
     batches) with each stage's time;
  6. a torch.profiler trace of one warm batch each way: device-busy share
     and the ops with the most device time;
  7. each of the seven colour spaces through encode_batch -> decode_batch
     on 8 x 512x768 on the card (PSNR > 25 dB, encode/decode Mpix/s, the
     kernels it launched), then the card against the CPU on one image per
     space under phase 4's tolerances;
  8. the per-image Codec on the card, 4 x 512x768, YCoCg q20-80 blocks
     4-128 and YCbCr 8x8: containers payload-identical to encode_batch's on
     the card, decodes within 1e-5 of decode_batch's, mean per-image
     compress / decompress ms, the kernels it launched;
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
     path's and decodes within 3e-6 of it (the JAX package's bound), 41
     images refused, encode/decode Mpix/s of mesh and single device (median
     of 3), every kernel launched;
 14. multihost: two ranks in subprocesses rendezvous over gloo on
     localhost, each runs encode_stream_sharded then decode_stream_sharded
     on its half of 12 x 512x768 on the card: the union of containers
     byte-identical to encode_stream in process, decodes within 1e-5 of
     decode_stream;
 15. `python -m aejpeg_tpu_torch.cli bench` in a subprocess on 14 512x768
     BMPs written by the port's I/O: its JSON line parsed, value > 0, PSNR
     > 25 dB, its stage lines echoed;
 16. the GUI's jobs without Tk: the preview job (ratio > 1, > 25 dB), the
     compress job (sibling .ajpg files byte-identical to encode_batch) and
     the decompress job (images written back, > 25 dB).

Prints the kernels as one JSON line (with their launches in phase 3, in
the sweep and on the mesh), the card's name and power limit, and
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
BATCH_REPS = 5            # warm batches timed in phase 5
SPACE_BATCH = 8           # images per colour space in phase 7
SPACE_REPS = 3            # warm batches timed per space in phase 7
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


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_ms(fn, kernel, reps=REPS):
    """Device time of one fn() in the kernel named `kernel`: torch.profiler
    over `reps` back-to-back calls (as cuda_ms makes them), the device time
    of the events whose name holds `kernel`, over `reps`.  None when the
    trace holds no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and kernel in e.key]
    if not hits:
        return None
    return sum(_dev_us(e) for e in hits) / 1e3 / reps


# ------------------------------------------------------------------ phase 2


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
             "clahe_lut_apply": [], "u8_to_unit": []}

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
    return cases


def check_kernels(dev):
    """Phase 2: every kernel against its plain version, bitwise, with
    times.  Returns {name: summary dict}."""
    import torch
    summary = {}
    for name, cases in kernel_cases(dev).items():
        tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0,
               "library_ms": 0.0 if cases[0][4] is not None else None,
               "max_abs_err": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
        for label, args, plain, kern, lib, nbytes, ops, on_path in cases:
            got = kern(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"{name} {label}: shape/dtype mismatch")
            same = torch.equal(got.view(torch.int32), ref.view(torch.int32))
            err = float((got.to(torch.float64) - ref.to(torch.float64))
                        .abs().max())
            if not same:
                raise AssertionError(
                    f"{name} {label}: kernel differs from its plain version "
                    f"(max abs {err})")
            ms = cuda_ms(lambda: kern(*args))
            dms = device_ms(lambda: kern(*args), KERNEL_NAMES[name])
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
                f"{ops / 1e6:.1f} M ops: {ops_ms:.4f} ms)"
                + ("" if on_path else "; not on the phase-3 path"))
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            if not on_path:
                continue
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
    return summary


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
    _require_launched("main path", launches, launches)
    return launches


def card_vs_cpu(cfg, imgs, singles=True):
    """Phase 4: the same images on cuda and on the CPU, held to the
    tolerances of tests/test_torch_codec.py: packed edge-level bits >=
    99.9% equal, coefficients >= 99.99% equal with |d| <= 1 where the
    state streams agree, decodes within 1e-5 and PSNR within 0.1 dB; then
    (singles) batch-vs-single container identity on cuda."""
    import torch
    import aejpeg_tpu_torch as at
    from aejpeg_tpu_torch.codec.batch_encode import _host_batch, _stage_a
    from aejpeg_tpu_torch.codec.tables import spec_for
    from aejpeg_tpu_torch.io.container import ContainerReader
    host = torch.from_numpy(_host_batch(imgs))
    spec = spec_for(cfg, imgs[0].original_shape[:2])
    mn, mx = cfg.block_size_range
    band = (mn.bit_length(), mx.bit_length() - 1)   # node sizes 2mn..mx
    lv_gpu = _stage_a(host.cuda(), cfg.color_space, band, spec)[1].cpu()
    lv_cpu = _stage_a(host, cfg.color_space, band, spec)[1]
    bits_g = np.unpackbits(lv_gpu.numpy(), axis=1)
    bits_c = np.unpackbits(lv_cpu.numpy(), axis=1)
    agree = float((bits_g == bits_c).mean())
    log(f"  packed edge-level bits: {agree:.6f} equal")
    if agree < 0.999:
        raise AssertionError("cuda/cpu edge levels out of tolerance")
    gpu = at.encode_batch(imgs, cfg)
    cpu = at.encode_batch(imgs, cfg, device="cpu")
    for i, (a, b) in enumerate(zip(gpu, cpu)):
        if a == b:
            log(f"  image {i}: cuda and cpu containers byte-identical")
            continue
        ra, rb = ContainerReader(a), ContainerReader(b)
        if ra.metadata != rb.metadata:
            raise AssertionError("cuda/cpu metadata differ")
        for li, (la, lb) in enumerate(zip(ra.read_layers(),
                                          rb.read_layers())):
            if la.states_bytes != lb.states_bytes:
                log(f"  image {i} layer {li}: state streams differ")
                continue
            eq = float((la.coeffs == lb.coeffs).mean())
            dmax = int(np.abs(la.coeffs.astype(np.int64) - lb.coeffs).max())
            log(f"  image {i} layer {li}: coefficients {eq:.6f} equal, "
                f"max |d| {dmax}")
            if eq < 0.9999 or dmax > 1:
                raise AssertionError("cuda/cpu coefficients out of tolerance")
    dg = at.decode_batch(gpu)
    dc = at.decode_batch(gpu, device="cpu")
    for i, (a, b) in enumerate(zip(dg, dc)):
        err = float(np.abs(a.data - b.data).max())
        dpsnr = abs(psnr_db(imgs[i].data, a.data)
                    - psnr_db(imgs[i].data, b.data))
        log(f"  image {i}: cuda vs cpu decode max abs {err:.3g}, "
            f"PSNR gap {dpsnr:.3g} dB")
        if err > 1e-5 or dpsnr > 0.1:
            raise AssertionError("cuda/cpu decodes out of tolerance")
    if not singles:
        return
    singles = [at.encode_batch([im], cfg)[0] for im in imgs]
    if singles != gpu:
        raise AssertionError("batch-vs-single containers differ on cuda")
    log("  batch-vs-single containers byte-identical on cuda")


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
        eq = [e.count for e in events if e.key == "aten::equal"]
        if name == "encode_batch" and eq:
            log(f"    hysteresis convergence checks (aten::equal): {eq[0]}")

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
                          ("u8_to_unit", "histogram256", "clahe_apply_gather"))
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
             ("histogram256", "clahe_apply_gather")),
            (at.CodecConfig("YCbCr", (50, 50), (8, 8), entropy_level=-1),
             ())):
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
        err = max(float(np.abs(a.data - b.data).max())
                  for a, b in zip(dec, at.decode_batch(ref)))
        worst = min(psnr_db(im.data, d.data) for im, d in zip(imgs, dec))
        log(f"  Codec {cfg.color_space} q{cfg.quality_range} blocks "
            f"{cfg.block_size_range}: payload-identical to encode_batch, "
            f"decode max abs vs decode_batch {err:.3g}, worst PSNR "
            f"{worst:.3f} dB; per image compress "
            f"{statistics.mean(tc) * 1e3:.3f} ms, decompress "
            f"{statistics.mean(td) * 1e3:.3f} ms (mean of {len(imgs)}, "
            f"{card}); launches {launches}")
        if err > 1e-5 or worst <= 25.0:
            raise AssertionError("Codec decodes out of tolerance")


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
        _require_launched("sweep", launches, launches)
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
                          ("u8_to_unit", "histogram256",
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
        _require_launched("speed table", launches, ("u8_to_unit",))
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
        log(f"  {label}: {len(imgs)} x {H}x{W}"
            + (f" + {len(pair)} x {SMALL[0]}x{SMALL[1]}" if pair else "")
            + f", containers byte-identical to the single-device path's; "
            f"decode max abs vs single device {err!r}; launches {launches}")
        if err > 3e-6:
            raise AssertionError(f"{label}: decode differs by {err}")
        if first is None:
            _require_launched(label, launches, launches)
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
    log(f"  union of {MH_IMAGES} containers byte-identical to encode_stream;"
        f" decodes max abs vs decode_stream {err!r}; two ranks' wall "
        f"{wall:.3f} s from spawn to exit ({card})")
    if err > 1e-5:
        raise AssertionError("multihost decodes out of tolerance")


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
                          ("u8_to_unit", "histogram256",
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


# each kernel's __global__ function, as torch.profiler names it
KERNEL_NAMES = {"histogram256": "hist256_kernel",
                "clahe_apply_gather": "clahe_gather_kernel",
                "clahe_lut_apply": "clahe_lut_apply_kernel",
                "u8_to_unit": "u8_to_unit_kernel"}
SOURCES = {"histogram256": ("aejpeg_tpu_torch/csrc/histogram256.cu",
                            "aejpeg_tpu/ops/pallas_kernels.py:76"),
           "clahe_apply_gather": ("aejpeg_tpu_torch/csrc/clahe_apply.cu",
                                  "aejpeg_tpu/ops/pallas_kernels.py:299"),
           "clahe_lut_apply": ("aejpeg_tpu_torch/csrc/clahe_apply.cu",
                               "aejpeg_tpu/ops/pallas_kernels.py:362"),
           "u8_to_unit": ("aejpeg_tpu_torch/csrc/u8_to_unit.cu",
                          "aejpeg_tpu/ops/pallas_kernels.py:197")}


def main() -> int:
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
    summary = check_kernels(dev)

    cfg = at.CodecConfig("YCoCg", QUALITY, BLOCKS, entropy_level=-1)
    big = synth_images(BATCH, H, W, seed=1)
    small = synth_images(2, *SMALL, seed=2)
    log(f"[3] main path: encode_stream -> decode_stream, {BATCH} x {H}x{W} "
        f"+ 2 x {SMALL[0]}x{SMALL[1]}, {cfg}")
    launches = main_path(cfg, big, small)

    log("[4] card against CPU, 2 images; batch vs single on the card")
    card_vs_cpu(cfg, big[:2])

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

    kernels = []
    for name, s in summary.items():
        src, rep = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        "sweep_launches": sweep_launches[name],
                        "mesh_launches": mesh_launches[name],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
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
