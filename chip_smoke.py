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
     (relative for LPIPS).

Prints the kernels as one JSON line, the card's name and power limit, and
last {"ok": true, "device": {...}}.  Exits non-zero without that line when
CUDA is unavailable or any phase fails.
"""

import json
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
CODEC_IMAGES = 4          # images through the per-image Codec in phase 8
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


def metrics_phase(big, card):
    """Phase 9: EvaluationMetrics on the card against the CPU."""
    import os
    import tempfile
    import aejpeg_tpu_torch as at
    from aejpeg_tpu_torch.metrics import lpips
    cfg = at.CodecConfig("YCoCg", QUALITY, BLOCKS, entropy_level=-1)
    a = big[0].data
    b = at.decode_batch(at.encode_batch(big[:1], cfg))[0].data
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
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lpips_random.npz")
        np.savez(path, **params)
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

    kernels = []
    for name, s in summary.items():
        src, rep = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
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
