"""Codec benchmark of the port: prints ONE JSON line,
{"metric", "value", "unit", "vs_baseline"}, with its stage lines on stderr.

    python -m aejpeg_tpu_torch.bench --images DIR [--device cpu]
    aejpeg-torch bench --images DIR

Counterpart of the JAX package's root bench.py, measuring the same things
on a card: the flagship quadtree-active configuration (YCoCg, quality
20-80, blocks 4-128, native sparse entropy coder) on the LIVE database's
512x768 BMPs, 14 distinct images x 3 = a 42-image batch.

Headline: the steady-state encode stream period, MEASURED.  The main
thread runs batch i's push, stage A, stage B and table pull while a worker
thread runs batch i-1's host stages (quadtree planning + C++ assembly and
entropy coding); the period is the time between completions.  The
host<->device copies ride PCIe and are inside the timed stream; the
batch's float -> u8 conversion is not (the stream's input is the u8 batch
on the host, as a u8-keeping loader hands it over).  Reported beside it:
the synchronous single-batch stage profile (every stage and copy),
device_busy (back-to-back device pipelines on a device-resident batch) and
host_busy (planning + assembly), the measured decode stream (parse of
batch i+1 on a worker, push + stage D of batch i; the decoded images stay
on the device), PSNR, compression ratio and the p50 wall time of a
single-image encode_batch.

Environment knobs, as bench.py's: AEJ_BENCH_BLOCKS ("4,128"),
AEJ_BENCH_BATCH (14 distinct images), AEJ_BENCH_REPLICATE (3),
AEJ_BENCH_ITERS (4), AEJ_BENCH_DEVICE_REPS (8), AEJ_BENCH_STREAM (17
stream batches, at least 3); AEJ_BENCH_IMAGES is --images' default.
"""

import argparse
import glob
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import resolve_device
from .io.image import ImageData, image_size

SHAPE = (512, 768)
SPACE = "YCoCg"
QUALITY = (20, 80)
ENTROPY_LEVEL = -1      # native sparse deflate; any level is spec-valid zlib
TARGET_MPIX_S = 500.0   # the JAX package's encode target (BASELINE.json)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def settings() -> Dict:
    """The AEJ_BENCH_* knobs, read when called."""
    env = os.environ.get
    return {"blocks": tuple(int(x) for x in
                            env("AEJ_BENCH_BLOCKS", "4,128").split(",")),
            "batch": int(env("AEJ_BENCH_BATCH", 14)),
            "replicate": int(env("AEJ_BENCH_REPLICATE", 3)),
            "iters": int(env("AEJ_BENCH_ITERS", 4)),
            "device_reps": int(env("AEJ_BENCH_DEVICE_REPS", 8)),
            "stream": max(3, int(env("AEJ_BENCH_STREAM", 17)))}


def load_images(directory: str) -> List[ImageData]:
    """The first AEJ_BENCH_BATCH 512x768 BMPs of `directory` (by name),
    repeated AEJ_BENCH_REPLICATE times."""
    s = settings()
    imgs = []
    for p in sorted(glob.glob(os.path.join(directory, "*.bmp"))):
        if image_size(p) == SHAPE:
            imgs.append(ImageData.load(p))
        if len(imgs) == s["batch"]:
            break
    if not imgs:
        raise FileNotFoundError(f"no {SHAPE[0]}x{SHAPE[1]} .bmp image in "
                                f"{directory!r}")
    return (imgs * s["replicate"])[:s["batch"] * s["replicate"]]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _quartiles(stamps: List[float]) -> Tuple[float, float, float, int]:
    """(median, q1, q3, count) of the periods between consecutive
    completion stamps."""
    diffs = np.diff(np.asarray(stamps))
    return (float(np.median(diffs)), float(np.percentile(diffs, 25)),
            float(np.percentile(diffs, 75)), len(diffs))


def run(images: List[ImageData], device=None) -> Tuple[Dict, Dict]:
    """Benchmark same-shape `images` as one batch on `device` (None: CUDA).
    Returns (the JSON line's dict, every measured number)."""
    from .codec import batch_decode as bd
    from .codec import batch_encode as be
    from .codec.tables import device_tables, spec_for
    from .config import CodecConfig
    from .io.container import ContainerReader
    from .metrics.quality import psnr

    dev = resolve_device(device)
    s = settings()
    iters = s["iters"]
    b = len(images)
    h, w = images[0].original_shape[:2]
    mpix = b * h * w / 1e6
    cfg = CodecConfig(SPACE, QUALITY, s["blocks"],
                      entropy_level=ENTROPY_LEVEL)
    layer_shapes = cfg.layer_shapes((h, w))
    band = be.level_band(cfg)
    spec = spec_for(cfg, (h, w))
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    st: Dict = {"device": card, "images": b, "mpix": mpix}

    _log(f"warm-up on {card}...")
    blobs = be.encode_batch(images, cfg, device=dev)

    # ---- synchronous single-batch stage profile
    timings: Dict[str, float] = {}
    for _ in range(iters):
        blobs = be.encode_batch(images, cfg, timings=timings, device=dev)
    timings = {k: v / iters for k, v in timings.items()}
    st["encode_stages_s"] = timings
    st["encode_sync_mpix_s"] = mpix / sum(timings.values())
    _log(f"per-batch stage times: "
         f"{ {k: round(v, 4) for k, v in timings.items()} }")

    # ---- device_busy: back-to-back device pipelines, device-resident input
    host = be._host_batch(images)
    batch_dev = torch.from_numpy(host).to(dev)
    tables = device_tables(cfg, (h, w), b, dev)

    def device_once():
        gp, pb = be._stage_a(batch_dev, cfg.color_space, band, spec)
        return be._stage_b(gp, spec, tables, b), pb

    _, pb = device_once()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(s["device_reps"]):
        _, pb = device_once()
    _sync(dev)
    device_busy = (time.perf_counter() - t0) / s["device_reps"]

    # ---- host_busy: planning on the pulled levels + the measured assembly
    levels_bits = pb.cpu().numpy()
    t0 = time.perf_counter()
    for _ in range(iters):
        be._build_plans(cfg, layer_shapes, levels_bits, band, b)
    plans_host = (time.perf_counter() - t0) / iters
    host_busy = plans_host + timings["assemble"]
    model = max(device_busy, host_busy)
    st.update(device_busy_s=device_busy, host_busy_s=host_busy,
              plans_s=plans_host, model_period_s=model)
    _log(f"pipelined model: device_busy {device_busy:.4f} s, host_busy "
         f"{host_busy:.4f} s (plans {plans_host:.4f} + assemble "
         f"{timings['assemble']:.4f}) -> {mpix / model:.3f} Mpix/s")

    # ---- MEASURED encode stream: batch i's device side and pulls on this
    # thread, batch i-1's host stages on a worker; a stamp when both are
    # done (from i = 1: every period holds one of each).  The pulled tables
    # are double-buffered (pinned scratch key i % 2)
    def device_stage(i):
        levels, flat = be._device_shard(host, cfg, (h, w), b, dev)
        return levels, be.carve_tables(
            be.to_host(flat, f"bench_tables_{i % 2}"), spec, b)

    def host_stage(levels, tabs):
        plans = be._build_plans(cfg, layer_shapes, levels, band, b)
        be.assemble_native(cfg, spec, plans, [tabs], b)

    host_stage(*device_stage(0))
    stamps = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = None
        for i in range(s["stream"]):
            out = device_stage(i)
            if fut is not None:
                fut.result()
                stamps.append(time.perf_counter())
            fut = pool.submit(host_stage, *out)
        fut.result()
    period, q1, q3, n_enc = _quartiles(stamps)
    rate = mpix / period
    st.update(encode_period_s=period, encode_period_iqr_s=(q1, q3),
              encode_stream_mpix_s=rate)
    _log(f"measured stream: {n_enc} warm periods, median "
         f"{period * 1e3:.3f} ms IQR [{q1 * 1e3:.3f}, {q3 * 1e3:.3f}] "
         f"(model {model * 1e3:.3f} ms) -> {rate:.3f} Mpix/s")
    ratio = b * h * w * 3 / sum(len(x) for x in blobs)

    # ---- decode: synchronous profile (images stay on the device)
    dev_out, _ = bd.decode_batch(blobs, device=dev, materialize=False)
    dtim: Dict[str, float] = {}
    for _ in range(iters):
        dev_out, _ = bd.decode_batch(blobs, timings=dtim, device=dev,
                                     materialize=False)
    dtim = {k: v / iters for k, v in dtim.items()}
    out0 = dev_out[0].cpu().numpy()
    st["decode_stages_s"] = dtim
    st["decode_sync_mpix_s"] = mpix / sum(dtim.values())
    _log(f"per-batch decode stage times: "
         f"{ {k: round(v, 4) for k, v in dtim.items()} }")

    # ---- MEASURED decode stream: parse of batch i+1 on a worker into
    # scratch (i + 1) % 2, push + stage D of batch i on this thread
    dcfg = CodecConfig(SPACE, QUALITY, s["blocks"])   # as the metadata says

    def parse(i):
        payloads = [[r.read_layer_raw() for _ in range(3)]
                    for r in map(ContainerReader, blobs)]
        arenas = [bd.host_arenas(f"bench_dec_{i % 2}", spec, b, dev)]
        bd.parse_into_arenas(payloads, spec, arenas, b)
        return arenas[0]

    arenas = parse(0)
    stamps = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        for i in range(s["stream"]):
            fut = pool.submit(parse, i + 1)
            bd._device_shard(*arenas, dcfg, (h, w), b, dev)
            _sync(dev)
            arenas = fut.result()
            stamps.append(time.perf_counter())
    dperiod, dq1, dq3, _ = _quartiles(stamps)
    dec_rate = mpix / dperiod
    st.update(decode_period_s=dperiod, decode_period_iqr_s=(dq1, dq3),
              decode_stream_mpix_s=dec_rate)
    _log(f"decode measured stream: median {dperiod * 1e3:.3f} ms IQR "
         f"[{dq1 * 1e3:.3f}, {dq3 * 1e3:.3f}] -> {dec_rate:.3f} Mpix/s")

    p = float(psnr(torch.from_numpy(images[0].data), torch.from_numpy(out0)))

    # ---- p50 single-image latency: full wall of encode_batch, every stage
    # and copy included
    lat = []
    for _ in range(9):
        _sync(dev)
        t0 = time.perf_counter()
        be.encode_batch(images[:1], cfg, device=dev)
        lat.append(time.perf_counter() - t0)
    p50_ms = sorted(lat)[len(lat) // 2] * 1e3
    st.update(psnr_db=p, ratio=ratio, p50_single_ms=p50_ms)
    _log(f"single-image p50: {p50_ms:.3f} ms (full wall); PSNR {p:.3f} dB, "
         f"CR {ratio:.3f}x")

    mn, mx = s["blocks"]
    line = {
        "metric": (
            f"encode Mpix/s, pipelined stream MEASURED over {n_enc} warm "
            f"batches on {card} (median period {period * 1e3:.1f} ms, IQR "
            f"[{q1 * 1e3:.1f}, {q3 * 1e3:.1f}] -> [{mpix / q3:.1f}, "
            f"{mpix / q1:.1f}] Mpix/s; model max(device "
            f"{device_busy * 1e3:.1f} ms, host {host_busy * 1e3:.1f} ms)): "
            f"push, stage A, stage B and table pull of batch i overlapped "
            f"with plans + C++ assembly of batch i-1, host<->device copies "
            f"over PCIe included, the float->u8 conversion not. "
            f"{h}x{w} x{b}, {SPACE} q{QUALITY[0]}-{QUALITY[1]} blocks "
            f"{mn}-{mx} quadtree; synchronous batch "
            f"{st['encode_sync_mpix_s']:.1f} Mpix/s (every stage and copy); "
            f"decode stream {dec_rate:.1f} (IQR period [{dq1 * 1e3:.1f}, "
            f"{dq3 * 1e3:.1f}] ms, images left on the device) / sync "
            f"{st['decode_sync_mpix_s']:.1f} Mpix/s; p50 single-image "
            f"encode {p50_ms:.1f} ms full wall; PSNR {p:.2f} dB, CR "
            f"{ratio:.1f}x"),
        "value": round(rate, 2),
        "unit": "Mpix/s",
        "vs_baseline": round(rate / TARGET_MPIX_S, 4),
    }
    return line, st


def add_images_arg(p: argparse.ArgumentParser) -> None:
    env = os.environ.get("AEJ_BENCH_IMAGES")
    p.add_argument("--images", default=env, required=env is None,
                   help="directory of the LIVE database's 512x768 .bmp "
                        "images (default: $AEJ_BENCH_IMAGES)")


def report(images_dir: str, device=None) -> Dict:
    """run() on load_images(images_dir); prints the JSON line."""
    line, _ = run(load_images(images_dir), device)
    print(json.dumps(line), flush=True)
    return line


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m aejpeg_tpu_torch.bench",
                                description="encode/decode throughput of "
                                            "the port")
    add_images_arg(p)
    p.add_argument("--device", default=None,
                   help="cuda (default; fails without a CUDA device) or cpu")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        p.error(str(e))
    report(args.images, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
