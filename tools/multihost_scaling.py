#!/usr/bin/env python3
"""Throughput of the PyTorch port's multi-process data parallelism
(aejpeg_tpu_torch/parallel/multihost.py) on one host with several cards:
N gloo ranks, one process per card, for N = 1, 2, 4, ... up to the visible
cards.  Every rank encodes its shard of a 672-image 512x768 stream (42
synthetic images of chip_smoke.py x 16, the bench config, batches of 42)
with encode_stream_sharded, then decodes its shard with
decode_stream_sharded, each timed between two barriers after a warm-up
stream of two batches.  Aggregate Mpix/s = the stream's Mpix / the time
between barriers.

    python3 tools/multihost_scaling.py

Exits non-zero when CUDA is absent or a rank fails.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DISTINCT = 42
REPEAT = 16
BATCH = 42

_WORKER = r"""
import json, sys, time
sys.path.insert(0, %(root)r)
import torch
import torch.distributed as dist
from chip_smoke import synth_images, H, W, QUALITY, BLOCKS
from aejpeg_tpu_torch import CodecConfig, encode_stream, decode_stream
from aejpeg_tpu_torch.parallel import multihost as mh
rank, world = %(rank)d, %(world)d
dev = torch.device("cuda", rank)
mh.initialize(%(coord)r, world, rank)
images = synth_images(%(distinct)d, H, W, seed=1) * %(repeat)d
cfg = CodecConfig("YCoCg", QUALITY, BLOCKS, entropy_level=-1)
decode_stream(encode_stream(images[:2 * %(batch)d], cfg,
                            batch_size=%(batch)d, device=dev),
              batch_size=%(batch)d, device=dev)
dist.barrier()
t0 = time.perf_counter()
idxs, blobs = mh.encode_stream_sharded(images, cfg, batch_size=%(batch)d,
                                       device=dev)
dist.barrier()
t1 = time.perf_counter()
parts = [None] * world
dist.all_gather_object(parts, (idxs, blobs))
merged = dict(kv for p in parts for kv in zip(*p))
everything = [merged[i] for i in range(len(images))]
dist.barrier()
t2 = time.perf_counter()
didxs, decoded = mh.decode_stream_sharded(everything, batch_size=%(batch)d,
                                          device=dev)
dist.barrier()
t3 = time.perf_counter()
with open(%(out)r, "w") as f:
    json.dump({"rank": rank, "images": len(idxs), "encode_s": t1 - t0,
               "decode_s": t3 - t2, "bytes": sum(map(len, blobs))}, f)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, tmp: str):
    coord = f"127.0.0.1:{_free_port()}"
    outs = [os.path.join(tmp, f"w{world}_r{r}.json") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER % {
            "root": ROOT, "coord": coord, "rank": r, "world": world,
            "out": outs[r], "distinct": DISTINCT, "repeat": REPEAT,
            "batch": BATCH}],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=600)
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {world} exited "
                                   f"{p.returncode}: "
                                   f"{err.decode(errors='replace')[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    res = []
    for path in outs:
        with open(path) as f:
            res.append(json.load(f))
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("multihost_scaling: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from aejpeg_tpu_torch.native import entropy as native_entropy
    from aejpeg_tpu_torch.ops import _build
    cards = torch.cuda.device_count()
    cs.log(f"{cards} card(s): {'; '.join(cs.card_line().splitlines())}")
    _build.build_all()
    if not native_entropy.native_available():
        raise RuntimeError("native host library did not build")
    mpix = DISTINCT * REPEAT * cs.H * cs.W / 1e6
    base = None
    with tempfile.TemporaryDirectory() as tmp:
        world = 1
        while world <= cards:
            t0 = time.perf_counter()
            res = run_ranks(world, tmp)
            wall = time.perf_counter() - t0
            enc = max(r["encode_s"] for r in res)
            dec = max(r["decode_s"] for r in res)
            if base is None:
                base = (enc, dec)
            cs.log(f"  {world} rank(s), one card each: "
                   f"{DISTINCT * REPEAT} x {cs.H}x{cs.W} encode "
                   f"{mpix / enc:.3f} Mpix/s ({enc:.3f} s, {base[0] / enc:.3f}"
                   f"x one rank), decode {mpix / dec:.3f} Mpix/s ({dec:.3f} "
                   f"s, {base[1] / dec:.3f}x); per rank "
                   + ", ".join(f"{r['rank']}: {r['images']} images "
                               f"{r['encode_s']:.3f} / {r['decode_s']:.3f} s"
                               for r in res)
                   + f"; {wall:.3f} s from spawn to exit")
            world *= 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
