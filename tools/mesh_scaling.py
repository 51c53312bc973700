#!/usr/bin/env python3
"""Phase 13 of chip_smoke.py on its own, for a machine with several cards:
encode_batch / decode_batch of the PyTorch port with mesh= over a (2, 1)
mesh naming cuda:0 twice and over 2, 4, ... cards, each against the
single-device path on the same batch (containers byte-identical, decodes
within 3e-6, Mpix/s median of 3); then where each mesh's time goes: stage
times, and the shards' device side dispatched from one thread per shard
against in turn from the caller's thread (what run_shards does).

    python3 tools/mesh_scaling.py

Builds the kernels first; exits non-zero when CUDA is absent or a check
fails.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_scaling: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import aejpeg_tpu_torch as at
    from aejpeg_tpu_torch.native import entropy as native_entropy
    from aejpeg_tpu_torch.ops import _build

    card = "; ".join(cs.card_line().splitlines())
    cs.log(f"{torch.cuda.device_count()} card(s): {card}")
    _build.build_all()
    if not native_entropy.native_available():
        raise RuntimeError("native host library did not build")
    cfg = at.CodecConfig("YCoCg", cs.QUALITY, cs.BLOCKS, entropy_level=-1)
    big = cs.synth_images(cs.BATCH, cs.H, cs.W, seed=1)
    small = cs.synth_images(2, *cs.SMALL, seed=2)
    launches = cs.mesh_phase(cfg, big, small, card)
    cs.log(f"launches on the (2, 1) mesh: {launches}")
    breakdown(cfg, big)
    return 0


def _stages(run, reps=3):
    """Median per-stage ms of run(timings) over `reps` calls."""
    import statistics
    rows = []
    for _ in range(reps):
        st = {}
        run(st)
        rows.append(st)
    return {k: round(statistics.median(r[k] for r in rows) * 1e3, 3)
            for k in rows[0]}


def breakdown(cfg, big):
    """Where a mesh's time goes: encode/decode stage times (timings=) of
    each mesh against the single-device path, and the shards' device side
    (push, stage A, stage B, synchronized) dispatched from one host thread
    per shard against in turn from the caller's thread, as run_shards
    does."""
    import statistics
    import time
    from concurrent.futures import ThreadPoolExecutor
    import torch
    import chip_smoke as cs
    import aejpeg_tpu_torch as at
    from aejpeg_tpu_torch.codec import batch_encode as be
    from aejpeg_tpu_torch.parallel import make_mesh
    from aejpeg_tpu_torch.parallel.batch import run_shards
    from aejpeg_tpu_torch.parallel.mesh import shard_devices
    meshes = [("(2, 1) on cuda:0", make_mesh((2, 1),
                                             devices=["cuda:0"] * 2))]
    n = 2
    while n <= torch.cuda.device_count():
        meshes.append((f"{n} cards", make_mesh(
            devices=[f"cuda:{i}" for i in range(n)])))
        n *= 2
    for label, mesh in meshes:
        imgs = big[:len(big) - len(big) % mesh.size]
        blobs = at.encode_batch(imgs, cfg)
        cs.log(f"  {label}, {len(imgs)} images, stage ms (median of 3):")
        for name, run in (
                ("encode single", lambda st: at.encode_batch(
                    imgs, cfg, timings=st)),
                ("encode mesh  ", lambda st: at.encode_batch(
                    imgs, cfg, timings=st, mesh=mesh)),
                ("decode single", lambda st: at.decode_batch(
                    blobs, timings=st)),
                ("decode mesh  ", lambda st: at.decode_batch(
                    blobs, timings=st, mesh=mesh))):
            cs.log(f"    {name} {_stages(run)}")
        devs = shard_devices(mesh)
        b_loc = len(imgs) // len(devs)
        host = be._host_batch(imgs)

        def shard(k, dev):
            out = be._device_shard(host[k * b_loc:(k + 1) * b_loc], cfg,
                                   (cs.H, cs.W), b_loc, dev)
            torch.cuda.synchronize(dev)
            return out

        def threaded():
            with ThreadPoolExecutor(max_workers=len(devs)) as pool:
                futs = [pool.submit(in_turn_one, k, d)
                        for k, d in enumerate(devs)]
                for f in futs:
                    f.result()

        def in_turn_one(k, dev):
            run_shards(lambda _, d: shard(k, d), [dev])

        def serial():
            run_shards(shard, devs)
        for name, fn in (("one thread per shard", threaded),
                         ("in turn from the caller (run_shards)", serial)):
            fn()
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            cs.log(f"    shards' device side, {name}: "
                   f"{statistics.median(ts) * 1e3:.3f} ms "
                   f"(all {[round(t * 1e3, 3) for t in ts]})")


if __name__ == "__main__":
    sys.exit(main())
