"""Share of its roofline of the DCT: the least time the card needs for the
work that the profiled calls' containers need, over the device time of the
kernels that do it.  Reads `dct2d_roofline.encode` (the forward DCT and
quantize) and `dct2d_roofline.decode` (the inverse DCT).

Work, counted from the containers' leaves (not from the kernel's launch
arguments): a leaf of size s takes two s x s by s x s products, 4 s^3 FP32
operations; bytes are each layer plane once as float32 and each leaf's
levels once as int16 (read one way, written the other).  The program
computes every block size densely over the whole plane; that dense work is
logged beside it.
"""

from benchmark.harness import readers

KERNELS = ("dct2d_kernel",)


def read(ctx):
    work = ctx.work
    if not work or not work.get("leaves"):
        return None
    times = work["calls"] * work["repeat"]
    n_images = ctx.config["images"]["count"]
    lo, hi = ctx.config["codec"]["block_size_range"]
    flops = nbytes = dense_flops = 0.0
    for li, (h, w) in enumerate(readers.layer_areas(ctx)):
        nbytes += 4.0 * h * w * n_images
        for s, n in work["leaves"].get(li, {}).items():
            flops += 4.0 * s ** 3 * n
            nbytes += 2.0 * s * s * n
        s = lo
        while s <= hi:
            dense_flops += 4.0 * s * (-(-h // s) * s) * (-(-w // s) * s) \
                * n_images
            s *= 2
    ctx.log(f"{ctx.metric}: dense work {dense_flops * times:.6g} FP32 "
            f"operations against {flops * times:.6g} needed")
    return readers.roofline(ctx, ctx.metric, KERNELS, flops * times,
                            nbytes * times)
