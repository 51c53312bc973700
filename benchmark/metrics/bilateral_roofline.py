"""Share of its roofline of the Canny stack's bilateral filter: the least
time the card needs for the window's planes, over the device time of the
kernel that does it.

Work: every pixel of every layer plane of every image encoded takes the
taps of the disk of radius d // 2 (13 for d = 5), each tap 4 FP32
operations (its weight's product, a multiply-add into the numerator, an
add into the denominator), and one division; the uint8 plane is read once
and written once (2 bytes a pixel).
"""

from benchmark.harness import readers

KERNELS = ("bilateral_kernel",)
D = 5


def read(ctx):
    work = ctx.work
    if not work:
        return None
    r = D // 2
    taps = sum(1 for dy in range(-r, r + 1) for dx in range(-r, r + 1)
               if dy * dy + dx * dx <= r * r)
    images = ctx.config["images"]["count"] * work.get("repeat", 1) \
        * work["calls"]
    pixels = images * sum(h * w for h, w in readers.layer_areas(ctx))
    return readers.roofline(ctx, "bilateral", KERNELS,
                            pixels * (4.0 * taps + 1.0), 2.0 * pixels)
