"""Hold the port's XLA-ordered contractions (ops/xla_dot.py) to XLA's CPU
dot, and read XLA's values the port takes as constants.

    python3 tools/xla_dot_order.py check M K N [M K N ...]
    python3 tools/xla_dot_order.py scan          # small-m grid, k 8 9 37 100
    python3 tools/xla_dot_order.py thin [M,...]  # thin planes: m 2-50, k > 512
    python3 tools/xla_dot_order.py nan           # NaN payloads vs jax.jit
    python3 tools/xla_dot_order.py resize [ROOT] # resize2d vs jax.jit
    python3 tools/xla_dot_order.py dct [--bench] # the DCTs vs jax.jit
    python3 tools/xla_dot_order.py ictcp [N]     # ICtCp near black

`check` multiplies dense random float32 operands (M, K) @ (K, N) with
jax.jit(jnp.dot(..., precision="highest")) on the CPU, the B operand baked
into the program as a constant as the resize and DCT weights are, and
through the port's band of that dot (`xla_dot_order(M, K, N)` laid out by
`make_band`, summed by ops/kernels.banded_resize_plain): per column and
row region, `lanes` FMA chains over the k of each residue (each FMA
rounding once) and their tree sum per k-block, the blocks added in order,
then the tree sum of the tail products, all flushed to zero below 2**-126.
It prints the order and the count of results whose bits differ (0 when the
order is right).  `scan` prints, for a grid of small m, the lane count
whose order reproduces XLA's bits ('X' if none of 1, 2, 4 does).
`thin` runs `check` over the thin, long dots of a narrow image's resize:
m 2-50 (or the m given), k 513, 600, 700, 1100, 1500, 2048 and n 65,
100, 128, 200, 1200 (XLA's column groups and their k-blocks, ROADMAP
Queue 3 item 12); it prints each shape's count and exits 1 if any differ.
`nan` counts the results of the port's DCTs (dct2_dense, idct2_dense,
dct2, idct2, idct2_planes with its sum and denormalize) at s 2-128 and of
resize2d at the test shapes whose bits differ from jax.jit's on planes
with NaNs of random payloads and signs (several in a dot row) and
infinities of both signs: which NaN XLA's dot passes on
(ops/kernels.nan_model; ROADMAP Queue 3 item 11).
`resize` counts the values of the port's resize2d (of the checkout at
ROOT, default this one) whose bits differ from jax.jit of the JAX
package's, on two random float planes and two u8/255 planes of each of
the dense-path shapes the tests use.
`dct` counts the coefficients of the port's dct2_dense / idct2_dense (and
dct2 / idct2 on gathered blocks) whose bits differ from jax.jit of the JAX
package's, for every block size 2-128: at the test planes (2, 256, 384),
at the per-block shapes the Codec sends (its buckets of 64-256 blocks),
and with --bench at the bench config's planes (42 x 512x768 YCoCg 4:2:0:
luma (42, 512, 768), chroma (84, 256, 384); minutes on the CPU).
`ictcp` counts the pixels of the port's ictcp_to_srgb whose bits differ
from jax.jit of the JAX package's on the ICtCp values of N (200,000)
near-black pixels (each channel 10**-31 to 10**-29, a third 10**-33 to
10**-28), as jax.jit(srgb_to_ictcp) gives them (ROADMAP Queue 3 item 6).

Needs jax (the JAX package's environment) and runs on the CPU only.
"""

import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


def xla_dot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    jax = _jax()
    import jax.numpy as jnp
    bc = np.array(b)
    return np.asarray(jax.jit(
        lambda x: jnp.dot(x, bc, precision="highest"))(a))


def ordered_dot(a: np.ndarray, b: np.ndarray, lanes: int,
                k_block: int) -> np.ndarray:
    """(M, K) @ (K, N) summed in the order a plan names, dense (lanes 0:
    one chain of rounded products, added in order)."""
    import torch
    from aejpeg_tpu_torch.ops.kernels import _lane_tree
    from aejpeg_tpu_torch.ops.libm import fma32_exact, ftz
    x = ftz(torch.from_numpy(a))
    w = torch.from_numpy(b)
    k = a.shape[1]
    unfused = lanes == 0
    lanes = max(lanes, 1)
    out = None
    tail = None
    for lo in range(0, k, k_block):
        hi = min(k, lo + k_block)
        main = lo + (hi - lo) // lanes * lanes
        chains = []
        for c in range(lanes):
            acc = torch.zeros((a.shape[0], b.shape[1]))
            for j in range(lo + c, main, lanes):
                if unfused:
                    acc = ftz(acc + ftz(x[:, j:j + 1] * w[j:j + 1]))
                else:
                    acc = ftz(fma32_exact(x[:, j:j + 1], w[j:j + 1], acc))
            chains.append(acc)
        blk = _lane_tree(chains)
        out = blk if out is None else ftz(out + blk)
        if main < hi:
            tails = [ftz(x[:, j:j + 1] * w[j:j + 1]) for j in range(main, hi)]
            tails += [torch.zeros_like(blk)] * (lanes - len(tails))
            tail = _lane_tree(tails)
    if tail is not None:
        out = ftz(out + tail)
    return out.numpy()


def check(m: int, k: int, n: int, seed: int = 0):
    """(order, count of differing results) of one shape, through the band
    path the port's kernels take."""
    import torch
    from aejpeg_tpu_torch.ops.kernels import banded_resize_plain
    from aejpeg_tpu_torch.ops.xla_dot import make_band, xla_dot_order
    rng = np.random.default_rng(seed)
    a = rng.random((m, k), dtype=np.float32) - np.float32(0.3)
    b = rng.random((k, n), dtype=np.float32) - np.float32(0.3)
    band = make_band(np.ascontiguousarray(b.T), m, torch.device("cpu"))
    got = banded_resize_plain(torch.from_numpy(a.T.copy())[None], band,
                              1)[0].T.contiguous().numpy()
    want = xla_dot(a, b)
    order = xla_dot_order(m, k, n)
    return order, int((got.view(np.uint32) != want.view(np.uint32)).sum())


def _orders(order) -> str:
    cols = sorted(set(order.columns))
    text = ", ".join(f"lanes {l} k-block {kb}" if l else
                     f"no FMA k-block {kb}" for l, kb in cols)
    if order.row_split < 10 ** 9 and set(order.tail_columns) != set(
            order.columns):
        text += (f"; rows from {order.row_split}: "
                 + ", ".join(f"lanes {l}" for l, _ in
                             sorted(set(order.tail_columns))))
    return text


def lanes_that_fit(m: int, k: int, n: int, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    a = rng.random((m, k), dtype=np.float32) - np.float32(0.3)
    b = rng.random((k, n), dtype=np.float32) - np.float32(0.3)
    want = xla_dot(a, b).view(np.uint32)
    for lanes in (1, 2, 4):
        got = ordered_dot(a, b, lanes, 1 << 20)
        if (got.view(np.uint32) == want).all():
            return str(lanes)
    return "X"


THIN_K = (513, 600, 700, 1100, 1500, 2048)
THIN_N = (65, 100, 128, 200, 1200)

RESIZES = (((37, 53), (19, 27), "area"), ((128, 192), (128, 48), "area"),
           ((101, 256), (51, 128), "area"),
           ((505, 632), (253, 316), "area"),
           ((482, 627), (241, 314), "area"),
           ((19, 27), (37, 53), "linear"),
           ((241, 314), (482, 627), "linear"),
           ((256, 384), (512, 768), "linear"))


def resize_diffs(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    jax = _jax()
    import torch
    from aejpeg_tpu.ops import resize as jr
    from aejpeg_tpu_torch.ops import resize as tr
    for src, dst, kind in RESIZES:
        rng = np.random.default_rng(5)
        counts = []
        for inputs in ("float", "u8"):
            if inputs == "float":
                x = rng.random((2,) + src, dtype=np.float32)
            else:
                x = (rng.integers(0, 256, (2,) + src).astype(np.float32)
                     / np.float32(255))
            want = np.asarray(jax.jit(
                lambda v: jr.resize2d(v, dst, kind))(x))
            got = tr.resize2d(torch.from_numpy(x), dst, kind).numpy()
            counts.append(int((got.view(np.uint32)
                               != want.view(np.uint32)).sum()))
        print(f"{src[0]}x{src[1]} -> {dst[0]}x{dst[1]} {kind}: "
              f"float {counts[0]}, u8 {counts[1]} of {want.size} differ",
              flush=True)


def _dct_line(name, got, want):
    diff = int((np.ascontiguousarray(got).view(np.uint32)
                != np.ascontiguousarray(want).view(np.uint32)).sum())
    print(f"{name}: {diff} of {want.size} differ", flush=True)
    return diff


def dct_diffs(bench: bool) -> int:
    jax = _jax()
    import torch
    from aejpeg_tpu.ops import dct as jd
    from aejpeg_tpu_torch.ops import dct as td
    from aejpeg_tpu_torch.ops.xla_dot import xla_dot_order
    torch.set_num_threads(max(1, os.cpu_count() // 2))
    rng = np.random.default_rng(0)
    planes = [(2, 256, 384)]
    if bench:
        planes += [(42, 512, 768), (84, 256, 384)]
    bad = 0
    for shape in planes:
        x = rng.random(shape, dtype=np.float32) - np.float32(0.5)
        for s in (2, 4, 8, 16, 32, 64, 128):
            if shape[1] % s or shape[2] % s:
                continue
            m = x.size // s
            print(f"{shape} s={s}: dot ({m}, {s}) @ ({s}, {s}), "
                  f"{_orders(xla_dot_order(m, s, s))}", flush=True)
            want = np.asarray(jax.jit(lambda v: jd.dct2_dense(v, s))(x))
            bad += _dct_line("  dct2_dense", td.dct2_dense(
                torch.from_numpy(x), s).numpy(), want)
            bad += _dct_line("  idct2_dense", td.idct2_dense(
                torch.from_numpy(want.copy())).numpy(),
                np.asarray(jax.jit(jd.idct2_dense)(want)))
    for s in (2, 4, 8, 16, 32, 64, 128):
        for cap in (64, 256):           # the Codec's bucket capacities
            b = rng.random((cap, s, s), dtype=np.float32) * 40 - 20
            bad += _dct_line(f"dct2 ({cap}, {s}, {s})", td.dct2(
                torch.from_numpy(b)).numpy(), np.asarray(jax.jit(jd.dct2)(b)))
            bad += _dct_line(f"idct2 ({cap}, {s}, {s})", td.idct2(
                torch.from_numpy(b)).numpy(),
                np.asarray(jax.jit(jd.idct2)(b)))
    return 1 if bad else 0


def non_finite(shape, seed):
    """Random values with 4% NaNs of random payloads and signs and 1% of
    each infinity."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32) - np.float32(0.3)
    bits = (rng.integers(1, 1 << 22, shape) | 0x7F800000
            | (rng.integers(0, 2, shape) << 31)).astype(np.uint32)
    pick = rng.random(shape)
    x = np.where(pick < 0.04, bits.view(np.float32), x)
    x = np.where((pick >= 0.04) & (pick < 0.05), np.float32(np.inf), x)
    return np.where((pick >= 0.05) & (pick < 0.06), np.float32(-np.inf),
                    x).astype(np.float32)


def nan_diffs() -> int:
    jax = _jax()
    import torch
    from aejpeg_tpu.ops import dct as jd
    from aejpeg_tpu.ops import resize as jr
    from aejpeg_tpu_torch.ops import dct as td
    from aejpeg_tpu_torch.ops import resize as tr
    bad = 0
    for s in (2, 4, 8, 16, 32, 64, 128):
        side = max(s, 16)
        shape = (2, 2 * side, 2 * side) if s < 64 else (1, s, 2 * s)
        x = non_finite(shape, s)
        x6 = x.reshape(shape[0], shape[1] // s, s, shape[2] // s, s)
        b = x.reshape(-1, s, s)[:8]
        add = non_finite(shape, s + 1)
        rcp, mid = np.float32(1) / np.float32(0.8), np.float32(0.5)

        def planes(v, a):
            y = jd.idct2_dense(v.reshape(x6.shape)).reshape(v.shape)
            return (a + y) / np.float32(0.8) + mid
        for name, got, want in (
                ("dct2_dense", td.dct2_dense(torch.from_numpy(x), s),
                 jax.jit(lambda v: jd.dct2_dense(v, s))(x)),
                ("idct2_dense", td.idct2_dense(torch.from_numpy(x6)),
                 jax.jit(jd.idct2_dense)(x6)),
                ("dct2", td.dct2(torch.from_numpy(b)), jax.jit(jd.dct2)(b)),
                ("idct2", td.idct2(torch.from_numpy(b)),
                 jax.jit(jd.idct2)(b)),
                ("idct2_planes + sum, denormalize", td.idct2_planes(
                    torch.from_numpy(x), s, add=torch.from_numpy(add),
                    affine=(torch.tensor([rcp]), torch.tensor([mid]), 1)),
                 jax.jit(planes)(x, add))):
            want = np.asarray(want)
            bad += _dct_line(f"{name} s={s} ({int(np.isnan(want).sum())} "
                             "NaN)", got.numpy(), want)
    for src, dst, kind in RESIZES[:4] + (((600, 10), (1200, 20), "linear"),
                                         ((100, 2), (201, 4), "linear")):
        x = non_finite((2,) + src, sum(src))
        want = np.asarray(jax.jit(lambda v: jr.resize2d(v, dst, kind))(x))
        bad += _dct_line(f"resize2d {src} -> {dst} {kind}",
                         tr.resize2d(torch.from_numpy(x), dst, kind).numpy(),
                         want)
    return 1 if bad else 0


def ictcp_diffs(n: int) -> int:
    jax = _jax()
    import torch
    from aejpeg_tpu.color import transforms as jt
    from aejpeg_tpu_torch.color import transforms as tt
    rng = np.random.default_rng(0)
    rgb = (10.0 ** rng.uniform(-31, -29, (n, 3))).astype(np.float32)
    rgb[::3] = (10.0 ** rng.uniform(-33, -28, (len(rgb[::3]), 3))).astype(
        np.float32)
    ict = np.asarray(jax.jit(jt.srgb_to_ictcp)(rgb))
    want = np.asarray(jax.jit(jt.ictcp_to_srgb)(ict))
    got = tt.ictcp_to_srgb(torch.from_numpy(ict.copy())).numpy()
    bad = got.view(np.uint32) != want.view(np.uint32)
    print(f"ictcp_to_srgb on {n} near-black pixels: {int(bad.any(1).sum())} "
          f"differ; per channel {bad.sum(0).tolist()}", flush=True)
    return 1 if bad.any() else 0


def main(argv) -> int:
    if not argv:
        print(__doc__)
        return 2
    if argv[0] == "check":
        dims = list(map(int, argv[1:]))
        bad = 0
        for m, k, n in zip(dims[::3], dims[1::3], dims[2::3]):
            order, diff = check(m, k, n)
            print(f"({m}, {k}) @ ({k}, {n}): {_orders(order)}: {diff} "
                  f"results differ", flush=True)
            bad += diff > 0
        return 1 if bad else 0
    if argv[0] == "dct":
        return dct_diffs("--bench" in argv[1:])
    if argv[0] == "nan":
        return nan_diffs()
    if argv[0] == "ictcp":
        return ictcp_diffs(int(argv[1]) if len(argv) > 1 else 200_000)
    if argv[0] == "scan":
        ns = (2, 3, 4, 8, 9, 12, 16, 17, 24, 48)
        for k in (8, 9, 37, 100):
            print(f"k {k}, n {ns}")
            for m in (2, 3, 4, 6, 8, 16, 32, 50):
                print(f"  m {m:3d}: "
                      + " ".join(lanes_that_fit(m, k, n) for n in ns),
                      flush=True)
        return 0
    if argv[0] == "thin":
        ms = (list(map(int, argv[1].split(","))) if len(argv) > 1
              else range(2, 51))
        bad = 0
        for m in ms:
            for k in THIN_K:
                for n in THIN_N:
                    order, diff = check(m, k, n)
                    print(f"({m}, {k}) @ ({k}, {n}): {_orders(order)}: "
                          f"{diff} results differ", flush=True)
                    bad += diff > 0
        print(f"{bad} shapes differ", flush=True)
        return 1 if bad else 0
    if argv[0] == "resize":
        resize_diffs(argv[1] if len(argv) > 1 else _ROOT)
        return 0
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
