"""Time two or more checkouts of the repo on the card in one call: for
each directory given, in order, chip_smoke.py's phase 5 (encode and decode
Mpix/s of the 42 x 512x768 bench batch, median of warm batches) and phase
15 (the bench subcommand's encode and decode streams), each checkout in a
subprocess of its own that imports only that checkout.

    python3 tools/phase5_ab.py checkout/parent . . checkout/parent

Prints each run's log lines; run the checkouts in the order A, B, B, A to
see the spread beside the difference.
"""

import subprocess
import sys
import time

_RUN = """
import sys, time
sys.path.insert(0, {root!r})
import chip_smoke as cs
import aejpeg_tpu_torch as at
from aejpeg_tpu_torch.ops import _build
_build.build_all()
card = cs.card_line()
cfg = at.CodecConfig("YCoCg", cs.QUALITY, cs.BLOCKS, entropy_level=-1)
big = cs.synth_images(cs.BATCH, cs.H, cs.W, seed=1)
cs.log("[5] " + card)
cs.times(cfg, big)
cs.log("[15]")
cs.bench_phase(big, card)
"""


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for i, root in enumerate(argv):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", _RUN.format(root=root)],
                             cwd=root, capture_output=True, text=True,
                             timeout=1200)
        print(f"=== run {i + 1}: {root} (exit {res.returncode}, "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        print(res.stdout.strip()[-6000:], flush=True)
        if res.returncode != 0:
            print(res.stderr.strip()[-3000:], flush=True)
        if res.returncode != 0:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
