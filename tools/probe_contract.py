"""Phase 2 of chip_smoke.py for the XLA-ordered contraction kernels alone
(csrc/banded_resize.cu: `banded_resize` and `dct_pass`): each against its
plain version on the card, bitwise, timed beside its bound and the route
it replaced.

    python3 tools/probe_contract.py [--quick] [--kernels NAME,...]
                                    [--csrc DIR ...] [--devices I,J,...]

The cases, timings and bounds are chip_smoke.py's (`kernel_cases`,
`check_kernels`).  --quick: the cases off the main path only (small,
odd and special shapes), untimed.  --kernels: a subset of
banded_resize,dct_pass.  --csrc DIR: build the kernels from the sources
in DIR instead of the package's csrc/; given several times, each
directory in turn in one process, so that a variant of a source and the
package's are timed on one card.  --devices: the checks on each of these
cards in turn, in one process (a kernel's launch set-up holds per card).
Prints one JSON line per source directory and card; exits 1 when a
kernel fails to launch or differs from its plain version.
"""

import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import chip_smoke as cs  # noqa: E402

NAMES = ("banded_resize", "dct_pass")


def use_sources(csrc):
    """Load the kernels from `csrc` (built into csrc/build) from now on."""
    from aejpeg_tpu_torch.ops import _build, kernels
    _build.CSRC = os.path.abspath(csrc)
    _build.BUILD = os.path.join(_build.CSRC, "build")
    _build._LIBS.clear()
    kernels._FNS.clear()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--kernels", default=",".join(NAMES))
    ap.add_argument("--csrc", action="append")
    ap.add_argument("--devices", default="0")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_contract: CUDA is not available", file=sys.stderr)
        return 1
    names = args.kernels.split(",")
    if not set(names) <= set(NAMES):
        ap.error(f"--kernels: a subset of {','.join(NAMES)}")
    devices = [int(d) for d in args.devices.split(",")]
    cs.log(cs.card_line())
    for csrc in args.csrc or [None]:
        if csrc is not None:
            use_sources(csrc)
        for d in devices:
            dev = torch.device("cuda", d)
            cs.log(f"sources: {csrc or 'aejpeg_tpu_torch/csrc'}, {dev}")
            try:
                with torch.cuda.device(dev):
                    summary = cs.check_kernels(dev, names, quick=args.quick)
            except (AssertionError, RuntimeError) as e:
                print(json.dumps({"csrc": csrc, "device": d, "ok": False,
                                  "error": str(e)}), flush=True)
                return 1
            print(json.dumps({"csrc": csrc, "device": d, "ok": True,
                              "kernels": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
