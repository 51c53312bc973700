#!/usr/bin/env python3
"""Print glibc's powf tables from a libm, and check them against the ones
aejpeg_tpu_torch/ops/libm.py carries.

    python3 tools/glibc_powf_tables.py LIBM [--log2 OFF] [--exp2 OFF]

The data symbols (__powf_log2_data, __exp2f_data) are not exported.  Their
offsets come from `objdump -d LIBM`: the `powf` ifunc resolver returns
`__powf_fma` on CPUs with FMA and AVX2, and that function's RIP-relative
`lea`s name the 16-entry (1/c, log2 c) table (followed by the 5 log2
coefficients) and the 32-entry exp2 table (followed by the shift and the
3 exp2 coefficients).  The defaults are those of Debian 12's glibc
2.36-9 on x86-64, where the tables lie in .rodata at equal file and
virtual offsets.  Exits 1 if a value differs from the module's.
"""

import argparse
import os
import struct
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aejpeg_tpu_torch.ops import libm  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("libm")
    ap.add_argument("--log2", type=lambda s: int(s, 0), default=0xAE0E0)
    ap.add_argument("--exp2", type=lambda s: int(s, 0), default=0xADD40)
    args = ap.parse_args()
    data = open(args.libm, "rb").read()

    def f64(off):
        return struct.unpack_from("<d", data, off)[0]

    def u64(off):
        return struct.unpack_from("<Q", data, off)[0]

    found = {
        "_LOG2_INVC": [f64(args.log2 + 16 * i) for i in range(16)],
        "_LOG2_LOGC": [f64(args.log2 + 16 * i + 8) for i in range(16)],
        "_LOG2_POLY": [f64(args.log2 + 256 + 8 * i) for i in range(5)],
        "_EXP2_TAB": [u64(args.exp2 + 8 * i) for i in range(32)],
        "_EXP2_SHIFT": [f64(args.exp2 + 256)],
        "_EXP2_POLY": [f64(args.exp2 + 264 + 8 * i) for i in range(3)],
    }
    bad = 0
    for name, vals in found.items():
        ours = getattr(libm, name)
        ours = list(ours) if isinstance(ours, tuple) else [ours]
        same = ours == vals
        bad += not same
        shown = [hex(v) if isinstance(v, int) else float.hex(v) for v in vals]
        print(f"{name}: {'same' if same else 'DIFFERENT'}: {shown}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
