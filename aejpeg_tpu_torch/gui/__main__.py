"""``python -m aejpeg_tpu_torch.gui [preview.png]`` — open the codec
explorer window on CUDA (reference entry point: src/main.py:20-33)."""

import sys

from .app import main

if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
