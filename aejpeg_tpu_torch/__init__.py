"""aejpeg_tpu_torch — the adaptive edge-aware image codec in PyTorch + CUDA.

The batched dense codec (encode_batch -> .ajpg -> decode_batch, and the
streams over them) runs on one NVIDIA H100.  Plain tensor code is PyTorch;
the three kernels of the Canny/CLAHE stack (256-bin histograms, the packed
CLAHE LUT gather and its 4-tap fallback) are hand-written CUDA for sm_90a
(`csrc/`), built with nvcc at first use (`ops/_build.py`).

Device rule: every public entry point takes `device=None`, which means
"cuda".  Without CUDA they raise unless the caller passes `device="cpu"`;
they never carry on quietly on the CPU.  On the CPU each kernel wrapper runs
its plain PyTorch version (that is how the tests run).

Numerics: fp32 matmuls and convolutions run in full fp32 (no TF32), the
counterpart of the JAX package's precision="highest".
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `None` means CUDA.  Raises when
    CUDA is asked for (explicitly or by default) and is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "aejpeg_tpu_torch runs on CUDA and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {dev}")
    return dev


from .config import CodecConfig  # noqa: E402
from .codec.batch_encode import encode_batch  # noqa: E402
from .codec.batch_decode import decode_batch  # noqa: E402
from .codec.stream import encode_stream, decode_stream  # noqa: E402
from .io.image import ImageData  # noqa: E402

__all__ = ["CodecConfig", "ImageData", "encode_batch", "decode_batch",
           "encode_stream", "decode_stream", "resolve_device"]
